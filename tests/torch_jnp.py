"""Shared helpers of the tests that hold the port's jnp engines
(kytpu_torch/integrator, light, bsdf, scene) against kytpu's.

Both packages get the same numpy lanes and scenes built by their own
builders (bit-identical tables, tests/test_torch_scene.py); kytpu runs
jitted on the CPU, the port on CPU tensors. Radiance is compared lane by
lane within rtol=1e-3/atol=1e-4 with at most 0.5% of lanes outside
(`lanes_agree`): kytpu's jitted code contracts multiply-adds and has its
own transcendentals, and a discrete fork (a lobe pick, roulette, the
closest surface) turns a last-bit difference into a different path.
"""

import dataclasses
import importlib

import jax
import numpy as np
import torch

from kytpu.integrator import fast as jfast
from kytpu.integrator import path as jpath
from kytpu_torch.core import rng as trng
from kytpu_torch.integrator import fast as tfast
from kytpu_torch.integrator import path as tpath
from tests.test_torch_wavefront import lanes_agree  # noqa: F401

# the packages' integrator/__init__ re-export render(), which hides the
# module of the same name
jrender = importlib.import_module("kytpu.integrator.render")
trender = importlib.import_module("kytpu_torch.integrator.render")


def port_cfg(jcfg):
    """The port's PathConfig or FastConfig with kytpu's fields."""
    cls = (tfast.FastConfig if isinstance(jcfg, jfast.FastConfig)
           else tpath.PathConfig)
    assert isinstance(jcfg, (jfast.FastConfig, jpath.PathConfig))
    return cls(**dataclasses.asdict(jcfg))


def lanes(w: int, h: int, spp: int):
    """kytpu's lane order: pixel ids tiled, sample ids repeated -> numpy
    (px, py, pid, sid)."""
    npix = w * h
    pid = np.tile(np.arange(npix, dtype=np.int32), spp)
    sid = np.repeat(np.arange(spp, dtype=np.int32), npix)
    return ((pid % w).astype(np.float32), (pid // w).astype(np.float32),
            pid, sid)


def trace_pair(jsc, tsc, jcfg, mode="path", aov=None, spp=2, seed=5):
    """One pass of trace_lanes over spp samples of every pixel in both
    packages -> (kytpu's, the port's) (n, 3) radiance as numpy."""
    w, h = jsc.camera.width, jsc.camera.height
    px, py, pid, sid = lanes(w, h, spp)
    ref = np.asarray(jrender._render_pass(jsc, jax.random.key(seed), px, py,
                                          pid, sid, jcfg, mode, aov))
    t = torch.from_numpy
    got = trender.trace_lanes(tsc, trng.key(seed), t(px), t(py),
                              t(pid).long(), t(sid).long(), port_cfg(jcfg),
                              mode, aov).numpy()
    return ref, got
