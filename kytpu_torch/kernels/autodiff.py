"""The autograd side that both kernel families share: a diff tracer's
tables (`DiffTables`), the autograd Functions over a residual forward and
its cache backward (K2 and K3, or K6 and K7) or over a forward and a
replay backward (K1 and K4, or K5 and K8), and the tracer in kytpu's
argument order (`diff_tracer`).
"""

from __future__ import annotations

import dataclasses

import torch

from kytpu_torch.kernels import tables as ktab
from kytpu_torch.scene import scene as kscene
from kytpu_torch.utils import profiling as kprof


class DiffTables:
    """A diff tracer's scene: the geometry tables packed once (`pack`), and
    the colour (exponent, texture) tables of each call, NEE light emissions
    derived from them. Each kernel family's subclass gives `pack` and the
    kernels the autograd Functions run on the tables (`trace`, `bwd_res`,
    `bwd_replay`), looked up in its module at each call, so a caller may
    wrap them."""

    def __init__(self, scene: kscene.Scene, cfg):
        self.scene = scene
        self.cfg = cfg
        self.geo = self.pack(scene, cfg)
        static = self.geo.static
        self.textured = bool(static["textures"])
        self.has_img = ktab.has_img(static)

    @kprof.spanned("kytpu::tables.colors")
    def __call__(self, diffuse, specular, emission, env, exponent=None,
                 texa=None, texb=None, timg=None):
        dev = self.geo.f.device
        f32 = lambda t: t.detach().to(device=dev,  # noqa: E731
                                      dtype=torch.float32).contiguous()
        emission = f32(emission)
        env = f32(env).reshape(3)
        tex = (ktab.texture_tables(self.scene, texa, texb, timg)
               if self.textured else {})
        return dataclasses.replace(
            self.geo, diffuse=f32(diffuse), specular=f32(specular),
            emission=emission, env=env,
            exponent=self.geo.exponent if exponent is None else f32(exponent),
            light_emit=ktab.light_emit_of(self.scene, emission,
                                          env).contiguous(),
            **tex)

    def grad_names(self) -> tuple:
        """The names of the backwards' outputs, in order."""
        return (("dd", "ds", "de", "denv")
                + (("dexp",) if self.cfg.trainable_exponent else ())
                + (("dta", "dtb") if self.textured else ())
                + (("dti",) if self.has_img else ()))


# the Functions' table inputs after `tabs`, and the gradient of each
_INPUT_GRADS = ("dd", "ds", "de", "dexp", "dta", "dtb", "dti", "denv")


def _table_grads(ctx, grads):
    """The backwards' outputs (`DiffTables.grad_names`) -> the gradients
    of the Functions' inputs (tabs, diffuse, specular, emission, exponent,
    texa, texb, timg, env, o, d, seed, si, pix), None where no gradient
    was asked for; the atlas gradient in the shape of the timg given."""
    got = dict(zip(ctx.tabs.grad_names(), grads))
    if "dti" in got:
        got["dti"] = got["dti"].reshape(ctx.timg_shape)
    need = ctx.needs_input_grad
    return (None, *(got.get(nm) if need[1 + k] else None
                    for k, nm in enumerate(_INPUT_GRADS)),
            None, None, None, None, None)


def _keep(ctx, tabs, tables, timg):
    ctx.tables = tables
    ctx.tabs = tabs
    ctx.timg_shape = None if timg is None else timg.shape


class ResidualTrace(torch.autograd.Function):
    """The forward launches the residual forward (K2, or the big-scene K6)
    and keeps its cache when a table needs a gradient (K1 or K5 otherwise);
    the backward launches the cache backward (K3 or K7): `tabs` says which.
    Rays, seed and the lane ids get no gradient (geometry derivatives are
    out of scope, as in the JAX package's detached-sampling estimator)."""

    @staticmethod
    def forward(ctx, tabs, diffuse, specular, emission, exponent, texa, texb,
                timg, env, o, d, seed, si, pix):
        tables = tabs(diffuse, specular, emission, env, exponent, texa, texb,
                      timg)
        if not any(ctx.needs_input_grad[1:9]):
            return tabs.trace(tables, o, d, seed, si, pix)
        big_l, resf, resi = tabs.trace(tables, o, d, seed, si, pix,
                                       residual=True)
        _keep(ctx, tabs, tables, timg)
        ctx.save_for_backward(big_l, resf, resi)
        return big_l

    @staticmethod
    def backward(ctx, g):
        big_l, resf, resi = ctx.saved_tensors
        return _table_grads(ctx, ctx.tabs.bwd_res(
            ctx.tables, g.to(torch.float32).contiguous(), big_l, resf, resi))


class ReplayTrace(torch.autograd.Function):
    """The forward launches K1 (or K5) and, when a table needs a gradient,
    keeps the lanes and the radiance (no cache: O(1) memory a lane beyond
    the inputs); the backward launches K4 (or K8), which re-traces the
    lanes."""

    @staticmethod
    def forward(ctx, tabs, diffuse, specular, emission, exponent, texa, texb,
                timg, env, o, d, seed, si, pix):
        tables = tabs(diffuse, specular, emission, env, exponent, texa, texb,
                      timg)
        big_l = tabs.trace(tables, o, d, seed, si, pix)
        if any(ctx.needs_input_grad[1:9]):
            _keep(ctx, tabs, tables, timg)
            ctx.seed = seed
            ctx.save_for_backward(o, d, si, pix, big_l)
        return big_l

    @staticmethod
    def backward(ctx, g):
        o, d, si, pix, big_l = ctx.saved_tensors
        return _table_grads(ctx, ctx.tabs.bwd_replay(
            ctx.tables, o, d, ctx.seed, si, pix,
            g.to(torch.float32).contiguous(), big_l))


def function_of(backward: str):
    """The autograd Function of a diff tracer's `backward`: "residual"
    (`ResidualTrace`) or "replay" (`ReplayTrace`)."""
    fn = {"residual": ResidualTrace, "replay": ReplayTrace}.get(backward)
    if fn is None:
        raise ValueError(f"unknown backward {backward!r}")
    return fn


def diff_tracer(tabs: DiffTables, fn):
    """fn(diffuse, specular, emission, [exponent,] [texa, texb,] [timg,]
    env, o, d, seed[, si, pix]) over the autograd Function `fn` and the
    tables `tabs` (kytpu's public argument order): the exponent is there
    iff tabs.cfg.trainable_exponent, the checker colours texa, texb (T, 3)
    iff the scene has texture records, the atlas timg (Ti, H, W, 3) iff it
    has image textures."""
    def trace(diffuse, specular, emission, *rest):
        rest = list(rest)
        exponent = (rest.pop(0) if tabs.cfg.trainable_exponent and rest
                    else None)
        texa = texb = timg = None
        if tabs.textured and len(rest) > 1:
            texa, texb = rest.pop(0), rest.pop(0)
        if tabs.has_img and rest:
            timg = rest.pop(0)
        if len(rest) not in (4, 6):
            raise TypeError("expected (env, o, d, seed[, si, pix]) after the "
                            "tables")
        env, o, d, seed, si, pix = rest + [None] * (6 - len(rest))
        return fn.apply(tabs, diffuse, specular, emission, exponent, texa,
                        texb, timg, env, o, d, seed, si, pix)

    trace.tabs = tabs
    return trace
