"""kytpu_torch -- the kytpu path tracer on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `kytpu` beside it, module for module. Plain
tensor code is PyTorch; each Pallas TPU kernel on a ported path has a CUDA
C++ counterpart under `kernels/csrc/`, built with nvcc on first use. The
package imports torch and numpy, never jax.

Ported so far: the forward render,
`integrator.render.render(scene, engine="cuda")`, and inverse rendering,
`diff.inverse.make_train_step(scene, target, engine="cuda")` (the Phong
exponents and textures trainable too), through either backward of the
megakernels or, past 64 surfaces, of the big-scene kernels, under every
sampler; and kytpu's default render path, the jnp engines
(`render(..., engine="jnp")`, `make_train_step(..., engine="jnp")`), as
plain torch code differentiated by autograd; the entry points users start
from, `python -m kytpu_torch.cli.render` and `python -m
kytpu_torch.cli.inverse`, with the image writers (film/), the grid
accelerator (scene/accel.py), profiling, checks and finite differences;
and the headline benchmark `python -m kytpu_torch.bench`, the nanopt
teaching example (examples/) and the parity tools against the compiled
reference (tools/).
All run on the card unless the caller passes device="cpu" (`--device cpu`
on the command lines).
"""

__version__ = "0.1.0"

from kytpu_torch.core import math as kmath  # noqa: F401

# the user-facing surface, kytpu's
from kytpu_torch.scene import builders  # noqa: F401
from kytpu_torch.integrator.render import (  # noqa: F401
    render, render_aov, render_region, debug_area, debug_pixel)
from kytpu_torch.integrator.path import PathConfig  # noqa: F401
from kytpu_torch.integrator.fast import FastConfig  # noqa: F401
