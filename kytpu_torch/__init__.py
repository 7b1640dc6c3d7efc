"""kytpu_torch -- the kytpu path tracer on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `kytpu` beside it, module for module. Plain
tensor code is PyTorch; each Pallas TPU kernel on a ported path has a CUDA
C++ counterpart under `kernels/csrc/`, built with nvcc on first use. The
package imports torch and numpy, never jax.

Ported so far: the forward render of scenes with at most 64 surfaces,
`integrator.render.render(scene, engine="cuda")`.
"""

__version__ = "0.1.0"

from kytpu_torch.scene import builders  # noqa: F401
from kytpu_torch.integrator.render import render  # noqa: F401
