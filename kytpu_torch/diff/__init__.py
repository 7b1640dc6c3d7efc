"""Inverse rendering on the port (kytpu/diff): losses, parameter views of a
scene, the train step through the CUDA diff tracer or the jnp engines, and
finite-difference checks of its gradients."""

from kytpu_torch.diff.params import TRAINABLE, get_params, set_params
from kytpu_torch.diff.losses import l1, mse, relmse
from kytpu_torch.diff.inverse import make_train_step, recover, render_loss
from kytpu_torch.diff.fd_check import check_gradients, fd_gradient

__all__ = ["get_params", "set_params", "TRAINABLE", "mse", "relmse", "l1",
           "render_loss", "make_train_step", "recover", "fd_gradient",
           "check_gradients"]
