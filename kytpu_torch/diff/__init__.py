"""Inverse rendering on the port (kytpu/diff): losses, parameter views of a
scene and the train step through the CUDA diff tracer."""

from kytpu_torch.diff.params import TRAINABLE, get_params, set_params  # noqa: F401
from kytpu_torch.diff.losses import l1, mse, relmse  # noqa: F401
from kytpu_torch.diff.inverse import make_train_step, recover  # noqa: F401
