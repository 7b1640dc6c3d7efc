from kytpu_torch.core import math, rng  # noqa: F401
