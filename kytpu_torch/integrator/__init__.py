from kytpu_torch.integrator.render import render  # noqa: F401
