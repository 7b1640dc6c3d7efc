from kytpu_torch.light.lights import (  # noqa: F401
    POINT, DIRECTION, AREA_RECT, AREA_SPHERE, ENV, Lights, is_delta_light,
)
