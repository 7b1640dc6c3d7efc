from kytpu_torch.light.lights import (  # noqa: F401
    POINT, DIRECTION, AREA_RECT, AREA_SPHERE, ENV,
    Lights, LightSample, sample_li, pdf_li, is_delta_light, light_power,
)
