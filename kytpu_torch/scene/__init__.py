from kytpu_torch.scene.scene import (  # noqa: F401
    Camera, Scene, generate_rays, make_camera, scene_from_numpy,
)
from kytpu_torch.scene import builders, shapes  # noqa: F401
