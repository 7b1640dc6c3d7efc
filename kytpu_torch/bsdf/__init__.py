from kytpu_torch.bsdf.bsdf import (  # noqa: F401
    LAMBERT, MIRROR, GLASS, PHONG,
    MAT_MATTE, MAT_MIRROR, MAT_GLASS, MAT_PLASTIC,
)
