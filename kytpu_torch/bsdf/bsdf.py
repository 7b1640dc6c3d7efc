"""BSDF and material kinds (kytpu/bsdf/bsdf.py).

Only the enums are ported: the render path's BSDF math lives with the
kernel in kernels/wavefront.py, as it does in the JAX package's megakernel.
"""

# BSDF kinds (per lane, after material resolution)
LAMBERT = 0
MIRROR = 1
GLASS = 2
PHONG = 3

# material kinds (per surface row)
MAT_MATTE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_PLASTIC = 3
