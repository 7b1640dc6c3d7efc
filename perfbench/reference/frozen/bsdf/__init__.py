from perfbench.reference.frozen.bsdf.bsdf import (  # noqa: F401
    LAMBERT, MIRROR, GLASS, PHONG,
    MAT_MATTE, MAT_MIRROR, MAT_GLASS, MAT_PLASTIC,
    BsdfParams, BsdfSample,
    resolve_bsdf, eval_local, pdf_local, sample_local,
    eval_world, pdf_world, sample_world, eval_and_pdf_world, is_delta,
)
