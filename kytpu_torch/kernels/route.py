"""kytpu's kernel family rule, once for render, make_train_step and
render_sharded_pallas: K1-K4 (kernels/wavefront.py) up to
TABLE_ROUTE_SURFACES surfaces, K5-K8 (kernels/bigscene.py) past that
unless their tables refuse the scene; engine="bigscene" takes K5-K8 at any
size and lets a refusal raise. The families' constructors are looked up on
their modules at each call, so a caller may wrap them.
"""

from __future__ import annotations

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf

TABLE_ROUTE_SURFACES = 64
ENGINES = ("cuda", "bigscene")


def tables_of(scene, engine: str = "cuda"):
    """`kbs.extract_tables(scene)` where K5-K8 take the scene, else None;
    under engine="cuda" a scene of at most TABLE_ROUTE_SURFACES surfaces
    is not extracted and a refusal (NotImplementedError) means K1-K4."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected one of "
                         f"{ENGINES}")
    if (engine == "cuda"
            and int(scene.mat_kind.shape[0]) <= TABLE_ROUTE_SURFACES):
        return None
    try:
        return kbs.extract_tables(scene)
    except NotImplementedError:
        if engine == "bigscene":
            raise
        return None


def tracer(scene, cfg, engine: str = "cuda"):
    extracted = tables_of(scene, engine)
    if extracted is None:
        return kwf.make_cuda_tracer(scene, cfg)
    return kbs.make_bigscene_tracer(scene, cfg, extracted)


def diff_tracer(scene, cfg, backward: str = "residual"):
    extracted = tables_of(scene)
    if extracted is None:
        return kwf.make_cuda_diff_tracer(scene, cfg, backward)
    return kbs.make_bigscene_diff_tracer(scene, cfg, backward,
                                         extracted=extracted)


def frame(scene, device, engine: str = "cuda", **kw):
    """A frame (render_cuda's or render_bigscene's keywords `kw`) on
    `device`, routed on the scene as given, before it moves there."""
    extracted = tables_of(scene, engine)
    scene = scene.to(device)
    if extracted is None:
        return kwf.render_cuda(scene, **kw)
    return kbs.render_bigscene(scene, extracted=extracted, **kw)
