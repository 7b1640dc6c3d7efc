"""kytpu's kernel family rule, once for render, make_train_step and
render_sharded_pallas: K1-K4 (kernels/wavefront.py) up to
TABLE_ROUTE_SURFACES surfaces, K5-K8 (kernels/bigscene.py) past that
unless their tables refuse the scene; engine="bigscene" takes K5-K8 at any
size and lets a refusal raise. The families' constructors are looked up on
their modules at each call, so a caller may wrap them.

A frame keeps its routing and its tracer for the next: `frame` reads the
bytes of every tensor of the scene, its Geometry, Lights and Textures but
those in `UNKEYED` to the host in one copy, and reuses the tracer of an
earlier frame whose engine, KernelConfig, device, family constructors
(as looked up at the call) and bytes are all equal, compared in full.
`UNKEYED` holds what a frame reads at each call (the camera and the
colour tables that `with_colors` takes) and what no kernel reads; those
fields enter the key by shape and dtype alone, and a field added later is
keyed unless it is listed there. At most FRAME_CACHE tracers are kept,
the least recently used evicted; `tables.frame.reused` and
`tables.frame.packed` count the frames that reused one and those that
packed.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import texture as ktex
from kytpu_torch.utils import profiling as kprof

TABLE_ROUTE_SURFACES = 64
ENGINES = ("cuda", "bigscene")
FRAME_CACHE = 4

# the fields read at each call or by no kernel; every other field of a
# Scene and of the dataclasses in it is keyed by value
UNKEYED = {
    kscene.Scene: ("camera", "mat_diffuse", "mat_specular", "emission",
                   "world_center", "env_radiance_", "accel"),
    klights.Lights: ("emit",),
    ktex.Textures: ("color_a", "color_b", "image"),
}

# [(key, bytes, tracer)], the most recently used last; _lock guards it and
# the host buffer that the card's key bytes are copied into
_frames: list = []
_pinned = None
_lock = threading.Lock()


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


def _walk(obj, tensors: list, meta: list) -> None:
    """Gather `obj`'s keyed tensors, walking into the dataclasses it holds,
    and the shape and dtype of each of its tensors and its other keyed
    values into meta."""
    meta.append(type(obj).__name__)
    unkeyed = UNKEYED.get(type(obj), ())
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            meta.append((tuple(v.shape), v.dtype))
            if f.name not in unkeyed:
                tensors.append(v)
        elif f.name in unkeyed:
            continue
        elif dataclasses.is_dataclass(v):
            _walk(v, tensors, meta)
        else:
            meta.append(v)


def _host_bytes(flat: torch.Tensor) -> bytes:
    """The bytes of the uint8 tensor flat, in one copy from the card (into
    a pinned buffer kept for the next)."""
    global _pinned
    if flat.device.type != "cuda":
        return flat.numpy().tobytes()
    n = flat.numel()
    if _pinned is None or _pinned.numel() < n:
        _pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    buf = _pinned[:n]
    buf.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return buf.numpy().tobytes()


def _scene_key(scene):
    """(python values, bytes) of `scene`'s keyed fields: the shapes and
    dtypes of its tensors and its host values, and the keyed tensors'
    bytes, read in one copy. The tensors are joined a dtype at a time
    before their bytes are viewed: a join takes any strides (an empty or
    expanded field has stride 0), a byte view only a unit one."""
    tensors, meta = [], []
    _walk(scene, tensors, meta)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.detach().reshape(-1))
    flat = torch.cat([torch.cat(ts).view(torch.uint8)
                      for ts in by_dtype.values()])
    return tuple(meta), _host_bytes(flat)


def frame(scene, device, engine: str = "cuda", cfg=None, **kw):
    """A frame (render_cuda's keywords `kw`) on `device`, routed and keyed
    on the scene as given, before it moves there; the tracer of an earlier
    frame with the same key is reused."""
    cfg = cfg or kwf.KernelConfig()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # the constructors live at this call key the tracer they build, so a
    # wrapped one neither reuses nor leaves behind another's tracer
    make = (kwf.make_cuda_tracer, kbs.make_bigscene_tracer)
    with kprof.span("kytpu::tables.frame"):
        with _lock:
            meta, data = _scene_key(scene)
            key = (engine, cfg, device, meta, kbs.extract_tables) + make
            i = next((i for i, (k, b, _) in enumerate(_frames)
                      if k == key and b == data), None)
            if i is not None:
                _frames.append(_frames.pop(i))
                tracer = _frames[-1][2]
        if i is None:
            extracted = tables_of(scene, engine)
    scene = scene.to(device)
    if i is None:
        kprof.count("tables.frame.packed")
        tracer = (make[0](scene, cfg) if extracted is None
                  else make[1](scene, cfg, extracted))
        with _lock:
            _frames.append((key, data, tracer))
            del _frames[:-FRAME_CACHE]
    else:
        kprof.count("tables.frame.reused")
    return kwf.render_cuda(scene, cfg=cfg, tracer=tracer, **kw)
