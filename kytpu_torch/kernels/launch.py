"""The launch protocol that every hand-written kernel of the port shares
(K1-K8, the tag sort and segment sums, the camera rays): the device test,
the launch on the current stream with its span and counter, the checks of
a launch's tables and lanes, and the int32 and config arguments.
"""

from __future__ import annotations

import torch

from kytpu_torch.kernels import tables as ktab
from kytpu_torch.utils import profiling as kprof

# lanes a row of a tile (cfg.rows rows a tile)
LANE = 128
M32 = 0xFFFFFFFF
SAMPLERS = {"random": 0, "hash": 1, "sobol": 2}
# the kernel keeps the sobol words of at most 4 draw sites a bounce in a
# constant table (csrc/wavefront_fwd.cu MAX_SITES)
MAX_SOBOL_DEPTH = 64


def i32(v: int) -> int:
    return ((int(v) + (1 << 31)) % (1 << 32)) - (1 << 31)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def on_card(dev: torch.device) -> bool:
    if dev.type in ("cuda", "cpu"):
        return dev.type == "cuda"
    raise ValueError(f"no kernel for device {dev}")


def run(fn, name: str, kernel: str, dev, *args):
    """fn(*args, stream) on dev's current stream, in the span
    `kytpu::launch.<kernel>`; raises on a CUDA error, else counts the
    launch of `kernel` (k1 ... k8, tag_sort, segment_sums, rays)."""
    with torch.cuda.device(dev), kprof.span(f"kytpu::launch.{kernel}"):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    kprof.launched(kernel)


def check_tables(tables, dev, names, ints):
    """The tables `names` of a launch on dev: each there and contiguous,
    int32 where its name is in `ints`, else float32."""
    for name in names:
        t = getattr(tables, name)
        if t.device != dev:
            raise ValueError(f"table {name} is on {t.device}, the lanes on "
                             f"{dev}")
        want = torch.int32 if name in ints else torch.float32
        if not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"table {name} must be contiguous {want}")


def check_lane_tensor(name, t, shape, dtype, dev):
    if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: expected {shape} {dtype} on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def lanes_checked(o, d, si, pix, cfg):
    """The rays and lane ids of a launch, checked -> contiguous (o, d, si,
    pix) on o's device; si and pix are None under the "random" sampler."""
    dev = o.device
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3):
        raise ValueError(f"rays must be (N, 3), got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")
    if d.device != dev:
        raise ValueError(f"d is on {d.device}, o on {dev}")
    if cfg.sampler == "sobol" and cfg.max_depth > MAX_SOBOL_DEPTH:
        raise ValueError(f'sampler="sobol" takes max_depth <= '
                         f"{MAX_SOBOL_DEPTH} on the card")
    o = o.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    if cfg.sampler == "random":
        return o, d, None, None
    if si is None or pix is None:
        raise ValueError(f'sampler="{cfg.sampler}" needs si and pix lane '
                         'arrays')
    si = si.to(device=dev, dtype=torch.int32).contiguous()
    pix = pix.to(device=dev, dtype=torch.int32).contiguous()
    if si.shape != (n,) or pix.shape != (n,):
        raise ValueError(f"si and pix must be ({n},), got {tuple(si.shape)} "
                         f"and {tuple(pix.shape)}")
    return o, d, si, pix


def cfg_args(cfg, seed: int) -> list:
    return [i32(seed), cfg.max_depth, cfg.rr_start, cfg.rows,
            SAMPLERS[cfg.sampler], int(cfg.shadow == "robust")]


def texel_outputs(tables, cfg, n: int, dev):
    """K3's, K4's, K7's and K8's texel entries (12 max_depth, n) and tags
    (4 max_depth, n) where the scene has image textures, else (None,
    None)."""
    if not ktab.has_img(tables.static):
        return None, None
    J = 4 * cfg.max_depth
    return (torch.empty((3 * J, n), dtype=torch.float32, device=dev),
            torch.empty((J, n), dtype=torch.int32, device=dev))
