"""Multi-process distribution (kytpu/dist/multihost.py): bootstrap,
render, film tiles, on torch.distributed.

`initialize` joins this process to the default process group: from the
environment torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or
from a coordinator address. Each process is one rank and renders on one
device; `global_mesh` lays every rank out on one ("tile", "spp") mesh.
A film strip is rendered by the ranks of its tile and never leaves them
until `all_gather_host` or `render_multihost` gathers the film; each
process writes only its own strips to a checkpoint (`save_film_tiles`), and
`load_film_tiles` reassembles them under any topology. The files are
kytpu's: numpy arrays and a JSON header, so a film that kytpu accumulated
over part of its samples finishes here (`accumulate_tiles(accum=)`).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from kytpu_torch.core import math as km
from kytpu_torch.dist import mesh as kmesh
from kytpu_torch.dist import shard as kshard
from kytpu_torch.integrator import path as kpath


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> None:
    """Join (or create) the default process group.

    With no arguments the group comes from the environment that torchrun
    (`torchrun --nproc_per_node N script.py`) sets: RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT ("env://"). Else coordinator_address
    ("host:port" or a URL such as "tcp://host:port" or "file:///path"),
    num_processes and process_id name it. backend: NCCL where this process
    renders on the card (device "cuda": rank r takes CUDA device LOCAL_RANK,
    or r mod the devices it sees), gloo on the CPU, unless named here
    ("gloo" on the card reduces CUDA tensors through the host; NCCL refuses
    two ranks of one communicator on one card)."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no "
                               "CUDA device (pass device='cpu')")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(dev.index if dev.index is not None
                              else local % torch.cuda.device_count())
    kw = {}
    if num_processes is not None:
        kw = dict(world_size=num_processes, rank=rank)
    dist.init_process_group(backend, init_method=init_method, **kw)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(shape: tuple[int, int] | None = None,
                spp: int | None = None, device="cuda") -> kmesh.Mesh:
    """The ("tile", "spp") mesh over every rank of the default group
    (`mesh.make_mesh`): the ranks of a tile are consecutive, so a tile's
    strip stays on one host where n_spp divides the ranks a host holds."""
    return kmesh.make_mesh(shape=shape, spp=spp, device=device)


def all_gather_host(x: torch.Tensor, group=None) -> np.ndarray:
    """The equal-shaped tensors x of every rank of `group` (default: the
    world), concatenated along dim 0 in rank order, as a numpy array on
    every rank: one collective. For a film, pass a strip and the mesh's
    tile group (`shard.gather_tiles`)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x.detach().cpu().numpy()
    return kshard.gather_rows(x.detach(), group).cpu().numpy()


def accumulate_tiles(scene, mesh: kmesh.Mesh, spp_range: tuple[int, int],
                     seed: int = 1234, cfg=None, mode: str = "path",
                     aov: str | None = None,
                     samples_per_chunk: int | None = None,
                     accum=None) -> torch.Tensor:
    """UNNORMALIZED film sums of this rank's strip over sample ids [s0, s1)
    -> (p_loc, 3) on the mesh's device (kytpu's accumulate_tiles).

    A lane's radiance depends on (seed, sample id, pixel id) alone, so the
    accumulation can stop at any sample boundary, be saved with
    `save_film_tiles`, and resume on another mesh, in another process
    layout or from a film that kytpu wrote: pass the rows that
    `load_film_tiles` reassembles as `accum` with the new mesh and the
    remaining sample range. The final film is the uninterrupted render's
    where the chunks (samples_per_chunk) and the spp axis match; else it
    agrees to the order of its float32 sums. Rows of accum past the new
    padded film are dropped, missing ones start at 0."""
    cfg = cfg or kpath.PathConfig()
    scene = scene.to(mesh.device)
    cam = scene.camera
    npix = cam.width * cam.height
    pid, p0, npad = kshard.strip_of(mesh, npix)
    acc = None
    if accum is not None:
        rows = np.zeros((npad, 3), np.float32)
        a = np.asarray(accum, np.float32).reshape(-1, 3)
        n = min(npad, a.shape[0])
        rows[:n] = a[:n]
        acc = torch.from_numpy(rows[p0:p0 + pid.shape[0]]).to(mesh.device)
    return kshard.accumulate(scene, mesh, spp_range[0], spp_range[1], seed,
                             cfg, mode, aov, samples_per_chunk, acc)


def render_multihost(scene, mesh: kmesh.Mesh, spp: int = 16,
                     seed: int = 1234, cfg=None, mode: str = "path",
                     aov: str | None = None, clamp: bool = True,
                     samples_per_chunk: int | None = None) -> np.ndarray:
    """A full frame on a (multi-process) mesh -> numpy (H, W, 3) on every
    rank: `accumulate_tiles` over all samples, then one all_gather of the
    strips over the tile group."""
    cam = scene.camera
    w, h = cam.width, cam.height
    acc = accumulate_tiles(scene, mesh, (0, spp), seed=seed, cfg=cfg,
                           mode=mode, aov=aov,
                           samples_per_chunk=samples_per_chunk)
    flat = all_gather_host(km.div(acc, float(spp)), mesh.tile_group)
    img = flat[:w * h].reshape(h, w, 3)
    return np.clip(img, 0.0, 1.0) if clamp else img


def save_film_tiles(path: str, strip: torch.Tensor, mesh: kmesh.Mesh,
                    step: int | None = None,
                    total_rows: int | None = None) -> str:
    """Per-process film checkpoint, kytpu's layout: each process writes
    `{path}.proc{rank}.npz` atomically, with its tile's rows [p0, p1) as
    "tile_0_{p0}_{p1}" where it is the first rank of its tile (each tile
    once) and none otherwise, and a JSON header (step, process,
    process_count, total_rows: the padded film's rows by default). No
    collective. Returns the file."""
    p_loc = strip.shape[0]
    p0 = mesh.tile * p_loc
    payload = ({f"tile_0_{p0}_{p0 + p_loc}": strip.detach().cpu().numpy()}
               if mesh.spp == 0 else {})
    meta = dict(step=step, process=mesh.rank, process_count=mesh.world,
                total_rows=total_rows or p_loc * mesh.shape["tile"])
    out = f"{path}.proc{mesh.rank}.npz"
    d = os.path.dirname(os.path.abspath(out))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **payload)
        os.replace(tmp, out)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return out


def load_film_tiles(path: str) -> tuple[np.ndarray, int | None]:
    """The full film from every `{path}.proc{k}.npz` that this package's
    or kytpu's save_film_tiles wrote (any process topology) -> (rows
    (total_rows, 3), step)."""
    files, k = [], 0
    while os.path.exists(f"{path}.proc{k}.npz"):
        files.append(f"{path}.proc{k}.npz")
        k += 1
    if not files:
        raise FileNotFoundError(f"no {path}.proc*.npz files")
    full, step = None, None
    for f in files:
        with np.load(f, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            step = meta.get("step")
            for name in z.files:
                if name == "__meta__":
                    continue
                tile = z[name]
                if full is None:
                    full = np.zeros((meta["total_rows"],) + tile.shape[1:],
                                    tile.dtype)
                _, _, a, b = name.split("_")
                a, b = int(a), min(int(b), full.shape[0])
                full[a:b] = tile[:b - a]
    if full is None:
        raise ValueError(f"{path}.proc*.npz hold no film rows")
    return full, step
