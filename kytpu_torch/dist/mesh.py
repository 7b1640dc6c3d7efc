"""Process meshes for sharded rendering (kytpu/dist/mesh.py) on
torch.distributed.

kytpu lays its devices out on a 2D ("tile", "spp") mesh:

  - "tile": pixels. The film is cut into contiguous strips of flat pixel
    ids, one a tile; a strip stays with its ranks.
  - "spp": samples a pixel. The ranks of a tile split its sample budget
    and add their partial sums with one all_reduce a pass.

Here each rank of the default process group is one device of the mesh:
rank r sits at tile r // n_spp and sample slice r % n_spp, so the ranks of
a tile are consecutive (on a multi-host run, host-local when n_spp divides
the ranks a host holds). A `Mesh` holds the two subgroups of its rank: the
"spp" group (the ranks of its tile: they share a strip and reduce its
samples) and the "tile" group (the ranks of its sample slice: the strips
are gathered over it). The group's backend follows the device (NCCL on the
card, gloo on the CPU, `multihost.initialize`), or is what the caller
named; nothing here picks another.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


def default_mesh_shape(n_devices: int,
                       spp: int | None = None) -> tuple[int, int]:
    """(tile, spp) axis sizes for n_devices, kytpu's rule: sample-axis
    parallelism up to 4-way (large strips a device), then tiles."""
    s = 1
    if spp is None:
        spp = 1 << 30
    for cand in (4, 2):
        if n_devices % cand == 0 and spp % cand == 0 and spp >= cand:
            s = cand
            break
    return n_devices // s, s


@dataclass(frozen=True)
class Mesh:
    """A ("tile", "spp") mesh over the ranks of the default process group,
    seen from one rank. shape: {"tile": n_tile, "spp": n_spp}, as kytpu's
    `mesh.shape`; tile, spp: this rank's place; spp_group: the ranks of
    this rank's tile; tile_group: the ranks of its sample slice; device:
    where this rank renders."""

    shape: dict
    rank: int
    tile: int
    spp: int
    spp_group: object
    tile_group: object
    device: torch.device

    @property
    def world(self) -> int:
        return self.shape["tile"] * self.shape["spp"]


def make_mesh(shape: tuple[int, int] | None = None, spp: int | None = None,
              device="cuda") -> Mesh:
    """A ("tile", "spp") mesh over every rank of the default process group,
    which must be initialized (`multihost.initialize`, or
    torch.distributed.init_process_group); world size 1 gives a 1x1 mesh.
    shape defaults to `default_mesh_shape(world size, spp)`. Every rank
    must call it, in the same order as its other group creations
    (torch.distributed.new_group's rule). device: where this rank renders,
    the card by default ("cuda" is the current CUDA device), "cpu" on
    request."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized default process group: call "
            "kytpu_torch.dist.multihost.initialize() (or "
            "torch.distributed.init_process_group) first")
    n = dist.get_world_size()
    t, s = shape or default_mesh_shape(n, spp)
    if t * s != n:
        raise ValueError(f"mesh shape {(t, s)} != {n} ranks")
    rank = dist.get_rank()
    # new_group must see every group on every rank, in one order
    spp_groups = [dist.new_group(list(range(i * s, (i + 1) * s)))
                  for i in range(t)]
    tile_groups = [dist.new_group(list(range(j, n, s))) for j in range(s)]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but torch sees no "
                               "CUDA device (pass device='cpu')")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(shape={"tile": t, "spp": s}, rank=rank, tile=rank // s,
                spp=rank % s, spp_group=spp_groups[rank // s],
                tile_group=tile_groups[rank % s], device=dev)
