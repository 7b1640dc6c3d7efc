"""What the render and inverse command lines share: joining a process
mesh, and printing and writing on rank 0 alone."""

from __future__ import annotations

import os
import socket

import torch.distributed as dist


def join_mesh(shape, device):
    """A ("tile", "spp") mesh of the given shape over the default process
    group. Where no group exists yet it joins one: from torchrun's
    environment when WORLD_SIZE is set, else a group of this process alone
    on a free localhost port."""
    from kytpu_torch.dist import make_mesh, multihost
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            multihost.initialize(device=device)
        else:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            multihost.initialize(f"tcp://127.0.0.1:{port}", 1, 0,
                                 device=device)
    return make_mesh(shape=shape, device=device)


def is_root() -> bool:
    """Rank 0 of the default process group, or a process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def say(*a) -> None:
    """print on rank 0 alone."""
    if is_root():
        print(*a, flush=True)
