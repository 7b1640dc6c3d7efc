"""One sharded train step of a tiny Cornell box on n CPU ranks: the
counterpart of the JAX package's `dryrun_multichip` (__graft_entry__.py).

    python -m kytpu_torch.dist.dryrun 4      # 4 gloo ranks, a (2, 2) mesh

spawns n processes that join one gloo group (a file:// rendezvous in a
temporary directory), lay out a ("tile", "spp") mesh of the JAX package's
default shape, and each run one make_train_step(mesh=) step of the jnp
engine and one of the kernels' plain versions (engine="cuda" on CPU
tensors, sampler "hash"); every rank must reach a finite loss and the same
parameters. No process outlives the call.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp


def _rank(rank: int, n: int, init_file: str, out_dir: str) -> None:
    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step, render_once
    from kytpu_torch.dist import multihost
    from kytpu_torch.dist.mesh import default_mesh_shape, make_mesh
    from kytpu_torch.integrator import path as kpath
    from kytpu_torch.scene import builders

    torch.set_num_threads(1)
    multihost.initialize(f"file://{init_file}", n, rank, device="cpu")
    try:
        mesh = make_mesh(shape=default_mesh_shape(n), device="cpu")
        n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
        # tiny but real: the tiles split the pixels, the spp axis the samples
        w, h = 16, max(4, n_tile)
        while (w * h) % n_tile:
            h += 1
        spp = 2 * n_spp
        cfg = kpath.PathConfig(max_depth=3, variant="iteration",
                               strategy="both_mis")
        scene = builders.cornell_box(width=w, height=h)
        target = render_once(scene, krng.key(7), 2, cfg, device="cpu")
        out = {}
        for engine in ("jnp", "cuda"):
            step, params, _ = make_train_step(scene, target.detach(), spp=spp,
                                              cfg=cfg, engine=engine,
                                              mesh=mesh)
            loss = float(step(krng.key(0)))
            if not np.isfinite(loss):
                raise AssertionError(f"{engine}: non-finite loss {loss}")
            out[f"loss_{engine}"] = np.asarray(loss)
            for k, v in params.items():
                out[f"{engine}_{k}"] = v.detach().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_ranks: int) -> dict:
    """Spawn n_ranks CPU ranks, run one sharded step of each engine, and
    check that every rank reached a finite loss and the same parameters
    -> rank 0's {"loss_jnp", "loss_cuda", "<engine>_<name>": ...}."""
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(n_ranks, os.path.join(d, "init"), d),
                           nprocs=n_ranks, join=True, start_method="spawn")
        got = [dict(np.load(os.path.join(d, f"rank{r}.npz")))
               for r in range(n_ranks)]
    for r, res in enumerate(got[1:], 1):
        for k, v in got[0].items():
            if not np.array_equal(v, res[k]):
                raise AssertionError(f"rank {r} differs from rank 0 in {k}")
    return got[0]


if __name__ == "__main__":
    res = dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    print(f"dryrun: losses jnp {float(res['loss_jnp']):.6f}, cuda "
          f"{float(res['loss_cuda']):.6f}; every rank the same parameters")
