"""One rank of tests/test_torch_dist.py's gloo group.

    python tests/torch_dist_worker.py RANK WORLD INIT_FILE OUTDIR

Joins a CPU process group of WORLD gloo ranks (file:// rendezvous), runs
the port's sharded paths on several mesh shapes and writes what it got to
OUTDIR/rank{RANK}.npz for the test to compare (rank 0 writes the images;
every rank its losses and parameters). It imports no jax.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kytpu_torch.core import rng as krng  # noqa: E402
from kytpu_torch.diff.inverse import make_train_step  # noqa: E402
from kytpu_torch.dist import make_mesh, render_sharded  # noqa: E402
from kytpu_torch.dist import multihost as mh  # noqa: E402
from kytpu_torch.dist.shard import render_sharded_pallas  # noqa: E402
from kytpu_torch.integrator.path import PathConfig  # noqa: E402
from kytpu_torch.kernels import wavefront as kwf  # noqa: E402
from kytpu_torch.scene import builders  # noqa: E402

# what the test holds the results to: the same scene, seeds and configs
W, H = 16, 16
SPP, SEED = 4, 9
CFG = PathConfig(max_depth=3)
STEP_CFG = PathConfig(max_depth=2)
KCFG = kwf.KernelConfig(max_depth=1, rows=8)
SHAPES = ((4, 1), (2, 2), (1, 4))


def scene():
    return builders.cornell_box(width=W, height=H)


def wrong(sc):
    return dataclasses.replace(sc, mat_diffuse=sc.mat_diffuse * 0.4)


def main(rank: int, world: int, init_file: str, outdir: str) -> None:
    torch.set_num_threads(1)
    mh.initialize(f"file://{init_file}", world, rank, device="cpu")
    out = {}
    sc = scene()
    meshes = {s: make_mesh(shape=s, device="cpu") for s in SHAPES}
    for s, mesh in meshes.items():
        out[f"jnp_{s[0]}x{s[1]}"] = render_sharded(
            sc, mesh, spp=SPP, seed=SEED, cfg=CFG).numpy()
    mesh = meshes[(2, 2)]
    out["chunked"] = render_sharded(sc, mesh, spp=SPP, seed=SEED, cfg=CFG,
                                    samples_per_chunk=2).numpy()
    for s in ((4, 1), (2, 2)):
        out[f"pallas_{s[0]}x{s[1]}"] = render_sharded_pallas(
            sc, meshes[s], spp=2, seed=SEED, kernel_cfg=KCFG).numpy()
    out["multihost"] = mh.render_multihost(sc, mesh, spp=SPP, seed=SEED,
                                           cfg=CFG, clamp=False,
                                           samples_per_chunk=2)
    # train steps on both engines, on the (2, 2) mesh
    target = torch.from_numpy(np.load(os.path.join(outdir, "target.npy")))
    for engine in ("jnp", "cuda"):
        step, params, _ = make_train_step(wrong(sc), target, spp=2,
                                          cfg=STEP_CFG, engine=engine,
                                          mesh=mesh)
        out[f"loss_{engine}"] = np.asarray(float(step(krng.key(11))))
        for k, v in params.items():
            out[f"param_{engine}_{k}"] = v.detach().numpy()
    # a film accumulated over samples [0, 2) on (2, 2), saved, and finished
    # over [2, 4) on (4, 1); and a film that kytpu began
    film = os.path.join(outdir, "film")
    acc = mh.accumulate_tiles(sc, mesh, (0, 2), seed=SEED, cfg=CFG,
                              samples_per_chunk=2)
    mh.save_film_tiles(film, acc, mesh, step=2, total_rows=W * H)
    dist.barrier()
    rows, step = mh.load_film_tiles(film)
    out["resumed_step"] = np.asarray(step)
    for name, path in (("resumed", film),
                       ("resumed_kytpu", os.path.join(outdir, "kytpu_film"))):
        rows, _ = mh.load_film_tiles(path)
        acc2 = mh.accumulate_tiles(sc, meshes[(4, 1)], (2, 4), seed=SEED,
                                   cfg=CFG, samples_per_chunk=2, accum=rows)
        out[name] = mh.all_gather_host(
            acc2, meshes[(4, 1)].tile_group)[:W * H] / 4.0
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
