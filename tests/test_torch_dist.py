"""kytpu_torch.dist against the single-device port and against kytpu.dist.

The decomposition and a 1x1 mesh run in this process on a world-size-1
gloo group; the sharded paths on several mesh shapes run once per module
in 4 spawned gloo ranks (tests/torch_dist_worker.py, about 7 s), which
write what they got for the tests below.

Tolerances: a sharded jnp frame against the single-device one atol 1e-6
(kytpu's own bound, tests/test_dist.py); a 1x1 mesh to the bit; the
sharded kernel frame against the single-device one atol 2e-5 (kytpu's);
the port against kytpu lane by lane within the jnp engines' bound (rtol
1e-3/atol 1e-4, at most 0.5% of pixels outside) and the kernels' (the
same bound); the sharded step against the unsharded one rtol 1e-5 on the
loss and atol 1e-5 on the parameters (kytpu's).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kytpu.dist import mesh as jmesh
from kytpu.dist import multihost as jmh
from kytpu.dist import shard as jshard
from kytpu.integrator import path as jpath
from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch.core import rng as krng
from kytpu_torch.diff.inverse import make_train_step, render_once
from kytpu_torch.dist import mesh as tmesh
from kytpu_torch.dist import multihost as tmh
from kytpu_torch.dist import shard as tshard
from kytpu_torch.integrator.render import render
from tests import torch_dist_worker as wk
import tests.torch_threads  # noqa: F401  (one torch thread a process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def port_scene():
    return wk.scene()


def kytpu_scene():
    return jb.cornell_box(width=wk.W, height=wk.H)


def kytpu_cfg(cfg):
    return jpath.PathConfig(max_depth=cfg.max_depth)


def within_jnp_bound(got, ref, max_share=0.005):
    got = np.asarray(got, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    share = (~np.isclose(got, ref, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert share <= max_share, share


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn WORLD gloo ranks once; -> (their results, the run's dir)."""
    d = tmp_path_factory.mktemp("torch_dist")
    target = render_once(port_scene(), krng.key(7), 2, wk.STEP_CFG,
                         device="cpu")
    np.save(d / "target.npy", target.numpy())
    # a film that kytpu began: samples [0, 2) on its (2, 2) mesh
    acc = jmh.accumulate_tiles(kytpu_scene(),
                               jmesh.make_mesh(jax.devices()[:4],
                                               shape=(2, 2)),
                               (0, 2), seed=wk.SEED, cfg=kytpu_cfg(wk.CFG),
                               samples_per_chunk=2)
    jmh.save_film_tiles(str(d / "kytpu_film"), acc, step=2,
                        total_rows=wk.W * wk.H)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
         str(r), str(WORLD), str(d / "init"), str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)], d


@pytest.fixture(scope="module")
def single_hdr():
    """The single-device port frame the sharded ones are held to,
    unclamped."""
    return render(port_scene(), spp=wk.SPP, seed=wk.SEED, cfg=wk.CFG,
                  engine="jnp", device="cpu", clamp=False).numpy()


@pytest.fixture(scope="module")
def single(single_hdr):
    return np.clip(single_hdr, 0.0, 1.0)


@pytest.fixture
def world_one(tmp_path):
    """A world-size-1 gloo group in this process."""
    tmh.initialize(f"file://{tmp_path / 'init'}", 1, 0, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("spp", [None, 1, 2, 3, 8])
def test_default_mesh_shape_is_kytpus(n, spp):
    assert tmesh.default_mesh_shape(n, spp) == jmesh.default_mesh_shape(
        n, spp)


@pytest.mark.parametrize("shape, npix", [((4, 1), 256), ((2, 2), 250),
                                         ((1, 4), 7), ((3, 2), 100)])
def test_decomposition_covers_the_film_once(shape, npix):
    """Each rank's strip and sample slice, its body's lanes run here for
    every rank in turn: the tiles cover the padded film once and the
    ranks of a tile its samples once."""
    t, s = shape
    rows = np.zeros(-(-npix // t) * t, int)
    for rank in range(t * s):
        mesh = tmesh.Mesh(shape={"tile": t, "spp": s}, rank=rank,
                          tile=rank // s, spp=rank % s, spp_group=None,
                          tile_group=None, device=torch.device("cpu"))
        pid, p0, npad = tshard.strip_of(mesh, npix)
        assert npad == len(rows)
        np.testing.assert_array_equal(
            pid.numpy(), np.arange(p0, p0 + pid.shape[0]) % npix)
        if mesh.spp == 0:
            rows[p0:p0 + pid.shape[0]] += 1
        sid = tshard.slice_of(mesh, 8, 4 * s)
        np.testing.assert_array_equal(
            sid.numpy(), 8 + 4 * mesh.spp + np.arange(4))
    assert (rows == 1).all()
    with pytest.raises(ValueError, match="divisible"):
        tshard.slice_of(mesh, 0, 4 * s + 1) if s > 1 else \
            tshard.slice_of(tmesh.Mesh({"tile": 1, "spp": 2}, 0, 0, 0, None,
                                       None, torch.device("cpu")), 0, 3)


def test_one_by_one_mesh_is_the_single_device_render(world_one, single):
    """World size 1: make_mesh's 1x1 mesh renders the single-device frames
    to the bit (jnp engines; the kernels' plain versions under hash), and
    refuses a shape the ranks do not fill."""
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"tile": 1, "spp": 1}
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_mesh(shape=(2, 1), device="cpu")
    img = tshard.render_sharded(port_scene(), mesh, spp=wk.SPP,
                                seed=wk.SEED, cfg=wk.CFG)
    np.testing.assert_array_equal(img.numpy(), single)
    kcfg = dataclasses.replace(wk.KCFG, sampler="hash")
    got = tshard.render_sharded_pallas(port_scene(), mesh, spp=2,
                                       seed=wk.SEED, kernel_cfg=wk.KCFG)
    ref = render(port_scene(), spp=2, seed=wk.SEED, cfg=kcfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    strip = tshard.render_tiles(port_scene(), mesh, spp=wk.SPP, seed=wk.SEED,
                                cfg=wk.CFG)
    np.testing.assert_array_equal(np.clip(strip.numpy(), 0, 1),
                                  single.reshape(-1, 3))


@pytest.mark.parametrize("shape", ["4x1", "2x2", "1x4"])
def test_render_sharded_matches_single_device(ranks, single, shape):
    got, _ = ranks
    for r in range(WORLD):   # every rank holds the gathered frame
        np.testing.assert_allclose(got[r][f"jnp_{shape}"], single, atol=1e-6)
    np.testing.assert_allclose(got[0]["chunked"], single, atol=1e-6)


def test_render_sharded_matches_kytpu(ranks):
    got, _ = ranks
    ref = np.asarray(jshard.render_sharded(
        kytpu_scene(), jmesh.make_mesh(shape=(4, 2)), spp=wk.SPP,
        seed=wk.SEED, cfg=kytpu_cfg(wk.CFG)))
    for shape in ("4x1", "2x2", "1x4"):
        within_jnp_bound(got[0][f"jnp_{shape}"], ref)


def test_render_sharded_pallas_matches_single_device_and_kytpu(ranks):
    """The plain K1 sharded (depth 1, the default sampler run as "hash"):
    against render(engine="cuda") under "hash" (kytpu's atol 2e-5) and
    against kytpu's render_sharded_pallas, interpreted, on its (4, 2) mesh
    (tests/test_dist.py:69-81, :106)."""
    got, _ = ranks
    hcfg = dataclasses.replace(wk.KCFG, sampler="hash")
    ref = render(port_scene(), spp=2, seed=wk.SEED, cfg=hcfg,
                 device="cpu").numpy()
    ref_j = np.asarray(jshard.render_sharded_pallas(
        kytpu_scene(), jmesh.make_mesh(shape=(4, 2)), spp=2, seed=wk.SEED,
        kernel_cfg=jwf.KernelConfig(max_depth=1, rows=8), interpret=True))
    for shape in ("4x1", "2x2"):
        img = got[0][f"pallas_{shape}"]
        assert img.shape == (wk.H, wk.W, 3) and img.mean() > 0.005
        np.testing.assert_allclose(img, ref, atol=2e-5)
        within_jnp_bound(img, ref_j)


@pytest.mark.parametrize("engine", ["jnp", "cuda"])
def test_sharded_step_matches_unsharded(ranks, engine):
    """One step on the (2, 2) mesh against the unsharded step (the kernel
    engine's sampler "hash" on both); every rank the same parameters."""
    got, d = ranks
    target = torch.from_numpy(np.load(d / "target.npy"))
    step, params, _ = make_train_step(
        wk.wrong(port_scene()), target, spp=2, cfg=wk.STEP_CFG,
        engine=engine, kernel_sampler="hash" if engine == "cuda" else None,
        device="cpu")
    loss = float(step(krng.key(11)))
    assert np.isfinite(loss)
    assert np.isclose(float(got[0][f"loss_{engine}"]), loss, rtol=1e-5)
    for k, v in params.items():
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r][f"param_{engine}_{k}"],
                                          got[0][f"param_{engine}_{k}"])
        np.testing.assert_allclose(got[0][f"param_{engine}_{k}"],
                                   v.detach().numpy(), atol=1e-5, err_msg=k)


def test_accumulate_tiles_resumes_on_another_topology(ranks, single_hdr):
    """Samples [0, 2) accumulated on (2, 2), saved per rank, reassembled
    and finished over [2, 4) on (4, 1); and a film that kytpu accumulated
    over [0, 2) on its (2, 2) mesh, finished here."""
    got, d = ranks
    assert int(got[0]["resumed_step"]) == 2
    np.testing.assert_allclose(got[0]["resumed"],
                               single_hdr.reshape(-1, 3), atol=1e-6)
    np.testing.assert_allclose(got[0]["multihost"], single_hdr, atol=1e-6)
    rows, _ = tmh.load_film_tiles(str(d / "film"))
    assert rows.shape == (wk.W * wk.H, 3)
    ref = np.asarray(jshard.render_sharded(
        kytpu_scene(), jmesh.make_mesh(shape=(4, 2)), spp=wk.SPP,
        seed=wk.SEED, cfg=kytpu_cfg(wk.CFG), clamp=False))
    within_jnp_bound(got[0]["resumed_kytpu"], ref)
    # kytpu's own half and the port's agree to the lanes' bound
    k_rows, k_step = tmh.load_film_tiles(str(d / "kytpu_film"))
    assert k_step == 2
    within_jnp_bound(k_rows, rows)


def test_dryrun_multichip_on_two_ranks():
    from kytpu_torch.dist.dryrun import dryrun_multichip

    res = dryrun_multichip(2)
    assert np.isfinite(float(res["loss_jnp"]))
    assert np.isfinite(float(res["loss_cuda"]))
