"""Sharded rendering over a ("tile", "spp") mesh (kytpu/dist/shard.py) on
torch.distributed.

Each rank owns a strip of flat pixels (its tile) and a slice of the
sample budget (its place on the "spp" axis), renders that (samples x
pixels) block with the single-device lane function, sums its samples in
sample order, and adds its partial sums to the other ranks of its tile
with one all_reduce(SUM) over the mesh's spp group a pass. Film strips stay
on their ranks (`render_tiles`, `multihost.accumulate_tiles`) until the
caller gathers them (`render_sharded` and `render_sharded_pallas` end with
one all_gather over the tile group, `gather_tiles`).

A lane's radiance depends on (seed, sample id, pixel id) alone under the
jnp engines and under the kernels' "hash" and "sobol" samplers, so an
image does not depend on the mesh's shape beyond the order of the float32
sums: a 1x1 mesh gives the single-device frame to the bit, other shapes
agree within a few ulps (the sample sums add in another association).

The sharded train step (diff/inverse.py `make_train_step(mesh=)`) uses
`sum_over`: the forward all_reduce of a tile's partial images, whose
backward is the identity, since every rank of a tile computes the same
tile loss from the same reduced image; the step then sums the parameter
gradients over the world once and divides by the tiles, kytpu's pmean over
"tile".
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.dist.mesh import Mesh
from kytpu_torch.integrator import path as kpath
from kytpu_torch.integrator.render import trace_lanes
from kytpu_torch.kernels import route as kroute
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.kernels.launch import M32, as_i32, i32
from kytpu_torch.scene import scene as kscene

# render_sharded_pallas' engines: "auto" and "cuda" route as
# render(engine="cuda") does (K5 past 64 surfaces where the big-scene
# tables take the scene, else K1), "bigscene" runs K5
PALLAS_ENGINES = ("auto", "cuda", "bigscene")


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def strip_of(mesh: Mesh, npix: int):
    """(pixel ids of this rank's strip (p_loc,) int64 on the mesh's device,
    its first row, the padded film's rows): the film's npix flat pixels
    padded to a multiple of the tiles, tile t owning rows [t p_loc, (t + 1)
    p_loc); a padding row renders pixel row % npix and is dropped at
    gathering."""
    npad = _pad_to(npix, mesh.shape["tile"])
    p_loc = npad // mesh.shape["tile"]
    p0 = mesh.tile * p_loc
    pid = torch.arange(p0, p0 + p_loc, dtype=torch.int64,
                       device=mesh.device) % npix
    return pid, p0, npad


def slice_of(mesh: Mesh, s0: int, count: int) -> torch.Tensor:
    """This rank's share of sample ids [s0, s0 + count): the contiguous
    count / n_spp ids at its place on the "spp" axis."""
    n_spp = mesh.shape["spp"]
    if count % n_spp:
        raise ValueError(f"{count} samples not divisible by the spp axis "
                         f"size {n_spp}")
    per = count // n_spp
    a = s0 + mesh.spp * per
    return torch.arange(a, a + per, dtype=torch.int64, device=mesh.device)


class _SumOver(torch.autograd.Function):
    """all_reduce(SUM) over a group; the backward is the identity: every
    rank of the group uses the same sum, so its own share of the gradient
    is the upstream gradient (torch.distributed.nn's all_reduce would sum
    the upstream gradients of the group's ranks instead)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of `group`, differentiable with an identity
    backward (`_SumOver`)."""
    return _SumOver.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The equal-shaped x of every rank of `group`, concatenated along dim
    0 in rank order, on every rank. gloo gathers CPU tensors only, so a
    CUDA tensor of a gloo group crosses through the host."""
    n = dist.get_world_size(group)
    src = x.cpu() if (x.is_cuda and dist.get_backend(group) == "gloo") \
        else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def gather_tiles(mesh: Mesh, strip: torch.Tensor, npix: int) -> torch.Tensor:
    """(npix, 3) film on every rank from each tile's (p_loc, 3) strip: one
    all_gather over the tile group (the ranks of a tile hold the same
    strip once its samples are reduced)."""
    return gather_rows(strip, mesh.tile_group)[:npix]


def accumulate(scene, mesh: Mesh, s0: int, s1: int, seed: int, cfg,
               mode: str = "path", aov: str | None = None,
               samples_per_chunk: int | None = None, accum=None):
    """UNNORMALIZED sums of this rank's strip over sample ids [s0, s1)
    through the jnp engines -> (p_loc, 3) on the mesh's device. Passes of
    samples_per_chunk samples (a multiple of the spp axis; all of them by
    default), each rank's share of a pass summed in sample order, then one
    all_reduce over the spp group a pass; accum (p_loc, 3), if given,
    starts the sum."""
    cam = scene.camera
    w, npix = cam.width, cam.width * cam.height
    n_spp = mesh.shape["spp"]
    pid, _, _ = strip_of(mesh, npix)
    p_loc = pid.shape[0]
    key = krng.root_key(seed, mesh.device)
    k = samples_per_chunk or (s1 - s0)
    k = max(n_spp, (k // n_spp) * n_spp)
    acc = accum
    s = s0
    while s < s1:
        kk = min(k, s1 - s)
        sid = slice_of(mesh, s, kk)
        lane_pid = pid.repeat(sid.shape[0])
        out = trace_lanes(scene, key, (lane_pid % w).float(),
                          (lane_pid // w).float(), lane_pid,
                          sid.repeat_interleave(p_loc), cfg, mode,
                          aov).reshape(sid.shape[0], p_loc, 3)
        part = torch.zeros((p_loc, 3), dtype=torch.float32,
                           device=mesh.device)
        for j in range(sid.shape[0]):
            part += out[j]
        dist.all_reduce(part, group=mesh.spp_group)
        acc = part if acc is None else acc + part
        s += kk
    return acc


def render_tiles(scene, mesh: Mesh, spp: int = 16, seed: int = 1234,
                 cfg=None, mode: str = "path", aov: str | None = None,
                 samples_per_chunk: int | None = None) -> torch.Tensor:
    """This rank's strip of the frame (`strip_of`): (p_loc, 3), the mean
    of spp samples a pixel, unclamped, still on its rank (for pipelines
    that keep tiles where they were rendered: checkpointing partial films,
    per-host encoding)."""
    cfg = cfg or kpath.PathConfig()
    scene = scene.to(mesh.device)
    acc = accumulate(scene, mesh, 0, spp, seed, cfg, mode, aov,
                     samples_per_chunk)
    return km.div(acc, float(spp))


def render_sharded(scene, mesh: Mesh, spp: int = 16, seed: int = 1234,
                   cfg=None, mode: str = "path", aov: str | None = None,
                   clamp: bool = True,
                   samples_per_chunk: int | None = None) -> torch.Tensor:
    """A full frame through the jnp engines on a ("tile", "spp") mesh ->
    (H, W, 3) on every rank (kytpu's render_sharded). samples_per_chunk
    bounds the lanes in flight a rank; it is rounded to a multiple of the
    spp axis. With one chunk (the default) a 1x1 mesh gives
    render(engine="jnp")'s frame to the bit; other shapes add the samples
    in another association."""
    cam = scene.camera
    strip = render_tiles(scene, mesh, spp=spp, seed=seed, cfg=cfg, mode=mode,
                         aov=aov, samples_per_chunk=samples_per_chunk)
    img = gather_tiles(mesh, strip, cam.width * cam.height).reshape(
        cam.height, cam.width, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img


def _kernel_sampler(cfg: kwf.KernelConfig) -> kwf.KernelConfig:
    """kytpu's sharded sampler mapping: "random" (the default) becomes the
    decomposition-invariant "hash"; "prng" asks for the per-rank seeded
    "random" stream."""
    if cfg.sampler == "random":
        return dataclasses.replace(cfg, sampler="hash")
    if cfg.sampler == "prng":
        return dataclasses.replace(cfg, sampler="random")
    return cfg


def render_sharded_pallas(scene, mesh: Mesh, spp: int = 16, seed: int = 1234,
                          kernel_cfg: kwf.KernelConfig | None = None,
                          clamp: bool = True, engine: str = "auto",
                          rays_per_pass: int = 1 << 20) -> torch.Tensor:
    """A full frame through the kernels on a ("tile", "spp") mesh -> (H, W,
    3) on every rank (kytpu's render_sharded_pallas).

    Each rank traces its strip times its sample slice in passes of k =
    min(its samples, rays_per_pass // its pixels) samples a pixel through
    K1, or K5 (engine: "auto" and "cuda" route as render(engine="cuda")
    does, "bigscene" runs K5), sums each pass's samples, and adds the sum
    to its tile's other ranks with one all_reduce a pass. Jitter and rays
    are built as `kwf.render_cuda` builds them. The default sampler
    ("random") runs as "hash", so the image does not depend on the mesh's
    shape; "sobol" keeps that property with low-discrepancy points; "prng"
    asks for the "random" stream, seeded per rank with kytpu's dev_seed
    (seed + 7919 tile + 104729 spp index, and 15485863 a later pass), so
    reproducible per mesh shape only. A 1x1 mesh gives render(engine=
    "cuda", rays_per_pass=, cfg=the mapped config)'s frame to the bit where
    its passes trace spp samples (k divides spp). kytpu's one exception
    stays: under nee="single" the scalar light pick of a tile of cfg.rows *
    128 lanes (K1, K2) depends on the lanes a rank holds, so that image
    depends on the decomposition."""
    if engine not in PALLAS_ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected one of "
                         f"{PALLAS_ENGINES}")
    cfg = _kernel_sampler(kernel_cfg or kwf.KernelConfig())
    kwf.check_config(cfg)
    scene = scene.to(mesh.device)
    tracer = kroute.tracer(scene, cfg, "bigscene" if engine == "bigscene"
                           else "cuda")
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    dev = mesh.device
    pid, _, _ = strip_of(mesh, npix)
    p_loc = pid.shape[0]
    sid = slice_of(mesh, 0, spp)
    s_loc = sid.shape[0]
    k = max(1, min(s_loc, rays_per_pass // p_loc))
    key = krng.key(seed, dev)
    accum = torch.zeros((p_loc, 3), dtype=torch.float32, device=dev)
    for p, s in enumerate(range(0, s_loc, k)):
        kk = min(k, s_loc - s)
        pid_k = pid.repeat(kk)
        si = sid[s:s + kk].repeat_interleave(p_loc)
        if cfg.sampler == "sobol":
            u = krng.uniform2(krng.fold_in(key, pid_k), "sobol", si)
        elif cfg.sampler == "hash":
            u = krng.uniform(krng.fold_in(key, si * npix + pid_k), (2,))
        else:
            u = krng.uniform(krng.fold_in(krng.fold_in(key, si), pid_k),
                             (2,))
        o, d = kscene.generate_rays(cam, torch.stack(
            [(pid_k % w).to(torch.float32) + u[:, 0],
             (pid_k // w).to(torch.float32) + u[:, 1]], dim=-1))
        if cfg.sampler in ("hash", "sobol"):
            out = tracer(scene, o, d, seed, as_i32(si & M32),
                         pid_k.to(torch.int32))
        else:
            out = tracer(scene, o, d, i32(
                seed + 7919 * mesh.tile + 104729 * mesh.spp
                + 15485863 * p))
        part = out.reshape(kk, p_loc, 3).sum(dim=0)
        dist.all_reduce(part, group=mesh.spp_group)
        accum = accum + part
    img = gather_tiles(mesh, km.div(accum, float(spp)), npix).reshape(
        h, w, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img
