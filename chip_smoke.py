"""Smoke run of kytpu_torch on one NVIDIA GPU: build, check, render, train,
time.

    python3 chip_smoke.py            # a few minutes on an H100

Phases, one line each (a few for phase 3):
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles each kytpu_torch/kernels/csrc/*.cu with its own nvcc,
     all started together, and prints each source's nvcc time and what
     -Xptxas -v said of each kernel;
  3. kernels vs plain, on 256K camera rays at depth 5, for Veach MIS and two
     Cornell boxes, across the three samplers, both NEE modes, both shadow
     modes and both exponent modes (a trainable-exponent case on Veach's
     four Phong planks), with the scene's tables staged in shared memory
     and, on a Veach and a Cornell case, read from device memory
     (kernels/wavefront.py STAGE_BUDGET 0 forces that route): the forward
     megakernel K1 against its plain PyTorch version (bit for bit; and
     the tolerance the other kernels are held to: at most 0.5% of lanes
     outside rtol=1e-3/atol=1e-4 per channel, and the means within 3
     standard errors); the residual forward K2's radiance against K1's (bit
     for bit), its radiance and its cache against the plain K2 (bit for
     bit, and plane by plane: each plane at most 0.5% of lanes outside
     rtol=1e-3/atol=1e-4; the int planes: at most 0.5% of lanes differ);
     the coefficient-cache backward K3 on a seeded upstream
     gradient against the plain K3 (each table within rtol=1e-4 plus 1e-6
     of its largest entry) and against itself (bit for bit, two launches);
     the path-replay backward K4 on the same lanes and gradient against the
     plain K4 (the same bound), against itself (bit for bit) and against
     K3 (rtol=2e-3 plus 2e-5 of the table's largest entry, the reference's
     bound for this cross-check); in the exponent case K2's "Bk"/"tuk"
     planes and K3's and K4's dexp are among the checked;
  4. frames: render(veach_mis(512, 308)) and render(cornell_box 256x256) at
     64 spp through render(engine="cuda"), the main path, whose launches are
     counted, and the Veach frame again with cfg sampler="sobol"; each
     64-spp frame and a 4-spp frame of each default-sampler scene against
     the same frame traced by the plain version (same seed and pass split,
     so the same lanes: 946176 a pass for Veach, 1048576 for Cornell); then one
     warmed frame of each under torch.profiler: the device's busy time, the
     kernel's share of it, and the device's idle share of the median wall
     time of 5 unprofiled warmed frames;
  5. timing: Veach forward at 4M lanes, depth 5, CUDA events, kernel and
     plain, and the two outputs compared (bit for bit);
  6. forward+backward: bench.py's workload (Veach 512x308, depth 5, 4M
     lanes, loss = out.sum() / N) through make_cuda_diff_tracer: its time
     and peak memory, then K2, K3 and K1 alone under CUDA events, the plain
     K2 and K3, and the kernels against them on those 4M lanes (bounds of
     phase 3; K2 and its cache bit for bit), and each kernel's bound
     (`bounds`; `k1_ops` counts the shadow sweeps the data surely needs);
     K1 and K2 again with the tables read from device memory (timed, bit
     for bit the staged route's); the SIMT share of K1 and K2 on those
     lanes from K2's cache (`simt_share`), one lane a thread against
     dead-lane refill; then the same workload
     through make_cuda_diff_tracer(backward="replay"), the replay path,
     whose launches are counted: its time and peak memory, K4 alone, the
     plain K4, the tracer's gradient against K4's (bit for bit), K4
     against the plain K4 and against K3 on those lanes; and K3 and K4 on
     the row-tagged route forced (kernels/wavefront.py DENSE_MAX_ROWS 0),
     timed beside the dense ones and held to them (bounds of phase 3);
  7. training, the second main path: five make_train_step(engine="cuda")
     steps on the Cornell box at its published 256x256, 4 spp, depth 3,
     kernel_sampler="hash", from the true scene with its diffuse table
     scaled by 0.4, against the true scene rendered at 64 spp: launches
     counted, ms per step, one step profiled. All five steps take one key,
     so each lowers the same estimator: the loss must fall at every step
     and the diffuse table must move towards the truth (with a new key a
     step, the loss also carries each key's Monte Carlo noise, which on
     small frames outweighs a few steps' gain). A sixth step records what
     its diff tracer gave K2 and K3 (tables, lanes, seed, the upstream
     gradient of relmse): K2's radiance against K1's on those lanes (bit
     for bit), K2 and its cache against the plain K2, K3 against the plain
     K3 on the step's own gradient (bounds of phase 3), and K3 against
     itself (bit for bit);
  8. glossiness training: five make_train_step steps on veach_mis(512, 308)
     at 4 spp, depth 3, kernel_sampler="sobol", names=TRAINABLE +
     ("mat_exponent",) with the exponent in softplus space, from the true
     scene with its plank exponents halved, against the true scene
     rendered at 64 spp: launches counted, ms per step, one step profiled,
     one key; the loss must fall from step 1 to step 5 and so must the mean
     |log e - log e_true| over the plank rows; a sixth step's own K2 and K3
     calls against their plain versions, as in phase 7;
  9. big scenes, past 64 surfaces, on the table-driven kernels of
     kernels/bigscene.py: random_spheres(n=1024) (1,026 surfaces) and
     mesh_scene(icosphere(3)) (1,282) at 256x256.
     a. K5, K6, K7 and the path-replay backward K8 against their plain
        versions on 64K camera rays at depth 3 of each scene, under each
        sampler, both shadow modes and both exponent modes (the bounds of
        phase 3); K6's radiance against K5's, K7 and K8 against themselves,
        bit for bit; K8 against K7 (the bound of K4 against K3);
     b. K5 against K1 on the Cornell box (256K lanes, depth 5): the share
        of lanes within 1e-3 (at least 99.5%; K5 reads each hit's Phong
        exponent from its row, K1 folds the scene's one exponent into
        constants), and a 16-spp frame through render(engine="bigscene");
     c. 16-spp frames of both scenes at depth 3 through render(), the main
        path (render routes past 64 surfaces to K5; launches counted, K1-K4
        must stay at 0), each against the same frame through the plain K5,
        then 5 warmed frames and one profiled: busy time, K5's share, idle
        share;
     d. benchmarks/run.py's K5 workload (spheres, 1M pixel-centre lanes,
        depth 3): K5, K6, K7 and K8 under CUDA events, the plain versions
        once each and the kernels against them, forward+backward through
        make_bigscene_diff_tracer (time, peak memory, its gradient K7's bit
        for bit) and through make_bigscene_diff_tracer(backward="replay"),
        the replay path, whose launches are counted (K5 and K8: time, peak
        memory, its gradient K8's bit for bit), and the bounds of K5
        (`k5_ops`), K6, K7 and K8 (`k8_ops`);
     e. training past 64 surfaces, the third main path: five
        make_train_step steps on the spheres at 256x256, 4 spp, depth 3,
        hash, from the true scene with the spheres' diffuse colours scaled
        by 0.4, one key, against the true scene at 64 spp: launches counted
        (K6 and K7, and K1-K4 at 0), the loss falling at every step, ms per
        step, one step profiled, and a sixth step's own K6 and K7 calls
        against their plain versions, as in phase 7.
 10. textures through K1-K4 (kytpu's checker floor and back-wall images):
     a. the textured K1, K2, K3 and K4 against their plain versions on 64K
        camera rays at depth 5 of 256x256 Cornell boxes with a checker
        floor, an 8x8 back-wall atlas (kytpu's select-chain route) and a
        16x16 one (its separable route), across samplers, NEE and shadow
        modes and both exponent modes (the bounds of phase 3; K1 and K2
        against their plain versions, K2 against K1, K3 and K4 against
        themselves, bit for bit; K4 against K3);
     b. kytpu's textured render (cli/render.py textured: Cornell 512x512,
        a checker floor and a 32x32 painted back wall) at 64 spp through
        render(), the main path, launches counted; a 4-spp frame against
        the plain K1, 5 warmed frames and one profiled;
     c. texture recovery, a main path: five make_train_step(names=
        ("tex_image",)) steps on Cornell 256x256 with a 16x16 back wall,
        from a flat 0.5 grey, 4 spp, depth 3, hash, one key, against the
        true scene at 64 spp: launches counted (K2, K3), the loss and the
        mean |texel - truth| falling, ms per step, one step profiled, a
        sixth step's own K2 and K3 against their plain versions;
     d. five checker-colour steps (names=("tex_color_a", "tex_color_b"),
        from 0.4 of the true colours): the loss falling, as in c;
     e. the textured replay path: make_cuda_diff_tracer(backward=
        "replay") on 1M lanes of the 16x16 scene, launches counted (K1,
        K4), its gradient (texels included) K4's bit for bit, K4's time.
 11. past 64 surfaces on every route kytpu takes: random_spheres(1024)'s
     spheres, light and sky with a textured ground, a 16x16-cell checker
     or an 8x8 atlas (the table kernels take them: K5-K8 with textures) or
     a 16x16 atlas (a separable one, which the tables refuse: K1-K4).
     a. the textured K5, K6, K7 and K8 against their plain versions on 64K
        camera rays at depth 3, under each sampler, both shadow modes and
        both exponent modes (the bounds of phase 3; K6 against K5, K7 and
        K8 against themselves bit for bit, K8 against K7, the texture
        adjoints live); the textured K5 against K1 on a Cornell box with a
        checker floor and an 8x8 back wall (as 9b);
     b. a 16-spp frame of the checker scene through render(), the main
        path: launches counted (K5 only), against the plain K5's frame,
        then 5 warmed frames and one profiled;
     c. five checker-colour steps (names=("tex_color_a", "tex_color_b"),
        from 0.4 of the true colours) on it: launches counted (K6, K7), the
        loss falling, a sixth step's own K6 and K7 against their plain
        versions;
     d. on the 16x16-atlas scene, K1-K4: a 16-spp frame through render()
        (launches counted, K5 at 0), five texel steps (K2, K3), a sixth
        step's own K2 and K3 against their plain versions; K1 and K2 (the
        tables past STAGE_BUDGET, read from device memory) against their
        plain versions bit for bit, the row-tagged K3 and K4 against their
        plain versions and each other on 64K lanes, and on the untextured
        twin against K7 (d_emission on the emissive rows), rows above 255
        live; K1-K4 timed at the 1M
        pixel-centre lanes with their bounds, the plain K1, K3 and K4 once,
        and the replay path (K1 + K4) through make_cuda_diff_tracer, its
        launches counted; then the textured K5, K7 and K8 at the checker
        scene's 1M lanes, the plain K5 and K8 once, and the textured replay
        path (K5 + K8), its launches counted;
     e. a smallpt frame through render() (K1), launches counted, and K1
        and K2 against their plain versions bit for bit on 64K lanes.
The line before the last is the kernels' JSON record, the one before it
nvidia-smi's name and power limit, and the last line is
{"ok": true, "device": {...}}. Any failed check raises: no result is printed
and the exit code is not 0, and the last line on standard error repeats the
last line printed before the failure, so the tail of standard error alone
says which check was running. It needs a CUDA device and imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

RTOL, ATOL, MAX_BAD_SHARE = 1e-3, 1e-4, 0.005
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # the latter times the table's largest entry
# K4 against K3: the reference's bound (tests/test_kernel.py:630)
CROSS_RTOL, CROSS_ATOL = 2e-3, 2e-5
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s and
# FP32 operations/s outside the tensor cores
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12


def compare(got: torch.Tensor, ref: torch.Tensor, what: str):
    """Lane-by-lane check of the kernel against the plain version."""
    g = got.double().cpu().numpy()
    r = ref.double().cpu().numpy()
    if not (np.isfinite(g).all() and np.isfinite(r).all()):
        raise AssertionError(f"{what}: non-finite values")
    bad = ~np.isclose(g, r, rtol=RTOL, atol=ATOL)
    share = float(bad.reshape(len(g), -1).any(-1).mean())
    gf, rf = g.reshape(len(g), -1), r.reshape(len(r), -1)
    se = rf.std(0) / np.sqrt(len(rf)) + 1e-12
    mean_dev = float(np.max(np.abs(gf.mean(0) - rf.mean(0)) / se))
    max_abs = float(np.abs(g - r).max())
    if share > MAX_BAD_SHARE or mean_dev > 3.0:
        raise AssertionError(f"{what}: {share:.5f} of lanes outside the "
                             f"bound, mean off by {mean_dev:.2f} SE")
    return share, max_abs, mean_dev


def compare_cache(resf, resi, ref_f, ref_i, what: str) -> float:
    """Plane by plane: each float plane at most MAX_BAD_SHARE of lanes
    outside rtol/atol, the int planes at most MAX_BAD_SHARE of lanes
    differing. Returns the max |err| over the float planes."""
    if resf.shape != ref_f.shape or resi.shape != ref_i.shape:
        raise AssertionError(f"{what}: cache shapes differ")
    if not torch.isfinite(resf).all():
        raise AssertionError(f"{what}: non-finite cache entries")
    bad = ~torch.isclose(resf, ref_f, rtol=RTOL, atol=ATOL)
    worst = float(bad.float().mean(1).max())
    ints = float((resi != ref_i).any(0).float().mean())
    if worst > MAX_BAD_SHARE or ints > MAX_BAD_SHARE:
        raise AssertionError(f"{what}: a cache plane has {worst:.5f} of lanes "
                             f"outside the bound, the int planes {ints:.5f}")
    return float((resf - ref_f).abs().max())


def same_bits(got, ref, what: str) -> None:
    """K1's radiance, or K2's (radiance, resf, resi), against the plain
    version's on the same lanes, to the last bit."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for k, (a, b) in enumerate(zip(got, ref)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: output {k} differs from the plain "
                                 f"version's in {int((a != b).sum())} entries")


def compare_grads(got, ref, what: str, rtol=GRAD_RTOL,
                  atol=GRAD_ATOL) -> float:
    """Each table (dd, ds, de, denv[, dexp][, dta, dtb][, dti]) within rtol
    plus atol of its largest entry; returns the max |err|."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} tables, expected {len(ref)}")
    err = 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        tol = rtol * b.abs() + atol * max(1.0, float(b.abs().max()))
        if not torch.isfinite(a).all() or ((a - b).abs() > tol).any():
            raise AssertionError(f"{what}: table {k} outside the bound")
        err = max(err, float((a - b).abs().max()))
    return err


def k1_ops(static, cache, cfg) -> float:
    """FP32 operations (add, sub, mul, div, sqrt, min/max, one per
    transcendental call) that K1 must do for the lanes of a run, counted
    from csrc/wavefront_fwd.cu for a scene of fast-path planar rows and
    sphere lights (Veach): per surface in the closest-hit sweep 31 (planar)
    or 33 (sphere), 32 per hit for the normal and the emission MIS; below
    the horizon 62 for the frame and material, 6 for the shared azimuth,
    134 per light for its sample and BSDF evaluation, 90 for the BSDF
    sample and the extension. Of the nee="all" shadow sweeps only what the
    data surely needs is counted, as `k5_ops` counts it: each shadow ray
    that reached its light (a nonzero "B" plane of K2's cache for these
    lanes) tested every row whose skip bit for its light is clear, at 27 (a
    fast planar row), 34 (any other planar row) or 19 (a sphere) a row, and
    a lane-bounce with such a ray computed the shared terms of each row
    that some light does not skip once (33 a fast planar row, 13 a sphere).
    Blocked rays stop early and are left out, and the nee="single" sweep is
    not counted, so the count is a lower bound. Live lane-bounces come from
    K2's cache of the same lanes: a lane reaches bounce b > 0 iff its "tu"
    plane at b - 1 is not 0."""
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import shapes as kshapes
    ix, _ = kwf.residual_layout(static, cfg)
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(cfg.max_depth)]
    planar, n_sp, n_l = static["planar"], len(static["spheres"]), len(
        static["lights"])
    hit = 31 * len(planar) + 33 * n_sp + 32
    shade = 62 + 6 + 134 * n_l + 90
    ops = float(sum(reached[:-1]) * (hit + shade) + reached[-1] * hit)
    if kwf.picks_one_light(cfg, n_l) or not n_l:
        return ops
    rows_skip, sph_skip = kwf._occl_skips(static, cfg)
    fast = [s["kind"] != kshapes.DISK and bool(s.get("fast"))
            for s in planar]
    ray_row = [sum(27 if fast[r] else 34 for r in range(len(planar))
                   if r not in rows_skip[i]) + 19 * (n_sp - len(sph_skip[i]))
               for i in range(n_l)]
    shared_row = (33 * sum(1 for r in range(len(planar)) if fast[r] and any(
        r not in rows_skip[i] for i in range(n_l)))
        + 13 * sum(1 for j in range(n_sp) if any(
            j not in sph_skip[i] for i in range(n_l))))
    for b in range(cfg.max_depth):
        lit = torch.stack([cache[ix[("B", b, i)]] != 0 for i in range(n_l)])
        ops += sum(ray_row[i] * int(lit[i].sum()) for i in range(n_l))
        ops += shared_row * int(lit.any(0).sum())
    return ops


def k4_ops(static, cache, cfg) -> float:
    """FP32 operations of K4 (csrc/wavefront_fwd.cu, MODE_REPLAY) for the
    lanes of a run: K1's (`k1_ops`, a lower bound, the shadow sweeps the
    data surely needs included) plus the adjoint terms, counted from the
    source: 9 per live lane-bounce for the hit emission, and below the
    horizon 21 per light (emission, colour adjoints), 3 for E_b and 31 for
    the tail peel and the extension's adjoint."""
    n_l = len(static["lights"])
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(cfg.max_depth)]
    adj = sum(reached[:-1]) * (9 + 21 * n_l + 3 + 31) + reached[-1] * 9
    return k1_ops(static, cache, cfg) + float(adj)


def simt_share(static, cache, cfg, chunk: int) -> tuple:
    """SIMT efficiency of K1 and K2 on the lanes of K2's cache: the
    lane-bounces (a lane traces bounce 0 and each b > 0 whose "tu" plane
    at b - 1 is not 0) over 32 x each warp's iterations, one lane a thread
    (a warp of 32 consecutive lanes runs its longest path) and with
    dead-lane refill (a warp's chunk of `chunk` lanes handed to its 32
    slots in order as they free, as csrc/wavefront_fwd.cu does) ->
    (lane-bounces, before, after)."""
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n = cache.shape[1]
    iters = torch.ones(n, dtype=torch.int64, device=cache.device)
    for b in range(cfg.max_depth):
        iters += (cache[ix[("tu", b)]] != 0).long()
    iters = iters.cpu().numpy()
    total = int(iters.sum())
    pad = -n % chunk
    lanes = np.concatenate([iters, np.zeros(pad, np.int64)])
    before = 32 * int(lanes.reshape(-1, 32).max(1).sum())
    lanes = lanes.reshape(-1, chunk)
    free = lanes[:, :32].copy()
    rows = np.arange(len(lanes))
    for j in range(32, chunk):
        s = free.argmin(1)
        free[rows, s] += lanes[:, j]
    after = 32 * int(free.max(1).sum())
    return total, total / before, total / after


def k3_ops(static, cfg, n: int) -> float:
    """FP32 operations of K3 (csrc/wavefront_bwd_res.cu), which walks every
    bounce of every lane: 45 per bounce below the horizon plus 27 per NEE
    ("B") plane of the cache, 6 at the horizon."""
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n_b = sum(1 for t in ix if t[0] == "B" and t[1] == 0)
    return float(n * (cfg.max_depth * (45 + 27 * n_b) + 6))


def k5_ops(tables, cache, cfg) -> float:
    """FP32 operations (as `k1_ops` counts them) that K5 must do for the
    lanes of a run, counted from csrc/bigscene_fwd.cu: a row of the
    closest-hit sweep costs 39 (triangle), 38 (rect), 26 (disk) or 34
    (sphere); a hit 32 for its normal and the emission MIS; a bounce below
    the horizon K1's 62 + 6 + 134 a light + 90 for the shading. Of the
    occlusion sweep only what the data surely needs is counted: each shadow
    ray that reached its light (a nonzero "B" plane of K6's cache for these
    lanes) tested every row, at 27 (planar), 28 (disk) or 19 (sphere) a
    row, and a lane-bounce with such a ray computed each row's shared terms
    once (33, 11, 13). Blocked rays are left out, so the count is a lower
    bound. Live lane-bounces as in `k1_ops`."""
    from kytpu_torch.kernels import bigscene as kbs
    st = tables.static
    n_l = len(st["lights"])
    ix, _ = kbs.layout_of(st, cfg)
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(cfg.max_depth)]
    n_tri, n_rect, n_disk, n_sph = tables.counts
    sweep = 39 * n_tri + 38 * n_rect + 26 * n_disk + 34 * n_sph + 32
    ray_row = 27 * (n_tri + n_rect) + 28 * n_disk + 19 * n_sph
    shared_row = 33 * (n_tri + n_rect) + 11 * n_disk + 13 * n_sph
    rays = vertices = 0
    for b in range(cfg.max_depth):
        lit = torch.stack([cache[ix[("B", b, i)]] != 0 for i in range(n_l)])
        rays += int(lit.sum())
        vertices += int(lit.any(0).sum())
    shade = 62 + 6 + 134 * n_l + 90
    return float(sum(reached) * sweep + sum(reached[:-1]) * shade
                 + rays * ray_row + vertices * shared_row)


def k8_ops(tables, cache, cfg) -> float:
    """FP32 operations of K8 (csrc/bigscene_fwd.cu, MODE_REPLAY) for the
    lanes of a run: K5's (`k5_ops`, a lower bound) plus the adjoint terms,
    counted from the source: 9 per live lane-bounce for the hit emission's
    adjoint and E_b, 12 more where the scene has an environment light, and
    below the horizon 21 per light (the emission and colour adjoints), 3 for
    E_b and 31 for the tail peel and the extension's adjoint. Live
    lane-bounces as in `k1_ops`, from K6's cache of the same lanes."""
    from kytpu_torch.kernels import bigscene as kbs
    st = tables.static
    n_l = len(st["lights"])
    ix, _ = kbs.layout_of(st, cfg)
    reached = [cache.shape[1]] + [int((cache[ix[("tu", b)]] != 0).sum())
                                  for b in range(cfg.max_depth)]
    env = 12 if ("wenv", 0) in ix else 0
    adj = sum(reached) * (9 + env) + sum(reached[:-1]) * (21 * n_l + 3 + 31)
    return k5_ops(tables, cache, cfg) + float(adj)


def demo_texture(n: int = 16) -> np.ndarray:
    """kytpu's (n, n, 3) texture-recovery pattern (kytpu/cli/inverse.py
    `demo_texture`, which imports jax): an RGB gradient and a yellow
    ring."""
    y, x = np.mgrid[0:n, 0:n] / max(n - 1, 1)
    img = np.stack([x, y, 1.0 - 0.5 * (x + y)], -1)
    r = np.hypot(x - 0.5, y - 0.5)
    img[np.abs(r - 0.3) < 0.08] = (0.9, 0.9, 0.1)
    return img.astype(np.float32)


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) on the H100's peaks."""
    t_b, t_o = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def jittered_rays(scene, n: int, seed: int):
    from kytpu_torch.scene.scene import generate_rays
    cam = scene.camera
    npix = cam.width * cam.height
    rng = np.random.default_rng(seed)
    pid = np.arange(n) % npix
    pf = np.stack([pid % cam.width + rng.random(n),
                   pid // cam.width + rng.random(n)], -1).astype(np.float32)
    o, d = generate_rays(cam, torch.from_numpy(pf).cuda())
    si = torch.from_numpy((np.arange(n) // npix).astype(np.int32)).cuda()
    return o, d, si, torch.from_numpy(pid.astype(np.int32)).cuda()


@contextlib.contextmanager
def recording(kmod):
    """While the block runs, keep the arguments and (detached) result of
    the last trace_lanes, bwd_res and bwd_replay call of the kernel module
    kmod (kernels/wavefront.py or kernels/bigscene.py: the diff tracers look
    them up in their module). The colour, exponent and texture tables are
    copied at the call: an optimizer step later updates the parameters they
    share storage with."""
    seen = {}
    real = {nm: getattr(kmod, nm) for nm in ("trace_lanes", "bwd_res",
                                             "bwd_replay")
            if hasattr(kmod, nm)}

    def wrap(nm):
        def fn(tables, *args, **kw):
            out = real[nm](tables, *args, **kw)
            seen[nm] = (dataclasses.replace(tables, **{
                k: getattr(tables, k).clone() for k in (
                    "diffuse", "specular", "emission", "exponent",
                    "light_emit", "env", "texa", "texb", "timg")
                if hasattr(tables, k)}),
                args, kw, tuple(t.detach() for t in out)
                if isinstance(out, tuple) else out.detach())
            return out
        return fn

    for nm in real:
        setattr(kmod, nm, wrap(nm))
    try:
        yield seen
    finally:
        for nm, fn in real.items():
            setattr(kmod, nm, fn)


def cuda_time_ms(fn, reps: int):
    """(ms per call of fn, fn's last output), from CUDA events after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


# device kernels by name in a profile, mangled or demangled (K3's
# sum_partials_kernel: no K4 runs in the profiled windows)
K1_NAMES = ("wavefront_fwd_kernel<0,", "wavefront_fwd_kernelILi0E")
K2_NAMES = ("wavefront_fwd_kernel<1,", "wavefront_fwd_kernelILi1E")
K3_NAMES = ("bwd_res_kernel", "sum_partials_kernel")
K5_NAMES = ("bigscene_fwd_kernel<0,", "bigscene_fwd_kernelILi0E")
K6_NAMES = ("bigscene_fwd_kernel<1,", "bigscene_fwd_kernelILi1E")
K7_NAMES = ("bigscene_bwd_lanes", "bigscene_segment_sums",
            "sum_partials_kernel")
K8_NAMES = ("bigscene_fwd_kernel<2,", "bigscene_fwd_kernelILi2E",
            "bigscene_segment_sums", "sum_partials_kernel")


def once_ms(fn):
    """(ms of one call of fn, its output), from CUDA events, not warmed:
    for the plain versions, which take seconds at the main path's sizes."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def pixel_centre_rays(scene, n: int):
    """benchmarks/run.py's lanes: pixel centres, lane i at pixel i mod
    W*H."""
    from kytpu_torch.scene.scene import generate_rays
    cam = scene.camera
    pid = torch.arange(n, device="cuda") % (cam.width * cam.height)
    pf = torch.stack([(pid % cam.width).float() + 0.5,
                      (pid // cam.width).float() + 0.5], -1)
    return generate_rays(cam, pf)


def device_profile(fn, kernels: dict):
    """Run fn once under torch.profiler -> (device busy ms, {name: ms in
    the device kernels whose name holds one of kernels[name]}, number of
    device kernels). Busy time is the union of the device kernels'
    intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    mine = {k: sum(e.time_range.elapsed_us() for e in evs
                   if any(p in e.name for p in pats)) / 1e3
            for k, pats in kernels.items()}
    for k, ms in mine.items():
        if ms == 0:
            raise AssertionError(f"the profile shows no {k} kernel")
    return busy_us / 1e3, mine, len(evs)


def check_recorded_step(kmod, seen, what: str, ks=("K1", "K2", "K3")):
    """A train step's own residual forward and cache backward calls, kept by
    `recording`: ks names (forward, residual forward, cache backward), K1,
    K2 and K3 of kernels/wavefront.py or K5, K6 and K7 of
    kernels/bigscene.py (kmod). The residual forward's radiance against the
    forward's on the step's lanes (bit for bit), it and its cache against
    its plain version, the backward on the step's upstream gradient against
    its plain version and against itself (bit for bit) -> (the residual
    forward's, the backward's max |err|)."""
    kf, kr, kb = ks
    tabs, (scfg, so, sd, sseed, ssi, spix), kw, (k2, resf, resi) = \
        seen["trace_lanes"]
    if not kw.get("residual"):
        raise AssertionError(f"the {what} did not run {kr}")
    _, (_, sg, *_), _, grads = seen["bwd_res"]
    if not torch.equal(k2, kmod.trace_lanes(tabs, scfg, so, sd, sseed, ssi,
                                            spix)):
        raise AssertionError(f"{kr}'s radiance is not {kf}'s bit for bit on "
                             f"a {what}'s lanes")
    if not all(torch.equal(a, b) for a, b in zip(
            grads, kmod.bwd_res(tabs, scfg, sg, k2, resf, resi))):
        raise AssertionError(f"{kb}'s gradient does not repeat bit for bit "
                             f"on a {what}")
    ref_l, ref_f, ref_i = kmod.trace_lanes_plain(tabs, scfg, so, sd, sseed,
                                                 ssi, spix, residual=True)
    share, mabs, _ = compare(k2, ref_l, f"{kr}, a {what}")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"{kr} cache, a {what}")
    gerr = compare_grads(grads, kmod.bwd_res_plain(
        tabs, scfg, sg, ref_l, ref_f, ref_i), f"{kb}, a {what}")
    print(f"{what} vs plain: {so.shape[0]} lanes, depth {scfg.max_depth}, "
          f"{scfg.sampler}/{scfg.nee}/{scfg.shadow}"
          f"{', trainable exponent' if scfg.trainable_exponent else ''}, "
          f"upstream gradient of relmse: {kr} radiance = {kf}'s bit for bit, "
          f"{share:.5f} of lanes outside vs plain (max |err| {mabs:.3g}); "
          f"cache {resf.shape[0]}+{resi.shape[0]} planes within the bound "
          f"(max |err| {cerr:.3g}); {kb} ({len(grads)} tables) within the "
          f"bound (max |err| {gerr:.3g}), repeats bit for bit", flush=True)
    return max(mabs, cerr), gerr


def main() -> None:
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch sees none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch: {name}, {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from kytpu_torch.core import rng as krng
    from kytpu_torch.diff.inverse import make_train_step
    from kytpu_torch.diff.params import TRAINABLE
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import build
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders
    STAGE_BUDGET = kwf.STAGE_BUDGET

    def reset_counts():
        kwf.launches = kwf.launches_res_fwd = kwf.launches_res_bwd = 0
        kwf.launches_replay = 0

    def counts():
        return (kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd,
                kwf.launches_replay)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    each = ", ".join(f"{k} {v:.2f} s" for k, v in build.nvcc_seconds.items())
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds else 0:.2f} s; "
          f"each source's nvcc -c, all started together: {each})", flush=True)
    for line in build.ptxas_report.splitlines():
        print(f"build: {line}", flush=True)

    # 3. kernel vs plain on the card
    n_lanes = 262144
    variant = {builders.LARGE_GLASS_SPHERE, builders.LIGHT_POINT,
               builders.LIGHT_DIRECTION, builders.LIGHT_ENVIRONMENT}
    scenes = {
        "veach": builders.veach_mis(512, 308).to("cuda"),
        "cornell": builders.cornell_box(width=256, height=256).to("cuda"),
        "cornell_lights": builders.cornell_box(variant, width=256,
                                               height=256).to("cuda"),
    }
    # the last field: the tables' route in K1, K2 and K4 (staged in shared
    # memory, or read from device memory: STAGE_BUDGET 0 forces the latter)
    cases = [("veach", "random", "all", "parity", False, "shared"),
             ("veach", "hash", "single", "robust", False, "shared"),
             ("veach", "sobol", "all", "parity", False, "shared"),
             ("veach", "random", "all", "parity", True, "shared"),
             ("veach", "hash", "all", "robust", True, "device"),
             ("cornell", "hash", "all", "robust", False, "shared"),
             ("cornell", "sobol", "single", "robust", False, "shared"),
             ("cornell", "random", "all", "parity", False, "device"),
             ("cornell_lights", "random", "single", "parity", False,
              "shared"),
             ("cornell_lights", "hash", "all", "parity", False, "shared")]
    max_abs_err = 0.0                # K1
    err_res = err_bwd = 0.0          # K2, K3
    err_replay = 0.0                 # K4
    for sc_name, sampler, nee, shadow, texp, route in cases:
        scene = scenes[sc_name]
        cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                               shadow=shadow, trainable_exponent=texp)
        tag = f"{sc_name} {sampler}/{nee}/{shadow}" + (
            " trainable exponent" if texp else "") + f", tables in {route} memory"
        o, d, si, pix = jittered_rays(scene, n_lanes, 11)
        kwf.STAGE_BUDGET = STAGE_BUDGET if route == "shared" else 0
        tables = kwf.pack_tables(scene, cfg)
        if (tables.stage_bytes > 0) != (route == "shared"):
            raise AssertionError(f"{tag}: the tables take the other route")
        before = kwf.launches
        got = kwf.render_lanes_cuda(scene, o, d, 77, cfg, si, pix)
        torch.cuda.synchronize()
        if kwf.launches != before + 1:
            raise AssertionError("render_lanes_cuda did not launch the kernel")
        ref = kwf.trace_lanes_plain(tables, cfg, o, d, 77, si, pix)
        share, mabs, mdev = compare(got, ref, tag)
        same_bits(got, ref, f"K1 {tag}")
        max_abs_err = max(max_abs_err, mabs)
        print(f"kernel vs plain: {tag}: "
              f"{n_lanes} lanes, {share:.5f} outside rtol={RTOL}/atol={ATOL}, "
              f"max |err| {mabs:.3g}, mean within {mdev:.2f} SE; K1 = plain "
              f"bit for bit", flush=True)
        # K2, K3 and K4 on the same lanes
        before = counts()
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 77, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        grads = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        again = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 77, si, pix, g, got)
        k4_again = kwf.bwd_replay(tables, cfg, o, d, 77, si, pix, g, got)
        torch.cuda.synchronize()
        if counts() != (before[0], before[1] + 1, before[2] + 2,
                        before[3] + 2):
            raise AssertionError("trace_lanes/bwd_res/bwd_replay did not "
                                 "launch K2/K3/K4")
        if not torch.equal(k2, got):
            raise AssertionError("K2's radiance is not K1's bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("K3's gradient does not repeat bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(k4, k4_again)):
            raise AssertionError("K4's gradient does not repeat bit for bit")
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 77, si,
                                                    pix, residual=True)
        share2, mabs2, _ = compare(k2, ref_l, f"K2 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {tag}")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i), f"K2 {tag}")
        gerr = compare_grads(grads, kwf.bwd_res_plain(
            tables, cfg, g, ref_l, ref_f, ref_i), f"K3 {tag}")
        rerr = compare_grads(k4, kwf.bwd_replay_plain(
            tables, cfg, o, d, 77, si, pix, g, ref), f"K4 {tag}")
        xerr = compare_grads(k4, grads, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_res = max(err_res, mabs2, cerr)
        err_bwd = max(err_bwd, gerr)
        err_replay = max(err_replay, rerr)
        print(f"residual kernels vs plain: {tag}: K2 radiance and cache = "
              f"plain bit for bit; "
              f"K2 radiance = K1's bit for bit, {share2:.5f} of lanes outside "
              f"vs plain (max |err| {mabs2:.3g}); cache {resf.shape[0]}+"
              f"{resi.shape[0]} planes within the bound (max |err| "
              f"{cerr:.3g}); K3 within the bound (max |err| {gerr:.3g}), "
              f"repeats bit for bit", flush=True)
        print(f"replay kernel vs plain: {tag}: K4 within the bound (max "
              f"|err| {rerr:.3g}), repeats bit for bit; K4 vs K3 within "
              f"rtol={CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr:.3g})",
              flush=True)
        if texp:
            ix, _ = kwf.residual_layout(tables.static, cfg)
            kplanes = [k for t, k in ix.items() if t[0] in ("Bk", "tuk")]
            kerr = float((resf[kplanes] - ref_f[kplanes]).abs().max())
            live = int((ref_f[kplanes] != 0).sum())
            print(f"exponent: {tag}: {len(kplanes)} Bk/tuk planes "
                  f"({live} nonzero entries) within the bound (max |err| "
                  f"{kerr:.3g}); dexp of K3 {grads[4].tolist()}, of K4 "
                  f"{k4[4].tolist()}", flush=True)
            if live == 0 or not bool((grads[4] != 0).any()):
                raise AssertionError("the exponent case exercised no "
                                     "phong lane")

    kwf.STAGE_BUDGET = STAGE_BUDGET

    # 4. frames through the main path (render, engine="cuda")
    veach_frame = builders.veach_mis(512, 308)
    frame_scenes = {"veach": veach_frame,
                    "cornell": builders.cornell_box(width=256, height=256)}
    # (scene, render's cfg) of each frame; None is render()'s default
    frame_cases = {**{nm: (sc, None) for nm, sc in frame_scenes.items()},
                   "veach sobol": (veach_frame,
                                   kwf.KernelConfig(sampler="sobol"))}
    spp, seed = 64, 1234

    def frame(sc, n_spp, cfg=None):
        return render(sc, spp=n_spp, seed=seed, cfg=cfg, clamp=False,
                      engine="cuda", device="cuda")

    reset_counts()
    frames = {}
    for nm, (sc, fcfg) in frame_cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(sc, spp, fcfg)
        torch.cuda.synchronize()
        frames[nm] = (img, time.perf_counter() - t0)
    render_launches = counts()
    if render_launches[0] == 0:
        raise AssertionError("the main path launched no kernel")
    for nm, (img, secs) in frames.items():
        a = img.cpu().numpy()
        if a.shape[-1] != 3 or not np.isfinite(a).all() or (a < 0).any():
            raise AssertionError(f"{nm} frame: not finite and non-negative")
        print(f"frame: {nm} {a.shape[1]}x{a.shape[0]} {spp} spp in {secs:.3f} s, "
              f"mean {a.mean():.5f}, clamped mean {np.clip(a, 0, 1).mean():.5f}",
              flush=True)
    for nm, (sc, fcfg) in frame_cases.items():
        # the same render, traced by the plain version instead
        sc = sc.to("cuda")
        cfg = fcfg or kwf.KernelConfig()
        tables = kwf.pack_tables(sc, cfg)

        def plain(s, o, d, *args):
            return kwf.trace_lanes_plain(tables, cfg, o, d, *args)

        for n_spp in ((spp, 4) if fcfg is None else (spp,)):
            got = frames[nm][0] if n_spp == spp else frame(sc, n_spp)
            ref = kwf.render_cuda(sc, spp=n_spp, seed=seed, cfg=cfg,
                                  clamp=False, rays_per_pass=1 << 20,
                                  tracer=plain)
            share, mabs, _ = compare(got.reshape(-1, 3), ref.reshape(-1, 3),
                                     f"{nm} {n_spp}-spp frame")
            max_abs_err = max(max_abs_err, mabs)
            print(f"frame vs plain: {nm} {n_spp} spp: {share:.5f} of pixels "
                  f"outside the bound, max |err| {mabs:.3g}", flush=True)
    for nm, sc in frame_scenes.items():
        frame(sc, spp)   # warm
        walls = []
        for _ in range(5):   # host time varies from frame to frame
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(sc, spp)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        busy, mine, n_k = device_profile(lambda: frame(sc, spp),
                                         {"K1": K1_NAMES})
        mine = mine["K1"]
        print(f"profile: {nm} {spp} spp: wall {wall:.3f} ms (median of 5 "
              f"warmed frames, not profiled: {min(walls):.3f}-"
              f"{max(walls):.3f}); device busy {busy:.3f} ms in {n_k} kernels "
              f"(idle share {1 - busy / wall:.3f}); wavefront_fwd {mine:.3f} "
              f"ms = {mine / busy:.3f} of device busy time, "
              f"{mine / wall:.3f} of wall", flush=True)

    # 5. timing: Veach forward, depth 5
    n_time = 1 << 22
    sc = scenes["veach"]
    cfg = kwf.KernelConfig(max_depth=5)
    o, d, _, _ = jittered_rays(sc, n_time, 3)
    tracer = kwf.make_cuda_tracer(sc, cfg)
    tables = kwf.pack_tables(sc, cfg)
    ms, got = cuda_time_ms(lambda: tracer(sc, o, d, 5), 5)
    plain_ms, ref = cuda_time_ms(
        lambda: kwf.trace_lanes_plain(tables, cfg, o, d, 5), 1)
    share, mabs, mdev = compare(got, ref, f"veach {n_time} lanes")
    same_bits(got, ref, f"K1 veach {n_time} lanes")
    max_abs_err = max(max_abs_err, mabs)
    print(f"timing: veach fwd depth 5, {n_time} lanes: kernel {ms:.3f} ms "
          f"({n_time / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms "
          f"({n_time / plain_ms / 1e3:.2f} Mrays/s) on {smi}; "
          f"{share:.5f} of lanes outside the bound, max |err| {mabs:.3g}, "
          f"K1 = plain bit for bit", flush=True)

    del ref

    # 6. forward+backward: bench.py's workload through the diff tracer
    leaves = [t.clone().requires_grad_() for t in
              (sc.mat_diffuse, sc.mat_specular, sc.emission)]
    env0 = torch.zeros(3, device="cuda")
    diff_tracer = kwf.make_cuda_diff_tracer(sc, cfg)

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        loss = diff_tracer(*leaves, env0, o, d, 5).sum() / n_time
        loss.backward()
        return loss

    fb_ms, _ = cuda_time_ms(fwd_bwd, 5)
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res_grads = [t.grad.clone() for t in leaves]

    # the same workload through the replay path (K1 forward, K4 backward)
    replay_tracer = kwf.make_cuda_diff_tracer(sc, cfg, backward="replay")

    def fwd_bwd_replay():
        for t in leaves:
            t.grad = None
        loss = replay_tracer(*leaves, env0, o, d, 5).sum() / n_time
        loss.backward()
        return loss

    torch.cuda.synchronize()
    reset_counts()
    fbr_ms, _ = cuda_time_ms(fwd_bwd_replay, 5)
    replay_launches = counts()
    if replay_launches[3] == 0 or replay_launches[1:3] != (0, 0):
        raise AssertionError(f"the replay path launched K1/K2/K3/K4 "
                             f"{replay_launches}")
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd_replay()
    torch.cuda.synchronize()
    peak_replay_gb = torch.cuda.max_memory_allocated() / 1e9
    k2_ms, (k2, resf, resi) = cuda_time_ms(
        lambda: kwf.trace_lanes(tables, cfg, o, d, 5, residual=True), 5)
    k1_ms, k1 = cuda_time_ms(lambda: kwf.trace_lanes(tables, cfg, o, d, 5), 5)
    g = torch.full((n_time, 3), 1.0 / n_time, device="cuda")
    k3_ms, grads = cuda_time_ms(
        lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi), 5)
    if not (torch.equal(k1, k2) and torch.equal(k1, got)):
        raise AssertionError("K2's radiance is not K1's bit for bit at 4M lanes")
    if not all(torch.equal(a, b) for a, b in zip(grads, res_grads)):
        raise AssertionError("the diff tracer's gradient is not K3's")
    k4_ms, k4 = cuda_time_ms(
        lambda: kwf.bwd_replay(tables, cfg, o, d, 5, None, None, g, k1), 5)
    if not all(torch.equal(a, t.grad) for a, t in zip(k4, leaves)):
        raise AssertionError("the replay tracer's gradient is not K4's")
    # the row-tagged K3 and K4 (the route past 64 surfaces) forced on the
    # same lanes: what the dense route saves at Veach's rows
    kwf.DENSE_MAX_ROWS = 0
    try:
        k3t_ms, k3t = cuda_time_ms(
            lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi), 5)
        k4t_ms, k4t = cuda_time_ms(
            lambda: kwf.bwd_replay(tables, cfg, o, d, 5, None, None, g, k1), 5)
    finally:
        kwf.DENSE_MAX_ROWS = 64
    terr = max(compare_grads(k3t, grads, f"tagged K3 vs K3 veach {n_time} "
                             "lanes"),
               compare_grads(k4t, k4, f"tagged K4 vs K4 veach {n_time} lanes"))
    del k3t, k4t
    print(f"row-tagged route forced: veach depth 5, {n_time} lanes: K3 "
          f"{k3t_ms:.3f} ms against the dense K3's {k3_ms:.3f} ms, K4 "
          f"{k4t_ms:.3f} ms against the dense K4's {k4_ms:.3f} ms (with the "
          f"sorts and sums by row); tagged vs dense max |diff| {terr:.3g}; on "
          f"{smi}", flush=True)
    plain_k2_ms, (ref_l, ref_f, ref_i) = cuda_time_ms(
        lambda: kwf.trace_lanes_plain(tables, cfg, o, d, 5, residual=True), 1)
    plain_k3_ms, ref_g = cuda_time_ms(
        lambda: kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i), 1)
    plain_k4_ms, ref_g4 = cuda_time_ms(
        lambda: kwf.bwd_replay_plain(tables, cfg, o, d, 5, None, None, g,
                                     ref_l), 1)
    share, mabs, _ = compare(k2, ref_l, f"K2 veach {n_time} lanes")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {n_time} lanes")
    same_bits((k2, resf, resi), (ref_l, ref_f, ref_i),
              f"K2 veach {n_time} lanes")
    gerr = compare_grads(grads, ref_g, f"K3 veach {n_time} lanes")
    rerr = compare_grads(k4, ref_g4, f"K4 veach {n_time} lanes")
    xerr = compare_grads(k4, grads, f"K4 vs K3 veach {n_time} lanes",
                         CROSS_RTOL, CROSS_ATOL)
    err_res = max(err_res, mabs, cerr)
    err_bwd = max(err_bwd, gerr)
    err_replay = max(err_replay, rerr)
    del ref_l, ref_f, ref_i, ref_g, ref_g4
    cache_bytes = resf.numel() * 4 + resi.numel() * 4
    ray_bytes = n_time * (24 + 12)   # rays in, radiance out
    ops1 = k1_ops(tables.static, resf, cfg)
    ops4 = k4_ops(tables.static, resf, cfg)
    bounds = {
        "K1": bound_ms(ray_bytes, ops1),
        "K2": bound_ms(ray_bytes + cache_bytes, ops1),
        "K3": bound_ms(cache_bytes + n_time * 24,
                       k3_ops(tables.static, cfg, n_time)),
        # rays, g and L in; the gradient vector out is a few hundred bytes
        "K4": bound_ms(n_time * (24 + 12 + 12), ops4),
    }
    print(f"fwd+bwd: veach depth 5, {n_time} lanes, loss = out.sum() / N "
          f"through make_cuda_diff_tracer: {fb_ms:.3f} ms, peak memory "
          f"{peak_gb:.3f} GB allocated (rays included); K2 {k2_ms:.3f} ms, "
          f"K3 {k3_ms:.3f} ms, K1 {k1_ms:.3f} ms; plain K2 {plain_k2_ms:.1f} "
          f"ms, plain K3 {plain_k3_ms:.1f} ms; cache {resf.shape[0]} float + "
          f"{resi.shape[0]} int planes = {cache_bytes / 1e9:.4f} GB "
          f"({cache_bytes / n_time:.0f} B a lane); K2 vs plain {share:.5f} of "
          f"lanes outside (max |err| {mabs:.3g}), cache max |err| {cerr:.3g}, "
          f"K3 max |err| {gerr:.3g}; on {smi}", flush=True)
    print(f"replay: veach depth 5, {n_time} lanes, loss = out.sum() / N "
          f"through make_cuda_diff_tracer(backward=\"replay\"): {fbr_ms:.3f} "
          f"ms, peak memory {peak_replay_gb:.3f} GB allocated (rays "
          f"included; the residual path's {peak_gb:.3f} GB); launches "
          f"K1/K2/K3/K4 {replay_launches}; K4 {k4_ms:.3f} ms, plain K4 "
          f"{plain_k4_ms:.1f} ms; the tracer's gradient = K4's bit for bit; "
          f"K4 vs plain max |err| {rerr:.3g}; K4 vs K3 within "
          f"rtol={CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr:.3g}); on "
          f"{smi}", flush=True)
    for k, (b_ms, by) in bounds.items():
        print(f"bound: {k} {b_ms:.4f} ms by {by} (K1 ops {ops1:.4g}, K4 ops "
              f"{ops4:.4g}, cache {cache_bytes:.4g} B)", flush=True)
    # the tables read from device memory instead of staged in shared memory
    # (the route of tables past STAGE_BUDGET), on the same lanes
    kwf.STAGE_BUDGET = 0
    try:
        dk1_ms, dk1 = cuda_time_ms(
            lambda: kwf.trace_lanes(tables, cfg, o, d, 5), 5)
        dk2_ms, dk2 = cuda_time_ms(
            lambda: kwf.trace_lanes(tables, cfg, o, d, 5, residual=True), 5)
    finally:
        kwf.STAGE_BUDGET = STAGE_BUDGET
    same_bits(dk1, k1, "K1, tables in device memory")
    same_bits(dk2, (k2, resf, resi), "K2, tables in device memory")
    del dk1, dk2
    print(f"tables in device memory: veach depth 5, {n_time} lanes: K1 "
          f"{dk1_ms:.3f} ms, K2 {dk2_ms:.3f} ms, against {k1_ms:.3f} and "
          f"{k2_ms:.3f} ms with the tables ({tables.stage_bytes} B) staged in "
          f"shared memory; the same bits; on {smi}", flush=True)
    chunk = kwf.refill_chunk(tables, cfg, n_time, residual=True)
    lane_bounces, simt_before, simt_after = simt_share(tables.static, resf,
                                                       cfg, chunk)
    print(f"SIMT: veach depth 5, {n_time} lanes, from K2's cache: "
          f"{lane_bounces} lane-bounces over 32 x the warps' iterations: "
          f"{simt_before:.4f} one lane a thread (a warp runs its longest "
          f"path), {simt_after:.4f} with dead-lane refill ({chunk} lanes a "
          f"warp)", flush=True)
    del k1, k2, resf, resi, grads, g, got, k4

    # 7. training through make_train_step (the second main path)
    true_sc = builders.cornell_box(width=256, height=256)
    tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
    target = render(true_sc, spp=64, seed=99, cfg=tcfg, clamp=False)
    start = dataclasses.replace(true_sc,
                                mat_diffuse=true_sc.mat_diffuse * 0.4)
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash")
    key = krng.fold_in(krng.key(0), 1)
    err0 = float((params["mat_diffuse"].detach().cpu()
                  - true_sc.mat_diffuse).abs().mean())
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    train_launches = counts()
    if train_launches[1] == 0 or train_launches[2] == 0:
        raise AssertionError("the train step launched no K2 or K3")
    err5 = float((params["mat_diffuse"].detach().cpu()
                  - true_sc.mat_diffuse).abs().mean())
    if not (np.isfinite(losses).all() and np.all(np.diff(losses) < 0)
            and err5 < err0):
        raise AssertionError(f"the loss did not fall: {losses}, mean "
                             f"|diffuse - true| {err0} -> {err5}")
    if not all(bool((p >= 0).all()) for p in params.values()):
        raise AssertionError("a parameter went negative")
    step_ms = float(np.median(walls[1:]))
    print(f"train: cornell 256x256, 4 spp, depth 3, hash: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; mean |diffuse - true| "
          f"{err0:.5f} -> {err5:.5f}; {step_ms:.3f} ms a step (median of "
          f"steps 2-5; all: {', '.join(f'{v:.1f}' for v in walls)}); "
          f"launches K1/K2/K3/K4 {train_launches}", flush=True)
    busy, mine, n_k = device_profile(
        lambda: step(key),
        {"K2": K2_NAMES, "K3": K3_NAMES})
    print(f"profile: train step: device busy {busy:.3f} ms in {n_k} kernels "
          f"(idle share {1 - busy / step_ms:.3f} of the median step); K2 "
          f"{mine['K2']:.3f} ms, K3 {mine['K3']:.3f} ms = "
          f"{(mine['K2'] + mine['K3']) / busy:.3f} of device busy time",
          flush=True)
    # the train step's own K2 and K3 calls against their plain versions
    with recording(kwf) as seen:
        step(key)
        torch.cuda.synchronize()
    e2, e3 = check_recorded_step(kwf, seen, "train step")
    err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)

    # 8. glossiness: the train step with the exponent trainable, on Veach
    true_v = builders.veach_mis(512, 308)
    names = TRAINABLE + ("mat_exponent",)
    vcfg = kwf.KernelConfig(max_depth=3, sampler="sobol")
    target = render(true_v, spp=64, seed=99, cfg=vcfg, clamp=False)
    planks = true_v.mat_kind == 3   # the four Phong planks
    e_true = true_v.mat_exponent[planks].double()
    start = dataclasses.replace(true_v,
                                mat_exponent=true_v.mat_exponent * 0.5)
    step, params, _ = make_train_step(
        start, target, spp=4, max_depth=3, kernel_sampler="sobol",
        names=names, param_spaces={"mat_exponent": "log"})

    def exp_err():
        e = params["mat_exponent"].detach().cpu()[planks].double()
        return float((e.log() - e_true.log()).abs().mean())

    err0 = exp_err()
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    gloss_launches = counts()
    if gloss_launches[1] == 0 or gloss_launches[2] == 0:
        raise AssertionError("the glossiness step launched no K2 or K3")
    err5 = exp_err()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]
            and err5 < err0):
        raise AssertionError(f"the loss did not fall: {losses}, mean |log e "
                             f"- log e_true| {err0} -> {err5}")
    if not all(bool((p >= 0).all()) for p in params.values()):
        raise AssertionError("a parameter went negative")
    gstep_ms = float(np.median(walls[1:]))
    print(f"glossiness: veach 512x308, 4 spp, depth 3, sobol, "
          f"TRAINABLE + mat_exponent (softplus space), plank exponents "
          f"halved: losses {', '.join(f'{v:.6f}' for v in losses)}; mean "
          f"|log e - log e_true| over the planks {err0:.6f} -> {err5:.6f}; "
          f"{gstep_ms:.3f} ms a step (median of steps 2-5; all: "
          f"{', '.join(f'{v:.1f}' for v in walls)}); launches K1/K2/K3/K4 "
          f"{gloss_launches}", flush=True)
    busy, mine, n_k = device_profile(
        lambda: step(key), {"K2": K2_NAMES, "K3": K3_NAMES})
    print(f"profile: glossiness step: device busy {busy:.3f} ms in {n_k} "
          f"kernels (idle share {1 - busy / gstep_ms:.3f} of the median "
          f"step); K2 {mine['K2']:.3f} ms, K3 {mine['K3']:.3f} ms = "
          f"{(mine['K2'] + mine['K3']) / busy:.3f} of device busy time",
          flush=True)
    with recording(kwf) as seen:
        step(key)
        torch.cuda.synchronize()
    e2, e3 = check_recorded_step(kwf, seen, "glossiness step")
    err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)

    # 9. big scenes: the table-driven kernels K5, K6 and K7
    from kytpu_torch.kernels import bigscene as kbs
    from kytpu_torch.scene import mesh

    def reset_big():
        kbs.launches = kbs.launches_res_fwd = kbs.launches_res_bwd = 0
        kbs.launches_replay = 0

    def big_counts():
        return (kbs.launches, kbs.launches_res_fwd, kbs.launches_res_bwd,
                kbs.launches_replay)

    big = {"spheres": builders.random_spheres(n=1024, width=256, height=256),
           "mesh": builders.mesh_scene(*mesh.icosphere(subdivisions=3),
                                       width=256, height=256)}
    big_cuda = {nm: sc.to("cuda") for nm, sc in big.items()}
    for nm, sc in big.items():
        print(f"big scene: {nm}: {int(sc.mat_kind.shape[0])} surfaces, "
              f"{len(sc.lights.kinds)} lights, class rows (tri, rect, disk, "
              f"sphere) {kbs.pack_big_tables(sc, kwf.KernelConfig()).counts}",
              flush=True)
    # 9a. each kernel against its plain version, 64K lanes, every sampler
    err_k5 = err_k6 = err_k7 = err_k8 = 0.0
    big_cases = [("spheres", "random", "parity", False),
                 ("spheres", "hash", "robust", True),
                 ("spheres", "sobol", "parity", False),
                 ("mesh", "random", "robust", False),
                 ("mesh", "hash", "parity", False),
                 ("mesh", "sobol", "robust", True)]
    for sc_name, sampler, shadow, texp in big_cases:
        scene = big_cuda[sc_name]
        cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow,
                               trainable_exponent=texp)
        tag = f"{sc_name} {sampler}/{shadow}" + (
            " trainable exponent" if texp else "")
        o, d, si, pix = jittered_rays(scene, 1 << 16, 13)
        tables = kbs.pack_big_tables(scene, cfg)
        before = big_counts()
        k5 = kbs.trace_lanes(tables, cfg, o, d, 21, si, pix)
        k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 21, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        grads = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
        again = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
        k8 = kbs.bwd_replay(tables, cfg, o, d, 21, si, pix, g, k5)
        k8_again = kbs.bwd_replay(tables, cfg, o, d, 21, si, pix, g, k5)
        torch.cuda.synchronize()
        if big_counts() != (before[0] + 1, before[1] + 1, before[2] + 2,
                            before[3] + 2):
            raise AssertionError("trace_lanes/bwd_res/bwd_replay did not "
                                 "launch K5/K6/K7/K8")
        if not all(torch.equal(a, b) for a, b in zip(k8, k8_again)):
            raise AssertionError(f"K8's gradient does not repeat bit for bit, "
                                 f"{tag}")
        if not torch.equal(k5, k6):
            raise AssertionError(f"K6's radiance is not K5's bit for bit, {tag}")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"K7's gradient does not repeat bit for bit, "
                                 f"{tag}")
        ref_l, ref_f, ref_i = kbs.trace_lanes_plain(tables, cfg, o, d, 21, si,
                                                    pix, residual=True)
        share, mabs, mdev = compare(k5, ref_l, f"K5 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {tag}")
        gerr = compare_grads(grads, kbs.bwd_res_plain(
            tables, cfg, g, ref_l, ref_f, ref_i), f"K7 {tag}")
        rerr = compare_grads(k8, kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
            tables, cfg, o, d, 21, si, pix, g, k5)), f"K8 {tag}")
        xerr = compare_grads(k8, grads, f"K8 vs K7 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_k5, err_k6 = max(err_k5, mabs), max(err_k6, mabs, cerr)
        err_k7, err_k8 = max(err_k7, gerr), max(err_k8, rerr)
        extra = ""
        if texp:
            ix, _ = kbs.layout_of(tables.static, cfg)
            kplanes = [k for t, k in ix.items() if t[0] in ("Bk", "tuk")]
            live = int((ref_f[kplanes] != 0).sum())
            if live == 0 or not bool((grads[4] != 0).any()):
                raise AssertionError(f"{tag}: no phong lane")
            extra = (f"; {len(kplanes)} Bk/tuk planes ({live} nonzero "
                     f"entries), dexp on {int((grads[4] != 0).sum())} rows")
        print(f"big kernels vs plain: {tag}: {o.shape[0]} lanes, depth 3: K5 "
              f"{share:.5f} of lanes outside rtol={RTOL}/atol={ATOL} (max "
              f"|err| {mabs:.3g}, mean within {mdev:.2f} SE); K6 radiance = "
              f"K5's bit for bit, cache {resf.shape[0]}+{resi.shape[0]} planes "
              f"within the bound (max |err| {cerr:.3g}); K7 within the bound "
              f"(max |err| {gerr:.3g}), repeats bit for bit; K8 within the "
              f"bound (max |err| {rerr:.3g}), repeats bit for bit, vs K7 "
              f"within rtol={CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| "
              f"{xerr:.3g}){extra}", flush=True)
    del k5, k6, resf, resi, ref_l, ref_f, ref_i, grads, again, k8, k8_again

    # 9b. K5 against K1 where both run: the Cornell box, engine="bigscene"
    cornell = scenes["cornell"]
    cfg = kwf.KernelConfig(max_depth=5)
    o, d, _, _ = jittered_rays(cornell, n_lanes, 17)
    k1 = kwf.trace_lanes(kwf.pack_tables(cornell, cfg), cfg, o, d, 31)
    k5 = kbs.trace_lanes(kbs.pack_big_tables(cornell, cfg), cfg, o, d, 31)
    within = float(((k5 - k1).abs() <= 1e-3).all(-1).float().mean())
    reset_big()
    img_b = render(cornell, spp=16, seed=seed, clamp=False, engine="bigscene")
    img_1 = render(cornell, spp=16, seed=seed, clamp=False, engine="cuda")
    torch.cuda.synchronize()
    if big_counts()[0] == 0 or not bool(torch.isfinite(img_b).all()):
        raise AssertionError("render(engine='bigscene') did not run K5")
    if within < 1 - MAX_BAD_SHARE:
        raise AssertionError(f"K5 vs K1 on the Cornell box: only {within:.5f} "
                             "of lanes within 1e-3")
    print(f"K5 vs K1: cornell 256x256, depth 5, {n_lanes} lanes: {within:.5f} "
          f"of lanes within 1e-3 (max |diff| {float((k5 - k1).abs().max()):.3g};"
          f" K5 takes each hit's exponent from its row, K1 folds the one "
          f"static exponent); 16-spp frames through render(engine="
          f"'bigscene') and render(engine='cuda'): mean |diff| "
          f"{float((img_b - img_1).abs().mean()):.3g}", flush=True)
    del k1, k5, img_b, img_1

    # 9c. frames of the big scenes through the main path (render, past 64
    # surfaces: K5)
    bcfg = kwf.KernelConfig(max_depth=3)
    big_spp = 16

    def big_frame(sc):
        return render(sc, spp=big_spp, seed=seed, cfg=bcfg, clamp=False)

    reset_counts()
    reset_big()
    big_frames = {}
    for nm, sc in big.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = big_frame(sc)
        torch.cuda.synchronize()
        big_frames[nm] = (img, time.perf_counter() - t0)
    big_render_launches = big_counts()
    if big_render_launches[0] == 0 or big_render_launches[1:] != (0, 0, 0) \
            or counts() != (0, 0, 0, 0):
        raise AssertionError(f"the big-scene frames launched K5 "
                             f"{big_render_launches[0]} times and K1-K4 "
                             f"{counts()}")
    for nm, (img, secs) in big_frames.items():
        a = img.cpu().numpy()
        if a.shape != (256, 256, 3) or not np.isfinite(a).all() or \
                (a < 0).any() or a.mean() <= 0:
            raise AssertionError(f"{nm} frame: not finite, positive")
        tables = kbs.pack_big_tables(big_cuda[nm], bcfg)
        plain_k5 = (lambda s, o, d, *args, tables=tables:
                    kbs.trace_lanes_plain(tables, bcfg, o, d, *args))
        ref = kwf.render_cuda(big_cuda[nm], spp=big_spp, seed=seed, cfg=bcfg,
                              clamp=False, rays_per_pass=1 << 20,
                              tracer=plain_k5)
        share, mabs, _ = compare(img.reshape(-1, 3), ref.reshape(-1, 3),
                                 f"{nm} frame")
        err_k5 = max(err_k5, mabs)
        print(f"frame: {nm} 256x256 {big_spp} spp, depth 3 in {secs:.3f} s "
              f"(cold), mean {a.mean():.5f}; against the same frame through "
              f"the plain K5: {share:.5f} of pixels outside the bound, max "
              f"|err| {mabs:.3g}", flush=True)
    del ref
    for nm, sc in big.items():
        big_frame(sc)   # warm
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            big_frame(sc)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        busy, mine, n_k = device_profile(lambda: big_frame(sc),
                                         {"K5": K5_NAMES})
        print(f"profile: {nm} frame, {big_spp} spp: wall {wall:.3f} ms "
              f"(median of 5 warmed frames: {min(walls):.3f}-"
              f"{max(walls):.3f}); device busy {busy:.3f} ms in {n_k} kernels "
              f"(idle share {1 - busy / wall:.3f}); bigscene_fwd "
              f"{mine['K5']:.3f} ms = {mine['K5'] / busy:.3f} of device busy "
              f"time, {mine['K5'] / wall:.3f} of wall", flush=True)

    # 9d. benchmarks/run.py's K5 workload: 1M pixel-centre lanes, depth 3;
    # then K6, K7 and forward+backward on the same lanes
    sc = big_cuda["spheres"]
    n_big = 1 << 20
    o, d = pixel_centre_rays(sc, n_big)
    tables = kbs.pack_big_tables(sc, bcfg)
    tracer = kbs.make_bigscene_tracer(sc, bcfg)
    k5_ms, k5 = cuda_time_ms(lambda: tracer(sc, o, d, 7), 3)
    plain_k5_ms, ref = once_ms(
        lambda: kbs.trace_lanes_plain(tables, bcfg, o, d, 7))
    share, mabs, _ = compare(k5, ref, f"K5 spheres {n_big} lanes")
    err_k5 = max(err_k5, mabs)
    del ref
    k6_ms, (k6, resf, resi) = cuda_time_ms(
        lambda: kbs.trace_lanes(tables, bcfg, o, d, 7, residual=True), 3)
    if not torch.equal(k5, k6):
        raise AssertionError("K6's radiance is not K5's bit for bit at 1M "
                             "lanes")
    g = torch.full((n_big, 3), 1.0 / n_big, device="cuda")
    k7_ms, grads = cuda_time_ms(
        lambda: kbs.bwd_res(tables, bcfg, g, k6, resf, resi), 3)
    if not all(torch.equal(a, b) for a, b in zip(
            grads, kbs.bwd_res(tables, bcfg, g, k6, resf, resi))):
        raise AssertionError("K7's gradient does not repeat bit for bit at "
                             "1M lanes")
    plain_k6_ms, (ref_l, ref_f, ref_i) = once_ms(
        lambda: kbs.trace_lanes_plain(tables, bcfg, o, d, 7, residual=True))
    plain_k7_ms, ref_g = once_ms(
        lambda: kbs.bwd_res_plain(tables, bcfg, g, ref_l, ref_f, ref_i))
    share6, mabs6, _ = compare(k6, ref_l, f"K6 spheres {n_big} lanes")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {n_big} lanes")
    gerr = compare_grads(grads, ref_g, f"K7 spheres {n_big} lanes")
    err_k6, err_k7 = max(err_k6, mabs6, cerr), max(err_k7, gerr)
    big_cache = resf.numel() * 4 + resi.numel() * 4
    res_n = resf.shape[0]
    ops5 = k5_ops(tables, resf, bcfg)
    ops8 = k8_ops(tables, resf, bcfg)
    # the forward+backward's peak holds its own cache, not these
    del ref_l, ref_f, ref_i, ref_g, k6, resf, resi
    leaves = [t.clone().requires_grad_() for t in
              (sc.mat_diffuse, sc.mat_specular, sc.emission,
               sc.env_radiance_)]
    big_diff = kbs.make_bigscene_diff_tracer(sc, bcfg)

    def big_fwd_bwd():
        for t in leaves:
            t.grad = None
        loss = big_diff(*leaves, o, d, 7).sum() / n_big
        loss.backward()
        return loss

    bfb_ms, _ = cuda_time_ms(big_fwd_bwd, 3)
    torch.cuda.reset_peak_memory_stats()
    big_fwd_bwd()
    torch.cuda.synchronize()
    big_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(torch.equal(a, t.grad) for a, t in zip(grads, leaves)):
        raise AssertionError("the big-scene diff tracer's gradient is not "
                             "K7's")
    # K8, the replay backward, on the same lanes and gradient, and the
    # replay path: K5 forward, K8 backward
    k8_ms, k8 = cuda_time_ms(
        lambda: kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5), 3)
    if not all(torch.equal(a, b) for a, b in zip(
            k8, kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5))):
        raise AssertionError("K8's gradient does not repeat bit for bit at "
                             "1M lanes")
    plain_k8_ms, ref_g8 = once_ms(lambda: kbs.sums_plain(
        tables, bcfg, *kbs.bwd_replay_plain(tables, bcfg, o, d, 7, None, None,
                                            g, k5)))
    rerr8 = compare_grads(k8, ref_g8, f"K8 spheres {n_big} lanes")
    xerr8 = compare_grads(k8, grads, f"K8 vs K7 spheres {n_big} lanes",
                          CROSS_RTOL, CROSS_ATOL)
    err_k8 = max(err_k8, rerr8)
    del ref_g8
    big_replay = kbs.make_bigscene_diff_tracer(sc, bcfg, backward="replay")

    def big_fwd_bwd_replay():
        for t in leaves:
            t.grad = None
        loss = big_replay(*leaves, o, d, 7).sum() / n_big
        loss.backward()
        return loss

    torch.cuda.synchronize()
    reset_big()
    bfr_ms, _ = cuda_time_ms(big_fwd_bwd_replay, 3)
    big_replay_launches = big_counts()
    if big_replay_launches[0] == 0 or big_replay_launches[3] == 0 or \
            big_replay_launches[1:3] != (0, 0):
        raise AssertionError(f"the big-scene replay path launched K5/K6/K7/K8 "
                             f"{big_replay_launches}")
    torch.cuda.reset_peak_memory_stats()
    big_fwd_bwd_replay()
    torch.cuda.synchronize()
    big_replay_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(torch.equal(a, t.grad) for a, t in zip(k8, leaves)):
        raise AssertionError("the big-scene replay tracer's gradient is not "
                             "K8's")
    m_rows = int(sc.mat_kind.shape[0])
    n_l = len(tables.static["lights"])
    bounds["K5"] = bound_ms(n_big * (24 + 12), ops5)
    bounds["K6"] = bound_ms(n_big * (24 + 12) + big_cache, ops5)
    # K7 reads the cache, g and L and writes the (M, 10) tables; its
    # arithmetic is K3's per lane-bounce
    bounds["K7"] = bound_ms(big_cache + n_big * 24 + m_rows * 10 * 4,
                            float(n_big * (bcfg.max_depth * (45 + 27 * n_l)
                                           + 6)))
    # K8 reads the rays, g and L and writes the (M, 9) tables (its row-tagged
    # planes are its own scratch, not the function's bytes)
    PB = 9
    bounds["K8"] = bound_ms(n_big * (24 + 12 + 12) + m_rows * PB * 4, ops8)
    print(f"timing: spheres 1026 surfaces, depth 3, {n_big} pixel-centre "
          f"lanes (benchmarks/run.py): K5 {k5_ms:.3f} ms "
          f"({n_big / k5_ms / 1e3:.2f} Mrays/s), plain K5 {plain_k5_ms:.1f} "
          f"ms; K5 vs plain {share:.5f} of lanes outside (max |err| "
          f"{mabs:.3g}); on {smi}", flush=True)
    print(f"big fwd+bwd: the same lanes, loss = out.sum() / N through "
          f"make_bigscene_diff_tracer: {bfb_ms:.3f} ms, peak memory "
          f"{big_peak_gb:.3f} GB allocated (rays included); K6 {k6_ms:.3f} "
          f"ms, K7 {k7_ms:.3f} ms (its lane pass, the sort of the row tags "
          f"and the sums by row); plain K6 {plain_k6_ms:.1f} ms, plain K7 "
          f"{plain_k7_ms:.1f} ms; cache {res_n} float + "
          f"{bcfg.max_depth + 1} int planes = {big_cache / 1e9:.4f} GB; K6 vs "
          f"plain {share6:.5f} of lanes outside (max |err| {mabs6:.3g}), "
          f"cache max |err| {cerr:.3g}, K7 max |err| {gerr:.3g}, repeats bit "
          f"for bit; the tracer's gradient = K7's bit for bit; on {smi}",
          flush=True)
    print(f"big replay: the same lanes and loss through make_bigscene_diff_"
          f"tracer(backward=\"replay\"): {bfr_ms:.3f} ms, peak memory "
          f"{big_replay_peak_gb:.3f} GB allocated (the residual path's "
          f"{big_peak_gb:.3f} GB); launches K5/K6/K7/K8 {big_replay_launches}; "
          f"K8 {k8_ms:.3f} ms (the replay kernel, the sort of the row tags "
          f"and the sums by row), plain K8 {plain_k8_ms:.1f} ms; the "
          f"tracer's gradient = K8's bit for bit; K8 vs plain max |err| "
          f"{rerr8:.3g}, repeats bit for bit; K8 vs K7 within rtol="
          f"{CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr8:.3g}); on {smi}",
          flush=True)
    for k in ("K5", "K6", "K7", "K8"):
        print(f"bound: {k} {bounds[k][0]:.4f} ms by {bounds[k][1]} (K5 ops "
              f"{ops5:.4g}, K8 ops {ops8:.4g}, cache {big_cache:.4g} B)",
              flush=True)
    del k5, grads, g, leaves, o, d, k8

    # 9e. training past 64 surfaces through make_train_step (K6, K7)
    true_b = big["spheres"]
    tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
    target = render(true_b, spp=64, seed=99, cfg=tcfg, clamp=False)
    spheres = slice(1, m_rows - 1)   # not the ground (row 0) or the light
    dif0 = true_b.mat_diffuse.clone()
    dif0[spheres] = dif0[spheres] * 0.4
    start = dataclasses.replace(true_b, mat_diffuse=dif0)
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash")

    def sphere_err():
        return float((params["mat_diffuse"].detach().cpu()[spheres]
                      - true_b.mat_diffuse[spheres]).abs().mean())

    err0 = sphere_err()
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    reset_big()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    big_train_launches = big_counts()
    if big_train_launches[1] == 0 or big_train_launches[2] == 0 or \
            big_train_launches[3] != 0 or counts() != (0, 0, 0, 0):
        raise AssertionError(f"the big-scene train step launched K5/K6/K7 "
                             f"{big_train_launches} and K1-K4 {counts()}")
    err5 = sphere_err()
    if not (np.isfinite(losses).all() and np.all(np.diff(losses) < 0)
            and err5 < err0):
        raise AssertionError(f"the loss did not fall: {losses}, mean "
                             f"|diffuse - true| {err0} -> {err5}")
    if not all(bool((p >= 0).all()) for p in params.values()):
        raise AssertionError("a parameter went negative")
    bstep_ms = float(np.median(walls[1:]))
    print(f"big train: spheres 1026 surfaces 256x256, 4 spp, depth 3, hash, "
          f"the spheres' diffuse scaled by 0.4: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; mean |diffuse - true| "
          f"over the spheres {err0:.5f} -> {err5:.5f}; {bstep_ms:.3f} ms a "
          f"step (median of steps 2-5; all: "
          f"{', '.join(f'{v:.1f}' for v in walls)}); launches K5/K6/K7 "
          f"{big_train_launches}, K1-K4 {counts()}", flush=True)
    busy, mine, n_k = device_profile(
        lambda: step(key), {"K6": K6_NAMES, "K7": K7_NAMES})
    print(f"profile: big train step: device busy {busy:.3f} ms in {n_k} "
          f"kernels (idle share {1 - busy / bstep_ms:.3f} of the median "
          f"step); K6 {mine['K6']:.3f} ms, K7 {mine['K7']:.3f} ms = "
          f"{(mine['K6'] + mine['K7']) / busy:.3f} of device busy time",
          flush=True)
    with recording(kbs) as seen:
        step(key)
        torch.cuda.synchronize()
    e6, e7 = check_recorded_step(kbs, seen, "big train step",
                                 ("K5", "K6", "K7"))
    err_k6, err_k7 = max(err_k6, e6), max(err_k7, e7)

    # 10. textures through K1-K4: kytpu's checker floor and back-wall images
    from kytpu_torch.diff.params import get_params, set_params
    rng = np.random.default_rng(4)
    tex_scenes = {
        "checker": builders.cornell_box(width=256, height=256,
                                        floor_checker=True),
        "select": builders.cornell_box(width=256, height=256, back_image=rng
                                       .uniform(0.1, 0.9, (8, 8, 3))
                                       .astype(np.float32)),
        "separable": builders.cornell_box(width=256, height=256,
                                          floor_checker=True,
                                          back_image=demo_texture(16))}
    # 10a. each textured kernel against its plain version, 64K lanes
    tex_cases = [("checker", "random", "all", "parity", False),
                 ("select", "hash", "all", "robust", True),
                 ("separable", "sobol", "single", "parity", False),
                 ("separable", "hash", "all", "parity", True)]
    for sc_name, sampler, nee, shadow, texp in tex_cases:
        scene = tex_scenes[sc_name].to("cuda")
        cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                               shadow=shadow, trainable_exponent=texp)
        tag = f"textured {sc_name} {sampler}/{nee}/{shadow}" + (
            " trainable exponent" if texp else "")
        o, d, si, pix = jittered_rays(scene, 1 << 16, 19)
        tables = kwf.pack_tables(scene, cfg)
        before = counts()
        k1 = kwf.trace_lanes(tables, cfg, o, d, 41, si, pix)
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 41, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 41, si, pix, g, k1)
        torch.cuda.synchronize()
        if counts() != (before[0] + 1, before[1] + 1, before[2] + 1,
                        before[3] + 1):
            raise AssertionError(f"{tag}: K1-K4 did not launch")
        if not torch.equal(k1, k2):
            raise AssertionError(f"{tag}: K2's radiance is not K1's")
        for nm, got, again in (
                ("K3", k3, kwf.bwd_res(tables, cfg, g, k2, resf, resi)),
                ("K4", k4, kwf.bwd_replay(tables, cfg, o, d, 41, si, pix, g,
                                          k1))):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: {nm} does not repeat")
        ref1 = kwf.trace_lanes_plain(tables, cfg, o, d, 41, si, pix)
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 41, si,
                                                    pix, residual=True)
        share, mabs, _ = compare(k1, ref1, f"K1 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {tag}")
        same_bits(k1, ref1, f"K1 {tag}")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i), f"K2 {tag}")
        gerr = compare_grads(k3, kwf.bwd_res_plain(tables, cfg, g, ref_l,
                                                   ref_f, ref_i), f"K3 {tag}")
        rerr = compare_grads(k4, kwf.bwd_replay_plain(
            tables, cfg, o, d, 41, si, pix, g, ref1), f"K4 {tag}")
        xerr = compare_grads(k4, k3, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        max_abs_err = max(max_abs_err, mabs)
        err_res, err_bwd = max(err_res, cerr), max(err_bwd, gerr)
        err_replay = max(err_replay, rerr)
        tex = [float(t.abs().max()) for t in k3[4 + texp:]]
        print(f"textured kernels vs plain: {tag}: {o.shape[0]} lanes, depth "
              f"5: K1 and K2 (radiance, cache) = plain bit for bit; "
              f"K1 {share:.5f} of lanes outside (max |err| {mabs:.3g}); K2 "
              f"radiance = K1's bit for bit, cache {resf.shape[0]}+"
              f"{resi.shape[0]} planes (max |err| {cerr:.3g}); K3 (max |err| "
              f"{gerr:.3g}) and K4 (max |err| {rerr:.3g}) within the bound, "
              f"repeat bit for bit; K4 vs K3 within rtol={CROSS_RTOL}/atol="
              f"{CROSS_ATOL} (max |diff| {xerr:.3g}); largest texture "
              f"adjoints (dta, dtb[, dti]) {', '.join(f'{v:.3g}' for v in tex)}",
              flush=True)
        if not any(v > 0 for v in tex):
            raise AssertionError(f"{tag}: no texture adjoint")
    del k1, k2, k3, k4, resf, resi, ref1, ref_l, ref_f, ref_i

    # 10b. kytpu's textured render: Cornell 512x512, a checker floor and a
    # 32x32 painted back wall, 64 spp through render() (the main path: K1)
    tex_frame = builders.cornell_box(builders.DEFAULT_SCENE, 512, 512,
                                     floor_checker=True,
                                     back_image=demo_texture(32))

    def tframe(n_spp):
        return render(tex_frame, spp=n_spp, seed=seed, clamp=False)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = tframe(spp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tex_render_launches = counts()
    a = img.cpu().numpy()
    if tex_render_launches[0] == 0 or tex_render_launches[1:] != (0, 0, 0) \
            or a.shape != (512, 512, 3) or not np.isfinite(a).all() \
            or (a < 0).any():
        raise AssertionError(f"textured frame: launches {tex_render_launches}")
    tcfg = kwf.KernelConfig()
    tex_tables = kwf.pack_tables(tex_frame.to("cuda"), tcfg)
    ref = kwf.render_cuda(
        tex_frame.to("cuda"), spp=4, seed=seed, cfg=tcfg, clamp=False,
        rays_per_pass=1 << 20,
        tracer=lambda s, o, d, *args: kwf.trace_lanes_plain(
            tex_tables, tcfg, o, d, *args))
    share, mabs, _ = compare(tframe(4).reshape(-1, 3), ref.reshape(-1, 3),
                             "textured 4-spp frame")
    max_abs_err = max(max_abs_err, mabs)
    del ref
    tframe(spp)   # warm
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tframe(spp)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    busy, mine, n_k = device_profile(lambda: tframe(spp), {"K1": K1_NAMES})
    print(f"textured frame: cornell 512x512, checker floor, 32x32 back wall, "
          f"{spp} spp in {secs:.3f} s (cold), mean {a.mean():.5f}; launches "
          f"K1/K2/K3/K4 {tex_render_launches}; the 4-spp frame against the "
          f"plain K1: {share:.5f} of pixels outside the bound, max |err| "
          f"{mabs:.3g}", flush=True)
    print(f"profile: textured frame {spp} spp: wall {wall:.3f} ms (median of "
          f"5 warmed frames: {min(walls):.3f}-{max(walls):.3f}); device busy "
          f"{busy:.3f} ms in {n_k} kernels (idle share {1 - busy / wall:.3f});"
          f" wavefront_fwd {mine['K1']:.3f} ms = {mine['K1'] / busy:.3f} of "
          f"device busy time, {mine['K1'] / wall:.3f} of wall; on {smi}",
          flush=True)

    # 10c, 10d. texture recovery: five steps of the texels of a 16x16 back
    # wall from a flat 0.5 grey, then five of the checker colours from 0.4
    # of the truth; Cornell 256x256, 4 spp, depth 3, hash, one key
    tex_train = {}
    for what, names, true_sc in (
            ("texels", ("tex_image",), tex_scenes["separable"]),
            ("checker", ("tex_color_a", "tex_color_b"),
             tex_scenes["checker"])):
        tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
        target = render(true_sc, spp=64, seed=99, cfg=tcfg, clamp=False)
        true_p = get_params(true_sc, names)
        start = set_params(true_sc, {
            n: (torch.full_like(v, 0.5) if n == "tex_image" else v * 0.4)
            for n, v in true_p.items()})
        step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                          kernel_sampler="hash", names=names)

        def tex_err():
            return sum(float((params[n].detach().cpu() - true_p[n])
                             .abs().mean()) for n in names)

        err0 = tex_err()
        losses, walls = [], []
        torch.cuda.synchronize()
        reset_counts()
        for i in range(5):
            t0 = time.perf_counter()
            losses.append(float(step(key)))
            walls.append((time.perf_counter() - t0) * 1e3)
        tl = counts()
        err5 = tex_err()
        # the texels' error must fall; the checker colours' loss
        if tl[1] == 0 or tl[2] == 0 or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]
                and (err5 < err0 or what == "checker")):
            raise AssertionError(f"{what} recovery: losses {losses}, error "
                                 f"{err0} -> {err5}, launches {tl}")
        tstep_ms = float(np.median(walls[1:]))
        busy, mine, n_k = device_profile(lambda: step(key),
                                         {"K2": K2_NAMES, "K3": K3_NAMES})
        print(f"texture train: {what} ({', '.join(names)}), cornell "
              f"256x256, 4 spp, depth 3, hash: losses "
              f"{', '.join(f'{v:.6f}' for v in losses)}; mean |texture - "
              f"true| {err0:.5f} -> {err5:.5f}; {tstep_ms:.3f} ms a step "
              f"(median of steps 2-5; all: "
              f"{', '.join(f'{v:.1f}' for v in walls)}); launches K1/K2/K3/K4 "
              f"{tl}; profile: device busy {busy:.3f} ms in {n_k} kernels "
              f"(idle share {1 - busy / tstep_ms:.3f}), K2 {mine['K2']:.3f} "
              f"ms, K3 {mine['K3']:.3f} ms", flush=True)
        with recording(kwf) as seen:
            step(key)
            torch.cuda.synchronize()
        e2, e3 = check_recorded_step(kwf, seen, f"{what} train step")
        err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)
        tex_train[what] = tl

    # 10e. the textured replay path: make_cuda_diff_tracer(backward=
    # "replay") on the texel scene, 1M lanes at depth 3, its gradient K4's
    scene = tex_scenes["separable"].to("cuda")
    rcfg = kwf.KernelConfig(max_depth=3)
    o, d, _, _ = jittered_rays(scene, 1 << 20, 23)
    tx = scene.textures
    leaves = [t.clone().requires_grad_() for t in (
        scene.mat_diffuse, scene.mat_specular, scene.emission, tx.color_a,
        tx.color_b, tx.image)]
    env0 = torch.zeros(3, device="cuda")
    tex_replay = kwf.make_cuda_diff_tracer(scene, rcfg, backward="replay")
    reset_counts()
    out = tex_replay(*leaves, env0, o, d, 13)
    (out.sum() / out.shape[0]).backward()
    torch.cuda.synchronize()
    tex_replay_launches = counts()
    if tex_replay_launches != (1, 0, 0, 1):
        raise AssertionError(f"the textured replay path launched K1-K4 "
                             f"{tex_replay_launches}")
    tabs = kwf.pack_tables(scene, rcfg)
    g = torch.full_like(out, 1.0 / out.shape[0])
    k4 = kwf.bwd_replay(tabs, rcfg, o, d, 13, None, None, g, out.detach())
    if not all(torch.equal(t.grad.reshape(a.shape), a)
               for t, a in zip(leaves, k4[:3] + k4[4:])):
        raise AssertionError("the textured replay tracer's gradient is not "
                             "K4's")
    k4_tex_ms, _ = cuda_time_ms(lambda: kwf.bwd_replay(
        tabs, rcfg, o, d, 13, None, None, g, out.detach()), 3)
    print(f"textured replay: cornell 256x256 with a 16x16 back wall and a "
          f"checker floor, {o.shape[0]} lanes, depth 3, through "
          f"make_cuda_diff_tracer(backward=\"replay\"): launches K1/K2/K3/K4 "
          f"{tex_replay_launches}, the tracer's gradient = K4's bit for bit "
          f"(dti max {float(k4[-1].abs().max()):.3g}); K4 {k4_tex_ms:.3f} ms",
          flush=True)
    del o, d, out, leaves, k4, g

    # 11. past 64 surfaces on every route (kytpu's rule): the textured
    # table kernels K5-K8, K1-K4 on a scene the tables refuse, smallpt
    from kytpu_torch.scene import texture as ktex

    def ground_textured(sc, tex):
        """sc with texture `tex` on its ground, row 0 (random_spheres'
        ground rect)."""
        tid = torch.full((int(sc.mat_kind.shape[0]),), -1, dtype=torch.int32)
        tid[0] = 0
        return dataclasses.replace(sc, has_textures=True, tex_id=tid,
                                   textures=ktex.build([tex]))

    rng = np.random.default_rng(6)
    spheres_b = big["spheres"]
    past64 = {
        "checker": ground_textured(spheres_b, dict(
            kind=ktex.CHECKER, color_a=np.float32([0.85, 0.3, 0.25]),
            color_b=np.float32([0.2, 0.7, 0.35]), scale=(16.0, 16.0))),
        "select": ground_textured(spheres_b, dict(
            kind=ktex.IMAGE, image=rng.uniform(0.1, 0.9, (8, 8, 3)).astype(
                np.float32), scale=(4.0, 4.0))),
        "separable": ground_textured(spheres_b, dict(
            kind=ktex.IMAGE, image=demo_texture(16), scale=(4.0, 4.0)))}
    for nm, sc in past64.items():
        try:
            kbs.extract_tables(sc)
            route = "K5-K8 (TEX)"
        except NotImplementedError as e:
            route = f"K1-K4 (the tables refuse it: {e})"
        print(f"past 64: spheres 1026 surfaces with a {nm} ground: routes to "
              f"{route}", flush=True)
    p64_cuda = {nm: sc.to("cuda") for nm, sc in past64.items()}

    # 11a. the textured K5-K8 against their plain versions, 64K lanes
    tex_big_cases = [("checker", "random", "parity", False),
                     ("checker", "sobol", "robust", True),
                     ("select", "hash", "robust", False),
                     ("select", "sobol", "parity", True)]
    for sc_name, sampler, shadow, texp in tex_big_cases:
        scene = p64_cuda[sc_name]
        cfg = kwf.KernelConfig(max_depth=3, sampler=sampler, shadow=shadow,
                               trainable_exponent=texp)
        tag = f"textured spheres {sc_name} {sampler}/{shadow}" + (
            " trainable exponent" if texp else "")
        o, d, si, pix = jittered_rays(scene, 1 << 16, 29)
        tables = kbs.pack_big_tables(scene, cfg)
        before = big_counts()
        k5 = kbs.trace_lanes(tables, cfg, o, d, 43, si, pix)
        k6, resf, resi = kbs.trace_lanes(tables, cfg, o, d, 43, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(7))
        k7 = kbs.bwd_res(tables, cfg, g, k6, resf, resi)
        k8 = kbs.bwd_replay(tables, cfg, o, d, 43, si, pix, g, k5)
        torch.cuda.synchronize()
        if big_counts() != (before[0] + 1, before[1] + 1, before[2] + 1,
                            before[3] + 1):
            raise AssertionError(f"{tag}: K5-K8 did not launch")
        if not torch.equal(k5, k6):
            raise AssertionError(f"{tag}: K6's radiance is not K5's")
        for nm, got, again in (
                ("K7", k7, kbs.bwd_res(tables, cfg, g, k6, resf, resi)),
                ("K8", k8, kbs.bwd_replay(tables, cfg, o, d, 43, si, pix, g,
                                          k5))):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: {nm} does not repeat")
        ref_l, ref_f, ref_i = kbs.trace_lanes_plain(tables, cfg, o, d, 43, si,
                                                    pix, residual=True)
        share, mabs, _ = compare(k5, ref_l, f"K5 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K6 cache {tag}")
        gerr = compare_grads(k7, kbs.bwd_res_plain(tables, cfg, g, ref_l,
                                                   ref_f, ref_i), f"K7 {tag}")
        rerr = compare_grads(k8, kbs.sums_plain(tables, cfg, *kbs.bwd_replay_plain(
            tables, cfg, o, d, 43, si, pix, g, k5)), f"K8 {tag}")
        xerr = compare_grads(k8, k7, f"K8 vs K7 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        err_k5, err_k6 = max(err_k5, mabs), max(err_k6, mabs, cerr)
        err_k7, err_k8 = max(err_k7, gerr), max(err_k8, rerr)
        tex = [float(t.abs().max()) for t in k7[4 + texp:]]
        # a checker's colours, or an atlas's texels
        if not (min(tex) if sc_name == "checker" else tex[-1]) > 0:
            raise AssertionError(f"{tag}: no texture adjoint {tex}")
        print(f"textured big kernels vs plain: {tag}: {o.shape[0]} lanes, "
              f"depth 3: K5 {share:.5f} of lanes outside (max |err| "
              f"{mabs:.3g}); K6 radiance = K5's bit for bit, cache "
              f"{resf.shape[0]}+{resi.shape[0]} planes (max |err| {cerr:.3g});"
              f" K7 (max |err| {gerr:.3g}) and K8 (max |err| {rerr:.3g}) "
              f"within the bound, repeat bit for bit; K8 vs K7 within rtol="
              f"{CROSS_RTOL}/atol={CROSS_ATOL} (max |diff| {xerr:.3g}); "
              f"largest texture adjoints (dta, dtb[, dti]) "
              f"{', '.join(f'{v:.3g}' for v in tex)}", flush=True)
    del k5, k6, k7, k8, resf, resi, ref_l, ref_f, ref_i
    # the textured K5 against K1 on the textured Cornell box
    tcorn = builders.cornell_box(width=256, height=256, floor_checker=True,
                                 back_image=rng.uniform(0.1, 0.9, (8, 8, 3))
                                 .astype(np.float32)).to("cuda")
    cfg = kwf.KernelConfig(max_depth=5)
    o, d, _, _ = jittered_rays(tcorn, n_lanes, 31)
    k1 = kwf.trace_lanes(kwf.pack_tables(tcorn, cfg), cfg, o, d, 37)
    k5 = kbs.trace_lanes(kbs.pack_big_tables(tcorn, cfg), cfg, o, d, 37)
    within = float(((k5 - k1).abs() <= 1e-3).all(-1).float().mean())
    if within < 1 - MAX_BAD_SHARE:
        raise AssertionError(f"textured K5 vs K1: only {within:.5f} of lanes "
                             "within 1e-3")
    print(f"textured K5 vs K1: cornell 256x256 with a checker floor and an "
          f"8x8 back wall, depth 5, {n_lanes} lanes: {within:.5f} of lanes "
          f"within 1e-3 (max |diff| {float((k5 - k1).abs().max()):.3g})",
          flush=True)
    del k1, k5

    # 11b. a 16-spp textured frame past 64 surfaces through render(): K5
    reset_counts()
    reset_big()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(past64["checker"], spp=big_spp, seed=seed, cfg=bcfg,
                 clamp=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tex_big_launches = big_counts()
    if tex_big_launches[0] == 0 or tex_big_launches[1:] != (0, 0, 0) or \
            counts() != (0, 0, 0, 0):
        raise AssertionError(f"the textured big frame launched K5-K8 "
                             f"{tex_big_launches} and K1-K4 {counts()}")
    tables = kbs.pack_big_tables(p64_cuda["checker"], bcfg)
    ref = kwf.render_cuda(p64_cuda["checker"], spp=big_spp, seed=seed,
                          cfg=bcfg, clamp=False, rays_per_pass=1 << 20,
                          tracer=lambda s, o, d, *args: kbs.trace_lanes_plain(
                              tables, bcfg, o, d, *args))
    share, mabs, _ = compare(img.reshape(-1, 3), ref.reshape(-1, 3),
                             "textured big frame")
    err_k5 = max(err_k5, mabs)
    print(f"frame: spheres with a checker ground 256x256 {big_spp} spp, depth "
          f"3 in {secs:.3f} s (cold), mean {float(img.mean()):.5f}; launches "
          f"K5/K6/K7/K8 {tex_big_launches}, K1-K4 {counts()}; against the "
          f"same frame through the plain K5: {share:.5f} of pixels outside "
          f"the bound, max |err| {mabs:.3g}", flush=True)
    del img, ref

    def tex_big_frame():
        return render(past64["checker"], spp=big_spp, seed=seed, cfg=bcfg,
                      clamp=False)

    tex_big_frame()   # warm
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tex_big_frame()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    busy, mine, n_k = device_profile(tex_big_frame, {"K5": K5_NAMES})
    print(f"profile: textured spheres frame, {big_spp} spp: wall {wall:.3f} ms "
          f"(median of 5 warmed frames: {min(walls):.3f}-{max(walls):.3f}); "
          f"device busy {busy:.3f} ms in {n_k} kernels (idle share "
          f"{1 - busy / wall:.3f}); bigscene_fwd {mine['K5']:.3f} ms = "
          f"{mine['K5'] / busy:.3f} of device busy time", flush=True)

    # 11c. checker-colour recovery past 64 surfaces: K6, K7 with TEX
    names = ("tex_color_a", "tex_color_b")
    tcfg = kwf.KernelConfig(max_depth=3, sampler="hash")
    target = render(past64["checker"], spp=64, seed=99, cfg=tcfg,
                    clamp=False)
    true_p = get_params(past64["checker"], names)
    start = set_params(past64["checker"],
                       {n: v * 0.4 for n, v in true_p.items()})
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash", names=names)
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    reset_big()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    tex_big_train = big_counts()
    if tex_big_train[1] == 0 or tex_big_train[2] == 0 or \
            tex_big_train[3] != 0 or counts() != (0, 0, 0, 0) or not (
                np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"textured big train: losses {losses}, launches "
                             f"K5-K8 {tex_big_train}, K1-K4 {counts()}")
    tb_ms = float(np.median(walls[1:]))
    print(f"textured big train: {', '.join(names)} on the checker-ground "
          f"spheres 256x256, 4 spp, depth 3, hash, from 0.4 of the true "
          f"colours: losses {', '.join(f'{v:.6f}' for v in losses)}; "
          f"{tb_ms:.3f} ms a step (median of steps 2-5); launches K5/K6/K7/K8 "
          f"{tex_big_train}, K1-K4 {counts()}", flush=True)
    with recording(kbs) as seen:
        step(key)
        torch.cuda.synchronize()
    e6, e7 = check_recorded_step(kbs, seen, "textured big train step",
                                 ("K5", "K6", "K7"))
    err_k6, err_k7 = max(err_k6, e6), max(err_k7, e7)

    # 11d. K1-K4 past 64 surfaces: the 16x16 atlas on the ground (a
    # separable atlas, which the tables refuse)
    sep = past64["separable"]
    reset_counts()
    reset_big()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(sep, spp=big_spp, seed=seed, cfg=bcfg, clamp=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sep_render_launches = counts()
    if sep_render_launches[0] == 0 or sep_render_launches[1:] != (0, 0, 0) \
            or big_counts() != (0, 0, 0, 0) or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError(f"the 16x16-ground frame launched K1-K4 "
                             f"{sep_render_launches} and K5-K8 {big_counts()}")
    print(f"frame: spheres with a 16x16 ground atlas 256x256 {big_spp} spp, "
          f"depth 3 in {secs:.3f} s (cold), mean {float(img.mean()):.5f}; "
          f"launches K1/K2/K3/K4 {sep_render_launches}, K5-K8 {big_counts()}",
          flush=True)
    del img
    names = ("tex_image",)
    target = render(sep, spp=64, seed=99, cfg=tcfg, clamp=False)
    true_p = get_params(sep, names)
    start = set_params(sep, {"tex_image": torch.full_like(
        true_p["tex_image"], 0.5)})
    step, params, _ = make_train_step(start, target, spp=4, max_depth=3,
                                      kernel_sampler="hash", names=names)
    losses, walls = [], []
    torch.cuda.synchronize()
    reset_counts()
    reset_big()
    for i in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(key)))
        walls.append((time.perf_counter() - t0) * 1e3)
    sep_train = counts()
    if sep_train[1] == 0 or sep_train[2] == 0 or big_counts() != (
            0, 0, 0, 0) or not (np.isfinite(losses).all()
                                and losses[-1] < losses[0]):
        raise AssertionError(f"16x16-ground train: losses {losses}, launches "
                             f"K1-K4 {sep_train}, K5-K8 {big_counts()}")
    print(f"train past 64 on K2/K3: texels of the 16x16 ground from a flat "
          f"0.5 grey, 256x256, 4 spp, depth 3, hash: losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; "
          f"{float(np.median(walls[1:])):.3f} ms a step (median of steps "
          f"2-5); launches K1/K2/K3/K4 {sep_train}, K5-K8 {big_counts()}",
          flush=True)
    with recording(kwf) as seen:
        step(key)
        torch.cuda.synchronize()
    e2, e3 = check_recorded_step(kwf, seen, "16x16-ground train step")
    err_res, err_bwd = max(err_res, e2), max(err_bwd, e3)
    # the row-tagged K3 and K4 against their plain versions, 64K lanes,
    # and against K7 on the untextured twin (random_spheres(1024))
    for sc_name, scene in (("16x16 ground", p64_cuda["separable"]),
                           ("untextured twin", big_cuda["spheres"])):
        cfg = kwf.KernelConfig(max_depth=3, sampler="hash",
                               trainable_exponent=True)
        tag = f"row-tagged K3/K4, spheres {sc_name}, hash, trainable exponent"
        o, d, si, pix = jittered_rays(scene, 1 << 16, 37)
        tables = kwf.pack_tables(scene, cfg)
        if not kwf.row_tagged(tables.static):
            raise AssertionError(f"{tag}: not on the row-tagged route")
        k1 = kwf.trace_lanes(tables, cfg, o, d, 47, si, pix)
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 47, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(9))
        k3 = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        k4 = kwf.bwd_replay(tables, cfg, o, d, 47, si, pix, g, k1)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            raise AssertionError(f"{tag}: K2's radiance is not K1's")
        for nm, got, again in (
                ("K3", k3, kwf.bwd_res(tables, cfg, g, k2, resf, resi)),
                ("K4", k4, kwf.bwd_replay(tables, cfg, o, d, 47, si, pix, g,
                                          k1))):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: {nm} does not repeat")
        ref1 = kwf.trace_lanes_plain(tables, cfg, o, d, 47, si, pix)
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 47, si,
                                                    pix, residual=True)
        share, mabs, _ = compare(k1, ref1, f"K1 {tag}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {tag}")
        if tables.stage_bytes:
            raise AssertionError(f"{tag}: the tables were staged")
        same_bits(k1, ref1, f"K1 {tag}, tables in device memory")
        same_bits((k2, resf, resi), (ref_l, ref_f, ref_i),
                  f"K2 {tag}, tables in device memory")
        gerr = compare_grads(k3, kwf.bwd_res_plain(tables, cfg, g, ref_l,
                                                   ref_f, ref_i), f"K3 {tag}")
        rerr = compare_grads(k4, kwf.bwd_replay_plain(
            tables, cfg, o, d, 47, si, pix, g, ref1), f"K4 {tag}")
        xerr = compare_grads(k4, k3, f"K4 vs K3 {tag}", CROSS_RTOL,
                             CROSS_ATOL)
        max_abs_err = max(max_abs_err, mabs)
        err_res, err_bwd = max(err_res, cerr), max(err_bwd, gerr)
        err_replay = max(err_replay, rerr)
        rows = kwf.unpack_row(resi) - 1
        live_high = int((k3[0][256:].abs().sum(-1) > 0).sum())
        if int(rows.max()) <= 255 or live_high == 0:
            raise AssertionError(f"{tag}: no live row above 255")
        extra = ""
        if sc_name == "untextured twin":
            btables = kbs.pack_big_tables(scene, cfg)
            k6, bresf, bresi = kbs.trace_lanes(btables, cfg, o, d, 47, si,
                                               pix, residual=True)
            k7 = kbs.bwd_res(btables, cfg, g, k6, bresf, bresi)
            emissive = scene.emission.sum(-1) > 0
            k7e = (*k7[:2], k7[2] * emissive[:, None], *k7[3:])
            k3e = (*k3[:2], k3[2] * emissive[:, None], *k3[3:])
            k4e = (*k4[:2], k4[2] * emissive[:, None], *k4[3:])
            x37 = compare_grads(k3e, k7e, f"K3 vs K7 {tag}", CROSS_RTOL,
                                CROSS_ATOL)
            x47 = compare_grads(k4e, k7e, f"K4 vs K7 {tag}", CROSS_RTOL,
                                CROSS_ATOL)
            extra = (f"; against K7 on the same lanes (d_emission on the "
                     f"emissive rows): K3 max |diff| {x37:.3g}, K4 {x47:.3g}")
        print(f"{tag}: {o.shape[0]} lanes, depth 3, tables in device memory "
              f"({len(tables.static['mats']['kind'])} rows): K1 and K2 "
              f"(radiance, cache) = plain bit for bit; K1 {share:.5f} of lanes "
              f"outside (max |err| {mabs:.3g}); K2 = K1 bit for bit, cache "
              f"(max |err| {cerr:.3g}), rows up to {int(rows.max())}; K3 (max "
              f"|err| {gerr:.3g}) and K4 (max |err| {rerr:.3g}) within the "
              f"bound, repeat bit for bit; K4 vs K3 max |diff| {xerr:.3g}; "
              f"{live_high} live rows above 255{extra}", flush=True)
    del k1, k2, k3, k4, resf, resi, ref1, ref_l, ref_f, ref_i, k6, k7
    # K1-K4 at the spheres' 1M pixel-centre lanes, 16x16 ground, depth 3
    scene = p64_cuda["separable"]
    o, d = pixel_centre_rays(scene, n_big)
    t0 = time.perf_counter()
    tables = kwf.pack_tables(scene, bcfg)   # the occlusion-skip proofs too
    pack_s = time.perf_counter() - t0
    p_k1_ms, k1 = cuda_time_ms(lambda: kwf.trace_lanes(tables, bcfg, o, d, 7),
                               3)
    p_k2_ms, (k2, resf, resi) = cuda_time_ms(
        lambda: kwf.trace_lanes(tables, bcfg, o, d, 7, residual=True), 3)
    g = torch.full((n_big, 3), 1.0 / n_big, device="cuda")
    p_k3_ms, k3 = cuda_time_ms(
        lambda: kwf.bwd_res(tables, bcfg, g, k2, resf, resi), 3)
    p_k4_ms, k4 = cuda_time_ms(
        lambda: kwf.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k1), 3)
    xerr = compare_grads(k4, k3, "K4 vs K3 1M lanes past 64", CROSS_RTOL,
                         CROSS_ATOL)
    # the plain versions once, and the replay path (K1 + K4) through
    # make_cuda_diff_tracer, its launches counted
    p_plain = {}
    p_plain["K1"], ref = once_ms(
        lambda: kwf.trace_lanes_plain(tables, bcfg, o, d, 7))
    _, mabs, _ = compare(k1, ref, "K1 1M lanes past 64")
    same_bits(k1, ref, "K1 1M lanes past 64")
    max_abs_err = max(max_abs_err, mabs)
    p_plain["K3"], ref = once_ms(
        lambda: kwf.bwd_res_plain(tables, bcfg, g, k2, resf, resi))
    err_bwd = max(err_bwd, compare_grads(k3, ref, "K3 1M lanes past 64"))
    p_plain["K4"], ref = once_ms(lambda: kwf.bwd_replay_plain(
        tables, bcfg, o, d, 7, None, None, g, k1))
    err_replay = max(err_replay, compare_grads(k4, ref,
                                               "K4 1M lanes past 64"))
    del ref
    tx = scene.textures
    leaves = [t.clone().requires_grad_() for t in (
        scene.mat_diffuse, scene.mat_specular, scene.emission, tx.color_a,
        tx.color_b, tx.image)]
    p64_replay = kwf.make_cuda_diff_tracer(scene, bcfg, backward="replay")
    reset_counts()
    reset_big()
    (p64_replay(*leaves, scene.env_radiance_, o, d, 7).sum()
     / n_big).backward()
    torch.cuda.synchronize()
    p64_replay_launches = counts()
    if p64_replay_launches != (1, 0, 0, 1) or big_counts() != (0, 0, 0, 0) \
            or not all(torch.equal(t.grad.reshape(a.shape), a)
                       for t, a in zip(leaves, k4[:3] + k4[4:])):
        raise AssertionError(f"the replay path past 64 launched K1-K4 "
                             f"{p64_replay_launches} and K5-K8 {big_counts()},"
                             f" or its gradient is not K4's")
    del leaves
    p_cache = resf.numel() * 4 + resi.numel() * 4
    ops1 = k1_ops(tables.static, resf, bcfg)
    ops4 = k4_ops(tables.static, resf, bcfg)
    m_rows = len(tables.static["mats"]["kind"])
    # as K7's and K8's: K3 reads the cache, g and L, K4 the rays, g and L;
    # both write the (M, 9) tables (the row-tagged planes and texel entries
    # are their own scratch, not the function's bytes)
    p64_bounds = {
        "K1": bound_ms(n_big * (24 + 12), ops1),
        "K2": bound_ms(n_big * (24 + 12) + p_cache, ops1),
        "K3": bound_ms(p_cache + n_big * 24 + m_rows * 9 * 4,
                       k3_ops(tables.static, bcfg, n_big)),
        "K4": bound_ms(n_big * (24 + 12 + 12) + m_rows * 9 * 4, ops4)}
    print(f"timing past 64 on K1-K4: spheres 1026 surfaces, 16x16 ground "
          f"atlas, depth 3, {n_big} pixel-centre lanes: K1 {p_k1_ms:.3f} ms, "
          f"K2 {p_k2_ms:.3f} ms, K3 {p_k3_ms:.3f} ms and K4 {p_k4_ms:.3f} ms "
          f"(row-tagged, with the sorts and sums by row and texel); plain K1 "
          f"{p_plain['K1']:.1f} ms, plain K3 {p_plain['K3']:.1f} ms, plain "
          f"K4 {p_plain['K4']:.1f} ms, the kernels within the bounds of "
          f"phase 3; K4 vs K3 max |diff| {xerr:.3g}; the replay path "
          f"(make_cuda_diff_tracer(backward='replay')) launched K1/K2/K3/K4 "
          f"{p64_replay_launches}, its gradient K4's bit for bit; "
          f"pack_tables {pack_s * 1e3:.1f} ms on the host; on {smi}",
          flush=True)
    for k, (t, by) in p64_bounds.items():
        print(f"bound past 64: {k} {t:.4f} ms by {by} (K1 ops {ops1:.4g}, K4 "
              f"ops {ops4:.4g}, cache {p_cache:.4g} B)", flush=True)
    del k1, k2, k3, k4, resf, resi, g, o, d

    # the textured K5, K7 and K8 at the 1M pixel-centre lanes (checker
    # ground), with the plain versions once and the replay path (K5 + K8)
    scene = p64_cuda["checker"]
    o, d = pixel_centre_rays(scene, n_big)
    tables = kbs.pack_big_tables(scene, bcfg)
    t_k5_ms, k5 = cuda_time_ms(lambda: kbs.trace_lanes(tables, bcfg, o, d, 7),
                               3)
    k6, resf, resi = kbs.trace_lanes(tables, bcfg, o, d, 7, residual=True)
    g = torch.full((n_big, 3), 1.0 / n_big, device="cuda")
    t_k7_ms, k7 = cuda_time_ms(
        lambda: kbs.bwd_res(tables, bcfg, g, k6, resf, resi), 3)
    t_k8_ms, k8 = cuda_time_ms(
        lambda: kbs.bwd_replay(tables, bcfg, o, d, 7, None, None, g, k5), 3)
    t_plain = {}
    t_plain["K5"], ref = once_ms(
        lambda: kbs.trace_lanes_plain(tables, bcfg, o, d, 7))
    _, mabs, _ = compare(k5, ref, "textured K5 1M lanes")
    err_k5 = max(err_k5, mabs)
    t_plain["K8"], ref = once_ms(lambda: kbs.sums_plain(
        tables, bcfg, *kbs.bwd_replay_plain(tables, bcfg, o, d, 7, None, None,
                                            g, k5)))
    err_k8 = max(err_k8, compare_grads(k8, ref, "textured K8 1M lanes"))
    xerr = compare_grads(k8, k7, "textured K8 vs K7 1M lanes", CROSS_RTOL,
                         CROSS_ATOL)
    del ref
    tx = scene.textures
    leaves = [t.clone().requires_grad_() for t in (
        scene.mat_diffuse, scene.mat_specular, scene.emission, tx.color_a,
        tx.color_b)]
    tex_replay = kbs.make_bigscene_diff_tracer(scene, bcfg, backward="replay")
    reset_counts()
    reset_big()
    (tex_replay(*leaves, scene.env_radiance_, o, d, 7).sum()
     / n_big).backward()
    torch.cuda.synchronize()
    tex_big_replay = big_counts()
    if tex_big_replay != (1, 0, 0, 1) or counts() != (0, 0, 0, 0) or \
            not all(torch.equal(t.grad, a)
                    for t, a in zip(leaves, k8[:3] + k8[4:])):
        raise AssertionError(f"the textured big replay path launched K5-K8 "
                             f"{tex_big_replay} and K1-K4 {counts()}, or its "
                             f"gradient is not K8's")
    ops5t = k5_ops(tables, resf, bcfg)
    ops8t = k8_ops(tables, resf, bcfg)
    t_cache = resf.numel() * 4 + resi.numel() * 4
    PB = 9
    tex_bounds = {
        "K5": bound_ms(n_big * (24 + 12), ops5t),
        "K7": bound_ms(t_cache + n_big * 24 + m_rows * PB * 4, float(
            n_big * (bcfg.max_depth * (45 + 27 * len(tables.static["lights"]))
                     + 6))),
        "K8": bound_ms(n_big * (24 + 12 + 12) + m_rows * PB * 4, ops8t)}
    print(f"timing textured past 64: spheres 1026 surfaces, checker ground, "
          f"depth 3, {n_big} pixel-centre lanes: K5 {t_k5_ms:.3f} ms, K7 "
          f"{t_k7_ms:.3f} ms, K8 {t_k8_ms:.3f} ms (K7 and K8 with their sorts "
          f"and sums by row); plain K5 {t_plain['K5']:.1f} ms, plain K8 "
          f"{t_plain['K8']:.1f} ms, the kernels within the bounds of phase 3;"
          f" K8 vs K7 max |diff| {xerr:.3g}; the replay path launched "
          f"K5/K6/K7/K8 {tex_big_replay}, its gradient K8's bit for bit; on "
          f"{smi}", flush=True)
    for k, (t, by) in tex_bounds.items():
        print(f"bound textured: {k} {t:.4f} ms by {by} (K5 ops {ops5t:.4g}, "
              f"K8 ops {ops8t:.4g}, cache {t_cache:.4g} B)", flush=True)
    del k5, k6, k7, k8, resf, resi, g, o, d, leaves

    # 11e. a smallpt frame through render() (K1)
    reset_counts()
    img = render(builders.smallpt(256, 256), spp=16, seed=seed, clamp=False)
    torch.cuda.synchronize()
    smallpt_launches = counts()
    a = img.cpu().numpy()
    if smallpt_launches[0] == 0 or not np.isfinite(a).all() or (a < 0).any() \
            or a.mean() <= 0:
        raise AssertionError(f"smallpt frame: launches {smallpt_launches}, "
                             f"mean {a.mean()}")
    spt = builders.smallpt(256, 256).to("cuda")
    cfg = kwf.KernelConfig(max_depth=5, sampler="hash")
    o, d, si, pix = jittered_rays(spt, 1 << 16, 53)
    tables = kwf.pack_tables(spt, cfg)
    k1 = kwf.trace_lanes(tables, cfg, o, d, 59, si, pix)
    k2 = kwf.trace_lanes(tables, cfg, o, d, 59, si, pix, residual=True)
    same_bits(k1, kwf.trace_lanes_plain(tables, cfg, o, d, 59, si, pix),
              "K1 smallpt")
    same_bits(k2, kwf.trace_lanes_plain(tables, cfg, o, d, 59, si, pix,
                                        residual=True), "K2 smallpt")
    print(f"frame: smallpt 256x256 16 spp through render(): mean "
          f"{a.mean():.5f}, launches K1/K2/K3/K4 {smallpt_launches}; K1 and "
          f"K2 (radiance, cache) = plain bit for bit on {o.shape[0]} lanes, "
          f"depth 5, hash (tables in shared memory: {tables.stage_bytes} B)",
          flush=True)
    del img, k1, k2

    src = "kytpu_torch/kernels/csrc/"
    tex_steps = [sum(tl[k] for tl in tex_train.values()) for k in (1, 2)]
    rows = [("wavefront_fwd", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:1760",
             render_launches[0] + tex_render_launches[0]
             + sep_render_launches[0] + smallpt_launches[0]
             + p64_replay_launches[0], max_abs_err, ms, plain_ms, "K1"),
            ("wavefront_fwd_res", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:3349",
             train_launches[1] + gloss_launches[1] + tex_steps[0]
             + sep_train[1], err_res, k2_ms, plain_k2_ms, "K2"),
            ("wavefront_bwd_res", "wavefront_bwd_res.cu",
             "kytpu/kernels/wavefront.py:3445",
             train_launches[2] + gloss_launches[2] + tex_steps[1]
             + sep_train[2], err_bwd, k3_ms, plain_k3_ms, "K3"),
            ("wavefront_bwd_replay", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:3470",
             replay_launches[3] + tex_replay_launches[3]
             + p64_replay_launches[3], err_replay, k4_ms, plain_k4_ms, "K4"),
            ("bigscene_fwd", "bigscene_fwd.cu",
             "kytpu/kernels/bigscene.py:2144",
             big_render_launches[0] + tex_big_launches[0] + tex_big_replay[0],
             err_k5, k5_ms, plain_k5_ms, "K5"),
            ("bigscene_fwd_res", "bigscene_fwd.cu",
             "kytpu/kernels/bigscene.py:2361",
             big_train_launches[1] + tex_big_train[1], err_k6, k6_ms,
             plain_k6_ms, "K6"),
            ("bigscene_bwd_res", "bigscene_bwd_res.cu",
             "kytpu/kernels/bigscene.py:2421",
             big_train_launches[2] + tex_big_train[2], err_k7, k7_ms,
             plain_k7_ms, "K7"),
            ("bigscene_bwd_replay", "bigscene_fwd.cu",
             "kytpu/kernels/bigscene.py:2445",
             big_replay_launches[3] + tex_big_replay[3], err_k8, k8_ms,
             plain_k8_ms, "K8")]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "source": src + f, "replaces": rp,
         "launches": nl, "max_abs_err": err, "ms": t, "plain_ms": pt,
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None}
        for nm, f, rp, nl, err, t, pt, k in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


class _LastLine:
    """Standard output that remembers the last line written to it."""

    def __init__(self, stream):
        self.stream, self.last = stream, ""

    def write(self, s: str) -> int:
        lines = [ln for ln in s.splitlines() if ln.strip()]
        if lines:
            self.last = lines[-1]
        return self.stream.write(s)

    def __getattr__(self, name):
        return getattr(self.stream, name)


if __name__ == "__main__":
    sys.stdout = out = _LastLine(sys.stdout)
    try:
        main()
    except Exception:
        traceback.print_exc()
        out.flush()
        print("chip_smoke.py failed; the last line it printed: "
              f"{out.last or '(none)'}",
              file=sys.stderr, flush=True)
        sys.exit(1)
    sys.stdout.flush()
