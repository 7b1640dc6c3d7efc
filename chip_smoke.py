"""Smoke run of kytpu_torch on one NVIDIA GPU: build, check, render, train,
time.

    python3 chip_smoke.py            # about a minute on an H100

Phases, one line each (a few for phase 3):
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles each kytpu_torch/kernels/csrc/*.cu with its own nvcc,
     all started together, and prints each source's nvcc time and what
     -Xptxas -v said of each kernel;
  3. kernels vs plain, on 256K camera rays at depth 5, for Veach MIS and two
     Cornell boxes, across both samplers, both NEE modes and both shadow
     modes: the forward megakernel K1 against its plain PyTorch version
     (tolerance: at most 0.5% of lanes outside rtol=1e-3/atol=1e-4 per
     channel, and the means within 3 standard errors); the residual forward
     K2's radiance against K1's (bit for bit), its radiance and its cache,
     plane by plane, against the plain K2 (each plane: at most 0.5% of
     lanes outside rtol=1e-3/atol=1e-4; the int planes: at most 0.5% of
     lanes differ); the coefficient-cache backward K3 on a seeded upstream
     gradient against the plain K3 (each table within rtol=1e-4 plus 1e-6
     of its largest entry) and against itself (bit for bit, two launches);
  4. frames: render(veach_mis(512, 308)) and render(cornell_box 256x256) at
     64 spp through render(engine="cuda"), the main path, whose launches are
     counted; each 64-spp frame and a 4-spp frame of each scene against the
     same frame traced by the plain version (same seed and pass split, so
     the same lanes: 946176 a pass for Veach, 1048576 for Cornell); then one
     warmed frame of each under torch.profiler: the device's busy time, the
     kernel's share of it, and the device's idle share of the median wall
     time of 5 unprofiled warmed frames;
  5. timing: Veach forward at 4M lanes, depth 5, CUDA events, kernel and
     plain, and the two outputs compared;
  6. forward+backward: bench.py's workload (Veach 512x308, depth 5, 4M
     lanes, loss = out.sum() / N) through make_cuda_diff_tracer: its time
     and peak memory, then K2, K3 and K1 alone under CUDA events, the plain
     K2 and K3, and the kernels against them on those 4M lanes (bounds of
     phase 3), and each kernel's bound (`bounds`);
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
     itself (bit for bit).
The line before the last is the kernels' JSON record, the one before it
nvidia-smi's name and power limit, and the last line is
{"ok": true, "device": {...}}. Any failed check raises: no result is printed
and the exit code is not 0. It needs a CUDA device and imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL, MAX_BAD_SHARE = 1e-3, 1e-4, 0.005
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6   # the latter times the table's largest entry
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


def compare_grads(got, ref, what: str) -> float:
    """Each of (dd, ds, de, denv) within GRAD_RTOL plus GRAD_ATOL of its
    largest entry; returns the max |err|."""
    err = 0.0
    for name, a, b in zip(("dd", "ds", "de", "denv"), got, ref):
        tol = GRAD_RTOL * b.abs() + GRAD_ATOL * max(1.0, float(b.abs().max()))
        if not torch.isfinite(a).all() or ((a - b).abs() > tol).any():
            raise AssertionError(f"{what}: {name} outside the bound")
        err = max(err, float((a - b).abs().max()))
    return err


def k1_ops(static, cache, max_depth: int) -> float:
    """FP32 operations (add, sub, mul, div, sqrt, min/max, one per
    transcendental call) that K1 must do for the lanes of a run, counted
    from csrc/wavefront_fwd.cu for a scene of fast-path planar rows and
    sphere lights (Veach): per surface in the closest-hit sweep 31 (planar)
    or 33 (sphere), 32 per hit for the normal and the emission MIS; below
    the horizon 62 for the frame and material, 6 for the shared azimuth,
    134 per light for its sample and BSDF evaluation, 90 for the BSDF
    sample and the extension. The shadow sweeps are not counted: how far
    each goes depends on the data, so the count stays a lower bound. Live
    lane-bounces come from K2's cache of the same lanes: a lane reaches
    bounce b > 0 iff its "tu" plane at b - 1 is not 0."""
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, kwf.KernelConfig(max_depth=max_depth))
    n = cache.shape[1]
    reached = [n] + [int((cache[ix[("tu", b)]] != 0).sum())
                     for b in range(max_depth)]
    hit = 31 * len(static["planar"]) + 33 * len(static["spheres"]) + 32
    shade = 62 + 6 + 134 * len(static["lights"]) + 90
    return float(sum(reached[:-1]) * (hit + shade) + reached[-1] * hit)


def k3_ops(static, cfg, n: int) -> float:
    """FP32 operations of K3 (csrc/wavefront_bwd_res.cu), which walks every
    bounce of every lane: 45 per bounce below the horizon plus 27 per NEE
    ("B") plane of the cache, 6 at the horizon."""
    from kytpu_torch.kernels import wavefront as kwf
    ix, _ = kwf.residual_layout(static, cfg)
    n_b = sum(1 for t in ix if t[0] == "B" and t[1] == 0)
    return float(n * (cfg.max_depth * (45 + 27 * n_b) + 6))


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
def recording(kwf):
    """While the block runs, keep the arguments and (detached) result of
    the last kwf.trace_lanes and kwf.bwd_res call (the diff tracer looks
    both up in its module). The colour tables are copied at the call: an
    optimizer step later updates the parameters they share storage with."""
    seen = {}
    real = {nm: getattr(kwf, nm) for nm in ("trace_lanes", "bwd_res")}

    def wrap(nm):
        def fn(tables, *args, **kw):
            out = real[nm](tables, *args, **kw)
            seen[nm] = (dataclasses.replace(tables, **{
                k: getattr(tables, k).clone() for k in (
                    "diffuse", "specular", "emission", "light_emit", "env")}),
                args, kw, tuple(t.detach() for t in out)
                if isinstance(out, tuple) else out.detach())
            return out
        return fn

    for nm in real:
        setattr(kwf, nm, wrap(nm))
    try:
        yield seen
    finally:
        for nm, fn in real.items():
            setattr(kwf, nm, fn)


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


# device kernels by name in a profile, mangled or demangled
K1_NAMES = ("wavefront_fwd_kernel<false>", "wavefront_fwd_kernelILb0E")
K2_NAMES = ("wavefront_fwd_kernel<true>", "wavefront_fwd_kernelILb1E")
K3_NAMES = ("bwd_res_kernel", "sum_partials_kernel")


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
    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import build
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders

    def reset_counts():
        kwf.launches = kwf.launches_res_fwd = kwf.launches_res_bwd = 0

    def counts():
        return kwf.launches, kwf.launches_res_fwd, kwf.launches_res_bwd

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
    cases = [("veach", "random", "all", "parity"),
             ("veach", "hash", "single", "robust"),
             ("cornell", "hash", "all", "robust"),
             ("cornell_lights", "random", "single", "parity"),
             ("cornell_lights", "hash", "all", "parity")]
    max_abs_err = 0.0           # K1
    err_res = err_bwd = 0.0     # K2, K3
    for sc_name, sampler, nee, shadow in cases:
        scene = scenes[sc_name]
        cfg = kwf.KernelConfig(max_depth=5, sampler=sampler, nee=nee,
                               shadow=shadow)
        o, d, si, pix = jittered_rays(scene, n_lanes, 11)
        tables = kwf.pack_tables(scene, cfg)
        before = kwf.launches
        got = kwf.render_lanes_cuda(scene, o, d, 77, cfg, si, pix)
        torch.cuda.synchronize()
        if kwf.launches != before + 1:
            raise AssertionError("render_lanes_cuda did not launch the kernel")
        ref = kwf.trace_lanes_plain(tables, cfg, o, d, 77, si, pix)
        share, mabs, mdev = compare(got, ref, f"{sc_name}/{sampler}/{nee}/{shadow}")
        max_abs_err = max(max_abs_err, mabs)
        print(f"kernel vs plain: {sc_name} {sampler}/{nee}/{shadow}: "
              f"{n_lanes} lanes, {share:.5f} outside rtol={RTOL}/atol={ATOL}, "
              f"max |err| {mabs:.3g}, mean within {mdev:.2f} SE", flush=True)
        # K2 and K3 on the same lanes
        before = counts()
        k2, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 77, si, pix,
                                         residual=True)
        g = torch.randn(o.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
        grads = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        again = kwf.bwd_res(tables, cfg, g, k2, resf, resi)
        torch.cuda.synchronize()
        if counts() != (before[0], before[1] + 1, before[2] + 2):
            raise AssertionError("trace_lanes/bwd_res did not launch K2/K3")
        if not torch.equal(k2, got):
            raise AssertionError("K2's radiance is not K1's bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError("K3's gradient does not repeat bit for bit")
        ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tables, cfg, o, d, 77, si,
                                                    pix, residual=True)
        share2, mabs2, _ = compare(k2, ref_l, f"K2 {sc_name}")
        cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {sc_name}")
        gerr = compare_grads(grads, kwf.bwd_res_plain(
            tables, cfg, g, ref_l, ref_f, ref_i), f"K3 {sc_name}")
        err_res = max(err_res, mabs2, cerr)
        err_bwd = max(err_bwd, gerr)
        print(f"residual kernels vs plain: {sc_name} {sampler}/{nee}/{shadow}: "
              f"K2 radiance = K1's bit for bit, {share2:.5f} of lanes outside "
              f"vs plain (max |err| {mabs2:.3g}); cache {resf.shape[0]}+"
              f"{resi.shape[0]} planes within the bound (max |err| "
              f"{cerr:.3g}); K3 within the bound (max |err| {gerr:.3g}), "
              f"repeats bit for bit", flush=True)

    # 4. frames through the main path (render, engine="cuda")
    frame_scenes = {"veach": builders.veach_mis(512, 308),
                    "cornell": builders.cornell_box(width=256, height=256)}
    spp, seed = 64, 1234

    def frame(sc, n_spp):
        return render(sc, spp=n_spp, seed=seed, clamp=False, engine="cuda",
                      device="cuda")

    reset_counts()
    frames = {}
    for nm, sc in frame_scenes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(sc, spp)
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
    for nm, sc in frame_scenes.items():
        # render() with its defaults, traced by the plain version instead
        sc = sc.to("cuda")
        cfg = kwf.KernelConfig()
        tables = kwf.pack_tables(sc, cfg)

        def plain(s, o, d, *args):
            return kwf.trace_lanes_plain(tables, cfg, o, d, *args)

        for n_spp in (spp, 4):
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
    max_abs_err = max(max_abs_err, mabs)
    print(f"timing: veach fwd depth 5, {n_time} lanes: kernel {ms:.3f} ms "
          f"({n_time / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms "
          f"({n_time / plain_ms / 1e3:.2f} Mrays/s) on {smi}; "
          f"{share:.5f} of lanes outside the bound, max |err| {mabs:.3g}",
          flush=True)

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
    k2_ms, (k2, resf, resi) = cuda_time_ms(
        lambda: kwf.trace_lanes(tables, cfg, o, d, 5, residual=True), 5)
    k1_ms, k1 = cuda_time_ms(lambda: kwf.trace_lanes(tables, cfg, o, d, 5), 5)
    g = torch.full((n_time, 3), 1.0 / n_time, device="cuda")
    k3_ms, grads = cuda_time_ms(
        lambda: kwf.bwd_res(tables, cfg, g, k2, resf, resi), 5)
    if not (torch.equal(k1, k2) and torch.equal(k1, got)):
        raise AssertionError("K2's radiance is not K1's bit for bit at 4M lanes")
    if not all(torch.equal(a, t.grad) for a, t in zip(grads, leaves)):
        raise AssertionError("the diff tracer's gradient is not K3's")
    plain_k2_ms, (ref_l, ref_f, ref_i) = cuda_time_ms(
        lambda: kwf.trace_lanes_plain(tables, cfg, o, d, 5, residual=True), 1)
    plain_k3_ms, ref_g = cuda_time_ms(
        lambda: kwf.bwd_res_plain(tables, cfg, g, ref_l, ref_f, ref_i), 1)
    share, mabs, _ = compare(k2, ref_l, f"K2 veach {n_time} lanes")
    cerr = compare_cache(resf, resi, ref_f, ref_i, f"K2 cache {n_time} lanes")
    gerr = compare_grads(grads, ref_g, f"K3 veach {n_time} lanes")
    err_res = max(err_res, mabs, cerr)
    err_bwd = max(err_bwd, gerr)
    del ref_l, ref_f, ref_i, ref_g
    cache_bytes = resf.numel() * 4 + resi.numel() * 4
    ray_bytes = n_time * (24 + 12)   # rays in, radiance out
    ops1 = k1_ops(tables.static, resf, cfg.max_depth)
    bounds = {
        "K1": bound_ms(ray_bytes, ops1),
        "K2": bound_ms(ray_bytes + cache_bytes, ops1),
        "K3": bound_ms(cache_bytes + n_time * 24,
                       k3_ops(tables.static, cfg, n_time)),
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
    for k, (b_ms, by) in bounds.items():
        print(f"bound: {k} {b_ms:.4f} ms by {by} (K1 ops {ops1:.4g}, cache "
              f"{cache_bytes:.4g} B)", flush=True)
    del k1, k2, resf, resi, grads, g, got

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
          f"launches K1/K2/K3 {train_launches}", flush=True)
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
    tabs, (scfg, so, sd, sseed, ssi, spix), kw, (k2, resf, resi) = \
        seen["trace_lanes"]
    if not kw.get("residual"):
        raise AssertionError("the train step did not run K2")
    _, (_, sg, *_), _, grads = seen["bwd_res"]
    if not torch.equal(k2, kwf.trace_lanes(tabs, scfg, so, sd, sseed, ssi,
                                           spix)):
        raise AssertionError("K2's radiance is not K1's bit for bit on a "
                             "train step's lanes")
    if not all(torch.equal(a, b) for a, b in zip(
            grads, kwf.bwd_res(tabs, scfg, sg, k2, resf, resi))):
        raise AssertionError("K3's gradient does not repeat bit for bit on a "
                             "train step")
    ref_l, ref_f, ref_i = kwf.trace_lanes_plain(tabs, scfg, so, sd, sseed,
                                                ssi, spix, residual=True)
    share, mabs, _ = compare(k2, ref_l, "K2, a train step")
    cerr = compare_cache(resf, resi, ref_f, ref_i, "K2 cache, a train step")
    gerr = compare_grads(grads, kwf.bwd_res_plain(
        tabs, scfg, sg, ref_l, ref_f, ref_i), "K3, a train step")
    err_res = max(err_res, mabs, cerr)
    err_bwd = max(err_bwd, gerr)
    print(f"train step vs plain: {so.shape[0]} lanes, depth "
          f"{scfg.max_depth}, {scfg.sampler}/{scfg.nee}/{scfg.shadow}, "
          f"upstream gradient of relmse: K2 radiance = K1's bit for bit, "
          f"{share:.5f} of lanes outside vs plain (max |err| {mabs:.3g}); "
          f"cache {resf.shape[0]}+{resi.shape[0]} planes within the bound "
          f"(max |err| {cerr:.3g}); K3 within the bound (max |err| "
          f"{gerr:.3g}), repeats bit for bit", flush=True)

    src = "kytpu_torch/kernels/csrc/"
    rows = [("wavefront_fwd", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:1760", render_launches[0],
             max_abs_err, ms, plain_ms, "K1"),
            ("wavefront_fwd_res", "wavefront_fwd.cu",
             "kytpu/kernels/wavefront.py:3349", train_launches[1], err_res,
             k2_ms, plain_k2_ms, "K2"),
            ("wavefront_bwd_res", "wavefront_bwd_res.cu",
             "kytpu/kernels/wavefront.py:3445", train_launches[2], err_bwd,
             k3_ms, plain_k3_ms, "K3")]
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


if __name__ == "__main__":
    main()
    sys.stdout.flush()
