"""Smoke run of kytpu_torch on one NVIDIA GPU: build, check, render, time.

    python3 chip_smoke.py            # about a minute on an H100

Phases, one line each:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: compiles kytpu_torch/kernels/csrc/*.cu with nvcc;
  3. kernel vs plain: the CUDA forward megakernel against its plain PyTorch
     version on the card, on 256K camera rays at depth 5, for Veach MIS and
     two Cornell boxes, across both samplers, both NEE modes and both shadow
     modes (tolerance: at most 0.5% of lanes outside rtol=1e-3/atol=1e-4 per
     channel, and the means within 3 standard errors);
  4. frames: render(veach_mis(512, 308)) and render(cornell_box 256x256) at
     64 spp through render(engine="cuda"), the main path, whose launches are
     counted; each 64-spp frame and a 4-spp frame of each scene against the
     same frame traced by the plain version (same seed and pass split, so
     the same lanes: 946176 a pass for Veach, 1048576 for Cornell); then one
     warmed frame of each under torch.profiler: the device's busy time, the
     kernel's share of it, and the device's idle share of the median wall
     time of 5 unprofiled warmed frames;
  5. timing: Veach forward at 4M lanes, depth 5, CUDA events, kernel and
     plain, and the two outputs compared.
The line before the last is the kernels' JSON record and the last line is
{"ok": true, "device": {...}}. Any failed check raises: no result is printed
and the exit code is not 0. It needs a CUDA device and imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL, MAX_BAD_SHARE = 1e-3, 1e-4, 0.005


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


def device_profile(fn, kernel_name: str):
    """Run fn once under torch.profiler -> (device busy ms, ms in kernels
    whose name holds kernel_name, number of device kernels). Busy time is
    the union of the device kernels' intervals."""
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
    mine = sum(e.time_range.elapsed_us() for e in evs if kernel_name in e.name)
    if mine == 0:
        raise AssertionError(f"the profile shows no {kernel_name} kernel")
    return busy_us / 1e3, mine / 1e3, len(evs)


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

    from kytpu_torch.integrator.render import render
    from kytpu_torch.kernels import build
    from kytpu_torch.kernels import wavefront as kwf
    from kytpu_torch.scene import builders

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds else 0:.2f} s)",
          flush=True)

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
    max_abs_err = 0.0
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

    # 4. frames through the main path (render, engine="cuda")
    frame_scenes = {"veach": builders.veach_mis(512, 308),
                    "cornell": builders.cornell_box(width=256, height=256)}
    spp, seed = 64, 1234

    def frame(sc, n_spp):
        return render(sc, spp=n_spp, seed=seed, clamp=False, engine="cuda",
                      device="cuda")

    kwf.launches = 0
    frames = {}
    for nm, sc in frame_scenes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(sc, spp)
        torch.cuda.synchronize()
        frames[nm] = (img, time.perf_counter() - t0)
    main_launches = kwf.launches
    if main_launches == 0:
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
        busy, mine, n_k = device_profile(lambda: frame(sc, spp), "wavefront_fwd")
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

    print(json.dumps({"kernels": [{
        "name": "wavefront_fwd", "route": "cuda",
        "source": "kytpu_torch/kernels/csrc/wavefront_fwd.cu",
        "replaces": "kytpu/kernels/wavefront.py:1760",
        "launches": main_launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
