"""A/B timing of the forward megakernels K1 and K5, the residual forward
K2, the replay backward K4 and a frame around K1, between this checkout
and other ones of the port, on one card, in one run.

    git archive <commit> | tar -x -C _archive/parent
    python -m kytpu_torch.kernels.ab_k1 _archive/parent [_archive/other ...]

First builds every checkout's kernels, all at once (`python -m
kytpu_torch.kernels.build` in each, in parallel). Then runs K1 on Veach MIS
512x308 at depth 5 over 4M jittered camera rays (the lanes of
chip_smoke.py's phase 5) in each checkout in turn, in the order the other
checkouts as given, this one, this one again, the others in reverse, each
in its own process. Each run prints the ms of 3 rounds of 5 warmed launches
(CUDA events) and the sum of the radiance, which must agree between the
checkouts when the change keeps K1's arithmetic, then the ms of 3 rounds
of 5 launches of K2 on the same lanes (the 0.70 GB cache of each launch
freed before the next) and the sum of its cache, then the ms of 3 rounds
of 5 launches of the replay backward K4 on those lanes (upstream gradient
1/N) and the sum of its gradient, then the ms of 3 rounds of 10 launches
of K2 at a train step's lanes (Cornell 256x256, 4 jittered samples a
pixel, depth 3, "hash": 262,144 lanes), with the kernel's device time a
launch (torch.profiler) and the host's time a call (10 calls, not
synchronised), then the wall time of a
Cornell box 256x256 frame at 64 spp through `render()` (the median of 5
warmed frames, host code included), then the ms of 3 rounds of 3 warmed
launches of the untextured big-scene forward K5 on random_spheres(1024) at
depth 3 over its 1M pixel-centre lanes (chip_smoke.py's phase 9d) and that
radiance's sum, then the same of K1 and K4 on those lanes of the scene
with a 16x16 ground atlas (1,026 surfaces, its tables in device memory,
K4 row-tagged; chip_smoke.py's phase 11d). The card's name and power
limit come first, each checkout's K1/K2/K4 registers, stack and spills
next, and a summary of each checkout's mean times last. Needs a CUDA device; the other
checkouts need `kytpu_torch.kernels.bigscene.make_bigscene_tracer`.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json, time, numpy as np, torch
from kytpu_torch.integrator.render import render
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import generate_rays
sc = builders.veach_mis(512, 308).to("cuda")
cfg = kwf.KernelConfig(max_depth=5)
n = 1 << 22
cam = sc.camera
rng = np.random.default_rng(3)
pid = np.arange(n) % (cam.width * cam.height)
pf = np.stack([pid % cam.width + rng.random(n),
               pid // cam.width + rng.random(n)], -1).astype(np.float32)
o, d = generate_rays(cam, torch.from_numpy(pf).cuda())
tracer = kwf.make_cuda_tracer(sc, cfg)
out = tracer(sc, o, d, 5)
ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(5):
        out = tracer(sc, o, d, 5)
    t1.record()
    torch.cuda.synchronize()
    ms.append(t0.elapsed_time(t1) / 5)
tables = kwf.pack_tables(sc, cfg)
k2_ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(5):
        res = kwf.trace_lanes(tables, cfg, o, d, 5, residual=True)
        del res
    t1.record()
    torch.cuda.synchronize()
    k2_ms.append(t0.elapsed_time(t1) / 5)
_, resf, resi = kwf.trace_lanes(tables, cfg, o, d, 5, residual=True)
k2_sum = float(resf.double().sum()) + float(resi.double().sum())
del resf, resi
g = torch.full((n, 3), 1.0 / n, device="cuda")
k4_ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(5):
        k4 = kwf.bwd_replay(tables, cfg, o, d, 5, None, None, g, out)
    t1.record()
    torch.cuda.synchronize()
    k4_ms.append(t0.elapsed_time(t1) / 5)
k4_sum = sum(float(t.double().sum()) for t in k4)
cb = builders.cornell_box(width=256, height=256)
ccfg = kwf.KernelConfig(max_depth=3, sampler="hash")
cn = 4 * 256 * 256
cpid = np.arange(cn) % (256 * 256)
cpf = np.stack([cpid % 256 + rng.random(cn), cpid // 256 + rng.random(cn)],
               -1).astype(np.float32)
co, cd = generate_rays(cb.to("cuda").camera, torch.from_numpy(cpf).cuda())
csi = torch.from_numpy((np.arange(cn) // (256 * 256)).astype(np.int32)).cuda()
cpix = torch.from_numpy(cpid.astype(np.int32)).cuda()
ctab = kwf.pack_tables(cb.to("cuda"), ccfg)
step_ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(10):
        res = kwf.trace_lanes(ctab, ccfg, co, cd, 5, csi, cpix, residual=True)
    t1.record()
    torch.cuda.synchronize()
    step_ms.append(t0.elapsed_time(t1) / 10)
k2_sum += float(res[1].double().sum())
del res
# the same launches' device time (profiler) and host time (no sync)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(10):
        res = kwf.trace_lanes(ctab, ccfg, co, cd, 5, csi, cpix, residual=True)
    torch.cuda.synchronize()
step_dev_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "wavefront_fwd_kernel" in e.name) / 1e4
torch.cuda.synchronize()
h0 = time.perf_counter()
for _ in range(10):
    res = kwf.trace_lanes(ctab, ccfg, co, cd, 5, csi, cpix, residual=True)
step_host_ms = (time.perf_counter() - h0) * 100
torch.cuda.synchronize()
del res
render(cb, spp=64)
walls = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(cb, spp=64)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
from kytpu_torch.kernels import bigscene as kbs
big = builders.random_spheres(n=1024, width=256, height=256).to("cuda")
bcfg = kwf.KernelConfig(max_depth=3)
nb = 1 << 20
pid = torch.arange(nb, device="cuda") % (256 * 256)
bo, bd = generate_rays(big.camera, torch.stack(
    [(pid % 256).float() + 0.5, (pid // 256).float() + 0.5], -1))
btracer = kbs.make_bigscene_tracer(big, bcfg)
bout = btracer(big, bo, bd, 7)
k5_ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(3):
        bout = btracer(big, bo, bd, 7)
    t1.record()
    torch.cuda.synchronize()
    k5_ms.append(t0.elapsed_time(t1) / 3)
import dataclasses
from kytpu_torch.scene import texture as ktex
tid = torch.full((int(big.mat_kind.shape[0]),), -1, dtype=torch.int32)
tid[0] = 0
img = np.random.default_rng(6).uniform(0.1, 0.9, (16, 16, 3)).astype(np.float32)
atlas = dataclasses.replace(big, has_textures=True, tex_id=tid, textures=ktex.build(
    [dict(kind=ktex.IMAGE, image=img, scale=(4.0, 4.0))])).to("cuda")
p64 = kwf.make_cuda_tracer(atlas, bcfg)
pout = p64(atlas, bo, bd, 7)
p64_ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(3):
        pout = p64(atlas, bo, bd, 7)
    t1.record()
    torch.cuda.synchronize()
    p64_ms.append(t0.elapsed_time(t1) / 3)
ptab = kwf.pack_tables(atlas, bcfg)
gb = torch.full((nb, 3), 1.0 / nb, device="cuda")
p4 = kwf.bwd_replay(ptab, bcfg, bo, bd, 7, None, None, gb, pout)
p64_k4_ms = []
for _ in range(3):
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(3):
        p4 = kwf.bwd_replay(ptab, bcfg, bo, bd, 7, None, None, gb, pout)
    t1.record()
    torch.cuda.synchronize()
    p64_k4_ms.append(t0.elapsed_time(t1) / 3)
k4_sum += sum(float(t.double().sum()) for t in p4)
print(json.dumps({"ms": ms, "sum": float(out.double().sum()),
                  "p64_k4_ms": p64_k4_ms, "step_ms": step_ms,
                  "step_dev_ms": step_dev_ms, "step_host_ms": step_host_ms,
                  "k4_ms": k4_ms, "k4_sum": k4_sum,
                  "p64_ms": p64_ms, "p64_sum": float(pout.double().sum()),
                  "frame_ms": float(np.median(walls)), "k2_ms": k2_ms,
                  "k2_sum": k2_sum,
                  "k5_ms": k5_ms,
                  "k5_sum": float(bout.double().sum())}))
"""


def run(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", _RUN], cwd=root, env=env,
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"the run in {root} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def ptxas_lines(report: str) -> list[str]:
    """-Xptxas -v's registers, stack and spills of each K1/K2/K4
    instantiation, wavefront_fwd_kernel<MODE, SOBOL, TEX, ROWTAG[, SH]>."""
    lines, name, frame = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"wavefront_fwd_kernelI((?:L[ib]\d+E)+)E", ln)
        if "Compiling entry" in ln:
            name = ("<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(1)))
                    + ">") if m else None
        elif name and "stack frame" in ln:
            frame = ln.split(":", 1)[-1].strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            lines.append(f"{name} {regs} registers, {frame}")
            name = None
    return lines


def prebuild(roots) -> None:
    """Build every checkout's kernels at once, one process each, and print
    each one's K1/K2/K4 registers, stack and spills."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kytpu_torch.kernels.build"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for root in roots]
    for root, p in zip(roots, procs):
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"build failed in {root}:\n{out}")
        print(f"built {root}: {out.strip().splitlines()[0]}", flush=True)
        for ln in ptxas_lines(out):
            print(f"  {root.name} {ln}", flush=True)


def main(others: list[str]) -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    here = Path(__file__).resolve().parents[2]
    roots = [Path(o).resolve() for o in others] + [here]
    prebuild(roots)
    order = roots[:-1] + [here, here] + roots[-2::-1]
    sums, seen = set(), {}
    for root in order:
        r = run(root)
        sums.add((r["sum"], r["k2_sum"], r["k4_sum"], r["k5_sum"],
                  r["p64_sum"]))
        seen.setdefault(root, []).append(r)
        print(f"{root}: K1 ms "
              f"{', '.join(f'{t:.3f}' for t in r['ms'])}; sum {r['sum']!r}; "
              f"K2 ms {', '.join(f'{t:.3f}' for t in r['k2_ms'])}; cache sum "
              f"{r['k2_sum']!r}; K4 ms "
              f"{', '.join(f'{t:.3f}' for t in r['k4_ms'])}; gradient sum "
              f"{r['k4_sum']!r}; K2 at a train step's lanes ms "
              f"{', '.join(f'{t:.3f}' for t in r['step_ms'])} (device "
              f"{r['step_dev_ms']:.3f}, host {r['step_host_ms']:.3f} a call); "
              f"Cornell 64-spp frame {r['frame_ms']:.3f} "
              f"ms; K5 ms {', '.join(f'{t:.3f}' for t in r['k5_ms'])}; sum "
              f"{r['k5_sum']!r}; K1 past 64 ms "
              f"{', '.join(f'{t:.3f}' for t in r['p64_ms'])}; sum "
              f"{r['p64_sum']!r}; K4 past 64 ms "
              f"{', '.join(f'{t:.3f}' for t in r['p64_k4_ms'])}", flush=True)
    for root, rs in seen.items():
        mean = lambda k: sum(sum(r[k]) / len(r[k]) for r in rs) / len(rs)  # noqa
        print(f"mean {root.name}: K1 {mean('ms'):.3f} ms, K2 "
              f"{mean('k2_ms'):.3f} ms, K4 {mean('k4_ms'):.3f} ms, K2 at a "
              f"train step's lanes {mean('step_ms'):.3f} ms, K5 {mean('k5_ms'):.3f} ms, K1 past 64 "
              f"{mean('p64_ms'):.3f} ms, K4 past 64 {mean('p64_k4_ms'):.3f} "
              f"ms, frame "
              f"{sum(r['frame_ms'] for r in rs) / len(rs):.3f} ms", flush=True)
    print("radiance, cache and gradient sums agree" if len(sums) == 1
          else f"sums differ: {sorted(sums)}")


if __name__ == "__main__":
    main(sys.argv[1:])
