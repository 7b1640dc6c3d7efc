"""A/B timing of the forward megakernels K1 and K5, the residual forward
K2, and a frame around K1, between this checkout and another one of the
port, on one card, in one run.

    git archive <commit> | tar -x -C _archive/parent
    python -m kytpu_torch.kernels.ab_k1 _archive/parent

Runs K1 on Veach MIS 512x308 at depth 5 over 4M jittered camera rays (the
lanes of chip_smoke.py's phase 5) in each checkout in turn, in the order
other, this, this, other, each in its own process that builds that
checkout's kernels. Each run prints the ms of 3 rounds of 5 warmed launches
(CUDA events) and the sum of the radiance, which must agree between the
checkouts when the change keeps K1's arithmetic, then the ms of 3 rounds
of 5 launches of K2 on the same lanes (the 0.70 GB cache of each launch
freed before the next), then the wall time of a
Cornell box 256x256 frame at 64 spp through `render()` (the median of 5
warmed frames, host code included), then the ms of 3 rounds of 3 warmed
launches of the untextured big-scene forward K5 on random_spheres(1024) at
depth 3 over its 1M pixel-centre lanes (chip_smoke.py's phase 9d) and that
radiance's sum. The card's name and power limit come first. Needs a CUDA
device; the other checkout needs
`kytpu_torch.kernels.bigscene.make_bigscene_tracer`.
"""

from __future__ import annotations

import json
import os
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
        kwf.trace_lanes(tables, cfg, o, d, 5, residual=True)
    t1.record()
    torch.cuda.synchronize()
    k2_ms.append(t0.elapsed_time(t1) / 5)
cb = builders.cornell_box(width=256, height=256)
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
print(json.dumps({"ms": ms, "sum": float(out.double().sum()),
                  "frame_ms": float(np.median(walls)), "k2_ms": k2_ms,
                  "k5_ms": k5_ms,
                  "k5_sum": float(bout.double().sum())}))
"""


def run(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", _RUN], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(other: str) -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    here = Path(__file__).resolve().parents[2]
    roots = {"other": Path(other).resolve(), "this": here}
    sums = set()
    for tag in ("other", "this", "this", "other"):
        r = run(roots[tag])
        sums.add((r["sum"], r["k5_sum"]))
        print(f"{tag} ({roots[tag]}): K1 ms "
              f"{', '.join(f'{t:.3f}' for t in r['ms'])}; sum {r['sum']!r}; "
              f"K2 ms {', '.join(f'{t:.3f}' for t in r['k2_ms'])}; "
              f"Cornell 64-spp frame {r['frame_ms']:.3f} ms; K5 ms "
              f"{', '.join(f'{t:.3f}' for t in r['k5_ms'])}; sum "
              f"{r['k5_sum']!r}", flush=True)
    print("radiance sums agree" if len(sums) == 1
          else f"radiance sums differ: {sorted(sums)}")


if __name__ == "__main__":
    main(sys.argv[1])
