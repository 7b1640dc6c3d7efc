"""Headline benchmark: primary rays/s on one card, forward+backward, Veach
MIS 512x308 at depth 5.

    python -m kytpu_torch.bench

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "rays/s", "vs_baseline": N}

Measures the production differentiable path, the one the JAX package's
bench.py runs: `kernels.wavefront.make_cuda_diff_tracer` with its default
backward="residual", that is K2, the forward megakernel that also writes a
per-bounce coefficient cache (csrc/wavefront_fwd.cu), then K3, the cache
backward (csrc/wavefront_bwd_res.cu), differentiating loss = sum(radiance)
/ LANES with respect to the diffuse, specular and emission tables. The
metric counts PRIMARY rays; every primary ray carries the full depth-5
path (per-light NEE + MIS). The rate is marginal: 56 more launches in the
longer of two timed runs over its extra time, which cancels the runs' fill
and per-run overhead.

A kernel that fails to build or launch raises: the process exits non-zero
and prints no result line. Nothing falls back to the jnp engine, whose rate
`_bench_jnp` measures on its own. The JAX package's ROWS and BWD_ROWS
(Pallas tile sizes) mean nothing on the card and are not read.

vs_baseline is against this port's own earlier rate on the card
(`BASELINE_RAYS_PER_S`), not a TPU figure.
"""

from __future__ import annotations

import json
import time

import torch

from kytpu_torch.core import rng as krng
from kytpu_torch.core.device import check_device
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import generate_rays

# chip_smoke.py's residual fwd+bwd at these 4,194,304 lanes, 8.352 ms, on
# an NVIDIA H100 80GB HBM3 at a 700 W limit (PERF.md section 5, the run of
# commit 2abd294): 4,194,304 / 8.352 ms
BASELINE_RAYS_PER_S = 502.2e6
LANES = 1 << 22   # large batches amortize the per-launch overhead
W, H = 512, 308
# the two timed runs: (launches, first seed)
SMALL, BIG = (8, 100), (64, 200)


def _rays(scene, n: int):
    """n lanes over the W x H film, lane i at pixel i mod W*H jittered by
    jax.random.uniform(key(0), (n, 2))'s bits -> (o, d), each (n, 3) on the
    scene's device."""
    dev = scene.mat_diffuse.device
    u = krng.uniform(krng.key(0, dev), (n, 2))
    pid = torch.arange(n, dtype=torch.int32, device=dev) % (W * H)
    px = (pid % W).to(torch.float32) + u[:, 0]
    py = (pid // W).to(torch.float32) + u[:, 1]
    return generate_rays(scene.camera, torch.stack([px, py], -1))


def _seconds(calls, device: torch.device) -> float:
    """Seconds that calls() took: CUDA events recorded around it and a
    synchronize after it on the card, the host's clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        calls()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    calls()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / 1e3


def _marginal_rate(step, lanes: int, device, small=None, big=None) -> float:
    """Rays/s of step(seed) over (big - small) launches (SMALL and BIG by
    default): one warm call, then a timed run of each size, launch i of a
    run with seed base + i."""
    small, big = small or SMALL, big or BIG
    step(7)

    def run(n, base):
        def calls():   # each launch's outputs freed before the next
            for i in range(n):
                step(base + i)
        return _seconds(calls, device)

    t_small, t_big = run(*small), run(*big)
    return (big[0] - small[0]) * lanes / (t_big - t_small)


def make_fwd_bwd(scene, *, lanes: int = LANES, max_depth: int = 5,
                 backward: str = "residual"):
    """fwd_bwd(seed) -> (loss, (d_diffuse, d_specular, d_emission)) of loss
    = sum(tracer(...)) / lanes on `_rays(scene, lanes)`, through
    make_cuda_diff_tracer(scene, KernelConfig(max_depth), backward), on the
    scene's device."""
    tracer = kwf.make_cuda_diff_tracer(
        scene, kwf.KernelConfig(max_depth=max_depth), backward=backward)
    o, d = _rays(scene, lanes)
    env = (scene.env_radiance_ if scene.has_env
           else torch.zeros(3, device=o.device))
    leaves = [t.detach().clone().requires_grad_() for t in
              (scene.mat_diffuse, scene.mat_specular, scene.emission)]

    def fwd_bwd(seed: int):
        loss = tracer(*leaves, env, o, d, seed).sum() / lanes
        return loss, torch.autograd.grad(loss, leaves)

    return fwd_bwd


def _bench_kernel(scene, *, lanes: int = LANES, max_depth: int = 5,
                  backward: str = "residual", device="cuda"):
    """(rays/s, engine name) of the kernels' forward+backward: K2 + K3
    (backward="residual") or K1 + K4 ("replay")."""
    device = check_device(device)
    fwd_bwd = make_fwd_bwd(scene.to(device), lanes=lanes,
                           max_depth=max_depth, backward=backward)
    return _marginal_rate(fwd_bwd, lanes, device), f"cuda_{backward}"


def _bench_jnp(scene, *, lanes: int = LANES, max_depth: int = 5,
               device="cuda"):
    """(rays/s, "jnp_fast") of the fast jnp engine's forward+backward (torch
    code, no kernel of its own) on pixel-corner lanes, the gradient of
    sum / lanes with respect to the trainable tables through autograd;
    launch i of a run draws with fold_in(key(1234), base + i)."""
    from kytpu_torch.diff.params import get_params, set_params
    from kytpu_torch.integrator import fast as kfast
    from kytpu_torch.integrator.render import trace_lanes

    device = check_device(device)
    scene = scene.to(device)
    cfg = kfast.FastConfig(max_depth=max_depth)
    key = krng.key(1234, device)
    pid = torch.arange(lanes, dtype=torch.int32, device=device) % (W * H)
    sid = torch.zeros(lanes, dtype=torch.int32, device=device)
    px = (pid % W).to(torch.float32)
    py = (pid // W).to(torch.float32)
    params = {n: p.detach().clone().requires_grad_()
              for n, p in get_params(scene).items()}

    def fwd_bwd(i: int):
        out = trace_lanes(set_params(scene, params), krng.fold_in(key, i),
                          px, py, pid, sid, cfg, "fast", None)
        loss = out.sum() / lanes
        return loss, torch.autograd.grad(loss, list(params.values()))

    return (_marginal_rate(fwd_bwd, lanes, device, (2, 100), (8, 200)),
            "jnp_fast")


def main(*, lanes: int = LANES, max_depth: int = 5,
         backward: str = "residual", device="cuda") -> dict:
    """Measure `_bench_kernel` on Veach MIS and print its JSON line."""
    scene = builders.veach_mis(width=W, height=H)
    rays_per_s, engine = _bench_kernel(scene, lanes=lanes,
                                       max_depth=max_depth,
                                       backward=backward, device=device)
    record = {
        "metric": f"veach_mis_fwd_bwd_rays_per_s_per_chip[{engine}]",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 4),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
