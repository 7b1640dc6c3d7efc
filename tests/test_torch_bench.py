"""kytpu_torch.bench against the JAX package's bench.py, on the CPU.

- `_rays`: the jitter is jax.random.uniform(key(0), (n, 2))'s bits, equal
  to kytpu's to the bit; the rays within atol 1e-6 (kytpu's `_rays` runs
  generate_rays op by op, the port rounds as XLA's fused version does).
- `make_fwd_bwd` (the plain K2 + K3 on CPU tensors) against kytpu's
  make_pallas_diff_tracer (K2 + K3 interpreted), on the same rays and
  seed, 2,048 lanes at depth 2: over the lanes that do not take the
  reference's self-occlusion near-tie another way (at most PARITY_SHARE
  of them), the loss within rtol 1e-4 and each gradient within rtol 1e-4
  plus 1e-6 of the table's largest entry (float32 sums over 2,048 lanes
  in another order).
- `main` prints one JSON line of kytpu's four keys; a kernel that fails
  makes it raise before any line is printed (no fallback).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu.kernels import wavefront as jwf
from kytpu.scene import builders as jb
from kytpu_torch import bench
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.scene import builders as tb
from tests.test_torch_wavefront_veach import PARITY_SHARE
import tests.torch_threads  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
SEED = 11


@pytest.fixture(scope="module")
def kbench():
    """The JAX package's bench.py, loaded from its file (its import points
    jax's compilation cache elsewhere; the suite's setting is restored)."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "kytpu_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def test_constants_match_kytpu(kbench):
    assert (bench.W, bench.H, bench.LANES) == (kbench.W, kbench.H,
                                                kbench.LANES)


def test_rays_match_kytpu(kbench):
    n = 4096
    jsc = jb.veach_mis(width=bench.W, height=bench.H)
    tsc = tb.veach_mis(width=bench.W, height=bench.H)
    from kytpu_torch.core import rng as krng
    u_port = krng.uniform(krng.key(0), (n, 2)).numpy()
    u_kytpu = np.asarray(jax.random.uniform(jax.random.key(0), (n, 2)))
    assert np.array_equal(u_port.view(np.uint32), u_kytpu.view(np.uint32))
    jo, jd = (np.asarray(a) for a in kbench._rays(jsc, n))
    to, td = (a.numpy() for a in bench._rays(tsc, n))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)


def _kytpu_tracer(shadow: str, max_depth: int):
    """kytpu's K2 + K3, interpreted, on Veach: fn(diffuse, specular,
    emission) -> (N, 3) on the port's rays (about 30 s to trace at depth
    2)."""
    jsc = jb.veach_mis(width=bench.W, height=bench.H)
    tracer = jwf.make_pallas_diff_tracer(
        jsc, jwf.KernelConfig(max_depth=max_depth, shadow=shadow),
        interpret=True)
    o, d = (jnp.asarray(a.numpy()) for a in bench._rays(
        tb.veach_mis(width=bench.W, height=bench.H), N))
    env0 = jnp.zeros(3, jnp.float32)
    return (lambda dd, ss, ee: tracer(dd, ss, ee, env0, o, d,
                                      jnp.int32(SEED))), \
        (jsc.mat_diffuse, jsc.mat_specular, jsc.emission)


def _grads_agree(got, ref):
    for name, g, r in zip(("diffuse", "specular", "emission"), got, ref):
        g, r = np.asarray(g), np.asarray(r)
        bound = 1e-4 * np.abs(r) + 1e-6 * max(1.0, np.abs(r).max())
        assert not (np.abs(g - r) > bound).any(), (name,
                                                   np.abs(g - r).max())


def test_fwd_bwd_matches_kytpu():
    """bench's own configuration (shadow="parity", kytpu's default), depth
    2: the reference's sphere-light self-occlusion near-tie sends up to
    PARITY_SHARE of Veach's lanes another way
    (test_torch_wavefront_veach.py), which moves the whole loss by about
    1e-3. Those lanes are counted; the whole loss differs from kytpu's by
    no more than they do (plus rtol 1e-4), and the loss and the gradients
    over the other lanes (their cotangent 1/N, the rest 0) are held within
    rtol 1e-4 and the suite's gradient bound."""
    tsc = tb.veach_mis(width=bench.W, height=bench.H)
    loss, grads = bench.make_fwd_bwd(tsc, lanes=N, max_depth=2)(SEED)
    # bench's pieces, lane by lane
    tracer = twf.make_cuda_diff_tracer(tsc, twf.KernelConfig(max_depth=2))
    o, d = bench._rays(tsc, N)
    leaves = [t.clone().requires_grad_() for t in
              (tsc.mat_diffuse, tsc.mat_specular, tsc.emission)]
    out = tracer(*leaves, torch.zeros(3), o, d, SEED)
    assert torch.equal(out.sum() / N, loss)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.autograd.grad(out.sum() / N, leaves, retain_graph=True),
        grads))
    trace, tables = _kytpu_tracer("parity", 2)
    jout, vjp = jax.vjp(trace, *tables)
    got, ref = out.detach().numpy(), np.asarray(jout)
    bad = (np.abs(got - ref) > 1e-3 * np.abs(ref) + 1e-4).any(1)
    assert bad.mean() <= PARITY_SHARE, bad.mean()
    assert abs(float(loss) - ref.sum() / N) <= (
        np.abs(got - ref)[bad].sum() / N + 1e-4 * abs(ref.sum() / N))
    w = np.broadcast_to(np.where(bad, 0.0, 1.0 / N)[:, None],
                        (N, 3)).astype(np.float32)
    np.testing.assert_allclose((got * w).sum(), (ref * w).sum(), rtol=1e-4,
                               atol=0)
    _grads_agree(torch.autograd.grad(out, leaves, torch.from_numpy(w)),
                 vjp(jnp.asarray(w)))


def test_main_prints_kytpus_four_keys(monkeypatch, capsys):
    """One JSON line, kytpu's keys, the residual path's metric name (fewer
    launches a timed run, so that the plain versions finish quickly)."""
    monkeypatch.setattr(bench, "SMALL", (1, 100))
    monkeypatch.setattr(bench, "BIG", (2, 200))
    rec = bench.main(lanes=N, max_depth=1, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == rec
    assert list(got) == ["metric", "value", "unit", "vs_baseline"]
    assert got["metric"] == \
        "veach_mis_fwd_bwd_rays_per_s_per_chip[cuda_residual]"
    assert got["unit"] == "rays/s" and got["value"] > 0
    assert got["vs_baseline"] == round(got["value"]
                                       / bench.BASELINE_RAYS_PER_S, 4)


def test_a_failing_kernel_raises_and_prints_nothing(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(bench.kwf, "make_cuda_diff_tracer", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bench.main(lanes=64, max_depth=1, device="cpu")
    assert capsys.readouterr().out == ""


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(lanes=64, max_depth=1)


def test_bench_jnp_and_replay_run_on_the_cpu(monkeypatch):
    """The jnp fast engine's rate and the replay path's (K1 + K4) give a
    positive rate on small CPU runs."""
    monkeypatch.setattr(bench, "SMALL", (1, 100))
    monkeypatch.setattr(bench, "BIG", (2, 200))
    sc = tb.veach_mis(width=bench.W, height=bench.H)
    rate, name = bench._bench_kernel(sc, lanes=256, max_depth=1,
                                     backward="replay", device="cpu")
    assert name == "cuda_replay" and rate > 0
    rate, name = bench._bench_jnp(sc, lanes=256, max_depth=1, device="cpu")
    assert name == "jnp_fast" and rate > 0
