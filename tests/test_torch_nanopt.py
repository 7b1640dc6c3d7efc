"""kytpu_torch.examples.nanopt against the JAX package's examples/nanopt.py
on the CPU.

- `hit` on 4,096 random rays from inside the box, against kytpu's jitted
  as its `radiance` runs it: the same sphere, t within rtol 1e-5 (the
  walls are spheres of radius 1000, whose t cancels most of the bits:
  the port rounds its dot products as XLA's fused multiply-adds do).
- `radiance` at 16x16, 2 spp, depth 5 on the same camera rays and keys:
  the means within 1e-3, and at most 2% of lanes outside rtol 1e-3 /
  atol 1e-4. A ray that takes another branch on a last-bit tie of the two
  packages' cos, sin and square roots diverges from that bounce on.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu_torch.core import rng as krng
from kytpu_torch.examples import nanopt
import tests.torch_threads  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def knano():
    spec = importlib.util.spec_from_file_location(
        "kytpu_nanopt", os.path.join(REPO, "examples", "nanopt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def test_scene_table_is_kytpus(knano):
    np.testing.assert_array_equal(nanopt.S, knano.S)


def test_hit_matches_kytpu(knano):
    rng = np.random.default_rng(5)
    n = 4096
    o = np.stack([rng.uniform(0.05, 0.95, n), rng.uniform(0.05, 0.78, n),
                  rng.uniform(0.05, 1.6, n)], -1).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    t, i, ok = nanopt.hit(torch.from_numpy(o), torch.from_numpy(d))
    jt, ji, jok = (np.asarray(a) for a in jax.jit(knano.hit)(
        jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=0)


def _camera_rays(w, h, spp):
    """(o, d, sample keys) of main()'s camera for each sample, in numpy:
    kytpu's own ray construction, so that both packages trace the same
    rays."""
    key = jax.random.key(0)
    ys, xs = np.divmod(np.arange(w * h), w)
    cam_o = jnp.asarray([0.5, 0.52, 2.956])
    cam_d = jnp.asarray([0.0, -0.042612, -1.0])
    cam_d = cam_d / jnp.linalg.norm(cam_d)
    cx = jnp.asarray([w * 0.5135 / h, 0.0, 0.0])
    cy = jnp.cross(cx, cam_d)
    cy = cy / jnp.linalg.norm(cy) * 0.5135
    for s in range(spp):
        u = jax.random.uniform(jax.random.fold_in(key, 1000 + s), (w * h, 2))
        px = (jnp.asarray(xs) + u[:, 0]) / w - 0.5
        py = -((jnp.asarray(ys) + u[:, 1]) / h - 0.5)
        d = cx[None] * px[:, None] + cy[None] * py[:, None] + cam_d[None]
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        yield (np.asarray(jnp.broadcast_to(cam_o, (w * h, 3)) + 1.4 * d),
               np.asarray(d), s)


def test_radiance_matches_kytpu(knano):
    got, ref = [], []
    render = jax.jit(knano.radiance)
    for o, d, s in _camera_rays(16, 16, 2):
        ref.append(np.asarray(render(jnp.asarray(o), jnp.asarray(d),
                                     jax.random.fold_in(jax.random.key(0),
                                                        s))))
        got.append(nanopt.radiance(torch.from_numpy(o), torch.from_numpy(d),
                                   krng.fold_in(krng.key(0), s)).numpy())
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert np.isfinite(got).all() and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 1e-3, (got.mean(), ref.mean())
    bad = (np.abs(got - ref) > 1e-3 * np.abs(ref) + 1e-4).any(1)
    assert bad.mean() <= 0.02, bad.mean()


def test_main_writes_kytpus_format(tmp_path, capsys):
    img = nanopt.main(2, 8, 6, device="cpu", out=str(tmp_path / "n.ppm"))
    assert img.shape == (6, 8, 3)
    words = (tmp_path / "n.ppm").read_text().split()
    assert words[:4] == ["P3", "8", "6", "255"] and len(words) == 4 + 8 * 6 * 3
    g = (np.clip(img, 0, 1) ** (1 / 2.2) * 255 + 0.5).astype(np.uint8)
    assert [int(x) for x in words[4:]] == g.reshape(-1).tolist()
    assert "wrote" in capsys.readouterr().out


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nanopt.main(1, 4, 4, out=str(tmp_path / "n.ppm"))
