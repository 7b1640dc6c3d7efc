"""kytpu_torch.tools (the parity gate against the compiled reference and its
image comparison) against the JAX package's tools/, on the CPU.

- `compare_reference.load`, the port's numpy BMP reader, against kytpu's
  PIL reader on files that both packages' write_bmp wrote (odd widths pad
  the rows) and on a top-down file: exact. It refuses other formats.
- `down` and `main`: kytpu's values exactly.
- `parity_ci.main_with_args` with the reference's build and render and the
  port's renders replaced by known BMPs: 0 under the limit, 1 over it.
- `render_image` is `render(..., engine="jnp")` of the reference's
  production scene bit for bit (not the port's default engine, K1), and
  that scene's tables are kytpu's builder's bit for bit.
- The gate itself (`-m parity`, as tests/test_parity.py runs kytpu's) needs
  the reference's sources; it is not in the tier.
"""

import importlib.util
import os
import struct

import jax
import numpy as np
import pytest
import torch

import kytpu.film.io as jio
from kytpu.scene import builders as jb
from kytpu_torch.film import io as tio
from kytpu_torch.integrator.path import PathConfig
from kytpu_torch.integrator.render import render
from kytpu_torch.tools import compare_reference as cref
from kytpu_torch.tools import parity_ci
from tests.test_torch_scene import assert_same_tables
import tests.torch_threads  # noqa: F401  (one torch thread a process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def kcompare():
    spec = importlib.util.spec_from_file_location(
        "kytpu_compare_reference",
        os.path.join(REPO, "tools", "compare_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(-0.2, 1.4, (h, w, 3)).astype(
        np.float32)


def _top_down(src: str, dst: str) -> None:
    """The BMP `src` rewritten with its rows top-down (negative height)."""
    data = bytearray(open(src, "rb").read())
    w, h = struct.unpack_from("<ii", data, 18)
    stride = (w * 3 + 3) & ~3
    rows = [data[54 + y * stride:54 + (y + 1) * stride] for y in range(h)]
    struct.pack_into("<i", data, 22, -h)
    data[54:] = b"".join(rows[::-1])
    open(dst, "wb").write(bytes(data))


@pytest.mark.parametrize("shape", [(5, 7), (9, 16), (1, 1), (12, 30)])
def test_load_matches_kytpus_pil_reader(tmp_path, kcompare, shape):
    img = _image(*shape, shape[0] * 31 + shape[1])
    for k, write in enumerate((jio.write_bmp, tio.write_bmp)):
        path = str(tmp_path / f"{k}.bmp")
        write(path, img)
        ref = kcompare.load(path)
        got = cref.load(path)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
        _top_down(path, str(tmp_path / "td.bmp"))
        np.testing.assert_array_equal(cref.load(str(tmp_path / "td.bmp")),
                                      ref)


@pytest.mark.parametrize("what, at, fmt, value", [
    ("32 bits a pixel", 28, "<H", 32), ("RLE compression", 30, "<I", 1),
    ("no BM magic", 0, "<H", 0x5858)])
def test_load_refuses_other_formats(tmp_path, what, at, fmt, value):
    path = str(tmp_path / "a.bmp")
    tio.write_bmp(path, _image(4, 4, 1))
    data = bytearray(open(path, "rb").read())
    struct.pack_into(fmt, data, at, value)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        cref.load(path)


def test_down_and_main_match_kytpu(tmp_path, kcompare, capsys):
    a, b = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    tio.write_bmp(a, _image(37, 45, 2))
    tio.write_bmp(b, _image(37, 45, 3))
    img = cref.load(a)
    for f in (1, 4, 8):
        np.testing.assert_array_equal(cref.down(img, f),
                                      kcompare.down(img, f))
        assert cref.main(a, b, f) == kcompare.main(a, b, f)
    out = capsys.readouterr().out.splitlines()
    assert out[0::2] == out[1::2]


@pytest.mark.parametrize("offset, rc", [(0.0, 0), (0.2, 1)])
def test_main_with_args_passes_under_the_limit(monkeypatch, tmp_path,
                                               capsys, offset, rc):
    """The reference's frame is the port's plus `offset`: within 1.5x the
    two seeds' noise floor passes, 0.2 past it fails."""
    base = np.full((32, 32, 3), 0.4, np.float32)
    noise = {1234: 0.0, 977: 0.02}
    ref = str(tmp_path / "single.bmp")

    def render_reference(spp):
        tio.write_bmp(ref, base + offset)
        return ref

    def render_kytpu(spp, seed, path, **kw):
        tio.write_bmp(path, base + noise[seed])
        return path

    monkeypatch.setattr(parity_ci, "build_reference", lambda: None)
    monkeypatch.setattr(parity_ci, "render_reference", render_reference)
    monkeypatch.setattr(parity_ci, "render_kytpu", render_kytpu)
    assert parity_ci.main_with_args(spp=4, tolerance=1.5, down=8) == rc
    assert ("PASS" if rc == 0 else "FAIL") in capsys.readouterr().out


def test_render_image_is_the_jnp_engine(tmp_path):
    cfg = PathConfig(max_depth=5, variant="iteration", strategy="both_mis")
    scene = parity_ci.parity_scene(16, 16)
    img = parity_ci.render_image(1, 1234, 16, 16, device="cpu")
    assert torch.equal(img, render(scene, spp=1, seed=1234, cfg=cfg,
                                   engine="jnp", device="cpu"))
    # the port's default engine (K1) traces another estimator
    assert not torch.equal(img, render(scene, spp=1, seed=1234, cfg=cfg,
                                       device="cpu"))
    path = parity_ci.render_kytpu(1, 1234, str(tmp_path / "a.bmp"), 16, 16,
                                  device="cpu")
    tio.write_bmp(str(tmp_path / "b.bmp"), img.numpy())
    assert open(path, "rb").read() == open(tmp_path / "b.bmp", "rb").read()


def test_parity_scene_is_kytpus():
    flags = jb.BOTH_SMALL_SPHERES | {jb.LIGHT_ENVIRONMENT}
    assert_same_tables(jax.device_get(jb.cornell_box(flags, width=16,
                                                     height=16)),
                       parity_ci.parity_scene(16, 16))


def test_the_gate_builds_the_repos_reference_script():
    assert parity_ci.BUILD_SCRIPT == os.path.join(
        REPO, "tools", "reference_build", "build_reference.sh")
    assert parity_ci.reference_source().endswith("ky.cpp")


@pytest.mark.parity
def test_compiled_reference_parity():
    if not os.path.exists(parity_ci.reference_source()):
        pytest.skip("reference sources not available")
    rc = parity_ci.main_with_args(
        spp=16, tolerance=1.75,
        device="cuda" if torch.cuda.is_available() else "cpu")
    assert rc == 0, "cross-renderer diff exceeded tolerance x noise floor"
