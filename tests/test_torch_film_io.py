"""kytpu_torch's image writers, film grids and native encoder
(kytpu_torch/film, kytpu_torch/native) against kytpu's: the same bytes for
the same float32 image, whether it comes as a numpy array or a tensor.

Tolerance: none. Every file is compared byte for byte, read_hdr's output
bit for bit.
"""

import shutil

import numpy as np
import pytest
import torch

import kytpu.film.io as jio
from kytpu.film.film import FilmGrid as JFilmGrid
from kytpu_torch.film import film as tfilm
from kytpu_torch.film import io as tio
from kytpu_torch.native import build as tbuild
from kytpu_torch.native import film_io as tnative

# (H, W) of the seeded images: odd widths pad BMP rows, 1x1 the smallest
SHAPES = [(5, 7), (9, 16), (1, 1)]


def _image(h: int, w: int) -> np.ndarray:
    """Seeded float32 radiance with values below 0, in [0, 1], above 1,
    tiny (below RGBE's 1e-32 cut) and exact zeros."""
    rng = np.random.default_rng(h * 100 + w)
    img = rng.uniform(-0.3, 2.5, (h, w, 3)).astype(np.float32)
    flat = img.reshape(-1)
    flat[::5] = 0.0
    flat[1::7] = 1e-35
    flat[2::11] = 40.0
    return img


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ext", ["ppm", "bmp", "hdr"])
def test_writers_match_kytpu(tmp_path, shape, ext):
    img = _image(*shape)
    ref = tmp_path / f"ref.{ext}"
    jio.write_image(str(ref), img)
    for name, arg in (("np", img), ("tensor", torch.from_numpy(img))):
        p = tmp_path / f"{name}.{ext}"
        assert tio.write_image(str(p), arg) == str(p)
        assert p.read_bytes() == ref.read_bytes(), name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_read_hdr_round_trip(tmp_path, shape):
    img = _image(*shape)
    p = str(tmp_path / "x.hdr")
    tio.write_hdr(p, img)
    got, ref = tio.read_hdr(p), jio.read_hdr(p)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))
    # writing what was read gives the same file again
    p2 = str(tmp_path / "y.hdr")
    tio.write_hdr(p2, got)
    assert open(p2, "rb").read() == open(p, "rb").read()


def test_write_image_refuses_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        tio.write_image(str(tmp_path / "x.png"), _image(2, 2))


def test_film_grid_matches_kytpu():
    ref = JFilmGrid(2, 3, 7, 5)
    got = tfilm.FilmGrid(2, 3, 7, 5)
    for i in range(6):
        img = _image(5, 7) * (i + 1)
        ref.place(img)
        got.place(torch.from_numpy(img) if i % 2 else img)
    assert np.array_equal(got.pixels, ref.pixels)
    with pytest.raises(ValueError, match="sub-film"):
        got.place(_image(4, 7))


def test_film_and_gamma():
    img = _image(9, 16)
    assert np.array_equal(tfilm.to_srgb_u8(torch.from_numpy(img)),
                          tfilm.gamma_encode(img))
    f = tfilm.Film.zeros(16, 9, device="cpu").add(torch.from_numpy(img))
    assert (f.width, f.height) == (16, 9)
    assert np.array_equal(f.numpy(), img)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tfilm.Film.zeros(4, 4)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_native_matches_numpy(tmp_path, monkeypatch):
    lib = tbuild.build(verbose=False, out_dir=tmp_path / "_build")
    assert lib.parent == tmp_path / "_build"
    enc = tnative.load(lib)
    assert enc is not None
    assert tnative.load(tmp_path / "none.so") is None
    for h, w in SHAPES:
        img = _image(h, w)
        for ext in ("bmp", "hdr"):
            monkeypatch.setattr(tio, "_native", None)
            a, b = tmp_path / f"np.{ext}", tmp_path / f"cc.{ext}"
            tio.write_image(str(a), img)
            monkeypatch.setattr(tio, "_native", enc)
            if ext == "bmp":
                # write_bmp stays on numpy; the encoder's own BMP
                enc.write_bmp(str(b), img)
            else:
                tio.write_image(str(b), torch.from_numpy(img))
            assert a.read_bytes() == b.read_bytes(), (h, w, ext)
