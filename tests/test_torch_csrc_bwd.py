"""The CUDA lane body of K3 (csrc/wavefront_bwd_res.cu `bwd_lane`) compiled
with g++ and run on the CPU against the plain version `bwd_res_plain`, and
the column sums of K3 and K4 (`sum_columns`, csrc/lane_sum.cuh) against a
float64 sum and a scalar transcription of the kernels' loops.

The source compiles on the host with tests/csrc_stub/cuda_runtime.h in
place of the CUDA runtime header, as in tests/test_torch_csrc_lane.py. The
harness runs `bwd_lane` on each lane of a plain K2 run (its radiance and
coefficient cache), each lane with a row of its own (the local route's
view, with the scene's column map `acc_map`), and writes the rows, the
texel entries and the row-tagged planes; the test sums them as the kernel
does (`sum_columns` over the kept columns, and the plain sums by texel and
by row).

Tolerance: chip_smoke.py's gradient bound, each table within rtol=1e-4
plus 1e-6 of its largest entry; and bit for bit, since the host rounds as
the card does with -ffp-contract=off, K3 has no transcendental, and
`sum_columns` adds in the kernel's order.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import shading as ksh
from kytpu_torch.kernels import tables as ktab
from kytpu_torch.kernels import tag_sums as kts
from kytpu_torch.kernels import wavefront as kwf
from tests.test_torch_csrc_lane import _lanes, _scene
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CSRC = Path(kwf.__file__).resolve().parent / "csrc"
STUB = Path(__file__).resolve().parent / "csrc_stub"

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6

HARNESS = r"""
#include "wavefront_bwd_res.cu"

#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

std::string dir;

template <class T>
std::vector<T> load(const char* name) {
  FILE* f = fopen((dir + "/" + name).c_str(), "rb");
  if (!f) { fprintf(stderr, "no %s\n", name); exit(2); }
  fseek(f, 0, SEEK_END);
  const long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<T> v(bytes / sizeof(T) + 1);
  if (fread(v.data(), 1, bytes, f) != (size_t)bytes) exit(2);
  fclose(f);
  return v;
}

template <class T>
void save(const char* name, const std::vector<T>& v) {
  FILE* f = fopen((dir + "/" + name).c_str(), "wb");
  fwrite(v.data(), sizeof(T), v.size(), f);
  fclose(f);
}

// each lane with a row of its own, through the local route's view
template <bool TEX, bool ROWTAG>
void run(const BwdArgs& a, float* rows) {
  for (int lane = 0; lane < a.n; ++lane)
    bwd_lane<TEX, ROWTAG>(a, lane, RowAcc{rows + (size_t)lane * a.K, a.cmap});
}

}  // namespace

// bwd DIR TEXTURED ROWTAG N K MAX_DEPTH TEX_PLANES ROW_PLANES
int main(int argc, char** argv) {
  if (argc != 9) return 2;
  dir = argv[1];
  const int textured = atoi(argv[2]), rowtag = atoi(argv[3]), n = atoi(argv[4]),
            K = atoi(argv[5]), max_depth = atoi(argv[6]), tex_planes = atoi(argv[7]),
            row_planes = atoi(argv[8]);
  const auto I = load<int>("i"), resi = load<int>("resi"), cmap = load<int>("cmap");
  const auto diffuse = load<float>("diffuse"), specular = load<float>("specular"),
             emission = load<float>("emission"), light_emit = load<float>("light_emit"),
             env = load<float>("env"), texa = load<float>("texa"), texb = load<float>("texb"),
             timg = load<float>("timg"), g = load<float>("g"), l = load<float>("l"),
             resf = load<float>("resf");
  std::vector<float> rows((size_t)n * K, 0.f), tex_dout((size_t)3 * tex_planes * n, -1.f),
      row_dout((size_t)row_planes * n, -1.f);
  std::vector<int> tex_tags((size_t)tex_planes * n, -1), row_tags((size_t)(max_depth + 1) * n, -1);
  const BwdArgs a{I.data(), diffuse.data(), specular.data(), emission.data(), light_emit.data(),
                  env.data(), g.data(), l.data(), resf.data(), resi.data(), n, K, max_depth,
                  cmap.data(), Tex{texa.data(), texb.data(), timg.data(), tex_dout.data(), tex_tags.data()},
                  Rows{row_dout.data(), row_tags.data()}};
  if (textured && rowtag) run<true, true>(a, rows.data());
  else if (rowtag) run<false, true>(a, rows.data());
  else if (textured) run<true, false>(a, rows.data());
  else run<false, false>(a, rows.data());
  save("rows", rows);
  save("tex_dout", tex_dout);
  save("tex_tags", tex_tags);
  save("row_dout", row_dout);
  save("row_tags", row_tags);
  return 0;
}
"""


def build_harness(tmp_path_factory, name: str, harness: str) -> Path:
    """`harness` compiled with g++ against the CUDA sources and the stub
    header (the <<<...>>> launch configurations stripped, the dynamic
    shared-memory array a static one); skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA lane body on the host")
    build = tmp_path_factory.mktemp(name)
    for src in CSRC.glob("*.cu*"):
        text = re.sub(r"<<<[^>]*>>>", "", src.read_text())
        text = text.replace("extern __shared__ float4 smem4[];",
                            "static float4 smem4[1 << 14];")
        (build / src.name).write_text(text)
    (build / "harness.cpp").write_text(harness)
    exe = build / name
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-I", str(STUB),
         "-I", str(build), "-o", str(exe), str(build / "harness.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


def write_tables(tables, cfg, path: Path) -> None:
    """The scene's tables and K3's and K4's column map, as the kernels
    read them."""
    for nm in kwf._TABLES:
        getattr(tables, nm).numpy().tofile(path / nm)
    kwf.acc_map(tables, cfg).numpy().tofile(path / "cmap")


def outputs(tables, cfg, n: int):
    """The per-bounce planes K3 and K4 write: (texel planes, row-tagged
    planes), 0 where the scene has none."""
    tex = 4 * cfg.max_depth if ktab.has_img(tables.static) else 0
    rows = (kwf.per_bounce(cfg) * cfg.max_depth + 3
            if kwf.row_tagged(tables.static) else 0)
    return tex, rows


def grads_of(tables, cfg, rows, path: Path, n: int):
    """A harness's rows (one a lane or slot, `_row_cols` each) and planes
    -> the gradient tables, summed as the kernels sum them on the card: the
    rows by column (`sum_columns`, then each column of the vector from its
    row column), the row-tagged and texel planes by tag."""
    static = tables.static
    # the second pass: entry c of the vector is row column cmap[c]'s sum, 0
    # for the dense route's last column, which no lane adds to
    sums = kwf.sum_columns(torch.from_numpy(rows))
    cmap = kwf.acc_map(tables, cfg).long()
    kept = len(sums) - (not kwf.row_tagged(static))
    vec = torch.where(cmap < kept, sums[cmap], torch.zeros(()))
    tex_planes, row_planes = outputs(tables, cfg, n)
    if row_planes:
        dout = torch.from_numpy(np.fromfile(path / "row_dout", np.float32)
                                .reshape(row_planes, n))
        tags = torch.from_numpy(np.fromfile(path / "row_tags", np.int32)
                                .reshape(-1, n))
        grads = kwf.tagged_grads(static, cfg, kwf.row_sums_plain(
            dout, tags, len(static["mats"]["kind"]), cfg), vec)
    else:
        grads = kwf.split_grads(vec, len(static["mats"]["kind"]),
                                cfg.trainable_exponent, ktab.n_tex(static))
    if not tex_planes:
        return grads
    dout = torch.from_numpy(np.fromfile(path / "tex_dout", np.float32)
                            .reshape(3 * tex_planes, n))
    tags = np.fromfile(path / "tex_tags", np.int32).reshape(tex_planes, n)
    perm, starts = kts.sort_tags(torch.from_numpy(tags), static["n_texels"])
    seg = kts.segment_sums_plain(dout, perm, starts, n, tex_planes, 3)
    return grads + (seg.reshape(ksh.texel_shape(static)),)


def check_grads(got, ref, what: str, rtol=GRAD_RTOL, atol=GRAD_ATOL) -> None:
    """Each table within rtol plus atol of its largest entry."""
    assert len(got) == len(ref), what
    for k, (a, b) in enumerate(zip(got, ref)):
        tol = rtol * b.abs() + atol * max(1.0, float(b.abs().max()))
        assert torch.isfinite(a).all(), (what, k)
        assert ((a - b).abs() <= tol).all(), (what, k, float(
            (a - b).abs().max()))


@pytest.fixture(scope="module")
def bwd_exe(tmp_path_factory):
    return build_harness(tmp_path_factory, "csrc_bwd", HARNESS)


# scene, sampler, nee, trainable exponent, row-tagged route forced
# (DENSE_MAX_ROWS 0): both samplers with a cache, both NEE modes, the
# exponent adjoint, a checker floor and an image wall, the row-tagged route,
# 33 lights (the nee="single" pick in its own int plane; 102 lane columns)
CASES = [
    ("veach", "hash", "all", False, False),
    ("veach", "sobol", "all", True, False),
    ("cornell", "hash", "single", False, False),
    ("cornell_lights", "sobol", "all", False, False),
    ("textured", "hash", "all", False, False),
    ("textured", "sobol", "single", True, False),
    ("veach", "hash", "all", True, True),
    ("textured", "hash", "all", False, True),
    ("many_lights33", "sobol", "single", False, False),
    ("many_lights33", "hash", "all", False, True),
]


@pytest.mark.parametrize("scene, sampler, nee, texp, rowtag", CASES)
def test_bwd_lane_matches_plain(bwd_exe, tmp_path, monkeypatch, scene,
                                sampler, nee, texp, rowtag):
    if rowtag:
        monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 0)
    sc = _scene(scene)
    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, sampler=sampler,
                           nee=nee, trainable_exponent=texp)
    n, seed = 2000, 7
    o, d, si, pix = _lanes(sc, n)
    tables = kwf.pack_tables(sc, cfg)
    assert kwf.row_tagged(tables.static) == rowtag
    big_l, resf, resi = kwf.trace_lanes_plain(tables, cfg, o, d, seed, si,
                                              pix, residual=True)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n, 3)).astype(np.float32))
    write_tables(tables, cfg, tmp_path)
    for nm, t in (("g", g), ("l", big_l), ("resf", resf), ("resi", resi)):
        t.contiguous().numpy().tofile(tmp_path / nm)
    k = kwf._row_cols(tables, cfg)
    tex_planes, row_planes = outputs(tables, cfg, n)
    res = subprocess.run(
        [str(bwd_exe), str(tmp_path),
         str(int(bool(tables.static["textures"]))), str(int(rowtag)), str(n),
         str(k), str(cfg.max_depth), str(tex_planes), str(row_planes)],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    rows = np.fromfile(tmp_path / "rows", np.float32).reshape(n, k)
    got = grads_of(tables, cfg, rows, tmp_path, n)
    ref = kwf.bwd_res_plain(tables, cfg, g, big_l, resf, resi)
    check_grads(got, ref, scene)
    # the same additions in the same order: the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    # the adjoints are live
    assert bool((got[0] != 0).any()) and bool((got[3] != 0).any()) == (
        scene == "cornell_lights")


def _kernel_order(acc: np.ndarray) -> np.ndarray:
    """csrc/lane_sum.cuh's loops, one float32 addition at a time: the
    block's column c as four chains of 32 threads, each from thread c % 32
    of its warp on, wrapping round, then (q0 + q1) + (q2 + q3); the second
    pass's thread t over blocks t, t + 256, ..., then its tree."""
    n, k = acc.shape
    nb = -(-n // 128)
    x = np.zeros((nb * 128, k), np.float32)
    x[:n] = acc
    part = np.zeros((nb, k), np.float32)
    for b in range(nb):
        for c in range(k):
            r = c % 32
            q = []
            for w in range(4):
                base = 128 * b + 32 * w
                s = x[base + r, c]
                for i in range(1, 32):
                    s = np.float32(s + x[base + (r + i) % 32, c])
                q.append(s)
            part[b, c] = np.float32(np.float32(q[0] + q[1])
                                    + np.float32(q[2] + q[3]))
    out = np.zeros(k, np.float32)
    for c in range(k):
        t = np.zeros(256, np.float32)
        for th in range(256):
            for b in range(th, nb, 256):
                t[th] = np.float32(t[th] + part[b, c])
        off = 128
        while off:
            t[:off] = t[:off] + t[off:2 * off]
            off //= 2
        out[c] = t[0]
    return out


def test_sum_columns_is_the_kernels_order():
    rng = np.random.default_rng(3)
    acc = (rng.normal(size=(300, 131)) * 10.0 ** rng.integers(
        -3, 4, size=(300, 131))).astype(np.float32)
    got = kwf.sum_columns(torch.from_numpy(acc)).numpy()
    assert np.array_equal(got, _kernel_order(acc))


@pytest.mark.parametrize("n, k", [(1, 5), (1000, 102), (70000, 3)])
def test_sum_columns_is_a_sum(n, k):
    rng = np.random.default_rng(n)
    acc = rng.normal(size=(n, k)).astype(np.float32)
    got = kwf.sum_columns(torch.from_numpy(acc)).numpy().astype(np.float64)
    ref = acc.astype(np.float64).sum(0)
    # each output is well within 140 float32 additions deep: |err| <= 140 u
    # sum |x|, u = 2^-24
    scale = np.abs(acc).astype(np.float64).sum(0)
    assert np.all(np.abs(got - ref) <= 140 * 2.0 ** -24 * scale)
