"""The culled lane body of K1, K2 and K4 past REFILL_MAX_ROWS surfaces
(csrc/wavefront_fwd.cu step 5: `closest_culled`, `shadow_sweep_culled`,
`any_hit_culled`, under CULL) compiled with g++ and run on the CPU: culled
against the same build with the cull off, and against the plain versions
`trace_lanes_plain` and `bwd_replay_plain`, which sweep every row in the
scene's order.

The sources compile on the host as in tests/test_torch_csrc_lane.py
(tests/csrc_stub/cuda_runtime.h, -ffp-contract=off). The kernel takes no
refill past REFILL_MAX_ROWS surfaces, a lane a thread, and so does the
harness, in two ways: each 32 lanes a warp of 32 host threads through the
kernel's `trace_chunk`, whose votes are barriers of the threads in their
mask (the stub's KYTPU_WARP_EMU: lanes that end early, sweeps that only
some lanes enter and lanes that leave a sweep together are the card's),
and each lane alone, a warp of one (each lane skips every block its own
rays cannot meet, the strictest cull the kernel can run); under K4 each
lane adds to a row of its own (the row-tagged route's local row). The
tables come from `kwf.pack_tables` with the visit order and bounds of
`kwf.cull_tables`.

Tolerances:
- culled against the cull off, and warps of 32 against warps of one:
  every output equal bit for bit (one build, one host libm: a skipped
  block that held a row the lane would take, a tie broken the other way,
  or a vote that loses a lane's state, changes that lane);
- against the plain versions, the bounds of tests/test_torch_csrc_lane.py
  (K1, K2: at most 0.5% of lanes outside rtol=1e-3, atol=1e-4, the means
  within 3 standard errors, each cache plane and the int planes at most
  0.5% of lanes off) and tests/test_torch_csrc_replay.py (K4: each lane's
  row and row-tagged planes, at most 0.5% of lanes outside rtol=1e-3,
  atol=1e-4): the host's cosf, powf and logf are not torch's.
- the tie (`trapezoids(tie=True)`): two coplanar rows meet a ray at the
  same t and the visit order takes the higher sid first; every lane whose
  plain hit is the lower row has it in the culled K2's cache too (and
  with the cull off: the least (t, sid) wins, not the first row visited).
"""

import subprocess

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.kernels.v3 import V3
from kytpu_torch.scene import builders
from tests.test_torch_csrc_bwd import build_harness, outputs
from tests.test_torch_csrc_lane import _agree, _lanes
from tests.test_torch_cull_bounds import _one_row, ground_atlas, trapezoids
import tests.torch_threads  # noqa: F401  (one torch thread a process)

HARNESS = r"""
#define KYTPU_WARP_EMU
#include "wavefront_fwd.cu"

#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
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
  std::vector<T> v(bytes / sizeof(T) + 4);
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

// The culled sweeps (CULL) on every lane, a lane a thread as the kernel
// runs them past REFILL_MAX_ROWS surfaces (no refill); K4 adds lane i's
// adjoints to row i of `rows`. warp = 0: each lane alone, a warp of one
// (the stub's votes of one thread); warp = 1: each 32 lanes a warp of 32
// host threads through trace_chunk, voting as the card's warps vote.
template <int MODE, bool SOBOL, bool TEX>
void run(const Args& a, float* rows, bool warp) {
  constexpr bool ROWTAG = MODE == MODE_REPLAY;
  static float rays[(ShadowRays::FIELDS + ShadowRays::CULL_FIELDS) * NEE_CHUNK * RAY_STRIDE];
  const KScene<false> S = stage_scene<false, TEX, true>(a, nullptr);
  const ResPlanes rp = res_planes(S.env_i >= 0, S.single, S.L, S.texp, TEX && S.has_img);
  if (!warp) {
    WarpVotes one;
    warp_emu = &one;
    const ShadowRays R{rays, a.nee_rays};  // thread 0's column
    for (int id = 0; id < a.n; ++id) {
      Lane L = {};
      lane_start<MODE, SOBOL>(a, id, L);
      const RowAcc acc{rows + (size_t)id * a.n_cols, a.cmap};
      while (!lane_bounce<MODE, SOBOL, TEX, ROWTAG, false, true>(a, S, rp, R, L, acc, 1u)) {
      }
      lane_finish<MODE, TEX, ROWTAG, false>(a, S, rp, L);
    }
    return;
  }
  for (int w = 0; 32 * w < a.n; ++w) {
    WarpVotes votes;
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = w;
        warp_emu = &votes;
        const RowAcc acc{rows + (size_t)(32 * w + t) * a.n_cols, a.cmap};
        trace_chunk<MODE, SOBOL, TEX, ROWTAG, false, true>(a, S, rp,
                                                           ShadowRays{rays + t, a.nee_rays}, acc);
      });
    for (auto& th : lanes) th.join();
  }
}

template <int MODE, bool SOBOL>
void run_tex(const Args& a, float* rows, bool tex, bool warp) {
  if (tex) run<MODE, SOBOL, true>(a, rows, warp);
  else run<MODE, SOBOL, false>(a, rows, warp);
}

template <int MODE>
void run_sobol(const Args& a, float* rows, bool sobol, bool tex, bool warp) {
  if (sobol) run_tex<MODE, true>(a, rows, tex, warp);
  else run_tex<MODE, false>(a, rows, tex, warp);
}

}  // namespace

// cull DIR MODE TEXTURED N SEED MAX_DEPTH RR_START ROWS SAMPLER ROBUST RES_N
//      NEE_RAYS CULL K TEX_PLANES ROW_PLANES WARP
int main(int argc, char** argv) {
  if (argc != 18) return 2;
  dir = argv[1];
  const int mode = atoi(argv[2]), textured = atoi(argv[3]);
  Args a{};
  a.n = atoi(argv[4]);
  a.seed = atoi(argv[5]);
  a.max_depth = atoi(argv[6]);
  a.rr_start = atoi(argv[7]);
  a.rows = atoi(argv[8]);
  a.sampler = atoi(argv[9]);
  a.robust = atoi(argv[10]);
  const int res_n = atoi(argv[11]);
  a.nee_rays = atoi(argv[12]);
  a.cull = atoi(argv[13]);
  a.n_cols = atoi(argv[14]);
  const int tex_planes = atoi(argv[15]), row_planes = atoi(argv[16]), warp = atoi(argv[17]);
  a.chunk = 32;
  const auto F = load<float>("f"), diffuse = load<float>("diffuse"),
             specular = load<float>("specular"), emission = load<float>("emission"),
             exponent = load<float>("exponent"), light_emit = load<float>("light_emit"),
             env = load<float>("env"), texa = load<float>("texa"), texb = load<float>("texb"),
             timg = load<float>("timg"), o = load<float>("o"), d = load<float>("d"),
             g = load<float>("g"), l = load<float>("l"), bnd = load<float>("bnd");
  const auto I = load<int>("i"), si = load<int>("si"), pix = load<int>("pix"),
             cmap = load<int>("cmap"), vis = load<int>("vis");
  a.F = F.data(); a.I = I.data(); a.diffuse = diffuse.data(); a.specular = specular.data();
  a.emission = emission.data(); a.exponent = exponent.data(); a.light_emit = light_emit.data();
  a.env = env.data(); a.texa = texa.data(); a.texb = texb.data(); a.timg = timg.data();
  a.o = o.data(); a.d = d.data(); a.si = si.data(); a.pix = pix.data();
  a.g = g.data(); a.l_in = l.data(); a.cmap = cmap.data();
  a.vis = vis.data();
  a.bnd = (const float4*)bnd.data();
  std::vector<float> out(3 * (size_t)a.n, -1.f), resf((size_t)res_n * a.n, -1.f),
      rows(((size_t)a.n + 31) / 32 * 32 * (a.n_cols > 0 ? a.n_cols : 1), 0.f),
      tex_dout((size_t)3 * tex_planes * a.n, -1.f), row_dout((size_t)row_planes * a.n, -1.f);
  std::vector<int> resi((size_t)(2 * a.max_depth + 1) * a.n, -1),
      tex_tags((size_t)tex_planes * a.n, -1), row_tags((size_t)(a.max_depth + 1) * a.n, -1);
  a.out = out.data();
  a.resf = resf.data();
  a.resi = resi.data();
  a.tex_dout = tex_dout.data();
  a.tex_tags = tex_tags.data();
  a.row_dout = row_dout.data();
  a.row_tags = row_tags.data();
  const bool sobol = a.sampler == S_SOBOL;
  if (sobol) upload_sites();
  if (mode == 0) run_sobol<MODE_FWD>(a, rows.data(), sobol, textured, warp);
  else if (mode == 1) run_sobol<MODE_RESIDUAL>(a, rows.data(), sobol, textured, warp);
  else run_sobol<MODE_REPLAY>(a, rows.data(), sobol, textured, warp);
  save("out", out);
  save("resf", resf);
  save("resi", resi);
  save("rows", rows);
  save("tex_dout", tex_dout);
  save("tex_tags", tex_tags);
  save("row_dout", row_dout);
  save("row_tags", row_tags);
  return 0;
}
"""

OUTPUTS = ("out", "resf", "resi", "rows", "tex_dout", "tex_tags", "row_dout",
           "row_tags")


@pytest.fixture(scope="module")
def cull_exe(tmp_path_factory):
    return build_harness(tmp_path_factory, "csrc_cull", HARNESS)


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = {
            "spheres80": lambda: ground_atlas(builders.random_spheres(
                n=80, width=16, height=16, seed=1)),
            "trapezoids": lambda: trapezoids(70),
            "tie": lambda: trapezoids(70, tie=True)}[name]()
    return _SCENES[name]


class Run:
    """One scene's tables and lanes written for the harness, and its runs."""

    def __init__(self, exe, path, scene, mode, cfg, n, seed=13):
        self.exe, self.path, self.mode, self.cfg = exe, path, mode, cfg
        self.n, self.seed = n, seed
        sc = _scene(scene)
        self.o, self.d, self.si, self.pix = _lanes(sc, n)
        self.tables = kwf.pack_tables(sc, cfg)
        assert self.tables.vis is not None and self.tables.stage_bytes == 0
        self.big_l = kwf.trace_lanes_plain(self.tables, cfg, self.o, self.d,
                                           seed, self.si, self.pix)
        self.g = torch.from_numpy(np.random.default_rng(5).normal(
            size=(n, 3)).astype(np.float32))
        for nm in kwf._TABLES + ("vis", "bnd"):
            getattr(self.tables, nm).numpy().tofile(path / nm)
        kwf.acc_map(self.tables, cfg).numpy().tofile(path / "cmap")
        for nm, t in (("o", self.o), ("d", self.d), ("si", self.si),
                      ("pix", self.pix), ("g", self.g), ("l", self.big_l)):
            t.contiguous().numpy().tofile(path / nm)
        self.res_n = kwf.residual_layout(self.tables.static, cfg)[1]
        self.k = kwf._row_cols(self.tables, cfg) if mode == 2 else 0
        self.planes = outputs(self.tables, cfg, n) if mode == 2 else (0, 0)

    def __call__(self, cull: bool, warp: bool = False) -> dict:
        cfg, st = self.cfg, self.tables.static
        res = subprocess.run(
            [str(self.exe), str(self.path), str(self.mode),
             str(int(bool(st["textures"]))), str(self.n), str(self.seed),
             str(cfg.max_depth), str(cfg.rr_start), str(cfg.rows),
             str(kwf.SAMPLERS[cfg.sampler]), str(int(cfg.shadow == "robust")),
             str(self.res_n), str(kwf._scene_args(self.tables, cfg)[2]),
             str(int(cull)), str(self.k), *map(str, self.planes),
             str(int(warp))],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        return {nm: np.fromfile(self.path / nm, np.int32 if "tag" in nm or
                                nm == "resi" else np.float32)
                for nm in OUTPUTS}


# scene, kernel (0 K1, 1 K2, 2 K4), sampler, nee, shadow, trainable
# exponent: random_spheres(80) with a 16x16 ground atlas (82 surfaces, an
# image texture) and `trapezoids(70)` (rects that are not parallelograms,
# triangles, disks), every kernel, the hash and sobol samplers, both NEE
# and shadow modes, the exponent adjoint
CASES = [
    ("spheres80", 0, "hash", "all", "parity", False),
    ("spheres80", 1, "sobol", "all", "robust", True),
    ("spheres80", 2, "hash", "all", "parity", True),
    ("spheres80", 0, "sobol", "single", "robust", False),
    ("trapezoids", 0, "hash", "all", "robust", False),
    ("trapezoids", 1, "hash", "single", "parity", False),
    ("trapezoids", 2, "sobol", "single", "robust", False),
    ("trapezoids", 2, "hash", "all", "parity", False),
]


@pytest.mark.parametrize("scene, mode, sampler, nee, shadow, texp", CASES)
def test_culled_lane_body(cull_exe, tmp_path, monkeypatch, scene, mode,
                          sampler, nee, shadow, texp):
    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, sampler=sampler,
                           nee=nee, shadow=shadow, trainable_exponent=texp)
    run = Run(cull_exe, tmp_path, scene, mode, cfg, 640)
    got = run(True, warp=True)
    for cull, warp in ((False, True), (True, False), (False, False)):
        other = run(cull, warp)
        for nm in OUTPUTS:
            np.testing.assert_array_equal(got[nm], other[nm],
                                          err_msg=(nm, cull, warp))
    n, tables = run.n, run.tables
    args = (tables, cfg, run.o, run.d, run.seed, run.si, run.pix)
    if mode < 2:
        ref = kwf.trace_lanes_plain(*args, residual=mode == 1)
        out = got["out"].reshape(n, 3)
        if mode == 0:
            _agree(out, ref.numpy(), "radiance")
            return
        ref_l, ref_f, ref_i = (t.numpy() for t in ref)
        _agree(out, ref_l, "radiance")
        resf = got["resf"].reshape(run.res_n, n)
        resi = got["resi"].reshape(-1, n)[:kwf.int_planes(tables.static,
                                                           cfg)]
        bad = ~np.isclose(resf, ref_f, rtol=1e-3, atol=1e-4)
        assert bad.mean(1).max() <= 0.005, bad.mean(1)
        assert (resi != ref_i).any(0).mean() <= 0.005
        return
    # K4: the plain version's rows, one a lane, and its row-tagged planes
    seen, tagged = [], []
    sum_columns, row_sums = kwf.sum_columns, kwf.row_sums_plain
    monkeypatch.setattr(kwf, "sum_columns",
                        lambda acc: seen.append(acc) or sum_columns(acc))
    monkeypatch.setattr(kwf, "row_sums_plain", lambda dout, tags, *a: (
        tagged.append((dout, tags)) or row_sums(dout, tags, *a)))
    kwf.bwd_replay_plain(*args, run.g, run.big_l)
    rows = got["rows"].reshape(-1, run.k)[:n]
    bad = ~np.isclose(rows, seen[0].numpy(), rtol=1e-3, atol=1e-4)
    assert bad.any(1).mean() <= 0.005, bad.any(1).mean()
    dout, tags = (t.numpy() for t in tagged[0])
    bad = ~np.isclose(got["row_dout"].reshape(dout.shape), dout, rtol=1e-3,
                      atol=1e-4)
    bad = bad.any(0) | (got["row_tags"].reshape(tags.shape) != tags).any(0)
    assert bad.mean() <= 0.005, bad.mean()
    assert (rows != 0).any() and (tags > 0).any()


def test_cull_skips_blocks(cull_exe, tmp_path):
    """The comparison can fail: with each bound's radius halved, the culled
    K1 loses rows that the cull off takes."""
    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, sampler="hash")
    run = Run(cull_exe, tmp_path, "spheres80", 0, cfg, 640)
    bnd = run.tables.bnd.clone()
    bnd[:, 3] *= 0.5
    bnd.numpy().tofile(tmp_path / "bnd")
    assert not np.array_equal(run(True, warp=True)["out"],
                              run(False, warp=True)["out"])


def test_tie_keeps_the_lower_row(cull_exe, tmp_path):
    """Rows 0 and 1 are coplanar and overlap; the visit order takes row 1
    first. Where a ray meets both at the same t, the culled K2 (cull on and
    off) keeps row 0, as the plain sweep in scene order does."""
    cfg = kwf.KernelConfig(max_depth=2, rr_start=1, rows=2, sampler="hash")
    run = Run(cull_exe, tmp_path, "tie", 1, cfg, 1024)
    static = run.tables.static
    order = list(run.tables.vis[:len(static["planar"])])
    assert order.index(1) < order.index(0)
    o, d = (V3(t[:, 0], t[:, 1], t[:, 2]) for t in (run.o, run.d))
    t0, _, v0, _ = kwf._closest_hit(_one_row(static, "planar", 0), o, d)
    t1, _, v1, _ = kwf._closest_hit(_one_row(static, "planar", 1), o, d)
    tie = v0 & v1 & (t0 == t1)
    assert int(tie.sum()) > 50
    _, _, ref_i = kwf.trace_lanes_plain(
        run.tables, cfg, run.o, run.d, run.seed, run.si, run.pix, residual=True)
    ref_row = kwf.unpack_row(ref_i[0]) - 1
    assert bool((ref_row[tie] == 0).all())
    for cull in (True, False):
        resi = run(cull, warp=True)["resi"].reshape(-1, run.n)
        row = kwf.unpack_row(torch.from_numpy(resi[0])) - 1
        assert bool((row[tie] == 0).all()), cull
        assert bool((row[ref_row == 0] == 0).all()), cull
