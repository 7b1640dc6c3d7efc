"""The CUDA lane body of K4, the path-replay backward (csrc/wavefront_fwd.cu
`lane_start`, `lane_bounce`, `lane_finish` under MODE_REPLAY), compiled
with g++ and run on the CPU in the kernel's refill order against the plain
version `bwd_replay_plain`.

The source compiles on the host as in tests/test_torch_csrc_lane.py. The
harness stages the scene's tables as a block does and runs each warp's
chunk of lanes in the kernel's order (`trace_chunk`): 32 slots, a slot that
ends its lane takes the chunk's next lane in slot order, and each slot adds
the adjoints of every lane it traces to its own row through the accumulator
view of the kernel's local route (RowAcc, with the scene's column map
`acc_map`; the shared route's ColAcc makes the same additions at other
addresses). The test sums the slots' rows as
the kernel does (`sum_columns` over blocks of 4 warps) and the texel and
row-tagged planes by tag. Two checks:

- the lanes: in 32-lane chunks (one lane a slot) each lane's row against
  the plain version's row of that lane, with the lane tolerance of
  tests/test_torch_csrc_lane.py (at most 0.5% of lanes outside
  rtol=1e-3/atol=1e-4: the host's cosf, powf and logf are not torch's, and
  Veach's Phong exponent of 5000 turns an ulp of a cosine into 5e-4 of a
  term);
- the refill: the refilled chunks' gradient (each slot 4-8 lanes) against
  the one-lane-a-slot gradient of the same build, within chip_smoke.py's
  gradient bound (rtol=1e-4 plus 1e-6 of the table's largest entry: one
  host arithmetic, only the order of additions differs), and the planes
  bit for bit. A lane's state that leaked into the next lane of its slot
  fails it.

The refilled gradient is not held against `bwd_replay_plain`'s directly:
a lane whose host libm result differs from torch's by 6e-5 lands on table
entries whose lanes cancel, which no bound relative to the entries
covers. On the card, where the two share one libm, chip_smoke.py holds
them to the gradient bound.
"""

import subprocess

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import wavefront as kwf
from tests.test_torch_csrc_bwd import (build_harness, check_grads, grads_of,
                                       outputs, write_tables)
from tests.test_torch_csrc_lane import _lanes, _scene
import tests.torch_threads  # noqa: F401  (one torch thread a process)

HARNESS = r"""
#include "wavefront_fwd.cu"

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

// the lanes in warps of a.chunk lanes, each warp's 32 slots refilled in the
// order of trace_chunk; slot s of warp w adds to row 32 w + s of `rows`
template <bool SOBOL, bool TEX, bool ROWTAG, bool SH>
void run(const Args& a, float* rows) {
  static float smem[1 << 16], rays[ShadowRays::FIELDS * NEE_CHUNK * RAY_STRIDE];
  const KScene<SH> S = stage_scene<SH, TEX>(a, smem);
  const ResPlanes rp = res_planes(S.env_i >= 0, S.single, S.L, S.texp, TEX && S.has_img);
  const ShadowRays R{rays, a.nee_rays};  // thread 0's column
  long long w = 0;
  for (long long base = 0; base < a.n; base += a.chunk, ++w) {
    const long long end = std::min(base + a.chunk, (long long)a.n);
    long long next = base + 32;
    Lane L[32] = {};
    bool active[32], any = false;
    for (int s = 0; s < 32; ++s) {
      active[s] = base + s < end;
      if (active[s]) lane_start<MODE_REPLAY, SOBOL>(a, (int)(base + s), L[s]);
      any = any || active[s];
    }
    while (any) {
      bool done[32];
      for (int s = 0; s < 32; ++s) {
        const RowAcc acc{rows + (size_t)(32 * w + s) * a.n_cols, a.cmap};
        done[s] = active[s] &&
                  lane_bounce<MODE_REPLAY, SOBOL, TEX, ROWTAG, SH>(a, S, rp, R, L[s], acc);
        if (done[s]) lane_finish<MODE_REPLAY, TEX, ROWTAG, SH>(a, S, rp, L[s]);
      }
      int k = 0;
      any = false;
      for (int s = 0; s < 32; ++s) {
        if (done[s]) {
          const long long id = next + k++;
          active[s] = id < end;
          if (active[s]) lane_start<MODE_REPLAY, SOBOL>(a, (int)id, L[s]);
        }
        any = any || active[s];
      }
      next += k;
    }
  }
}

template <bool SOBOL, bool TEX, bool ROWTAG>
void run_route(const Args& a, float* rows, bool sh) {
  if (sh) run<SOBOL, TEX, ROWTAG, true>(a, rows);
  else run<SOBOL, TEX, ROWTAG, false>(a, rows);
}

template <bool SOBOL, bool TEX>
void run_rowtag(const Args& a, float* rows, bool rowtag, bool sh) {
  if (rowtag) run_route<SOBOL, TEX, true>(a, rows, sh);
  else run_route<SOBOL, TEX, false>(a, rows, sh);
}

template <bool SOBOL>
void run_tex(const Args& a, float* rows, bool tex, bool rowtag, bool sh) {
  if (tex) run_rowtag<SOBOL, true>(a, rows, rowtag, sh);
  else run_rowtag<SOBOL, false>(a, rows, rowtag, sh);
}

}  // namespace

// replay DIR TEXTURED ROWTAG SHARED N SEED MAX_DEPTH RR_START ROWS SAMPLER
//        ROBUST CHUNK NEE_RAYS K TEX_PLANES ROW_PLANES
int main(int argc, char** argv) {
  if (argc != 17) return 2;
  dir = argv[1];
  const int textured = atoi(argv[2]), rowtag = atoi(argv[3]), sh = atoi(argv[4]);
  Args a{};
  a.n = atoi(argv[5]);
  a.seed = atoi(argv[6]);
  a.max_depth = atoi(argv[7]);
  a.rr_start = atoi(argv[8]);
  a.rows = atoi(argv[9]);
  a.sampler = atoi(argv[10]);
  a.robust = atoi(argv[11]);
  a.chunk = atoi(argv[12]);
  a.nee_rays = atoi(argv[13]);
  a.n_cols = atoi(argv[14]);
  const int tex_planes = atoi(argv[15]), row_planes = atoi(argv[16]);
  const auto F = load<float>("f"), diffuse = load<float>("diffuse"),
             specular = load<float>("specular"), emission = load<float>("emission"),
             exponent = load<float>("exponent"), light_emit = load<float>("light_emit"),
             env = load<float>("env"), texa = load<float>("texa"), texb = load<float>("texb"),
             timg = load<float>("timg"), o = load<float>("o"), d = load<float>("d"),
             g = load<float>("g"), l = load<float>("l");
  const auto I = load<int>("i"), si = load<int>("si"), pix = load<int>("pix"),
             cmap = load<int>("cmap");
  a.F = F.data(); a.I = I.data(); a.diffuse = diffuse.data(); a.specular = specular.data();
  a.emission = emission.data(); a.exponent = exponent.data(); a.light_emit = light_emit.data();
  a.env = env.data(); a.texa = texa.data(); a.texb = texb.data(); a.timg = timg.data();
  a.o = o.data(); a.d = d.data(); a.si = si.data(); a.pix = pix.data();
  a.g = g.data(); a.l_in = l.data(); a.cmap = cmap.data();
  const long long warps = (a.n + a.chunk - 1) / a.chunk;
  std::vector<float> rows((size_t)32 * warps * a.n_cols, 0.f),
      tex_dout((size_t)3 * tex_planes * a.n, -1.f), row_dout((size_t)row_planes * a.n, -1.f);
  std::vector<int> tex_tags((size_t)tex_planes * a.n, -1),
      row_tags((size_t)(a.max_depth + 1) * a.n, -1);
  a.tex_dout = tex_dout.data();
  a.tex_tags = tex_tags.data();
  a.row_dout = row_dout.data();
  a.row_tags = row_tags.data();
  if (a.sampler == S_SOBOL) upload_sites();
  if (a.sampler == S_SOBOL) run_tex<true>(a, rows.data(), textured, rowtag, sh);
  else run_tex<false>(a, rows.data(), textured, rowtag, sh);
  save("rows", rows);
  save("tex_dout", tex_dout);
  save("tex_tags", tex_tags);
  save("row_dout", row_dout);
  save("row_tags", row_tags);
  return 0;
}
"""


@pytest.fixture(scope="module")
def replay_exe(tmp_path_factory):
    return build_harness(tmp_path_factory, "csrc_replay", HARNESS)


# scene, sampler, nee, shadow, trainable exponent, tables staged in shared
# memory, lanes a warp, row-tagged route forced (DENSE_MAX_ROWS 0): Veach
# and Cornell under hash and sobol, both NEE, shadow and exponent modes,
# both table routes, refilled chunks of 128-256 lanes (4-8 lanes a slot)
# and 32-lane ones, textures (a checker floor, an image wall), a light
# chunk past NEE_CHUNK, the row-tagged route, 33 lights (a second skip
# word; 102 row-tagged lane columns)
CASES = [
    ("veach", "hash", "all", "parity", False, True, 128, False),
    ("veach", "sobol", "all", "robust", True, True, 256, False),
    ("veach", "hash", "single", "robust", False, False, 32, False),
    ("cornell", "hash", "all", "robust", False, True, 256, False),
    ("cornell", "sobol", "single", "parity", True, False, 128, False),
    ("textured", "sobol", "all", "parity", False, True, 128, False),
    ("many_lights", "hash", "all", "parity", False, True, 128, False),
    ("veach", "sobol", "all", "parity", False, True, 128, True),
    ("many_lights33", "hash", "all", "parity", False, True, 128, False),
    ("many_lights33", "sobol", "all", "robust", False, False, 32, True),
]


@pytest.mark.parametrize(
    "scene, sampler, nee, shadow, texp, shared, chunk, rowtag", CASES)
def test_replay_lane_body_matches_plain(replay_exe, tmp_path, monkeypatch,
                                        scene, sampler, nee, shadow, texp,
                                        shared, chunk, rowtag):
    if rowtag:
        monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 0)
    if not shared:
        monkeypatch.setattr(kwf, "STAGE_BUDGET", 0)
    sc = _scene(scene)
    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, sampler=sampler,
                           nee=nee, shadow=shadow, trainable_exponent=texp)
    n, seed = 3000, 13
    o, d, si, pix = _lanes(sc, n)
    tables = kwf.pack_tables(sc, cfg)
    assert (tables.stage_bytes > 0) == shared
    assert kwf.row_tagged(tables.static) == rowtag
    big_l = kwf.trace_lanes_plain(tables, cfg, o, d, seed, si, pix)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n, 3)).astype(np.float32))
    write_tables(tables, cfg, tmp_path)
    for nm, t in (("o", o), ("d", d), ("si", si), ("pix", pix), ("g", g),
                  ("l", big_l)):
        t.contiguous().numpy().tofile(tmp_path / nm)
    k = kwf._row_cols(tables, cfg)
    tex_planes, row_planes = outputs(tables, cfg, n)

    def harness(lanes_a_warp: int):
        res = subprocess.run(
            [str(replay_exe), str(tmp_path),
             str(int(bool(tables.static["textures"]))), str(int(rowtag)),
             str(int(shared)), str(n), str(seed), str(cfg.max_depth),
             str(cfg.rr_start), str(cfg.rows), str(kwf.SAMPLERS[sampler]),
             str(int(shadow == "robust")), str(lanes_a_warp),
             str(kwf._scene_args(tables, cfg)[2]), str(k), str(tex_planes),
             str(row_planes)],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        rows = np.fromfile(tmp_path / "rows", np.float32).reshape(-1, k)
        planes = [np.fromfile(tmp_path / nm, np.float32 if "dout" in nm
                              else np.int32)
                  for nm in ("tex_dout", "tex_tags", "row_dout", "row_tags")]
        return rows, grads_of(tables, cfg, rows, tmp_path, n), planes

    one_rows, one, one_planes = harness(32)
    rows, got, planes = harness(chunk)
    # the plain version's rows, one a lane, as it hands them to sum_columns,
    # and its row-tagged planes
    seen, tagged = [], []
    sum_columns, row_sums = kwf.sum_columns, kwf.row_sums_plain
    monkeypatch.setattr(kwf, "sum_columns",
                        lambda acc: seen.append(acc) or sum_columns(acc))
    monkeypatch.setattr(kwf, "row_sums_plain", lambda dout, tags, *a: (
        tagged.append((dout, tags)) or row_sums(dout, tags, *a)))
    kwf.bwd_replay_plain(tables, cfg, o, d, seed, si, pix, g, big_l)
    # (the kept columns: the dense route's row has one more, which no lane
    # adds to)
    kept = k - (not rowtag)
    assert len(seen) == 1 and seen[0].shape == (n, kept)
    bad = ~np.isclose(one_rows[:n, :kept], seen[0].numpy(), rtol=1e-3,
                      atol=1e-4)
    assert bad.any(1).mean() <= 0.005, bad.any(1).mean()
    assert not one_rows[n:].any() and not one_rows[:, kept:].any()
    if rowtag:
        dout, tags = (t.numpy() for t in tagged[0])
        bad = ~np.isclose(planes[2].reshape(dout.shape), dout, rtol=1e-3,
                          atol=1e-4)
        bad = bad.any(0) | (planes[3].reshape(tags.shape) != tags).any(0)
        assert bad.mean() <= 0.005, bad.mean()
    assert not one_rows[n:].any()
    check_grads(got, one, f"{scene}: refilled against one lane a slot")
    assert all(np.array_equal(a, b) for a, b in zip(planes, one_planes))
    assert bool((got[0] != 0).any())
