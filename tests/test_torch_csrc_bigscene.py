"""The big-scene lane body of K5, K6 and K8 (csrc/bigscene_fwd.cu
`trace_lane`, with its block cull) compiled with g++ and run on the CPU:
against the plain versions `trace_lanes_plain` and `bwd_replay_plain`, and
culled against the same build with the cull off.

The source compiles on the host as in tests/test_torch_csrc_lane.py
(tests/csrc_stub/cuda_runtime.h, the <<<...>>> launch configurations
stripped, the dynamic shared-memory array a static one, -ffp-contract=off).
The stub's votes treat each lane as a warp of one, so each lane skips every
block that its own rays cannot meet: the strictest cull the kernel can run.
A harness runs the lanes one after another, each with the shadow-ray
column of thread 0.

Tolerances:
- culled against the cull off: every output equal bit for bit (one build,
  one host libm: a skipped block that held a row some lane would take
  changes that lane);
- against the plain versions, the plain-vs-kytpu bound
  (tests/test_torch_wavefront.py): at most 0.5% of lanes outside
  rtol=1e-3, atol=1e-4 in any channel or plane (the host's cosf, powf and
  logf differ from torch's in the last bits, and a 1-ulp difference can
  flip a branch), the radiance's means within 3 standard errors; the row
  tags and int planes of at most 0.5% of lanes differ.

A quarter of the lanes graze the sphere that sets a block's bounding
radius, at the bound itself, so a block bound without its pad loses rows
that the row tests take (the culled run then differs from the cull off).
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import launch as klaunch
from kytpu_torch.kernels import tables as ktab
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import builders, mesh
from kytpu_torch.scene.scene import generate_rays, make_camera
from tests.test_torch_cuda import many_lights
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CSRC = Path(kbs.__file__).resolve().parent / "csrc"
STUB = Path(__file__).resolve().parent / "csrc_stub"

HARNESS = r"""
#include "bigscene_fwd.cu"

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

// every lane in turn, as thread 0 of a warp of one, or (KYTPU_WARP_EMU)
// each 32 lanes a warp of 32 host threads that vote as the card's warps
// vote; acc: K8's lane columns; swept: each lane's rows swept, sweeps,
// node steps, and the tri class's rows and node steps
template <int MODE, bool SOBOL, bool TEX>
void run(const BigArgs& a, std::vector<float>& acc, std::vector<uint32_t>& swept) {
  static float rays[Rays::FIELDS * NEE_CHUNK * THREADS];
  Scene S;
  S.init(a.F, a.I);
  Tables T;
  T.init(a);
  auto lane = [&](int i, int t) {
    const bool in = i < a.n;
    float* row = in ? acc.data() + (size_t)i * a.n_cols : nullptr;
    Swept<true> sw;
    trace_lane<MODE, SOBOL, TEX>(a, S, T, Rays{rays + t, a.nee_rays}, i, in,
                                 MODE == MODE_REPLAY ? row : nullptr, sw);
    if (!in) return;
    const uint32_t got[5] = {sw.rows, sw.sweeps, sw.bounds, sw.tri_rows, sw.tri_bounds};
    for (int k = 0; k < 5; ++k) swept[5 * (size_t)i + k] = got[k];
  };
#ifdef KYTPU_WARP_EMU
  for (int w = 0; 32 * w < a.n; ++w) {
    WarpVotes votes;
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = w;
        warp_emu = &votes;
        lane(32 * w + t, t);
      });
    for (auto& th : lanes) th.join();
  }
#else
  for (int i = 0; i < a.n; ++i) lane(i, 0);
#endif
}

template <int MODE, bool SOBOL>
void run_tex(const BigArgs& a, bool tex, std::vector<float>& acc, std::vector<uint32_t>& swept) {
  if (tex) run<MODE, SOBOL, true>(a, acc, swept);
  else run<MODE, SOBOL, false>(a, acc, swept);
}

template <int MODE>
void run_sobol(const BigArgs& a, bool tex, std::vector<float>& acc, std::vector<uint32_t>& swept) {
  if (a.sampler == S_SOBOL) run_tex<MODE, true>(a, tex, acc, swept);
  else run_tex<MODE, false>(a, tex, acc, swept);
}

}  // namespace

// bigscene DIR MODE TEXTURED CULL N N_TRI N_RECT N_DISK N_SPH M SEED
//          MAX_DEPTH RR_START ROWS SAMPLER ROBUST TEXP RES_N NEE_RAYS N_COLS
//          IMG
int main(int argc, char** argv) {
  if (argc != 22) return 2;
  dir = argv[1];
  const int mode = atoi(argv[2]), textured = atoi(argv[3]);
  BigArgs a{};
  a.cull = atoi(argv[4]);
  a.n = atoi(argv[5]);
  a.n_tri = atoi(argv[6]); a.n_rect = atoi(argv[7]); a.n_disk = atoi(argv[8]);
  a.n_sph = atoi(argv[9]); a.M = atoi(argv[10]); a.seed = atoi(argv[11]);
  a.max_depth = atoi(argv[12]); a.rr_start = atoi(argv[13]); a.rows_per_tile = atoi(argv[14]);
  a.sampler = atoi(argv[15]); a.robust = atoi(argv[16]); a.texp = atoi(argv[17]);
  const int res_n = atoi(argv[18]);
  a.nee_rays = atoi(argv[19]);
  a.n_cols = atoi(argv[20]);
  const int img = atoi(argv[21]);
  const auto F = load<float>("f"), geo = load<float>("geo"), mat_f = load<float>("mat_f"),
             diffuse = load<float>("diffuse"), specular = load<float>("specular"),
             emission = load<float>("emission"), exponent = load<float>("exponent"),
             light_emit = load<float>("light_emit"), env = load<float>("env"),
             texa = load<float>("texa"), texb = load<float>("texb"), timg = load<float>("timg"),
             bnd = load<float>("bnd"), o = load<float>("o"), d = load<float>("d"),
             g = load<float>("g"), l_in = load<float>("l_in");
  const auto I = load<int>("i"), rows = load<int>("rows"), mat_i = load<int>("mat_i"),
             tex_rec = load<int>("tex_rec"), si = load<int>("si"), pix = load<int>("pix");
  const auto links = load<int>("links");
  a.F = F.data(); a.I = I.data(); a.geo = geo.data(); a.rows = rows.data();
  a.mat_i = mat_i.data(); a.mat_f = mat_f.data(); a.diffuse = diffuse.data();
  a.specular = specular.data(); a.emission = emission.data(); a.exponent = exponent.data();
  a.light_emit = light_emit.data(); a.env = env.data(); a.texa = texa.data();
  a.texb = texb.data(); a.timg = timg.data(); a.tex_rec = tex_rec.data();
  a.bnd = (const float4*)bnd.data(); a.link = (const int2*)links.data();
  a.o = o.data(); a.d = d.data(); a.si = si.data();
  a.pix = pix.data(); a.g = g.data(); a.l_in = l_in.data();
  const size_t n = a.n, B = a.max_depth, PB = a.texp ? 10 : 9;
  std::vector<float> out(3 * n, -1.f), resf(res_n * n, -1.f), dout((PB * B + 3) * n, -1.f),
      acc(n * (a.n_cols > 0 ? a.n_cols : 1), 0.f), tex_dout(12 * B * n, -1.f);
  std::vector<int> resi((B + 1) * n, -1), tags((B + 1) * n, -1), tex_tags(4 * B * n, -1);
  std::vector<uint32_t> swept(5 * n, 0);
  // a counter buffer, so that the lanes count (the kernel's traced launch)
  unsigned long long counted[5] = {0, 0, 0, 0, 0};
  a.swept = counted;
  a.out = out.data(); a.resf = resf.data(); a.resi = resi.data(); a.dout = dout.data();
  a.tags = tags.data(); a.tex_dout = tex_dout.data(); a.tex_tags = tex_tags.data();
  if (a.sampler == S_SOBOL) upload_sites();
  if (mode == MODE_FWD) run_sobol<MODE_FWD>(a, textured, acc, swept);
  else if (mode == MODE_RESIDUAL) run_sobol<MODE_RESIDUAL>(a, textured, acc, swept);
  else run_sobol<MODE_REPLAY>(a, textured, acc, swept);
  save("swept", swept);
  if (mode != MODE_REPLAY) save("out", out);
  if (mode == MODE_RESIDUAL) {
    save("resf", resf);
    save("resi", resi);
  }
  if (mode == MODE_REPLAY) {
    save("dout", dout);
    save("tags", tags);
    save("acc", acc);
    if (img) {
      save("tex_dout", tex_dout);
      save("tex_tags", tex_tags);
    }
  }
  return 0;
}
"""


def _build(tmp_path_factory, warps: bool):
    """The harness built from csrc/bigscene_fwd.cu (warps: with
    KYTPU_WARP_EMU, a warp of 32 host threads); skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA lane body on the host")
    build = tmp_path_factory.mktemp("csrc_bigscene")
    for src in CSRC.glob("*.cu*"):
        text = re.sub(r"<<<[^>]*>>>", "", src.read_text())
        text = text.replace("extern __shared__ float4 smem4[];",
                            "static float4 smem4[1 << 14];")
        (build / src.name).write_text(text)
    (build / "harness.cpp").write_text(
        ("#define KYTPU_WARP_EMU\n" if warps else "") + HARNESS)
    exe = build / "bigscene"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-pthread",
         "-I", str(STUB), "-I", str(build), "-o", str(exe),
         str(build / "harness.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def big_exe(tmp_path_factory):
    return _build(tmp_path_factory, False)


@pytest.fixture(scope="module")
def big_warp_exe(tmp_path_factory):
    return _build(tmp_path_factory, True)


IMG8 = np.random.default_rng(2).uniform(0.1, 0.9, (8, 8, 3)).astype(
    np.float32)


def _triangles_only():
    """The tetrahedral pyramid's 64 triangles at factor 3 with no floor:
    every row of the tri class."""
    a = builders._SceneAssembler()
    for tri in builders.sierpinski(3):
        a.surface(a.geo.add_triangle(*tri), a.matte(torch.full((3,), 0.8)))
    a.add_light(kind=klights.POINT, emit=torch.full((3,), 60.0),
                position=np.array(builders.TETRA_LIGHT_POS))
    a.add_light(kind=klights.ENV, emit=torch.tensor(builders.SPD_SKY))
    cam = make_camera(position=(2.4, -3.0, 2.0), front=(-2.4, 3.0, -1.45),
                      up=(0.0, 0.0, 1.0), fov_degrees=45.0, width=24,
                      height=16)
    return a.build(cam)


def _scene(name):
    return {
        "spd_balls": lambda: builders.spd_balls(2, 24, 16),
        "tetra": lambda: builders.spd_tetra(3, 24, 16),
        "triangles": _triangles_only,
        "spheres": lambda: builders.random_spheres(n=96, width=24, height=16),
        "mesh": lambda: builders.mesh_scene(*mesh.icosphere(subdivisions=2),
                                            width=24, height=16),
        "textured": lambda: builders.cornell_box(
            width=24, height=16, floor_checker=True, back_image=IMG8),
        "many_lights33": lambda: many_lights(builders, 33),
    }[name]()


def _grazing(tables, n, rng):
    """n rays, each tangent to the sphere that sets its block's bounding
    radius, at the block's bound (without its pad): the row test and the
    unpadded block test both sit at their rounding edge there."""
    static, tabs = tables
    geo, _, bnd = tabs["sphere"]
    o, d = [], []
    for b in range(len(bnd)):
        rows = geo[b * kbs.UNROLL:(b + 1) * kbs.UNROLL].astype(np.float64)
        rows = rows[rows[:, 3] > 0]
        if not len(rows):
            continue
        c = bnd[b, :3].astype(np.float64)
        far = np.linalg.norm(rows[:, :3] - c, axis=-1) + rows[:, 3]
        s = rows[int(np.argmax(far))]
        u = s[:3] - c
        if np.linalg.norm(u) < 1e-6 * s[3]:   # one sphere: any side
            u = rng.normal(size=3)
        u = u / np.linalg.norm(u)
        p = s[:3] + u * s[3]
        w = np.cross(u, rng.normal(size=3))
        w = w / np.linalg.norm(w)
        o.append(p - w * rng.uniform(2.0, 6.0))
        d.append(w)
    o, d = np.asarray(o), np.asarray(d)
    k = rng.integers(0, len(o), n)
    return o[k].astype(np.float32), d[k].astype(np.float32)


def _lanes(scene, extracted, n, graze, seed=1):
    w, h = scene.camera.width, scene.camera.height
    rng = np.random.default_rng(seed)
    pix = (np.arange(n) % (w * h)).astype(np.int32)
    pf = np.stack([pix % w + rng.random(n), pix // w + rng.random(n)],
                  -1).astype(np.float32)
    o, d = generate_rays(scene.camera, torch.from_numpy(pf))
    o, d = o.numpy().copy(), d.numpy().copy()
    if graze:
        o[:graze], d[:graze] = _grazing(extracted, graze, rng)
    si = (np.arange(n) // (w * h) + 3).astype(np.int32)
    return (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(si),
            torch.from_numpy(pix))


def _share_off(got, ref, what, max_share=0.005):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    share = (~np.isclose(got, ref, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert share <= max_share, (what, share)


def _means_agree(got, ref, what):
    se = ref.std(0) / np.sqrt(len(ref)) + 1e-12
    assert (np.abs(got.mean(0) - ref.mean(0)) <= 3 * se).all(), what


def _run(exe, path, mode, cull, tables, cfg, n, seed, res_n, n_cols):
    st = tables.static
    res = subprocess.run(
        [str(exe), str(path), str(mode), str(int(bool(st["textures"]))),
         str(cull), str(n), *map(str, tables.counts),
         str(len(st["mats"]["kind"])), str(seed), str(cfg.max_depth),
         str(cfg.rr_start), str(cfg.rows),
         str(klaunch.SAMPLERS[cfg.sampler]), str(int(cfg.shadow == "robust")),
         str(int(cfg.trainable_exponent)),
         str(res_n), str(kbs._cull_args(tables, cfg)[1]), str(n_cols),
         str(int(ktab.has_img(st)))], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    names = {0: ("out",), 1: ("out", "resf", "resi"),
             2: ("dout", "tags", "acc") + (
                 ("tex_dout", "tex_tags") if ktab.has_img(st) else ())}[mode]
    return {nm: np.fromfile(path / nm, np.int32 if nm in (
        "resi", "tags", "tex_tags") else np.float32) for nm in names}


# scene, sampler, shadow, trainable exponent, depth: each sampler and both
# shadow modes on each scene kind, a textured table scene (checker floor,
# 8x8 atlas: K8's texel entries), 33 lights (102 lane columns, past the
# kernel's local row)
CASES = [
    ("spheres", "random", "parity", False, 3),
    ("spheres", "hash", "robust", True, 3),
    ("spheres", "sobol", "parity", False, 2),
    ("mesh", "random", "robust", False, 2),
    ("mesh", "hash", "parity", False, 3),
    ("mesh", "sobol", "robust", True, 2),
    ("textured", "hash", "parity", False, 3),
    ("textured", "sobol", "robust", False, 2),
    ("many_lights33", "hash", "robust", False, 2),
]


@pytest.mark.parametrize("scene, sampler, shadow, texp, depth", CASES)
def test_culled_lane_body_matches_plain(big_exe, tmp_path, scene, sampler,
                                        shadow, texp, depth):
    sc = _scene(scene)
    cfg = kwf.KernelConfig(max_depth=depth, rr_start=1, rows=2,
                           sampler=sampler, shadow=shadow,
                           trainable_exponent=texp)
    n, seed = 2048, 11
    extracted = kbs.extract_tables(sc)
    tables = kbs.pack_big_tables(sc, cfg, extracted)
    graze = n // 4 if tables.counts[3] else 0
    o, d, si, pix = _lanes(sc, extracted, n, graze)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n, 3)).astype(np.float32))
    ref_l, ref_f, ref_i = kbs.trace_lanes_plain(tables, cfg, o, d, seed, si,
                                                pix, residual=True)
    for nm in kbs._TABLES:
        getattr(tables, nm).numpy().tofile(tmp_path / nm)
    for nm, t in (("o", o), ("d", d), ("si", si), ("pix", pix), ("g", g),
                  ("l_in", ref_l)):
        t.contiguous().numpy().tofile(tmp_path / nm)
    _, res_n = kbs.layout_of(tables.static, cfg)
    n_cols = kbs._n_cols(tables)
    runs = {(mode, cull): _run(big_exe, tmp_path, mode, cull, tables, cfg, n,
                               seed, res_n, n_cols)
            for mode in (0, 1, 2) for cull in (1, 0)}
    for mode in (0, 1, 2):
        for nm, got in runs[(mode, 1)].items():
            np.testing.assert_array_equal(
                got, runs[(mode, 0)][nm],
                err_msg=f"mode {mode} {nm}: culled != cull off")
    np.testing.assert_array_equal(runs[(0, 1)]["out"], runs[(1, 1)]["out"])

    # K5 and K6 against the plain K6
    got = runs[(1, 1)]["out"].reshape(n, 3)
    _share_off(got, ref_l.numpy(), "radiance")
    _means_agree(got, ref_l.numpy(), "radiance")
    resf = runs[(1, 1)]["resf"].reshape(res_n, n)
    resi = runs[(1, 1)]["resi"].reshape(-1, n)
    _share_off(resf.T, ref_f.numpy().T, "cache planes")
    assert (resi != ref_i.numpy()).any(0).mean() <= 0.005

    # K8's row-tagged planes, tags and lane columns against the plain K8
    ref = kbs.bwd_replay_plain(tables, cfg, o, d, seed, si, pix, g, ref_l)
    r8 = runs[(2, 1)]
    PB = 10 if texp else 9
    dout = r8["dout"].reshape(PB * depth + 3, n)
    tags = r8["tags"].reshape(depth + 1, n)
    _share_off(dout.T, ref[0].numpy().T, "K8 planes")
    _share_off(r8["acc"].reshape(n, n_cols), ref[1].numpy(), "K8 lane columns")
    assert (tags != ref[2].numpy()).any(0).mean() <= 0.005
    if ktab.has_img(tables.static):
        assert (r8["tex_tags"].reshape(-1, n) != 0).any()
    if texp:
        ix, _ = kbs.layout_of(tables.static, cfg)
        kplanes = [k for t, k in ix.items() if t[0] in ("Bk", "tuk")]
        assert (ref_f.numpy()[kplanes] != 0).any()
    if graze:
        assert np.isfinite(got[:graze]).all()


@pytest.mark.parametrize("scene, cull", [("spd_balls", "cone"),
                                         ("spd_balls", "off"),
                                         ("spheres", "cone")])
def test_row_counter_matches_the_plain_votes(big_exe, tmp_path, scene, cull):
    """The lane body's row counter (each lane's rows of the blocks its warp
    entered, and its sweeps; csrc/bigscene_fwd.cu `Swept`) summed over the
    lanes against chip_smoke.swept_counts at warps of one, the host build's
    votes, on the same rays: the same counts."""
    import chip_smoke

    sc = _scene(scene)
    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, cull=cull)
    n, seed = 1024, 11
    extracted = kbs.extract_tables(sc)
    tables = kbs.pack_big_tables(sc, cfg, extracted)
    o, d, si, pix = _lanes(sc, extracted, n, 0)
    ref_l = kbs.trace_lanes_plain(tables, cfg, o, d, seed, si, pix)
    for nm in kbs._TABLES:
        getattr(tables, nm).numpy().tofile(tmp_path / nm)
    for nm, t in (("o", o), ("d", d), ("si", si), ("pix", pix),
                  ("g", torch.zeros(n, 3)), ("l_in", ref_l)):
        t.contiguous().numpy().tofile(tmp_path / nm)
    _, res_n = kbs.layout_of(tables.static, cfg)
    _run(big_exe, tmp_path, 1, int(cull != "off"), tables, cfg, n, seed,
         res_n, kbs._n_cols(tables))
    swept = np.fromfile(tmp_path / "swept", np.uint32).reshape(n, 5)
    got = tuple(int(x) for x in swept.astype(np.int64).sum(0))
    assert got == chip_smoke.swept_counts(tables, cfg, o, d, seed, si, pix,
                                          warp=1)
    assert got[0] > 0 and got[1] >= n and got[2] > 0


def _walk_runs(exe, tmp_path, scene, cfg, n, seed, graze):
    """K5, K6 and K8 culled and with the cull off, and K6's counters under
    cfg.cull summed over the lanes, of one build on `scene`'s lanes."""
    sc = _scene(scene)
    extracted = kbs.extract_tables(sc)
    tables = kbs.pack_big_tables(sc, cfg, extracted)
    lanes = _lanes(sc, extracted, n, graze)
    ref_l = kbs.trace_lanes_plain(tables, cfg, *lanes[:2], seed, *lanes[2:])
    for nm in kbs._TABLES:
        getattr(tables, nm).numpy().tofile(tmp_path / nm)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(n, 3)).astype(np.float32))
    for nm, t in zip(("o", "d", "si", "pix", "g", "l_in"), lanes + (g, ref_l)):
        t.contiguous().numpy().tofile(tmp_path / nm)
    _, res_n = kbs.layout_of(tables.static, cfg)
    runs = {}
    for mode in (0, 1, 2):
        for cull in (1, 0):
            runs[(mode, cull)] = _run(exe, tmp_path, mode, cull, tables, cfg,
                                      n, seed, res_n, kbs._n_cols(tables))
            if (mode, cull) == (1, int(cfg.cull != "off")):
                swept = np.fromfile(tmp_path / "swept", np.uint32)
                counted = tuple(int(x) for x in swept.reshape(n, 5).astype(
                    np.int64).sum(0))
    for mode in (0, 1, 2):
        for nm, got in runs[(mode, 1)].items():
            np.testing.assert_array_equal(
                got, runs[(mode, 0)][nm],
                err_msg=f"{scene} mode {mode} {nm}: culled != cull off")
    return tables, lanes, counted


def _class_split(scene, counted):
    """The tri class's rows and node steps (counted[3:]) within the totals
    (counted[0], counted[2]): all of them on a scene of triangles alone,
    none where the scene has no triangle."""
    rows, _, bounds, tri_rows, tri_bounds = counted
    assert 0 <= tri_rows <= rows and 0 <= tri_bounds <= bounds
    if scene == "triangles":
        assert (tri_rows, tri_bounds) == (rows, bounds)
    elif scene in ("spheres", "spd_balls"):
        assert (tri_rows, tri_bounds) == (0, 0)
    else:
        assert 0 < tri_rows < rows and 0 < tri_bounds < bounds


@pytest.mark.parametrize("scene", ["spd_balls", "spheres", "tetra",
                                   "triangles"])
def test_tree_walk_in_warps_of_one(big_exe, tmp_path, scene):
    """Each lane a warp of one (the host build's votes): the tree walk's K5,
    K6 and K8 equal the cull off to the bit, grazing rays included (on the
    scenes with spheres), and the culled K6's rows, sweeps and node steps,
    and the tri class's rows and node steps, equal
    chip_smoke.swept_counts(warp=1)."""
    import chip_smoke

    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, shadow="robust")
    n, seed = 1024, 23
    graze = n // 4 if scene in ("spd_balls", "spheres") else 0
    tables, lanes, counted = _walk_runs(big_exe, tmp_path, scene, cfg, n,
                                        seed, graze)
    o, d, si, pix = lanes
    assert counted == chip_smoke.swept_counts(tables, cfg, o, d, seed, si,
                                              pix, warp=1)
    assert counted[2] > 0
    _class_split(scene, counted)


@pytest.mark.parametrize("scene, cull", [("spd_balls", "cone"),
                                         ("spd_balls", "off"),
                                         ("spheres", "cone"),
                                         ("tetra", "cone"),
                                         ("triangles", "cone")])
def test_tree_walk_in_warps_of_32(big_warp_exe, tmp_path, scene, cull):
    """Each 32 lanes a warp of 32 host threads whose votes and maxima meet
    as the card's warps' do (KYTPU_WARP_EMU): the warp's node phases, its
    lanes' pending blocks and its leaf phases give K5, K6 and K8 equal to
    the cull off to the bit, and K6's counters equal chip_smoke.swept_counts
    at warps of 32, the tri class's share included, the replay phases 16
    and 17 hold the card to. 1,000 lanes: the last warp is partial."""
    import chip_smoke

    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2, cull=cull)
    n, seed = 1000, 17
    tables, lanes, counted = _walk_runs(big_warp_exe, tmp_path, scene, cfg,
                                        n, seed, 0)
    o, d, si, pix = lanes
    want = chip_smoke.swept_counts(tables, cfg, o, d, seed, si, pix)
    assert counted == want
    _class_split(scene, counted)
    # the warp's phases cost more than its lanes' own walks
    assert want[0] > chip_smoke.swept_counts(tables, cfg, o, d, seed, si,
                                             pix, warp=1)[0]
