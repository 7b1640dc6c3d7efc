"""The CUDA lane body of K1 and K2 (csrc/wavefront_fwd.cu `lane_start`,
`lane_bounce`, `lane_finish`) compiled with g++ and run on the CPU against
the plain version `trace_lanes_plain`.

The sources compile on the host with tests/csrc_stub/cuda_runtime.h in
place of the CUDA runtime header (the <<<...>>> launch configurations
stripped, the dynamic shared-memory array a static one) and -ffp-contract=off,
so the host rounds the arithmetic as the card does. A small harness stages
the scene's tables as a block does (`stage_scene`, on both table routes) and
runs each warp's chunk of lanes in the kernel's refill order: 32 slots, a
slot that ends its lane takes the chunk's next lane in slot order, so a
lane's state must not leak into the next lane of its slot.

Tolerance: the plain-vs-kytpu one (tests/test_torch_wavefront.py): at most
0.5% of lanes outside rtol=1e-3, atol=1e-4 in any channel (the host's cosf,
powf and logf differ from the card's and torch's in the last bits, and a
1-ulp difference can flip a branch), the means within 3 standard errors;
each float cache plane the same, the int planes at most 0.5% of lanes
differing.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import launch as klaunch
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene.scene import generate_rays
from tests.test_torch_cuda import many_lights
import tests.torch_threads  # noqa: F401  (one torch thread a process)

CSRC = Path(kwf.__file__).resolve().parent / "csrc"
STUB = Path(__file__).resolve().parent / "csrc_stub"

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
// order of wavefront_fwd_kernel
template <int MODE, bool SOBOL, bool TEX, bool SH>
void run(const Args& a) {
  static float smem[1 << 16], rays[ShadowRays::FIELDS * NEE_CHUNK * RAY_STRIDE];
  const KScene<SH> S = stage_scene<SH, TEX>(a, smem);
  const ResPlanes rp = res_planes(S.env_i >= 0, S.single, S.L, S.texp, TEX && S.has_img);
  const ShadowRays R{rays, a.nee_rays};  // thread 0's column
  for (long long base = 0; base < a.n; base += a.chunk) {
    const long long end = std::min(base + a.chunk, (long long)a.n);
    long long next = base + 32;
    Lane L[32];
    bool active[32], any = false;
    for (int s = 0; s < 32; ++s) {
      active[s] = base + s < end;
      if (active[s]) lane_start<MODE, SOBOL>(a, (int)(base + s), L[s]);
      any = any || active[s];
    }
    while (any) {
      bool done[32];
      for (int s = 0; s < 32; ++s) {
        done[s] = active[s] && lane_bounce<MODE, SOBOL, TEX, false, SH>(a, S, rp, R, L[s],
                                                                           RowAcc{nullptr});
        if (done[s]) lane_finish<MODE, TEX, false, SH>(a, S, rp, L[s]);
      }
      int k = 0;
      any = false;
      for (int s = 0; s < 32; ++s) {
        if (done[s]) {
          const long long id = next + k++;
          active[s] = id < end;
          if (active[s]) lane_start<MODE, SOBOL>(a, (int)id, L[s]);
        }
        any = any || active[s];
      }
      next += k;
    }
  }
}

template <int MODE, bool SOBOL, bool TEX>
void run_route(const Args& a, bool sh) {
  if (sh) run<MODE, SOBOL, TEX, true>(a);
  else run<MODE, SOBOL, TEX, false>(a);
}

template <int MODE, bool SOBOL>
void run_tex(const Args& a, bool tex, bool sh) {
  if (tex) run_route<MODE, SOBOL, true>(a, sh);
  else run_route<MODE, SOBOL, false>(a, sh);
}

template <int MODE>
void run_sobol(const Args& a, bool sobol, bool tex, bool sh) {
  if (sobol) run_tex<MODE, true>(a, tex, sh);
  else run_tex<MODE, false>(a, tex, sh);
}

}  // namespace

// lane DIR RESIDUAL TEXTURED SHARED N SEED MAX_DEPTH RR_START ROWS SAMPLER
//      ROBUST RES_N CHUNK NEE_RAYS
int main(int argc, char** argv) {
  if (argc != 15) return 2;
  dir = argv[1];
  const int residual = atoi(argv[2]), textured = atoi(argv[3]), sh = atoi(argv[4]);
  Args a{};
  a.n = atoi(argv[5]);
  a.seed = atoi(argv[6]);
  a.max_depth = atoi(argv[7]);
  a.rr_start = atoi(argv[8]);
  a.rows = atoi(argv[9]);
  a.sampler = atoi(argv[10]);
  a.robust = atoi(argv[11]);
  const int res_n = atoi(argv[12]);
  a.chunk = atoi(argv[13]);
  a.nee_rays = atoi(argv[14]);
  const auto F = load<float>("f"), diffuse = load<float>("diffuse"),
             specular = load<float>("specular"), emission = load<float>("emission"),
             exponent = load<float>("exponent"), light_emit = load<float>("light_emit"),
             env = load<float>("env"), texa = load<float>("texa"), texb = load<float>("texb"),
             timg = load<float>("timg"), o = load<float>("o"), d = load<float>("d");
  const auto I = load<int>("i"), si = load<int>("si"), pix = load<int>("pix");
  a.F = F.data(); a.I = I.data(); a.diffuse = diffuse.data(); a.specular = specular.data();
  a.emission = emission.data(); a.exponent = exponent.data(); a.light_emit = light_emit.data();
  a.env = env.data(); a.texa = texa.data(); a.texb = texb.data(); a.timg = timg.data();
  a.o = o.data(); a.d = d.data(); a.si = si.data(); a.pix = pix.data();
  std::vector<float> out(3 * (size_t)a.n, -1.f), resf((size_t)res_n * a.n, -1.f);
  // the row planes and, past 32 lights under nee="single", the pick planes
  std::vector<int> resi((size_t)(2 * a.max_depth + 1) * a.n, -1);
  a.out = out.data();
  a.resf = resf.data();
  a.resi = resi.data();
  if (a.sampler == S_SOBOL) upload_sites();
  if (residual) run_sobol<MODE_RESIDUAL>(a, a.sampler == S_SOBOL, textured, sh);
  else run_sobol<MODE_FWD>(a, a.sampler == S_SOBOL, textured, sh);
  save("out", out);
  if (residual) {
    save("resf", resf);
    save("resi", resi);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def lane_exe(tmp_path_factory):
    """The harness built from csrc/wavefront_fwd.cu; skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA lane body on the host")
    build = tmp_path_factory.mktemp("csrc_lane")
    for src in CSRC.glob("*.cu*"):
        text = re.sub(r"<<<[^>]*>>>", "", src.read_text())
        text = text.replace("extern __shared__ float4 smem4[];",
                            "static float4 smem4[1 << 14];")
        (build / src.name).write_text(text)
    (build / "harness.cpp").write_text(HARNESS)
    exe = build / "lane"
    res = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-w", "-I", str(STUB),
         "-I", str(build), "-o", str(exe), str(build / "harness.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


def _scene(name):
    tex = np.random.default_rng(2).uniform(0.1, 0.9, (8, 8, 3)).astype(
        np.float32)
    return {
        "veach": lambda: builders.veach_mis(32, 20),
        "cornell": lambda: builders.cornell_box(width=24, height=16),
        "cornell_lights": lambda: builders.cornell_box(
            {builders.LARGE_GLASS_SPHERE, builders.LIGHT_POINT,
             builders.LIGHT_DIRECTION, builders.LIGHT_ENVIRONMENT}, 24, 16),
        "many_lights": lambda: many_lights(builders, 11),
        "many_lights33": lambda: many_lights(builders, 33),
        "many_lights64": lambda: many_lights(builders, 64, 12, 8),
        "textured": lambda: builders.cornell_box(
            width=24, height=16, floor_checker=True, back_image=tex),
    }[name]()


def _lanes(scene, n, seed=1):
    w, h = scene.camera.width, scene.camera.height
    rng = np.random.default_rng(seed)
    pix = (np.arange(n) % (w * h)).astype(np.int32)
    pf = np.stack([pix % w + rng.random(n), pix // w + rng.random(n)],
                  -1).astype(np.float32)
    o, d = generate_rays(scene.camera, torch.from_numpy(pf))
    si = torch.from_numpy((np.arange(n) // (w * h) + 3).astype(np.int32))
    return o, d, si, torch.from_numpy(pix)


def _agree(got, ref, what, max_share=0.005):
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), what
    share = (~np.isclose(got, ref, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert share <= max_share, (what, share)
    se = ref.std(0) / np.sqrt(len(ref)) + 1e-12
    assert (np.abs(got.mean(0) - ref.mean(0)) <= 3 * se).all(), what


# scene, sampler, nee, shadow, trainable exponent, K2, staged in shared
# memory, lanes a warp: every sampler but "random" (the card tests hold
# it), both NEE, shadow and exponent modes, both table routes, textures, a
# light chunk past NEE_CHUNK (11 lights), refilled warps, and past the 32
# lights of one skip word and of the pick bits (33 and 64 lights)
CASES = [
    ("veach", "hash", "all", "parity", False, False, True, 128),
    ("veach", "hash", "all", "robust", False, True, False, 96),
    ("veach", "sobol", "all", "parity", True, True, True, 256),
    ("veach", "sobol", "single", "robust", False, True, True, 64),
    ("cornell", "hash", "single", "parity", False, True, True, 128),
    ("cornell", "sobol", "all", "robust", False, False, False, 32),
    ("cornell_lights", "hash", "all", "parity", False, True, True, 256),
    ("many_lights", "hash", "all", "robust", False, True, False, 128),
    ("many_lights", "sobol", "all", "parity", False, False, True, 256),
    ("many_lights33", "hash", "all", "robust", False, True, True, 128),
    ("many_lights33", "sobol", "single", "parity", False, True, False, 64),
    ("many_lights64", "hash", "all", "parity", False, True, False, 256),
    ("textured", "hash", "all", "parity", False, True, True, 128),
    ("textured", "sobol", "single", "robust", False, False, False, 96),
]


@pytest.mark.parametrize(
    "scene, sampler, nee, shadow, texp, residual, shared, chunk", CASES)
def test_lane_body_matches_plain(lane_exe, tmp_path, scene, sampler, nee,
                                 shadow, texp, residual, shared, chunk):
    sc = _scene(scene)
    cfg = kwf.KernelConfig(max_depth=4, rr_start=1, rows=2, sampler=sampler,
                           nee=nee, shadow=shadow, trainable_exponent=texp)
    n, seed = 768, 11
    o, d, si, pix = _lanes(sc, n)
    tables = kwf.pack_tables(sc, cfg)
    if shared:
        assert tables.stage_bytes > 0
    for nm in kwf._TABLES:
        getattr(tables, nm).numpy().tofile(tmp_path / nm)
    for nm, t in (("o", o), ("d", d), ("si", si), ("pix", pix)):
        t.contiguous().numpy().tofile(tmp_path / nm)
    _, res_n = kwf.residual_layout(tables.static, cfg)
    res = subprocess.run(
        [str(lane_exe), str(tmp_path), str(int(residual)),
         str(int(bool(tables.static["textures"]))), str(int(shared)), str(n),
         str(seed), str(cfg.max_depth), str(cfg.rr_start), str(cfg.rows),
         str(klaunch.SAMPLERS[sampler]),
         str(int(shadow == "robust")), str(res_n), str(chunk),
         str(kwf._scene_args(tables, cfg)[2])],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    got = np.fromfile(tmp_path / "out", np.float32).reshape(n, 3)
    ref = kwf.trace_lanes_plain(tables, cfg, o, d, seed, si, pix,
                                residual=residual)
    if not residual:
        _agree(got, ref.numpy(), "radiance")
        return
    ref_l, ref_f, ref_i = (t.numpy() for t in ref)
    _agree(got, ref_l, "radiance")
    resf = np.fromfile(tmp_path / "resf", np.float32).reshape(res_n, n)
    resi = np.fromfile(tmp_path / "resi", np.int32).reshape(-1, n)
    resi = resi[:kwf.int_planes(tables.static, cfg)]
    assert np.isfinite(resf).all()
    bad = ~np.isclose(resf, ref_f, rtol=1e-3, atol=1e-4)
    assert bad.mean(1).max() <= 0.005, bad.mean(1)
    assert (resi != ref_i).any(0).mean() <= 0.005
    if texp:
        ix, _ = kwf.residual_layout(tables.static, cfg)
        kplanes = [k for t, k in ix.items() if t[0] in ("Bk", "tuk")]
        assert (ref_f[kplanes] != 0).any()
