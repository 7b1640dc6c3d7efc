"""The plain version of the forward megakernel against kytpu's.

Helper level: the same inputs through kytpu's in-kernel helpers (plain jnp
outside pallas_call) and the port's. Whole kernel: `trace_lanes_plain`
against kytpu's K1 run in interpret mode on the same rays and seeds, lane by
lane (the Veach cases are in test_torch_wavefront_veach.py, the other
sampler/NEE/shadow pairs and a scene with 9 lights in
test_torch_wavefront_lights.py).

Tolerance: at most 0.5% of lanes outside rtol=1e-3, atol=1e-4 in any channel,
and the means within 3 standard errors. Lanes differ where a 1-ulp
difference between XLA's CPU transcendentals (cos, rsqrt, pow, fused
multiply-adds) and the IEEE ones flips a branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kytpu import bsdf as jbsdf
from kytpu.kernels import wavefront as jwf
from kytpu.kernels.v3 import V3 as JV3
from kytpu.scene import builders as jb
from kytpu.scene import scene as jscene
from kytpu_torch.kernels import wavefront as twf
from kytpu_torch.kernels.v3 import V3 as TV3
from kytpu_torch.scene import builders as tb
from tests.test_torch_cuda import many_lights
import tests.torch_threads  # noqa: F401  (one torch thread a process)

N = 4096
ALL_LIGHTS = {jb.LARGE_GLASS_SPHERE, jb.LIGHT_POINT, jb.LIGHT_DIRECTION,
              jb.LIGHT_ENVIRONMENT}
SCENES = {
    "veach": lambda b: b.veach_mis(32, 20),
    "cornell": lambda b: b.cornell_box(width=24, height=16),
    "cornell_lights": lambda b: b.cornell_box(ALL_LIGHTS, 24, 16),
    "many_lights": lambda b: many_lights(b, 9),
    "many_lights33": lambda b: many_lights(b, 33),
}


def lanes_agree(got, ref, max_share=0.005):
    """The tolerance above; returns the share of lanes outside the bound."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    share = (~np.isclose(got, ref, rtol=1e-3, atol=1e-4)).any(-1).mean()
    assert share <= max_share, share
    se = ref.std(0) / np.sqrt(len(ref)) + 1e-12
    assert (np.abs(got.mean(0) - ref.mean(0)) <= 3 * se).all()
    return share


def camera_rays(scene, n, seed=1):
    """Jittered camera rays of a kytpu scene as numpy (o, d, si, pix)."""
    w, h = scene.camera.width, scene.camera.height
    rng = np.random.default_rng(seed)
    pix = (np.arange(n) % (w * h)).astype(np.int32)
    pf = np.stack([pix % w + rng.random(n), pix // w + rng.random(n)],
                  -1).astype(np.float32)
    o, d = jax.jit(lambda p: jscene.generate_rays(scene.camera, p))(
        jnp.asarray(pf))
    si = (np.arange(n) // (w * h) + 3).astype(np.int32)
    return np.asarray(o), np.asarray(d), si, pix


def trace_both(name, sampler, nee, shadow, n=2048, seed=7, max_depth=2):
    """(kytpu interpret-mode K1, port plain) radiance on the same lanes."""
    jsc, tsc = SCENES[name](jb), SCENES[name](tb)
    kw = dict(max_depth=max_depth, rr_start=0, rows=8, sampler=sampler,
              nee=nee, shadow=shadow)
    o, d, si, pix = camera_rays(jsc, n)
    tracer = jwf.make_pallas_tracer(jsc, jwf.KernelConfig(**kw),
                                    interpret=True)
    extra = ((jnp.asarray(si), jnp.asarray(pix)) if sampler != "random"
             else ())
    ref = np.asarray(tracer(jsc, jnp.asarray(o), jnp.asarray(d),
                            jnp.int32(seed), *extra))
    cfg = twf.KernelConfig(**kw)
    got = twf.trace_lanes_plain(twf.pack_tables(tsc, cfg), cfg,
                                torch.from_numpy(o), torch.from_numpy(d), seed,
                                torch.from_numpy(si), torch.from_numpy(pix))
    return got.numpy(), ref


# ---- helper level ----------------------------------------------------------


def _jv(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _tv(a):
    return TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3)))


def _np(v):
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], -1)


@pytest.fixture(scope="module", params=["veach", "cornell", "cornell_lights"])
def scene_pair(request):
    jsc = SCENES[request.param](jb)
    return (jsc, SCENES[request.param](tb), jwf.extract_static(jsc),
            camera_rays(jsc, N))


def _hits(scene_pair):
    jsc, tsc, static, (o, d, _, _) = scene_pair
    ts = twf.extract_static(tsc)
    a = jwf._closest_hit(static, _jv(o), _jv(d))
    b = twf._closest_hit(ts, _tv(o), _tv(d))
    return ts, a, b


def test_closest_hit(scene_pair):
    _, a, b = _hits(scene_pair)
    np.testing.assert_array_equal(np.asarray(a[1]), b[1].numpy())
    np.testing.assert_allclose(np.asarray(a[0]), b[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(_np(a[3]), _np(b[3]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("robust", [False, True])
def test_shadow_masks(scene_pair, robust):
    """Both occlusion sweeps on the same shading points and light samples:
    the masks agree exactly."""
    jsc, tsc, static, (o, d, _, _) = scene_pair
    ts, a, b = _hits(scene_pair)
    t = np.where(np.asarray(a[2]), np.asarray(a[0]), 1.0).astype(np.float32)
    hp = (o + d * t[:, None]).astype(np.float32)
    nrm = _np(a[3]).astype(np.float32)
    rng = np.random.default_rng(4)
    u1, u2 = (rng.random(N).astype(np.float32) for _ in range(2))
    rays_j, rays_t = [], []
    for lj in static["lights"]:
        wi, _pdf, _li, dist, _ = jwf._light_sample(
            lj, static["world_radius"], _jv(hp), _jv(nrm), jnp.asarray(u1),
            jnp.asarray(u2))
        wi_np, tmax = _np(wi), np.asarray(dist) - np.float32(2e-3)
        rays_j.append((_jv(wi_np), jnp.asarray(tmax)))
        rays_t.append((_tv(wi_np), torch.from_numpy(tmax)))
    cfg = twf.KernelConfig(shadow="robust" if robust else "parity")
    skips, sph = twf._occl_skips(ts, cfg)
    ref = jwf._any_hit_multi(static, _jv(hp), _jv(nrm), rays_j, skips,
                             robust=robust, sphere_skips=sph if robust
                             else None)
    got = twf._any_hit_multi(ts, _tv(hp), _tv(nrm), rays_t, skips,
                             robust=robust, sphere_skips=sph if robust
                             else None)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    # the single-light sweep from the offset origin
    if rays_j:
        o_j = jwf._offset_origin(_jv(hp), _jv(nrm), rays_j[0][0])
        o_t = twf._offset_origin(_tv(hp), _tv(nrm), rays_t[0][0])
        np.testing.assert_array_equal(
            np.asarray(jwf._any_hit(static, o_j, rays_j[0][0], rays_j[0][1])),
            twf._any_hit(ts, o_t, rays_t[0][0], rays_t[0][1]).numpy())


def test_light_samples(scene_pair):
    jsc, tsc, static, (o, d, _, _) = scene_pair
    ts, a, _ = _hits(scene_pair)
    rng = np.random.default_rng(5)
    p = rng.normal(size=(N, 3)).astype(np.float32) * 2
    n = rng.normal(size=(N, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    u1, u2 = (rng.random(N).astype(np.float32) for _ in range(2))
    for lj, lt in zip(static["lights"], ts["lights"]):
        sj = jwf._light_sample(lj, static["world_radius"], _jv(p), _jv(n),
                               jnp.asarray(u1), jnp.asarray(u2))
        st = twf._light_sample(lt, ts["world_radius"], _tv(p), _tv(n),
                               torch.from_numpy(u1), torch.from_numpy(u2))
        np.testing.assert_allclose(_np(sj[0]), _np(st[0]), atol=2e-5)
        for k in (1, 2, 3):
            np.testing.assert_allclose(
                np.broadcast_to(np.asarray(sj[k]), (N,)), st[k].numpy(),
                rtol=2e-3, atol=1e-5)
        assert (sj[4] is None) == (st[4] is None)
        li = np.full(N, static["lights"].index(lj), np.int32)
        t = np.abs(rng.normal(size=N)).astype(np.float32) + 0.5
        np.testing.assert_allclose(
            np.asarray(jwf._hit_light_pdf(static["lights"], jnp.asarray(li),
                                          _jv(p), _jv(n), jnp.asarray(t),
                                          _jv(n))),
            twf._hit_light_pdf(ts["lights"], torch.from_numpy(li), _tv(p),
                               _tv(n), torch.from_numpy(t), _tv(n)).numpy(),
            rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(jwf._light_pdf(lj, _jv(p), _jv(n), sj[0])),
            twf._light_pdf(lt, _tv(p), _tv(n), st[0]).numpy(),
            rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("kind", [jbsdf.LAMBERT, jbsdf.MIRROR, jbsdf.GLASS,
                                  jbsdf.PHONG])
@pytest.mark.parametrize("static_exp", [None, 90.0])
def test_bsdf_sample(kind, static_exp):
    rng = np.random.default_rng(3)
    wo = rng.normal(size=(N, 3))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    u1, u2 = (rng.random(N).astype(np.float32) for _ in range(2))
    col = np.tile(np.float32([[0.8, 0.6, 0.4]]), (N, 1))
    col2 = np.tile(np.float32([[0.5, 0.7, 0.9]]), (N, 1))
    eta = np.full(N, 1.6, np.float32)
    expo = np.full(N, 32.0, np.float32)
    ref = jwf._bsdf_sample(jnp.full(N, kind, jnp.int32), _jv(col), _jv(col2),
                           jnp.asarray(eta), jnp.asarray(expo), _jv(wo),
                           jnp.asarray(u1), jnp.asarray(u2),
                           static_exp=static_exp)
    got = twf._bsdf_sample(torch.full((N,), kind), _tv(col), _tv(col2),
                           torch.from_numpy(eta), torch.from_numpy(expo),
                           _tv(wo), torch.from_numpy(u1), torch.from_numpy(u2),
                           static_exp=static_exp)
    np.testing.assert_allclose(_np(ref[0]), _np(got[0]), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(_np(ref[1]), _np(got[1]), atol=2e-5)
    np.testing.assert_allclose(np.broadcast_to(np.asarray(ref[2]), (N,)),
                               got[2].numpy(), rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref[3]), got[3].numpy())


def test_bsdf_eval():
    rng = np.random.default_rng(5)
    wo, wi = (rng.normal(size=(N, 3)) for _ in range(2))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    col = np.tile(np.float32([[0.8, 0.6, 0.4]]), (N, 1))
    expo = np.full(N, 12.0, np.float32)
    for kind in (jbsdf.LAMBERT, jbsdf.PHONG):
        ref = jwf._bsdf_eval_pdf(jnp.full(N, kind, jnp.int32), _jv(col),
                                 jnp.asarray(expo), _jv(wo), _jv(wi))
        got = twf._bsdf_eval_pdf(torch.full((N,), kind), _tv(col),
                                 torch.from_numpy(expo), _tv(wo), _tv(wi))
        np.testing.assert_allclose(_np(ref[0]), _np(got[0]), rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(ref[1]), got[1].numpy(),
                                   rtol=2e-4, atol=1e-6)


def test_pack_tables_layout():
    """The flat tables the CUDA kernel reads decode to the static dict."""
    scene = tb.cornell_box(ALL_LIGHTS | {jb.LIGHT_AREA}, 8, 8)
    cfg = twf.KernelConfig(shadow="robust")
    t = twf.pack_tables(scene, cfg)
    st = t.static
    f, i = t.f.numpy(), t.i.numpy()
    n_pl, n_sp, M, L = (int(v) for v in i[:4])
    assert (n_pl, n_sp, M, L) == (len(st["planar"]), len(st["spheres"]),
                                  len(st["mats"]["kind"]), len(st["lights"]))
    rows, sph = twf._occl_skips(st, cfg)
    for r, s in enumerate(st["planar"]):
        rec = i[twf.HDR_I + twf.PL_I * r:][:twf.PL_I]
        assert rec[0] == s["kind"] and rec[1] == int(s["fast"])
        assert rec[2] == sum(1 << k for k in range(L) if r in rows[k])
        fr = f[twf.HDR_F + twf.PL_F * r:][:twf.PL_F]
        np.testing.assert_array_equal(fr[0:3], np.float32(s["n"]))
        np.testing.assert_array_equal(fr[25:28], twf._planar_consts(s))
    lt0 = twf.HDR_I + twf.PL_I * n_pl + twf.SP_I * n_sp + twf.MAT_I * M
    for k, lt in enumerate(st["lights"]):
        assert i[lt0 + twf.LT_I * k] == lt["kind"]


# ---- the whole kernel --------------------------------------------------------

# every sampler, NEE mode and shadow mode on each scene
CONFIGS = [("random", "all", "parity"), ("hash", "single", "robust")]


@pytest.mark.parametrize("name", ["cornell", "cornell_lights"])
@pytest.mark.parametrize("sampler, nee, shadow", CONFIGS)
def test_trace_lanes_plain_matches_interpreted_kernel(name, sampler, nee,
                                                      shadow):
    got, ref = trace_both(name, sampler, nee, shadow)
    lanes_agree(got, ref)
