"""The path-tracing megakernels (kytpu/kernels/wavefront.py): the forward
K1, the residual forward K2, the coefficient-cache backward K3 and the
path-replay backward K4.

Three layers, each the counterpart of one in the JAX package:

- host side: `KernelConfig`, `extract_static` (the scene as python values,
  the same dict as the JAX package's) and `pack_tables`, which flattens it
  into two device tables. Every scene-dependent decision that the Pallas
  kernel builder `_make_kernel` makes at trace time (lobes present, static
  Phong exponent, occlusion-skip rows, sphere-light inside branch, which
  lights carry a direction-free hit pdf, ...) is a field of those tables,
  read by the CUDA kernel at run time;
- `trace_lanes_plain`, a plain torch transcription of the forward
  `_make_kernel(grad=False)` on (N,) lane tensors, with residual=True also
  writing the coefficient cache (K2), and `bwd_res_plain`, that of
  `_make_bwd_res_kernel` (K3), and `bwd_replay_plain`, that of
  `_make_kernel(grad=True)` (K4), which replays the forward's arithmetic
  and draws. CPU tensors run them, and the card checks the kernels against
  them;
- the wrappers (`trace_lanes`, `bwd_res`, `bwd_replay`, `make_cuda_tracer`,
  `render_lanes_cuda`, `render_cuda`, and `make_cuda_diff_tracer`, a
  torch.autograd.Function over K2 and K3, or over K1 and K4), which launch
  `csrc/wavefront_fwd.cu` (K1, K2, K4) and `csrc/wavefront_bwd_res.cu`
  (K3) on CUDA tensors.

Samplers: "hash" (stateless lowbias32 streams keyed by (seed, pixel,
sample, draw site)) is the JAX package's own. "random" on the TPU is the
on-core PRNG, which has no counterpart; here it is the tile-keyed hash
stream the JAX package runs under interpret (`_Rng(hw=False)`), so the port
matches interpret mode bit for bit at the integer level, not the TPU's
stream. "sobol" is the JAX package's hash-based Owen-scrambled (0,2)
sequence: every draw site (the draw counter) shuffles and scrambles the
lane's sample index with three splitmix64 words of the counter. Tiles are
`cfg.rows * 128` consecutive lanes, as in the JAX package.

cfg.trainable_exponent reads the Phong exponents from a per-call (M,)
table (`SceneTables.exponent`, plastic rows only) instead of baking them,
adds the kappa-weighted "Bk"/"tuk" planes to K2's cache, and gives K3 and
K4 an exponent adjoint.

K1-K4 take any surface count, as kytpu's baked kernels do: render() and
make_train_step() run them past 64 surfaces on the scenes the big-scene
tables refuse. There K3 and K4 write row-tagged adjoint entries summed by
row, as K7 and K8 do (`row_tagged`, DENSE_MAX_ROWS), and K2's int cache
keeps the row in 23 bits (`pack_row`).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import lds
from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.kernels.v3 import (V3, cv3, make_frame, to_local, to_world,
                                    v3_full, v3_zeros)
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes
from kytpu_torch.scene import texture as ktex

LANE = 128
# past this many surfaces render() and make_train_step() run a scene on the
# table kernels K5-K8 where their tables take it, as kytpu routes (K1-K4
# take any surface count)
TABLE_ROUTE_SURFACES = 64
# K3 and K4 sum a scene of at most this many surfaces in a dense row of
# adjoint columns a thread (csrc/lane_sum.cuh MAX_COLS), and a larger one
# as row-tagged entries summed by row, as K7 and K8 do (`row_tagged`)
DENSE_MAX_ROWS = 64
# K3 and K4 keep 6 checker-adjoint columns a texture in a thread
# (csrc/lane_sum.cuh MAX_COLS, ROW_COLS)
MAX_TEXTURES = 64
# the kernels keep one skip bit per light in an int32 table field
# (csrc/wavefront_fwd.cu) and per-light arrays (csrc/bigscene_fwd.cu)
MAX_LIGHTS = 32
# K1, K2 and K4 stage a scene's tables in a block's shared memory up to
# this many bytes (csrc/wavefront_fwd.cu STAGE_BUDGET): the most a block
# takes without opting in; larger tables stay in device memory
STAGE_BUDGET = 48 * 1024
# K1, K2 and K4 sample, sweep and accumulate the nee="all" shadow rays of a
# vertex in chunks of at most NEE_CHUNK lights (csrc/wavefront_fwd.cu)
NEE_CHUNK = 8
# K1 and K2 refill the threads of dead lanes with the next lanes of their
# warp's chunk on scenes of at most this many surfaces. Past it the
# occlusion sweeps run over hundreds of rows and end at each ray's first
# occluder, and a refilled warp's lanes, from all over the frame, end them
# far apart: random_spheres(1024) with a 16x16 ground atlas took 33.1 ms
# with refill and 23.4 without (K1, 1M lanes, depth 3, H100).
REFILL_MAX_ROWS = 64


@dataclass(frozen=True)
class KernelConfig:
    """Same fields and defaults as kytpu.kernels.wavefront.KernelConfig.
    The port's kernels take max_depth, rr_start, rows, nee ("all" |
    "single"), sampler ("random" | "hash" | "sobol"), shadow ("parity" |
    "robust") and trainable_exponent. bwd_rows changes nothing here: K3
    reads no tile (the nee="single" pick comes from the cache). cull
    ("off" | "cone" | "cone+nee") and sweep ("auto" | "scalar" | "mxu") are
    read as names only: the big-scene kernels (kernels/bigscene.py) run one
    sweep, with the scalar sweep's arithmetic, and no cone cull, which
    kytpu's own tests pin as changing no result. The big-scene kernels
    ignore nee: they always sample every light, as kytpu's do."""

    max_depth: int = 5
    rr_start: int = 3
    rows: int = 16
    bwd_rows: int = 0
    nee: str = "all"
    sampler: str = "random"
    shadow: str = "parity"
    trainable_exponent: bool = False
    cull: str = "cone"
    sweep: str = "auto"


def check_config(cfg: KernelConfig) -> None:
    if cfg.sampler not in ("random", "hash", "sobol") or cfg.nee not in (
            "all", "single") or cfg.shadow not in ("parity", "robust"):
        raise ValueError(f"unsupported kernel config {cfg}")
    if cfg.rows < 1 or cfg.max_depth < 0:
        raise ValueError(f"unsupported kernel config {cfg}")
    if cfg.cull not in ("off", "cone", "cone+nee") or cfg.sweep not in (
            "auto", "scalar", "mxu"):
        raise ValueError(f"unsupported kernel config {cfg}")


# ---------------------------------------------------------------------------
# host side: the scene as python values
# ---------------------------------------------------------------------------


def _f(x):
    return np.asarray(x).reshape(-1).tolist()


def _f32(x) -> float:
    return float(np.float32(x))


def _dual_basis(e1, e2):
    """In-plane dual vectors f1, f2 with (a e1 + b e2).f1 == a etc."""
    e11 = float(np.dot(e1, e1))
    e22 = float(np.dot(e2, e2))
    e12 = float(np.dot(e1, e2))
    det = e11 * e22 - e12 * e12
    f1 = (e22 * e1 - e12 * e2) / det
    f2 = (e11 * e2 - e12 * e1) / det
    return f1, f2


def _surface_inside_ball_possible(planar, spheres, c, r):
    """Conservative: can any scene surface point lie strictly inside the
    ball (c, r)? If not, a sphere light's inside branch is dead. The
    light's own coincident sphere contributes boundary points only."""
    c = np.asarray(c, np.float64)
    for s in planar:
        pts = [np.asarray(s[k], np.float64) for k in ("p0", "p1", "p2", "p3")]
        if s["kind"] == kshapes.TRI:
            pts = pts[:3]
        n = np.asarray(s["n"], np.float64)
        n = n / max(np.linalg.norm(n), 1e-30)
        if abs(np.dot(n, c - pts[0])) >= r:
            continue
        centroid = np.mean(pts, axis=0)
        circum = max(np.linalg.norm(p - centroid) for p in pts)
        if np.linalg.norm(c - centroid) < r + circum:
            return True
    for s in spheres:
        ci = np.asarray(s["c"], np.float64)
        dist = np.linalg.norm(ci - c)
        if dist < 1e-9 and abs(s["r"] - r) < 1e-9:
            continue
        if abs(dist - s["r"]) < r:
            return True
    return False


def extract_static(scene: kscene.Scene, occl_skip: bool = True) -> dict:
    """The scene as python values: the same dict that
    kytpu.kernels.wavefront.extract_static returns, texture records
    included. occl_skip=False leaves out the per-light occlusion-skip proofs
    (an O(rows^2) host loop that only K1's sweeps read): every set is
    empty."""
    g = scene.geometry
    npg = {k: getattr(g, k).detach().cpu().numpy()
           for k in ("pl_kind", "pl_p0", "pl_p1", "pl_p2", "pl_p3",
                     "pl_normal", "pl_radius", "sp_center", "sp_radius")}
    planar = []
    for i in range(g.n_planar):
        kind = int(npg["pl_kind"][i])
        p0, p1, p2, p3 = (np.asarray(npg[f"pl_p{j}"][i], np.float64)
                          for j in range(4))
        rec = dict(kind=kind, p0=_f(p0), p1=_f(p1), p2=_f(p2), p3=_f(p3),
                   n=_f(npg["pl_normal"][i]),
                   radius=float(npg["pl_radius"][i]))
        # dual bases of the 2D inclusion fast path; rects must be
        # parallelograms for it to equal the 4-edge quad test
        if kind == kshapes.TRI:
            f1, f2 = _dual_basis(p1 - p0, p2 - p0)
            rec.update(anchor=_f(p0), f1=_f(f1), f2=_f(f2), fast=True)
        elif kind == kshapes.RECT and \
                np.allclose(p3, p0 + p2 - p1, rtol=1e-5, atol=1e-7):
            f1, f2 = _dual_basis(p0 - p1, p2 - p1)
            rec.update(anchor=_f(p1), f1=_f(f1), f2=_f(f2), fast=True)
        else:
            rec.update(fast=False)
        if kind == kshapes.TRI:
            uf1, uf2 = _dual_basis(p1 - p0, p2 - p0)
            rec.update(uv_anchor=_f(p0), uv_f1=_f(uf1), uv_f2=_f(uf2))
        elif kind == kshapes.RECT:
            uf1, uf2 = _dual_basis(p0 - p1, p2 - p1)
            rec.update(uv_anchor=_f(p1), uv_f1=_f(uf1), uv_f2=_f(uf2))
        else:
            nn = np.asarray(rec["n"], np.float64)
            nn = nn / np.linalg.norm(nn)
            helper = (np.array([0.0, 1.0, 0.0]) if abs(nn[0]) > 0.99
                      else np.array([1.0, 0.0, 0.0]))
            tt = np.cross(nn, helper)
            tt = tt / np.linalg.norm(tt)
            ss = np.cross(tt, nn)
            inv2r = 0.5 / max(rec["radius"], 1e-12)
            rec.update(uv_anchor=_f(p0), uv_f1=_f(ss * inv2r),
                       uv_f2=_f(tt * inv2r), uv_disk=True)
        planar.append(rec)
    spheres = [dict(c=_f(npg["sp_center"][i]), r=float(npg["sp_radius"][i]))
               for i in range(g.n_sphere)]

    tab = lambda t: t.detach().cpu().numpy()  # noqa: E731
    mats = dict(
        kind=[int(k) for k in tab(scene.mat_kind)],
        exponent=[float(v) for v in tab(scene.mat_exponent)],
        eta=[float(v) for v in tab(scene.mat_eta)],
        d_prob=[float(v) for v in tab(scene.mat_d_prob)],
        s_prob=[float(v) for v in tab(scene.mat_s_prob)],
        light_index=[int(v) for v in tab(scene.light_index)],
    )
    mk = set(mats["kind"])
    lobes = set()
    if kbsdf.MAT_MATTE in mk or kbsdf.MAT_PLASTIC in mk:
        lobes.add(kbsdf.LAMBERT)
    if kbsdf.MAT_PLASTIC in mk:
        lobes.add(kbsdf.PHONG)
    if kbsdf.MAT_MIRROR in mk:
        lobes.add(kbsdf.MIRROR)
    if kbsdf.MAT_GLASS in mk:
        lobes.add(kbsdf.GLASS)
    mats["lobes"] = frozenset(lobes)
    li = scene.lights
    lights = []
    for i, kind in enumerate(li.kinds):
        row = lambda name: tab(getattr(li, name))[i]  # noqa: E731
        rec = dict(kind=int(kind), position=_f(row("position")),
                   direction=_f(row("direction")), p0=_f(row("p0")),
                   p1=_f(row("p1")), p2=_f(row("p2")), p3=_f(row("p3")),
                   normal=_f(row("normal")), area=float(row("area")),
                   center=_f(row("center")), radius=float(row("radius")))
        if int(kind) == klights.AREA_SPHERE:
            rec["inside_possible"] = _surface_inside_ball_possible(
                planar, spheres, rec["center"], rec["radius"])
        lights.append(rec)
    # a sphere light's own shape stays in its NEE occlusion sweep under
    # shadow="parity" (the reference's self-occlusion quirk, ky.cpp:3193)
    skips = (_occl_skip_rows(planar, spheres, mats, lights) if occl_skip
             else [set() for _ in lights])
    # texture bindings: one record a textured row. Image rows carry the
    # atlas geometry; "sep" marks the atlases that kytpu fetches with its
    # separable matmul route (past the select chain's 64 texels, or a side
    # that is not a power of two), whose addition order the port keeps
    textures, n_textures, n_texels = [], 0, 0
    if scene.has_textures:
        tx = scene.textures
        n_textures = tx.n_textures
        tex_id, tscale = tab(scene.tex_id), tab(tx.scale)
        tkind, timg_idx = tab(tx.kind), tab(tx.image_index)
        ti_n, th, tw = (int(v) for v in tx.image.shape[:3])
        n_texels = ti_n * th * tw
        for m, ti in enumerate(int(v) for v in tex_id):
            if ti < 0:
                continue
            rec = dict(row=m, tex=ti,
                       kind=("image" if int(tkind[ti]) == ktex.IMAGE
                             else "checker"),
                       scale=(float(tscale[ti, 0]), float(tscale[ti, 1])))
            if rec["kind"] == "image":
                sep = (th * tw > KERNEL_MAX_TEXELS or (th & (th - 1)) != 0
                       or (tw & (tw - 1)) != 0)
                rec.update(img=int(timg_idx[ti]), tw=tw, th=th, sep=sep)
            textures.append(rec)
    n_images = (int(scene.textures.image.shape[0])
                if any(r["kind"] == "image" for r in textures) else 0)
    return dict(planar=planar, spheres=spheres, mats=mats, lights=lights,
                world_radius=float(tab(scene.world_radius)),
                has_env=scene.has_env, textures=textures,
                n_textures=n_textures, n_texels=n_texels, n_images=n_images,
                occl_skip=skips)


def _n_tex(static) -> int:
    """The textures whose checker adjoints K3 and K4 keep: all of a
    textured scene's, none of another's."""
    return static["n_textures"] if static["textures"] else 0


def _has_img(static) -> bool:
    """Whether a row of the scene reads an image texture."""
    return static["n_images"] > 0


# kytpu's in-kernel texture limits: its select-chain fetch takes atlases of
# at most 64 texels with power-of-two sides, its separable fetch any atlas
# of at most 256 x 256 texels an image. The port fetches every atlas with
# one four-tap gather and keeps each route's addition order.
KERNEL_MAX_TEXELS = 64
KERNEL_SEP_MAX_TEXELS = 256 * 256


def kernel_texture_support(scene: kscene.Scene):
    """None if the kernels evaluate this scene's textures (checkers, or
    images of at most KERNEL_SEP_MAX_TEXELS texels, on planar surfaces),
    else the reason (kytpu's `_kernel_texture_support`)."""
    if not scene.has_textures:
        return None
    tex_id = scene.tex_id.tolist()
    kinds = scene.textures.kind.tolist()
    n_planar = scene.geometry.n_planar
    for m, ti in enumerate(tex_id):
        if ti < 0:
            continue
        if kinds[ti] == ktex.IMAGE:
            th, tw = scene.textures.image.shape[1:3]
            if th * tw > KERNEL_SEP_MAX_TEXELS:
                return (f"the kernels fetch image textures of at most "
                        f"{KERNEL_SEP_MAX_TEXELS} texels ({th}x{tw} given), "
                        "as kytpu's megakernel does; larger images need the "
                        "jnp engines (ROADMAP item M7)")
        if m >= n_planar:
            return ("the kernels evaluate textures on planar surfaces only, "
                    "as kytpu's megakernel does; sphere UV textures need the "
                    "jnp engines (ROADMAP item M7)")
    return None


def _occl_skip_rows(planar, spheres, mats, lights):
    """Per-light sets of planar rows proven unable to occlude any of that
    light's NEE shadow rays (kytpu's `_occl_skip_rows`): every light sample
    lies strictly on one side of the row's plane, and every shadow-ray
    origin (a shading point offset by RAY_OFFSET along its own normal)
    stays on that side too. Direction and environment lights skip nothing,
    and a light's own emitting surface is never skipped."""
    skips = [set() for _ in lights]
    if not lights:
        return skips

    def _poly_pts(s):
        k = 3 if s["kind"] == kshapes.TRI else 4
        return [np.asarray(s[f"p{j}"], np.float64) for j in range(k)]

    for row, s in enumerate(planar):
        n = np.asarray(s["n"], np.float64)
        nl = np.linalg.norm(n)
        if nl < 1e-12:
            continue
        n = n / nl
        c = float(np.dot(n, np.asarray(s["p0"], np.float64)))
        lo = hi = 0.0
        for u_row, u in enumerate(planar):
            if u_row == row:
                continue
            nu = np.asarray(u["n"], np.float64)
            nu = nu / max(np.linalg.norm(nu), 1e-30)
            exc = km.RAY_OFFSET * abs(float(np.dot(n, nu)))
            if u["kind"] == kshapes.DISK:
                d0 = float(np.dot(n, np.asarray(u["p0"], np.float64))) - c
                r_in = u["radius"] * float(
                    np.sqrt(max(0.0, 1.0 - np.dot(n, nu) ** 2)))
                dmin, dmax = d0 - r_in, d0 + r_in
            else:
                ds = [float(np.dot(n, p)) - c for p in _poly_pts(u)]
                dmin, dmax = min(ds), max(ds)
            lo = min(lo, dmin - exc)
            hi = max(hi, dmax + exc)
        for sp in spheres:
            d0 = float(np.dot(n, np.asarray(sp["c"], np.float64))) - c
            lo = min(lo, d0 - sp["r"] - km.RAY_OFFSET)
            hi = max(hi, d0 + sp["r"] + km.RAY_OFFSET)

        for i, lt in enumerate(lights):
            kind = lt["kind"]
            if kind in (klights.DIRECTION, klights.ENV):
                continue
            if mats["light_index"][row] == i:
                continue
            if kind == klights.POINT:
                q = [float(np.dot(n, np.asarray(lt["position"],
                                                np.float64))) - c] * 2
            elif kind == klights.AREA_RECT:
                dq = [float(np.dot(n, np.asarray(lt[f"p{j}"], np.float64)))
                      - c for j in range(4)]
                q = [min(dq), max(dq)]
            else:
                d0 = float(np.dot(n, np.asarray(lt["center"],
                                                np.float64))) - c
                q = [d0 - lt["radius"], d0 + lt["radius"]]
            if q[0] >= 1e-3 and lo >= -1e-6:
                skips[i].add(row)
            elif q[1] <= -1e-3 and hi <= 1e-6:
                skips[i].add(row)
    return skips


def _static_exponent(mats):
    """The one integer Phong exponent shared by every glossy surface, or
    None (then the kernel evaluates pow with the per-row exponent)."""
    vals = {float(v) for v in mats["exponent"] if float(v) != 0.0}
    if len(vals) == 1:
        e = vals.pop()
        if e.is_integer() and 1.0 <= e <= 1e6:
            return e
    return None


def _light_rows(static) -> dict:
    """light index -> its first emitting surface row."""
    light_row = {}
    for m, li in enumerate(static["mats"]["light_index"]):
        if li >= 0 and li not in light_row:
            light_row[li] = m
    return light_row


def _occl_skips(static, cfg: KernelConfig):
    """Per-light (planar rows, sphere indices) left out of the all-lights
    shadow sweep: `_occl_skip_rows`, plus under shadow="robust" the light's
    own emitting shape."""
    n_pl = len(static["planar"])
    light_row = _light_rows(static)
    rows_out, sph_out = [], []
    for i in range(len(static["lights"])):
        rows = set(static["occl_skip"][i])
        sph = set()
        if cfg.shadow == "robust":
            r = light_row.get(i, -1)
            if 0 <= r < n_pl:
                rows.add(r)
            elif r >= n_pl:
                sph.add(r - n_pl)
        rows_out.append(frozenset(rows))
        sph_out.append(frozenset(sph))
    return rows_out, sph_out


def _planar_consts(s):
    """Host-folded float32 constants of one fast-path planar row: the plane
    offset n.anchor and the dual-basis offsets f1.anchor, f2.anchor, all
    taken in float64 from the unrounded dual basis (wavefront.py:656,
    :863-865)."""
    anchor = np.asarray(s["anchor"], np.float64)
    return (_f32(np.dot(s["n"], anchor)), _f32(np.dot(s["f1"], anchor)),
            _f32(np.dot(s["f2"], anchor)))


def _sphere_area_f32(r: float) -> float:
    """np.float32(4.0 * np.pi * r * r) with r an np.float32: under numpy's
    scalar promotion every product rounds to float32 (_light_sample)."""
    r32 = np.float32(r)
    return float(np.float32(4.0 * np.pi) * r32 * r32)


# ---------------------------------------------------------------------------
# host side: the flat device tables the CUDA kernel reads
# ---------------------------------------------------------------------------

# int table: header, then per planar row, per sphere, per material row,
# per light, per texture record (offsets derived from the counts, see
# csrc/megakernel.cuh `Scene`). Header: n_pl, n_sp, M, L, lobe bits,
# has_plastic, has_glass, has_delta, static exponent, env light index, any
# azimuth, use_phits, single, trainable_exponent, texture records, textures,
# image textures
HDR_I = 17
PL_I = 4     # kind, fast, all-lights skip bitmask, single-mode skip
SP_I = 1     # all-lights skip bitmask
MAT_I = 3    # material kind, light index, texture record (-1: none)
LT_I = 3     # kind, inside_possible, emitting row
TX_I = 6     # kind (0 checker, 1 image), texture, image, width, height, sep
# float table
HDR_F = 4    # 2 * world_radius, then the static exponent's 1/(e+1),
             # (e+2)/2pi and (e+1)/2pi
PL_F = 32    # n, p0, p1, p2, p3, radius^2, anchor, f1, f2, c_n, c_1, c_2
SP_F = 8     # c, r, r*r, 1/r
MAT_F = 4    # exponent, eta, d_prob, s_prob
LT_F = 28    # position, direction, p0, p1, p2, normal, area, center,
             # radius, 4 pi r^2 (float32 products), 4 pi r^2 (float64)
TX_F = 12    # uv anchor, uv dual basis 1, 2, disk flag, uv scale (2)


@dataclass(frozen=True)
class SceneTables:
    """What one kernel launch reads: the scene as python values (`static`,
    for the plain version), its flat int32/float32 device tables, and the
    tables a render may change without repacking. `exponent` is read only
    under cfg.trainable_exponent, and only on plastic rows; texa, texb and
    timg only on textured rows (one zero row each in an untextured
    scene)."""

    static: dict
    f: torch.Tensor
    i: torch.Tensor
    diffuse: torch.Tensor     # (M, 3)
    specular: torch.Tensor    # (M, 3)
    emission: torch.Tensor    # (M, 3)
    exponent: torch.Tensor    # (M,)
    light_emit: torch.Tensor  # (max(L, 1), 3)
    env: torch.Tensor         # (3,)
    texa: torch.Tensor        # (max(T, 1), 3) checker "even" colours
    texb: torch.Tensor        # (max(T, 1), 3) checker "odd" colours
    timg: torch.Tensor        # (max(Ti H W, 1), 3) the texel atlas

    def with_colors(self, scene: kscene.Scene) -> "SceneTables":
        return dataclasses.replace(self, **_color_tables(scene),
                                   **_texture_tables(scene))

    @property
    def stage_bytes(self) -> int:
        """Bytes of the tables K1, K2 and K4 copy into a block's shared
        memory (csrc/wavefront_fwd.cu `stage_scene`): f, i, the colour,
        emission, exponent, light and env tables and, in a textured scene,
        texa and texb; 0 where they pass STAGE_BUDGET and the kernels read
        them from device memory. Veach's and Cornell's take about 2.6 KB;
        random_spheres(1024) with a 16x16 ground atlas (1,026 surfaces, the
        largest scene that reaches K1) about 107 KB."""
        names = ("f", "i", "diffuse", "specular", "emission", "exponent",
                 "light_emit", "env") + (
                     ("texa", "texb") if self.static["textures"] else ())
        n = 4 * sum(getattr(self, nm).numel() for nm in names)
        return n if n <= STAGE_BUDGET else 0


def _color_tables(scene: kscene.Scene) -> dict:
    dev = scene.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()  # noqa
    emit = (scene.lights.emit if scene.n_lights
            else torch.zeros((1, 3), device=dev))
    env = (scene.env_radiance_ if scene.has_env
           else torch.zeros(3, device=dev))
    return dict(diffuse=f32(scene.mat_diffuse),
                specular=f32(scene.mat_specular),
                emission=f32(scene.emission),
                exponent=f32(scene.mat_exponent), light_emit=f32(emit),
                env=f32(env).reshape(3))


def _texture_tables(scene: kscene.Scene, texa=None, texb=None,
                    timg=None) -> dict:
    """The texture tables a launch reads (`SceneTables` texa, texb, timg),
    from the scene's textures or the given leaves; one zero row each where
    the scene has none, so every pointer is valid."""
    tx = scene.textures if scene.has_textures else None
    dev = scene.device

    def tab(v, name):
        if v is None and tx is not None:
            v = getattr(tx, name)
        if v is None or not v.numel():
            return torch.zeros((1, 3), dtype=torch.float32, device=dev)
        return v.detach().to(device=dev, dtype=torch.float32).reshape(
            -1, 3).contiguous()

    return dict(texa=tab(texa, "color_a"), texb=tab(texb, "color_b"),
                timg=tab(timg, "image"))


def check_lights(n_lights: int) -> None:
    if n_lights > MAX_LIGHTS:
        raise NotImplementedError(
            f"{n_lights} lights: the CUDA kernels take at most {MAX_LIGHTS}; "
            "more lights are ROADMAP item M12 of the port")


def check_textures(static) -> None:
    if static["n_textures"] > MAX_TEXTURES:
        raise NotImplementedError(
            f"{static['n_textures']} textures: the backwards keep the "
            f"checker adjoints of at most {MAX_TEXTURES} in a thread (ROADMAP "
            "section 3)")


def row_tagged(static) -> bool:
    """Do K3 and K4 write row-tagged entries (past DENSE_MAX_ROWS
    surfaces) instead of a dense row of adjoint columns a thread?"""
    return len(static["mats"]["kind"]) > DENSE_MAX_ROWS


def pack_row(r1):
    """The row field of K2's int cache plane: r1 = row + 1 (0 on a miss) in
    bits 0-7 as kytpu writes it, and past 255 its high part in bits 16-30,
    above the lobe (8, 9), parity (10) and pick (11-15) bits."""
    return (r1 & 255) | ((r1 >> 8) << 16)


def unpack_row(ib):
    """row + 1 of a K2 int cache entry (`pack_row`)."""
    return (ib & 255) | ((ib >> 16) << 8)


def pack_header(static, cfg: KernelConfig, counts, static_exp):
    """(int, float) header tables and the light records after them, the part
    of `pack_tables` that the light sampling and BSDF code of
    csrc/megakernel.cuh reads. counts: (planar rows, spheres, material
    rows) the caller's records take between the header and the lights;
    static_exp: the one static Phong exponent, or None."""
    mats, lights = static["mats"], static["lights"]
    L = len(lights)
    check_lights(L)
    env_i = next((i for i, lt in enumerate(lights)
                  if lt["kind"] == klights.ENV), -1)
    lobes = mats["lobes"]
    hi = np.zeros(HDR_I, np.int32)
    hf = np.zeros(HDR_F, np.float32)
    hi[:] = [
        *counts, L,
        sum(1 << k for k in lobes),
        int(kbsdf.MAT_PLASTIC in mats["kind"]),
        int(kbsdf.MAT_GLASS in mats["kind"]),
        int(bool(lobes & {kbsdf.MIRROR, kbsdf.GLASS})),
        int(static_exp) if static_exp is not None else 0,
        env_i,
        int(any(lt["kind"] in (klights.AREA_SPHERE, klights.ENV)
                for lt in lights)),
        int(_phit_lights(lights)),
        int(picks_one_light(cfg, L)),
        int(cfg.trainable_exponent),
        len(static["textures"]),
        _n_tex(static),
        int(_has_img(static)),
    ]
    hf[0] = _f32(2.0 * static["world_radius"])
    if static_exp is not None:
        hf[1:4] = [_f32(1.0 / (static_exp + 1.0)),
                   _f32((static_exp + 2.0) * km.INV_2PI),
                   _f32((static_exp + 1.0) * km.INV_2PI)]
    light_row = _light_rows(static)
    li = np.zeros(LT_I * L, np.int32)
    lf = np.zeros(LT_F * L, np.float32)
    for i, lt in enumerate(lights):
        li[LT_I * i:LT_I * (i + 1)] = [
            lt["kind"], int(lt.get("inside_possible", True)),
            light_row.get(i, -1)]
        lf[LT_F * i:LT_F * i + 25] = [
            *lt["position"], *lt["direction"], *lt["p0"], *lt["p1"],
            *lt["p2"], *lt["normal"], lt["area"], *lt["center"],
            lt["radius"], _sphere_area_f32(lt["radius"]),
            _f32(4.0 * np.pi * lt["radius"] ** 2)]
    return (hi, hf), (li, lf)


def pack_tables(scene: kscene.Scene, cfg: KernelConfig) -> SceneTables:
    tex_err = kernel_texture_support(scene)
    if tex_err:
        raise NotImplementedError(tex_err)
    static = extract_static(scene)
    planar, spheres = static["planar"], static["spheres"]
    mats, lights = static["mats"], static["lights"]
    n_pl, n_sp, M, L = len(planar), len(spheres), len(mats["kind"]), len(lights)
    check_textures(static)
    rows_skip, sph_skip = _occl_skips(static, cfg)
    single_skip = (frozenset.intersection(
        *[frozenset(s) for s in static["occl_skip"]]) if L else frozenset())
    # under trainable_exponent the exponents come from the per-call table
    static_exp = None if cfg.trainable_exponent else _static_exponent(mats)
    (hi, hf), (li, lf) = pack_header(static, cfg, (n_pl, n_sp, M), static_exp)

    it = np.concatenate([hi, np.zeros(PL_I * n_pl + SP_I * n_sp + MAT_I * M,
                                      np.int32), li])
    ft = np.concatenate([hf, np.zeros(PL_F * n_pl + SP_F * n_sp + MAT_F * M,
                                      np.float32), lf])
    oi, of = HDR_I, HDR_F
    for row, s in enumerate(planar):
        mask = _i32(sum(1 << k for k in range(L) if row in rows_skip[k]))
        it[oi:oi + PL_I] = [s["kind"], int(bool(s.get("fast"))), mask,
                            int(row in single_skip)]
        rec = ft[of:of + PL_F]
        rec[0:3] = s["n"]
        for j in range(4):
            rec[3 + 3 * j:6 + 3 * j] = s[f"p{j}"]
        rec[15] = _f32(s["radius"] ** 2)
        if s.get("fast"):
            rec[16:19] = s["anchor"]
            rec[19:22] = s["f1"]
            rec[22:25] = s["f2"]
            rec[25:28] = _planar_consts(s)
        oi += PL_I
        of += PL_F
    for j, s in enumerate(spheres):
        it[oi] = _i32(sum(1 << k for k in range(L) if j in sph_skip[k]))
        r32 = np.float32(s["r"])
        ft[of:of + 6] = [*s["c"], r32, r32 * r32, _f32(1.0 / s["r"])]
        oi += SP_I
        of += SP_F
    rec_of_row = texture_record_of_row(static)
    for m in range(M):
        it[oi:oi + MAT_I] = [mats["kind"][m], mats["light_index"][m],
                             rec_of_row[m]]
        ft[of:of + MAT_F] = [mats["exponent"][m], mats["eta"][m],
                             mats["d_prob"][m], mats["s_prob"][m]]
        oi += MAT_I
        of += MAT_F
    ti, tf = texture_records(static)
    dev = scene.device
    return SceneTables(static=static,
                       f=torch.from_numpy(np.concatenate([ft, tf])).to(dev),
                       i=torch.from_numpy(np.concatenate([it, ti])).to(dev),
                       **_color_tables(scene), **_texture_tables(scene))


def texture_record_of_row(static) -> list:
    """Each surface row's texture record (`texture_records`), -1 for
    none."""
    rec = {r["row"]: k for k, r in enumerate(static["textures"])}
    return [rec.get(m, -1) for m in range(len(static["mats"]["kind"]))]


def texture_records(static):
    """(int, float) texture records, one a textured row, that follow the
    light records in the tables (csrc/megakernel.cuh `Scene` TXI, TXF):
    kind, texture, image, width, height, separable route; the row's uv
    anchor and dual basis, disk flag, uv scale."""
    ti = np.zeros(TX_I * len(static["textures"]), np.int32)
    tf = np.zeros(TX_F * len(static["textures"]), np.float32)
    for k, r in enumerate(static["textures"]):
        s = static["planar"][r["row"]]
        ti[TX_I * k:TX_I * (k + 1)] = [
            int(r["kind"] == "image"), r["tex"], r.get("img", 0),
            r.get("tw", 0), r.get("th", 0), int(r.get("sep", False))]
        tf[TX_F * k:TX_F * (k + 1)] = [
            *s["uv_anchor"], *s["uv_f1"], *s["uv_f2"],
            float(bool(s.get("uv_disk"))), *r["scale"]]
    return ti, tf


def picks_one_light(cfg: KernelConfig, n_lights: int) -> bool:
    """Does NEE sample one picked light a bounce (nee="single" with more
    than one light)? Then the cache holds one "B" plane a bounce and the
    pick in resi bits 11-15; else one "B" plane a light. The kernels read
    this from the table header (`pack_tables`)."""
    return cfg.nee == "single" and n_lights > 1


def residual_layout(static, cfg: KernelConfig):
    """Plane order of the coefficient cache that K2 writes and K3 reads
    (kytpu's `_residual_layout`) -> ({tag: plane}, count). Per bounce: "wb"
    (hit-emission MIS weight, fully masked), "wenv" (env-miss weight, env
    scenes), then below the horizon one "B" plane per NEE light (one under
    nee="single": B' = li_scalar * f_unit * |cos| * okf * lobe_scale) and
    "tu" (extension throughput unit incl. lobe scale, pdf division, RR
    compensation and the alive mask). Under cfg.trainable_exponent each "B"
    is followed by its "Bk" and "tu" by its "tuk": the plane times kappa
    (`_kappa`), 0 off phong lanes. A scene with image textures adds "tx" and
    "ty": the continuous texel coordinates of the hit on its image row (0
    elsewhere), from which K3 rebuilds the bilinear taps. The kernels
    compute the same offsets from the table header
    (csrc/wavefront_tables.cuh `ResPlanes`). The int cache holds one plane
    a bounce: row + 1 in bits 0-7 and 16-30 (`pack_row`; kytpu keeps it in
    bits 0-7 alone, which a scene of 255 or more surfaces overflows into
    the lobe bits), lobe_is_phong in bit 8, to_spec in bit 9, the checker
    parity in bit 10 and the nee="single" pick in bits 11-15."""
    check_config(cfg)
    lights = static["lights"]
    has_env = any(lt["kind"] == klights.ENV for lt in lights)
    has_img = _has_img(static)
    n_b = 1 if picks_one_light(cfg, len(lights)) else len(lights)
    texp = cfg.trainable_exponent
    tags = []
    for b in range(cfg.max_depth + 1):
        tags.append(("wb", b))
        if has_env:
            tags.append(("wenv", b))
        if b < cfg.max_depth:
            for i in range(n_b):
                tags.append(("B", b, i))
                if texp:
                    tags.append(("Bk", b, i))
            tags.append(("tu", b))
            if texp:
                tags.append(("tuk", b))
            if has_img:
                tags.append(("tx", b))
                tags.append(("ty", b))
    return {t: k for k, t in enumerate(tags)}, len(tags)


def light_emit_of(scene: kscene.Scene, emission: torch.Tensor,
                  env: torch.Tensor) -> torch.Tensor:
    """(max(L, 1), 3) NEE light emissions derived from the traced
    `emission` rows and `env` (kytpu's `_light_emit_of`): a light bound to
    a surface takes that row's emission, the environment light `env`, the
    others `scene.lights.emit`. The diff tracer reads these, not
    `lights.emit`, so a train step never runs NEE with stale emission."""
    if not scene.n_lights:
        return emission.new_zeros((1, 3))
    rows = scene.lights.surface_ids
    idx = torch.tensor([max(r, 0) for r in rows], device=emission.device)
    has = torch.tensor([r >= 0 for r in rows], device=emission.device)
    emit = torch.where(has[:, None], emission[idx],
                       scene.lights.emit.to(emission.device))
    for i, kind in enumerate(scene.lights.kinds):
        if kind == klights.ENV:
            emit = emit.clone()
            emit[i] = env
    return emit


def _phit_lights(lights) -> bool:
    """Does every light give a direction-free hit pdf at sampling time
    (`_light_sample`'s phit), so the next bounce's emission MIS reads it
    instead of recomputing `_hit_light_pdf`?"""
    return all(lt["kind"] != klights.AREA_RECT
               and not (lt["kind"] == klights.AREA_SPHERE
                        and lt.get("inside_possible", True))
               for lt in lights)


# ---------------------------------------------------------------------------
# plain version: integer hashes and the lane RNG
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """An int tensor's bits as uint32 values held in int64."""
    return x.to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


_mul32 = lds.mul32


def _bits_to_unit(x: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1) from its top 24 bits."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _pix_hash(pid: torch.Tensor, seed) -> torch.Tensor:
    """lowbias32 of (pixel id, seed), on uint32 words (wavefront.py:477)."""
    x = pid ^ _mul32(seed if isinstance(seed, torch.Tensor)
                     else torch.tensor(seed & _M32), 0x9E3779B9)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x735A2D97)
    return x ^ (x >> 15)


def _lowbias(x: torch.Tensor) -> torch.Tensor:
    """The hash stream's finaliser (wavefront.py:574-580), with the
    constants as written there."""
    x = x ^ (x >> 17)
    x = _mul32(x, -315667899)
    x = x ^ (x >> 11)
    x = _mul32(x, -1404298415)
    x = x ^ (x >> 15)
    x = _mul32(x, 830770091)
    return x ^ (x >> 14)


def _superset_xor(x: torch.Tensor) -> torch.Tensor:
    """z_j = XOR over k >= j, j a subset of k, of x_k: the GF(2) superset
    transform in 5 word-parallel stages (wavefront.py:451); bit-reversed, a
    (0,2)-sequence partner of the radical inverse."""
    x = x ^ ((x >> 1) & 0x55555555)
    x = x ^ ((x >> 2) & 0x33333333)
    x = x ^ ((x >> 4) & 0x0F0F0F0F)
    x = x ^ ((x >> 8) & 0x00FF00FF)
    return x ^ ((x >> 16) & 0x0000FFFF)


def _site_seeds(ctr: int) -> list[int]:
    """Three decorrelated 32-bit words for draw site `ctr`: splitmix64 of
    the counter (wavefront.py:487)."""
    m64 = (1 << 64) - 1
    out = []
    x = (ctr * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) & m64
    for _ in range(3):
        x = (x + 0x9E3779B97F4A7C15) & m64
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m64
        out.append((z ^ (z >> 31)) & _M32)
    return out


class _Rng:
    """The JAX package's `_Rng(hw=False)` on (N,) lanes.

    "random": key = tile seed, mixed with the lane's position inside its
    rows*128 tile. "hash" (per_lane): key = a per-lane hash of (seed,
    pixel id, sample id). "sobol" (sobol=(sample index, pixel hash)): every
    draw shuffles and Owen-scrambles the lane's reversed sample index with
    the words of its site; uniform2() is one point of a (0,2) pair and
    advances the counter once. Every draw is a pure function of (key, lane,
    draw counter), and the counter advances the same on every lane."""

    def __init__(self, key: torch.Tensor | None, lane: torch.Tensor | None,
                 sobol=None):
        self.key = key
        self.lane = lane
        self.ctr = 0
        self.sobol = sobol is not None
        if self.sobol:
            si, self.ph = sobol
            self.si_rev = lds.reverse_bits(si)

    def _sobol_site(self):
        """(shuffled index i, the site's third word, dimension 0 of i)."""
        self.ctr += 1
        c1, c2, c3 = _site_seeds(self.ctr)
        i = lds.reverse_bits(lds.laine_karras(self.si_rev, self.ph ^ c1))
        u1 = _bits_to_unit(lds.reverse_bits(lds.laine_karras(i,
                                                             self.ph ^ c2)))
        return i, c3, u1

    def uniform(self) -> torch.Tensor:
        if self.sobol:
            return self._sobol_site()[2]
        self.ctr += 1
        step = (self.ctr * 668265263) & _M32
        if self.lane is None:
            x = (self.key + step) & _M32
        else:
            x = (self.key + _mul32(self.lane, 374761393) + step) & _M32
        return _bits_to_unit(_lowbias(x))

    def uniform2(self):
        if not self.sobol:
            return self.uniform(), self.uniform()
        i, c3, u1 = self._sobol_site()
        u2 = _bits_to_unit(lds.reverse_bits(lds.laine_karras(
            _superset_xor(i), self.ph ^ c3)))
        return u1, u2


def _single_pick(tile_seed: torch.Tensor, bounce: int, si0, L: int):
    """nee="single": the light picked for a whole tile at one bounce
    (wavefront.py:2213-2236); si0 is the sample index of the tile's first
    lane under the "hash" and "sobol" samplers, else None."""
    c = (tile_seed + ((bounce * 668265263) & 0x7FFFFFFF)) & _M32
    c = c ^ (c >> 16)
    c = _mul32(c, 0x85EBCA6B)
    c = c ^ (c >> 13)
    if si0 is not None:
        c = (c + si0) & _M32
    return (c & 0x7FFFFFFF) % L


# ---------------------------------------------------------------------------
# plain version: geometry
# ---------------------------------------------------------------------------

_EPS = _f32(km.SHAPE_EPSILON)
_OFF = _f32(km.RAY_OFFSET)
_SHADOW_EPS = _f32(km.SHADOW_EPSILON)
_TWO_PI = _f32(km.TWO_PI)
_INV_PI = _f32(km.INV_PI)
_INV_2PI = _f32(km.INV_2PI)
_ENV_PDF = _f32(1.0 / (2.0 * np.pi * np.pi))


def _where(c, a, b):
    """torch.where that takes python numbers on either side (float32 when
    both are)."""
    if isinstance(a, torch.Tensor):
        like = a
    elif isinstance(b, torch.Tensor):
        like = b
    else:
        like = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return torch.where(c, a, b)


def _planar_hit(s, o: V3, d: V3):
    """(t, inside) for one planar surface. The divisions are raw: a parallel
    ray gives t = +-inf/nan, which every caller's `eps < t < tmax` gate
    rejects."""
    nrm = cv3(s["n"])
    if s["kind"] == kshapes.DISK:
        p0 = cv3(s["p0"])
        t = km.div(nrm.dot(p0 - o), nrm.dot(d))
        hp = o + d * t
        inside = (hp - p0).length_squared() <= _f32(s["radius"] ** 2)
        return t, inside
    if s.get("fast"):
        anchor = cv3(s["anchor"])
        c_n = _planar_consts(s)[0]
        t = km.div(c_n - nrm.dot(o), nrm.dot(d))
        rel = o + d * t - anchor
        a = rel.dot(cv3(s["f1"]))
        b = rel.dot(cv3(s["f2"]))
        if s["kind"] == kshapes.TRI:
            inside = (a >= 0) & (b >= 0) & (a + b <= 1.0)
        else:
            inside = (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)
        return t, inside
    p0, p1 = cv3(s["p0"]), cv3(s["p1"])
    p2, p3 = cv3(s["p2"]), cv3(s["p3"])
    oa, ob, oc, od = p0 - o, p1 - o, p2 - o, p3 - o
    v0d = oc.cross(ob).dot(d)
    v1d = ob.cross(oa).dot(d)
    v2d = oa.cross(od).dot(d)
    v3d = od.cross(oc).dot(d)
    if s["kind"] == kshapes.TRI:
        inside = ((v0d < 0) & (v1d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
    else:
        inside = ((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
    t = km.div(nrm.dot(oa), nrm.dot(d))
    return t, inside


def _sphere_consts(s):
    r = _f32(s["r"])
    return cv3(s["c"]), r, _f32(np.float32(r) * np.float32(r))


def _closest_hit(static, o: V3, d: V3):
    """Closest hit over the scene -> (t, sid, valid, normal). The normal is
    resolved once from the winning row."""
    t_best = torch.full_like(o.x, math.inf)
    sid = torch.full(o.x.shape, -1, dtype=torch.int32, device=o.x.device)
    for row, s in enumerate(static["planar"]):
        t, inside = _planar_hit(s, o, d)
        accept = inside & (t > _EPS) & (t < t_best)
        t_best = torch.where(accept, t, t_best)
        sid = _where(accept, row, sid)
    base = len(static["planar"])
    for j, s in enumerate(static["spheres"]):
        c, _, r2 = _sphere_consts(s)
        oc = c - o
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r2 - perp.length_squared()
        sq = km.safe_sqrt(discr)
        cc = oc.length_squared() - r2
        sgn = _where(neg_b >= 0.0, 1.0, -1.0)
        q = neg_b + sgn * sq
        tq = cc / q
        t1 = torch.minimum(q, tq)
        t2 = torch.maximum(q, tq)
        t1_ok = t1 > _EPS
        t2_ok = t2 > _EPS
        t = torch.where(t1_ok, t1, t2)
        accept = (discr >= 0) & (t1_ok | t2_ok) & (t < t_best)
        t_best = torch.where(accept, t, t_best)
        sid = _where(accept, base + j, sid)
    valid = sid >= 0

    # normal of the winning row
    dev = o.x.device
    zero = torch.zeros_like(o.x)
    idx = sid.clamp_min(0).long()
    n_pl = len(static["planar"])
    if n_pl:
        nrm_tab = torch.tensor([s["n"] for s in static["planar"]],
                               dtype=torch.float32, device=dev)
        rect_tab = torch.tensor([s["kind"] == kshapes.RECT
                                 for s in static["planar"]], device=dev)
        on_pl = valid & (sid < n_pl)
        pidx = idx.clamp_max(n_pl - 1)
        nx = torch.where(on_pl, nrm_tab[pidx, 0], zero)
        ny = torch.where(on_pl, nrm_tab[pidx, 1], zero)
        nz = torch.where(on_pl, nrm_tab[pidx, 2], zero)
        is_rect = on_pl & rect_tab[pidx]
    else:
        nx = ny = nz = zero
        is_rect = torch.zeros_like(valid)
    flip = is_rect & (nx * d.x + ny * d.y + nz * d.z > 0)
    n_best = V3(torch.where(flip, -nx, nx), torch.where(flip, -ny, ny),
                torch.where(flip, -nz, nz))
    if static["spheres"]:
        sp_tab = torch.tensor(
            [[*map(_f32, s["c"]), _f32(1.0 / s["r"])]
             for s in static["spheres"]], dtype=torch.float32, device=dev)
        on_sp = sid >= base
        sidx = (idx - base).clamp(0, len(static["spheres"]) - 1)
        cx = torch.where(on_sp, sp_tab[sidx, 0], zero)
        cy = torch.where(on_sp, sp_tab[sidx, 1], zero)
        cz = torch.where(on_sp, sp_tab[sidx, 2], zero)
        inv_r = torch.where(on_sp, sp_tab[sidx, 3], torch.ones_like(zero))
        n_sp = V3((o.x + d.x * t_best - cx) * inv_r,
                  (o.y + d.y * t_best - cy) * inv_r,
                  (o.z + d.z * t_best - cz) * inv_r)
        n_best = n_sp.where(on_sp, n_best)
    return t_best, sid, valid, n_best


def _sphere_occludes(neg_b, discr, tmax):
    """Root of a sphere crossing in (eps, tmax), without the square root
    (wavefront.py:901-916)."""
    a_c = neg_b - _EPS
    b_c = neg_b - tmax
    a2 = a_c * a_c
    b2 = b_c * b_c
    a_pos = a_c > 0.0
    b_neg = b_c < 0.0
    in1 = a_pos & (discr < a2) & (b_neg | (discr > b2))
    in2 = (a_pos | (discr > a2)) & b_neg & (discr < b2)
    return (discr >= 0) & (in1 | in2)


def _any_hit(static, o: V3, d: V3, tmax, skip_rows=frozenset(),
             skip_light=None):
    """Occlusion in (SHAPE_EPSILON, tmax) for nee="single": planar rows in
    `skip_rows` are left out, and under shadow="robust" (`skip_light`, the
    picked light per lane) so are the surfaces bound to that light."""
    hit = torch.zeros_like(tmax, dtype=torch.bool)
    n_pl = len(static["planar"])
    li_of = static["mats"]["light_index"]

    def gated(h, row):
        if skip_light is None or li_of[row] < 0:
            return h
        return h & (skip_light != li_of[row])

    for row, s in enumerate(static["planar"]):
        if row in skip_rows:
            continue
        t, inside = _planar_hit(s, o, d)
        hit = hit | gated(inside & (t > _EPS) & (t < tmax), row)
    for j, s in enumerate(static["spheres"]):
        c, _, r2 = _sphere_consts(s)
        oc = c - o
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r2 - perp.length_squared()
        hit = hit | gated(_sphere_occludes(neg_b, discr, tmax), n_pl + j)
    return hit


def _any_hit_multi(static, hp: V3, n_shade: V3, rays, skips, robust=False,
                   sphere_skips=None, nd=None):
    """All NEE shadow rays of one vertex leave the same shading point hp
    (offset +-RAY_OFFSET along n_shade by the sign of n.wi), so the terms
    that depend only on (hp, n_shade) are shared by the K rays.
    rays: [(wi, tmax)]; skips: per-ray planar rows to omit."""
    K = len(rays)
    if nd is None:
        nd = [n_shade.dot(wi) for wi, _ in rays]
    se = [_where(nd[k] < 0.0, -_OFF, _OFF) for k in range(K)]
    if robust:
        rays = [(rays[k][0], rays[k][1] - se[k] * nd[k]) for k in range(K)]
    hits = [torch.zeros_like(rays[k][1], dtype=torch.bool) for k in range(K)]
    origins = [None] * K
    for row, s in enumerate(static["planar"]):
        which = [k for k in range(K) if row not in skips[k]]
        if not which:
            continue
        if s["kind"] == kshapes.DISK or not s.get("fast"):
            for k in which:
                if origins[k] is None:
                    origins[k] = hp + n_shade * se[k]
                t, inside = _planar_hit(s, origins[k], rays[k][0])
                hits[k] = hits[k] | (inside & (t > _EPS) & (t < rays[k][1]))
            continue
        nrm = cv3(s["n"])
        f1, f2 = cv3(s["f1"]), cv3(s["f2"])
        c_n, c_1, c_2 = _planar_consts(s)
        num_h = c_n - nrm.dot(hp)
        num_n = nrm.dot(n_shade)
        a_h = f1.dot(hp) - c_1
        a_n = f1.dot(n_shade)
        b_h = f2.dot(hp) - c_2
        b_n = f2.dot(n_shade)
        for k in which:
            wi, tmax = rays[k]
            num = num_h - se[k] * num_n
            t = km.div(num, nrm.dot(wi))
            a = (a_h + se[k] * a_n) + t * f1.dot(wi)
            b = (b_h + se[k] * b_n) + t * f2.dot(wi)
            if s["kind"] == kshapes.TRI:
                inside = (a >= 0) & (b >= 0) & (a + b <= 1.0)
            else:
                inside = (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)
            hits[k] = hits[k] | (inside & (t > _EPS) & (t < tmax))

    off2 = _f32(km.RAY_OFFSET * km.RAY_OFFSET)
    for j, s in enumerate(static["spheres"]):
        which = [k for k in range(K)
                 if sphere_skips is None or j not in sphere_skips[k]]
        if not which:
            continue
        c, _, r2 = _sphere_consts(s)
        vc = c - hp
        vc2 = vc.length_squared()
        vcn = vc.dot(n_shade)
        for k in which:
            wi, tmax = rays[k]
            neg_b = vc.dot(wi) - se[k] * nd[k]
            oc2 = vc2 - 2.0 * se[k] * vcn + off2
            discr = r2 - oc2 + neg_b * neg_b
            hits[k] = hits[k] | _sphere_occludes(neg_b, discr, tmax)
    return hits


def _offset_origin(p: V3, n: V3, d: V3) -> V3:
    return p + n * _where(n.dot(d) < 0.0, -_OFF, _OFF)


# ---------------------------------------------------------------------------
# plain version: BSDFs and lights
# ---------------------------------------------------------------------------


def _ipow(x, n: int):
    """x**n for a static integer n >= 1 by square-and-multiply."""
    r = None
    while n:
        if n & 1:
            r = x if r is None else r * x
        n >>= 1
        if n:
            x = x * x
    return r


def _fresnel_dielectric(ci, eta):
    ci = torch.clamp(ci, -1.0, 1.0)
    entering = ci > 0.0
    ei = _where(entering, 1.0, eta)
    et = _where(entering, eta, 1.0)
    c = torch.abs(ci)
    si = km.safe_sqrt(1.0 - c * c)
    st = ei / et * si
    tir = st >= 1.0
    ct = km.safe_sqrt(1.0 - torch.clamp_max(st, 1.0) ** 2)
    r_par = km.safe_div(et * c - ei * ct, et * c + ei * ct)
    r_per = km.safe_div(ei * c - et * ct, ei * c + et * ct)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return _where(tir, 1.0, fr)


def _sin_from_phi_cos(cos_phi, u):
    """sin(2 pi u) from cos(2 pi u): sign(sin) = +1 iff u <= 0.5."""
    s = km.safe_sqrt(1.0 - cos_phi * cos_phi)
    return torch.where(u <= 0.5, s, -s)


def _concentric_disk(u1, u2):
    x = 2.0 * u1 - 1.0
    y = 2.0 * u2 - 1.0
    xd = torch.abs(x) > torch.abs(y)
    r = torch.where(xd, x, y)
    ratio = torch.where(xd, km.safe_div(y, x), km.safe_div(x, y))
    theta = torch.where(xd, _f32(km.PI_OVER_4) * ratio,
                        _f32(km.PI_OVER_2) - _f32(km.PI_OVER_4) * ratio)
    deg = (x == 0.0) & (y == 0.0)
    ct = torch.cos(theta)
    st = km.safe_sqrt(1.0 - ct * ct)
    st = torch.where(theta >= 0.0, st, -st)
    px = _where(deg, 0.0, r * ct)
    py = _where(deg, 0.0, r * st)
    return px, py


def _phong_pow(cos_alpha, exponent, static_exp):
    """(cos^e, (e+2)/2pi, (e+1)/2pi): `_ipow` and host-folded factors for
    a static exponent, pow with the per-lane exponent otherwise."""
    if static_exp is not None:
        return (_ipow(cos_alpha, int(static_exp)),
                _f32((static_exp + 2.0) * km.INV_2PI),
                _f32((static_exp + 1.0) * km.INV_2PI))
    return (torch.pow(cos_alpha, exponent), (exponent + 2.0) * _INV_2PI,
            (exponent + 1.0) * _INV_2PI)


def _bsdf_sample(kind, color: V3, color2: V3, eta, exponent, wo: V3, u1, u2,
                 lobes=frozenset((kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                                  kbsdf.PHONG)), static_exp=None):
    """Local-frame sample of the lobes present, selected by `kind`
    (wavefront.py:1228-1330). Returns (f, wi, pdf, delta, f_unit,
    glass_refract)."""
    mirror_wi = V3(-wo.x, -wo.y, wo.z)
    zero = torch.zeros_like(u1)
    cand = {}
    if kbsdf.LAMBERT in lobes:
        px, py = _concentric_disk(u1, u2)
        lz = km.safe_sqrt(1.0 - px * px - py * py)
        wi_lam = V3(px, py, torch.where(wo.z < 0, -lz, lz))
        same_lam = wo.z * wi_lam.z > 0
        f_lam = (color * _INV_PI).where(same_lam, v3_zeros(wo.x))
        pdf_lam = _where(same_lam, torch.abs(wi_lam.z) * _INV_PI, 0.0)
        unit_lam = _where(same_lam, _INV_PI, 0.0)
        cand[kbsdf.LAMBERT] = (wi_lam, f_lam, pdf_lam, unit_lam)
    if kbsdf.MIRROR in lobes:
        abs_cos_m = torch.clamp_min(torch.abs(mirror_wi.z), 1e-12)
        inv_m = km.div(1.0, abs_cos_m)
        cand[kbsdf.MIRROR] = (mirror_wi, color * inv_m,
                              torch.ones_like(u1), inv_m)
    take_refl = None
    if kbsdf.GLASS in lobes:
        fr = _fresnel_dielectric(wo.z, eta)
        take_refl = u1 < fr
        into = wo.z > 0
        nz = _where(into, 1.0, -1.0)
        n_loc = V3(torch.zeros_like(nz), torch.zeros_like(nz), nz)
        eta_ratio = _where(into, km.div(1.0, eta), eta)
        cos_i = n_loc.dot(wo)
        sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        sin2_t = eta_ratio * eta_ratio * sin2_i
        refr_ok = sin2_t < 1.0
        cos_t = km.safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
        wt = (-wo) * eta_ratio + n_loc * (eta_ratio * cos_i - cos_t)
        wi_gl = mirror_wi.where(take_refl, wt)
        abs_cos_g = torch.clamp_min(torch.abs(wi_gl.z), 1e-12)
        refl_unit = fr / abs_cos_g
        refr_unit = (1.0 - fr) / abs_cos_g
        unit_gl = torch.where(take_refl, refl_unit,
                              _where(refr_ok, refr_unit, 0.0))
        f_gl = (color * refl_unit).where(
            take_refl, (color2 * refr_unit).where(refr_ok, v3_zeros(wo.x)))
        pdf_gl = torch.where(take_refl, fr, _where(refr_ok, 1.0 - fr, 0.0))
        cand[kbsdf.GLASS] = (wi_gl, f_gl, pdf_gl, unit_gl)
    if kbsdf.PHONG in lobes:
        phi = _TWO_PI * u1
        if static_exp is not None:
            cos_t_p = torch.pow(u2, _f32(1.0 / (static_exp + 1.0)))
        else:
            cos_t_p = torch.pow(u2, km.div(1.0, exponent + 1.0))
        sin_t_p = km.safe_sqrt(1.0 - cos_t_p * cos_t_p)
        cphi = torch.cos(phi)
        lobe = V3(cphi * sin_t_p, _sin_from_phi_cos(cphi, u1) * sin_t_p,
                  cos_t_p)
        s_f, t_f, n_f = make_frame(mirror_wi)
        wi_ph = to_world(s_f, t_f, n_f, lobe)
        wi_ph = V3(wi_ph.x, wi_ph.y, torch.where(wo.z < 0, -wi_ph.z, wi_ph.z))
        cos_alpha = torch.clamp_min(mirror_wi.dot(wi_ph), 0.0)
        same_ph = wo.z * wi_ph.z > 0
        powa, e2, e1 = _phong_pow(cos_alpha, exponent, static_exp)
        ph_val = _where(same_ph, e2 * powa, 0.0)
        pdf_ph = e1 * powa
        cand[kbsdf.PHONG] = (wi_ph, color * ph_val, pdf_ph, ph_val)

    order = [k for k in (kbsdf.LAMBERT, kbsdf.MIRROR, kbsdf.GLASS,
                         kbsdf.PHONG) if k in cand]
    wi, f, pdf, f_unit = cand[order[-1]]
    for k in reversed(order[:-1]):
        is_k = kind == k
        wi_k, f_k, pdf_k, unit_k = cand[k]
        wi = wi_k.where(is_k, wi)
        f = f_k.where(is_k, f)
        pdf = torch.where(is_k, pdf_k, pdf)
        f_unit = torch.where(is_k, unit_k, f_unit)
    false_mask = zero > 0
    is_gls = (kind == kbsdf.GLASS) if kbsdf.GLASS in cand else false_mask
    is_mir = (kind == kbsdf.MIRROR) if kbsdf.MIRROR in cand else false_mask
    glass_refract = (is_gls & ~take_refl) if take_refl is not None \
        else false_mask
    return f, wi, pdf, is_mir | is_gls, f_unit, glass_refract


def _eval_lobes(kind, same, wi_z, cos_alpha, exponent, lobes, static_exp):
    """Lambert / Phong eval + pdf shared by the two eval entry points."""
    has_lam = kbsdf.LAMBERT in lobes
    has_ph = kbsdf.PHONG in lobes
    zero = torch.zeros_like(wi_z)
    if has_lam:
        unit_lam = _where(same, _INV_PI, 0.0)
        pdf_lam = _where(same, torch.abs(wi_z) * _INV_PI, 0.0)
    if has_ph:
        powa, e2, e1 = _phong_pow(torch.clamp_min(cos_alpha, 0.0), exponent,
                                  static_exp)
        ph = _where(same, e2 * powa, 0.0)
        pdf_ph = e1 * powa
    if has_lam and has_ph:
        is_lam = kind == kbsdf.LAMBERT
        is_ph = kind == kbsdf.PHONG
        f_unit = torch.where(is_lam, unit_lam, _where(is_ph, ph, 0.0))
        pdf = torch.where(is_lam, pdf_lam, _where(is_ph, pdf_ph, 0.0))
    elif has_lam:
        is_lam = kind == kbsdf.LAMBERT
        f_unit = _where(is_lam, unit_lam, 0.0)
        pdf = _where(is_lam, pdf_lam, 0.0)
    elif has_ph:
        is_ph = kind == kbsdf.PHONG
        f_unit = _where(is_ph, ph, 0.0)
        pdf = _where(is_ph, pdf_ph, 0.0)
    else:
        f_unit = pdf = zero
    return pdf, f_unit


def _bsdf_eval_pdf(kind, color: V3, exponent, wo: V3, wi: V3,
                   lobes=frozenset((kbsdf.LAMBERT, kbsdf.PHONG)),
                   static_exp=None):
    """Local-frame eval + pdf of the non-delta lobes -> (f, pdf, f_unit)."""
    wr = V3(-wo.x, -wo.y, wo.z)
    cos_alpha = wr.dot(wi) if kbsdf.PHONG in lobes else None
    pdf, f_unit = _eval_lobes(kind, wo.z * wi.z > 0, wi.z, cos_alpha,
                              exponent, lobes, static_exp)
    return color * f_unit, pdf, f_unit


def _bsdf_eval_pdf_dots(kind, exponent, wo_z, wi_z, cos_alpha,
                        lobes=frozenset((kbsdf.LAMBERT, kbsdf.PHONG)),
                        static_exp=None):
    """`_bsdf_eval_pdf` on the frame-invariant dots n.wo, n.wi and the
    mirror dot -> (pdf, f_unit)."""
    return _eval_lobes(kind, wo_z * wi_z > 0, wi_z, cos_alpha, exponent,
                       lobes, static_exp)


def _light_sample(lt, world_radius, p: V3, n_shade: V3, u1, u2, azim=None):
    """sample_Li for light lt -> (wi, pdf, li_scalar, dist, phit); Li =
    emit * li_scalar. phit is the light's direction-free solid-angle pdf
    for a BSDF ray leaving p, or None where it depends on the direction
    (wavefront.py:1441-1590)."""
    kind = lt["kind"]
    ones = torch.ones_like(u1)
    zeros = torch.zeros_like(u1)
    if kind == klights.POINT:
        vec = cv3(lt["position"]) - p
        d2 = torch.clamp_min(vec.length_squared(), 1e-20)
        dist = km.sqrt(d2)
        wi = vec * km.div(1.0, dist)
        return wi, ones, km.div(1.0, d2), dist, zeros
    if kind == klights.DIRECTION:
        dr = cv3(lt["direction"])
        wi = v3_full(u1, -dr.x, -dr.y, -dr.z)
        dist = torch.full_like(u1, _f32(2.0 * world_radius))
        return wi, ones, ones, dist, zeros
    if kind == klights.AREA_RECT:
        p0, p1, p2 = cv3(lt["p0"]), cv3(lt["p1"]), cv3(lt["p2"])
        n_l = cv3(lt["normal"])
        area = _f32(lt["area"])
        lp = p1 + (p0 - p1) * u1 + (p2 - p1) * u2
        vec = lp - p
        d2 = torch.clamp_min(vec.length_squared(), 1e-20)
        dist = km.sqrt(d2)
        wi = vec * km.div(1.0, dist)
        cos_l = n_l.dot(-wi)
        pdf = km.safe_div(d2, torch.abs(cos_l) * area)
        facing = cos_l > 0
        li_s = _where(facing, 1.0, 0.0)
        pdf = _where(facing & (pdf > 0) & torch.isfinite(pdf), pdf, 0.0)
        return wi, pdf, li_s, dist, None
    if kind == klights.AREA_SPHERE:
        c, r, r2 = _sphere_consts(dict(c=lt["center"], r=lt["radius"]))
        vec_c = c - p
        d2c = torch.clamp_min(vec_c.length_squared(), 1e-20)
        inv_dc = km.rsqrt(d2c)
        dist_c = d2c * inv_dc
        inv_d2c = inv_dc * inv_dc
        sin2_max = torch.clamp_max(r2 * inv_d2c, 1.0)
        cos_max = km.safe_sqrt(1.0 - sin2_max)
        cos_t = (cos_max - 1.0) * u1 + 1.0
        sin2 = 1.0 - cos_t * cos_t
        tiny = sin2_max < _f32(0.00068523)
        sin2 = torch.where(tiny, sin2_max * u1, sin2)
        cos_t = torch.where(tiny, km.safe_sqrt(1.0 - sin2), cos_t)
        sin_t = km.safe_sqrt(sin2)
        if azim is None:
            cphi = torch.cos(u2 * _TWO_PI)
            sphi = _sin_from_phi_cos(cphi, u2)
        else:
            cphi, sphi = azim
        to_c = vec_c * inv_dc
        s_f, t_f, n_f = make_frame(to_c)
        wi_cone = s_f * (-sin_t * cphi) + t_f * (-sin_t * sphi) \
            + n_f * cos_t
        depth2 = r2 - d2c * sin2
        ds = dist_c * cos_t - km.safe_sqrt(depth2)
        q_cone = _TWO_PI * (1.0 - cos_max)
        pdf_cone = _where(q_cone > 0.0, km.div(1.0, q_cone), 0.0)
        outside = d2c > r2
        ok_cone = (depth2 > 0) & (q_cone > 0.0) & outside
        if not lt.get("inside_possible", True):
            li_s = _where(ok_cone, 1.0, 0.0)
            phit = _where(outside, pdf_cone, 0.0)
            return wi_cone, pdf_cone, li_s, ds, phit
        inside = ~outside
        z_u = 1.0 - 2.0 * u1
        r_u = km.safe_sqrt(1.0 - z_u * z_u)
        dir_u = V3(r_u * cphi, r_u * sphi, z_u)
        lp_in = c + dir_u * r
        vec_in = lp_in - p
        d2_in = torch.clamp_min(vec_in.length_squared(), 1e-20)
        inv_d_in = km.rsqrt(d2_in)
        wi_in = vec_in * inv_d_in
        area = _sphere_area_f32(lt["radius"])
        pdf_in = km.safe_div(d2_in, area * torch.abs(n_shade.dot(-wi_in)))
        pdf_in = _where(torch.isfinite(pdf_in), pdf_in, 0.0)
        ok_in = (dir_u.dot(-wi_in) > 0) & (pdf_in > 0)
        wi = wi_in.where(inside, wi_cone)
        pdf = torch.where(inside, pdf_in, pdf_cone)
        ok = torch.where(inside, ok_in, ok_cone)
        dist = torch.where(inside, d2_in * inv_d_in, ds)
        return wi, pdf, _where(ok, 1.0, 0.0), dist, None
    if kind == klights.ENV:
        # replicated reference quirk: uniform-sphere direction, angle-space
        # pdf (ky.cpp:3029-3035)
        z_u = 1.0 - 2.0 * u1
        r_u = km.safe_sqrt(1.0 - z_u * z_u)
        if azim is None:
            cphi = torch.cos(_TWO_PI * u2)
            sphi = _sin_from_phi_cos(cphi, u2)
        else:
            cphi, sphi = azim
        wi = V3(r_u * cphi, r_u * sphi, z_u)
        pdf = _env_pdf(wi)
        dist = torch.full_like(u1, _f32(2.0 * world_radius))
        return wi, pdf, ones, dist, zeros
    raise ValueError(f"unknown light kind {kind}")


def _env_pdf(wi: V3):
    sin_theta = km.safe_sqrt(1.0 - wi.z * wi.z)
    return _where(sin_theta == 0.0, 0.0,
                  km.div(_ENV_PDF, torch.clamp_min(sin_theta, 1e-20)))


def _sphere_cone_pdf(c: V3, r2, p: V3):
    """(inside, uniform-cone pdf) of a sphere light seen from p."""
    d2c = torch.clamp_min((c - p).length_squared(), 1e-20)
    inside = d2c <= r2
    sin2_max = torch.clamp_max(km.div(r2, d2c), 1.0)
    cos_max = km.safe_sqrt(1.0 - sin2_max)
    pdf_cone = km.safe_div(1.0, _TWO_PI * (1.0 - cos_max))
    return inside, _where(torch.isfinite(pdf_cone), pdf_cone, 0.0)


def _hit_light_pdf(lights, li_idx, o: V3, d: V3, t, nrm: V3):
    """Solid-angle pdf of the area light the extension ray hit, from the
    hit record: squared distance t^2, light cosine |nrm.d|."""
    pdf = torch.zeros_like(t)
    t2 = t * t
    cos_l = torch.abs(nrm.dot(d))
    for i, lt in enumerate(lights):
        kind = lt["kind"]
        if kind == klights.AREA_RECT:
            pi = km.safe_div(t2, cos_l * _f32(lt["area"]))
        elif kind == klights.AREA_SPHERE:
            c, _, r2 = _sphere_consts(dict(c=lt["center"], r=lt["radius"]))
            inside, pdf_cone = _sphere_cone_pdf(c, r2, o)
            if not lt.get("inside_possible", True):
                pi = _where(inside, 0.0, pdf_cone)
            else:
                area = _f32(4.0 * np.pi * lt["radius"] ** 2)
                pi = torch.where(inside, km.safe_div(t2, cos_l * area),
                                 pdf_cone)
        else:
            continue
        pdf = torch.where(li_idx == i, pi, pdf)
    return pdf


def _light_pdf(lt, p: V3, n_shade: V3, wi: V3):
    """pdf_Li of light lt along wi from p (lights.py:232-266)."""
    kind = lt["kind"]
    if kind in (klights.POINT, klights.DIRECTION):
        return torch.zeros_like(wi.x)
    if kind == klights.AREA_RECT:
        p0, p1 = cv3(lt["p0"]), cv3(lt["p1"])
        p2, p3 = cv3(lt["p2"]), cv3(lt["p3"])
        n_l = cv3(lt["normal"])
        area = _f32(lt["area"])
        o = _offset_origin(p, n_shade, wi)
        oa, ob, oc, od = p0 - o, p1 - o, p2 - o, p3 - o
        v0d = oc.cross(ob).dot(wi)
        v1d = ob.cross(oa).dot(wi)
        v2d = oa.cross(od).dot(wi)
        v3d = od.cross(oc).dot(wi)
        inside = ((v0d < 0) & (v1d < 0) & (v2d < 0) & (v3d < 0)) | \
                 ((v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0))
        t = km.safe_div(n_l.dot(oa), n_l.dot(wi), math.inf)
        hit = inside & (t > _EPS) & torch.isfinite(t)
        hp = o + wi * t
        d2 = (hp - p).length_squared()
        pdf = km.safe_div(d2, torch.abs(n_l.dot(-wi)) * area)
        return _where(hit & torch.isfinite(pdf), pdf, 0.0)
    if kind == klights.AREA_SPHERE:
        c, r, r2 = _sphere_consts(dict(c=lt["center"], r=lt["radius"]))
        inside, pdf_cone = _sphere_cone_pdf(c, r2, p)
        if not lt.get("inside_possible", True):
            return _where(inside, 0.0, pdf_cone)
        o = _offset_origin(p, n_shade, wi)
        oc = c - o
        neg_b = oc.dot(wi)
        discr = neg_b * neg_b - oc.length_squared() + r2
        sq = km.safe_sqrt(discr)
        t1, t2 = neg_b - sq, neg_b + sq
        t1_ok = t1 > _EPS
        t2_ok = t2 > _EPS
        t = torch.where(t1_ok, t1, t2)
        hit = (discr >= 0) & (t1_ok | t2_ok)
        hp = o + wi * t
        n_hit = hp - c
        n_hit = n_hit * km.rsqrt(torch.clamp_min(n_hit.length_squared(),
                                                 1e-20))
        area = _sphere_area_f32(lt["radius"])
        pdf_in = km.safe_div((hp - p).length_squared(),
                             torch.abs(n_hit.dot(-wi)) * area)
        pdf_in = _where(hit & torch.isfinite(pdf_in), pdf_in, 0.0)
        return torch.where(inside, pdf_in, pdf_cone)
    if kind == klights.ENV:
        return _env_pdf(wi)
    raise ValueError(f"unknown light kind {kind}")


# ---------------------------------------------------------------------------
# plain version: textures (kytpu's wavefront.py:946-1175)
# ---------------------------------------------------------------------------


def _uv(static, rec, hp: V3):
    """(u, v) of hit hp on a textured planar row, from the baked anchor and
    dual basis (disks: frame coordinates shifted by 0.5)."""
    s = static["planar"][rec["row"]]
    rel = hp - cv3(s["uv_anchor"])
    u, v = rel.dot(cv3(s["uv_f1"])), rel.dot(cv3(s["uv_f2"]))
    if s.get("uv_disk"):
        u, v = u + 0.5, v + 0.5
    return u, v


def _checker_even(static, rec, hp: V3):
    """The checker's "even"-cell mask at hp (`_checker_parity`)."""
    u, v = _uv(static, rec, hp)
    pu = torch.floor(u * _f32(rec["scale"][0])).to(torch.int32)
    pv = torch.floor(v * _f32(rec["scale"][1])).to(torch.int32)
    return ((pu + pv) & 1) == 0


def _image_xy(static, rec, hp: V3):
    """Continuous texel coordinates (x, y) of hp on an image row, in
    [-0.5, dim - 0.5) (`_image_uv_xy`): what K2 caches as "tx", "ty"."""
    u, v = _uv(static, rec, hp)
    su = u * _f32(rec["scale"][0])
    sv = v * _f32(rec["scale"][1])
    x = (su - torch.floor(su)) * float(rec["tw"]) - 0.5
    y = (sv - torch.floor(sv)) * float(rec["th"]) - 0.5
    return x, y


def _image_taps(rec, x, y):
    """The bilinear taps of texel coordinates (x, y) on an image row, as the
    kernels list them (csrc/megakernel.cuh `image_taps`): four slots in
    ascending texel order, slot 2a + b the a-th lowest row and the b-th
    lowest column; a tap that coincides with another (a side of 1 texel) is
    merged into the first slot, the others left unused. Each slot: (texel
    index into the flattened atlas, -1 if unused; the select chain's weight,
    kytpu's per-texel sum of tap weights in tap order; the separable
    route's row and column weights). The tap indices and the weights are
    kytpu's (`_image_taps_from_xy`, `_image_sep_axes`)."""
    tw, th = rec["tw"], rec["th"]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi0, yi0 = x0.to(torch.int64), y0.to(torch.int64)
    xi0 = torch.where(xi0 < 0, tw - 1, xi0)
    yi0 = torch.where(yi0 < 0, th - 1, yi0)
    xi1 = torch.where(xi0 + 1 >= tw, 0, xi0 + 1)
    yi1 = torch.where(yi0 + 1 >= th, 0, yi0 + 1)
    a = (1.0 - fx, fx)
    b = (1.0 - fy, fy)
    xd, yd = xi0 == xi1, yi0 == yi1

    def wt(r, c):   # tap (row r, column c): kytpu's (1-fx)(1-fy), fx(1-fy) ..
        return a[c] * b[r]

    both = ((wt(0, 0) + wt(0, 1)) + wt(1, 0)) + wt(1, 1)
    c_hi_first = ~xd & (xi1 < xi0)   # the lower column is tap column 1
    r_hi_first = ~yd & (yi1 < yi0)
    base = rec["img"] * th * tw
    slots = []
    for ra in (0, 1):
        r = r_hi_first if ra == 0 else ~r_hi_first
        for cb in (0, 1):
            c = c_hi_first if cb == 0 else ~c_hi_first
            ok = (~yd if ra else torch.ones_like(yd)) & (
                ~xd if cb else torch.ones_like(xd))
            w_rc = torch.where(r, torch.where(c, wt(1, 1), wt(1, 0)),
                               torch.where(c, wt(0, 1), wt(0, 0)))
            w_x = torch.where(r, wt(1, 0) + wt(1, 1), wt(0, 0) + wt(0, 1))
            w_y = torch.where(c, wt(0, 1) + wt(1, 1), wt(0, 0) + wt(1, 0))
            w = torch.where(xd & yd, both, torch.where(
                xd, w_x, torch.where(yd, w_y, w_rc)))
            wr = torch.where(yd, b[0] + b[1], torch.where(r, b[1], b[0]))
            wc = torch.where(xd, a[0] + a[1], torch.where(c, a[1], a[0]))
            idx = base + torch.where(r, yi1, yi0) * tw + torch.where(
                c, xi1, xi0)
            slots.append((torch.where(ok, idx, -1), w, wr, wc))
    return slots


def _image_color(rec, slots, timg) -> V3:
    """The bilinear colour of an image row in the addition order of the
    route kytpu takes for its atlas: the select chain adds the texels in
    texel order, the separable route each row's two columns, then the
    rows."""
    def texel(idx):
        return timg[idx.clamp_min(0)]

    if not rec.get("sep"):
        col = torch.zeros((slots[0][0].shape[0], 3), device=timg.device)
        for idx, w, _, _ in slots:
            col = col + _where0(idx >= 0, texel(idx) * w[:, None])
        return V3(col[:, 0], col[:, 1], col[:, 2])
    rows = []
    for ra in (0, 1):
        (i0, _, wr, wc0), (i1, _, _, wc1) = slots[2 * ra], slots[2 * ra + 1]
        rs = texel(i0) * wc0[:, None] + _where0(i1 >= 0,
                                                texel(i1) * wc1[:, None])
        rows.append(_where0(i0 >= 0, rs * wr[:, None]))
    col = rows[0] + rows[1]
    return V3(col[:, 0], col[:, 1], col[:, 2])


def _texel_entries(rec, slots, adj: torch.Tensor, onrow):
    """K3's and K4's texel-tagged adjoint entries of one bounce: per slot
    (the value (N, 3), the tag: texel + 1, or 0 off the row or for an unused
    slot). The select chain's value is adj * w, the separable route's
    (w_row * adj) * w_col, as kytpu's scatters form them."""
    out = []
    for idx, w, wr, wc in slots:
        tag = torch.where(onrow & (idx >= 0), idx + 1, 0).to(torch.int32)
        val = (adj * w[:, None] if not rec.get("sep")
               else (wr[:, None] * adj) * wc[:, None])
        out.append((_where0(tag > 0, val), tag))
    return out


def _textures_at(static, tables, sid, hp: V3, diffuse: V3):
    """The textured rows' diffuse at hit hp (`_apply_textures`) -> (the
    diffuse, [(rec, onrow, checker even mask or None, image (x, y) or None,
    image slots or None)]), the hits kept for the cache and the adjoints."""
    hits = []
    for rec in static["textures"]:
        onrow = sid == rec["row"]
        if rec["kind"] == "image":
            x, y = _image_xy(static, rec, hp)
            slots = _image_taps(rec, x, y)
            col = _image_color(rec, slots, tables.timg)
            hits.append((rec, onrow, None, (x, y), slots))
        else:
            even = _checker_even(static, rec, hp)
            t = rec["tex"]
            ca, cb = tables.texa[t], tables.texb[t]
            col = V3(*(torch.where(even, ca[c], cb[c]) for c in range(3)))
            hits.append((rec, onrow, even, None, None))
        diffuse = col.where(onrow, diffuse)
    return diffuse, hits


def _route_textures(hits, addc_diff, acc_ta, acc_tb, entries):
    """The diffuse-value adjoint of a textured row goes to its texture:
    a checker's to color_a or color_b by the hit's parity (per-lane
    accumulators acc_ta, acc_tb (N, T, 3)), an image's to the four taps
    (appended to `entries` as 4 slots a bounce); the row's diffuse-table
    share is zeroed. -> the remaining diffuse adjoint (N, 3)."""
    slot_entries = None
    for rec, onrow, even, _, slots in hits:
        if even is not None:
            t = rec["tex"]
            acc_ta[:, t] += _where0(onrow & even, addc_diff)
            acc_tb[:, t] += _where0(onrow & ~even, addc_diff)
        else:
            ent = _texel_entries(rec, slots, addc_diff, onrow)
            slot_entries = ent if slot_entries is None else [
                (torch.where((t1 > 0)[:, None], v1, v0),
                 torch.where(t1 > 0, t1, t0))
                for (v0, t0), (v1, t1) in zip(slot_entries, ent)]
        addc_diff = _where0(~onrow, addc_diff)
    if entries is not None and slot_entries is not None:
        entries.extend(slot_entries)
    return addc_diff


# ---------------------------------------------------------------------------
# plain version: the forward kernel body
# ---------------------------------------------------------------------------


def _rng_keys(cfg: KernelConfig, n: int, seed: int, si, pix, device):
    """(rng, tile_seed per lane, si of each lane's tile head or None)."""
    tile = cfg.rows * LANE
    lane_ids = torch.arange(n, dtype=torch.int64, device=device)
    tile_id = lane_ids // tile
    tile_seed = (seed + _mul32(tile_id, 2654435761 & 0x7FFFFFFF)) & _M32
    if cfg.sampler in ("hash", "sobol"):
        si_u, pix_u = _u32(si), _u32(pix)
        ph = _pix_hash(pix_u, seed & _M32)
        rng = (_Rng(None, None, sobol=(si_u, ph)) if cfg.sampler == "sobol"
               else _Rng(_pix_hash(si_u, ph), None))
        return rng, tile_seed, si_u[tile_id * tile]
    return _Rng(tile_seed, lane_ids % tile), tile_seed, None


def _kappa_dot(exponent, cos_alpha):
    """d log f_phong / d e at a fixed direction, from the mirror dot:
    1/(e+2) + log cos_alpha, clamped (kytpu's `_kappa_dot`). The one
    definition behind every exponent adjoint: K2's "Bk"/"tuk" planes and
    K4's accumulators use it. Callers mask it to phong lanes."""
    cos_a = torch.clamp_min(cos_alpha, 1e-12)
    return km.safe_div(1.0, exponent + 2.0) + torch.log(cos_a)


def _kappa(exponent, wo_l: V3, wi_l: V3):
    """`_kappa_dot` of the local mirror direction of wo_l and wi_l."""
    return _kappa_dot(exponent, V3(-wo_l.x, -wo_l.y, wo_l.z).dot(wi_l))


def _st(v: V3) -> torch.Tensor:
    """V3 of (N,) planes -> (N, 3)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot of (N, 3) rows, summed as (x + y) + z."""
    p = a * b
    return (p[:, 0] + p[:, 1]) + p[:, 2]


def _row_add(acc, ok_tab, sid, val):
    """acc[lane, sid] += val where sid is a row allowed by ok_tab; acc is
    (N, M) or (N, M, 3), val (N,) or (N, 3)."""
    lanes = torch.arange(sid.shape[0], device=sid.device)
    sc = sid.clamp_min(0).long()
    ok = (sid >= 0) & ok_tab[sc]
    if val.dim() == 2:
        ok = ok[:, None]
    acc[lanes, sc] = torch.where(ok, acc[lanes, sc] + val, acc[lanes, sc])


def _where0(c, v: torch.Tensor) -> torch.Tensor:
    """c ? v : 0 for (N,) masks and (N,) or (N, 3) values."""
    if v.dim() == 2:
        c = c[:, None]
    return torch.where(c, v, torch.zeros_like(v))


def _eligible(ok_tab, sid):
    """(N,) mask: the lane hit a row that ok_tab allows (False on a miss)."""
    return (sid >= 0) & ok_tab[sid.clamp_min(0).long()]


def _tagged_planes(dif, spc, de, dexp, sid) -> list:
    """One bounce's row-tagged adjoint planes in K7's order, dd, ds, de[,
    dexp], from (ok_tab, value) pairs: a share is 0 where the hit row may
    not take it, the rows that `_row_add` leaves untouched."""
    out = []
    for ok_tab, v in (dif, spc):
        out.extend(_where0(_eligible(ok_tab, sid), v).unbind(1))
    out.extend(de.unbind(1))
    if dexp is not None:
        out.append(_where0(_eligible(dexp[0], sid), dexp[1]))
    return out


def trace_lanes_plain(tables: SceneTables, cfg: KernelConfig,
                      o: torch.Tensor, d: torch.Tensor, seed: int,
                      si: torch.Tensor | None = None,
                      pix: torch.Tensor | None = None,
                      residual: bool = False):
    """Plain torch transcription of the forward megakernel
    (kytpu.kernels.wavefront._make_kernel with grad=False).

    o, d: (N, 3) float32 rays; seed: int; si, pix: (N,) int sample index
    and pixel id, required by the "hash" and "sobol" samplers. Returns
    (N, 3) radiance. Lane n sits in tile n // (cfg.rows*128), as in the JAX
    package.

    residual=True (K2) also returns the coefficient cache, (L, resf, resi):
    resf (res_n, N) float32 in `residual_layout`'s plane order and resi
    (max_depth+1, N) int32 as `residual_layout` packs it. A bounce a lane
    does not reach (it died before) has every float plane 0 and resi 0; the
    JAX package writes the same zeros but the sid of its frozen ray."""
    return _trace_plain(tables, cfg, o, d, seed, si, pix,
                        "residual" if residual else "forward")


def bwd_replay_plain(tables: SceneTables, cfg: KernelConfig,
                     o: torch.Tensor, d: torch.Tensor, seed: int, si, pix,
                     g: torch.Tensor, big_l: torch.Tensor):
    """Plain K4, the path-replay backward (kytpu's `_make_kernel` with
    grad=True): the forward's arithmetic and random draws replayed on the
    same lanes, with the upstream gradient g and the forward's radiance
    big_l (N, 3) -> (dd, ds, de, denv[, dexp]) of shapes (M, 3) x 3, (3,)
    [and (M,) under cfg.trainable_exponent].

    Per bounce it peels the tail radiance R_{b+1} = (R_b - E_b) / T_b
    (0 where the path ends), scatters the bounce's colour adjoints to its
    row once, and sums the lanes in K3's fixed order (`sum_lanes`), so the
    two backwards are the same sum over lanes of different per-lane
    algebra. Past DENSE_MAX_ROWS surfaces (`row_tagged`) each bounce's
    adjoints are row-tagged entries instead, summed by row as K7's are
    (`tagged_grads`)."""
    return _trace_plain(tables, cfg, o, d, seed, si, pix, "replay", g, big_l)


def _trace_plain(tables: SceneTables, cfg: KernelConfig, o, d, seed: int,
                 si, pix, mode: str, g=None, big_l_in=None):
    """The plain megakernel body. mode "forward" is K1, "residual" K2 and
    "replay" K4: one body, as `wavefront_fwd_kernel<MODE>` is one template,
    so K2 and K4 draw, hit and branch as K1 does."""
    check_config(cfg)
    if cfg.sampler in ("hash", "sobol") and (si is None or pix is None):
        raise ValueError(f'sampler="{cfg.sampler}" needs si and pix lane '
                         'arrays')
    residual, replay = mode == "residual", mode == "replay"
    texp = cfg.trainable_exponent
    static = tables.static
    mats, lights = static["mats"], static["lights"]
    M, L = len(mats["kind"]), len(lights)
    world_radius = static["world_radius"]
    lobes = mats["lobes"]
    eval_lobes = lobes & {kbsdf.LAMBERT, kbsdf.PHONG}
    static_exp = None if texp else _static_exponent(mats)
    has_plastic = kbsdf.MAT_PLASTIC in mats["kind"]
    has_glass = kbsdf.MAT_GLASS in mats["kind"]
    has_delta = bool(lobes & {kbsdf.MIRROR, kbsdf.GLASS})
    env_i = next((i for i, lt in enumerate(lights)
                  if lt["kind"] == klights.ENV), None)
    occl_skips, sph_skips = _occl_skips(static, cfg)
    robust = cfg.shadow == "robust"
    textured, has_img = bool(static["textures"]), _has_img(static)

    n = o.shape[0]
    dev = o.device
    rng, tile_seed, si0 = _rng_keys(cfg, n, seed, si, pix, dev)

    # per-row tables as lane gathers (the kernel reads the same values
    # from its flat table)
    f32t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    i64t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)  # noqa
    kind_tab = i64t(mats["kind"])
    li_tab = i64t(mats["light_index"])
    eta_tab = f32t(mats["eta"])
    dprob_tab, sprob_tab = f32t(mats["d_prob"]), f32t(mats["s_prob"])
    rows_x = kind_tab == kbsdf.MAT_PLASTIC
    # trainable: the per-call table on plastic rows, 0 elsewhere
    exp_tab = (torch.where(rows_x, tables.exponent.to(dev), 0.0) if texp
               else f32t(mats["exponent"]))

    def row_of(sid, tab, fill):
        v = tab[sid.clamp_min(0).long()]
        return torch.where(sid >= 0, v, torch.full_like(v, fill))

    def sel3(sid, tab, allowed):
        ok = (sid >= 0) & allowed[sid.clamp_min(0).long()]
        v = tab[sid.clamp_min(0).long()]
        return V3(*(torch.where(ok, v[:, c], torch.zeros_like(v[:, c]))
                    for c in range(3)))

    rows_d = kind_tab != kbsdf.MAT_MIRROR
    rows_s = kind_tab != kbsdf.MAT_MATTE
    rows_e = li_tab >= 0

    o = V3(o[:, 0].float(), o[:, 1].float(), o[:, 2].float())
    d = V3(d[:, 0].float(), d[:, 1].float(), d[:, 2].float())
    beta = v3_full(o.x, 1.0, 1.0, 1.0)
    big_l = v3_zeros(o.x)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    spec_prev = torch.zeros_like(alive)
    pdf_prev = torch.ones_like(o.x)
    phits_prev = None
    env = tables.env
    if residual:
        res_ix, res_n = residual_layout(static, cfg)
        planes = [None] * res_n
        ints = [None] * (cfg.max_depth + 1)
    if replay:
        g = g.to(dev, torch.float32)
        r_tail = V3(*(big_l_in[:, c].to(dev, torch.float32)
                      for c in range(3)))
        light_row = _light_rows(static)
        tagged = row_tagged(static)
        if tagged:
            # per bounce the hit row's adjoint planes and its tag; the NEE
            # emission adjoints per light, over lanes
            acc_le = g.new_zeros((n, L, 3))
            dplanes, tags = [], []
        else:
            acc_d, acc_s, acc_e = (g.new_zeros((n, M, 3)) for _ in range(3))
            acc_x = g.new_zeros((n, M))
        acc_env = g.new_zeros((n, 3))
        T = _n_tex(static)
        acc_ta, acc_tb = g.new_zeros((n, T, 3)), g.new_zeros((n, T, 3))
        entries = [] if has_img else None

    for bounce in range(cfg.max_depth + 1):
        t, sid, valid, nrm = _closest_hit(static, o, d)
        t_safe = _where(valid, t, 1.0)
        hp = o + d * t_safe
        wo = -d
        facing = nrm.dot(wo) > 0.0
        emit_v = sel3(sid, tables.emission, rows_e)
        emit_mask = valid & facing
        le = V3(*(_where(emit_mask, c, 0.0) for c in (emit_v.x, emit_v.y,
                                                       emit_v.z)))
        if bounce == 0:
            full = True
        elif has_delta:
            full = spec_prev
        else:
            full = False
        if full is True:
            w_emit = torch.ones_like(o.x)
        else:
            li_idx = row_of(sid, li_tab, -1)
            if phits_prev is not None:
                pdf_l_hit = torch.zeros_like(o.x)
                for i in range(L):
                    pdf_l_hit = torch.where(li_idx == i, phits_prev[i],
                                            pdf_l_hit)
            else:
                pdf_l_hit = _hit_light_pdf(lights, li_idx, o, d, t_safe, nrm)
            w_emit = km.safe_div(pdf_prev, pdf_prev + pdf_l_hit)
            if full is not False:
                w_emit = _where(full, 1.0, w_emit)
        wb = _where(alive, w_emit, 0.0)
        e_term = le * wb
        big_l = big_l + beta * e_term
        if residual:
            planes[res_ix[("wb", bounce)]] = _where(emit_mask, wb, 0.0)
        if replay:
            gb = g * _st(beta)
            de_b = gb * _where(emit_mask, wb, 0.0)[:, None]
            if tagged:
                de_b = _where0(_eligible(rows_e, sid), de_b)
                tags.append(_where(alive & valid, sid + 1, 0))
            else:
                _row_add(acc_e, rows_e, sid, de_b)

        if env_i is not None:
            ones = torch.ones_like(o.x)
            env_v = V3(env[0] * ones, env[1] * ones, env[2] * ones)
            if full is True:
                w_env = 1.0
            else:
                pdf_env = _light_pdf(lights[env_i], o, nrm, d)
                w_env = km.safe_div(pdf_prev, pdf_prev + pdf_env)
                if full is not False:
                    w_env = _where(full, 1.0, w_env)
            wenv = _where(alive & ~valid, w_env, 0.0)
            big_l = big_l + beta * env_v * wenv
            e_term = e_term + env_v * wenv
            if residual:
                planes[res_ix[("wenv", bounce)]] = wenv
            if replay:
                acc_env = acc_env + gb * wenv[:, None]

        if bounce == cfg.max_depth:
            if residual:
                ints[bounce] = _where(alive, pack_row(sid + 1), 0)
            if replay and tagged:
                dplanes.extend(de_b.unbind(1))
            break
        cont = alive & valid

        exponent = 0.0 if static_exp is not None \
            else row_of(sid, exp_tab, 0.0)
        eta = row_of(sid, eta_tab, 0.0) if has_glass else 1.0
        diffuse = sel3(sid, tables.diffuse, rows_d)
        if textured:
            diffuse, tex_hits = _textures_at(static, tables, sid, hp,
                                             diffuse)
            # the live lanes' textured hits, for the cache and the adjoints
            tex_hits = [(rec, onrow & alive, *rest)
                        for rec, onrow, *rest in tex_hits]
        specular = sel3(sid, tables.specular, rows_s)
        mk = row_of(sid, kind_tab, 0)
        is_matte = mk == kbsdf.MAT_MATTE
        is_mirror = mk == kbsdf.MAT_MIRROR
        is_glass = mk == kbsdf.MAT_GLASS
        is_plastic = mk == kbsdf.MAT_PLASTIC
        if has_plastic:
            u_lobe = rng.uniform()
            s_prob = row_of(sid, sprob_tab, 0.0)
            d_prob = row_of(sid, dprob_tab, 0.0)
            pick_spec = u_lobe < s_prob
            plastic_kind = _where(pick_spec, torch.full_like(mk, kbsdf.PHONG),
                                  kbsdf.LAMBERT)
            inv_sp = km.div(1.0, torch.clamp_min(s_prob, 1e-12))
            inv_dp = km.div(1.0, torch.clamp_min(d_prob, 1e-12))
            plastic_col = (specular * inv_sp).where(pick_spec,
                                                    diffuse * inv_dp)
            lobe_is_phong = is_plastic & pick_spec
            lobe_scale = _where(is_plastic,
                                torch.where(pick_spec, inv_sp, inv_dp), 1.0)
        else:
            plastic_kind = torch.full_like(mk, kbsdf.LAMBERT)
            plastic_col = diffuse
            lobe_is_phong = torch.zeros_like(is_plastic)
            lobe_scale = 1.0
        kind = torch.where(
            is_matte, torch.full_like(mk, kbsdf.LAMBERT),
            torch.where(is_mirror, torch.full_like(mk, kbsdf.MIRROR),
                        torch.where(is_glass, torch.full_like(mk, kbsdf.GLASS),
                                    plastic_kind)))
        color = diffuse.where(is_matte, specular.where(is_mirror | is_glass,
                                                       plastic_col))
        color2 = diffuse
        nee_act = cont & ~(is_mirror | is_glass) if has_delta else cont

        s_f, t_f, n_f = make_frame(nrm)
        wo_l = to_local(s_f, t_f, n_f, wo)
        wr_w = nrm * (wo_l.z * 2.0) - wo \
            if kbsdf.PHONG in eval_lobes else None
        col_nee_tbl = specular.where(lobe_is_phong, diffuse) \
            if has_plastic else diffuse
        col_nee = _st(col_nee_tbl)
        nee_base = nee_act & ~color.is_black()
        ld = v3_zeros(o.x)
        if replay:
            # the bounce's colour adjoints, scattered to its row once
            addc_diff = torch.zeros_like(g)
            addc_spec = torch.zeros_like(g)
            addx = torch.zeros_like(o.x)

        def nee_adjoint(addc, kap):
            """K4: one NEE term's colour and exponent adjoints (the caller
            routes its emission adjoint)."""
            nonlocal addc_diff, addc_spec, addx
            if has_plastic:
                addc_spec = addc_spec + _where0(lobe_is_phong, addc)
                addc_diff = addc_diff + _where0(~lobe_is_phong, addc)
            else:
                addc_diff = addc_diff + addc
            if texp:
                addx = addx + _where0(lobe_is_phong,
                                      _dot3(addc, col_nee) * kap)

        if picks_one_light(cfg, L):
            u1, u2 = rng.uniform2()
            pick = _single_pick(tile_seed, bounce, si0, L)
            smps = [_light_sample(lt, world_radius, hp, nrm, u1, u2)
                    for lt in lights]
            sel = [pick == i for i in range(L)]
            wi, pdf_l, li_s, dist = smps[-1][0], smps[-1][1], \
                smps[-1][2], smps[-1][3]
            for i in range(L - 2, -1, -1):
                wi = smps[i][0].where(sel[i], wi)
                pdf_l = torch.where(sel[i], smps[i][1], pdf_l)
                li_s = torch.where(sel[i], smps[i][2], li_s)
                dist = torch.where(sel[i], smps[i][3], dist)
            is_delta_l = torch.zeros_like(sel[0])
            for i, lt in enumerate(lights):
                if klights.is_delta_light(lt["kind"]):
                    is_delta_l = is_delta_l | sel[i]
            emit_pick = tables.light_emit[pick.long()]
            emit_l = V3(emit_pick[:, 0], emit_pick[:, 1], emit_pick[:, 2])
            wi_l = to_local(s_f, t_f, n_f, wi)
            _, pdf_b, f_unit_e = _bsdf_eval_pdf(kind, color, exponent, wo_l,
                                                wi_l, eval_lobes, static_exp)
            ucos = f_unit_e * torch.abs(wi_l.z)
            w = torch.where(is_delta_l, km.safe_div(1.0, pdf_l),
                            km.safe_div(1.0, pdf_l + pdf_b))
            ok = nee_base & (pdf_l > 0.0)
            tm = dist - _SHADOW_EPS
            if robust:
                tm = tm - _OFF * torch.abs(nrm.dot(wi))
            occ = _any_hit(static, _offset_origin(hp, nrm, wi), wi, tm,
                           skip_rows=frozenset.intersection(
                               *[frozenset(s) for s in static["occl_skip"]]),
                           skip_light=pick if robust else None)
            okf = _where(ok & ~occ, w * _f32(L), 0.0)
            bp = li_s * ucos * okf * lobe_scale
            ld = col_nee_tbl * emit_l * bp
            kap = _kappa(exponent, wo_l, wi_l) if texp else None
            if residual:
                planes[res_ix[("B", bounce, 0)]] = bp
                if texp:
                    planes[res_ix[("Bk", bounce, 0)]] = _where(
                        lobe_is_phong, bp * kap, 0.0)
            if replay:
                add = gb * col_nee * bp[:, None]
                for i in range(L):
                    val = _where0(sel[i], add)
                    if tagged:
                        acc_le[:, i] += val
                    elif i in light_row:
                        acc_e[:, light_row[i]] += val
                    elif lights[i]["kind"] == klights.ENV:
                        acc_env = acc_env + val
                nee_adjoint(gb * emit_pick * bp[:, None], kap)
        else:
            u1, u2 = rng.uniform2()
            azim = None
            if any(lt["kind"] in (klights.AREA_SPHERE, klights.ENV)
                   for lt in lights):
                cphi_s = torch.cos(_TWO_PI * u2)
                azim = (cphi_s, _sin_from_phi_cos(cphi_s, u2))
            smps = [_light_sample(lt, world_radius, hp, nrm, u1, u2, azim)
                    for lt in lights]
            nds = [nrm.dot(smp[0]) for smp in smps]
            if all(smp[4] is not None for smp in smps):
                phits_prev = [smp[4] for smp in smps]
            occs = _any_hit_multi(
                static, hp, nrm,
                [(smp[0], smp[3] - _SHADOW_EPS) for smp in smps],
                occl_skips, robust=robust, sphere_skips=sph_skips if robust
                else None, nd=nds)
            for i, lt in enumerate(lights):
                wi, pdf_l, li_s, _dist, _ = smps[i]
                emit_l = V3(tables.light_emit[i, 0], tables.light_emit[i, 1],
                            tables.light_emit[i, 2])
                cos_aw = wr_w.dot(wi) if wr_w is not None \
                    else torch.zeros_like(o.x)
                pdf_b, f_unit_e = _bsdf_eval_pdf_dots(
                    kind, exponent, wo_l.z, nds[i], cos_aw, eval_lobes,
                    static_exp)
                ucos = f_unit_e * torch.abs(nds[i])
                if klights.is_delta_light(lt["kind"]):
                    w = km.div(1.0, pdf_l)
                else:
                    w = km.div(1.0, pdf_l + pdf_b)
                ok = nee_base & (pdf_l > 0.0)
                okf = _where(ok & ~occs[i], w * 1.0, 0.0)
                bp = li_s * ucos * okf * lobe_scale
                ld = ld + col_nee_tbl * emit_l * bp
                kap = _kappa_dot(exponent, cos_aw) if texp else None
                if residual:
                    planes[res_ix[("B", bounce, i)]] = bp
                    if texp:
                        planes[res_ix[("Bk", bounce, i)]] = _where(
                            lobe_is_phong, bp * kap, 0.0)
                if replay:
                    add = gb * col_nee * bp[:, None]
                    if tagged:
                        acc_le[:, i] += add
                    elif i in light_row:
                        acc_e[:, light_row[i]] += add
                    elif lt["kind"] == klights.ENV:
                        acc_env = acc_env + add
                    nee_adjoint(gb * tables.light_emit[i] * bp[:, None],
                                kap)
        big_l = big_l + beta * ld
        e_term = e_term + ld

        # extension sample
        u1, u2 = rng.uniform2()
        f_s, wi_l, pdf_s, delta_s, f_unit_s, refract = _bsdf_sample(
            kind, color, color2, eta, exponent, wo_l, u1, u2, lobes,
            static_exp)
        wi_w = to_world(s_f, t_f, n_f, wi_l)
        ok = cont & ~f_s.is_black() & (pdf_s != 0.0)
        thr = f_s * km.safe_div(torch.abs(wi_l.z), pdf_s)
        beta_new = beta * thr
        # kill lanes whose throughput overflows float32
        ok = ok & (beta_new.max_component() < math.inf)
        scale = 1.0
        if bounce > cfg.rr_start:
            u_rr = rng.uniform()
            q = torch.clamp_min(1.0 - beta_new.max_component(), _f32(0.05))
            kill = u_rr < q
            scale = km.safe_div(1.0, 1.0 - q)
            beta_new = beta_new * scale
            alive_n = ok & ~kill
        else:
            alive_n = ok
        to_spec_t = is_mirror | (is_glass & ~refract) | lobe_is_phong
        if residual or replay:
            t_unit = f_unit_s * km.safe_div(torch.abs(wi_l.z), pdf_s) * scale
            tu_plane = _where(alive_n, t_unit * lobe_scale, 0.0)
            kap_s = _kappa(exponent, wo_l, wi_l) if texp else None
        if residual:
            planes[res_ix[("tu", bounce)]] = tu_plane
            if texp:
                planes[res_ix[("tuk", bounce)]] = _where(
                    lobe_is_phong, tu_plane * kap_s, 0.0)
            packed = pack_row(sid + 1) + lobe_is_phong.to(torch.int32) * 256 \
                + to_spec_t.to(torch.int32) * 512
            if picks_one_light(cfg, L):
                packed = packed + pick.to(torch.int32) * 2048
            if has_img:
                tx = ty = torch.zeros_like(o.x)
            for rec, onrow, even, xy, _ in tex_hits if textured else ():
                if even is not None:   # the checker parity in bit 10
                    packed = packed + (onrow & even).to(torch.int32) * 1024
                else:
                    tx = torch.where(onrow, xy[0], tx)
                    ty = torch.where(onrow, xy[1], ty)
            if has_img:
                planes[res_ix[("tx", bounce)]] = tx
                planes[res_ix[("ty", bounce)]] = ty
            ints[bounce] = _where(alive, packed, 0)
        if replay:
            # R_{b+1} = (R_b - E_b) / T_b per channel, 0 where the path ends
            t_eff = _where0(alive_n, _st(thr * scale))
            r_next = _where0(alive_n, km.safe_div(_st(r_tail) - _st(e_term),
                                                  t_eff))
            addt = gb * r_next * tu_plane[:, None]
            addc_spec = addc_spec + _where0(to_spec_t, addt)
            addc_diff = addc_diff + _where0(~to_spec_t, addt)
            if texp:
                addx = addx + _where0(lobe_is_phong,
                                      _dot3(addt, col_nee) * kap_s)
            if textured:
                addc_diff = _route_textures(tex_hits, addc_diff, acc_ta,
                                            acc_tb, entries)
            if tagged:
                dplanes.extend(_tagged_planes(
                    (rows_d, addc_diff), (rows_s, addc_spec), de_b,
                    (rows_x, addx) if texp else None, sid))
            else:
                _row_add(acc_d, rows_d, sid, addc_diff)
                _row_add(acc_s, rows_s, sid, addc_spec)
                if texp:
                    _row_add(acc_x, rows_x, sid, addx)
            r_tail = V3(r_next[:, 0], r_next[:, 1], r_next[:, 2])
        o = _offset_origin(hp, nrm, wi_w).where(alive_n, o)
        d = wi_w.where(alive_n, d)
        beta = beta_new.where(alive_n, beta)
        if has_delta:
            spec_prev = torch.where(alive_n, delta_s, spec_prev)
        pdf_prev = torch.where(alive_n, pdf_s, pdf_prev)
        alive = alive_n

    if replay:
        tex_acc = ([acc_ta.reshape(n, -1), acc_tb.reshape(n, -1)]
                   if textured else [])
        if tagged:
            grads = tagged_grads(
                static, cfg, row_sums_plain(torch.stack(dplanes),
                                            torch.stack(tags), M, cfg),
                sum_lanes(torch.cat([acc_env, acc_le.reshape(n, -1)]
                                    + tex_acc, dim=1)))
        else:
            acc = [acc_d.reshape(n, -1), acc_s.reshape(n, -1),
                   acc_e.reshape(n, -1), acc_env] + (
                [acc_x] if texp else []) + tex_acc
            grads = split_grads(sum_lanes(torch.cat(acc, dim=1)), M, texp, T)
        if not has_img:
            return grads
        return grads + (texel_sums_plain(static, entries, n),)
    out = torch.stack([big_l.x, big_l.y, big_l.z], dim=-1)
    if not residual:
        return out
    return out, torch.stack(planes), torch.stack(ints)


# ---------------------------------------------------------------------------
# plain version: the coefficient-cache backward (K3)
# ---------------------------------------------------------------------------

# K3's block and its second pass's block (csrc/wavefront_bwd_res.cu)
BWD_THREADS = 128
SUM_THREADS = 256


def sum_lanes(acc: torch.Tensor) -> torch.Tensor:
    """(N, K) per-lane adjoints -> (K,) in K3's fixed order: each block of
    BWD_THREADS lanes sums its warps as a shuffle tree (lane i += lane
    i + off, off = 16 .. 1) and the four warp sums as (w0 + w1) + (w2 + w3);
    the second pass's thread t sums blocks t, t + SUM_THREADS, ... in turn,
    then the SUM_THREADS threads reduce as a tree (off = 128 .. 1). The
    same float additions in the same order as the kernel, so the two agree
    to the last bit and the gradient repeats from run to run."""
    n, k = acc.shape
    nb = max(1, -(-n // BWD_THREADS))
    x = acc.new_zeros((nb * BWD_THREADS, k))
    x[:n] = acc
    x = x.reshape(nb, BWD_THREADS // 32, 32, k)
    for off in (16, 8, 4, 2, 1):
        x[:, :, :off] = x[:, :, :off] + x[:, :, off:2 * off]
    w = x[:, :, 0]
    part = (w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3])
    s = acc.new_zeros((SUM_THREADS, k))
    for j in range(0, nb, SUM_THREADS):
        chunk = part[j:j + SUM_THREADS]
        s[:len(chunk)] = s[:len(chunk)] + chunk
    off = SUM_THREADS // 2
    while off:
        s[:off] = s[:off] + s[off:2 * off]
        off //= 2
    return s[0]


def split_grads(vec: torch.Tensor, m_rows: int, texp: bool = False,
                n_tex: int = 0):
    """K3's and K4's gradient vector, dd | ds | de (each (M, 3) row-major)
    | denv (3,) [| dexp (M,), under trainable_exponent] [| dta | dtb (each
    (T, 3)), the checker adjoints of a textured scene's T textures] ->
    (dd, ds, de, denv[, dexp][, dta, dtb])."""
    m3 = 3 * m_rows
    out = (vec[:m3].reshape(m_rows, 3), vec[m3:2 * m3].reshape(m_rows, 3),
           vec[2 * m3:3 * m3].reshape(m_rows, 3), vec[3 * m3:3 * m3 + 3])
    k = 3 * m3 + 3
    if texp:
        out += (vec[k:k + m_rows],)
        k += m_rows
    if n_tex:
        out += (vec[k:k + 3 * n_tex].reshape(n_tex, 3),
                vec[k + 3 * n_tex:k + 6 * n_tex].reshape(n_tex, 3))
    return out


# threads of the segment-sum block (csrc/bigscene_bwd_res.cu)
SEG_THREADS = 512


def sort_tags(tags: torch.Tensor, m_rows: int):
    """The entries (plane j, lane i) of (J, N) integer tags, numbered
    j * N + i, sorted by tag (a stable sort of integer keys: each tag's
    entries stay in plane, then lane order) -> (perm, starts): tag m's
    entries are perm[starts[m]:starts[m + 1]], tag 0 the entries that go
    nowhere. K7 and K8 tag by row + 1, K3's and K4's texel entries by
    texel + 1."""
    ids = tags.reshape(-1).long()
    _, perm = torch.sort(ids, stable=True)
    counts = torch.bincount(ids, minlength=m_rows + 1)
    starts = torch.zeros(m_rows + 2, dtype=torch.int64, device=ids.device)
    starts[1:] = torch.cumsum(counts, 0)
    return perm, starts


def _entry_values(dout, ent, n: int, B: int, PB: int):
    """The PB adjoint columns of entries `ent` (any shape): dout's planes
    PB*b .. PB*b+PB-1 at lane i for b < B; for b = B (K7's and K8's
    horizon) 0, except de (columns 6-8) from its three planes."""
    b = ent // n
    lane = ent - b * n
    col = torch.arange(PB, device=dout.device)
    plane = torch.where(b[..., None] < B, PB * b[..., None] + col,
                        PB * B + (col - 6).clamp(0, 2))
    v = dout[plane, lane[..., None]]
    keep = (b[..., None] < B) | ((col >= 6) & (col < 9))
    return torch.where(keep, v, torch.zeros_like(v))


def segment_sums_plain(dout, perm, starts, n: int, B: int, PB: int):
    """(M, PB) sums by tag, in the segment-sum kernel's order: for each tag
    m >= 1, thread t of a SEG_THREADS block adds the tag's sorted entries
    t, t + SEG_THREADS, ... in turn (from 0.0), then the threads reduce as
    a tree (off = SEG_THREADS/2 .. 1). The same float additions in the same
    order as csrc/bigscene_bwd_res.cu."""
    T = SEG_THREADS
    M = len(starts) - 2
    lens = (starts[2:] - starts[1:-1])
    acc = dout.new_zeros((M, T, PB))
    tid = torch.arange(T, device=dout.device)
    max_len = int(lens.max()) if M else 0
    for s0 in range(0, max_len, T):
        rows = (lens > s0).nonzero().reshape(-1)
        pos = starts[1 + rows][:, None] + s0 + tid
        valid = (s0 + tid) < lens[rows][:, None]
        ent = perm[pos.clamp_max(len(perm) - 1)]
        vals = _entry_values(dout, ent, n, B, PB)
        acc[rows] = acc[rows] + torch.where(valid[..., None], vals,
                                            torch.zeros_like(vals))
    off = T // 2
    while off:
        acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0]


def per_bounce(cfg: KernelConfig) -> int:
    """Row-tagged adjoint planes a bounce below the horizon: dd, ds, de [,
    dexp]."""
    return 10 if cfg.trainable_exponent else 9


def row_sums_plain(dout, tags, m_rows: int, cfg: KernelConfig):
    """Row-tagged planes dout (PB*max_depth + 3, N) summed by the row tags
    (max_depth + 1, N) (row + 1, 0 for none) in the segment-sum kernel's
    order -> (M, PB)."""
    perm, starts = sort_tags(tags, m_rows)
    return segment_sums_plain(dout, perm, starts, dout.shape[1],
                              cfg.max_depth, per_bounce(cfg))


def tagged_grads(static, cfg: KernelConfig, seg, lane_sums,
                 light_rows: dict | None = None) -> tuple:
    """(M, PB) row sums and the lane sums env (3) | per-light emission (3L)
    [| dta | dtb (3T each)] -> (dd, ds, de, denv[, dexp][, dta, dtb]), the
    tables of `split_grads`: each light's NEE emission adjoint goes to its
    emitting row (`light_rows`, default `_light_rows`), or to env for the
    environment light; point and directional lights get none. K3 and K4
    past DENSE_MAX_ROWS surfaces, K7 and K8."""
    L = len(static["lights"])
    rows = _light_rows(static) if light_rows is None else light_rows
    dd, ds, de = seg[:, 0:3], seg[:, 3:6], seg[:, 6:9].clone()
    denv = lane_sums[0:3]
    for i, lt in enumerate(static["lights"]):
        dle = lane_sums[3 + 3 * i:6 + 3 * i]
        if i in rows:
            de[rows[i]] = de[rows[i]] + dle
        elif lt["kind"] == klights.ENV:
            denv = denv + dle
    out = (dd, ds, de, denv) + ((seg[:, 9],) if cfg.trainable_exponent
                                else ())
    T = _n_tex(static)
    if T:
        k = 3 + 3 * L
        out += (lane_sums[k:k + 3 * T].reshape(T, 3),
                lane_sums[k + 3 * T:k + 6 * T].reshape(T, 3))
    return out


def _texel_shape(static) -> tuple:
    rec = next(r for r in static["textures"] if r["kind"] == "image")
    return (static["n_texels"] // (rec["th"] * rec["tw"]), rec["th"],
            rec["tw"], 3)


def texel_sums_plain(static, entries, n: int) -> torch.Tensor:
    """The texel-tagged entries of K3 or K4 (4 slots a bounce below the
    horizon, each ((N, 3) values, (N,) tags)) summed by texel in the
    segment-sum kernel's order -> the (Ti, H, W, 3) atlas gradient."""
    J = len(entries)
    dout = torch.stack([v for v, _ in entries]).permute(0, 2, 1).reshape(
        3 * J, n)
    perm, starts = sort_tags(torch.stack([t for _, t in entries]),
                             static["n_texels"])
    return segment_sums_plain(dout, perm, starts, n, J, 3).reshape(
        _texel_shape(static))


def bwd_res_plain(tables: SceneTables, cfg: KernelConfig, g: torch.Tensor,
                  big_l: torch.Tensor, resf: torch.Tensor,
                  resi: torch.Tensor):
    """Plain K3, the coefficient-cache backward (kytpu's
    `_make_bwd_res_kernel`) on lane tensors: upstream gradient g and
    radiance big_l (N, 3), the cache of K2 -> (dd, ds, de, denv[, dexp]) of
    shapes (M, 3), (M, 3), (M, 3), (3,)[, (M,) under
    cfg.trainable_exponent], the per-lane adjoints summed in the kernel's
    order (`sum_lanes`).

    Per bounce it reads sid and the lobe bits from resi and peels the tail
    radiance R_{b+1} = (R_b - E_b) / T_b, with E_b and T_b rebuilt
    bilinearly from the cached coefficients and the colour tables: no
    intersection, no random numbers. Only adjoint-eligible rows are ever
    added to (a mirror row's diffuse, a matte row's specular, a non-light
    row's emission stay exactly 0), and each lane adds to one row per term,
    in the kernel's order. The NEE emission adjoint goes to the light's
    emitting row, or to env for the environment light; point and
    directional lights get none. Under nee="single" the picked light is
    read from resi bits 11-15, never recomputed. The exponent adjoint of a
    plastic row is bilinear in the cache too: each "Bk" plane weighs the
    NEE term's colour cotangent and "tuk" the extension's. A textured row's
    diffuse is its texture's value, rebuilt from the checker parity (resi
    bit 10) or the "tx"/"ty" planes, and its diffuse adjoint goes to the
    texture ([dta, dtb] after dexp; the atlas gradient dti last, summed by
    texel as `texel_sums_plain` does). Past DENSE_MAX_ROWS surfaces
    (`row_tagged`) each bounce's adjoints of its hit row are row-tagged
    entries, summed by row in a fixed order (`row_sums_plain`,
    `tagged_grads`), as K7's are."""
    check_config(cfg)
    static = tables.static
    mats, lights = static["mats"], static["lights"]
    M, L = len(mats["kind"]), len(lights)
    res_ix, res_n = residual_layout(static, cfg)
    if resf.shape[0] != res_n or resi.shape[0] != cfg.max_depth + 1:
        raise ValueError(f"cache of {resf.shape[0]} float and "
                         f"{resi.shape[0]} int planes; this scene and config "
                         f"take {res_n} and {cfg.max_depth + 1}")
    single = picks_one_light(cfg, L)
    has_env = any(lt["kind"] == klights.ENV for lt in lights)
    light_row = _light_rows(static)
    texp = cfg.trainable_exponent
    n = g.shape[0]
    dev = g.device
    kind_tab = torch.tensor(mats["kind"], device=dev)
    li_tab = torch.tensor(mats["light_index"], device=dev)
    ok_d = kind_tab != kbsdf.MAT_MIRROR
    ok_s = kind_tab != kbsdf.MAT_MATTE
    ok_e = li_tab >= 0
    ok_x = kind_tab == kbsdf.MAT_PLASTIC
    tagged = row_tagged(static)
    if tagged:
        acc_le = g.new_zeros((n, L, 3))
        dplanes, tags = [], []
    else:
        acc_d = g.new_zeros((n, M, 3))
        acc_s = g.new_zeros((n, M, 3))
        acc_e = g.new_zeros((n, M, 3))
        acc_x = g.new_zeros((n, M))
    acc_env = g.new_zeros((n, 3))
    textured, has_img = bool(static["textures"]), _has_img(static)
    T = _n_tex(static)
    acc_ta, acc_tb = g.new_zeros((n, T, 3)), g.new_zeros((n, T, 3))
    entries = [] if has_img else None
    emit_l = tables.light_emit
    env = tables.env

    def sel(tab, ok_tab, sid):
        sc = sid.clamp_min(0).long()
        ok = (sid >= 0) & ok_tab[sc]
        return torch.where(ok[:, None], tab[sc], torch.zeros_like(tab[sc]))

    beta = torch.ones_like(g)
    r_tail = big_l
    for b in range(cfg.max_depth + 1):
        ib = resi[b].to(torch.int32)
        sid = unpack_row(ib) - 1
        wb = resf[res_ix[("wb", b)]][:, None]
        gb = g * beta
        if tagged:
            de_b = _where0(_eligible(ok_e, sid), gb * wb)
            tags.append(sid + 1)
        else:
            _row_add(acc_e, ok_e, sid, gb * wb)
        if has_env:
            wenv = resf[res_ix[("wenv", b)]][:, None]
            acc_env = acc_env + gb * wenv
        if b == cfg.max_depth:
            if tagged:
                dplanes.extend(de_b.unbind(1))
            break
        phong = ((ib & 256) != 0)[:, None]
        to_spec = ((ib & 512) != 0)[:, None]
        diff_sel = sel(tables.diffuse, ok_d, sid)
        tex_hits = []
        for rec in static["textures"]:
            onrow = sid == rec["row"]
            if rec["kind"] == "image":
                slots = _image_taps(rec, resf[res_ix[("tx", b)]],
                                    resf[res_ix[("ty", b)]])
                col = _st(_image_color(rec, slots, tables.timg))
                tex_hits.append((rec, onrow, None, None, slots))
            else:
                even = (ib & 1024) != 0
                col = torch.where(even[:, None], tables.texa[rec["tex"]],
                                  tables.texb[rec["tex"]])
                tex_hits.append((rec, onrow, even, None, None))
            diff_sel = torch.where(onrow[:, None], col, diff_sel)
        spec_sel = sel(tables.specular, ok_s, sid)
        emit_sel = sel(tables.emission, ok_e, sid)
        col_nee = torch.where(phong, spec_sel, diff_sel)
        e_term = emit_sel * wb
        if has_env:
            e_term = e_term + env * wenv
        addc = torch.zeros_like(g)
        addx = torch.zeros_like(g[:, 0])
        picks = ([(((ib >> 11) & 31).long(), 0)] if single
                 else [(i, i) for i in range(L)])
        for pick, j in picks:
            bp = resf[res_ix[("B", b, j)]][:, None]
            e_l = emit_l[pick]
            e_term = e_term + col_nee * e_l * bp
            add = gb * col_nee * bp
            for i in range(L) if single else [pick]:
                val = torch.where((pick == i)[:, None], add, 0.0) if single \
                    else add
                if tagged:
                    acc_le[:, i] += val
                elif i in light_row:
                    acc_e[:, light_row[i]] += val
                elif lights[i]["kind"] == klights.ENV:
                    acc_env = acc_env + val
            addc = addc + gb * e_l * bp
            if texp:
                addx = addx + _dot3(gb * e_l, col_nee) \
                    * resf[res_ix[("Bk", b, j)]]
        tu = resf[res_ix[("tu", b)]][:, None]
        t_eff = torch.where(to_spec, spec_sel, diff_sel) * tu
        r_next = km.safe_div(r_tail - e_term, t_eff)
        addt = gb * r_next * tu
        # NEE colour adjoint: to specular on phong lanes, else diffuse; the
        # extension's: to specular where the sampled lobe read it
        addc_diff = torch.where(phong, 0.0, addc) + torch.where(to_spec, 0.0,
                                                                addt)
        if textured:
            addc_diff = _route_textures(tex_hits, addc_diff, acc_ta, acc_tb,
                                        entries)
        addc_spec = torch.where(phong, addc, 0.0) \
            + torch.where(to_spec, addt, 0.0)
        if texp:
            # "tuk" is 0 off phong lanes, whose extension read specular
            addx = addx + _dot3(gb * r_next, spec_sel) \
                * resf[res_ix[("tuk", b)]]
        if tagged:
            dplanes.extend(_tagged_planes(
                (ok_d, addc_diff), (ok_s, addc_spec), de_b,
                (ok_x, addx) if texp else None, sid))
        else:
            _row_add(acc_d, ok_d, sid, addc_diff)
            _row_add(acc_s, ok_s, sid, addc_spec)
            if texp:
                _row_add(acc_x, ok_x, sid, addx)
        beta = beta * t_eff
        r_tail = r_next
    tex_acc = ([acc_ta.reshape(n, -1), acc_tb.reshape(n, -1)] if textured
               else [])
    if tagged:
        grads = tagged_grads(
            static, cfg, row_sums_plain(torch.stack(dplanes),
                                        torch.stack(tags), M, cfg),
            sum_lanes(torch.cat([acc_env, acc_le.reshape(n, -1)] + tex_acc,
                                dim=1)))
    else:
        acc = [acc_d.reshape(n, -1), acc_s.reshape(n, -1),
               acc_e.reshape(n, -1), acc_env] + ([acc_x] if texp else []) \
            + tex_acc
        grads = split_grads(sum_lanes(torch.cat(acc, dim=1)), M, texp, T)
    if not has_img:
        return grads
    return grads + (texel_sums_plain(static, entries, n),)


# ---------------------------------------------------------------------------
# the wrapper: CUDA tensors launch csrc/wavefront_fwd.cu, CPU tensors run
# the plain version
# ---------------------------------------------------------------------------

# kernel launches made by this process (set them to 0 to count a run): K1,
# K2 (the residual forward), K3 (the coefficient-cache backward) and K4
# (the path-replay backward)
launches = 0
launches_res_fwd = 0
launches_res_bwd = 0
launches_replay = 0

SAMPLERS = {"random": 0, "hash": 1, "sobol": 2}
# the kernel keeps the sobol words of at most 4 draw sites a bounce in a
# constant table (csrc/wavefront_fwd.cu MAX_SITES)
MAX_SOBOL_DEPTH = 64


def _i32(v: int) -> int:
    return ((int(v) + (1 << 31)) % (1 << 32)) - (1 << 31)


_TABLES = ("f", "i", "diffuse", "specular", "emission", "exponent",
           "light_emit", "env", "texa", "texb", "timg")


def _check_tables(tables: SceneTables, dev):
    for name in _TABLES:
        t = getattr(tables, name)
        if t.device != dev:
            raise ValueError(f"table {name} is on {t.device}, the lanes on "
                             f"{dev}")
        if not t.is_contiguous() or t.dtype != (
                torch.int32 if name == "i" else torch.float32):
            raise ValueError(f"table {name} must be contiguous "
                             f"{'int32' if name == 'i' else 'float32'}")


def _check_lane_tensor(name, t, shape, dtype, dev):
    if t.device != dev or tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: expected {shape} {dtype} on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _n_cols(tables: SceneTables, cfg: KernelConfig) -> int:
    """Length of K3's and K4's lane-summed vector: the dense gradient
    vector (`split_grads`), or past DENSE_MAX_ROWS surfaces env | the
    lights' emission | dta | dtb (`tagged_grads`)."""
    static = tables.static
    if row_tagged(static):
        return 3 + 3 * len(static["lights"]) + 6 * _n_tex(static)
    m_rows = len(static["mats"]["kind"])
    return ((10 if cfg.trainable_exponent else 9) * m_rows + 3
            + 6 * _n_tex(static))


def _row_outputs(tables: SceneTables, cfg: KernelConfig, n: int, dev):
    """K3's and K4's row-tagged planes (PB max_depth + 3, n) and row tags
    (max_depth + 1, n) past DENSE_MAX_ROWS surfaces, else (None, None)."""
    if not row_tagged(tables.static):
        return None, None
    B = cfg.max_depth
    return (torch.empty((per_bounce(cfg) * B + 3, n), dtype=torch.float32,
                        device=dev),
            torch.empty((B + 1, n), dtype=torch.int32, device=dev))


def _texel_outputs(tables: SceneTables, cfg: KernelConfig, n: int, dev):
    """K3's and K4's texel entries (12 max_depth, n) and tags (4 max_depth,
    n) where the scene has image textures, else (None, None)."""
    if not _has_img(tables.static):
        return None, None
    J = 4 * cfg.max_depth
    return (torch.empty((3 * J, n), dtype=torch.float32, device=dev),
            torch.empty((J, n), dtype=torch.int32, device=dev))


def segment_sums(lib, dout, tags, m_tags: int, n_planes: int, n_cols: int):
    """Tagged entries summed by tag on the card: the stable integer sort of
    the (n_planes, n) tags (torch.sort moves no floats), then the
    segment-sum kernel of csrc/bigscene_bwd_res.cu -> (m_tags, n_cols), in
    `segment_sums_plain`'s order."""
    perm, starts = sort_tags(tags, m_tags)
    seg = torch.empty((m_tags, n_cols), dtype=torch.float32,
                      device=dout.device)
    _run(lib.kytpu_bigscene_segment_sums, "segment_sums", dout.device,
         dout.data_ptr(), perm.data_ptr(), starts.data_ptr(),
         seg.data_ptr(), dout.shape[1], m_tags, n_planes, n_cols)
    return seg


def _grads_of(lib, tables: SceneTables, cfg: KernelConfig, vec, tex, rows):
    """K3's or K4's outputs on the card -> (dd, ds, de, denv[, dexp][, dta,
    dtb][, dti]): the lane-summed vector split (`split_grads`), or past
    DENSE_MAX_ROWS surfaces the row-tagged planes summed by row with it
    (`tagged_grads`); the texel entries summed by texel. tex, rows: (the
    planes, their tags), or (None, None)."""
    static = tables.static
    if rows[1] is None:
        grads = split_grads(vec, len(static["mats"]["kind"]),
                            cfg.trainable_exponent, _n_tex(static))
    else:
        grads = tagged_grads(static, cfg, segment_sums(
            lib, *rows, len(static["mats"]["kind"]), cfg.max_depth,
            per_bounce(cfg)), vec)
    if tex[1] is None:
        return grads
    seg = segment_sums(lib, *tex, static["n_texels"], tex[1].shape[0], 3)
    return grads + (seg.reshape(_texel_shape(static)),)


def _lanes(tables: SceneTables, cfg: KernelConfig, o, d, si, pix):
    """One launch's lanes, checked -> contiguous (o, d, si, pix) on o's
    device; si and pix are None under the "random" sampler."""
    _check_tables(tables, o.device)
    return _lanes_checked(o, d, si, pix, cfg)


def _lanes_checked(o, d, si, pix, cfg: KernelConfig):
    """`_lanes` without the tables: the rays and lane ids of a launch."""
    dev = o.device
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3):
        raise ValueError(f"rays must be (N, 3), got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")
    if d.device != dev:
        raise ValueError(f"d is on {d.device}, o on {dev}")
    if cfg.sampler == "sobol" and cfg.max_depth > MAX_SOBOL_DEPTH:
        raise ValueError(f'sampler="sobol" takes max_depth <= '
                         f"{MAX_SOBOL_DEPTH} on the card")
    o = o.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    if cfg.sampler == "random":
        return o, d, None, None
    if si is None or pix is None:
        raise ValueError(f'sampler="{cfg.sampler}" needs si and pix lane '
                         'arrays')
    si = si.to(device=dev, dtype=torch.int32).contiguous()
    pix = pix.to(device=dev, dtype=torch.int32).contiguous()
    if si.shape != (n,) or pix.shape != (n,):
        raise ValueError(f"si and pix must be ({n},), got {tuple(si.shape)} "
                         f"and {tuple(pix.shape)}")
    return o, d, si, pix


def _lane_ptrs(tables: SceneTables, o, d, si, pix) -> list:
    """The pointer arguments K1, K2 and K4 share: tables, rays, lane ids."""
    return [getattr(tables, nm).data_ptr() for nm in _TABLES] + [
        o.data_ptr(), d.data_ptr(), None if si is None else si.data_ptr(),
        None if pix is None else pix.data_ptr()]


def _cfg_args(cfg: KernelConfig, seed: int) -> list:
    return [_i32(seed), cfg.max_depth, cfg.rr_start, cfg.rows,
            SAMPLERS[cfg.sampler], int(cfg.shadow == "robust")]


def _scene_args(tables: SceneTables, cfg: KernelConfig) -> list:
    """K1's, K2's and K4's last arguments: whether the scene is textured,
    the bytes of the tables a block stages in shared memory, the shadow
    rays a chunk of the nee="all" light loop holds (0 under nee="single"),
    and whether K1 and K2 refill dead lanes (`REFILL_MAX_ROWS`)."""
    n_l = len(tables.static["lights"])
    rays = 0 if picks_one_light(cfg, n_l) else min(n_l, NEE_CHUNK)
    refill = len(tables.static["mats"]["kind"]) <= REFILL_MAX_ROWS
    return [int(bool(tables.static["textures"])), tables.stage_bytes, rays,
            int(refill)]


def refill_chunk(tables: SceneTables, cfg: KernelConfig, n: int,
                 residual: bool = False) -> int:
    """The lanes a warp of K1 (K2 with residual=True) owns in a launch of n
    lanes of these tables on the current card: its 32 threads trace them in
    turn, a thread taking the chunk's next lane when its lane ends
    (dead-lane refill, csrc/wavefront_fwd.cu `refill_chunk`)."""
    from kytpu_torch.kernels import build

    chunk = build.load().kytpu_wavefront_chunk(
        int(residual), n, SAMPLERS[cfg.sampler], *_scene_args(tables, cfg))
    if chunk < 0:
        raise RuntimeError("kytpu_wavefront_chunk failed")
    return chunk


def _run(fn, name: str, dev, *args):
    """fn(*args, stream) on dev's current stream; raises on a CUDA error."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch(tables: SceneTables, cfg: KernelConfig, o, d, seed, si, pix,
            residual: bool = False):
    """K1 (or K2 with residual=True) on CUDA lanes -> radiance (or
    (radiance, resf, resi)); raises if the kernel cannot be built or
    launched."""
    global launches, launches_res_fwd
    from kytpu_torch.kernels import build

    o, d, si, pix = _lanes(tables, cfg, o, d, si, pix)
    n, dev = o.shape[0], o.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    args = _lane_ptrs(tables, o, d, si, pix) + [out.data_ptr()]
    if residual:
        _, res_n = residual_layout(tables.static, cfg)
        # every plane of every lane is written by K2 (torch.empty, not zeros)
        resf = torch.empty((res_n, n), dtype=torch.float32, device=dev)
        resi = torch.empty((cfg.max_depth + 1, n), dtype=torch.int32,
                           device=dev)
        args += [resf.data_ptr(), resi.data_ptr()]
    lib = build.load()
    name = "wavefront_fwd_res" if residual else "wavefront_fwd"
    _run(getattr(lib, "kytpu_" + name), name, dev, *args, n,
         *_cfg_args(cfg, seed), *_scene_args(tables, cfg))
    if not residual:
        launches += 1
        return out
    launches_res_fwd += 1
    return out, resf, resi


def _launch_bwd(tables: SceneTables, cfg: KernelConfig, g, big_l, resf,
                resi):
    """K3 on CUDA lanes -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]);
    raises if a kernel cannot be built or launched."""
    global launches_res_bwd
    from kytpu_torch.kernels import build

    dev = g.device
    n = g.shape[0]
    m_rows = len(tables.static["mats"]["kind"])
    _, res_n = residual_layout(tables.static, cfg)
    for name, t, shape, dt in (
            ("g", g, (n, 3), torch.float32),
            ("L", big_l, (n, 3), torch.float32),
            ("resf", resf, (res_n, n), torch.float32),
            ("resi", resi, (cfg.max_depth + 1, n), torch.int32)):
        _check_lane_tensor(name, t, shape, dt, dev)
    _check_tables(tables, dev)
    g, big_l = g.contiguous(), big_l.contiguous()
    resf, resi = resf.contiguous(), resi.contiguous()
    k = _n_cols(tables, cfg)
    nb = max(1, -(-n // BWD_THREADS))
    partial = torch.empty((nb, k), dtype=torch.float32, device=dev)
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    tex = _texel_outputs(tables, cfg, n, dev)
    rows = _row_outputs(tables, cfg, n, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.load()
    _run(lib.kytpu_wavefront_bwd_res, "wavefront_bwd_res", dev,
         tables.i.data_ptr(), tables.diffuse.data_ptr(),
         tables.specular.data_ptr(), tables.emission.data_ptr(),
         tables.light_emit.data_ptr(), tables.env.data_ptr(),
         tables.texa.data_ptr(), tables.texb.data_ptr(),
         tables.timg.data_ptr(), g.data_ptr(), big_l.data_ptr(),
         resf.data_ptr(), resi.data_ptr(), partial.data_ptr(),
         out.data_ptr(), *map(ptr, tex), *map(ptr, rows), n, m_rows, k,
         cfg.max_depth, int(bool(tables.static["textures"])))
    launches_res_bwd += 1
    return _grads_of(lib, tables, cfg, out, tex, rows)


def _launch_replay(tables: SceneTables, cfg: KernelConfig, o, d, seed, si,
                   pix, g, big_l):
    """K4 on CUDA lanes -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]);
    raises if a kernel cannot be built or launched."""
    global launches_replay
    from kytpu_torch.kernels import build

    o, d, si, pix = _lanes(tables, cfg, o, d, si, pix)
    n, dev = o.shape[0], o.device
    _check_lane_tensor("g", g, (n, 3), torch.float32, dev)
    _check_lane_tensor("L", big_l, (n, 3), torch.float32, dev)
    g, big_l = g.contiguous(), big_l.contiguous()
    k = _n_cols(tables, cfg)
    nb = max(1, -(-n // BWD_THREADS))
    partial = torch.empty((nb, k), dtype=torch.float32, device=dev)
    out = torch.empty((k,), dtype=torch.float32, device=dev)
    tex = _texel_outputs(tables, cfg, n, dev)
    rows = _row_outputs(tables, cfg, n, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.load()
    _run(lib.kytpu_wavefront_bwd_replay, "wavefront_bwd_replay", dev,
         *_lane_ptrs(tables, o, d, si, pix), g.data_ptr(), big_l.data_ptr(),
         partial.data_ptr(), out.data_ptr(), *map(ptr, tex), *map(ptr, rows),
         n, k, *_cfg_args(cfg, seed), *_scene_args(tables, cfg))
    launches_replay += 1
    return _grads_of(lib, tables, cfg, out, tex, rows)


def make_cuda_tracer(scene: kscene.Scene, cfg: KernelConfig | None = None):
    """Lane tracer for `scene`'s geometry (kytpu's make_pallas_tracer).

    Returns fn(scene, o, d, seed, si=None, pix=None) -> (N, 3) radiance.
    The geometry tables are packed once; the colour and exponent tables are
    read from the `scene` given at each call, so parameter updates need no
    new tracer. CUDA tensors launch the kernel (and raise if it cannot be
    built or launched); CPU tensors run `trace_lanes_plain`."""
    cfg = cfg or KernelConfig()
    check_config(cfg)
    geo = pack_tables(scene, cfg)

    def trace(scene, o, d, seed, si=None, pix=None):
        return trace_lanes(geo.with_colors(scene), cfg, o, d, seed, si, pix)

    return trace


def _on_card(dev: torch.device) -> bool:
    if dev.type in ("cuda", "cpu"):
        return dev.type == "cuda"
    raise ValueError(f"no kernel for device {dev}")


def trace_lanes(tables: SceneTables, cfg: KernelConfig, o, d, seed: int,
                si=None, pix=None, residual: bool = False):
    """K1 (K2 with residual=True, see `trace_lanes_plain` for what it
    returns): CUDA lanes launch the kernel or raise, CPU lanes run the
    plain version."""
    if _on_card(o.device):
        return _launch(tables, cfg, o, d, seed, si, pix, residual)
    return trace_lanes_plain(tables, cfg, o, d, seed, si, pix, residual)


def bwd_res(tables: SceneTables, cfg: KernelConfig, g, big_l, resf, resi):
    """K3 -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]): CUDA lanes
    launch the kernels or raise, CPU lanes run `bwd_res_plain`."""
    if _on_card(g.device):
        return _launch_bwd(tables, cfg, g, big_l, resf, resi)
    return bwd_res_plain(tables, cfg, g, big_l, resf, resi)


def bwd_replay(tables: SceneTables, cfg: KernelConfig, o, d, seed: int, si,
               pix, g, big_l):
    """K4 -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]) on the lanes (o,
    d, seed, si, pix) that the forward traced, its radiance big_l and the
    upstream gradient g: CUDA lanes launch the kernels or raise, CPU lanes
    run `bwd_replay_plain`."""
    if _on_card(o.device):
        return _launch_replay(tables, cfg, o, d, seed, si, pix, g, big_l)
    return bwd_replay_plain(tables, cfg, o, d, seed, si, pix, g, big_l)


def render_lanes_cuda(scene, o, d, seed: int, cfg: KernelConfig | None = None,
                      si=None, pix=None):
    """One-shot wrapper around make_cuda_tracer (kytpu's
    render_lanes_pallas)."""
    return make_cuda_tracer(scene, cfg)(scene, o, d, seed, si, pix)


class _DiffTables:
    """A diff tracer's scene: the geometry tables packed once, and the
    colour (exponent, texture) tables of each call, NEE light emissions
    derived from them; and the kernels the autograd Functions run on them
    (looked up in this module at each call, so a caller may wrap them)."""

    def __init__(self, scene: kscene.Scene, cfg: KernelConfig):
        self.scene = scene
        self.cfg = cfg
        self.geo = self.pack(scene, cfg)
        static = self.geo.static
        self.textured = bool(static["textures"])
        self.has_img = _has_img(static)

    pack = staticmethod(pack_tables)

    def __call__(self, diffuse, specular, emission, env, exponent=None,
                 texa=None, texb=None, timg=None):
        dev = self.geo.f.device
        f32 = lambda t: t.detach().to(device=dev,  # noqa: E731
                                      dtype=torch.float32).contiguous()
        emission = f32(emission)
        env = f32(env).reshape(3)
        tex = (_texture_tables(self.scene, texa, texb, timg) if self.textured
               else {})
        return dataclasses.replace(
            self.geo, diffuse=f32(diffuse), specular=f32(specular),
            emission=emission, env=env,
            exponent=self.geo.exponent if exponent is None else f32(exponent),
            light_emit=light_emit_of(self.scene, emission, env).contiguous(),
            **tex)

    def grad_names(self) -> tuple:
        """The names of the backwards' outputs, in order."""
        return (("dd", "ds", "de", "denv")
                + (("dexp",) if self.cfg.trainable_exponent else ())
                + (("dta", "dtb") if self.textured else ())
                + (("dti",) if self.has_img else ()))

    def trace(self, tables, o, d, seed, si, pix, residual=False):
        return trace_lanes(tables, self.cfg, o, d, seed, si, pix,
                           residual=residual)

    def bwd_res(self, tables, g, big_l, resf, resi):
        return bwd_res(tables, self.cfg, g, big_l, resf, resi)

    def bwd_replay(self, tables, o, d, seed, si, pix, g, big_l):
        return bwd_replay(tables, self.cfg, o, d, seed, si, pix, g, big_l)


# the Functions' table inputs after `tabs`, and the gradient of each
_INPUT_GRADS = ("dd", "ds", "de", "dexp", "dta", "dtb", "dti", "denv")


def _table_grads(ctx, grads):
    """The backwards' outputs (`_DiffTables.grad_names`) -> the gradients
    of the Functions' inputs (tabs, diffuse, specular, emission, exponent,
    texa, texb, timg, env, o, d, seed, si, pix), None where no gradient
    was asked for; the atlas gradient in the shape of the timg given."""
    got = dict(zip(ctx.tabs.grad_names(), grads))
    if "dti" in got:
        got["dti"] = got["dti"].reshape(ctx.timg_shape)
    need = ctx.needs_input_grad
    return (None, *(got.get(nm) if need[1 + k] else None
                    for k, nm in enumerate(_INPUT_GRADS)),
            None, None, None, None, None)


def _keep(ctx, tabs, tables, timg):
    ctx.tables = tables
    ctx.tabs = tabs
    ctx.timg_shape = None if timg is None else timg.shape


class _ResidualTrace(torch.autograd.Function):
    """The forward launches the residual forward (K2, or the big-scene K6)
    and keeps its cache when a table needs a gradient (K1 or K5 otherwise);
    the backward launches the cache backward (K3 or K7): `tabs` says which.
    Rays, seed and the lane ids get no gradient (geometry derivatives are
    out of scope, as in the JAX package's detached-sampling estimator)."""

    @staticmethod
    def forward(ctx, tabs, diffuse, specular, emission, exponent, texa, texb,
                timg, env, o, d, seed, si, pix):
        tables = tabs(diffuse, specular, emission, env, exponent, texa, texb,
                      timg)
        if not any(ctx.needs_input_grad[1:9]):
            return tabs.trace(tables, o, d, seed, si, pix)
        big_l, resf, resi = tabs.trace(tables, o, d, seed, si, pix,
                                       residual=True)
        _keep(ctx, tabs, tables, timg)
        ctx.save_for_backward(big_l, resf, resi)
        return big_l

    @staticmethod
    def backward(ctx, g):
        big_l, resf, resi = ctx.saved_tensors
        return _table_grads(ctx, ctx.tabs.bwd_res(
            ctx.tables, g.to(torch.float32).contiguous(), big_l, resf, resi))


class _ReplayTrace(torch.autograd.Function):
    """The forward launches K1 and, when a table needs a gradient, keeps
    the lanes and the radiance (no cache: O(1) memory a lane beyond the
    inputs); the backward launches K4, which re-traces the lanes."""

    @staticmethod
    def forward(ctx, tabs, diffuse, specular, emission, exponent, texa, texb,
                timg, env, o, d, seed, si, pix):
        tables = tabs(diffuse, specular, emission, env, exponent, texa, texb,
                      timg)
        big_l = tabs.trace(tables, o, d, seed, si, pix)
        if any(ctx.needs_input_grad[1:9]):
            _keep(ctx, tabs, tables, timg)
            ctx.seed = seed
            ctx.save_for_backward(o, d, si, pix, big_l)
        return big_l

    @staticmethod
    def backward(ctx, g):
        o, d, si, pix, big_l = ctx.saved_tensors
        return _table_grads(ctx, ctx.tabs.bwd_replay(
            ctx.tables, o, d, ctx.seed, si, pix,
            g.to(torch.float32).contiguous(), big_l))


def diff_tracer(tabs: _DiffTables, fn):
    """fn(diffuse, specular, emission, [exponent,] [texa, texb,] [timg,]
    env, o, d, seed[, si, pix]) over the autograd Function `fn` and the
    tables `tabs` (kytpu's public argument order): the exponent is there
    iff tabs.cfg.trainable_exponent, the checker colours texa, texb (T, 3)
    iff the scene has texture records, the atlas timg (Ti, H, W, 3) iff it
    has image textures."""
    def trace(diffuse, specular, emission, *rest):
        rest = list(rest)
        exponent = (rest.pop(0) if tabs.cfg.trainable_exponent and rest
                    else None)
        texa = texb = timg = None
        if tabs.textured and len(rest) > 1:
            texa, texb = rest.pop(0), rest.pop(0)
        if tabs.has_img and rest:
            timg = rest.pop(0)
        if len(rest) not in (4, 6):
            raise TypeError("expected (env, o, d, seed[, si, pix]) after the "
                            "tables")
        env, o, d, seed, si, pix = rest + [None] * (6 - len(rest))
        return fn.apply(tabs, diffuse, specular, emission, exponent, texa,
                        texb, timg, env, o, d, seed, si, pix)

    trace.tabs = tabs
    return trace


def make_cuda_diff_tracer(scene: kscene.Scene, cfg: KernelConfig | None = None,
                          backward: str = "residual"):
    """Differentiable lane tracer (kytpu's make_pallas_diff_tracer) for
    `scene`'s geometry.

    Returns fn(diffuse, specular, emission, [exponent,] [texa, texb,]
    [timg,] env, o, d, seed[, si, pix]) -> (N, 3) radiance, a
    torch.autograd.Function whose gradient is (d_diffuse, d_specular,
    d_emission, [d_exponent,] [d_texa, d_texb,] [d_timg,] d_env) by
    detached sampling, the NEE light-emission adjoints routed to each
    light's emitting surface row (or to `env`) as `diff.params.set_params`
    ties them. `exponent` is there iff cfg.trainable_exponent (the signature
    is keyed on the cfg alone, as kytpu's); its gradient is 0 on every row
    but the plastic ones. texa, texb (T, 3), the checker colours, are there
    iff the scene has textured rows, timg (Ti, H, W, 3), the texel atlas,
    iff it has image textures; a textured row's diffuse adjoint goes to its
    texture (its diffuse-table gradient is 0). `env` is the (3,)
    environment radiance (zeros for a scene without one). NEE reads light
    emissions derived from the traced `emission` and `env`
    (`light_emit_of`).

    backward="residual": when a table requires grad the forward runs K2
    and keeps its coefficient cache (resf, resi) and radiance for the
    backward, K3; otherwise it runs K1. backward="replay": the forward runs
    K1 and keeps the lanes and radiance, the backward K4 re-traces them
    (no cache). CUDA tensors launch the kernels or raise, CPU tensors run
    their plain versions."""
    cfg = cfg or KernelConfig()
    fn = {"residual": _ResidualTrace, "replay": _ReplayTrace}.get(backward)
    if fn is None:
        raise ValueError(f"unknown backward {backward!r}")
    check_config(cfg)
    return diff_tracer(_DiffTables(scene, cfg), fn)


def render_cuda(scene: kscene.Scene, spp: int = 16, seed: int = 1234,
                cfg: KernelConfig | None = None, clamp: bool = True,
                rays_per_pass: int = 1 << 22, tracer=None) -> torch.Tensor:
    """Full-frame render through the kernel -> (H, W, 3) float32 on the
    scene's device (kytpu's render_pallas, same passes and defaults).

    Each pass traces k = min(spp, rays_per_pass // npix) samples of every
    pixel. "random": pass p jitters the camera with
    uniform(fold_in(key, p), (k*npix, 2)) and traces with seed + 7919*p.
    "hash" and "sobol": the seed stays fixed and lane (sample s, pixel q)
    carries (s, q) into the kernel, so a frame does not depend on the pass
    split; "hash" jitters with uniform(fold_in(key, s*npix + q), (2,)),
    "sobol" with point s of pixel q's Owen-Sobol sequence,
    uniform2(fold_in(key, q), "sobol", s)."""
    cfg = cfg or KernelConfig()
    if tracer is None:
        tracer = make_cuda_tracer(scene, cfg)
    dev = scene.device
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    k = max(1, min(spp, rays_per_pass // max(npix, 1)))
    pid = torch.arange(npix, dtype=torch.int64, device=dev)
    px0 = (pid % w).to(torch.float32).repeat(k)
    py0 = (pid // w).to(torch.float32).repeat(k)
    pid_k = pid.repeat(k)
    key = krng.key(seed, dev)
    if cfg.sampler == "sobol":
        # the camera-jitter site: a key per pixel, the same for every sample
        cam_keys = krng.fold_in(key, pid_k)
    accum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    s0 = p = 0
    while s0 < spp:
        if cfg.sampler in ("hash", "sobol"):
            si = p * k + torch.arange(k, dtype=torch.int64,
                                      device=dev).repeat_interleave(npix)
            if cfg.sampler == "sobol":
                u = krng.uniform2(cam_keys, "sobol", si)
            else:
                u = krng.uniform(krng.fold_in(key, si * npix + pid_k), (2,))
            args = (seed, _as_i32(si & _M32), pid_k.to(torch.int32))
        else:
            u = krng.uniform(krng.fold_in(key, p), (k * npix, 2))
            args = (_i32(seed + 7919 * p),)
        o, d = kscene.generate_rays(
            cam, torch.stack([px0 + u[:, 0], py0 + u[:, 1]], dim=-1))
        out = tracer(scene, o, d, *args)
        accum = accum + out.reshape(k, npix, 3).sum(dim=0)
        s0 += k
        p += 1
    img = km.div(accum, float(p * k)).reshape(h, w, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img
