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

What K5-K8 (kernels/bigscene.py) share with them lives in public modules
that import neither family: the launch protocol (kernels/launch.py), the
plain per-lane shading (kernels/shading.py), the autograd Functions
(kernels/autodiff.py), the sums by tag (kernels/tag_sums.py), the cull
geometry (kernels/cull.py) and the colour, texture and light records
(kernels/tables.py).

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
row, as K7 and K8 do (`row_tagged`, DENSE_MAX_ROWS), K2's int cache
keeps the row in 23 bits (`pack_row`), and past REFILL_MAX_ROWS surfaces
K1, K2 and K4 cull blocks of Morton-ordered rows at the warp under
cfg.cull, as K5-K8 do (`cull_tables`), with the full sweep's bits.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import math as km
from kytpu_torch.core import rng as krng
from kytpu_torch.kernels import autodiff as kad
from kytpu_torch.kernels import camera as kcam
from kytpu_torch.kernels import tables as ktab
from kytpu_torch.kernels import tag_sums as kts
from kytpu_torch.kernels.cull import (CLASSES, UNROLL, block_bounds, group,
                                      morton3, padded)
from kytpu_torch.kernels.launch import (M32, SAMPLERS, as_i32, cfg_args,
                                        check_lane_tensor, check_tables, i32,
                                        lanes_checked, on_card, run,
                                        texel_outputs)
from kytpu_torch.kernels.shading import (
    EPS, OFF, SHADOW_EPS, TWO_PI, bsdf_eval_pdf, bsdf_eval_pdf_dots,
    bsdf_sample, hit_light_pdf, image_color, image_taps, kappa, kappa_dot,
    light_pdf, light_sample, mul32, offset_origin, rng_keys, route_textures,
    sin_from_phi_cos, sphere_area_f32, sphere_consts, sphere_occludes, st,
    texel_shape, textures_at, where, where0)
from kytpu_torch.kernels.v3 import (V3, cv3, make_frame, to_local, to_world,
                                    v3_full, v3_zeros)
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes
from kytpu_torch.scene import texture as ktex
from kytpu_torch.utils import profiling as kprof
# public names of this module that the shared layer holds
from kytpu_torch.kernels.autodiff import diff_tracer  # noqa: F401
from kytpu_torch.kernels.launch import MAX_SOBOL_DEPTH  # noqa: F401
from kytpu_torch.kernels.tables import light_emit_of  # noqa: F401
from kytpu_torch.kernels.tag_sums import (  # noqa: F401
    SEG_PIECE, SEG_THREADS, seg_pieces, seg_sums, segment_sums,
    segment_sums_plain, sort_tags, tag_sort)

# K3 and K4 sum a scene of at most this many surfaces in a dense row of
# adjoint columns a thread (csrc/lane_sum.cuh MAX_COLS), and a larger one
# as row-tagged entries summed by row, as K7 and K8 do (`row_tagged`)
DENSE_MAX_ROWS = 64
# the lights one uint32 skip word of the tables holds, a bit a light
# (csrc/wavefront_tables.cuh MASK_LIGHTS): a record's own field holds lights
# 0-31, and a scene of more lights appends the words of lights 32.. after
# the texture records (`pack_tables`)
MASK_LIGHTS = 32
# the lights the nee="single" pick in bits 11-15 of K2's int cache holds;
# past it the pick has an int plane a bounce of its own (`int_planes`)
PICK_LIGHTS = 32
# the room of the backwards' local rows (csrc/lane_sum.cuh MAX_ROW,
# ROW_COLS): 3 emission columns a light for 32 lights and 6 checker columns
# a texture for 64 textures; a longer row takes the "device" accumulator
# route (K3, K4) or the device-memory rows of K7 and K8 (`local_row_cols`)
ROW_LIGHTS, ROW_TEXTURES = 32, 64
DENSE_ROW_COLS = 10 * DENSE_MAX_ROWS + 3 + 6 * ROW_TEXTURES + 1
TAGGED_ROW_COLS = 3 + 3 * ROW_LIGHTS + 6 * ROW_TEXTURES
# K1, K2 and K4 stage a scene's tables in a block's shared memory up to
# this many bytes (csrc/wavefront_fwd.cu STAGE_BUDGET): the most a block
# takes without opting in; larger tables stay in device memory
STAGE_BUDGET = 48 * 1024
# K1, K2 and K4 sample, sweep and accumulate the nee="all" shadow rays of a
# vertex in chunks of at most NEE_CHUNK lights (csrc/wavefront_fwd.cu)
NEE_CHUNK = 8
# K1, K2 and K4 refill the threads of dead lanes with the next lanes of
# their warp's chunk on scenes of at most this many surfaces. Past it the
# occlusion sweeps run over hundreds of rows and end at each ray's first
# occluder, and a refilled warp's lanes, from all over the frame, end them
# far apart: random_spheres(1024) with a 16x16 ground atlas took 33.1 ms
# with refill and 23.4 without (K1, 1M lanes, depth 3, H100). Past it the
# kernels read the tables from device memory and cull blocks of rows at
# the warp, as K5-K8 do (`cull_tables`, csrc/wavefront_fwd.cu step 5).
REFILL_MAX_ROWS = 64
# K3's and K4's routes for a dense adjoint row (csrc/lane_sum.cuh AccRoute):
# "shared", a column a thread of the block's accumulator in dynamic shared
# memory, where the block's dynamic shared memory (K4: with its staged
# tables and shadow rays, `acc_bytes`) stays within ACC_BUDGET bytes, and
# "local", each thread's row in local memory, past it (PERF.md §6: at
# Veach's 4M lanes K3 1.21 ms shared against 1.76 local, K4 7.04 against
# 7.74, NVIDIA H100). ACC_BUDGET 0 forces "local". "device": a row past the
# local array (`DENSE_ROW_COLS`, `TAGGED_ROW_COLS`) is the shared route's
# block in a device-memory scratch, summed in the same order.
ACC_ROUTES = ("local", "shared", "device")
ACC_BUDGET = 80 * 1024
# floats a shadow ray holds in K1's, K2's and K4's shared memory
# (csrc/wavefront_fwd.cu ShadowRays::FIELDS)
RAY_FIELDS = 7


@dataclass(frozen=True)
class KernelConfig:
    """Same fields and defaults as kytpu.kernels.wavefront.KernelConfig.
    The port's kernels take max_depth, rr_start, rows, nee ("all" |
    "single"), sampler ("random" | "hash" | "sobol"), shadow ("parity" |
    "robust") and trainable_exponent. bwd_rows changes nothing here: K3
    reads no tile (the nee="single" pick comes from the cache). cull
    ("off" | "cone" | "cone+nee") is read by the big-scene kernels
    (kernels/bigscene.py) and by K1, K2 and K4 past REFILL_MAX_ROWS
    surfaces: "cone" and "cone+nee" skip, on every sweep, the 8-row blocks
    that no lane of a warp can meet, a per-lane test that, unlike kytpu's
    per-tile cone, keeps culling on incoherent rays; "off" sweeps every row;
    the results are the same to the last bit. K1-K4 at 64 surfaces or
    fewer do not read it, as kytpu's baked kernel does not. sweep ("auto" |
    "scalar" | "mxu") is read as a name only: the big-scene kernels run the
    scalar sweep's arithmetic. The big-scene kernels ignore nee: they
    always sample every light, as kytpu's do."""

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
                        "as kytpu's megakernel does; render larger images "
                        "with engine='jnp'")
        if m >= n_planar:
            return ("the kernels evaluate textures on planar surfaces only, "
                    "as kytpu's megakernel does; render sphere UV textures "
                    "with engine='jnp'")
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


def _occl_skips(static, cfg: KernelConfig):
    """Per-light (planar rows, sphere indices) left out of the all-lights
    shadow sweep: `_occl_skip_rows`, plus under shadow="robust" the light's
    own emitting shape."""
    n_pl = len(static["planar"])
    light_row = ktab.light_rows(static)
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
    return tuple(ktab.f32(np.dot(s[k], anchor)) for k in ("n", "f1", "f2"))


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
    # past REFILL_MAX_ROWS surfaces the cull's visit order (int32) and
    # bounds (float32 (blocks + superblocks, 4), `cull_tables`), else None
    vis: torch.Tensor | None = None
    bnd: torch.Tensor | None = None
    # K3's and K4's column maps (`acc_map`), by (trainable exponent,
    # row-tagged); shared with the tables' colour variants
    acc_maps: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    @kprof.spanned("kytpu::tables.colors")
    def with_colors(self, scene: kscene.Scene) -> "SceneTables":
        return dataclasses.replace(self, **ktab.color_tables(scene),
                                   **ktab.texture_tables(scene))

    @property
    def stage_bytes(self) -> int:
        """Bytes of the tables K1, K2 and K4 copy into a block's shared
        memory (csrc/wavefront_fwd.cu `stage_scene`): f, i, the colour,
        emission, exponent, light and env tables and, in a textured scene,
        texa and texb; 0 where they pass STAGE_BUDGET, or past
        REFILL_MAX_ROWS surfaces (the culled sweeps), and the kernels read
        them from device memory. Veach's and Cornell's take about 2.6 KB;
        random_spheres(1024) with a 16x16 ground atlas (1,026 surfaces, the
        largest scene that reaches K1) about 107 KB."""
        if self.vis is not None:
            return 0
        names = ("f", "i", "diffuse", "specular", "emission", "exponent",
                 "light_emit", "env") + (
                     ("texa", "texb") if self.static["textures"] else ())
        n = 4 * sum(getattr(self, nm).numel() for nm in names)
        return n if n <= STAGE_BUDGET else 0


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
        ktab.n_tex(static),
        int(ktab.has_img(static)),
    ]
    hf[0] = ktab.f32(2.0 * static["world_radius"])
    if static_exp is not None:
        hf[1:4] = [ktab.f32(1.0 / (static_exp + 1.0)),
                   ktab.f32((static_exp + 2.0) * km.INV_2PI),
                   ktab.f32((static_exp + 1.0) * km.INV_2PI)]
    light_row = ktab.light_rows(static)
    li = np.zeros(LT_I * L, np.int32)
    lf = np.zeros(LT_F * L, np.float32)
    for i, lt in enumerate(lights):
        li[LT_I * i:LT_I * (i + 1)] = [
            lt["kind"], int(lt.get("inside_possible", True)),
            light_row.get(i, -1)]
        lf[LT_F * i:LT_F * i + 25] = [
            *lt["position"], *lt["direction"], *lt["p0"], *lt["p1"],
            *lt["p2"], *lt["normal"], lt["area"], *lt["center"],
            lt["radius"], sphere_area_f32(lt["radius"]),
            ktab.f32(4.0 * np.pi * lt["radius"] ** 2)]
    return (hi, hf), (li, lf)


@kprof.spanned("kytpu::tables.pack")
def pack_tables(scene: kscene.Scene, cfg: KernelConfig) -> SceneTables:
    tex_err = kernel_texture_support(scene)
    if tex_err:
        raise NotImplementedError(tex_err)
    static = extract_static(scene)
    planar, spheres = static["planar"], static["spheres"]
    mats, lights = static["mats"], static["lights"]
    n_pl, n_sp, M, L = len(planar), len(spheres), len(mats["kind"]), len(lights)
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
    # the skip words of each planar row, then of each sphere: word 0 in the
    # record, words 1.. after the texture records
    words = [_skip_words(rows_skip, row, L) for row in range(n_pl)] + [
        _skip_words(sph_skip, j, L) for j in range(n_sp)]
    for row, s in enumerate(planar):
        it[oi:oi + PL_I] = [s["kind"], int(bool(s.get("fast"))),
                            words[row][0], int(row in single_skip)]
        rec = ft[of:of + PL_F]
        rec[0:3] = s["n"]
        for j in range(4):
            rec[3 + 3 * j:6 + 3 * j] = s[f"p{j}"]
        rec[15] = ktab.f32(s["radius"] ** 2)
        if s.get("fast"):
            rec[16:19] = s["anchor"]
            rec[19:22] = s["f1"]
            rec[22:25] = s["f2"]
            rec[25:28] = _planar_consts(s)
        oi += PL_I
        of += PL_F
    for j, s in enumerate(spheres):
        it[oi] = words[n_pl + j][0]
        r32 = np.float32(s["r"])
        ft[of:of + 6] = [*s["c"], r32, r32 * r32, ktab.f32(1.0 / s["r"])]
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
    xm = np.asarray([w[g] for g in range(1, -(-L // MASK_LIGHTS))
                     for w in words], np.int32)
    dev = scene.device
    cull = {}
    if M > REFILL_MAX_ROWS:
        vis, bnd = cull_tables(static)
        cull = dict(vis=torch.from_numpy(vis).to(dev),
                    bnd=torch.from_numpy(bnd).to(dev))
    return SceneTables(static=static,
                       f=torch.from_numpy(np.concatenate([ft, tf])).to(dev),
                       i=torch.from_numpy(np.concatenate([it, ti, xm])).to(dev),
                       **ktab.color_tables(scene),
                       **ktab.texture_tables(scene), **cull)


def row_bounds(static):
    """Each surface row's bounding sphere, planar rows then spheres, as
    float64 (centres (R, 3), radii (R,)): a triangle's or a parallelogram's
    around its vertices and a disk's around its centre (as
    `kbs.extract_tables` bounds them), a sphere itself. A rect that is not
    a parallelogram takes an infinite radius: its row test (`_planar_hit`'s
    edge signs) tests the ray's line, not the point it accepts, whose t
    comes from the plane alone, and nothing bounds how far the rounding of
    a ray nearly in that plane puts the point from the rect."""
    cs, rs = [], []
    for s in static["planar"]:
        if s["kind"] == kshapes.DISK:
            cs.append(np.asarray(s["p0"], np.float64))
            rs.append(float(s["radius"]))
            continue
        v = np.asarray([s[f"p{j}"] for j in range(
            3 if s["kind"] == kshapes.TRI else 4)], np.float64)
        c = (v.min(axis=0) + v.max(axis=0)) * 0.5
        cs.append(c)
        rs.append(float(np.max(np.linalg.norm(v - c, axis=-1)))
                  if s.get("fast") else math.inf)
    for s in static["spheres"]:
        cs.append(np.asarray(s["c"], np.float64))
        rs.append(float(s["r"]))
    return np.asarray(cs, np.float64).reshape(-1, 3), np.asarray(rs,
                                                                 np.float64)


def cull_tables(static):
    """The culled sweeps' tables past REFILL_MAX_ROWS surfaces
    (csrc/wavefront_fwd.cu step 5) -> (vis, bnd). vis (int32): each class's
    visit order, the planar rows (their rows) then the spheres (their index
    among the spheres), each a stable sort by the Morton code of the row's
    bound centre (`row_bounds`) over the box of all centres, as
    `kbs.extract_tables` orders its classes; the scene's rows keep their
    indices (`sid`), which the materials, the skip words and the row tags
    are keyed by. bnd (float32, (blocks + superblocks, 4)): the bounds of
    each class's 8-row blocks in the visit order, planar then sphere, then
    of each class's superblocks of 8 blocks, padded as K5's blocks are
    (`cull_bounds`); a block or superblock that holds a row of infinite radius
    is (0, 0, 0, inf) and passes every ray.

    Why the pad holds for K1's rows: a parallelogram's, triangle's or
    disk's test accepts a hit only where the point it computes, o + t d,
    lies inside the row, and a sphere's only where the ray crosses it, up
    to the rounding of a few dozen float32 operations of the size of the
    origin, the row and t |d| (`cull_bounds`' argument, unchanged);
    the ground, one huge row, is a class or a block of its own in
    random_spheres and its pad grows with its radius. The one test that
    does not look at the point it accepts, a rect that is not a
    parallelogram's, has no finite bound (`row_bounds`)."""
    cs, rs = row_bounds(static)
    n_pl = len(static["planar"])
    lo, hi = ((cs.min(axis=0), cs.max(axis=0)) if len(cs)
              else (np.zeros(3), np.zeros(3)))
    vis, blocks = [], {}
    for name, sl in (("tri", slice(0, n_pl)), ("sphere", slice(n_pl, None))):
        c, r = cs[sl], rs[sl]
        order = (np.argsort(np.asarray(morton3(c, lo, hi)),
                            kind="stable") if len(c) > 1
                 else np.arange(len(c)))
        vis.append(order.astype(np.int32))
        c, r = c[order], r[order]
        inf = ~np.isfinite(r)
        b = block_bounds(c, np.where(inf, 0.0, r)).reshape(-1, 4)
        b[np.add.reduceat(inf, np.arange(0, len(r), UNROLL)) > 0
          if len(r) else np.zeros(0, bool)] = [0.0, 0.0, 0.0, math.inf]
        blocks[name] = (None, None, b)
    empty = (None, None, np.zeros((0, 4)))
    with np.errstate(invalid="ignore"):   # an unbounded superblock's centre
        bnd = cull_bounds({k: blocks.get(k, empty) for k in CLASSES})
    bnd[~np.isfinite(bnd).all(axis=1)] = [0.0, 0.0, 0.0, np.inf]
    return (np.concatenate(vis + [np.zeros(0, np.int32)]),
            np.ascontiguousarray(bnd, np.float32))


# blocks a superblock of K1's, K2's and K4's cull (SUPER_BLOCKS in
# csrc/megakernel.cuh)
SUPER = 8


def cull_bounds(tables) -> np.ndarray:
    """The flat cull bounds of class tables (`cull_tables`' blocks, or
    `kbs.extract_tables`' tables), one (blocks + superblocks, 4) float32
    array [cx cy cz R]: each class's 8-row block bounds (kytpu's
    `_block_bounds`, r * 1.0001 + 1e-6), tri | rect | disk | sphere, then
    each class's superblock bounds, a sphere around SUPER consecutive block
    bounds (`group`). K1, K2 and K4 read them past 64 surfaces (K5, K6 and
    K8 walk trees of boxes instead, `kbs.tree_bounds`).

    Each R adds CULL_PAD * (|cx| + |cy| + |cz| + r) to r and is rounded up
    to a float32. Why that is enough: a row test accepts a point off its
    surface only by the rounding of a few dozen float32 operations on the
    ray's origin, the row's constants and t |d|, each at most |o| + |c| + r
    in size (a hit inside a block is no farther than that from the origin);
    the block test (`kbs.block_meets_plain`) rounds as much again. That is some
    tens of ulps of |o| + |c| + r. CULL_PAD, 2^-12, is 2^11 ulps of that
    size, the bound's share here and the origin's added by each lane: at
    the spheres' |x|, |z| <= 35.2 it is about 0.02, a few percent of a
    block's radius, so the pad costs little cull. A superblock's sphere
    holds its blocks' padded spheres whole (float64, then the same pad)."""
    blocks = [padded(b[:, :3], b[:, 3]) for b in (
        np.asarray(tables[k][2], np.float64).reshape(-1, 4)
        for k in CLASSES)]
    supers = [group(pb, SUPER) for pb in blocks]
    return np.concatenate(blocks + supers + [np.zeros((0, 4), np.float32)])


def _skip_words(skips, row: int, n_lights: int) -> list:
    """The skip bits of `row` (a planar row or a sphere) as int32 words of
    MASK_LIGHTS lights: bit k of word g set where light 32 g + k may skip
    the row (`skips`: a set of rows a light)."""
    return [i32(sum(1 << (k - g) for k in range(g, min(g + MASK_LIGHTS,
                                                          n_lights))
                    if row in skips[k]))
            for g in range(0, max(n_lights, 1), MASK_LIGHTS)]


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
    pick in resi bits 11-15 (past PICK_LIGHTS lights in a plane of its own,
    `int_planes`); else one "B" plane a light. The kernels read
    this from the table header (`pack_tables`)."""
    return cfg.nee == "single" and n_lights > 1


def pick_plane(cfg: KernelConfig, n_lights: int) -> bool:
    """Does K2 keep the nee="single" pick in an int plane of its own (past
    PICK_LIGHTS lights, which its 5 bits hold), not in resi bits 11-15?"""
    return picks_one_light(cfg, n_lights) and n_lights > PICK_LIGHTS


def int_planes(static, cfg: KernelConfig) -> int:
    """K2's int cache planes: one a bounce (`residual_layout`), then, where
    `pick_plane`, the pick of each bounce below the horizon (plane
    max_depth + 1 + b)."""
    return cfg.max_depth + 1 + (
        cfg.max_depth if pick_plane(cfg, len(static["lights"])) else 0)


def residual_layout(static, cfg: KernelConfig):
    """Plane order of the coefficient cache that K2 writes and K3 reads
    (kytpu's `_residual_layout`) -> ({tag: plane}, count). Per bounce: "wb"
    (hit-emission MIS weight, fully masked), "wenv" (env-miss weight, env
    scenes), then below the horizon one "B" plane per NEE light (one under
    nee="single": B' = li_scalar * f_unit * |cos| * okf * lobe_scale) and
    "tu" (extension throughput unit incl. lobe scale, pdf division, RR
    compensation and the alive mask). Under cfg.trainable_exponent each "B"
    is followed by its "Bk" and "tu" by its "tuk": the plane times kappa
    (`kappa`), 0 off phong lanes. A scene with image textures adds "tx" and
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
    has_img = ktab.has_img(static)
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


def _phit_lights(lights) -> bool:
    """Does every light give a direction-free hit pdf at sampling time
    (`light_sample`'s phit), so the next bounce's emission MIS reads it
    instead of recomputing `hit_light_pdf`?"""
    return all(lt["kind"] != klights.AREA_RECT
               and not (lt["kind"] == klights.AREA_SPHERE
                        and lt.get("inside_possible", True))
               for lt in lights)


# ---------------------------------------------------------------------------
# plain version: nee="single"'s light pick
# ---------------------------------------------------------------------------


def _single_pick(tile_seed: torch.Tensor, bounce: int, si0, L: int):
    """nee="single": the light picked for a whole tile at one bounce
    (wavefront.py:2213-2236); si0 is the sample index of the tile's first
    lane under the "hash" and "sobol" samplers, else None."""
    c = (tile_seed + ((bounce * 668265263) & 0x7FFFFFFF)) & M32
    c = c ^ (c >> 16)
    c = mul32(c, 0x85EBCA6B)
    c = c ^ (c >> 13)
    if si0 is not None:
        c = (c + si0) & M32
    return (c & 0x7FFFFFFF) % L


# ---------------------------------------------------------------------------
# plain version: geometry
# ---------------------------------------------------------------------------


def _planar_hit(s, o: V3, d: V3):
    """(t, inside) for one planar surface. The divisions are raw: a parallel
    ray gives t = +-inf/nan, which every caller's `eps < t < tmax` gate
    rejects."""
    nrm = cv3(s["n"])
    if s["kind"] == kshapes.DISK:
        p0 = cv3(s["p0"])
        t = km.div(nrm.dot(p0 - o), nrm.dot(d))
        hp = o + d * t
        inside = (hp - p0).length_squared() <= ktab.f32(s["radius"] ** 2)
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


def _closest_hit(static, o: V3, d: V3):
    """Closest hit over the scene -> (t, sid, valid, normal). The normal is
    resolved once from the winning row."""
    t_best = torch.full_like(o.x, math.inf)
    sid = torch.full(o.x.shape, -1, dtype=torch.int32, device=o.x.device)
    for row, s in enumerate(static["planar"]):
        t, inside = _planar_hit(s, o, d)
        accept = inside & (t > EPS) & (t < t_best)
        t_best = torch.where(accept, t, t_best)
        sid = where(accept, row, sid)
    base = len(static["planar"])
    for j, s in enumerate(static["spheres"]):
        c, _, r2 = sphere_consts(s)
        oc = c - o
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r2 - perp.length_squared()
        sq = km.safe_sqrt(discr)
        cc = oc.length_squared() - r2
        sgn = where(neg_b >= 0.0, 1.0, -1.0)
        q = neg_b + sgn * sq
        tq = cc / q
        t1 = torch.minimum(q, tq)
        t2 = torch.maximum(q, tq)
        t1_ok = t1 > EPS
        t2_ok = t2 > EPS
        t = torch.where(t1_ok, t1, t2)
        accept = (discr >= 0) & (t1_ok | t2_ok) & (t < t_best)
        t_best = torch.where(accept, t, t_best)
        sid = where(accept, base + j, sid)
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
            [[*map(ktab.f32, s["c"]), ktab.f32(1.0 / s["r"])]
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
        hit = hit | gated(inside & (t > EPS) & (t < tmax), row)
    for j, s in enumerate(static["spheres"]):
        c, _, r2 = sphere_consts(s)
        oc = c - o
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r2 - perp.length_squared()
        hit = hit | gated(sphere_occludes(neg_b, discr, tmax), n_pl + j)
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
    se = [where(nd[k] < 0.0, -OFF, OFF) for k in range(K)]
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
                hits[k] = hits[k] | (inside & (t > EPS) & (t < rays[k][1]))
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
            hits[k] = hits[k] | (inside & (t > EPS) & (t < tmax))

    off2 = ktab.f32(km.RAY_OFFSET * km.RAY_OFFSET)
    for j, s in enumerate(static["spheres"]):
        which = [k for k in range(K)
                 if sphere_skips is None or j not in sphere_skips[k]]
        if not which:
            continue
        c, _, r2 = sphere_consts(s)
        vc = c - hp
        vc2 = vc.length_squared()
        vcn = vc.dot(n_shade)
        for k in which:
            wi, tmax = rays[k]
            neg_b = vc.dot(wi) - se[k] * nd[k]
            oc2 = vc2 - 2.0 * se[k] * vcn + off2
            discr = r2 - oc2 + neg_b * neg_b
            hits[k] = hits[k] | sphere_occludes(neg_b, discr, tmax)
    return hits


# ---------------------------------------------------------------------------
# plain version: the forward kernel body
# ---------------------------------------------------------------------------


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


def _eligible(ok_tab, sid):
    """(N,) mask: the lane hit a row that ok_tab allows (False on a miss)."""
    return (sid >= 0) & ok_tab[sid.clamp_min(0).long()]


def _tagged_planes(dif, spc, de, dexp, sid) -> list:
    """One bounce's row-tagged adjoint planes in K7's order, dd, ds, de[,
    dexp], from (ok_tab, value) pairs: a share is 0 where the hit row may
    not take it, the rows that `_row_add` leaves untouched."""
    out = []
    for ok_tab, v in (dif, spc):
        out.extend(where0(_eligible(ok_tab, sid), v).unbind(1))
    out.extend(de.unbind(1))
    if dexp is not None:
        out.append(where0(_eligible(dexp[0], sid), dexp[1]))
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
    row once, and sums the lanes in K3's fixed order (`sum_kept`), so the
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
    textured, has_img = bool(static["textures"]), ktab.has_img(static)

    n = o.shape[0]
    dev = o.device
    rng, tile_seed, si0 = rng_keys(cfg, n, seed, si, pix, dev)

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
        ints = [None] * int_planes(static, cfg)
    if replay:
        g = g.to(dev, torch.float32)
        r_tail = V3(*(big_l_in[:, c].to(dev, torch.float32)
                      for c in range(3)))
        light_row = ktab.light_rows(static)
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
        T = ktab.n_tex(static)
        acc_ta, acc_tb = g.new_zeros((n, T, 3)), g.new_zeros((n, T, 3))
        entries = [] if has_img else None

    for bounce in range(cfg.max_depth + 1):
        t, sid, valid, nrm = _closest_hit(static, o, d)
        t_safe = where(valid, t, 1.0)
        hp = o + d * t_safe
        wo = -d
        facing = nrm.dot(wo) > 0.0
        emit_v = sel3(sid, tables.emission, rows_e)
        emit_mask = valid & facing
        le = V3(*(where(emit_mask, c, 0.0) for c in (emit_v.x, emit_v.y,
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
                pdf_l_hit = hit_light_pdf(lights, li_idx, o, d, t_safe, nrm)
            w_emit = km.safe_div(pdf_prev, pdf_prev + pdf_l_hit)
            if full is not False:
                w_emit = where(full, 1.0, w_emit)
        wb = where(alive, w_emit, 0.0)
        e_term = le * wb
        big_l = big_l + beta * e_term
        if residual:
            planes[res_ix[("wb", bounce)]] = where(emit_mask, wb, 0.0)
        if replay:
            gb = g * st(beta)
            de_b = gb * where(emit_mask, wb, 0.0)[:, None]
            if tagged:
                de_b = where0(_eligible(rows_e, sid), de_b)
                tags.append(where(alive & valid, sid + 1, 0))
            else:
                _row_add(acc_e, rows_e, sid, de_b)

        if env_i is not None:
            ones = torch.ones_like(o.x)
            env_v = V3(env[0] * ones, env[1] * ones, env[2] * ones)
            if full is True:
                w_env = 1.0
            else:
                pdf_env = light_pdf(lights[env_i], o, nrm, d)
                w_env = km.safe_div(pdf_prev, pdf_prev + pdf_env)
                if full is not False:
                    w_env = where(full, 1.0, w_env)
            wenv = where(alive & ~valid, w_env, 0.0)
            big_l = big_l + beta * env_v * wenv
            e_term = e_term + env_v * wenv
            if residual:
                planes[res_ix[("wenv", bounce)]] = wenv
            if replay:
                acc_env = acc_env + gb * wenv[:, None]

        if bounce == cfg.max_depth:
            if residual:
                ints[bounce] = where(alive, pack_row(sid + 1), 0)
            if replay and tagged:
                dplanes.extend(de_b.unbind(1))
            break
        cont = alive & valid

        exponent = 0.0 if static_exp is not None \
            else row_of(sid, exp_tab, 0.0)
        eta = row_of(sid, eta_tab, 0.0) if has_glass else 1.0
        diffuse = sel3(sid, tables.diffuse, rows_d)
        if textured:
            diffuse, tex_hits = textures_at(static, tables, sid, hp,
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
            plastic_kind = where(pick_spec, torch.full_like(mk, kbsdf.PHONG),
                                 kbsdf.LAMBERT)
            inv_sp = km.div(1.0, torch.clamp_min(s_prob, 1e-12))
            inv_dp = km.div(1.0, torch.clamp_min(d_prob, 1e-12))
            plastic_col = (specular * inv_sp).where(pick_spec,
                                                    diffuse * inv_dp)
            lobe_is_phong = is_plastic & pick_spec
            lobe_scale = where(is_plastic,
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
        col_nee = st(col_nee_tbl)
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
                addc_spec = addc_spec + where0(lobe_is_phong, addc)
                addc_diff = addc_diff + where0(~lobe_is_phong, addc)
            else:
                addc_diff = addc_diff + addc
            if texp:
                addx = addx + where0(lobe_is_phong,
                                     _dot3(addc, col_nee) * kap)

        if picks_one_light(cfg, L):
            u1, u2 = rng.uniform2()
            pick = _single_pick(tile_seed, bounce, si0, L)
            smps = [light_sample(lt, world_radius, hp, nrm, u1, u2)
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
            _, pdf_b, f_unit_e = bsdf_eval_pdf(kind, color, exponent, wo_l,
                                               wi_l, eval_lobes, static_exp)
            ucos = f_unit_e * torch.abs(wi_l.z)
            w = torch.where(is_delta_l, km.safe_div(1.0, pdf_l),
                            km.safe_div(1.0, pdf_l + pdf_b))
            ok = nee_base & (pdf_l > 0.0)
            tm = dist - SHADOW_EPS
            if robust:
                tm = tm - OFF * torch.abs(nrm.dot(wi))
            occ = _any_hit(static, offset_origin(hp, nrm, wi), wi, tm,
                           skip_rows=frozenset.intersection(
                               *[frozenset(s) for s in static["occl_skip"]]),
                           skip_light=pick if robust else None)
            okf = where(ok & ~occ, w * ktab.f32(L), 0.0)
            bp = li_s * ucos * okf * lobe_scale
            ld = col_nee_tbl * emit_l * bp
            kap = kappa(exponent, wo_l, wi_l) if texp else None
            if residual:
                planes[res_ix[("B", bounce, 0)]] = bp
                if texp:
                    planes[res_ix[("Bk", bounce, 0)]] = where(
                        lobe_is_phong, bp * kap, 0.0)
            if replay:
                add = gb * col_nee * bp[:, None]
                for i in range(L):
                    val = where0(sel[i], add)
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
                cphi_s = torch.cos(TWO_PI * u2)
                azim = (cphi_s, sin_from_phi_cos(cphi_s, u2))
            smps = [light_sample(lt, world_radius, hp, nrm, u1, u2, azim)
                    for lt in lights]
            nds = [nrm.dot(smp[0]) for smp in smps]
            if all(smp[4] is not None for smp in smps):
                phits_prev = [smp[4] for smp in smps]
            occs = _any_hit_multi(
                static, hp, nrm,
                [(smp[0], smp[3] - SHADOW_EPS) for smp in smps],
                occl_skips, robust=robust, sphere_skips=sph_skips if robust
                else None, nd=nds)
            for i, lt in enumerate(lights):
                wi, pdf_l, li_s, _dist, _ = smps[i]
                emit_l = V3(tables.light_emit[i, 0], tables.light_emit[i, 1],
                            tables.light_emit[i, 2])
                cos_aw = wr_w.dot(wi) if wr_w is not None \
                    else torch.zeros_like(o.x)
                pdf_b, f_unit_e = bsdf_eval_pdf_dots(
                    kind, exponent, wo_l.z, nds[i], cos_aw, eval_lobes,
                    static_exp)
                ucos = f_unit_e * torch.abs(nds[i])
                if klights.is_delta_light(lt["kind"]):
                    w = km.div(1.0, pdf_l)
                else:
                    w = km.div(1.0, pdf_l + pdf_b)
                ok = nee_base & (pdf_l > 0.0)
                okf = where(ok & ~occs[i], w * 1.0, 0.0)
                bp = li_s * ucos * okf * lobe_scale
                ld = ld + col_nee_tbl * emit_l * bp
                kap = kappa_dot(exponent, cos_aw) if texp else None
                if residual:
                    planes[res_ix[("B", bounce, i)]] = bp
                    if texp:
                        planes[res_ix[("Bk", bounce, i)]] = where(
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
        f_s, wi_l, pdf_s, delta_s, f_unit_s, refract = bsdf_sample(
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
            q = torch.clamp_min(1.0 - beta_new.max_component(), ktab.f32(0.05))
            kill = u_rr < q
            scale = km.safe_div(1.0, 1.0 - q)
            beta_new = beta_new * scale
            alive_n = ok & ~kill
        else:
            alive_n = ok
        to_spec_t = is_mirror | (is_glass & ~refract) | lobe_is_phong
        if residual or replay:
            t_unit = f_unit_s * km.safe_div(torch.abs(wi_l.z), pdf_s) * scale
            tu_plane = where(alive_n, t_unit * lobe_scale, 0.0)
            kap_s = kappa(exponent, wo_l, wi_l) if texp else None
        if residual:
            planes[res_ix[("tu", bounce)]] = tu_plane
            if texp:
                planes[res_ix[("tuk", bounce)]] = where(
                    lobe_is_phong, tu_plane * kap_s, 0.0)
            packed = pack_row(sid + 1) + lobe_is_phong.to(torch.int32) * 256 \
                + to_spec_t.to(torch.int32) * 512
            if pick_plane(cfg, L):
                ints[cfg.max_depth + 1 + bounce] = where(
                    alive, pick.to(torch.int32), 0)
            elif picks_one_light(cfg, L):
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
            ints[bounce] = where(alive, packed, 0)
        if replay:
            # R_{b+1} = (R_b - E_b) / T_b per channel, 0 where the path ends
            t_eff = where0(alive_n, st(thr * scale))
            r_next = where0(alive_n, km.safe_div(st(r_tail) - st(e_term),
                                                 t_eff))
            addt = gb * r_next * tu_plane[:, None]
            addc_spec = addc_spec + where0(to_spec_t, addt)
            addc_diff = addc_diff + where0(~to_spec_t, addt)
            if texp:
                addx = addx + where0(lobe_is_phong,
                                     _dot3(addt, col_nee) * kap_s)
            if textured:
                addc_diff = route_textures(tex_hits, addc_diff, acc_ta,
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
        o = offset_origin(hp, nrm, wi_w).where(alive_n, o)
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
                sum_kept(tables, cfg, torch.cat(
                    [acc_env, acc_le.reshape(n, -1)] + tex_acc, dim=1)))
        else:
            acc = [acc_d.reshape(n, -1), acc_s.reshape(n, -1),
                   acc_e.reshape(n, -1), acc_env] + (
                [acc_x] if texp else []) + tex_acc
            grads = split_grads(sum_kept(tables, cfg, torch.cat(acc, dim=1)),
                                M, texp, T)
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

# the backwards' blocks and their second pass's block (csrc/lane_sum.cuh)
BWD_THREADS = 128
SUM_THREADS = 256


def _sum_blocks(part: torch.Tensor) -> torch.Tensor:
    """The second pass of `sum_lanes` and `sum_columns`: (blocks, K) block
    partials -> (K,). Thread t of a SUM_THREADS block sums blocks t, t +
    SUM_THREADS, ... in turn, then the threads reduce as a tree (off = 128
    .. 1)."""
    s = part.new_zeros((SUM_THREADS, part.shape[1]))
    for j in range(0, len(part), SUM_THREADS):
        chunk = part[j:j + SUM_THREADS]
        s[:len(chunk)] = s[:len(chunk)] + chunk
    off = SUM_THREADS // 2
    while off:
        s[:off] = s[:off] + s[off:2 * off]
        off //= 2
    return s[0]


def sum_lanes(acc: torch.Tensor) -> torch.Tensor:
    """(N, K) per-lane adjoints -> (K,) in K7's and K8's fixed order: each
    block of BWD_THREADS lanes sums its warps as a shuffle tree (lane i +=
    lane i + off, off = 16 .. 1) and the four warp sums as (w0 + w1) + (w2
    + w3); then `_sum_blocks`. The same float additions in the same order
    as the kernels, so the two agree to the last bit and the gradient
    repeats from run to run."""
    n, k = acc.shape
    nb = max(1, -(-n // BWD_THREADS))
    x = acc.new_zeros((nb * BWD_THREADS, k))
    x[:n] = acc
    x = x.reshape(nb, BWD_THREADS // 32, 32, k)
    for off in (16, 8, 4, 2, 1):
        x[:, :, :off] = x[:, :, :off] + x[:, :, off:2 * off]
    w = x[:, :, 0]
    return _sum_blocks((w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3]))


def sum_columns(acc: torch.Tensor) -> torch.Tensor:
    """(N, K) per-lane adjoints -> (K,) in K3's fixed order, and K4's where
    its slots do not refill (32-lane chunks): lane i of each block of
    BWD_THREADS lanes is thread i's row; the block sums column c as four
    chains, one a warp of 32 threads, each in thread order from thread c %
    32 on, wrapping round (csrc/lane_sum.cuh: a warp then reads 32 banks),
    adds them as (q0 + q1) + (q2 + q3), and then `_sum_blocks`. The same
    float additions in the same order as K3, so the two agree to the last
    bit and the gradient repeats from run to run."""
    n, k = acc.shape
    nb = max(1, -(-n // BWD_THREADS))
    x = acc.new_zeros((nb, BWD_THREADS, k))
    x.view(-1, k)[:n] = acc
    x = x.reshape(nb, BWD_THREADS // 32, 32, k)
    step = torch.arange(32, device=acc.device)[:, None]
    # step i of column c adds thread (c + i) % 32 of the warp
    order = (step + torch.arange(k, device=acc.device)) % 32
    x = torch.gather(x, 2, order.expand(nb, BWD_THREADS // 32, -1, -1))
    q = x[:, :, 0]
    for i in range(1, 32):
        q = q + x[:, :, i]
    return _sum_blocks((q[:, 0] + q[:, 1]) + (q[:, 2] + q[:, 3]))


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


def per_bounce(cfg: KernelConfig) -> int:
    """Row-tagged adjoint planes a bounce below the horizon: dd, ds, de [,
    dexp]."""
    return 10 if cfg.trainable_exponent else 9


def row_sums_plain(dout, tags, m_rows: int, cfg: KernelConfig):
    """Row-tagged planes dout (PB*max_depth + 3, N) summed by the row tags
    (max_depth + 1, N) (row + 1, 0 for none) in the segment-sum kernels'
    order -> (M, PB)."""
    perm, starts = kts.sort_tags(tags, m_rows)
    return kts.segment_sums_plain(dout, perm, starts, dout.shape[1],
                                  cfg.max_depth, per_bounce(cfg))


def tagged_grads(static, cfg: KernelConfig, seg, lane_sums,
                 light_rows: dict | None = None) -> tuple:
    """(M, PB) row sums and the lane sums env (3) | per-light emission (3L)
    [| dta | dtb (3T each)] -> (dd, ds, de, denv[, dexp][, dta, dtb]), the
    tables of `split_grads`: each light's NEE emission adjoint goes to its
    emitting row (`light_rows`, default `ktab.light_rows`), or to env for the
    environment light; point and directional lights get none. K3 and K4
    past DENSE_MAX_ROWS surfaces, K7 and K8."""
    L = len(static["lights"])
    rows = ktab.light_rows(static) if light_rows is None else light_rows
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
    T = ktab.n_tex(static)
    if T:
        k = 3 + 3 * L
        out += (lane_sums[k:k + 3 * T].reshape(T, 3),
                lane_sums[k + 3 * T:k + 6 * T].reshape(T, 3))
    return out


def texel_sums_plain(static, entries, n: int) -> torch.Tensor:
    """The texel-tagged entries of K3 or K4 (4 slots a bounce below the
    horizon, each ((N, 3) values, (N,) tags)) summed by texel in the
    segment-sum kernels' order -> the (Ti, H, W, 3) atlas gradient."""
    J = len(entries)
    dout = torch.stack([v for v, _ in entries]).permute(0, 2, 1).reshape(
        3 * J, n)
    perm, starts = kts.sort_tags(torch.stack([t for _, t in entries]),
                                 static["n_texels"])
    return kts.segment_sums_plain(dout, perm, starts, n, J, 3).reshape(
        texel_shape(static))


def bwd_res_plain(tables: SceneTables, cfg: KernelConfig, g: torch.Tensor,
                  big_l: torch.Tensor, resf: torch.Tensor,
                  resi: torch.Tensor):
    """Plain K3, the coefficient-cache backward (kytpu's
    `_make_bwd_res_kernel`) on lane tensors: upstream gradient g and
    radiance big_l (N, 3), the cache of K2 -> (dd, ds, de, denv[, dexp]) of
    shapes (M, 3), (M, 3), (M, 3), (3,)[, (M,) under
    cfg.trainable_exponent], the per-lane adjoints summed in the kernel's
    order (`sum_kept`).

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
    n_int = int_planes(static, cfg)
    if resf.shape[0] != res_n or resi.shape[0] != n_int:
        raise ValueError(f"cache of {resf.shape[0]} float and "
                         f"{resi.shape[0]} int planes; this scene and config "
                         f"take {res_n} and {n_int}")
    single = picks_one_light(cfg, L)
    has_env = any(lt["kind"] == klights.ENV for lt in lights)
    light_row = ktab.light_rows(static)
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
    textured, has_img = bool(static["textures"]), ktab.has_img(static)
    T = ktab.n_tex(static)
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
            de_b = where0(_eligible(ok_e, sid), gb * wb)
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
                slots = image_taps(rec, resf[res_ix[("tx", b)]],
                                   resf[res_ix[("ty", b)]])
                col = st(image_color(rec, slots, tables.timg))
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
        if not single:
            picks = [(i, i) for i in range(L)]
        elif pick_plane(cfg, L):
            picks = [(resi[cfg.max_depth + 1 + b].long(), 0)]
        else:
            picks = [(((ib >> 11) & 31).long(), 0)]
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
            addc_diff = route_textures(tex_hits, addc_diff, acc_ta, acc_tb,
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
            sum_kept(tables, cfg, torch.cat(
                [acc_env, acc_le.reshape(n, -1)] + tex_acc, dim=1)))
    else:
        acc = [acc_d.reshape(n, -1), acc_s.reshape(n, -1),
               acc_e.reshape(n, -1), acc_env] + ([acc_x] if texp else []) \
            + tex_acc
        grads = split_grads(sum_kept(tables, cfg, torch.cat(acc, dim=1)), M,
                            texp, T)
    if not has_img:
        return grads
    return grads + (texel_sums_plain(static, entries, n),)


# ---------------------------------------------------------------------------
# the wrapper: CUDA tensors launch csrc/wavefront_fwd.cu, CPU tensors run
# the plain version
# ---------------------------------------------------------------------------


_TABLES = ("f", "i", "diffuse", "specular", "emission", "exponent",
           "light_emit", "env", "texa", "texb", "timg")


def _check_tables(tables: SceneTables, dev):
    check_tables(tables, dev, _TABLES + (("vis", "bnd") if tables.vis
                                         is not None else ()), ("i", "vis"))


def _n_cols(tables: SceneTables, cfg: KernelConfig) -> int:
    """Length of K3's and K4's lane-summed vector: the dense gradient
    vector (`split_grads`), or past DENSE_MAX_ROWS surfaces env | the
    lights' emission | dta | dtb (`tagged_grads`)."""
    static = tables.static
    if row_tagged(static):
        return 3 + 3 * len(static["lights"]) + 6 * ktab.n_tex(static)
    m_rows = len(static["mats"]["kind"])
    return ((10 if cfg.trainable_exponent else 9) * m_rows + 3
            + 6 * ktab.n_tex(static))


def acc_columns(static, cfg: KernelConfig) -> np.ndarray:
    """The columns of the dense gradient vector (`split_grads`' layout)
    that a lane of K3 or K4 can add to, ascending: a row's diffuse unless
    it is a mirror, its specular unless it is matte, its emission where it
    belongs to a light, env, a plastic row's exponent under
    trainable_exponent, the checker colours."""
    mats = static["mats"]
    kind = np.asarray(mats["kind"])
    light = np.asarray(mats["light_index"])
    M, T = len(kind), ktab.n_tex(static)

    def rows(ok):
        return (3 * np.nonzero(ok)[0][:, None] + np.arange(3)).ravel()

    cols = [rows(kind != kbsdf.MAT_MIRROR),
            3 * M + rows(kind != kbsdf.MAT_MATTE), 6 * M + rows(light >= 0),
            9 * M + np.arange(3)]
    k = 9 * M + 3
    if cfg.trainable_exponent:
        cols.append(k + np.nonzero(kind == kbsdf.MAT_PLASTIC)[0])
        k += M
    cols.append(k + np.arange(6 * T))
    return np.concatenate(cols)


def _acc_layout(tables: SceneTables, cfg: KernelConfig):
    """(`acc_map`, the kept columns or None on the row-tagged route), on
    the tables' device, cached on the tables."""
    key = (cfg.trainable_exponent, row_tagged(tables.static))
    if key not in tables.acc_maps:
        n, dev = _n_cols(tables, cfg), tables.i.device
        if key[1]:
            cmap, keep = np.arange(n), None
        else:
            keep = acc_columns(tables.static, cfg)
            cmap = np.full(n, len(keep))
            cmap[keep] = np.arange(len(keep))
            keep = torch.from_numpy(keep).to(dev)
        tables.acc_maps[key] = (
            torch.from_numpy(cmap.astype(np.int32)).to(dev), keep)
    return tables.acc_maps[key]


def acc_map(tables: SceneTables, cfg: KernelConfig) -> torch.Tensor:
    """K3's and K4's column map, (`_n_cols`,) int32 on the tables' device:
    each column of the lane-summed vector -> its column in a lane's row
    (csrc/lane_sum.cuh). The dense route keeps the `acc_columns` in order
    and sends the others to the row's last column, which no lane adds to;
    the row-tagged route keeps every column."""
    return _acc_layout(tables, cfg)[0]


def _row_cols(tables: SceneTables, cfg: KernelConfig) -> int:
    """Columns of a lane's row in K3 and K4: the kept ones and, on the
    dense route, the last one no lane adds to."""
    keep = _acc_layout(tables, cfg)[1]
    return _n_cols(tables, cfg) if keep is None else len(keep) + 1


def sum_kept(tables: SceneTables, cfg: KernelConfig,
             acc: torch.Tensor) -> torch.Tensor:
    """(N, `_n_cols`) per-lane adjoints -> the lane-summed vector in K3's
    order: the kept columns summed by `sum_columns` as the kernels' rows
    hold them, 0 in the others (which no lane adds to)."""
    keep = _acc_layout(tables, cfg)[1]
    if keep is None:
        return sum_columns(acc)
    keep = keep.to(acc.device)
    vec = acc.new_zeros(acc.shape[1])
    vec[keep] = sum_columns(acc[:, keep])
    return vec


def acc_bytes(tables: SceneTables, cfg: KernelConfig,
              replay: bool = False) -> int:
    """The dynamic shared memory of a K3 block (K4 with replay=True) on the
    shared accumulator route: a column of `_row_cols` floats a thread, and
    K4's staged tables and shadow rays before it."""
    b = 4 * BWD_THREADS * _row_cols(tables, cfg)
    if replay:
        rays = _scene_args(tables, cfg)[2]
        b += tables.stage_bytes + 4 * RAY_FIELDS * BWD_THREADS * rays
    return b


def acc_route(tables: SceneTables, cfg: KernelConfig,
              replay: bool = False) -> str:
    """K3's (K4's with replay=True) accumulator route: "shared" where the
    row's block fits ACC_BUDGET (`acc_bytes`), else "local"; K4 past
    DENSE_MAX_ROWS surfaces (`row_tagged`) keeps local rows; a row past
    the local array (`DENSE_ROW_COLS`, `TAGGED_ROW_COLS`: past 32 lights or
    64 textures) that is not "shared" goes to "device"."""
    tagged = row_tagged(tables.static)
    if not (replay and tagged) and acc_bytes(tables, cfg,
                                             replay) <= ACC_BUDGET:
        return "shared"
    room = TAGGED_ROW_COLS if tagged else DENSE_ROW_COLS
    return "local" if _row_cols(tables, cfg) <= room else "device"


def local_row_cols(textured: bool) -> int:
    """The columns of K7's and K8's local rows (env, the lights' emission
    [, the checker adjoints]: csrc/bigscene_bwd_res.cu LOCAL_COLS); a
    longer row is kept in device memory."""
    return 3 + 3 * ROW_LIGHTS + (6 * ROW_TEXTURES if textured else 0)


def _wide(tables: SceneTables, cfg: KernelConfig, route: str, nb: int,
          dev):
    """K3's and K4's accumulators on the "device" route, (nb, row columns,
    BWD_THREADS) float32, else None."""
    if route != "device":
        return None
    return torch.empty((nb, _row_cols(tables, cfg), BWD_THREADS),
                       dtype=torch.float32, device=dev)


def _row_outputs(tables: SceneTables, cfg: KernelConfig, n: int, dev):
    """K3's and K4's row-tagged planes (PB max_depth + 3, n) and row tags
    (max_depth + 1, n) past DENSE_MAX_ROWS surfaces, else (None, None)."""
    if not row_tagged(tables.static):
        return None, None
    B = cfg.max_depth
    return (torch.empty((per_bounce(cfg) * B + 3, n), dtype=torch.float32,
                        device=dev),
            torch.empty((B + 1, n), dtype=torch.int32, device=dev))


def _grads_of(tables: SceneTables, cfg: KernelConfig, vec, tex, rows):
    """K3's or K4's outputs on the card -> (dd, ds, de, denv[, dexp][, dta,
    dtb][, dti]): the lane-summed vector split (`split_grads`), or past
    DENSE_MAX_ROWS surfaces the row-tagged planes summed by row with it
    (`tagged_grads`); the texel entries summed by texel. tex, rows: (the
    planes, their tags), or (None, None)."""
    static = tables.static
    if rows[1] is None:
        grads = split_grads(vec, len(static["mats"]["kind"]),
                            cfg.trainable_exponent, ktab.n_tex(static))
    else:
        grads = tagged_grads(static, cfg, kts.segment_sums(
            *rows, len(static["mats"]["kind"]), cfg.max_depth,
            per_bounce(cfg)), vec)
    if tex[1] is None:
        return grads
    seg = kts.segment_sums(*tex, static["n_texels"], tex[1].shape[0], 3)
    return grads + (seg.reshape(texel_shape(static)),)


def _lanes(tables: SceneTables, cfg: KernelConfig, o, d, si, pix):
    """One launch's lanes, checked -> contiguous (o, d, si, pix) on o's
    device; si and pix are None under the "random" sampler."""
    _check_tables(tables, o.device)
    return lanes_checked(o, d, si, pix, cfg)


def _lane_ptrs(tables: SceneTables, o, d, si, pix) -> list:
    """The pointer arguments K1, K2 and K4 share: tables, rays, lane ids."""
    return [getattr(tables, nm).data_ptr() for nm in _TABLES] + [
        o.data_ptr(), d.data_ptr(), None if si is None else si.data_ptr(),
        None if pix is None else pix.data_ptr()]


def _scene_args(tables: SceneTables, cfg: KernelConfig) -> list:
    """K1's, K2's and K4's last arguments: whether the scene is textured,
    the bytes of the tables a block stages in shared memory, the shadow
    rays a chunk of the nee="all" light loop holds (0 under nee="single"),
    and whether K1, K2 and K4 refill dead lanes (`REFILL_MAX_ROWS`)."""
    n_l = len(tables.static["lights"])
    rays = 0 if picks_one_light(cfg, n_l) else min(n_l, NEE_CHUNK)
    refill = len(tables.static["mats"]["kind"]) <= REFILL_MAX_ROWS
    return [int(bool(tables.static["textures"])), tables.stage_bytes, rays,
            int(refill)]


def _cull_args(tables: SceneTables, cfg: KernelConfig) -> list:
    """K1's, K2's and K4's cull arguments: past REFILL_MAX_ROWS surfaces
    the visit order, the bounds (`cull_tables`) and whether to cull
    (cfg.cull not "off"), else (null, null, 0)."""
    if tables.vis is None:
        return [None, None, 0]
    return [tables.vis.data_ptr(), tables.bnd.data_ptr(),
            int(cfg.cull != "off")]


def refill_chunk(tables: SceneTables, cfg: KernelConfig, n: int,
                 residual: bool = False, replay: bool = False) -> int:
    """The lanes a warp of K1 (K2 with residual=True, K4 with replay=True)
    owns in a launch of n lanes of these tables on the current card: its 32
    threads trace them in turn, a thread taking the chunk's next lane when
    its lane ends (dead-lane refill, csrc/wavefront_fwd.cu
    `refill_chunk`)."""
    from kytpu_torch.kernels import build

    chunk = build.load().kytpu_wavefront_chunk(
        2 if replay else int(residual), n, SAMPLERS[cfg.sampler],
        *_scene_args(tables, cfg))
    if chunk < 0:
        raise RuntimeError("kytpu_wavefront_chunk failed")
    return chunk


def _launch(tables: SceneTables, cfg: KernelConfig, o, d, seed, si, pix,
            residual: bool = False):
    """K1 (or K2 with residual=True) on CUDA lanes -> radiance (or
    (radiance, resf, resi)); raises if the kernel cannot be built or
    launched."""
    from kytpu_torch.kernels import build

    o, d, si, pix = _lanes(tables, cfg, o, d, si, pix)
    n, dev = o.shape[0], o.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    args = _lane_ptrs(tables, o, d, si, pix) + [out.data_ptr()]
    if residual:
        _, res_n = residual_layout(tables.static, cfg)
        # every plane of every lane is written by K2 (torch.empty, not zeros)
        resf = torch.empty((res_n, n), dtype=torch.float32, device=dev)
        resi = torch.empty((int_planes(tables.static, cfg), n),
                           dtype=torch.int32, device=dev)
        args += [resf.data_ptr(), resi.data_ptr()]
    lib = build.load()
    name = "wavefront_fwd_res" if residual else "wavefront_fwd"
    run(getattr(lib, "kytpu_" + name), name, "k2" if residual else "k1",
        dev, *args, n, *cfg_args(cfg, seed), *_scene_args(tables, cfg),
        *_cull_args(tables, cfg))
    return (out, resf, resi) if residual else out


def _launch_bwd(tables: SceneTables, cfg: KernelConfig, g, big_l, resf,
                resi):
    """K3 on CUDA lanes -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]);
    raises if a kernel cannot be built or launched."""
    from kytpu_torch.kernels import build

    dev = g.device
    n = g.shape[0]
    m_rows = len(tables.static["mats"]["kind"])
    _, res_n = residual_layout(tables.static, cfg)
    for name, t, shape, dt in (
            ("g", g, (n, 3), torch.float32),
            ("L", big_l, (n, 3), torch.float32),
            ("resf", resf, (res_n, n), torch.float32),
            ("resi", resi, (int_planes(tables.static, cfg), n),
             torch.int32)):
        check_lane_tensor(name, t, shape, dt, dev)
    _check_tables(tables, dev)
    g, big_l = g.contiguous(), big_l.contiguous()
    resf, resi = resf.contiguous(), resi.contiguous()
    k, k_out = _row_cols(tables, cfg), _n_cols(tables, cfg)
    nb = max(1, -(-n // BWD_THREADS))
    partial = torch.empty((k, nb), dtype=torch.float32, device=dev)
    out = torch.empty((k_out,), dtype=torch.float32, device=dev)
    tex = texel_outputs(tables, cfg, n, dev)
    rows = _row_outputs(tables, cfg, n, dev)
    route = acc_route(tables, cfg)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.load()
    run(lib.kytpu_wavefront_bwd_res, "wavefront_bwd_res", "k3", dev,
        tables.i.data_ptr(), tables.diffuse.data_ptr(),
        tables.specular.data_ptr(), tables.emission.data_ptr(),
        tables.light_emit.data_ptr(), tables.env.data_ptr(),
        tables.texa.data_ptr(), tables.texb.data_ptr(),
        tables.timg.data_ptr(), g.data_ptr(), big_l.data_ptr(),
        resf.data_ptr(), resi.data_ptr(), partial.data_ptr(),
        ptr(_wide(tables, cfg, route, nb, dev)),
        out.data_ptr(), *map(ptr, tex), *map(ptr, rows),
        acc_map(tables, cfg).data_ptr(), n, m_rows, k, k_out, cfg.max_depth,
        int(bool(tables.static["textures"])), ACC_ROUTES.index(route))
    return _grads_of(tables, cfg, out, tex, rows)


def _launch_replay(tables: SceneTables, cfg: KernelConfig, o, d, seed, si,
                   pix, g, big_l):
    """K4 on CUDA lanes -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]);
    raises if a kernel cannot be built or launched."""
    from kytpu_torch.kernels import build

    o, d, si, pix = _lanes(tables, cfg, o, d, si, pix)
    n, dev = o.shape[0], o.device
    check_lane_tensor("g", g, (n, 3), torch.float32, dev)
    check_lane_tensor("L", big_l, (n, 3), torch.float32, dev)
    g, big_l = g.contiguous(), big_l.contiguous()
    k, k_out = _row_cols(tables, cfg), _n_cols(tables, cfg)
    # the launch's blocks: 4 warps each, a warp's chunk of lanes apiece
    with torch.cuda.device(dev):
        chunk = refill_chunk(tables, cfg, n, replay=True)
    nb = max(1, -(-n // (chunk * BWD_THREADS // 32)))
    partial = torch.empty((k, nb), dtype=torch.float32, device=dev)
    out = torch.empty((k_out,), dtype=torch.float32, device=dev)
    tex = texel_outputs(tables, cfg, n, dev)
    rows = _row_outputs(tables, cfg, n, dev)
    route = acc_route(tables, cfg, replay=True)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.load()
    run(lib.kytpu_wavefront_bwd_replay, "wavefront_bwd_replay", "k4",
        dev, *_lane_ptrs(tables, o, d, si, pix), g.data_ptr(),
        big_l.data_ptr(), partial.data_ptr(),
        ptr(_wide(tables, cfg, route, nb, dev)),
        out.data_ptr(), *map(ptr, tex), *map(ptr, rows),
        acc_map(tables, cfg).data_ptr(), n, k, k_out, *cfg_args(cfg, seed),
        *_scene_args(tables, cfg), ACC_ROUTES.index(route), nb,
        *_cull_args(tables, cfg))
    return _grads_of(tables, cfg, out, tex, rows)


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


def trace_lanes(tables: SceneTables, cfg: KernelConfig, o, d, seed: int,
                si=None, pix=None, residual: bool = False):
    """K1 (K2 with residual=True, see `trace_lanes_plain` for what it
    returns): CUDA lanes launch the kernel or raise, CPU lanes run the
    plain version."""
    with kprof.kernel("k2" if residual else "k1"):
        if on_card(o.device):
            return _launch(tables, cfg, o, d, seed, si, pix, residual)
        return trace_lanes_plain(tables, cfg, o, d, seed, si, pix, residual)


def bwd_res(tables: SceneTables, cfg: KernelConfig, g, big_l, resf, resi):
    """K3 -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]): CUDA lanes
    launch the kernels or raise, CPU lanes run `bwd_res_plain`."""
    with kprof.kernel("k3"):
        if on_card(g.device):
            return _launch_bwd(tables, cfg, g, big_l, resf, resi)
        return bwd_res_plain(tables, cfg, g, big_l, resf, resi)


def bwd_replay(tables: SceneTables, cfg: KernelConfig, o, d, seed: int, si,
               pix, g, big_l):
    """K4 -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]) on the lanes (o,
    d, seed, si, pix) that the forward traced, its radiance big_l and the
    upstream gradient g: CUDA lanes launch the kernels or raise, CPU lanes
    run `bwd_replay_plain`."""
    with kprof.kernel("k4"):
        if on_card(o.device):
            return _launch_replay(tables, cfg, o, d, seed, si, pix, g, big_l)
        return bwd_replay_plain(tables, cfg, o, d, seed, si, pix, g, big_l)


def render_lanes_cuda(scene, o, d, seed: int, cfg: KernelConfig | None = None,
                      si=None, pix=None):
    """One-shot wrapper around make_cuda_tracer (kytpu's
    render_lanes_pallas)."""
    return make_cuda_tracer(scene, cfg)(scene, o, d, seed, si, pix)


class _DiffTables(kad.DiffTables):
    """A diff tracer's tables for K1-K4: K1 or K2 forward, K3 or K4
    backward (looked up in this module at each call)."""

    pack = staticmethod(pack_tables)

    def trace(self, tables, o, d, seed, si, pix, residual=False):
        return trace_lanes(tables, self.cfg, o, d, seed, si, pix,
                           residual=residual)

    def bwd_res(self, tables, g, big_l, resf, resi):
        return bwd_res(tables, self.cfg, g, big_l, resf, resi)

    def bwd_replay(self, tables, o, d, seed, si, pix, g, big_l):
        return bwd_replay(tables, self.cfg, o, d, seed, si, pix, g, big_l)


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
    fn = kad.function_of(backward)
    check_config(cfg)
    return kad.diff_tracer(_DiffTables(scene, cfg), fn)


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
    # the key's words, krng.key(seed), stay on the host: "random" and
    # "hash" draw from them with one launch a pass (kernels/camera.py)
    key = (0, seed & M32)
    if cfg.sampler in ("hash", "sobol"):
        pid = torch.arange(npix, dtype=torch.int64, device=dev)
        pid_k = pid.repeat(k)
    if cfg.sampler == "sobol":
        px0 = (pid % w).to(torch.float32).repeat(k)
        py0 = (pid // w).to(torch.float32).repeat(k)
        # the camera-jitter site: a key per pixel, the same for every sample
        cam_keys = krng.fold_in(krng.key(seed, dev), pid_k)
    accum = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    s0 = p = 0
    while s0 < spp:
        with kprof.span("kytpu::pass"):
            with kprof.span("kytpu::rays"):
                if cfg.sampler in ("hash", "sobol"):
                    si = p * k + torch.arange(
                        k, dtype=torch.int64, device=dev).repeat_interleave(
                            npix)
                    if cfg.sampler == "sobol":
                        u = krng.uniform2(cam_keys, "sobol", si)
                        o, d = kscene.generate_rays(cam, torch.stack(
                            [px0 + u[:, 0], py0 + u[:, 1]], dim=-1))
                    else:
                        o, d = kcam.lane_rays(cam, key, k * npix, npix,
                                              "hash", p * k)
                    args = (seed, as_i32(si & M32), pid_k.to(torch.int32))
                else:
                    o, d = kcam.lane_rays(cam, krng.fold_in_words(key, p),
                                          k * npix, npix, "random")
                    args = (i32(seed + 7919 * p),)
            out = tracer(scene, o, d, *args)
            accum = accum + out.reshape(k, npix, 3).sum(dim=0)
        s0 += k
        p += 1
    img = km.div(accum, float(p * k)).reshape(h, w, 3)
    return torch.clamp(img, 0.0, 1.0) if clamp else img
