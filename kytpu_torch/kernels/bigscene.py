"""The table-driven big-scene megakernels (kytpu/kernels/bigscene.py): the
forward K5, the residual forward K6, the cache backward K7 and the
path-replay backward K8, for scenes past 64 surfaces, where K1-K4
(kernels/wavefront.py) stop.

Three layers, each the counterpart of one in the JAX package:

- host side: `extract_tables` (the scene's geometry as one SoA table per
  shape class, tri / rect / disk / sphere, rows in the order of the leaves
  of the class's cull tree, with the global surface row of each table
  row),
  `bigres_layout` (K6's cache planes) and `pack_big_tables`, which puts the
  class tables, the material rows and the lights (kernels/wavefront.py's
  header and light records, so csrc/megakernel.cuh's light and BSDF code
  reads them unchanged) on the device;
- `trace_lanes_plain` (K5, and K6 with residual=True), `bwd_replay_plain`
  (K8, one body with them in `_trace_plain`) and `bwd_res_plain` (K7),
  plain torch transcriptions of `_make_kernel(grad=False[,
  residual=True])`, `_make_kernel(grad=True)` and `_make_res_bwd_kernel`,
  with the segment sums by row that finish K7 and K8 (`sums_plain`). The
  sweeps test every surface of a class at once, as (lanes x rows) tensors
  in chunks. CPU tensors run them, and the card checks the kernels against
  them;
- the wrappers (`trace_lanes`, `bwd_res`, `bwd_replay`,
  `make_bigscene_tracer`, `make_bigscene_diff_tracer`, `render_bigscene`),
  which launch `csrc/bigscene_fwd.cu` (K5, K6, K8),
  `csrc/bigscene_bwd_res.cu` (K7) and `csrc/tag_sums.cu` (the sort of the
  row tags and the sums by row) on CUDA tensors.

Semantics, as kytpu's table kernel: the closest hit sweeps tri -> rect ->
disk -> sphere, rows in table order, accepting strictly nearer hits (the
first row wins a tie); the hit's material comes from its global row (the
exponent per hit, from the per-call exponent table), its emission from every
row whatever its light binding; NEE samples every light (cfg.nee is not
read) with one occlusion sweep a bounce; under shadow="robust" each light's
shadow ray skips the light's own emitting surface. kytpu's default past 64
surfaces is its matmul sweep (cfg.sweep="auto"), about an ulp away from
the scalar sweep that the port runs for every cfg.sweep. cfg.cull: kytpu
skips the 8-row blocks that a tile's ray cone cannot meet, on its primary
sweep ("cone") and on compact lights' shadow sweeps ("cone+nee"), where its
rays are coherent; on the card "cone" and "cone+nee" cull every sweep, each
lane walking a tree of padded boxes on its own (`tree_bounds`,
`node_meets_plain`) and testing the rows of the leaves its own rays meet,
since a per-lane test does not fall apart on incoherent rays as a
per-tile cone does; "off" sweeps every row. The cull
is exact-conservative: the results are the full sweep's to the last bit,
so the plain versions
sweep every row whatever cfg.cull says. Textures as kytpu's
table kernel evaluates them: checkers and atlases of its select chain (at
most 64 texels, power-of-two sides) on planar rows, found by the hit's
global row; K6 caches the textured diffuse, the checker parity (bit 22 of
the int plane) and the texel coordinates ("tx", "ty"), and K7 and K8 route
a textured row's diffuse adjoint to its texture (kernels/shading.py
`textures_at`, `route_textures`).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from kytpu_torch import bsdf as kbsdf
from kytpu_torch.core import math as km
from kytpu_torch.kernels import autodiff as kad
from kytpu_torch.kernels import tables as ktab
from kytpu_torch.kernels import tag_sums as kts
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.kernels.cull import (CLASSES, CULL_PAD, UNROLL, box_tree,
                                      morton3)
from kytpu_torch.kernels.launch import (cfg_args, check_lane_tensor,
                                        check_tables, lanes_checked, on_card,
                                        run, texel_outputs)
from kytpu_torch.kernels.shading import (
    EPS, OFF, SHADOW_EPS, TWO_PI, bsdf_eval_pdf_dots, bsdf_sample, env_pdf,
    hit_light_pdf, image_taps, kappa, kappa_dot, light_sample, offset_origin,
    rng_keys, route_textures, sin_from_phi_cos, sphere_occludes, st,
    texel_shape, textures_at, where)
# the sums by row of K7 and K8 (and of K3's and K4's texel entries)
from kytpu_torch.kernels.tag_sums import segment_sums_plain  # noqa: F401
from kytpu_torch.kernels.v3 import V3, make_frame, to_local, to_world, v3_full
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import scene as kscene
from kytpu_torch.scene import shapes as kshapes
from kytpu_torch.utils import profiling as kprof

# planar table columns: normal, n.anchor, dual basis 1, f1.anchor, dual
# basis 2, f2.anchor
PG_NX, PG_NY, PG_NZ, PG_CN = 0, 1, 2, 3
PG_F1X, PG_F1Y, PG_F1Z, PG_K1 = 4, 5, 6, 7
PG_F2X, PG_F2Y, PG_F2Z, PG_K2 = 8, 9, 10, 11
PLANAR_GEO_COLS = 12
# disk table: normal, n.anchor, centre, radius^2
DG_NX, DG_NY, DG_NZ, DG_CN, DG_PX, DG_PY, DG_PZ, DG_R2 = range(8)
DISK_GEO_COLS = 8
# sphere table: centre, radius
SG_CX, SG_CY, SG_CZ, SG_R = range(4)
SPHERE_GEO_COLS = 4
GEO_COLS = {"tri": PLANAR_GEO_COLS, "rect": PLANAR_GEO_COLS,
            "disk": DISK_GEO_COLS, "sphere": SPHERE_GEO_COLS}
# resi: sid+1 in bits 0-19, lobe_is_phong in bit 20, to_spec in bit 21, the
# checker parity of a textured row in bit 22
RESI_ROW_MASK = (1 << 20) - 1
RESI_PHONG, RESI_TO_SPEC, RESI_EVEN = 1 << 20, 1 << 21, 1 << 22

# ---------------------------------------------------------------------------
# host side: the class tables
# ---------------------------------------------------------------------------


def _pad_rows(a, mult=UNROLL):
    n = a.shape[0]
    npad = ((n + mult - 1) // mult) * mult if n else 0
    if npad == n:
        return a
    return np.concatenate([a, np.zeros((npad - n,) + a.shape[1:],
                                       a.dtype)], axis=0)


# children of a node of K5's, K6's and K8's cull trees at most (TREE_ARITY
# in csrc/bigscene_fwd.cu)
ARITY = 4
# leaves a lane of their walk holds pending while it steps on (LEAF_BUF in
# csrc/bigscene_fwd.cu)
LEAF_BUF = 4
# FP32 operations of csrc/bigscene_fwd.cu, counted from the source: a
# closest-hit row test of each class, tri | rect | disk | sphere, and a box
# test of the tree (`box_meets`: 6 subtractions, 6 products, 6 min / max, a
# comparison); `extract_tables`' SAH weighs its trees by them
ROW_TEST_OPS = (39, 38, 26, 34)
BOX_TEST_OPS = 19


@kprof.spanned("kytpu::tables.pack")
def extract_tables(scene):
    """Host-side extraction (kytpu's `extract_tables`) -> (static, tables):
    static is kernels/wavefront.py's `extract_static` dict (without K1's
    occlusion-skip proofs) plus "table_of_row" (global surface row ->
    (class, table row)); tables maps each class to (geometry (rows padded
    to 8, cols) float32, global row of each table row (int32, padded with
    0), the class's cull tree (`cull.box_tree`: (entries, 8) float32, skips
    class-local), each table row's rank in kytpu's Morton order of the
    class (int32, padded with 0)). Each class's cull tree is a binned SAH
    over the float64 boxes of its rows (a sphere's c +- r, a triangle's or
    rect's box of its vertices, a disk's exact box), weighing a box test at
    BOX_TEST_OPS and a row test at the class's ROW_TEST_OPS, with leaves of
    1 to 8 rows; the class's rows are stored in the depth-first order of
    its leaves (kytpu sorts them by the Morton code of their bound centres
    instead), so a leaf is a run of table rows. Of two rows of a class that
    a ray hits at the same t, the closest hit takes the one of lower rank,
    as kytpu's sweep does. Raises NotImplementedError, as kytpu's does, for
    what the tables do not take: a texture the kernels do not evaluate
    (`kwf.kernel_texture_support`), an atlas past the select chain (over 64
    texels, or a side that is not a power of two) and a rect that is not a
    parallelogram; render() and make_train_step() run such a scene on
    K1-K4."""
    err = kwf.kernel_texture_support(scene)
    if err:
        raise NotImplementedError(err)
    static = kwf.extract_static(scene, occl_skip=False)
    if any(r.get("sep") for r in static["textures"]):
        raise NotImplementedError(
            "the table kernel's in-kernel image fetch is the select chain "
            f"(<= {kwf.KERNEL_MAX_TEXELS} pow2 texels); larger / non-pow2 "
            "atlases run on K1-K4 (kernels/wavefront.py)")
    tris, rects, disks = [], [], []
    tri_rows, rect_rows, disk_rows = [], [], []
    # per row, float64: its box (lo, hi) and the centre of kytpu's bound
    tri_b, rect_b, disk_b = [], [], []

    def vert_box(verts):
        v = np.asarray(verts, np.float64)
        lo, hi = v.min(axis=0), v.max(axis=0)
        return lo, hi, (lo + hi) * 0.5

    for row, s in enumerate(static["planar"]):
        if s["kind"] == kshapes.DISK:
            n = np.asarray(s["n"], np.float64)
            p0 = np.asarray(s["p0"], np.float64)
            disks.append(list(n) + [float(np.dot(n, p0))] + list(p0)
                         + [s["radius"] ** 2])
            disk_rows.append(row)
            # the disk's exact box: r sqrt(1 - n_a^2) about p0 on axis a
            u = n / np.linalg.norm(n)
            e = abs(s["radius"]) * np.sqrt(np.maximum(1.0 - u * u, 0.0))
            disk_b.append((p0 - e, p0 + e, p0))
            continue
        if not s.get("fast"):
            raise NotImplementedError(
                f"surface {row} is a rect that is not a parallelogram: the "
                "table-driven kernel supports triangles, parallelogram "
                "rectangles, disks and spheres (K1-K4, kernels/wavefront.py, "
                "take any rect)")
        n = np.asarray(s["n"], np.float64)
        anchor = np.asarray(s["anchor"], np.float64)
        f1 = np.asarray(s["f1"], np.float64)
        f2 = np.asarray(s["f2"], np.float64)
        rec = (list(n) + [float(np.dot(n, anchor))]
               + list(f1) + [float(np.dot(f1, anchor))]
               + list(f2) + [float(np.dot(f2, anchor))])
        if s["kind"] == kshapes.TRI:
            tris.append(rec)
            tri_rows.append(row)
            tri_b.append(vert_box([s["p0"], s["p1"], s["p2"]]))
        else:
            rects.append(rec)
            rect_rows.append(row)
            rect_b.append(vert_box([s["p0"], s["p1"], s["p2"], s["p3"]]))
    spheres = [list(np.asarray(s["c"], np.float64)) + [s["r"]]
               for s in static["spheres"]]
    sph_rows = [len(static["planar"]) + j for j in range(len(spheres))]
    sph_b = [(np.asarray(s["c"], np.float64) - abs(s["r"]),
              np.asarray(s["c"], np.float64) + abs(s["r"]),
              np.asarray(s["c"], np.float64)) for s in static["spheres"]]

    # scene-wide AABB of bound centres for the Morton quantization
    all_c = [b[2] for bs in (tri_b, rect_b, disk_b, sph_b) for b in bs]
    if all_c:
        allc = np.asarray(all_c, np.float64)
        m_lo, m_hi = allc.min(axis=0), allc.max(axis=0)
    else:
        m_lo = m_hi = np.zeros(3)

    def blk(lst, rows, boxes, cols, k):
        geo = np.asarray(lst, np.float32).reshape(len(lst), cols)
        rows = np.asarray(rows, np.int32)
        lo, hi, cen = (np.asarray([b[i] for b in boxes], np.float64)
                       .reshape(-1, 3) for i in range(3))
        rank = np.arange(len(boxes), dtype=np.int32)
        if len(boxes) > 1:
            rank[np.argsort(np.asarray(morton3(cen, m_lo, m_hi)),
                            kind="stable")] = np.arange(len(boxes))
        order, tree = box_tree(lo, hi, ROW_TEST_OPS[k], BOX_TEST_OPS, ARITY)
        return (_pad_rows(geo[order]), _pad_rows(rows[order]), tree,
                _pad_rows(rank[order]))

    tables = {
        "tri": blk(tris, tri_rows, tri_b, PLANAR_GEO_COLS, 0),
        "rect": blk(rects, rect_rows, rect_b, PLANAR_GEO_COLS, 1),
        "disk": blk(disks, disk_rows, disk_b, DISK_GEO_COLS, 2),
        "sphere": blk(spheres, sph_rows, sph_b, SPHERE_GEO_COLS, 3),
    }
    n_real = {"tri": len(tris), "rect": len(rects), "disk": len(disks),
              "sphere": len(spheres)}
    table_of_row = {}
    for name in CLASSES:
        for ti, row in enumerate(np.asarray(tables[name][1])[:n_real[name]]):
            table_of_row[int(row)] = (name, ti)
    static["table_of_row"] = table_of_row
    static["n_real"] = n_real
    return static, tables


def layout_of(static, cfg: kwf.KernelConfig):
    """`bigres_layout` of a scene's static dict: the environment planes are
    there iff one of its lights is the environment, the texel planes iff a
    row reads an image texture, as the kernels read them."""
    return bigres_layout(cfg, len(static["lights"]),
                         any(lt["kind"] == klights.ENV
                             for lt in static["lights"]),
                         ktab.has_img(static))


def bigres_layout(cfg: kwf.KernelConfig, n_lights: int, has_env: bool,
                  has_img: bool = False):
    """Plane order of K6's coefficient cache (kytpu's `_bigres_layout`) ->
    ({tag: plane}, count). Per bounce: "wb" (hit emission MIS weight, fully
    masked), "wenv" (env scenes), the hit's emission "emi" (3 planes);
    below the horizon one "B" per NEE light ("Bk" after each under
    trainable_exponent), "tu" ("tuk"), and the hit's colours "dif" (the
    textured value on a textured row), "spc" (3 planes each): at thousands
    of rows the backward cannot re-read them by row, so the forward caches
    the values; then on image scenes the hit's texel coordinates "tx",
    "ty" on its image row (0 elsewhere). csrc/bigscene_fwd.cu `BigRes`
    computes the same offsets."""
    texp = cfg.trainable_exponent
    tags = []
    for b in range(cfg.max_depth + 1):
        tags.append(("wb", b))
        if has_env:
            tags.append(("wenv", b))
        for c in range(3):
            tags.append(("emi", b, c))
        if b < cfg.max_depth:
            for i in range(n_lights):
                tags.append(("B", b, i))
                if texp:
                    tags.append(("Bk", b, i))
            tags.append(("tu", b))
            if texp:
                tags.append(("tuk", b))
            for c in range(3):
                tags.append(("dif", b, c))
            for c in range(3):
                tags.append(("spc", b, c))
            if has_img:
                tags.append(("tx", b))
                tags.append(("ty", b))
    return {t: i for i, t in enumerate(tags)}, len(tags)


def tree_bounds(tables) -> np.ndarray:
    """K5's, K6's and K8's cull trees of `extract_tables`' tables as one
    (entries, 8) float32 array, tri | rect | disk | sphere, each class's
    tree (`cull.box_tree`) laid out depth first with its skips moved past
    the classes before it. An entry is [lo.x lo.y lo.z skip hi.x hi.y hi.z
    leaf], skip and leaf int32 bits: skip the entry after the entry's
    subtree (for a leaf, the next entry), leaf first row * 8 + rows - 1 of
    the leaf's run of rows in its class's table, or -1 above the leaves;
    a class's first entry is its root, whose skip ends the class. The box
    of a leaf is its rows' float64 box padded by CULL_PAD of its size and
    rounded outward to float32 (`cull.padded_boxes`), a node's the float32
    union of its children's. A walk that goes on to entry + 1 where a ray
    meets an entry's box and to its skip where it does not visits the
    class's rows in table order (csrc/bigscene_fwd.cu `walk`)."""
    out, off = [], 0
    for k in CLASSES:
        rec = np.array(tables[k][2], np.float32).reshape(-1, 8)
        rec.view(np.int32)[:, 3] += off
        out.append(rec)
        off += len(rec)
    return np.concatenate(out)


def tree_links(bnd: torch.Tensor) -> torch.Tensor:
    """(skip, leaf) of each entry of `tree_bounds`' array, (entries, 2)
    int64."""
    return bnd.contiguous().view(torch.int32)[:, [3, 7]].long()


def cull_slack_plain(o: V3, d: V3):
    """megakernel.cuh `cull_slack`: (a ray's slack, 1 / |d|^2); the slack
    is CULL_PAD * |o|_1, or inf (every block and box passes) where the ray,
    |d|^2 or its inverse is not finite or |d|^2 is 0."""
    dd = d.dot(d)
    inv = km.div(1.0, dd)
    s = ktab.f32(CULL_PAD) * ((torch.abs(o.x) + torch.abs(o.y))
                             + torch.abs(o.z))
    ok = torch.isfinite(s) & torch.isfinite(dd) & torch.isfinite(inv) \
        & (dd > 0)
    return torch.where(ok, s, torch.full_like(s, math.inf)), inv


def block_meets_plain(bnd: torch.Tensor, o: V3, d: V3, inv, t1, slack):
    """megakernel.cuh `block_meets`, K1's, K2's and K4's per-lane block test
    past 64 surfaces (`kwf.cull_tables`), on (C,) rays against (B, 4)
    bounds [cx cy cz R] -> (C, B): can o + t d, t in [0, t1], come within R
    + slack of the block's centre? inv: 1 / |d|^2 (`cull_slack_plain`); t1
    is (C,), a ray's for every block, or (C, B), one a pair. The closest
    point's t is clamped to the segment; a NaN passes."""
    col = lambda x: x.reshape(-1, 1)  # noqa: E731
    o, d = V3(col(o.x), col(o.y), col(o.z)), V3(col(d.x), col(d.y), col(d.z))
    t1 = t1 if t1.dim() == 2 else col(t1)
    v = V3(bnd[:, 0] - o.x, bnd[:, 1] - o.y, bnd[:, 2] - o.z)
    tc = v.dot(d) * col(inv)
    tc = torch.where(tc < 0, torch.zeros_like(tc), tc)
    tc = torch.where(tc > t1, t1, tc)
    p = v - d * tc
    rl = bnd[:, 3] + col(slack)
    return ~(p.dot(p) > rl * rl)


def node_meets_plain(bnd: torch.Tensor, o: V3, d: V3, t1, slack):
    """csrc/bigscene_fwd.cu `box_meets` (with `slab`), the walk's test of a
    ray against a box of `tree_bounds`: can o + t d, t in [0, t1], meet the
    box [lo - slack, hi + slack]? bnd (..., 8) entries and rays o, d, t1,
    slack (`cull_slack_plain`) of shapes that broadcast with bnd[..., 0] ->
    their shape. Each axis's t runs from the face the sign of 1 / d puts
    first to the other, the origin moved by the slack; a NaN among them is
    dropped (fmax / fmin), so a NaN never culls."""
    inv = V3(km.div(1.0, d.x), km.div(1.0, d.y), km.div(1.0, d.z))
    tn, tf = torch.zeros((), dtype=bnd.dtype), t1
    for a, (oa, ia) in enumerate(((o.x, inv.x), (o.y, inv.y), (o.z, inv.z))):
        neg = ia < 0
        pn = torch.where(neg, oa - slack, oa + slack)
        pf = torch.where(neg, oa + slack, oa - slack)
        lo, hi = bnd[..., a], bnd[..., 4 + a]
        tn = torch.fmax(tn, (torch.where(neg, hi, lo) - pn) * ia)
        tf = torch.fmin(tf, (torch.where(neg, lo, hi) - pf) * ia)
    return ~(tn > tf)


@dataclass(frozen=True)
class BigTables:
    """What one big-scene launch reads. geo: the class tables' real rows
    (no padding), tri | rect | disk | sphere, each row-major with its
    class's column count, one float32 tensor; rows: the global surface row
    of each, and rank: its rank in kytpu's Morton order of its class (the
    closest hit's tie-break), one int32 tensor each; counts: rows per
    class. f, i: the header,
    light and texture records of kernels/wavefront.py's tables with no
    geometry records; mat_i (M, 2) int32: material kind, light index;
    tex_rec (M,) int32: each row's texture record (-1: none), read only by
    the textured instantiations; mat_f (M, 4) float32: eta, d_prob, s_prob,
    0; bnd (entries, 8) float32: `tree_bounds`. Then the
    tables a render may change without repacking (texa, texb, timg: one
    zero row each in an untextured scene)."""

    static: dict
    counts: tuple
    geo: torch.Tensor
    rows: torch.Tensor
    rank: torch.Tensor
    f: torch.Tensor
    i: torch.Tensor
    mat_i: torch.Tensor
    tex_rec: torch.Tensor
    mat_f: torch.Tensor
    bnd: torch.Tensor
    diffuse: torch.Tensor     # (M, 3)
    specular: torch.Tensor    # (M, 3)
    emission: torch.Tensor    # (M, 3)
    exponent: torch.Tensor    # (M,)
    light_emit: torch.Tensor  # (max(L, 1), 3)
    env: torch.Tensor         # (3,)
    texa: torch.Tensor        # (max(T, 1), 3) checker "even" colours
    texb: torch.Tensor        # (max(T, 1), 3) checker "odd" colours
    timg: torch.Tensor        # (max(Ti H W, 1), 3) the texel atlas

    @kprof.spanned("kytpu::tables.colors")
    def with_colors(self, scene: kscene.Scene) -> "BigTables":
        return dataclasses.replace(self, **ktab.color_tables(scene),
                                   **ktab.texture_tables(scene))

    def cls(self, name: str):
        """(geometry (R, cols), global rows (R,)) of one class."""
        k = CLASSES.index(name)
        r0 = sum(self.counts[:k])
        g0 = sum(c * GEO_COLS[nm] for c, nm in zip(self.counts[:k], CLASSES))
        r = self.counts[k]
        return (self.geo[g0:g0 + r * GEO_COLS[name]].reshape(
            r, GEO_COLS[name]), self.rows[r0:r0 + r])


@kprof.spanned("kytpu::tables.pack")
def pack_big_tables(scene: kscene.Scene, cfg: kwf.KernelConfig,
                    extracted=None) -> BigTables:
    """The launch tables of `scene`; extracted: `extract_tables(scene)`
    where the caller has it."""
    static, tables = extracted or extract_tables(scene)
    counts = tuple(static["n_real"][k] for k in CLASSES)
    geo = np.concatenate([tables[k][0][:c].reshape(-1)
                          for k, c in zip(CLASSES, counts)]
                         + [np.zeros(0, np.float32)])
    rows, rank = (np.concatenate([tables[k][j][:c]
                                  for k, c in zip(CLASSES, counts)]
                                 + [np.zeros(0, np.int32)]) for j in (1, 3))
    # the header of K1's tables with no geometry or material records: the
    # exponent is per hit (never static) and every light is sampled
    (hi, hf), (li, lf) = kwf.pack_header(
        static, dataclasses.replace(cfg, nee="all"), (0, 0, 0), None)
    static["light_surface_rows"] = tuple(scene.lights.surface_ids)
    mats = static["mats"]
    mat_i = np.stack([np.asarray(mats["kind"], np.int32),
                      np.asarray(mats["light_index"], np.int32)], -1)
    tex_rec = np.asarray(kwf.texture_record_of_row(static), np.int32)
    mat_f = np.stack([np.asarray(mats["eta"], np.float32),
                      np.asarray(mats["d_prob"], np.float32),
                      np.asarray(mats["s_prob"], np.float32),
                      np.zeros(len(mats["kind"]), np.float32)], -1)
    ti, tf = kwf.texture_records(static)
    bnd = tree_bounds(tables)
    dev = scene.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return BigTables(static=static, counts=counts, geo=t(geo), rows=t(rows),
                     rank=t(rank),
                     f=t(np.concatenate([hf, lf, tf])),
                     i=t(np.concatenate([hi, li, ti])), mat_i=t(mat_i),
                     tex_rec=t(tex_rec), mat_f=t(mat_f), bnd=t(bnd),
                     **ktab.color_tables(scene),
                     **ktab.texture_tables(scene))


# ---------------------------------------------------------------------------
# plain version: the sweeps, all rows of a class at once
# ---------------------------------------------------------------------------

_OFF2 = ktab.f32(km.RAY_OFFSET * km.RAY_OFFSET)


def _chunk(dev: torch.device) -> int:
    """Lanes x rows elements one sweep step of the plain version holds."""
    return 1 << (24 if dev.type == "cuda" else 22)


def _col(v: V3) -> V3:
    """(C,) lane planes -> (C, 1) columns against (R,) table rows."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _tdot(G, k: int, v: V3):
    """Table vector G[:, k:k+3] . v, summed as (x + y) + z (V3.dot)."""
    return (G[:, k] * v.x + G[:, k + 1] * v.y) + G[:, k + 2] * v.z


def _planar_inside(a, b, tri: bool):
    if tri:
        return (a >= 0) & (b >= 0) & (a + b <= 1.0)
    return (a >= 0) & (a <= 1.0) & (b >= 0) & (b <= 1.0)


def _closest_class(name, G, o: V3, d: V3):
    """(C, R) hit distances of one class's rows, inf where a row is not hit
    (`_closest_hit_tables`' accept gates without the running best)."""
    if name == "sphere":
        r = G[:, SG_R]
        oc = V3(G[:, SG_CX] - o.x, G[:, SG_CY] - o.y, G[:, SG_CZ] - o.z)
        neg_b = oc.dot(d)
        perp = oc - d * neg_b
        discr = r * r - perp.length_squared()
        cc = oc.length_squared() - r * r
        sq = km.safe_sqrt(discr)
        q = neg_b + where(neg_b >= 0.0, 1.0, -1.0) * sq
        tq = cc / q
        t1 = torch.minimum(q, tq)
        t2 = torch.maximum(q, tq)
        t1_ok = t1 > EPS
        t = torch.where(t1_ok, t1, t2)
        ok = (discr >= 0) & (r > 0) & (t1_ok | (t2 > EPS))
    elif name == "disk":
        t = (G[:, DG_CN] - _tdot(G, DG_NX, o)) / _tdot(G, DG_NX, d)
        hp = o + d * t
        rel = V3(hp.x - G[:, DG_PX], hp.y - G[:, DG_PY], hp.z - G[:, DG_PZ])
        ok = (rel.length_squared() <= G[:, DG_R2]) & (t > EPS)
    else:
        t = (G[:, PG_CN] - _tdot(G, PG_NX, o)) / _tdot(G, PG_NX, d)
        a = (_tdot(G, PG_F1X, o) - G[:, PG_K1]) + t * _tdot(G, PG_F1X, d)
        b = (_tdot(G, PG_F2X, o) - G[:, PG_K2]) + t * _tdot(G, PG_F2X, d)
        ok = _planar_inside(a, b, name == "tri") & (t > EPS)
    return torch.where(ok, t, torch.full_like(t, math.inf))


def _closest_hit(bt: BigTables, o: V3, d: V3, live):
    """Closest hit of the `live` lanes -> (t, class index, table row), with
    (inf, -1, -1) on a miss and on every other lane. The classes are swept
    tri, rect, disk, sphere; within a class the nearest row of least rank
    wins (the first in kytpu's order), across classes a strictly nearer
    hit: the sequential sweep's strict `t < t_best`."""
    n = o.x.shape[0]
    t_best = torch.full((n,), math.inf, device=o.x.device)
    cls = torch.full((n,), -1, dtype=torch.int64, device=o.x.device)
    trow = torch.full_like(cls, -1)
    idx = live.nonzero().reshape(-1)
    if not len(idx):
        return t_best, cls, trow
    step = max(1, _chunk(o.x.device) // max(1, max(bt.counts)))
    for c0 in range(0, len(idx), step):
        li = idx[c0:c0 + step]
        oc = _col(V3(o.x[li], o.y[li], o.z[li]))
        dc = _col(V3(d.x[li], d.y[li], d.z[li]))
        tb = t_best[li]
        cb, rb = cls[li], trow[li]
        for k, name in enumerate(CLASSES):
            G, _ = bt.cls(name)
            if not len(G):
                continue
            r0 = sum(bt.counts[:k])
            t = _closest_class(name, G, oc, dc)
            tmin = t.min(dim=1)[0]
            arg = torch.where(t == tmin[:, None], bt.rank[r0:r0 + len(G)],
                              len(G)).argmin(dim=1)
            upd = tmin < tb
            tb = torch.where(upd, tmin, tb)
            cb = torch.where(upd, torch.full_like(cb, k), cb)
            rb = torch.where(upd, arg, rb)
        t_best[li], cls[li], trow[li] = tb, cb, rb
    return t_best, cls, trow


def _hit_record(bt: BigTables, o: V3, d: V3, t, cls, trow):
    """-> (valid, global row (-1 on a miss), normal): the table normal of a
    planar hit (a rect's turned toward the ray) or (o + d t - c) / r of a
    sphere hit."""
    valid = cls >= 0
    grow = torch.full_like(cls, -1)
    zero = torch.zeros_like(o.x)
    nx, ny, nz = zero, zero, zero
    for k, name in enumerate(CLASSES):
        G, rows = bt.cls(name)
        on = cls == k
        if not len(G):
            continue
        r = trow.clamp(0, len(G) - 1)
        grow = torch.where(on, rows.long()[r], grow)
        g = G[r]
        if name == "sphere":
            inv = km.div(1.0, torch.clamp_min(g[:, SG_R], 1e-20))
            n_sp = (o + d * t - V3(g[:, 0], g[:, 1], g[:, 2])) * inv
            nx = torch.where(on, n_sp.x, nx)
            ny = torch.where(on, n_sp.y, ny)
            nz = torch.where(on, n_sp.z, nz)
            continue
        n = V3(g[:, 0], g[:, 1], g[:, 2])
        if name == "rect":
            n = (-n).where(n.dot(d) > 0, n)
        nx = torch.where(on, n.x, nx)
        ny = torch.where(on, n.y, ny)
        nz = torch.where(on, n.z, nz)
    return valid, grow, V3(nx, ny, nz)


def _occluded_class(name, G, rows, hp: V3, ns: V3, rays, own):
    """(C,) hit masks of one class for each shadow ray (wi, tmax, se, nd)
    (`_any_hit_tables`' algebra): the terms of (hp, n_shade) are shared by
    the rays; own[k] is the global row ray k skips, or None."""
    out = []
    if name == "sphere":
        r = G[:, SG_R]
        vc = V3(G[:, SG_CX] - hp.x, G[:, SG_CY] - hp.y, G[:, SG_CZ] - hp.z)
        vc2 = vc.length_squared()
        vcn = vc.dot(ns)
        for wi, tmax, se, nd in rays:
            neg_b = vc.dot(wi) - se * nd
            oc2 = vc2 - 2.0 * se * vcn + _OFF2
            discr = r * r - oc2 + neg_b * neg_b
            out.append(sphere_occludes(neg_b, discr, tmax) & (r > 0))
    elif name == "disk":
        num_h = G[:, DG_CN] - _tdot(G, DG_NX, hp)
        num_n = _tdot(G, DG_NX, ns)
        for wi, tmax, se, nd in rays:
            t = (num_h - se * num_n) / _tdot(G, DG_NX, wi)
            o_k = hp + ns * se
            rel = o_k + wi * t
            rel = V3(rel.x - G[:, DG_PX], rel.y - G[:, DG_PY],
                     rel.z - G[:, DG_PZ])
            out.append((rel.length_squared() <= G[:, DG_R2]) & (t > EPS)
                       & (t < tmax))
    else:
        num_h = G[:, PG_CN] - _tdot(G, PG_NX, hp)
        num_n = _tdot(G, PG_NX, ns)
        a_h = _tdot(G, PG_F1X, hp) - G[:, PG_K1]
        a_n = _tdot(G, PG_F1X, ns)
        b_h = _tdot(G, PG_F2X, hp) - G[:, PG_K2]
        b_n = _tdot(G, PG_F2X, ns)
        for wi, tmax, se, nd in rays:
            t = (num_h - se * num_n) / _tdot(G, PG_NX, wi)
            a = (a_h + se * a_n) + t * _tdot(G, PG_F1X, wi)
            b = (b_h + se * b_n) + t * _tdot(G, PG_F2X, wi)
            out.append(_planar_inside(a, b, name == "tri") & (t > EPS)
                       & (t < tmax))
    return [(h & (rows != own[k]) if own[k] is not None else h).any(dim=1)
            for k, h in enumerate(out)]


def _occluded(bt: BigTables, hp: V3, ns: V3, rays, wants, robust: bool,
              own):
    """One occlusion sweep over every row for the K shadow rays [(wi,
    tmax)], ray k of the lanes where wants[k] (the kernel's `want` bits)
    -> K (N,) masks, False where ray k is not wanted. The origin of ray k
    is hp offset by +-RAY_OFFSET along ns by the sign of nd = ns.wi; under
    robust, tmax shrinks by that offset's projection and ray k skips its
    light's own surface."""
    n = hp.x.shape[0]
    K = len(rays)
    hits = [torch.zeros(n, dtype=torch.bool, device=hp.x.device)
            for _ in range(K)]
    need = torch.zeros(n, dtype=torch.bool, device=hp.x.device)
    for w in wants:
        need = need | w
    idx = need.nonzero().reshape(-1)
    if not len(idx) or not K:
        return hits
    nds = [ns.dot(wi) for wi, _ in rays]
    ses = [where(nd < 0.0, -OFF, OFF) for nd in nds]
    tms = [tm - se * nd if robust else tm
           for (_, tm), se, nd in zip(rays, ses, nds)]
    own = own if robust else [None] * K
    step = max(1, _chunk(hp.x.device) // max(1, K * max(bt.counts)))
    for c0 in range(0, len(idx), step):
        li = idx[c0:c0 + step]
        sub = lambda v: _col(V3(v.x[li], v.y[li], v.z[li]))  # noqa: E731
        crays = [(sub(wi), tms[k][li, None], ses[k][li, None],
                  nds[k][li, None]) for k, (wi, _) in enumerate(rays)]
        hc = [torch.zeros(len(li), dtype=torch.bool, device=hp.x.device)
              for _ in range(K)]
        for name in CLASSES:
            G, rows = bt.cls(name)
            if not len(G):
                continue
            for k, h in enumerate(_occluded_class(name, G, rows, sub(hp),
                                                  sub(ns), crays, own)):
                hc[k] = hc[k] | h
        for k in range(K):
            hits[k][li] = hc[k]
    return [h & w for h, w in zip(hits, wants)]


# ---------------------------------------------------------------------------
# plain version: the forward kernel body (K5, K6)
# ---------------------------------------------------------------------------


def trace_lanes_plain(tables: BigTables, cfg: kwf.KernelConfig,
                      o: torch.Tensor, d: torch.Tensor, seed: int,
                      si: torch.Tensor | None = None,
                      pix: torch.Tensor | None = None,
                      residual: bool = False):
    """Plain torch transcription of kytpu's table kernel
    (`bigscene._make_kernel`, grad=False), K5, on (N,) lanes.

    o, d: (N, 3) float32 rays; seed: int; si, pix: (N,) int sample index and
    pixel id, required by the "hash" and "sobol" samplers. Returns (N, 3)
    radiance. residual=True (K6) also returns the cache (resf (res_n, N)
    float32 in `bigres_layout`'s plane order, resi (max_depth+1, N) int32:
    row+1 in bits 0-19, lobe_is_phong in bit 20, to_spec in bit 21, the
    checker parity of a textured row in bit 22). A
    bounce a lane does not reach (it died before) has every plane 0, as
    K6 writes it; kytpu's straight-line kernel keeps tracing the lane's
    frozen ray there and writes that hit's colours and row, with zero
    coefficients, so its backward adds nothing for it either."""
    return _trace_plain(tables, cfg, o, d, seed, si, pix,
                        "residual" if residual else "forward")


def bwd_replay_plain(tables: BigTables, cfg: kwf.KernelConfig,
                     o: torch.Tensor, d: torch.Tensor, seed: int, si, pix,
                     g: torch.Tensor, big_l: torch.Tensor):
    """Plain K8, the big-scene path-replay backward (kytpu's `_make_kernel`
    with grad=True): the forward's lanes re-traced with the same draws, the
    upstream gradient g and the forward's radiance big_l (N, 3) -> the
    per-lane products of `bwd_lanes_plain` and a row-tag plane: (dout
    (PB*max_depth + 3, N) float32, acc (N, 3 + 3L + 6T) float32, tags
    (max_depth+1, N) int32, the hit's row + 1, 0 on a miss or a bounce the
    lane does not reach[, the texel entries of an image scene]). Per
    bounce it peels the tail radiance R_{b+1} = (R_b - E_b) / T_b (0 where
    the path ends); `sums_plain` finishes it as K7's sums by row do."""
    return _trace_plain(tables, cfg, o, d, seed, si, pix, "replay", g, big_l)


def _trace_plain(tables: BigTables, cfg: kwf.KernelConfig, o, d, seed: int,
                 si, pix, mode: str, g=None, big_l_in=None):
    """The plain table-kernel body. mode "forward" is K5, "residual" K6 and
    "replay" K8: one body, as `bigscene_fwd_kernel<MODE>` is one template,
    so K6 and K8 draw, hit and branch as K5 does."""
    kwf.check_config(cfg)
    if cfg.sampler in ("hash", "sobol") and (si is None or pix is None):
        raise ValueError(f'sampler="{cfg.sampler}" needs si and pix lane '
                         'arrays')
    static = tables.static
    mats, lights = static["mats"], static["lights"]
    L = len(lights)
    world_radius = static["world_radius"]
    lobes = mats["lobes"]
    eval_lobes = lobes & {kbsdf.LAMBERT, kbsdf.PHONG}
    has_plastic = kbsdf.MAT_PLASTIC in mats["kind"]
    has_delta = bool(lobes & {kbsdf.MIRROR, kbsdf.GLASS})
    env_i = next((i for i, lt in enumerate(lights)
                  if lt["kind"] == klights.ENV), None)
    robust = cfg.shadow == "robust"
    # per light, the global row of its first emitting surface, or None
    own = [ktab.light_rows(static).get(i) for i in range(L)]
    texp = cfg.trainable_exponent
    residual, replay = mode == "residual", mode == "replay"
    textured, has_img = bool(static["textures"]), ktab.has_img(static)

    n = o.shape[0]
    dev = o.device
    rng, _, _ = rng_keys(cfg, n, seed, si, pix, dev)
    kind_tab = tables.mat_i[:, 0].long()
    li_tab = tables.mat_i[:, 1].long()
    eta_tab, dprob_tab, sprob_tab = (tables.mat_f[:, k] for k in range(3))

    def row_of(grow, tab, fill):
        v = tab[grow.clamp_min(0)]
        return torch.where(grow >= 0, v, torch.full_like(v, fill))

    def row3(grow, tab):
        v = tab[grow.clamp_min(0)]
        ok = (grow >= 0)[:, None]
        v = torch.where(ok, v, torch.zeros_like(v))
        return V3(v[:, 0], v[:, 1], v[:, 2])

    o = V3(o[:, 0].float(), o[:, 1].float(), o[:, 2].float())
    d = V3(d[:, 0].float(), d[:, 1].float(), d[:, 2].float())
    beta = v3_full(o.x, 1.0, 1.0, 1.0)
    big_l = v3_full(o.x, 0.0, 0.0, 0.0)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    spec_prev = torch.zeros_like(alive)
    pdf_prev = torch.ones_like(o.x)
    phits_prev = None
    env = tables.env
    if residual:
        res_ix, res_n = layout_of(static, cfg)
        planes = [None] * res_n
        ints = [None] * (cfg.max_depth + 1)
    if replay:
        g = V3(*(g[:, c].to(dev, torch.float32) for c in range(3)))
        r_tail = V3(*(big_l_in[:, c].to(dev, torch.float32)
                      for c in range(3)))
        acc_env = v3_full(o.x, 0.0, 0.0, 0.0)
        acc_le = [v3_full(o.x, 0.0, 0.0, 0.0) for _ in range(L)]
        dplanes, tags = [], []
        T = ktab.n_tex(static)
        acc_ta, acc_tb = o.x.new_zeros((n, T, 3)), o.x.new_zeros((n, T, 3))
        entries = [] if has_img else None

    def where3(c, v: V3, other=0.0) -> V3:
        return V3(*(where(c, a, other) for a in (v.x, v.y, v.z)))

    for bounce in range(cfg.max_depth + 1):
        # dead lanes are not swept: they get a miss, so every term and cache
        # entry of theirs is 0, as in K5/K6, whose dead lanes leave the loop
        t, cls, trow = _closest_hit(tables, o, d, alive)
        valid, grow, nrm = _hit_record(tables, o, d, t, cls, trow)
        t_safe = where(valid, t, 1.0)
        hp = o + d * t_safe
        wo = -d
        facing = nrm.dot(wo) > 0.0
        emit_mask = valid & facing
        emi = row3(grow, tables.emission)
        le = V3(*(where(emit_mask, c, 0.0) for c in (emi.x, emi.y,
                                                     emi.z)))
        if bounce == 0:
            full = True
        elif has_delta:
            full = spec_prev
        else:
            full = False
        if full is True:
            w_emit = torch.ones_like(o.x)
        else:
            li_idx = row_of(grow, li_tab, -1)
            if phits_prev is not None:
                pdf_l_hit = torch.zeros_like(o.x)
                for i in range(L):
                    pdf_l_hit = torch.where(li_idx == i, phits_prev[i],
                                            pdf_l_hit)
            else:
                pdf_l_hit = hit_light_pdf(lights, li_idx, o, d, t_safe,
                                          nrm)
            w_emit = km.safe_div(pdf_prev, pdf_prev + pdf_l_hit)
            if full is not False:
                w_emit = where(full, 1.0, w_emit)
        wb = where(alive, w_emit, 0.0)
        e_term = le * wb
        big_l = big_l + beta * e_term
        if replay:
            # the hit emission's adjoint, and the bounce's row tag
            gb = g * beta
            de_b = gb * where(emit_mask, wb, 0.0)
            tags.append(where(valid, (grow + 1).to(torch.int32),
                              0).to(torch.int32))
        if residual:
            planes[res_ix[("wb", bounce)]] = where(emit_mask, wb, 0.0)
            for c, v in enumerate((emi.x, emi.y, emi.z)):
                planes[res_ix[("emi", bounce, c)]] = v

        if env_i is not None:
            ones = torch.ones_like(o.x)
            env_v = V3(env[0] * ones, env[1] * ones, env[2] * ones)
            if full is True:
                w_env = 1.0
            else:
                w_env = km.safe_div(pdf_prev, pdf_prev + env_pdf(d))
                if full is not False:
                    w_env = where(full, 1.0, w_env)
            wenv = where(alive & ~valid, w_env, 0.0)
            big_l = big_l + beta * env_v * wenv
            e_term = e_term + env_v * wenv
            if residual:
                planes[res_ix[("wenv", bounce)]] = wenv
            if replay:
                acc_env = acc_env + gb * wenv

        if bounce == cfg.max_depth:
            if replay:
                dplanes.extend([de_b.x, de_b.y, de_b.z])
            if residual:
                ints[bounce] = where(valid, (grow + 1).to(torch.int32),
                                     0).to(torch.int32)
            break
        cont = alive & valid

        diffuse = row3(grow, tables.diffuse)
        if textured:
            # a textured row's diffuse is its texture's value at the hit
            diffuse, tex_hits = textures_at(static, tables, grow, hp,
                                            diffuse)
            tex_hits = [(rec, onrow & alive, *rest)
                        for rec, onrow, *rest in tex_hits]
        specular = row3(grow, tables.specular)
        exponent = row_of(grow, tables.exponent, 0.0)
        eta = row_of(grow, eta_tab, 0.0)
        mk = row_of(grow, kind_tab, 0)
        is_matte = mk == kbsdf.MAT_MATTE
        is_mirror = mk == kbsdf.MAT_MIRROR
        is_glass = mk == kbsdf.MAT_GLASS
        is_plastic = mk == kbsdf.MAT_PLASTIC
        if has_plastic:
            u_lobe = rng.uniform()
            s_prob = row_of(grow, sprob_tab, 0.0)
            d_prob = row_of(grow, dprob_tab, 0.0)
            pick_spec = u_lobe < s_prob
            plastic_kind = where(
                pick_spec, torch.full_like(mk, kbsdf.PHONG), kbsdf.LAMBERT)
            inv_sp = km.div(1.0, torch.clamp_min(s_prob, 1e-12))
            inv_dp = km.div(1.0, torch.clamp_min(d_prob, 1e-12))
            plastic_col = (specular * inv_sp).where(pick_spec,
                                                    diffuse * inv_dp)
            lobe_is_phong = is_plastic & pick_spec
            lobe_scale = where(is_plastic,
                               torch.where(pick_spec, inv_sp, inv_dp),
                               1.0)
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
        nee_act = cont & ~(is_mirror | is_glass) if has_delta else cont

        s_f, t_f, n_f = make_frame(nrm)
        wo_l = to_local(s_f, t_f, n_f, wo)
        wr_w = nrm * (wo_l.z * 2.0) - wo \
            if kbsdf.PHONG in eval_lobes else None
        col_nee = specular.where(lobe_is_phong, diffuse) \
            if has_plastic else diffuse
        nee_base = nee_act & ~color.is_black()

        # NEE: every light, one occlusion sweep for all their shadow rays
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
        terms = []
        for i, lt in enumerate(lights):
            wi, pdf_l, li_s, _dist, _ = smps[i]
            cos_aw = wr_w.dot(wi) if wr_w is not None \
                else torch.zeros_like(o.x)
            pdf_b, f_unit_e = bsdf_eval_pdf_dots(
                kind, exponent, wo_l.z, nds[i], cos_aw, eval_lobes, None)
            ucos = f_unit_e * torch.abs(nds[i])
            if klights.is_delta_light(lt["kind"]):
                w = km.safe_div(1.0, pdf_l)
            else:
                w = km.safe_div(1.0, pdf_l + pdf_b)
            ok = nee_base & (pdf_l > 0.0) & (li_s != 0.0) & (ucos != 0.0)
            terms.append((ok, w, ucos, cos_aw))
        if replay:
            # the bounce's colour and exponent adjoints, all of its hit row
            zero = torch.zeros_like(o.x)
            addc_diff = addc_spec = V3(zero, zero, zero)
            addx = zero
        occs = _occluded(tables, hp, nrm,
                         [(smp[0], smp[3] - SHADOW_EPS) for smp in smps],
                         [ok for ok, *_ in terms], robust, own)
        ld = v3_full(o.x, 0.0, 0.0, 0.0)
        for i, (ok, w, ucos, cos_aw) in enumerate(terms):
            li_s = smps[i][2]
            emit_l = V3(tables.light_emit[i, 0], tables.light_emit[i, 1],
                        tables.light_emit[i, 2])
            okf = where(ok & ~occs[i], w, 0.0)
            bp = li_s * ucos * okf * lobe_scale
            ld = ld + col_nee * emit_l * bp
            if replay:
                acc_le[i] = acc_le[i] + gb * col_nee * bp
                addc = gb * emit_l * bp
                addc_spec = addc_spec + where3(lobe_is_phong, addc)
                addc_diff = addc_diff + where3(~lobe_is_phong, addc)
                if texp:
                    addx = addx + where(
                        lobe_is_phong,
                        addc.dot(col_nee) * kappa_dot(exponent, cos_aw),
                        0.0)
            if residual:
                planes[res_ix[("B", bounce, i)]] = bp
                if texp:
                    planes[res_ix[("Bk", bounce, i)]] = where(
                        lobe_is_phong, bp * kappa_dot(exponent, cos_aw),
                        0.0)
        big_l = big_l + beta * ld
        e_term = e_term + ld

        # extension sample
        u1, u2 = rng.uniform2()
        f_s, wi_l, pdf_s, delta_s, f_unit_s, refract = bsdf_sample(
            kind, color, diffuse, eta, exponent, wo_l, u1, u2, lobes, None)
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
        to_spec = is_mirror | (is_glass & ~refract) | lobe_is_phong
        if replay:
            # R_{b+1} = (R_b - E_b) / T_b per channel, 0 where the path ends
            t_eff = where3(alive_n, thr * scale)
            r_next = where3(alive_n, V3(*(km.safe_div(a - b, c) for a, b, c in (
                (r_tail.x, e_term.x, t_eff.x), (r_tail.y, e_term.y, t_eff.y),
                (r_tail.z, e_term.z, t_eff.z)))))
            t_unit = f_unit_s * km.safe_div(torch.abs(wi_l.z), pdf_s) * scale
            addt = gb * r_next * where(alive_n, t_unit * lobe_scale, 0.0)
            addc_spec = addc_spec + where3(to_spec, addt)
            addc_diff = addc_diff + where3(~to_spec, addt)
            if texp:
                addx = addx + where(
                    lobe_is_phong,
                    addt.dot(col_nee) * kappa(exponent, wo_l, wi_l), 0.0)
            if textured:
                # a textured row's diffuse adjoint goes to its texture
                addc_diff = V3(*route_textures(
                    tex_hits, st(addc_diff), acc_ta, acc_tb,
                    entries).unbind(1))
            dplanes.extend([addc_diff.x, addc_diff.y, addc_diff.z,
                            addc_spec.x, addc_spec.y, addc_spec.z,
                            de_b.x, de_b.y, de_b.z] + ([addx] if texp else []))
            r_tail = r_next
        if residual:
            t_unit = f_unit_s * km.safe_div(torch.abs(wi_l.z), pdf_s) * scale
            tu_plane = where(alive_n, t_unit * lobe_scale, 0.0)
            planes[res_ix[("tu", bounce)]] = tu_plane
            if texp:
                planes[res_ix[("tuk", bounce)]] = where(
                    lobe_is_phong, tu_plane * kappa(exponent, wo_l, wi_l),
                    0.0)
            for c, v in enumerate((diffuse.x, diffuse.y, diffuse.z)):
                planes[res_ix[("dif", bounce, c)]] = v
            for c, v in enumerate((specular.x, specular.y, specular.z)):
                planes[res_ix[("spc", bounce, c)]] = v
            packed = (where(valid, (grow + 1).to(torch.int32), 0)
                      + lobe_is_phong.to(torch.int32) * RESI_PHONG
                      + to_spec.to(torch.int32) * RESI_TO_SPEC)
            if has_img:
                tx = ty = torch.zeros_like(o.x)
            for rec, onrow, even, xy, _ in tex_hits if textured else ():
                if even is not None:   # the checker parity in bit 22
                    packed = packed + (onrow & even).to(torch.int32) \
                        * RESI_EVEN
                else:
                    tx = torch.where(onrow, xy[0], tx)
                    ty = torch.where(onrow, xy[1], ty)
            if has_img:
                planes[res_ix[("tx", bounce)]] = tx
                planes[res_ix[("ty", bounce)]] = ty
            ints[bounce] = packed.to(torch.int32)
        o = offset_origin(hp, nrm, wi_w).where(alive_n, o)
        d = wi_w.where(alive_n, d)
        beta = beta_new.where(alive_n, beta)
        if has_delta:
            spec_prev = torch.where(alive_n, delta_s, spec_prev)
        pdf_prev = torch.where(alive_n, pdf_s, pdf_prev)
        alive = alive_n

    if replay:
        acc = [acc_env.x, acc_env.y, acc_env.z]
        for v in acc_le:
            acc.extend([v.x, v.y, v.z])
        acc = torch.cat([torch.stack(acc, dim=-1), acc_ta.reshape(n, -1),
                         acc_tb.reshape(n, -1)], dim=1)
        return (torch.stack(dplanes), acc, torch.stack(tags)) + (
            (entries,) if has_img else ())
    out = torch.stack([big_l.x, big_l.y, big_l.z], dim=-1)
    if not residual:
        return out
    return out, torch.stack(planes), torch.stack(ints)


# ---------------------------------------------------------------------------
# plain version: the cache backward (K7) and the sums by row
# ---------------------------------------------------------------------------

_per_bounce = kwf.per_bounce


def bwd_lanes_plain(tables: BigTables, cfg: kwf.KernelConfig, g, big_l,
                    resf, resi):
    """K7's per-lane cache algebra (kytpu's `_make_res_bwd_kernel`) ->
    (dout (PB*max_depth + 3, N) float32, acc (N, 3 + 3L + 6T) float32[,
    the texel entries of an image scene]): per bounce below the horizon the
    row-tagged adjoint planes dd, ds, de [, dexp] of the lane's hit, then
    the horizon's de; acc holds each lane's env, per-light emission and
    checker adjoints. Walks the bounces forward carrying the throughput and
    the tail radiance R_{b+1} = (R_b - E_b) / T_b; every term is bilinear
    in a cached coefficient, a cached colour and a light emission. A
    textured row's diffuse adjoint goes to its texture, by the parity bit
    or the taps of the "tx"/"ty" planes, and its row-tagged share is 0."""
    static = tables.static
    L = len(static["lights"])
    res_ix, res_n = layout_of(static, cfg)
    has_env = ("wenv", 0) in res_ix
    B = cfg.max_depth
    if resf.shape[0] != res_n or resi.shape[0] != B + 1:
        raise ValueError(f"cache of {resf.shape[0]} float and {resi.shape[0]}"
                         f" int planes; this scene and config take {res_n} "
                         f"and {B + 1}")
    texp = cfg.trainable_exponent

    def rf(tag):
        return resf[res_ix[tag]]

    def rf3(tag, b):
        return V3(*(rf((tag, b, c)) for c in range(3)))

    g = V3(g[:, 0], g[:, 1], g[:, 2])
    r_tail = V3(big_l[:, 0], big_l[:, 1], big_l[:, 2])
    beta = v3_full(g.x, 1.0, 1.0, 1.0)
    zero = torch.zeros_like(g.x)
    acc_env = V3(zero, zero, zero)
    acc_le = [V3(zero, zero, zero) for _ in range(L)]
    env = tables.env
    dplanes = []
    textured, has_img = bool(static["textures"]), ktab.has_img(static)
    n = g.x.shape[0]
    T = ktab.n_tex(static)
    acc_ta, acc_tb = g.x.new_zeros((n, T, 3)), g.x.new_zeros((n, T, 3))
    entries = [] if has_img else None
    for b in range(B + 1):
        wb = rf(("wb", b))
        emi = rf3("emi", b)
        gb = g * beta
        de_b = gb * wb
        e_term = emi * wb
        if has_env:
            wenv = rf(("wenv", b))
            e_term = e_term + V3(env[0], env[1], env[2]) * wenv
            acc_env = acc_env + gb * wenv
        if b == B:
            dplanes.extend([de_b.x, de_b.y, de_b.z])
            break
        ib = resi[b]
        phong = (ib & RESI_PHONG) != 0
        spec_t = (ib & RESI_TO_SPEC) != 0
        dif, spc = rf3("dif", b), rf3("spc", b)
        col_nee = spc.where(phong, dif)
        addc_diff = V3(zero, zero, zero)
        addc_spec = V3(zero, zero, zero)
        addx = zero
        for i in range(L):
            bp = rf(("B", b, i))
            emit_l = V3(tables.light_emit[i, 0], tables.light_emit[i, 1],
                        tables.light_emit[i, 2])
            e_term = e_term + col_nee * emit_l * bp
            acc_le[i] = acc_le[i] + gb * col_nee * bp
            addc = gb * emit_l * bp
            addc_spec = addc_spec + V3(*(where(phong, c, 0.0) for c in (
                addc.x, addc.y, addc.z)))
            addc_diff = addc_diff + V3(*(where(phong, 0.0, c) for c in (
                addc.x, addc.y, addc.z)))
            if texp:
                addx = addx + (gb.x * emit_l.x * col_nee.x
                               + gb.y * emit_l.y * col_nee.y
                               + gb.z * emit_l.z * col_nee.z) * rf(("Bk", b, i))
        # extension: T_b = ext colour * tu; peel the tail radiance
        tu = rf(("tu", b))
        t_eff = spc.where(spec_t, dif) * tu
        r_next = V3(km.safe_div(r_tail.x - e_term.x, t_eff.x),
                    km.safe_div(r_tail.y - e_term.y, t_eff.y),
                    km.safe_div(r_tail.z - e_term.z, t_eff.z))
        addt = gb * r_next * tu
        addc_spec = addc_spec + V3(*(where(spec_t, c, 0.0) for c in (
            addt.x, addt.y, addt.z)))
        addc_diff = addc_diff + V3(*(where(spec_t, 0.0, c) for c in (
            addt.x, addt.y, addt.z)))
        if texp:
            # tuk is 0 off phong lanes, whose extension read the specular
            addx = addx + (gb.x * r_next.x * spc.x + gb.y * r_next.y * spc.y
                           + gb.z * r_next.z * spc.z) * rf(("tuk", b))
        if textured:
            # the textured row's diffuse adjoint goes to its texture
            row1 = ib & RESI_ROW_MASK
            even = (ib & RESI_EVEN) != 0
            hits = []
            for rec in static["textures"]:
                onrow = row1 == rec["row"] + 1
                if rec["kind"] == "image":
                    hits.append((rec, onrow, None, None, image_taps(
                        rec, rf(("tx", b)), rf(("ty", b)))))
                else:
                    hits.append((rec, onrow, even, None, None))
            addc_diff = V3(*route_textures(
                hits, st(addc_diff), acc_ta, acc_tb, entries).unbind(1))
        dplanes.extend([addc_diff.x, addc_diff.y, addc_diff.z,
                        addc_spec.x, addc_spec.y, addc_spec.z,
                        de_b.x, de_b.y, de_b.z] + ([addx] if texp else []))
        beta = beta * t_eff
        r_tail = r_next
    acc = [acc_env.x, acc_env.y, acc_env.z]
    for v in acc_le:
        acc.extend([v.x, v.y, v.z])
    acc = torch.cat([torch.stack(acc, dim=-1), acc_ta.reshape(n, -1),
                     acc_tb.reshape(n, -1)], dim=1)
    return (torch.stack(dplanes), acc) + ((entries,) if has_img else ())


def sort_rows(resi: torch.Tensor, m_rows: int):
    """`sort_tags` of the row tags in bits 0-19 of resi (K6's int cache,
    or K8's tag planes): row m's entries are perm[starts[m]:starts[m + 1]],
    row 0 being the misses and dead lanes."""
    return kts.sort_tags(resi, m_rows, RESI_ROW_MASK)


def _assemble(tables: BigTables, cfg: kwf.KernelConfig, seg, lane_sums):
    """(M, PB) row sums and the (3 + 3L + 6T,) env / light-emission /
    checker lane sums -> (dd, ds, de, denv[, dexp][, dta, dtb])
    (`kwf.tagged_grads`): each light's NEE emission adjoint goes to the row
    of the surface bound to it, or to env for the environment light
    (kytpu's `_bwd`); point and directional lights get none."""
    static = tables.static
    rows = {i: r for i, r in enumerate(static.get("light_surface_rows", ()))
            if r >= 0}
    return kwf.tagged_grads(static, cfg, seg, lane_sums, rows)


def bwd_res_plain(tables: BigTables, cfg: kwf.KernelConfig, g, big_l, resf,
                  resi):
    """Plain K7 with the sums that follow it: upstream gradient g and
    radiance big_l (N, 3), K6's cache -> (dd, ds, de, denv[, dexp][, dta,
    dtb][, dti]) of shapes (M, 3) x 3, (3,) [, (M,) under
    cfg.trainable_exponent][, (T, 3) x 2 on a textured scene][, the atlas
    gradient on an image scene].

    Every row gets the linear coefficient of its terms (kytpu's big-scene
    semantics: a non-emitting row's emission gradient is not zeroed, as K3
    does). The row-tagged planes are summed by row in a fixed order
    (`sort_rows`, `segment_sums_plain`), the texel entries by texel, and
    the env, light-emission and checker adjoints over lanes in K7's order
    (`kwf.sum_lanes`), so the gradient repeats bit for bit and equals the
    kernel's."""
    kwf.check_config(cfg)
    dout, acc, *entries = bwd_lanes_plain(tables, cfg, g, big_l, resf, resi)
    return sums_plain(tables, cfg, dout, acc, resi, *entries)


def sums_plain(tables: BigTables, cfg: kwf.KernelConfig, dout, acc, tags,
               entries=None):
    """The sums that finish K7 and K8, plain: the row-tagged planes dout
    summed by the rows `tags` hold (`sort_rows`, `segment_sums_plain`), the
    (N, 3 + 3L + 6T) lane accumulators over lanes in K7's order
    (`kwf.sum_lanes`) -> (dd, ds, de, denv[, dexp][, dta, dtb])
    (`_assemble`), and the texel entries of an image scene summed by texel
    (`kwf.texel_sums_plain`) -> [, dti]."""
    M = len(tables.static["mats"]["kind"])
    perm, starts = sort_rows(tags, M)
    seg = kts.segment_sums_plain(dout, perm, starts, dout.shape[1],
                                 cfg.max_depth, _per_bounce(cfg))
    grads = _assemble(tables, cfg, seg, kwf.sum_lanes(acc))
    if entries is None:
        return grads
    return grads + (kwf.texel_sums_plain(tables.static, entries,
                                         dout.shape[1]),)


# ---------------------------------------------------------------------------
# the wrappers: CUDA tensors launch csrc/bigscene_fwd.cu,
# csrc/bigscene_bwd_res.cu and csrc/tag_sums.cu, CPU tensors run the plain
# versions
# ---------------------------------------------------------------------------

_TABLES = ("f", "i", "geo", "rows", "mat_i", "mat_f", "diffuse", "specular",
           "emission", "exponent", "light_emit", "env", "texa", "texb", "timg",
           "tex_rec", "bnd", "rank")


def _check_tables(tables: BigTables, dev):
    check_tables(tables, dev, _TABLES, ("i", "rows", "mat_i", "tex_rec",
                                        "rank"))


def _n_cols(tables: BigTables) -> int:
    """K7's and K8's lane-summed columns: env | the lights' emission | dta |
    dtb."""
    static = tables.static
    return 3 + 3 * len(static["lights"]) + 6 * ktab.n_tex(static)


def _wide(tables: BigTables, k: int, nb: int, dev):
    """K7's and K8's rows in device memory, (nb, k, 128) float32, where
    their k columns pass the kernels' local row (`kwf.local_row_cols`: past
    32 lights or 64 textures), else None."""
    if k <= kwf.local_row_cols(bool(tables.static["textures"])):
        return None
    return torch.empty((nb, k, kwf.BWD_THREADS), dtype=torch.float32,
                       device=dev)


def _textured(tables: BigTables) -> int:
    return int(bool(tables.static["textures"]))


def _cull_args(tables: BigTables, cfg: kwf.KernelConfig) -> list:
    """K5's, K6's and K8's last arguments: whether to cull, and the shadow
    rays a chunk of the light loop holds."""
    return [int(cfg.cull != "off"),
            min(len(tables.static["lights"]), kwf.NEE_CHUNK)]


def _launch(tables: BigTables, cfg: kwf.KernelConfig, o, d, seed, si, pix,
            residual: bool = False):
    """K5 (or K6 with residual=True) on CUDA lanes -> radiance (or
    (radiance, resf, resi)); raises if the kernel cannot be built or
    launched."""
    from kytpu_torch.kernels import build

    kwf.check_config(cfg)
    o, d, si, pix = lanes_checked(o, d, si, pix, cfg)
    _check_tables(tables, o.device)
    n, dev = o.shape[0], o.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    resf = resi = None
    if residual:
        _, res_n = layout_of(tables.static, cfg)
        # every plane of every lane is written by K6 (torch.empty, not zeros)
        resf = torch.empty((res_n, n), dtype=torch.float32, device=dev)
        resi = torch.empty((cfg.max_depth + 1, n), dtype=torch.int32,
                           device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    run(build.load().kytpu_bigscene_fwd, "bigscene_fwd",
        "k6" if residual else "k5", dev,
        *[getattr(tables, nm).data_ptr() for nm in _TABLES],
        o.data_ptr(), d.data_ptr(), ptr(si), ptr(pix), out.data_ptr(),
        ptr(resf), ptr(resi), n, *tables.counts,
        len(tables.static["mats"]["kind"]), *cfg_args(cfg, seed),
        int(cfg.trainable_exponent), int(residual), _textured(tables),
        *_cull_args(tables, cfg),
        ptr(kprof.row_counter("k6" if residual else "k5", dev)))
    return (out, resf, resi) if residual else out


def _launch_bwd(tables: BigTables, cfg: kwf.KernelConfig, g, big_l, resf,
                resi):
    """K7 on CUDA lanes: the per-lane kernel, the stable int32 sort of the
    row tags and the segment sums by row (and by texel) of
    csrc/tag_sums.cu, and the lane sums -> (dd, ds, de, denv[, dexp][, dta,
    dtb][, dti]); raises if a kernel cannot be built or launched."""
    from kytpu_torch.kernels import build

    dev = g.device
    n = g.shape[0]
    static = tables.static
    L = len(static["lights"])
    res_ix, res_n = layout_of(static, cfg)
    has_env = ("wenv", 0) in res_ix
    B, PB = cfg.max_depth, _per_bounce(cfg)
    for name, t, shape, dt in (
            ("g", g, (n, 3), torch.float32),
            ("L", big_l, (n, 3), torch.float32),
            ("resf", resf, (res_n, n), torch.float32),
            ("resi", resi, (B + 1, n), torch.int32)):
        check_lane_tensor(name, t, shape, dt, dev)
    _check_tables(tables, dev)
    g, big_l = g.contiguous(), big_l.contiguous()
    resf, resi = resf.contiguous(), resi.contiguous()
    lib = build.load()
    k = _n_cols(tables)
    nb = max(1, -(-n // kwf.BWD_THREADS))
    dout = torch.empty((PB * B + 3, n), dtype=torch.float32, device=dev)
    partial = torch.empty((nb, k), dtype=torch.float32, device=dev)
    lane_sums = torch.empty((k,), dtype=torch.float32, device=dev)
    tex = texel_outputs(tables, cfg, n, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    run(lib.kytpu_bigscene_bwd_res, "bigscene_bwd_res", "k7", dev,
        tables.i.data_ptr(), tables.tex_rec.data_ptr(),
        tables.light_emit.data_ptr(), tables.env.data_ptr(),
        g.data_ptr(), big_l.data_ptr(), resf.data_ptr(),
        resi.data_ptr(), dout.data_ptr(), partial.data_ptr(),
        lane_sums.data_ptr(), *map(ptr, tex), n, L, int(has_env), B,
        int(cfg.trainable_exponent), k, _textured(tables),
        ptr(_wide(tables, k, nb, dev)))
    return _sums(tables, cfg, dout, resi, lane_sums, tex)


def _sums(tables: BigTables, cfg: kwf.KernelConfig, dout, tags, lane_sums,
          tex):
    """K7's and K8's sums on the card: the row tags (bits 0-19 of the int
    planes) sorted and the row-tagged planes summed by row
    (`segment_sums`: csrc/tag_sums.cu's kernels) -> (dd, ds, de,
    denv[, dexp][, dta, dtb]) with the lane sums (`_assemble`), and the
    texel entries tex (planes, tags) summed by texel on an image scene [,
    dti]."""
    static = tables.static
    M = len(static["mats"]["kind"])
    grads = _assemble(tables, cfg, kts.segment_sums(
        dout, tags, M, cfg.max_depth, _per_bounce(cfg), RESI_ROW_MASK),
        lane_sums)
    if tex[1] is None:
        return grads
    seg = kts.segment_sums(*tex, static["n_texels"], tex[1].shape[0], 3)
    return grads + (seg.reshape(texel_shape(static)),)


def _launch_replay(tables: BigTables, cfg: kwf.KernelConfig, o, d, seed, si,
                   pix, g, big_l):
    """K8 on CUDA lanes: the replay kernel (row-tagged adjoint planes, row
    tags, texel entries on an image scene, the lane sums of the env,
    light-emission and checker adjoints), then the sums by row (and texel)
    -> (dd, ds, de, denv[, dexp][, dta, dtb][, dti]); raises if a kernel
    cannot be built or launched."""
    from kytpu_torch.kernels import build

    kwf.check_config(cfg)
    o, d, si, pix = lanes_checked(o, d, si, pix, cfg)
    n, dev = o.shape[0], o.device
    check_lane_tensor("g", g, (n, 3), torch.float32, dev)
    check_lane_tensor("L", big_l, (n, 3), torch.float32, dev)
    _check_tables(tables, dev)
    g, big_l = g.contiguous(), big_l.contiguous()
    lib = build.load()
    B, PB = cfg.max_depth, _per_bounce(cfg)
    k = _n_cols(tables)
    nb = max(1, -(-n // kwf.BWD_THREADS))
    # every plane and tag of every lane is written by K8
    dout = torch.empty((PB * B + 3, n), dtype=torch.float32, device=dev)
    tags = torch.empty((B + 1, n), dtype=torch.int32, device=dev)
    partial = torch.empty((nb, k), dtype=torch.float32, device=dev)
    lane_sums = torch.empty((k,), dtype=torch.float32, device=dev)
    tex = texel_outputs(tables, cfg, n, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    run(lib.kytpu_bigscene_bwd_replay, "bigscene_bwd_replay", "k8",
        dev, *[getattr(tables, nm).data_ptr() for nm in _TABLES],
        o.data_ptr(), d.data_ptr(), ptr(si), ptr(pix), g.data_ptr(),
        big_l.data_ptr(), dout.data_ptr(), tags.data_ptr(),
        partial.data_ptr(), lane_sums.data_ptr(), *map(ptr, tex), n, k,
        *tables.counts, len(tables.static["mats"]["kind"]),
        *cfg_args(cfg, seed), int(cfg.trainable_exponent),
        _textured(tables), *_cull_args(tables, cfg),
        ptr(_wide(tables, k, nb, dev)),
        ptr(kprof.row_counter("k8", dev)))
    return _sums(tables, cfg, dout, tags, lane_sums, tex)


def trace_lanes(tables: BigTables, cfg: kwf.KernelConfig, o, d, seed: int,
                si=None, pix=None, residual: bool = False):
    """K5 (K6 with residual=True; see `trace_lanes_plain` for what it
    returns): CUDA lanes launch the kernel or raise, CPU lanes run the
    plain version."""
    with kprof.kernel("k6" if residual else "k5"):
        if on_card(o.device):
            return _launch(tables, cfg, o, d, seed, si, pix, residual)
        return trace_lanes_plain(tables, cfg, o, d, seed, si, pix, residual)


def bwd_res(tables: BigTables, cfg: kwf.KernelConfig, g, big_l, resf, resi):
    """K7 -> (dd, ds, de, denv[, dexp]): CUDA lanes launch the kernels or
    raise, CPU lanes run `bwd_res_plain`."""
    with kprof.kernel("k7"):
        if on_card(g.device):
            return _launch_bwd(tables, cfg, g, big_l, resf, resi)
        return bwd_res_plain(tables, cfg, g, big_l, resf, resi)


def bwd_replay(tables: BigTables, cfg: kwf.KernelConfig, o, d, seed: int, si,
               pix, g, big_l):
    """K8 -> (dd, ds, de, denv[, dexp]) on the lanes (o, d, seed, si, pix)
    that the forward traced, its radiance big_l and the upstream gradient g,
    with K7's conventions: CUDA lanes launch the kernels or raise, CPU lanes
    run `bwd_replay_plain` and `sums_plain`."""
    with kprof.kernel("k8"):
        if on_card(o.device):
            return _launch_replay(tables, cfg, o, d, seed, si, pix, g,
                                  big_l)
        return sums_plain(tables, cfg, *bwd_replay_plain(
            tables, cfg, o, d, seed, si, pix, g, big_l))


def make_bigscene_tracer(scene: kscene.Scene,
                         cfg: kwf.KernelConfig | None = None,
                         extracted=None):
    """Lane tracer over `scene`'s class tables (kytpu's
    make_bigscene_tracer). Returns fn(scene, o, d, seed, si=None, pix=None)
    -> (N, 3) radiance; the colour, exponent and texture tables are read
    from the `scene` given at each call. CUDA tensors launch K5 (and raise
    if it cannot be built or launched); CPU tensors run
    `trace_lanes_plain`. extracted: `extract_tables(scene)` where the caller
    has it."""
    cfg = cfg or kwf.KernelConfig()
    kwf.check_config(cfg)
    geo = pack_big_tables(scene, cfg, extracted)

    def trace(scene, o, d, seed, si=None, pix=None):
        return trace_lanes(geo.with_colors(scene), cfg, o, d, seed, si, pix)

    return trace


class _BigDiffTables(kad.DiffTables):
    """The diff tracer's tables for the big-scene kernels: K5 or K6
    forward, K7 or K8 backward (looked up in this module at each call)."""

    def __init__(self, scene, cfg, extracted=None):
        self.extracted = extracted
        super().__init__(scene, cfg)

    def pack(self, scene, cfg):
        return pack_big_tables(scene, cfg, self.extracted)

    def trace(self, tables, o, d, seed, si, pix, residual=False):
        return trace_lanes(tables, self.cfg, o, d, seed, si, pix,
                           residual=residual)

    def bwd_res(self, tables, g, big_l, resf, resi):
        return bwd_res(tables, self.cfg, g, big_l, resf, resi)

    def bwd_replay(self, tables, o, d, seed, si, pix, g, big_l):
        return bwd_replay(tables, self.cfg, o, d, seed, si, pix, g, big_l)


def make_bigscene_diff_tracer(scene: kscene.Scene,
                              cfg: kwf.KernelConfig | None = None,
                              backward: str = "residual", extracted=None):
    """Differentiable big-scene tracer (kytpu's make_bigscene_diff_tracer).

    Returns fn(diffuse, specular, emission, [exponent,] [texa, texb,]
    [timg,] env, o, d, seed[, si, pix]) -> (N, 3) radiance (kytpu's
    argument order: the exponent iff cfg.trainable_exponent, the checker
    colours iff the scene has texture records, the atlas iff it has image
    textures), a torch.autograd.Function: when a table needs a gradient the
    forward runs K6 and keeps its cache, the backward runs K7 (`bwd_res`);
    otherwise the forward runs K5. backward="replay": the forward runs K5
    and keeps the lanes and radiance, the backward K8 (`bwd_replay`)
    re-traces them (no cache). The gradient is (d_diffuse, d_specular,
    d_emission, [d_exponent,] [d_texa, d_texb,] [d_timg,] d_env) by
    detached sampling, with kytpu's big-scene conventions (`bwd_res_plain`)
    under either backward; a textured row's diffuse gradient is 0, its
    adjoint going to the texture. extracted: `extract_tables(scene)` where
    the caller has it."""
    cfg = cfg or kwf.KernelConfig()
    fn = kad.function_of(backward)
    kwf.check_config(cfg)
    return kad.diff_tracer(_BigDiffTables(scene, cfg, extracted), fn)


def render_bigscene(scene: kscene.Scene, spp: int = 16, seed: int = 1234,
                    cfg: kwf.KernelConfig | None = None, clamp: bool = True,
                    rays_per_pass: int = 1 << 22,
                    extracted=None) -> torch.Tensor:
    """Full-frame render through K5 -> (H, W, 3) on the scene's device
    (kytpu's render_bigscene: `render_cuda` with the big-scene tracer, the
    same passes and defaults)."""
    cfg = cfg or kwf.KernelConfig()
    return kwf.render_cuda(scene, spp=spp, seed=seed, cfg=cfg, clamp=clamp,
                           rays_per_pass=rays_per_pass,
                           tracer=make_bigscene_tracer(scene, cfg, extracted))
