# Frozen copy of kytpu_torch/scene/shapes.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Structure-of-arrays scene geometry and batched ray intersection
(kytpu/scene/shapes.py).

Two SoA blocks: planar surfaces (triangle / rectangle / disk) in rows
[0, P) and spheres in rows [P, P+S). The builder runs on the host in
numpy, exactly as the JAX package's does, so both packages bake the same
float32 tables. Every ray tests every row in one elementwise sweep and the
closest hit is an argmin over the rows (the jnp engines' intersection; the
kernels carry their own sweeps).

Parity constants: a minimum hit distance of 1e-3 (ky.cpp:1093);
rectangle normals flip towards the ray at a hit (ky.cpp:1289), triangles,
disks and spheres do not; a sphere hit takes the near root, else the far
one (ky.cpp:1375-1382).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.reference.frozen.core import frame as kframe
from perfbench.reference.frozen.core import math as km

# planar sub-kinds
TRI = 0
RECT = 1
DISK = 2


@dataclass(frozen=True)
class Geometry:
    pl_kind: torch.Tensor    # (P,) int32 in {TRI, RECT, DISK}
    pl_p0: torch.Tensor      # (P, 3); triangles store p3 == p0
    pl_p1: torch.Tensor
    pl_p2: torch.Tensor
    pl_p3: torch.Tensor
    pl_normal: torch.Tensor  # (P, 3) unit, canonical orientation
    pl_radius: torch.Tensor  # (P,) disk radius (0 otherwise)
    pl_area: torch.Tensor    # (P,)
    sp_center: torch.Tensor  # (S, 3)
    sp_radius: torch.Tensor  # (S,)
    sp_area: torch.Tensor    # (S,)

    @property
    def n_planar(self) -> int:
        return self.pl_p0.shape[0]

    @property
    def n_sphere(self) -> int:
        return self.sp_center.shape[0]

    @property
    def n_surfaces(self) -> int:
        return self.n_planar + self.n_sphere

    def to(self, device) -> "Geometry":
        return Geometry(**{f.name: getattr(self, f.name).to(device)
                           for f in fields(self)})


class GeometryBuilder:
    """Accumulates shapes on the host; `build()` freezes them into SoA
    tensors and returns the global surface row of each added shape."""

    def __init__(self):
        self._planar = []   # (kind, p0, p1, p2, p3, normal, radius, area)
        self._spheres = []  # (center, radius)
        self._handles = []  # ("pl"|"sp", local_index) in insertion order

    def add_triangle(self, p0, p1, p2, flip_normal=False) -> int:
        p0, p1, p2 = map(np.asarray, (p0, p1, p2))
        n = np.cross(p1 - p0, p2 - p0)
        area = 0.5 * np.linalg.norm(n)
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        self._planar.append((TRI, p0, p1, p2, p0.copy(), n, 0.0, area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_rectangle(self, p0, p1, p2, p3, flip_normal=False) -> int:
        p0, p1, p2, p3 = map(np.asarray, (p0, p1, p2, p3))
        n = np.cross(p1 - p0, p2 - p0)
        n = n / np.linalg.norm(n)
        if flip_normal:
            n = -n
        area = float(np.linalg.norm(np.cross(p0 - p1, p2 - p1)))
        self._planar.append((RECT, p0, p1, p2, p3, n, 0.0, area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_disk(self, position, normal, radius) -> int:
        position = np.asarray(position)
        normal = np.asarray(normal, dtype=np.float64)
        normal = normal / np.linalg.norm(normal)
        area = float(np.pi * radius * radius)
        self._planar.append(
            (DISK, position, position.copy(), position.copy(),
             position.copy(), normal, float(radius), area))
        self._handles.append(("pl", len(self._planar) - 1))
        return len(self._handles) - 1

    def add_sphere(self, center, radius) -> int:
        self._spheres.append((np.asarray(center), float(radius)))
        self._handles.append(("sp", len(self._spheres) - 1))
        return len(self._handles) - 1

    def build(self) -> tuple[Geometry, list[int]]:
        P = len(self._planar)
        f32 = np.float32

        def stack3(idx):
            if P == 0:
                return np.zeros((0, 3), f32)
            return np.stack([np.asarray(sh[idx], f32) for sh in self._planar])

        t = torch.from_numpy
        geom = Geometry(
            pl_kind=t(np.array([sh[0] for sh in self._planar], np.int32)),
            pl_p0=t(stack3(1)), pl_p1=t(stack3(2)), pl_p2=t(stack3(3)),
            pl_p3=t(stack3(4)), pl_normal=t(stack3(5)),
            pl_radius=t(np.array([sh[6] for sh in self._planar], f32)),
            pl_area=t(np.array([sh[7] for sh in self._planar], f32)),
            sp_center=t(np.stack([c for c, _ in self._spheres]).astype(f32)
                        if self._spheres else np.zeros((0, 3), f32)),
            sp_radius=t(np.array([r for _, r in self._spheres], f32)),
            sp_area=t(np.array([4.0 * np.pi * r * r
                                for _, r in self._spheres], f32)),
        )
        ids = [local if block == "pl" else P + local
               for block, local in self._handles]
        return geom, ids

    def world_bound(self):
        """Host-side AABB over all shapes (ky.cpp:3209-3219)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for kind, p0, p1, p2, p3, n, radius, _ in self._planar:
            if kind == DISK:
                s, t = _onb_np(n)
                off = np.abs(s) * radius + np.abs(t) * radius
                lo = np.minimum(lo, p0 - off)
                hi = np.maximum(hi, p0 + off)
            else:
                for p in [p0, p1, p2] + ([p3] if kind == RECT else []):
                    lo = np.minimum(lo, p)
                    hi = np.maximum(hi, p)
        for c, r in self._spheres:
            lo = np.minimum(lo, c - r)
            hi = np.maximum(hi, c + r)
        return lo, hi

    def bounding_sphere(self):
        """(center, radius) of the world bound (ky.cpp:506-512)."""
        lo, hi = self.world_bound()
        center = 0.5 * (lo + hi)
        return center, float(np.linalg.norm(hi - center))


def _onb_np(n):
    helper = (np.array([0.0, 1.0, 0.0]) if abs(n[0]) > 0.99
              else np.array([1.0, 0.0, 0.0]))
    t = np.cross(n, helper)
    t = t / np.linalg.norm(t)
    s = np.cross(t, n)
    s = s / np.linalg.norm(s)
    return s, t


# ---------------------------------------------------------------------------
# batched intersection sweeps (the jnp engines'; the kernels sweep in
# kernels/wavefront.py and kernels/bigscene.py)
# ---------------------------------------------------------------------------


def planar_test(oN, dN, tmaxN, kind, p0, p1, p2, p3, normal, radius):
    """Planar hit test over broadcastable tables: oN, dN (N, 1, 3), tmaxN
    (N, 1), shape tables (1, P, ...) -> (t, accept), each (N, P).

    The SmallVCM sign-of-cross-products inside test for triangles and
    rectangles (ky.cpp:1183-1212, 1261-1296): the ray is inside iff the
    edge-plane dot products share a sign. Triangles store p3 == p0, which
    makes the fourth edge test exactly 0; the kind mask ignores it in the
    all-negative case."""
    oa = p0 - oN
    ob = p1 - oN
    oc = p2 - oN
    od = p3 - oN
    v0d = km.dot(km.cross(oc, ob), dN)
    v1d = km.dot(km.cross(ob, oa), dN)
    v2d = km.dot(km.cross(oa, od), dN)
    v3d = km.dot(km.cross(od, oc), dN)
    is_tri = kind == TRI
    all_neg = (v0d < 0) & (v1d < 0) & (v3d < 0) & ((v2d < 0) | is_tri)
    all_pos = (v0d >= 0) & (v1d >= 0) & (v2d >= 0) & (v3d >= 0)
    t = km.safe_div(km.dot(normal, oa), km.dot(normal, dN), km.INF)
    in_disk = km.distance(oN + t[..., None] * dN, p0) <= radius
    inside = torch.where(kind == DISK, in_disk, all_neg | all_pos)
    return t, inside & (t > km.SHAPE_EPSILON) & (t < tmaxN)


def sphere_test(oN, dN, tmaxN, center, radius):
    """Sphere hit test over broadcastable tables (see planar_test): the
    reference's roots (ky.cpp:1336-1392) computed stably in float32, the
    discriminant from the perpendicular distance r^2 - |oc - (oc.d)d|^2 and
    the two roots by Vieta (t_a t_b = |oc|^2 - r^2), so that smallpt's
    1e5-radius walls do not cancel."""
    oc = center - oN
    neg_b = km.dot(oc, dN)
    perp = oc - neg_b[..., None] * dN
    discr = radius ** 2 - km.length_squared(perp)
    sq = km.safe_sqrt(discr)
    c = km.length_squared(oc) - radius ** 2
    q = neg_b + torch.where(neg_b >= 0.0, 1.0, -1.0) * sq
    tq = km.safe_div(c, q)
    t1 = torch.minimum(q, tq)
    t2 = torch.maximum(q, tq)
    t1_ok = (t1 > km.SHAPE_EPSILON) & (t1 < tmaxN)
    t2_ok = (t2 > km.SHAPE_EPSILON) & (t2 < tmaxN)
    return torch.where(t1_ok, t1, t2), (discr >= 0) & (t1_ok | t2_ok)


def intersect_planar(geom, o, d, tmax):
    """t and acceptance of every (ray, planar row) pair: (N, P) each."""
    return planar_test(o[:, None, :], d[:, None, :], tmax[:, None],
                       geom.pl_kind[None], geom.pl_p0[None],
                       geom.pl_p1[None], geom.pl_p2[None], geom.pl_p3[None],
                       geom.pl_normal[None], geom.pl_radius[None])


def intersect_sphere(geom, o, d, tmax):
    """The near-then-far root sphere test: (N, S) each."""
    return sphere_test(o[:, None, :], d[:, None, :], tmax[:, None],
                       geom.sp_center[None], geom.sp_radius[None])


# Past this many surfaces in all, the sweeps run over chunks of _SWEEP_CHUNK
# rows (kytpu's lax.scan): peak memory O(N x chunk) instead of O(N x rows).
_SWEEP_CHUNK = 128


_PLANAR = ("pl_kind", "pl_p0", "pl_p1", "pl_p2", "pl_p3", "pl_normal",
           "pl_radius")
_SPHERE = ("sp_center", "sp_radius")


def _chunks(geom):
    """(first global row, a view of the chunk's rows, its sweep) of each
    chunk, planar first. kytpu pads the last chunk of a block with rows
    that never accept a ray; the port sweeps the real rows alone, with the
    same result."""
    out = []
    for names, n, base, sweep in ((_PLANAR, geom.n_planar, 0,
                                   intersect_planar),
                                  (_SPHERE, geom.n_sphere, geom.n_planar,
                                   intersect_sphere)):
        for lo in range(0, n, _SWEEP_CHUNK):
            view = SimpleNamespace(**{nm: getattr(geom, nm)[lo:lo
                                                            + _SWEEP_CHUNK]
                                      for nm in names})
            out.append((base + lo, view, sweep))
    return out


def _chunked(geom) -> bool:
    return geom.n_planar + geom.n_sphere > 2 * _SWEEP_CHUNK


def closest_hit(geom, o, d, tmax):
    """The closest hit over both blocks -> (t, surface row, valid): (N,),
    (N,) int32, (N,) bool. Ties go to the first row (argmin), and across
    chunks to the earlier chunk (a strict t < t_best)."""
    n = o.shape[0]
    if _chunked(geom):
        t_best = torch.full((n,), km.INF, dtype=o.dtype, device=o.device)
        sid = torch.zeros((n,), dtype=torch.int32, device=o.device)
        for base, rows, sweep in _chunks(geom):
            t, acc = sweep(rows, o, d, tmax)
            tm = torch.where(acc, t, km.INF)
            tc, i = torch.min(tm, dim=1)
            better = tc < t_best
            t_best = torch.where(better, tc, t_best)
            sid = torch.where(better, (base + i).to(torch.int32), sid)
        return t_best, sid, torch.isfinite(t_best)
    ts, accs = [], []
    if geom.n_planar:
        ts_, acc_ = intersect_planar(geom, o, d, tmax)
        ts.append(ts_)
        accs.append(acc_)
    if geom.n_sphere:
        ts_, acc_ = intersect_sphere(geom, o, d, tmax)
        ts.append(ts_)
        accs.append(acc_)
    tm = torch.where(torch.cat(accs, 1), torch.cat(ts, 1), km.INF)
    t_best, sid = torch.min(tm, dim=1)
    return t_best, sid.to(torch.int32), torch.isfinite(t_best)


def any_hit(geom, o, d, tmax, skip_row=None):
    """Occlusion: does any surface hit in (eps, tmax)? -> (N,) bool.

    skip_row: a global surface row (python int) or (N,) int rows, one a
    lane, to leave out (-1 leaves out nothing): the robust shadow mode
    excludes a light's own emitting surface from its shadow rays."""
    n = o.shape[0]
    if skip_row is not None:
        skip_row = torch.as_tensor(skip_row, dtype=torch.int32,
                                   device=o.device).expand(n)
    hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    if _chunked(geom):
        blocks = [(base, sweep(rows, o, d, tmax)[1])
                  for base, rows, sweep in _chunks(geom)]
    else:
        blocks = []
        if geom.n_planar:
            blocks.append((0, intersect_planar(geom, o, d, tmax)[1]))
        if geom.n_sphere:
            blocks.append((geom.n_planar,
                           intersect_sphere(geom, o, d, tmax)[1]))
    for base, acc in blocks:
        if skip_row is not None:
            rows = base + torch.arange(acc.shape[1], dtype=torch.int32,
                                       device=o.device)
            acc = acc & (rows[None, :] != skip_row[:, None])
        hit = hit | acc.any(dim=1)
    return hit


def surface_normal(geom, sid, position, d):
    """The normal at each hit, with the reference's orientation rules:
    rectangles flip towards the ray (ky.cpp:1289), triangles and disks keep
    their canonical normal, spheres take the outward (hit - centre)/|...|
    (ky.cpp:1389), which faces inwards from inside."""
    P = geom.n_planar
    sid = sid.long()
    is_planar = (sid < P)[:, None]
    if P:
        pl_idx = sid.clamp(0, P - 1)
        n_pl = geom.pl_normal[pl_idx]
        flip = (geom.pl_kind[pl_idx] == RECT) & (km.dot(n_pl, d) > 0)
        n_pl = torch.where(flip[:, None], -n_pl, n_pl)
    else:
        n_pl = torch.zeros_like(position)
    if geom.n_sphere:
        c = geom.sp_center[(sid - P).clamp(0, geom.n_sphere - 1)]
        n_sp = km.normalize(position - c)
    else:
        n_sp = torch.zeros_like(position)
    return torch.where(is_planar, n_pl, n_sp)


def _gram_uv(r, e1, e2):
    """Solve r = u e1 + v e2 in the plane by the 2x2 Gram system (exact for
    skewed bases: a triangle's barycentrics, a parallelogram's
    coordinates)."""
    a = km.length_squared(e1)
    b = km.dot(e1, e2)
    c = km.length_squared(e2)
    det = a * c - b * b
    r1 = km.dot(r, e1)
    r2 = km.dot(r, e2)
    return km.safe_div(c * r1 - b * r2, det), km.safe_div(a * r2 - b * r1,
                                                          det)


def surface_uv(geom, sid, position):
    """Texture coordinates at the hits (scene/texture.py gives the
    conventions): sid (N,) global rows, position (N, 3) -> (N, 2)."""
    P = geom.n_planar
    sid = sid.long()
    is_planar = sid < P
    zero = torch.zeros(position.shape[0], dtype=position.dtype,
                       device=position.device)
    if P:
        pl_idx = sid.clamp(0, P - 1)
        kind = geom.pl_kind[pl_idx]
        p0, p1, p2 = (geom.pl_p0[pl_idx], geom.pl_p1[pl_idx],
                      geom.pl_p2[pl_idx])
        # triangle: barycentrics over (p0; p1 - p0, p2 - p0)
        ut, vt = _gram_uv(position - p0, p1 - p0, p2 - p0)
        # rectangle: corner p1, edges to p0 (u) and p2 (v), the corner the
        # reference's area and normal pivot on (ky.cpp:1261, 1304)
        ur, vr = _gram_uv(position - p1, p0 - p1, p2 - p1)
        # disk: frame coordinates about the centre, mapped to [0,1]^2
        s_ax, t_ax, _ = kframe.make_frame(geom.pl_normal[pl_idx])
        inv2r = km.safe_div(0.5, geom.pl_radius[pl_idx])
        rd = position - p0
        ud = 0.5 + km.dot(rd, s_ax) * inv2r
        vd = 0.5 + km.dot(rd, t_ax) * inv2r
        is_k = [kind == TRI, kind == RECT]
        u_pl = torch.where(is_k[0], ut, torch.where(is_k[1], ur, ud))
        v_pl = torch.where(is_k[0], vt, torch.where(is_k[1], vr, vd))
    else:
        u_pl = v_pl = zero
    if geom.n_sphere:
        n = km.normalize(position
                         - geom.sp_center[(sid - P).clamp(0, geom.n_sphere
                                                          - 1)])
        u_sp = km.spherical_phi(n) * km.INV_2PI
        v_sp = km.spherical_theta(n) * km.INV_PI
    else:
        u_sp = v_sp = zero
    return torch.stack([torch.where(is_planar, u_pl, u_sp),
                        torch.where(is_planar, v_pl, v_sp)], dim=-1)


offset_ray_origin = km.offset_ray_origin
