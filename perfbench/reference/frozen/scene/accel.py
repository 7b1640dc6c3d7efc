# Frozen copy of kytpu_torch/scene/accel.py at commit 35fb5ad, imports
# rewritten to this package: the benchmark's plain reference.
"""Uniform-grid ray-traversal accelerator (kytpu/scene/accel.py).

The reference's accelerator is a stub: `accel_t` stores the surface list
and traversal is a linear scan (ky.cpp:3097-3115, 3172-3184). The jnp
engines' SoA sweep (scene/shapes.py) is its vectorised form, O(N) a ray;
the grid is the opt-in (`builders.*(accel="grid")`) for scenes of
thousands of surfaces, and "auto" resolves to the sweep, as in kytpu.

  - The bake is kytpu's numpy code: two dense (cells, Imax) int32
    candidate tables (planar rows, sphere rows, -1 padded) with the same
    bits, then moved to the scene's device as tensors.
  - The traversal is plain torch code: a 3D DDA (Amanatides-Woo) over the
    whole ray batch, a Python loop of masked tensor steps. Each step
    gathers every lane's cell candidates and runs the jnp engines' hit
    tests (shapes.planar_test, sphere_test) on them. A lane retires when
    its best hit is nearer than the cell boundary it crosses, when it
    leaves the grid or passes tmax; the loop ends when no lane is active,
    one host sync (`active.any()`) a step, at most about sum(dims) steps.

chip_smoke.py phase 14c times the grid against the sweep on the card, in
Mrays/s, with the number of DDA steps (PERF.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.frozen.core import math as km
from perfbench.reference.frozen.scene import shapes as kshapes


@dataclass(frozen=True)
class Grid:
    """A baked uniform grid over the scene's AABB."""

    cell_pl: torch.Tensor   # (C, Ip) int32 planar rows per cell, -1 padded
    cell_sp: torch.Tensor   # (C, Is) int32 sphere rows per cell, -1 padded
    lo: torch.Tensor        # (3,) grid AABB min
    inv_h: torch.Tensor     # (3,) 1 / cell size
    h: torch.Tensor         # (3,) cell size
    dims: tuple = (1, 1, 1)

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def to(self, device) -> "Grid":
        return replace(self, **{f.name: getattr(self, f.name).to(device)
                                for f in fields(self) if f.name != "dims"})


# ---------------------------------------------------------------------------
# host-side bake (kytpu's numpy code)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _surface_aabbs(geom: kshapes.Geometry):
    """Per-surface AABBs (numpy): returns (pl_lo, pl_hi), (sp_lo, sp_hi)."""
    pl_lo = pl_hi = np.zeros((0, 3), np.float64)
    if geom.n_planar:
        pts = np.stack([_np(geom.pl_p0).astype(np.float64),
                        _np(geom.pl_p1).astype(np.float64),
                        _np(geom.pl_p2).astype(np.float64),
                        _np(geom.pl_p3).astype(np.float64)], axis=1)
        pl_lo = pts.min(axis=1)
        pl_hi = pts.max(axis=1)
        # disks: p1..p3 == p0, extend by the in-plane radius extent
        is_disk = _np(geom.pl_kind) == kshapes.DISK
        if is_disk.any():
            n = _np(geom.pl_normal).astype(np.float64)
            r = _np(geom.pl_radius).astype(np.float64)[:, None]
            # |s|*r + |t|*r per axis == r * sqrt(1 - n_axis^2)
            ext = r * np.sqrt(np.maximum(0.0, 1.0 - n * n))
            pl_lo = np.where(is_disk[:, None], pl_lo - ext, pl_lo)
            pl_hi = np.where(is_disk[:, None], pl_hi + ext, pl_hi)
    sp_lo = sp_hi = np.zeros((0, 3), np.float64)
    if geom.n_sphere:
        c = _np(geom.sp_center).astype(np.float64)
        r = _np(geom.sp_radius).astype(np.float64)[:, None]
        sp_lo, sp_hi = c - r, c + r
    return (pl_lo, pl_hi), (sp_lo, sp_hi)


def build_grid(geom: kshapes.Geometry, resolution: int | None = None) -> Grid:
    """Bake the grid on the host, on geom's device. `resolution` caps the
    longest axis' cell count; by default the density heuristic (about the
    cube root of 4x the surface count, capped at 64)."""
    (pl_lo, pl_hi), (sp_lo, sp_hi) = _surface_aabbs(geom)
    all_lo = np.concatenate([pl_lo, sp_lo])
    all_hi = np.concatenate([pl_hi, sp_hi])
    if all_lo.shape[0] == 0:
        raise ValueError("cannot build a grid over empty geometry")
    lo = all_lo.min(axis=0)
    hi = all_hi.max(axis=0)
    extent = np.maximum(hi - lo, 1e-6)
    # pad slightly so boundary hits stay strictly inside
    lo = lo - 1e-4 * extent
    hi = hi + 1e-4 * extent
    extent = hi - lo

    n_surf = geom.n_surfaces
    if resolution is None:
        resolution = int(np.clip(np.ceil((4.0 * n_surf) ** (1.0 / 3.0)),
                                 2, 64))
    # per-axis dims proportional to extent, longest axis = resolution
    dims = np.maximum(
        1, np.round(resolution * extent / extent.max())).astype(int)
    h = extent / dims
    inv_h = 1.0 / h

    def bucket(a_lo, a_hi):
        c0s = np.clip(np.floor((a_lo - lo) * inv_h).astype(int), 0, dims - 1)
        c1s = np.clip(np.floor((a_hi - lo) * inv_h).astype(int), 0, dims - 1)
        buckets = [[] for _ in range(int(np.prod(dims)))]
        for row, (c0, c1) in enumerate(zip(c0s, c1s)):
            for ix in range(c0[0], c1[0] + 1):
                for iy in range(c0[1], c1[1] + 1):
                    for iz in range(c0[2], c1[2] + 1):
                        buckets[(ix * dims[1] + iy) * dims[2] + iz].append(row)
        imax = max(1, max(len(b) for b in buckets))
        table = np.full((len(buckets), imax), -1, np.int32)
        for lin, b in enumerate(buckets):
            table[lin, :len(b)] = b
        return table

    dev = geom.pl_p0.device
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return Grid(
        cell_pl=torch.from_numpy(bucket(pl_lo, pl_hi)),
        cell_sp=torch.from_numpy(bucket(sp_lo, sp_hi)),
        lo=f32(lo), inv_h=f32(inv_h), h=f32(h),
        dims=tuple(int(x) for x in dims)).to(dev)


def grid_from_numpy(leaves) -> Grid:
    """A JAX-package `Grid` fetched with `jax.device_get` (numpy leaves and
    its static dims) as a CPU `Grid` of this package."""
    t = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=dt, copy=True))
    return Grid(cell_pl=t(leaves.cell_pl, np.int32),
                cell_sp=t(leaves.cell_sp, np.int32),
                lo=t(leaves.lo, np.float32), inv_h=t(leaves.inv_h, np.float32),
                h=t(leaves.h, np.float32),
                dims=tuple(int(x) for x in leaves.dims))


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------


def _enter_grid(grid: Grid, o, d):
    """Slab test against the grid AABB -> (t_enter, t_exit, inside);
    t_enter is clamped at 0 for rays starting inside."""
    dims_f = torch.tensor(grid.dims, dtype=torch.float32, device=o.device)
    hi = grid.lo + grid.h * dims_f
    inv_d = km.safe_div(1.0, d, fallback=km.INF)
    ta = (grid.lo[None] - o) * inv_d
    tb = (hi[None] - o) * inv_d
    t0 = torch.minimum(ta, tb).amax(dim=-1)
    t1 = torch.maximum(ta, tb).amin(dim=-1)
    t_enter = torch.clamp_min(t0, 0.0)
    return t_enter, t1, t1 >= t_enter


def _fold_closest(t, acc, idx, base: int, t_best, sid_best):
    """Each lane's nearest accepted candidate (the first on ties), folded
    into (t_best, sid_best) where strictly nearer."""
    tm = torch.where(acc, t, km.INF)
    j = torch.argmin(tm, dim=1, keepdim=True)
    tc = torch.gather(tm, 1, j)[:, 0]
    better = tc < t_best
    row = base + torch.gather(idx, 1, j)[:, 0]
    return (torch.where(better, tc, t_best),
            torch.where(better, row.to(torch.int32), sid_best))


def _test_cell(grid: Grid, geom: kshapes.Geometry, o, d, tmax, cell_lin,
               t_best, sid_best, want_closest: bool):
    """Test all candidates of each lane's cell; fold into (t_best, sid)."""
    oN = o[:, None, :]
    dN = d[:, None, :]
    tN = tmax[:, None]
    hit_any = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    cell_lin = cell_lin.long()
    for table, base in ((grid.cell_pl, 0), (grid.cell_sp, geom.n_planar)):
        if not (geom.n_planar if base == 0 else geom.n_sphere):
            continue
        idx = table[cell_lin]                     # (N, I)
        live = idx >= 0
        i = torch.clamp_min(idx, 0).long()
        if base == 0:
            t, acc = kshapes.planar_test(
                oN, dN, tN, geom.pl_kind[i], geom.pl_p0[i], geom.pl_p1[i],
                geom.pl_p2[i], geom.pl_p3[i], geom.pl_normal[i],
                geom.pl_radius[i])
        else:
            t, acc = kshapes.sphere_test(oN, dN, tN, geom.sp_center[i],
                                         geom.sp_radius[i])
        acc = acc & live
        if want_closest:
            t_best, sid_best = _fold_closest(t, acc, i, base, t_best,
                                             sid_best)
        else:
            hit_any = hit_any | acc.any(dim=1)
    return t_best, sid_best, hit_any


def traverse(grid: Grid, geom: kshapes.Geometry, o, d, tmax,
             want_closest: bool):
    """Batched Amanatides-Woo DDA -> (t_best, sid_best, hit_flag, steps),
    steps the number of DDA iterations the batch took."""
    n = o.shape[0]
    dev = o.device
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)

    t_enter, _, inside = _enter_grid(grid, o, d)
    # entry point, nudged into the grid interior
    p = o + (t_enter + 1e-5)[:, None] * d
    cell_f = (p - grid.lo[None]) * grid.inv_h[None]
    cell = torch.minimum(torch.clamp_min(torch.floor(cell_f).to(torch.int32),
                                         0), dims[None] - 1)

    step = torch.where(d >= 0, 1, -1).to(torch.int32)
    # t at the next boundary along each axis
    cf = cell.to(torch.float32)
    next_f = torch.where(d >= 0, cf + 1.0, cf)
    bound = grid.lo[None] + next_f * grid.h[None]
    inv_d = km.safe_div(1.0, d, fallback=km.INF)
    t_next = torch.where(torch.isinf(inv_d), km.INF, (bound - o) * inv_d)
    t_delta = torch.abs(grid.h[None] * inv_d)

    t_best = torch.full((n,), km.INF, dtype=torch.float32, device=dev)
    sid = torch.zeros((n,), dtype=torch.int32, device=dev)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    active = inside & (t_enter < tmax)
    steps = 0
    while bool(active.any()):
        steps += 1
        cell_lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        # only active lanes contribute: inactive lanes test against -inf
        tmax_eff = torch.where(active, tmax, -km.INF)
        t_best, sid, hit_any = _test_cell(
            grid, geom, o, d, tmax_eff, cell_lin, t_best, sid, want_closest)
        hit = hit | hit_any
        # advance the DDA along the axis of the nearest boundary
        axis = torch.argmin(t_next, dim=1, keepdim=True)
        t_boundary = torch.gather(t_next, 1, axis)[:, 0]
        onehot = F.one_hot(axis[:, 0], 3).to(torch.int32)
        new_cell = cell + onehot * step
        # where, not + onehot * delta: 0 * inf = nan on zero-direction axes
        new_t_next = torch.where(onehot != 0, t_next + t_delta, t_next)
        out = (new_cell < 0).any(dim=1) | (new_cell >= dims[None]).any(dim=1)
        if want_closest:
            # retire when the best hit is before the boundary just crossed
            # (the grid's correctness criterion), or out, or past tmax
            done = (t_best <= t_boundary) | out | (t_boundary > tmax)
        else:
            done = hit | out | (t_boundary > tmax)
        active = active & ~done
        cell = torch.where(active[:, None], new_cell, cell)
        t_next = torch.where(active[:, None], new_t_next, t_next)
    return t_best, sid, hit, steps


def grid_closest_hit(grid: Grid, geom: kshapes.Geometry, o, d, tmax):
    """shapes.closest_hit through the grid: (t, surface row, valid)."""
    t_best, sid, _, _ = traverse(grid, geom, o, d, tmax, want_closest=True)
    return t_best, sid, torch.isfinite(t_best)


def grid_any_hit(grid: Grid, geom: kshapes.Geometry, o, d, tmax):
    """shapes.any_hit through the grid: (N,) bool occlusion flags."""
    return traverse(grid, geom, o, d, tmax, want_closest=False)[2]
