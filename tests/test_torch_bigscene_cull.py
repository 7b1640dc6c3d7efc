"""The big-scene kernels' block cull (csrc/bigscene_fwd.cu `block_meets`,
`cull_slack`, and the padded bounds of `kbs.cull_bounds`) is conservative:
its plain transcription `kbs.block_meets_plain` passes every block, and the
superblock around it, that holds a row the full sweep's row tests hit or
find occluding.

The rows are tested by the plain sweeps' own row tests
(`kbs._closest_class`, `kbs._occluded_class`), block by block. A block (and
its superblock) that one of them hits must pass for that ray over [0, t], t
the nearest hit in the block (tighter than the kernels' running t_best), or
over [0, tmax] for a shadow ray from its offset origin. Adversarial rays: rays that graze each
sphere's silhouette within a few ulps of its radius from near and far,
origins inside a block's bound, shading points offset by RAY_OFFSET with
short tmax, rays in the ground's plane and just off it, on
random_spheres(1024) (its ground spans |x|, |z| <= 35.2, where an ulp is
about 4e-6) and an icosphere mesh; a NaN or inf ray passes every block.
"""

import zlib

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.kernels.v3 import V3
from kytpu_torch.scene import builders, mesh

_SCENES = {}


def _tables(name):
    if name not in _SCENES:
        sc = {"spheres": lambda: builders.random_spheres(n=1024, width=8,
                                                         height=8),
              "mesh": lambda: builders.mesh_scene(
                  *mesh.icosphere(subdivisions=3), width=8, height=8)}[name]()
        _SCENES[name] = kbs.pack_big_tables(sc, kwf.KernelConfig())
    return _SCENES[name]


def _v3(a):
    a = torch.as_tensor(np.asarray(a, np.float32))
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _col(v: V3) -> V3:
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _blocks(tables):
    """(class name, its table, its rows, [(block, its bound and its
    superblock's bound (1, 4) in bnd)])."""
    nb = [-(-c // kbs.UNROLL) for c in tables.counts]
    sup = sum(nb)
    for k, name in enumerate(kbs.CLASSES):
        G, rows = tables.cls(name)
        off = sum(nb[:k])
        yield name, G, rows, [
            (b, torch.cat([tables.bnd[off + b:off + b + 1],
                           tables.bnd[sup + b // kbs.SUPER:
                                      sup + b // kbs.SUPER + 1]]))
            for b in range(nb[k])]
        sup += -(-nb[k] // kbs.SUPER)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _perp(u, rng):
    return _unit(np.cross(u, rng.normal(size=u.shape)))


def _grazing(G, name, bnd, rng, n):
    """Rays tangent to random rows' silhouettes, at the radius times 1 +
    k * 2^-23 (k in -8..8), from 0.3 to 80 units away; half of those on a
    sphere table graze a block's farthest sphere where it touches the
    block's bound."""
    k = rng.integers(0, len(G), n)
    g = G[k].numpy().astype(np.float64)
    if name == "sphere":
        c, r = g[:, :3], g[:, 3]
    else:   # a planar row's vertices are not in its table: its plane point
        c, r = g[:, :3] * g[:, 3:4], np.zeros(n)
    u = _unit(rng.normal(size=(n, 3)))
    if name == "sphere":
        Gn = G.numpy().astype(np.float64)
        bc = bnd.numpy().astype(np.float64)[k // kbs.UNROLL, :3]
        for i in range(0, n, 2):
            blk = Gn[(k[i] // kbs.UNROLL) * kbs.UNROLL:][:kbs.UNROLL]
            far = np.linalg.norm(blk[:, :3] - bc[i], axis=-1) + blk[:, 3]
            c[i], r[i] = blk[np.argmax(far), :3], blk[np.argmax(far), 3]
            if np.linalg.norm(c[i] - bc[i]) > 1e-6:
                u[i] = _unit(c[i] - bc[i])
    w = _perp(u, rng)
    p = c + u * (r * (1 + rng.integers(-8, 9, n) * 2.0 ** -23))[:, None]
    far = 10.0 ** rng.uniform(-0.5, 1.9, n)
    return p - w * far[:, None], w


def _inside(bnd, rng, n):
    """Origins inside a block's bound, directions anywhere."""
    b = bnd[rng.integers(0, len(bnd), n)].numpy().astype(np.float64)
    o = b[:, :3] + _unit(rng.normal(size=(n, 3))) * (
        b[:, 3] * rng.uniform(0, 1, n) ** (1 / 3))[:, None]
    return o, _unit(rng.normal(size=(n, 3)))


def _ground_plane(rng, n):
    """Rays in the ground's plane (y = 0), and just above and below it."""
    o = np.stack([rng.uniform(-40, 40, n), rng.choice(
        [0.0, 1e-6, -1e-6, 1e-3, 2e-2], n), rng.uniform(-40, 40, n)], -1)
    d = np.stack([rng.normal(size=n), rng.choice([0.0, 1e-7, -1e-7, 1e-3], n),
                  rng.normal(size=n)], -1)
    return o, _unit(d)


def _closest_cases(tables, family, rng):
    bnd = tables.bnd
    if family == "grazing":
        name = "sphere" if tables.counts[3] > 1 else "tri"
        off = sum(-(-c // kbs.UNROLL) for c in tables.counts[:3])
        return _grazing(tables.cls(name)[0], name, bnd[off:], rng, 4096)
    if family == "inside":
        return _inside(bnd, rng, 4096)
    return _ground_plane(rng, 16384)


@pytest.mark.parametrize("scene, family", [
    ("spheres", "grazing"), ("spheres", "inside"), ("spheres", "ground"),
    ("mesh", "grazing"), ("mesh", "inside"), ("mesh", "ground")])
def test_closest_hit_rows_pass_their_block(scene, family):
    tables = _tables(scene)
    rng = np.random.default_rng(zlib.crc32(f"{scene} {family}".encode()))
    o_np, d_np = _closest_cases(tables, family, rng)
    o, d = _v3(o_np), _v3(d_np)
    slack, inv = kbs.cull_slack_plain(o, d)
    checked = 0
    for name, G, _, blocks in _blocks(tables):
        for b, bnd in blocks:
            t = kbs._closest_class(name, G[b * kbs.UNROLL:(b + 1) * kbs.UNROLL],
                                   _col(o), _col(d))
            t_hit = t.min(dim=1).values
            hit = torch.isfinite(t_hit)
            if not hit.any():
                continue
            ok = kbs.block_meets_plain(bnd, o, d, inv, t_hit, slack).all(1)
            assert bool(ok[hit].all()), (name, b, int((~ok & hit).sum()))
            checked += int(hit.sum())
    assert checked > 100


@pytest.mark.parametrize("scene, robust", [
    ("spheres", False), ("spheres", True), ("mesh", False)])
def test_occluding_rows_pass_their_block(scene, robust):
    """Shading points on random rows, offset by +-RAY_OFFSET along their
    normal as the kernels offset them, shadow rays with short and long
    tmax toward random points, some grazing the neighbours."""
    tables = _tables(scene)
    rng = np.random.default_rng(7 + int(robust))
    name = "sphere" if tables.counts[3] > 1 else "tri"
    G = tables.cls(name)[0].numpy().astype(np.float64)
    n = 4096
    k = rng.integers(0, len(G), n)
    if name == "sphere":
        ns = _unit(rng.normal(size=(n, 3)))
        hp = G[k, :3] + ns * G[k, 3:4]
    else:
        ns = G[k, :3]
        hp = G[k, :3] * G[k, 3:4] + _perp(ns, rng) * 1e-3
    j = rng.integers(0, len(G), n)
    target = (G[j, :3] if name == "sphere" else G[j, :3] * G[j, 3:4]) + \
        rng.normal(size=(n, 3)) * 0.5
    wi = _unit(target - hp)
    tmax = np.linalg.norm(target - hp, axis=-1) * rng.choice(
        [0.002, 0.05, 1.0, 40.0], n)
    hp_t, ns_t, wi_t = _v3(hp), _v3(ns), _v3(wi)
    nd = ns_t.dot(wi_t)
    se = kwf._where(nd < 0.0, -kbs._OFF, kbs._OFF)
    tm = torch.as_tensor(tmax.astype(np.float32))
    if robust:
        tm = tm - se * nd
    o_k = hp_t + ns_t * se
    slack, inv = kbs.cull_slack_plain(o_k, wi_t)
    own = [int(tables.rows[0])] if robust else [None]
    checked = 0
    for cname, Gc, rows, blocks in _blocks(tables):
        for b, bnd in blocks:
            sl = slice(b * kbs.UNROLL, (b + 1) * kbs.UNROLL)
            hit = kbs._occluded_class(
                cname, Gc[sl], rows[sl], _col(hp_t), _col(ns_t),
                [(_col(wi_t), tm[:, None], se[:, None], nd[:, None])], own)[0]
            if not hit.any():
                continue
            ok = kbs.block_meets_plain(bnd, o_k, wi_t, inv, tm, slack).all(1)
            assert bool(ok[hit].all()), (cname, b, int((~ok & hit).sum()))
            checked += int(hit.sum())
    assert checked > 100


def test_nonfinite_rays_pass_every_block():
    tables = _tables("spheres")
    nan, inf = float("nan"), float("inf")
    o = _v3([[0, 1, 0], [nan, 1, 0], [inf, 1, 0], [0, 1, 0], [0, 1, 0],
             [0, 1, 0], [1e30, 1e30, 1e30], [0, -inf, 0]])
    d = _v3([[nan, 0, 1], [0, 0, 1], [0, 0, 1], [inf, 0, 0], [0, 0, 0],
             [0, -inf, 1], [1, 0, 0], [1e-30, 1e-30, 1e-30]])
    slack, inv = kbs.cull_slack_plain(o, d)
    assert not torch.isfinite(slack[[0, 1, 2, 3, 4, 5, 7]]).any()
    for t1 in (torch.full((8,), float("inf")), torch.full((8,), nan),
               torch.full((8,), 5.0)):
        ok = kbs.block_meets_plain(tables.bnd, o, d, inv, t1, slack)
        assert bool(ok[[0, 1, 2, 3, 4, 5, 7]].all())
