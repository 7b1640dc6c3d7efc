"""K1's, K2's and K4's block cull past REFILL_MAX_ROWS surfaces
(csrc/wavefront_fwd.cu step 5: `block_meets`, `cull_slack`, and the padded
bounds of `kwf.cull_tables`) is conservative: its plain transcription
`kbs.block_meets_plain` passes every block, and the superblock around it,
that holds a row the plain sweep's own row tests hit or find occluding.

Each row is tested alone by the plain version's row tests (`kwf._closest_hit`
and `kwf._any_hit`, `kwf._any_hit_multi` on a scene of that one row),
block by block in the visit order. A block (and its superblock) that holds
a row one of them takes must pass for that ray over [0, t], t the row's hit
(tighter than the kernels' running t_best), or over [0, tmax] for a shadow
ray from its offset origin (both NEE forms: the nee="all" sweep's shared
terms and the nee="single" test of the offset origin). Adversarial rays:
rays that graze each sphere's silhouette within a few ulps of its radius
from near and far (half of them at the sphere that sets its block's
radius), rays through the edges and corners of the planar rows within a
few ulps and nearly in their planes, origins inside a block's bound, rays
in the ground's plane and just off it, and shading points offset by
RAY_OFFSET with short and long tmax. Two scenes: random_spheres(1024) with
a 16x16 ground atlas (1,026 surfaces, which the big-scene tables refuse;
its ground, one huge row, is the planar class's one block) and
`trapezoids(70)`, past 64 surfaces with rects that are not
parallelograms, parallelograms, triangles and disks, whose non-parallelogram
rows' blocks are unbounded. A ray that is not finite passes every block.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from kytpu_torch.cli.inverse import demo_texture
from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import shading as ksh
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
from kytpu_torch.scene import shapes as kshapes
from kytpu_torch.scene import texture as ktex
from tests.test_torch_bigscene_cull import _ground_plane, _perp, _unit, _v3
import tests.torch_threads  # noqa: F401  (one torch thread a process)


def ground_atlas(sc, n: int = 16):
    """random_spheres' scene `sc` with an n x n image texture on its ground
    (row 0): past 64 texels, a separable atlas, which the big-scene tables
    refuse, so render() and make_train_step() run it on K1-K4."""
    tid = torch.full((int(sc.mat_kind.shape[0]),), -1, dtype=torch.int32)
    tid[0] = 0
    return dataclasses.replace(sc, has_textures=True, tex_id=tid,
                               textures=ktex.build([dict(
                                   kind=ktex.IMAGE, image=demo_texture(n),
                                   scale=(4.0, 4.0))]))


def trapezoids(n_spheres: int, width: int = 16, height: int = 16,
               tie: bool = False):
    """A scene past 64 surfaces that K1-K4 take and the big-scene tables
    refuse (its floor and two tiles are rects that are not
    parallelograms): a trapezoid floor at y = 0, a row of tiles (a
    trapezoid, a parallelogram, a triangle and a disk, each twice) standing
    on it, `n_spheres` small spheres on a ring, a sphere light and a point
    light. tie=True puts two coplanar, overlapping parallelograms first
    (rows 0 and 1, y = 0.5), row 1 left of row 0, so that the visit order
    (`kwf.cull_tables`, by Morton code, x its highest bit) takes row 1
    before row 0 where both meet a ray at the same t."""
    A = builders._SceneAssembler
    a = A()
    g = a.geo
    if tie:
        a.surface(g.add_rectangle((-2, 0.5, -3), (-2, 0.5, 3), (4, 0.5, 3),
                                  (4, 0.5, -3)),
                  A.matte(np.float32([0.8, 0.2, 0.2])))
        a.surface(g.add_rectangle((-4, 0.5, -3), (-4, 0.5, 3), (2, 0.5, 3),
                                  (2, 0.5, -3)),
                  A.matte(np.float32([0.2, 0.2, 0.8])))
    a.surface(g.add_rectangle((-12, 0, -12), (-9, 0, 12), (9, 0, 12),
                              (12, 0, -12)),
              A.matte(np.float32([0.6, 0.6, 0.55])))
    for k in range(2):
        x0, z0 = -7.0 + 8.0 * k, -4.0 - 2.0 * k
        a.surface(g.add_rectangle((x0, 0, z0), (x0 + 0.5, 2.0, z0),
                                  (x0 + 1.5, 2.0, z0), (x0 + 2.2, 0, z0)),
                  A.matte(np.float32([0.3, 0.7, 0.4])))
        a.surface(g.add_rectangle((x0 + 3, 0, z0), (x0 + 3, 2, z0),
                                  (x0 + 4, 2, z0 + 0.5), (x0 + 4, 0, z0 + 0.5)),
                  A.plastic(np.float32([0.2, 0.2, 0.5]),
                            np.full(3, 0.5, np.float32), 60.0))
        a.surface(g.add_triangle((x0 + 5, 0, z0), (x0 + 6, 0, z0),
                                 (x0 + 5.5, 1.5, z0)),
                  A.matte(np.float32([0.7, 0.5, 0.2])))
        a.surface(g.add_disk((x0 + 1, 1.2, z0 + 3), (0.3, 1.0, 0.2), 0.7),
                  A.matte(np.float32([0.5, 0.3, 0.6])))
    for k in range(n_spheres):
        ang = 2 * np.pi * k / n_spheres
        r = 0.25 + 0.2 * (k % 3) / 2
        a.surface(g.add_sphere((7.5 * np.cos(ang), r, 7.5 * np.sin(ang)), r),
                  A.mirror(np.full(3, 0.9, np.float32)) if k % 5 == 0 else
                  A.matte(np.float32([0.3 + 0.5 * (k % 2), 0.5, 0.4])))
    emit = np.full(3, 30.0, np.float32)
    slot = a.add_light(kind=builders.klights.AREA_SPHERE, emit=emit,
                       center=np.asarray((0.0, 8.0, 0.0)), radius=1.0)
    a._lights[slot]["surface_handle"] = a.surface(
        g.add_sphere((0.0, 8.0, 0.0), 1.0), A.matte(np.zeros(3, np.float32)),
        emission=emit, light_slot=slot)
    a.add_light(kind=builders.klights.POINT, emit=np.full(3, 8.0, np.float32),
                position=np.float32([3.0, 4.0, 5.0]))
    cam = builders.kscene.make_camera(
        position=(0.0, 6.0, 14.0), front=(0.0, -0.45, -1.0),
        up=(0.0, 1.0, 0.0), fov_degrees=55.0, width=width, height=height)
    return a.build(cam)


_TABLES = {}


def _tables(name):
    if name not in _TABLES:
        sc = {"spheres16": lambda: ground_atlas(builders.random_spheres(
                  n=1024, width=8, height=8)),
              "trapezoids": lambda: trapezoids(70)}[name]()
        static = kwf.extract_static(sc, occl_skip=False)
        vis, bnd = kwf.cull_tables(static)
        _TABLES[name] = (static, vis, torch.from_numpy(bnd))
    return _TABLES[name]


def _classes(static, vis, bnd):
    """[(class, [(block, its rows, its bound and its superblock's (2, 4))])]
    in the visit order: the planar rows, then the spheres."""
    n_pl, n_sp = len(static["planar"]), len(static["spheres"])
    nb = [-(-n_pl // kbs.UNROLL), -(-n_sp // kbs.UNROLL)]
    sup0 = [sum(nb), sum(nb) + -(-nb[0] // kwf.SUPER)]
    out = []
    for k, (name, n, off) in enumerate((("planar", n_pl, 0),
                                        ("sphere", n_sp, n_pl))):
        order = vis[off:off + n]
        blocks = []
        for b in range(nb[k]):
            s = sup0[k] + b // kwf.SUPER
            blocks.append((b, order[b * kbs.UNROLL:(b + 1) * kbs.UNROLL],
                           torch.cat([bnd[sum(nb[:k]) + b:sum(nb[:k]) + b + 1],
                                      bnd[s:s + 1]])))
        out.append((name, blocks))
    return out


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
    """Origins inside a block's or a superblock's bound, directions
    anywhere."""
    b = bnd[rng.integers(0, len(bnd), n)].numpy().astype(np.float64)
    o = b[:, :3] + _unit(rng.normal(size=(n, 3))) * (
        b[:, 3] * rng.uniform(0, 1, n) ** (1 / 3))[:, None]
    return o, _unit(rng.normal(size=(n, 3)))


def _one_row(static, name, r):
    """A scene of row r alone (planar row r, or sphere r), for the plain
    version's own row tests."""
    li = static["mats"]["light_index"]
    if name == "planar":
        return dict(planar=[static["planar"][r]], spheres=[],
                    mats=dict(light_index=[li[r]]))
    return dict(planar=[], spheres=[static["spheres"][r]],
                mats=dict(light_index=[li[len(static["planar"]) + r]]))


def _sphere_table(static, vis):
    """The spheres in the visit order as a (n, 4) [c r] table (`_grazing`'s
    G)."""
    n_pl = len(static["planar"])
    sp = [static["spheres"][j] for j in vis[n_pl:]]
    return torch.tensor([[*s["c"], s["r"]] for s in sp], dtype=torch.float32)


def _edges(static, rng, n):
    """Rays through the edges and corners of random planar rows (a disk's
    rim) at 1 + k 2^-23 of the way out from the row's centre (k in
    -8..8), from 0.3 to 80 units away, a third of them within 1e-6 of the
    row's plane."""
    rows = static["planar"]
    k = rng.integers(0, len(rows), n)
    p = np.zeros((n, 3))
    nrm = np.zeros((n, 3))
    for i, r in enumerate(k):
        s = rows[r]
        nrm[i] = s["n"]
        if s["kind"] == kshapes.DISK:
            c = np.asarray(s["p0"])
            e = _perp(np.asarray(s["n"], np.float64)[None], rng)[0]
            p[i] = c + e * s["radius"]
        else:
            vs = [np.asarray(s[f"p{j}"]) for j in range(
                3 if s["kind"] == kshapes.TRI else 4)]
            j = rng.integers(0, len(vs))
            u = rng.choice([0.0, rng.uniform(), 1.0])
            q = vs[j] + u * (vs[(j + 1) % len(vs)] - vs[j])
            c = np.mean(vs, axis=0)
            p[i] = c + (q - c) * (1 + rng.integers(-8, 9) * 2.0 ** -23)
    w = _unit(rng.normal(size=(n, 3)))
    flat = rng.random(n) < 1 / 3
    w[flat] = _unit(_perp(nrm[flat], rng) + nrm[flat] * rng.choice(
        [0.0, 1e-7, -1e-6], (flat.sum(), 1)))
    far = 10.0 ** rng.uniform(-0.5, 1.9, n)
    return p - w * far[:, None], w


def _closest_cases(name, family, rng):
    static, vis, bnd = _tables(name)
    if family == "grazing":
        nb_pl = -(-len(static["planar"]) // kbs.UNROLL)
        return _grazing(_sphere_table(static, vis), "sphere", bnd[nb_pl:],
                        rng, 4096)
    if family == "edges":
        return _edges(static, rng, 4096)
    if family == "inside":
        fin = bnd[torch.isfinite(bnd).all(1)]
        return _inside(fin, rng, 4096)
    return _ground_plane(rng, 16384)


@pytest.mark.parametrize("scene, family", [
    ("spheres16", "grazing"), ("spheres16", "edges"), ("spheres16", "inside"),
    ("spheres16", "ground"), ("trapezoids", "grazing"),
    ("trapezoids", "edges"), ("trapezoids", "inside"),
    ("trapezoids", "ground")])
def test_closest_hit_rows_pass_their_block(scene, family):
    static, vis, bnd = _tables(scene)
    rng = np.random.default_rng(zlib.crc32(f"{scene} {family}".encode()))
    o_np, d_np = _closest_cases(scene, family, rng)
    o, d = _v3(o_np), _v3(d_np)
    slack, inv = kbs.cull_slack_plain(o, d)
    checked = 0
    for name, blocks in _classes(static, vis, bnd):
        for b, rows, bb in blocks:
            for r in rows:
                t, _, valid, _ = kwf._closest_hit(
                    _one_row(static, name, int(r)), o, d)
                if not valid.any():
                    continue
                ok = kbs.block_meets_plain(bb, o, d, inv, t, slack).all(1)
                assert bool(ok[valid].all()), (name, b, int(r),
                                               int((~ok & valid).sum()))
                checked += int(valid.sum())
    assert checked > 100


@pytest.mark.parametrize("scene, robust", [
    ("spheres16", False), ("spheres16", True), ("trapezoids", False),
    ("trapezoids", True)])
def test_occluding_rows_pass_their_block(scene, robust):
    """Shading points on random rows (a sphere's surface, a planar row's
    plane near its centre), offset by +-RAY_OFFSET along the normal as the
    kernels offset them, shadow rays with short and long tmax toward random
    points near other rows; each row's nee="all" test (shared terms) and
    nee="single" test (the offset origin) against its block."""
    static, vis, bnd = _tables(scene)
    rng = np.random.default_rng(11 + int(robust) + 2 * (scene == "trapezoids"))
    cs, rs = kwf.row_bounds(static)
    n_pl = len(static["planar"])
    n = 4096
    k = rng.integers(0, len(cs), n)
    ns = _unit(rng.normal(size=(n, 3)))
    hp = cs[k] + ns * np.where(np.isfinite(rs[k]), rs[k], 0.0)[:, None]
    on_pl = k < n_pl
    for i in np.nonzero(on_pl)[0]:
        s = static["planar"][k[i]]
        ns[i] = np.asarray(s["n"]) * rng.choice([-1.0, 1.0])
        hp[i] = cs[k[i]] + _perp(ns[i][None], rng)[0] * 1e-3
    j = rng.integers(0, len(cs), n)
    target = cs[j] + rng.normal(size=(n, 3)) * 0.5
    wi = _unit(target - hp)
    tmax = np.linalg.norm(target - hp, axis=-1) * rng.choice(
        [0.002, 0.05, 1.0, 40.0], n)
    hp_t, ns_t, wi_t = _v3(hp), _v3(ns), _v3(wi)
    nd = ns_t.dot(wi_t)
    se = ksh.where(nd < 0.0, -ksh.OFF, ksh.OFF)
    tm = torch.as_tensor(tmax.astype(np.float32))
    # the kernels' tmax: robust shadows shorten it by the offset
    tm_k = tm - se * nd if robust else tm
    o_k = hp_t + ns_t * se
    slack, inv = kbs.cull_slack_plain(o_k, wi_t)
    checked = 0
    for name, blocks in _classes(static, vis, bnd):
        for b, rows, bb in blocks:
            ok = None
            for r in rows:
                one = _one_row(static, name, int(r))
                hit = kwf._any_hit_multi(one, hp_t, ns_t, [(wi_t, tm)],
                                         [frozenset()], robust, nd=[nd])[0]
                hit = hit | kwf._any_hit(one, o_k, wi_t, tm_k)
                if not hit.any():
                    continue
                if ok is None:
                    ok = kbs.block_meets_plain(bb, o_k, wi_t, inv, tm_k,
                                               slack).all(1)
                assert bool(ok[hit].all()), (name, b, int(r),
                                             int((~ok & hit).sum()))
                checked += int(hit.sum())
    assert checked > 100


def test_visit_order_and_bounds():
    """Each class's visit order is a permutation of its rows; every block
    bound is finite but those holding a rect that is not a parallelogram
    (and their superblocks), which are (0, 0, 0, inf); a ray that is not
    finite passes every block."""
    for name in ("spheres16", "trapezoids"):
        static, vis, bnd = _tables(name)
        n_pl = len(static["planar"])
        assert sorted(vis[:n_pl]) == list(range(n_pl))
        assert sorted(vis[n_pl:]) == list(range(len(static["spheres"])))
        unbounded = [not s.get("fast") and s["kind"] != kshapes.DISK
                     for s in static["planar"]]
        nb = -(-n_pl // kbs.UNROLL)
        want = [any(unbounded[r] for r in vis[:n_pl][b * 8:(b + 1) * 8])
                for b in range(nb)]
        inf = ~torch.isfinite(bnd[:, 3])
        assert inf[:nb].tolist() == want
        assert (name == "trapezoids") == any(want)
        assert bool(torch.isfinite(bnd[~inf]).all())
        assert bool((bnd[inf, :3] == 0).all())
    nan, inf = float("nan"), float("inf")
    o = _v3([[0, 1, 0], [nan, 1, 0], [inf, 1, 0], [0, 1, 0], [0, 1, 0],
             [0, -inf, 0]])
    d = _v3([[nan, 0, 1], [0, 0, 1], [0, 0, 1], [inf, 0, 0], [0, 0, 0],
             [1e-30, 1e-30, 1e-30]])
    slack, inv = kbs.cull_slack_plain(o, d)
    for t1 in (torch.full((6,), inf), torch.full((6,), nan),
               torch.full((6,), 5.0)):
        assert bool(kbs.block_meets_plain(bnd, o, d, inv, t1, slack).all())
