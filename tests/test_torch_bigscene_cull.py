"""The big-scene kernels' tree cull (csrc/bigscene_fwd.cu `box_meets`,
`slab`, `cull_slack`, and the trees of padded boxes of `kbs.tree_bounds`,
built by `cull.box_tree`'s SAH) is conservative: its plain transcription
`kbs.node_meets_plain` passes every leaf, and every node above it in its
class's tree, that holds a row the full sweep's row tests hit or find
occluding, so a lane's walk reaches every row it would take.

The rows are tested by the plain sweeps' own row tests
(`kbs._closest_class`, `kbs._occluded_class`), a class's rows in a few
batched calls. A leaf (and each node above it) that one of them hits must
pass for that ray over [0, t], t the nearest hit in the leaf (tighter than
the kernels' running t_best), or over [0, tmax] for a shadow ray from its
offset origin. Adversarial rays: rays that graze each sphere's silhouette
within a few ulps of its radius from near and far (half of them where the
sphere touches a face of its leaf's unpadded box), origins inside a leaf's
or a node's box, shading points offset by RAY_OFFSET with short tmax, rays
in the ground's plane and just off it, on random_spheres(1024) (its ground
spans |x|, |z| <= 35.2, where an ulp is about 4e-6), an icosphere mesh,
SPD's sphereflake and its tetrahedral pyramid; a NaN or inf ray passes
every node. Each node's box holds its children's boxes and each of its
rows' float32 extent; the leaves hold every row once, in table order; a
walk of the plain test over the tree takes the full sweep's hit to the
bit; and the replay of the kernel's walk (`chip_smoke.swept_counts`)
tests fewer rows and boxes than the earlier tree of spheres over 8-row Morton
blocks did.
"""

import math
import zlib

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import shading as ksh
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.kernels.v3 import V3
from kytpu_torch.light import lights as klights
from kytpu_torch.scene import builders, mesh
from kytpu_torch.scene.scene import generate_rays, make_camera
import tests.torch_threads  # noqa: F401  (one torch thread a process)

def coplanar(width: int = 8, height: int = 8):
    """96 matte triangles of one plane (z = 0), each its own material row,
    overlapping at random, under the pyramid's lights, seen from above: a
    ray that meets the plane where rows overlap hits each of them at the
    same t (their plane records are equal), a tie that the closest hit
    breaks by kytpu's order of the rows."""
    rng = np.random.default_rng(4)
    a = builders._SceneAssembler()
    for _ in range(96):
        c, r = rng.uniform(-1.0, 1.0, 2), rng.uniform(0.3, 1.2)
        ang = rng.uniform(0.0, 2 * np.pi) + np.array([0.0, 2.0, 4.0]) * (
            np.pi / 3)
        v = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang),
                      np.zeros(3)], -1)
        a.surface(a.geo.add_triangle(*v), a.matte(torch.tensor(
            rng.uniform(0.2, 0.9, 3), dtype=torch.float32)))
    a.add_light(kind=klights.POINT, emit=torch.full((3,), 60.0),
                position=np.array(builders.TETRA_LIGHT_POS))
    a.add_light(kind=klights.ENV, emit=torch.tensor(builders.SPD_SKY))
    cam = make_camera(position=(0.4, -1.2, 3.0), front=(-0.4, 1.2, -3.0),
                      up=(0.0, 0.0, 1.0), fov_degrees=45.0, width=width,
                      height=height)
    return a.build(cam)


_BUILD = {
    "spheres": lambda: builders.random_spheres(n=1024, width=8, height=8),
    "coplanar": coplanar,
    "mesh": lambda: builders.mesh_scene(*mesh.icosphere(subdivisions=3),
                                        width=8, height=8),
    "spd_balls": lambda: builders.spd_balls(width=8, height=8),
    "tetra": lambda: builders.spd_tetra(width=8, height=8),
    "flake2": lambda: builders.spd_balls(2, 8, 8),
    "tetra3": lambda: builders.spd_tetra(3, 8, 8),
}
_SCENES = {}


def _tables(name):
    if name not in _SCENES:
        _SCENES[name] = kbs.pack_big_tables(_BUILD[name](),
                                            kwf.KernelConfig())
    return _SCENES[name]


def _v3(a):
    a = torch.as_tensor(np.asarray(a, np.float32))
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _col(v: V3) -> V3:
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _sub(v: V3, i) -> V3:
    return V3(v.x[i], v.y[i], v.z[i])


def _classes(tables):
    """Per class: (name, its table, its global rows, its entries' range
    [e0, e1) in tables.bnd, the parent of each of those entries (-1 at the
    root))."""
    links = kbs.tree_links(tables.bnd)
    e0 = 0
    for k, name in enumerate(kbs.CLASSES):
        G, rows = tables.cls(name)
        e1 = int(links[e0, 0]) if tables.counts[k] else e0
        parent, open_ = [], []
        for e in range(e0, e1):
            while open_ and int(links[open_[-1], 0]) <= e:
                open_.pop()
            parent.append(open_[-1] if open_ else -1)
            open_.append(e)
        yield name, G, rows, e0, e1, parent
        e0 = e1


def _leaves(tables):
    """Per class: (name, its table, its global rows, (leaves,) first rows,
    (leaves,) row counts, (leaves, H, 8) the bounds of each leaf and of
    the entries above it up to the root, the root repeated where a leaf
    lies less deep than H - 1)."""
    links = kbs.tree_links(tables.bnd)
    for name, G, rows, e0, e1, parent in _classes(tables):
        words = links[e0:e1, 1]
        at = torch.nonzero(words >= 0).reshape(-1)
        paths = []
        for i in at.tolist():
            p, e = [], i
            while e >= 0:
                p.append(e0 + e)
                e = parent[e] - e0 if parent[e] >= 0 else -1
            paths.append(p)
        h = max((len(p) for p in paths), default=1)
        paths = [p + [e0] * (h - len(p)) for p in paths]
        anc = tables.bnd[torch.tensor(paths, dtype=torch.long).reshape(-1, h)]
        yield (name, G, rows, words[at] >> 3, (words[at] & 7) + 1, anc)


def _leaf_min(x: torch.Tensor, first, fill) -> torch.Tensor:
    """(C, R) values of consecutive rows -> (C, leaves), each leaf's
    reduction (min for a float, any for a bool) over its rows."""
    a = x.numpy()
    f = first.numpy()
    if a.dtype == bool:
        return torch.from_numpy(np.logical_or.reduceat(a, f, axis=1))
    return torch.from_numpy(np.minimum.reduceat(a, f, axis=1))


def meets(anc: torch.Tensor, o: V3, d: V3, t1, slack) -> torch.Tensor:
    """`kbs.node_meets_plain` of each ray (C,) against each leaf of anc
    (leaves, H, 8) and the entries above it, over [0, t1]: t1 (C,) or (C,
    leaves) -> (C, leaves), every bound met."""
    t1 = t1[:, :, None] if t1.dim() == 2 else t1[:, None, None]
    c3 = lambda v: V3(v.x[:, None, None], v.y[:, None, None],  # noqa: E731
                      v.z[:, None, None])
    return kbs.node_meets_plain(anc[None], c3(o), c3(d), t1,
                                slack[:, None, None]).all(-1)


def _ray_chunks(n_rays: int, per_ray: int):
    """Slices of rays whose (ray, row or entry) pairs fit 1M elements."""
    step = max(1, (1 << 20) // max(per_ray, 1))
    return [slice(c0, min(n_rays, c0 + step)) for c0 in range(0, n_rays, step)]


def _first_bad(ok, hit):
    """(first leaf where a hit ray's bounds fail, how many rays fail)."""
    bad = hit & ~ok
    return int(bad.any(0).nonzero()[0]), int(bad.sum())


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _perp(u, rng):
    return _unit(np.cross(u, rng.normal(size=u.shape)))


def _grazing(tables, name, rng, n):
    """Rays tangent to random rows' silhouettes, at the radius times 1 +
    k * 2^-23 (k in -8..8), from 0.3 to 80 units away; on a sphere table
    half of them graze, on a random axis, the sphere of a leaf that reaches
    farthest along it, where it touches that face of the leaf's unpadded
    box."""
    G = tables.cls(name)[0].numpy().astype(np.float64)
    k = rng.integers(0, len(G), n)
    g = G[k]
    if name == "sphere":
        c, r = g[:, :3].copy(), g[:, 3].copy()
    else:   # a planar row's vertices are not in its table: its plane point
        c, r = g[:, :3] * g[:, 3:4], np.zeros(n)
    u = _unit(rng.normal(size=(n, 3)))
    if name == "sphere":
        leaf = [x for x in _leaves(tables) if x[0] == "sphere"][0]
        first, cnt = leaf[3].numpy(), leaf[4].numpy()
        pick = rng.integers(0, len(first), n)
        for i in range(0, n, 2):
            rows = G[first[pick[i]]:first[pick[i]] + cnt[pick[i]]]
            a, sgn = rng.integers(0, 3), rng.choice([-1.0, 1.0])
            s = rows[np.argmax(sgn * rows[:, a] + rows[:, 3])]
            c[i], r[i] = s[:3], s[3]
            u[i] = 0.0
            u[i, a] = sgn
    w = _perp(u, rng)
    p = c + u * (r * (1 + rng.integers(-8, 9, n) * 2.0 ** -23))[:, None]
    far = 10.0 ** rng.uniform(-0.5, 1.9, n)
    return p - w * far[:, None], w


def _inside(bnd, rng, n):
    """Origins inside a leaf's or a node's box, directions anywhere."""
    b = bnd[rng.integers(0, len(bnd), n)].numpy().astype(np.float64)
    lo, hi = b[:, :3], b[:, 4:7]
    return lo + (hi - lo) * rng.uniform(0, 1, (n, 3)), _unit(
        rng.normal(size=(n, 3)))


def _ground_plane(rng, n):
    """Rays in the ground's plane (y = 0), and just above and below it."""
    o = np.stack([rng.uniform(-40, 40, n), rng.choice(
        [0.0, 1e-6, -1e-6, 1e-3, 2e-2], n), rng.uniform(-40, 40, n)], -1)
    d = np.stack([rng.normal(size=n), rng.choice([0.0, 1e-7, -1e-7, 1e-3], n),
                  rng.normal(size=n)], -1)
    return o, _unit(d)


def _closest_cases(tables, family, rng, n=4096):
    if family == "grazing":
        name = "sphere" if tables.counts[3] > 1 else "tri"
        return _grazing(tables, name, rng, n)
    if family == "inside":
        return _inside(tables.bnd, rng, n)
    if family == "random":
        return (rng.uniform(-6, 6, (n, 3)), _unit(rng.normal(size=(n, 3))))
    return _ground_plane(rng, 4 * n)


@pytest.mark.parametrize("scene, family", [
    ("spheres", "grazing"), ("spheres", "inside"), ("spheres", "ground"),
    ("mesh", "grazing"), ("mesh", "inside"), ("mesh", "ground")])
def test_closest_hit_rows_pass_their_block(scene, family):
    """A leaf (the cull's block of rows) and every node above it pass each
    ray that hits one of its rows, over [0, t], t its nearest hit there."""
    tables = _tables(scene)
    rng = np.random.default_rng(zlib.crc32(f"{scene} {family}".encode()))
    o_np, d_np = _closest_cases(tables, family, rng)
    o, d = _v3(o_np), _v3(d_np)
    slack, _ = kbs.cull_slack_plain(o, d)
    checked = 0
    for name, G, _, first, _, anc in _leaves(tables):
        if not len(first):
            continue
        for sl in _ray_chunks(len(o.x), max(len(G), anc.shape[0]
                                            * anc.shape[1] * 8)):
            os_, ds_ = _sub(o, sl), _sub(d, sl)
            t = kbs._closest_class(name, G, _col(os_), _col(ds_))
            t_hit = _leaf_min(t, first, math.inf)
            hit = torch.isfinite(t_hit)
            ok = meets(anc, os_, ds_, t_hit, slack[sl])
            assert bool(ok[hit].all()), (name, sl.start, _first_bad(ok, hit))
            checked += int(hit.sum())
    assert checked > 100


def _shadow_cases(tables, rng, n=4096):
    """Shading points on random rows, offset by +-RAY_OFFSET along their
    normal as the kernels offset them, shadow rays with short and long
    tmax toward random points, some grazing the neighbours -> (hp, ns, wi,
    tmax) float64."""
    name = "sphere" if tables.counts[3] > 1 else "tri"
    G = tables.cls(name)[0].numpy().astype(np.float64)
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
    return hp, ns, wi, tmax


def _occluding_pass(tables, rng, robust: bool) -> int:
    """Each leaf (and every node above it) that holds a row occluding a
    shadow ray of `_shadow_cases` passes that ray over [0, tmax] from its
    offset origin -> how many (ray, leaf) pairs were checked."""
    hp, ns, wi, tmax = _shadow_cases(tables, rng)
    hp_t, ns_t, wi_t = _v3(hp), _v3(ns), _v3(wi)
    nd = ns_t.dot(wi_t)
    se = ksh.where(nd < 0.0, -ksh.OFF, ksh.OFF)
    tm = torch.as_tensor(tmax.astype(np.float32))
    if robust:
        tm = tm - se * nd
    o_k = hp_t + ns_t * se
    slack, _ = kbs.cull_slack_plain(o_k, wi_t)
    own = [int(tables.rows[0])] if robust else [None]
    # (C, 1, 1) rays: `_occluded_class`'s any() over its rows then keeps
    # each row's mask, (C, R)
    col2 = lambda v: V3(v.x[:, None, None], v.y[:, None, None],  # noqa: E731
                        v.z[:, None, None])
    checked = 0
    for cname, Gc, rows, first, _, anc in _leaves(tables):
        if not len(first):
            continue
        for sl in _ray_chunks(len(hp_t.x), max(len(Gc), anc.shape[0]
                                               * anc.shape[1] * 8)):
            ray = [(col2(_sub(wi_t, sl)), tm[sl, None, None],
                    se[sl, None, None], nd[sl, None, None])]
            hit = kbs._occluded_class(cname, Gc, rows, col2(_sub(hp_t, sl)),
                                      col2(_sub(ns_t, sl)), ray, own)[0]
            hit = _leaf_min(hit, first, False)
            ok = meets(anc, _sub(o_k, sl), _sub(wi_t, sl), tm[sl], slack[sl])
            assert bool(ok[hit].all()), (cname, sl.start, _first_bad(ok, hit))
            checked += int(hit.sum())
    return checked


@pytest.mark.parametrize("scene, robust", [
    ("spheres", False), ("spheres", True), ("mesh", False)])
def test_occluding_rows_pass_their_block(scene, robust):
    rng = np.random.default_rng(7 + int(robust))
    assert _occluding_pass(_tables(scene), rng, robust) > 100


@pytest.mark.parametrize("scene", ["spd_balls", "tetra"])
def test_occluding_rows_pass_every_node_above_them(scene):
    """The same on SPD's flake and pyramid: a leaf that holds a row
    occluding a shadow ray, and every node above it up to its class's
    root, pass that ray, so the occlusion walk reaches the row."""
    rng = np.random.default_rng(zlib.crc32(scene.encode()))
    assert _occluding_pass(_tables(scene), rng, True) > 100


def test_nonfinite_rays_pass_every_block():
    """A NaN or inf ray passes every box of the tree (leaves and nodes),
    each ray against every entry."""
    tables = _tables("spheres")
    nan, inf = float("nan"), float("inf")
    o = _v3([[0, 1, 0], [nan, 1, 0], [inf, 1, 0], [0, 1, 0], [0, 1, 0],
             [0, 1, 0], [1e30, 1e30, 1e30], [0, -inf, 0]])
    d = _v3([[nan, 0, 1], [0, 0, 1], [0, 0, 1], [inf, 0, 0], [0, 0, 0],
             [0, -inf, 1], [1, 0, 0], [1e-30, 1e-30, 1e-30]])
    slack, _ = kbs.cull_slack_plain(o, d)
    assert not torch.isfinite(slack[[0, 1, 2, 3, 4, 5, 7]]).any()
    for t1 in (torch.full((8, 1), float("inf")), torch.full((8, 1), nan),
               torch.full((8, 1), 5.0)):
        ok = kbs.node_meets_plain(tables.bnd, _col(o), _col(d), t1,
                                  slack[:, None])
        assert ok.shape == (8, len(tables.bnd))
        assert bool(ok[[0, 1, 2, 3, 4, 5, 7]].all())


def _row_extents(tables, name, G, rows):
    """Each row's float64 box from the float32 values the kernels test: a
    sphere's c +- r and a disk's exact box from its table row, a planar
    row's box of its vertices rounded to float32."""
    g = G.numpy().astype(np.float64)
    if name == "sphere":
        return g[:, :3] - np.abs(g[:, 3:4]), g[:, :3] + np.abs(g[:, 3:4])
    if name == "disk":
        u = g[:, :3] / np.linalg.norm(g[:, :3], axis=-1, keepdims=True)
        e = np.sqrt(g[:, 7:8]) * np.sqrt(np.maximum(1 - u * u, 0))
        return g[:, 4:7] - e, g[:, 4:7] + e
    planar = tables.static["planar"]
    keys = ("p0", "p1", "p2") if name == "tri" else ("p0", "p1", "p2", "p3")
    v = np.stack([np.stack([np.asarray(planar[int(r)][k], np.float32)
                            for k in keys]) for r in rows.tolist()])
    v = v.astype(np.float64)
    return v.min(1), v.max(1)


@pytest.mark.parametrize("scene", ["spheres", "mesh", "spd_balls", "tetra"])
def test_tree_nodes_hold_their_children(scene):
    """`kbs.tree_bounds`: each class's tree depth first, its root's skip
    the class's end, a leaf's skip the next entry, each node's children
    (entry + 1, then each one's skip, up to the node's skip) 1 to ARITY,
    each node's box holding each child's (float32, exactly), each leaf's
    box each of its rows' float32 extent, lo <= hi everywhere."""
    tables = _tables(scene)
    bnd = tables.bnd.numpy().astype(np.float64)
    links = kbs.tree_links(tables.bnd).numpy()
    assert (bnd[:, :3] <= bnd[:, 4:7]).all()
    e = 0
    for k, (name, G, rows, e0, e1, _) in enumerate(_classes(tables)):
        assert e0 == e
        if not tables.counts[k]:
            continue
        assert links[e0, 0] == e1
        lo, hi = _row_extents(tables, name, G, rows)
        for a in range(e0, e1):
            skip, word = links[a]
            assert a < skip <= e1
            if word >= 0:
                assert skip == a + 1
                s0, s1 = word >> 3, (word >> 3) + (word & 7) + 1
                assert (bnd[a, :3] <= lo[s0:s1]).all(), (scene, name, a)
                assert (bnd[a, 4:7] >= hi[s0:s1]).all(), (scene, name, a)
                continue
            kids, c = [], a + 1
            while c < skip:
                kids.append(c)
                c = links[c, 0]
            assert c == skip and 1 <= len(kids) <= kbs.ARITY
            assert (bnd[kids, :3] >= bnd[a, :3]).all(), (scene, name, a)
            assert (bnd[kids, 4:7] <= bnd[a, 4:7]).all(), (scene, name, a)
        e = e1
    assert e == len(links)


@pytest.mark.parametrize("scene", ["spheres", "mesh", "spd_balls", "tetra"])
def test_leaves_cover_each_row_once(scene):
    """Every real row of a class lies in exactly one leaf of 1 to 8 rows,
    the leaves in the tree's depth-first order come in table order one
    after another, and `extract_tables`' table_of_row names each row's
    place in that order."""
    tables = _tables(scene)
    links = kbs.tree_links(tables.bnd)
    st = tables.static
    for k, (name, _, rows, e0, e1, _) in enumerate(_classes(tables)):
        words = links[e0:e1, 1]
        words = words[words >= 0]
        first, n = (words >> 3).tolist(), ((words & 7) + 1).tolist()
        assert all(1 <= c <= kbs.UNROLL for c in n)
        assert first == list(np.cumsum([0] + n)[:-1])
        assert sum(n) == tables.counts[k]
        for ti, r in enumerate(rows.tolist()):
            assert st["table_of_row"][r] == (name, ti)


@pytest.mark.parametrize("scene", ["spheres", "spd_balls", "tetra"])
def test_closest_hits_pass_every_node_above_them(scene):
    """The row the full sweep's closest hit takes (`kbs._closest_hit`) on
    grazing rays and rays from inside the boxes: its leaf and every node
    above it pass `kbs.node_meets_plain` over [0, t], t the hit (the walk's
    running t_best is never below it), so a lane's walk reaches it."""
    tables = _tables(scene)
    rng = np.random.default_rng(zlib.crc32(scene.encode()))
    fams = [_closest_cases(tables, f, rng) for f in ("grazing", "inside")]
    o = _v3(np.concatenate([f[0] for f in fams]))
    d = _v3(np.concatenate([f[1] for f in fams]))
    t, cls, trow = kbs._closest_hit(tables, o, d,
                                    torch.ones_like(o.x, dtype=torch.bool))
    slack, _ = kbs.cull_slack_plain(o, d)
    checked = 0
    for k, (name, _, _, first, n, anc) in enumerate(_leaves(tables)):
        on = (cls == k).nonzero().reshape(-1)
        if not len(on):
            continue
        leaf = torch.searchsorted(first, trow[on], right=True) - 1
        assert bool((trow[on] < first[leaf] + n[leaf]).all())
        path = anc[leaf]                          # (C, H, 8)
        for j in range(path.shape[1]):
            ok = kbs.node_meets_plain(path[:, j], _sub(o, on), _sub(d, on),
                                      t[on], slack[on])
            assert bool(ok.all()), (scene, name, j, int((~ok).sum()))
        checked += len(on)
    assert checked > 500


def test_nonfinite_rays_pass_every_node():
    """A NaN or inf ray passes every leaf and tree node, each against its
    own bound (`kbs.node_meets_plain`, the walk's test), whatever t1."""
    tables = _tables("spd_balls")
    nodes = tables.bnd
    nan, inf = float("nan"), float("inf")
    rays = [([nan, 1, 0], [0, 0, 1]), ([inf, 1, 0], [0, 0, 1]),
            ([0, 1, 0], [nan, 0, 1]), ([0, 1, 0], [inf, 0, 0]),
            ([0, 1, 0], [0, 0, 0]), ([0, -inf, 0], [1e-30, 1e-30, 1e-30])]
    n = len(nodes)
    for ro, rd in rays:
        o = _v3(np.tile(ro, (n, 1)))
        d = _v3(np.tile(rd, (n, 1)))
        slack, _ = kbs.cull_slack_plain(o, d)
        for t1 in (inf, nan, 5.0, 0.0):
            ok = kbs.node_meets_plain(nodes, o, d, torch.full((n,), t1),
                                      slack)
            assert bool(ok.all()), (ro, rd, t1)


def _walk_closest(tables, o: V3, d: V3):
    """The kernels' closest-hit walk (csrc/bigscene_fwd.cu `walk`, each ray
    alone) on the plain tests: each class's tree in table order, a box met
    over [0, t_best] entered, a leaf's rows tested by `kbs._closest_class`
    in order, a row taken at t < t_best or at a tie in its class where its
    rank is lower -> (t, class, table row)."""
    n = len(o.x)
    links = kbs.tree_links(tables.bnd)
    slack, _ = kbs.cull_slack_plain(o, d)
    t_best = torch.full((n,), math.inf)
    cls = torch.full((n,), -1, dtype=torch.long)
    trow = torch.full((n,), -1, dtype=torch.long)
    for k, (name, G, _, e0, e1, _) in enumerate(_classes(tables)):
        r0 = sum(tables.counts[:k])
        rank = tables.rank[r0:r0 + tables.counts[k]]
        e = torch.full((n,), e0, dtype=torch.long)
        while bool((e < e1).any()):
            on = (e < e1).nonzero().reshape(-1)
            ee = e[on]
            m = kbs.node_meets_plain(tables.bnd[ee], _sub(o, on), _sub(d, on),
                                     t_best[on], slack[on])
            word = links[ee, 1]
            for q in range(kbs.UNROLL):
                lf = m & (word >= 0) & ((word & 7) >= q)
                i = on[lf]
                s = (word[lf] >> 3) + q
                g = G[s]
                t = kbs._closest_class(name, g[:, :, None], _col(_sub(o, i)),
                                       _col(_sub(d, i)))[:, 0]
                best = trow[i].clamp(0, len(rank) - 1)
                take = (t < t_best[i]) | ((t == t_best[i]) & (cls[i] == k)
                                          & (rank[s] < rank[best]))
                t_best[i[take]] = t[take]
                cls[i[take]] = k
                trow[i[take]] = s[take]
            e[on] = torch.where(m, ee + 1, links[ee, 0])
    return t_best, cls, trow


@pytest.mark.parametrize("scene, family", [
    ("flake2", "random"), ("flake2", "grazing"), ("flake2", "inside"),
    ("tetra3", "random"), ("tetra3", "grazing"), ("tetra3", "inside")])
def test_plain_walk_equals_full_sweep(scene, family):
    """The walk over the tree takes the full sweep's closest hit
    (`kbs._closest_hit`: every row of every class) to the bit: t, class
    and table row, on random rays, rays grazing the rows (at a leaf box's
    face on the flake) and rays from inside the boxes, at flake factor 2
    (91 spheres) and pyramid factor 3 (64 triangles)."""
    tables = _tables(scene)
    rng = np.random.default_rng(zlib.crc32(f"{scene} {family}".encode()))
    o_np, d_np = _closest_cases(tables, family, rng, 2048)
    o, d = _v3(o_np), _v3(d_np)
    want = kbs._closest_hit(tables, o, d,
                            torch.ones_like(o.x, dtype=torch.bool))
    got = _walk_closest(tables, o, d)
    hit = want[1] >= 0
    assert int(hit.sum()) > 50
    assert torch.equal(got[1], want[1].long())
    assert torch.equal(got[2][hit], want[2][hit].long())
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def test_ties_take_the_first_row_in_kytpus_order():
    """Rays from above onto the overlapping triangles of one plane: where
    several rows meet a ray at the same t, `kbs._closest_hit` (the plain
    K6's) and the plain walk over the tree take the row that kytpu's sweep
    takes, the first of the nearest in kytpu's table (the class's rows in
    the order of their ranks), and not the first in the port's table."""
    tables = _tables("coplanar")
    rng = np.random.default_rng(6)
    n = 4096
    o_np = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                     np.full(n, 2.0)], -1)
    d_np = _unit(np.stack([rng.normal(size=n) * 0.3,
                           rng.normal(size=n) * 0.3, -np.ones(n)], -1))
    o, d = _v3(o_np), _v3(d_np)
    G, rows = tables.cls("tri")
    t = kbs._closest_class("tri", G, _col(o), _col(d))
    by_rank = torch.argsort(tables.rank[:len(G)])
    t_min, j = t[:, by_rank].min(1)
    hit = torch.isfinite(t_min)
    want = rows[by_rank[j]][hit]
    ties = (t == t_min[:, None]).sum(1)[hit]
    in_table = rows[t.min(1)[1]][hit]
    assert int((ties > 1).sum()) > 1000
    assert int((in_table != want).sum()) > 200
    for got_t, cls, trow in (kbs._closest_hit(tables, o, d, torch.ones(
            n, dtype=torch.bool)), _walk_closest(tables, o, d)):
        assert torch.equal(cls == 0, hit)
        assert torch.equal(got_t.view(torch.int32), t_min.view(torch.int32))
        assert torch.equal(rows[trow[hit]], want)


# The replay's own rows and node steps a lane-sweep (warps of one) on the
# lanes of `test_walk_counts_fall`: (rows, node steps) of the earlier tree of
# padded spheres over 8-row Morton blocks, measured on its code, and of
# the SAH tree of boxes
_OLD_COUNTS = {"flake3": (74.50, 64.32), "tetra4": (44.63, 24.36)}
_NEW_COUNTS = {"flake3": (2.75, 31.20), "tetra4": (4.63, 14.45)}


@pytest.mark.parametrize("scene", ["flake3", "tetra4"])
def test_walk_counts_fall(scene):
    """`chip_smoke.swept_counts` at warps of one on 2,048 jittered camera
    lanes of 32x32, depth 3, at flake factor 3 (820 spheres) and pyramid
    factor 4 (256 triangles): a lane's own rows a lane-sweep at most half
    of the old tree's, its node steps at most half on the flake and at
    most 0.6 of them on the pyramid (its old tree had 43 entries for 256
    rows), as measured (_NEW_COUNTS)."""
    import chip_smoke

    sc = {"flake3": lambda: builders.spd_balls(3, 32, 32),
          "tetra4": lambda: builders.spd_tetra(4, 32, 32)}[scene]()
    cfg = kwf.KernelConfig(max_depth=3, rr_start=1, rows=2)
    n, w = 2048, 32
    rng = np.random.default_rng(3)
    pix = (np.arange(n) % (w * w)).astype(np.int32)
    pf = np.stack([pix % w + rng.random(n), pix // w + rng.random(n)],
                  -1).astype(np.float32)
    o, d = generate_rays(sc.camera, torch.from_numpy(pf))
    si = torch.from_numpy((np.arange(n) // (w * w) + 3).astype(np.int32))
    tables = kbs.pack_big_tables(sc, cfg)
    own = {}
    got = chip_smoke.swept_counts(tables, cfg, o, d, 11, si,
                                  torch.from_numpy(pix), warp=1, stats=own)
    rows, steps = own["lane_rows"] / got[1], own["lane_bounds"] / got[1]
    old_rows, old_steps = _OLD_COUNTS[scene]
    assert rows <= old_rows / 2, (rows, old_rows)
    assert steps <= old_steps * (0.5 if scene == "flake3" else 0.6), (
        steps, old_steps)
    assert (round(rows, 2), round(steps, 2)) == _NEW_COUNTS[scene]
