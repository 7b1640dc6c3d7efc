"""The big-scene kernels' block cull (csrc/bigscene_fwd.cu `block_meets`,
`cull_slack`, and the padded bounds of `kbs.tree_bounds`: the blocks and
the tree above them) is conservative: its plain transcription
`kbs.block_meets_plain` passes every block, and every node above it in
its class's tree, that holds a row the full sweep's row tests hit or find
occluding, so a lane's walk reaches every row it would take.

The rows are tested by the plain sweeps' own row tests
(`kbs._closest_class`, `kbs._occluded_class`), a class's blocks in a few
batched calls. A block (and each node above it) that one of them hits must
pass for that ray over [0, t], t
the nearest hit in the block (tighter than the kernels' running t_best), or
over [0, tmax] for a shadow ray from its offset origin. Adversarial rays: rays that graze each
sphere's silhouette within a few ulps of its radius from near and far,
origins inside a block's or a node's bound, shading points offset by
RAY_OFFSET with short tmax, rays in the ground's plane and just off it, on
random_spheres(1024) (its ground spans |x|, |z| <= 35.2, where an ulp is
about 4e-6) and an icosphere mesh; a NaN or inf ray passes every block
and node. Each node's sphere holds its children's padded spheres whole.
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
from kytpu_torch.scene import builders, mesh
import tests.torch_threads  # noqa: F401  (one torch thread a process)

_SCENES = {}


def _tables(name):
    if name not in _SCENES:
        sc = {"spheres": lambda: builders.random_spheres(n=1024, width=8,
                                                         height=8),
              "mesh": lambda: builders.mesh_scene(
                  *mesh.icosphere(subdivisions=3), width=8, height=8),
              "spd_balls": lambda: builders.spd_balls(width=8, height=8)
              }[name]()
        _SCENES[name] = kbs.pack_big_tables(sc, kwf.KernelConfig())
    return _SCENES[name]


def _v3(a):
    a = torch.as_tensor(np.asarray(a, np.float32))
    return V3(a[:, 0], a[:, 1], a[:, 2])


def _col(v: V3) -> V3:
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _blocks(tables):
    """(class name, its table, its rows, the bounds (blocks, H + 1, 4) of
    each block and of the entries above it, in bnd: in `kbs.tree_bounds`'
    depth-first layout entry a is above entry b where a < b < a's skip)."""
    links, e = tables.links.long(), 0
    for k, name in enumerate(kbs.CLASSES):
        G, rows = tables.cls(name)
        if not tables.counts[k]:
            yield name, G, rows, tables.bnd.new_zeros((0, 1, 4))
            continue
        end = int(links[e, 0])
        ix = torch.arange(e, end)
        leaf, inner = ix[links[ix, 1] >= 0], ix[links[ix, 1] < 0]
        assert torch.equal(links[leaf, 1], torch.arange(len(leaf)))
        above = (inner[None] < leaf[:, None]) & (
            links[inner, 0][None] > leaf[:, None])
        h = int(above[0].sum())
        assert bool((above.sum(1) == h).all())
        anc = inner[None].expand_as(above)[above].view(len(leaf), h)
        yield name, G, rows, tables.bnd[torch.cat([leaf[:, None], anc], 1)]
        e = end


def _nodes(tables):
    """The bounds of every block and tree node of `tables`, (entries,
    4)."""
    return tables.bnd


def _chunks(n_rays: int, n_blocks: int):
    """Slices of blocks whose (ray, row) pairs fit 2M elements a tensor."""
    step = max(1, (1 << 21) // (n_rays * kbs.UNROLL))
    return [slice(b0, min(n_blocks, b0 + step))
            for b0 in range(0, n_blocks, step)]


def _by_block(x: torch.Tensor, n_blocks: int, fill) -> torch.Tensor:
    """(C, R) values of consecutive rows -> (C, blocks, UNROLL), the last
    block padded with `fill`."""
    pad = n_blocks * kbs.UNROLL - x.shape[1]
    x = torch.cat([x, x.new_full((x.shape[0], pad), fill)], 1)
    return x.view(x.shape[0], n_blocks, kbs.UNROLL)


def meets(bb: torch.Tensor, o: V3, d: V3, inv, t1, slack) -> torch.Tensor:
    """`kbs.block_meets_plain` of each ray against each block of bb (blocks,
    L, 4) and the nodes above it, over [0, t1]: t1 (C,) or (C, blocks) ->
    (C, blocks), every bound met."""
    n = bb.shape[1]
    if t1.dim() == 2:
        t1 = t1.repeat_interleave(n, dim=1)
    return kbs.block_meets_plain(bb.reshape(-1, 4), o, d, inv, t1,
                                 slack).view(len(o.x), -1, n).all(-1)


def _first_bad(ok, hit):
    """(first block where a hit ray's bound fails, how many rays fail)."""
    bad = hit & ~ok
    return int(bad.any(0).nonzero()[0]), int(bad.sum())


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
    """Origins inside a block's or a node's bound, directions anywhere."""
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
        return _inside(_nodes(tables), rng, 4096)
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
    for name, G, _, bb in _blocks(tables):
        for sl in _chunks(len(o.x), len(bb)):
            n_b = sl.stop - sl.start
            t = kbs._closest_class(
                name, G[sl.start * kbs.UNROLL:sl.stop * kbs.UNROLL], _col(o),
                _col(d))
            t_hit = _by_block(t, n_b, math.inf).min(2).values
            hit = torch.isfinite(t_hit)
            ok = meets(bb[sl], o, d, inv, t_hit, slack)
            assert bool(ok[hit].all()), (name, sl.start, _first_bad(ok, hit))
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
    se = ksh.where(nd < 0.0, -ksh.OFF, ksh.OFF)
    tm = torch.as_tensor(tmax.astype(np.float32))
    if robust:
        tm = tm - se * nd
    o_k = hp_t + ns_t * se
    slack, inv = kbs.cull_slack_plain(o_k, wi_t)
    own = [int(tables.rows[0])] if robust else [None]
    # (C, 1, 1) rays: `_occluded_class`'s any() over its rows then keeps
    # each row's mask, (C, R)
    col2 = lambda v: V3(v.x[:, None, None], v.y[:, None, None],  # noqa: E731
                        v.z[:, None, None])
    ray = [(col2(wi_t), tm[:, None, None], se[:, None, None],
            nd[:, None, None])]
    checked = 0
    for cname, Gc, rows, bb in _blocks(tables):
        for sl in _chunks(len(hp_t.x), len(bb)):
            r = slice(sl.start * kbs.UNROLL, sl.stop * kbs.UNROLL)
            hit = kbs._occluded_class(cname, Gc[r], rows[r], col2(hp_t),
                                      col2(ns_t), ray, own)[0]
            hit = _by_block(hit, sl.stop - sl.start, False).any(2)
            ok = meets(bb[sl], o_k, wi_t, inv, tm, slack)
            assert bool(ok[hit].all()), (cname, sl.start, _first_bad(ok, hit))
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


@pytest.mark.parametrize("scene", ["spheres", "mesh", "spd_balls"])
def test_tree_nodes_hold_their_children(scene):
    """`kbs.tree_bounds`: depth first, one root a class whose skip ends the
    class, a block's skip the next entry, the blocks in table order and
    `cull_bounds`' to the byte, each node's children (entry + 1, then each
    one's skip, up to the node's skip) at most ARITY, and each node's
    sphere holding each child's whole (float64)."""
    tables = _tables(scene)
    st, tabs = kbs.extract_tables(
        {"spheres": lambda: builders.random_spheres(n=1024, width=8,
                                                    height=8),
         "mesh": lambda: builders.mesh_scene(*mesh.icosphere(subdivisions=3),
                                             width=8, height=8),
         "spd_balls": lambda: builders.spd_balls(width=8, height=8)}[scene]())
    nb = [-(-c // kbs.UNROLL) for c in tables.counts]
    blocks = kwf.cull_bounds(tabs)[:sum(nb)]
    bnd = tables.bnd.numpy().astype(np.float64)
    links = tables.links.numpy()
    assert len(bnd) == len(links)
    e, leaves = 0, []
    for k in range(4):
        if not nb[k]:
            continue
        end = links[e, 0]
        for a in range(e, end):
            skip, blk = links[a]
            assert a < skip <= end
            if blk >= 0:
                assert skip == a + 1
                leaves.append(a)
                continue
            kids, c = [], a + 1
            while c < skip:
                kids.append(c)
                c = links[c, 0]
            assert c == skip and 1 <= len(kids) <= kbs.ARITY
            reach = np.linalg.norm(bnd[kids, :3] - bnd[a, :3], axis=-1) + \
                bnd[kids, 3]
            assert (reach <= bnd[a, 3]).all(), (scene, k, a)
        e = end
    assert e == len(links)
    assert tables.bnd.numpy()[leaves].tobytes() == blocks.tobytes()


@pytest.mark.parametrize("scene", ["spheres", "spd_balls"])
def test_closest_hits_pass_every_node_above_them(scene):
    """The row the full sweep's closest hit takes (`kbs._closest_hit`) on
    camera rays, grazing rays and rays from inside the bounds: its block and
    every node above it pass `kbs.node_meets_plain` over [0, t], t the hit
    (the walk's running t_best is never below it), so a lane's walk reaches
    it."""
    tables = _tables(scene)
    rng = np.random.default_rng(zlib.crc32(scene.encode()))
    fams = [_closest_cases(tables, f, rng) for f in ("grazing", "inside")]
    o = _v3(np.concatenate([f[0] for f in fams]))
    d = _v3(np.concatenate([f[1] for f in fams]))
    t, cls, trow = kbs._closest_hit(tables, o, d,
                                    torch.ones_like(o.x, dtype=torch.bool))
    slack, inv = kbs.cull_slack_plain(o, d)
    checked = 0
    for k, (name, _, _, bb) in enumerate(_blocks(tables)):
        on = (cls == k).nonzero().reshape(-1)
        if not len(on):
            continue
        anc = bb[trow[on] // kbs.UNROLL]          # (C, H + 1, 4)
        for j in range(anc.shape[1]):
            ok = kbs.node_meets_plain(
                anc[:, j], V3(o.x[on], o.y[on], o.z[on]),
                V3(d.x[on], d.y[on], d.z[on]), inv[on], t[on], slack[on])
            assert bool(ok.all()), (scene, name, j, int((~ok).sum()))
        checked += len(on)
    assert checked > 500


def test_nonfinite_rays_pass_every_node():
    """A NaN or inf ray passes every block and tree node, each against its
    own bound (`kbs.node_meets_plain`, the walk's test), whatever t1."""
    tables = _tables("spd_balls")
    nodes = _nodes(tables)
    nan, inf = float("nan"), float("inf")
    rays = [([nan, 1, 0], [0, 0, 1]), ([inf, 1, 0], [0, 0, 1]),
            ([0, 1, 0], [nan, 0, 1]), ([0, 1, 0], [inf, 0, 0]),
            ([0, 1, 0], [0, 0, 0]), ([0, -inf, 0], [1e-30, 1e-30, 1e-30])]
    n = len(nodes)
    for ro, rd in rays:
        o = _v3(np.tile(ro, (n, 1)))
        d = _v3(np.tile(rd, (n, 1)))
        slack, inv = kbs.cull_slack_plain(o, d)
        for t1 in (inf, nan, 5.0, 0.0):
            ok = kbs.node_meets_plain(nodes, o, d, inv,
                                      torch.full((n,), t1), slack)
            assert bool(ok.all()), (ro, rd, t1)
