"""The cull geometry that both kernel families read: for K1, K2 and K4,
which vote over flat superblocks of Morton-ordered rows
(`kwf.cull_tables`), the Morton keys, the 8-row block bounds and the
padded spheres around groups of bounds; for K5, K6 and K8, which walk a
tree a class (`kbs.tree_bounds`), the SAH tree of padded boxes
(`box_tree`). CULL_PAD sizes the pads of both.
"""

from __future__ import annotations

import numpy as np

# rows a block (kytpu's table kernels' unroll), and the shape classes in
# table order
UNROLL = 8
CLASSES = ("tri", "rect", "disk", "sphere")


def morton3(points: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """30-bit Morton keys of points quantized over [lo, hi]."""
    span = np.maximum(hi - lo, 1e-20)
    q = np.clip(((points - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1])
                                                << np.uint64(1)) \
        | spread(q[:, 2])


def block_bounds(centers, radii):
    """Per-UNROLL-block bounding spheres of (already sorted, unpadded)
    per-entry bounds -> (n_blocks, 4) [cx cy cz r]; blocks made entirely of
    padding get r = -1, as kytpu's (its cone cull reads them);
    `padded` pads them for the kernels' per-lane cull."""
    n = len(radii)
    npad = ((n + UNROLL - 1) // UNROLL) * UNROLL if n else 0
    out = np.zeros((npad // UNROLL if npad else 0, 4), np.float32)
    for b in range(out.shape[0]):
        i0, i1 = b * UNROLL, min((b + 1) * UNROLL, n)
        if i0 >= n:
            out[b] = [0, 0, 0, -1.0]
            continue
        cs = np.asarray(centers[i0:i1], np.float64)
        rs = np.asarray(radii[i0:i1], np.float64)
        lo = (cs - rs[:, None]).min(axis=0)
        hi = (cs + rs[:, None]).max(axis=0)
        c = (lo + hi) * 0.5
        r = float(np.max(np.linalg.norm(cs - c, axis=-1) + rs))
        out[b] = [c[0], c[1], c[2], r * 1.0001 + 1e-6]   # conservative pad
    return out


# csrc/bigscene_fwd.cu's cull pad: a block's bounding radius grows by
# CULL_PAD of its centre's and radius's size, and each lane adds CULL_PAD
# of its ray origin's size (`kbs.cull_slack_plain`)
CULL_PAD = 2.0 ** -12


def padded(c, r) -> np.ndarray:
    """(n, 4) float32 [c R] of float64 centres and radii, R = r + CULL_PAD
    * (|cx| + |cy| + |cz| + r) rounded up to a float32."""
    r = r + CULL_PAD * (np.abs(c).sum(-1) + r)
    r32 = r.astype(np.float32)
    r32 = np.where(r32 < r, np.nextafter(r32, np.float32(np.inf)), r32)
    return np.concatenate([c.astype(np.float32), r32[:, None]], -1)


def group(pb, k: int) -> np.ndarray:
    """(ceil(n / k), 4) float32 padded spheres, each around k consecutive
    padded spheres of pb (n, 4) and holding them whole: the centre of their
    float64 box, the radius to the farthest one's far side, then
    `padded`."""
    out = []
    for s0 in range(0, len(pb), k):
        g = pb[s0:s0 + k].astype(np.float64)
        lo = (g[:, :3] - g[:, 3:]).min(0)
        hi = (g[:, :3] + g[:, 3:]).max(0)
        c = (lo + hi) * 0.5
        r = np.max(np.linalg.norm(g[:, :3] - c, axis=-1) + g[:, 3])
        out.append(padded(c[None], np.array([r])))
    return np.concatenate(out + [np.zeros((0, 4), np.float32)])


# bins of a node's centroid span on each axis in `box_tree`'s binned SAH
SAH_BINS = 32


def half_area(lo, hi, axis: int = -1) -> np.ndarray:
    """Half the surface area of boxes [lo, hi], xyz along `axis`; 0 where
    empty (NaN where a face is infinite on both sides)."""
    with np.errstate(invalid="ignore"):
        e = np.moveaxis(np.maximum(hi - lo, 0.0), axis, 0)
    return e[0] * e[1] + e[1] * e[2] + e[2] * e[0]


def _prefix_union(b) -> np.ndarray:
    """The running union of boxes (nb, 6, m) along the first axis (a min
    of the lo rows, a max of the hi rows), in log2(nb) steps."""
    b = b.copy()
    s = 1
    while s < len(b):
        lo = np.minimum(b[s:, :3], b[:-s, :3])
        hi = np.maximum(b[s:, 3:], b[:-s, 3:])
        b[s:, :3], b[s:, 3:] = lo, hi
        s *= 2
    return b


def padded_boxes(lo, hi) -> tuple:
    """float32 boxes around float64 boxes (n, 3): each face moved out by
    CULL_PAD * m, m the box's size (the sum over the axes of the larger of
    |lo| and |hi|, no less than |c|_1 + r of a sphere's box), then rounded
    outward to a float32."""
    m = np.maximum(np.abs(lo), np.abs(hi)).sum(-1, keepdims=True)
    lo, hi = lo - CULL_PAD * m, hi + CULL_PAD * m
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32 > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32 < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def _best_split(blo, bhi, k, seg, m: int, nb: int) -> tuple:
    """The binned SAH's best split of m nodes whose rows (boxes blo, bhi,
    node seg) fall in bins k (rows, 3) of nb a node and axis -> (A_l n_l +
    A_r n_r (m,), its axis, the last bin on its left); inf where no bin
    split has rows on both sides."""
    best = np.full(m, np.inf)
    b_ax = np.zeros(m, np.int64)
    b_j = np.zeros(m, np.int64)
    for a in range(3):
        key = k[:, a] * m + seg
        cnt = np.bincount(key, minlength=m * nb).reshape(nb, m)
        # the bins' boxes, (nb, 6, m): lo x, y, z, then hi x, y, z
        box = np.empty((6, nb * m))
        box[:3], box[3:] = np.inf, -np.inf
        for q in range(3):
            np.minimum.at(box[q], key, blo[:, q])
            np.maximum.at(box[3 + q], key, bhi[:, q])
        box = box.reshape(6, nb, m).transpose(1, 0, 2)
        l_n = np.cumsum(cnt, 0)[:-1]
        r_n = np.cumsum(cnt[::-1], 0)[::-1][1:]
        left, right = _prefix_union(box), _prefix_union(box[::-1])[::-1]
        cost = (half_area(left[:, :3], left[:, 3:], 1)[:-1] * l_n
                + half_area(right[:, :3], right[:, 3:], 1)[1:] * r_n)
        cost = np.where((l_n == 0) | (r_n == 0), np.inf, cost).T
        j = np.argmin(cost, 1)
        c = cost[np.arange(m), j]
        better = c < best
        best = np.where(better, c, best)
        b_ax = np.where(better, a, b_ax)
        b_j = np.where(better, j, b_j)
    return best, b_ax, b_j


def _sah_split(lo, hi):
    """A binary tree over boxes lo, hi (n, 3) float64 down to single rows,
    built top down one level at a time by a binned SAH -> (order, start,
    count, kids, area, level): order (n,) the rows in leaf order; for each
    node its rows order[start: start + count], its two children (-1: a
    row), its box's half area and its depth. A node's rows go left or right
    of the split of its centroids' bins, on any axis, of least A_l n_l +
    A_r n_r (where their centroids are one point: halves), each side in
    order."""
    n = len(lo)
    fin = np.isfinite(lo).all(1) & np.isfinite(hi).all(1)
    flo = lo[fin].min(0) if fin.any() else np.zeros(3)
    fhi = hi[fin].max(0) if fin.any() else np.zeros(3)
    # a row without a finite box counts as the finite rows' box
    glo = np.where(fin[:, None], lo, flo)
    ghi = np.where(fin[:, None], hi, fhi)
    cen = (glo + ghi) * 0.5
    order = np.arange(n)
    start, count = np.zeros(1, np.int64), np.full(1, n, np.int64)
    kids, area = np.full((1, 2), -1, np.int64), np.zeros(1)
    front = np.array([0])
    level, depth = [0], 0
    while len(front):
        st, ct = start[front], count[front]
        m = len(front)
        c0 = np.cumsum(ct) - ct
        idx = np.arange(ct.sum()) + np.repeat(st - c0, ct)
        r = order[idx]
        seg = np.repeat(np.arange(m), ct)
        blo, bhi = glo[r], ghi[r]
        area[front] = half_area(np.minimum.reduceat(blo, c0),
                                np.maximum.reduceat(bhi, c0))
        cr = cen[r]
        clo = np.minimum.reduceat(cr, c0)
        ext = np.maximum.reduceat(cr, c0) - clo
        # bins a node: the power of 2 from twice its rows up to SAH_BINS
        nbn = np.minimum(SAH_BINS, 2 ** np.ceil(np.log2(2 * ct)).astype(
            np.int64))
        with np.errstate(divide="ignore", invalid="ignore"):
            k = np.where(ext[seg] > 0, (cr - clo[seg]) / ext[seg]
                         * nbn[seg, None], 0.0)
        k = np.clip(k, 0, nbn[seg, None] - 1).astype(np.int64)
        best = np.full(m, np.inf)
        b_ax = np.zeros(m, np.int64)
        b_j = np.zeros(m, np.int64)
        for nb in np.unique(nbn):
            on = nbn == nb
            sel = on[seg]
            loc = np.cumsum(on) - 1
            best[on], b_ax[on], b_j[on] = _best_split(
                blo[sel], bhi[sel], k[sel], loc[seg[sel]], int(on.sum()),
                int(nb))
        leaf = ct <= 1
        binned = np.isfinite(best)
        side = np.where(binned[seg], k[np.arange(len(r)), b_ax[seg]]
                        > b_j[seg], np.arange(len(r)) - c0[seg]
                        >= (ct // 2)[seg])
        side &= ~leaf[seg]
        order[idx] = r[np.argsort(seg * 2 + side, kind="stable")]
        n_r = np.bincount(seg, weights=side, minlength=m).astype(np.int64)
        sp = np.nonzero(~leaf)[0]
        ids = len(start) + 2 * np.arange(len(sp))
        kids[front[sp]] = np.stack([ids, ids + 1], -1)
        n_l = ct[sp] - n_r[sp]
        start = np.concatenate([start, np.stack(
            [st[sp], st[sp] + n_l], -1).reshape(-1)])
        count = np.concatenate([count, np.stack([n_l, n_r[sp]],
                                                -1).reshape(-1)])
        kids = np.concatenate([kids, np.full((2 * len(sp), 2), -1)])
        area = np.concatenate([area, np.zeros(2 * len(sp))])
        level += [depth + 1] * (2 * len(sp))
        depth += 1
        front = np.stack([ids, ids + 1], -1).reshape(-1)
    return order, start, count, kids, area, np.asarray(level)


def _collapse(count, kids, area, level, row_cost, node_cost, arity: int):
    """The wide tree of least SAH cost that a binary tree (`_sah_split`)
    holds, by dynamic programming over its nodes from the deepest level up
    (after Ylitie, Karras and Laine, HPG 2017) -> (pick, part): a node
    kept as an entry is a leaf (pick 0; at most UNROLL rows) or has pick
    children, the roots of its two subtrees' best forests of part[node,
    pick] and pick - part[node, pick] entries (a forest of j > 1 entries
    from a node splits likewise at part[node, j]). Costs are weighted by
    the half area of the box where they are paid: a leaf's rows row_cost
    each at its own box, an entry's children node_cost each at its box."""
    nn = len(count)
    inf = np.inf
    g = np.full((nn, arity + 1), inf)    # a subtree as exactly j entries
    pick = np.zeros(nn, np.int64)
    part = np.zeros((nn, arity + 1), np.int64)
    leaf_c = np.where(count <= UNROLL, area * count * row_cost, inf)
    for lv in range(int(level.max()), -1, -1):
        at = np.nonzero(level == lv)[0]
        inner = at[kids[at, 0] >= 0]
        g[at, 1] = leaf_c[at]
        if not len(inner):
            continue
        gl, gr = g[kids[inner, 0]], g[kids[inner, 1]]
        for j in range(2, arity + 1):
            cand = np.stack([gl[:, a] + gr[:, j - a] for a in range(1, j)],
                            -1)
            part[inner, j] = np.argmin(cand, -1) + 1
            g[inner, j] = cand.min(-1)
        as_node = g[inner, 2:] + area[inner, None] * node_cost * np.arange(
            2, arity + 1)
        k = np.argmin(as_node, -1)
        better = as_node[np.arange(len(inner)), k] < g[inner, 1]
        g[inner, 1] = np.where(better, as_node[np.arange(len(inner)), k],
                               g[inner, 1])
        pick[inner] = np.where(better, k + 2, 0)
    return pick, part


def box_tree(lo, hi, row_cost: float, node_cost: float, arity: int) -> tuple:
    """K5's, K6's and K8's cull tree over one class's rows, from each row's
    float64 box lo, hi (n, 3) -> (order, rec): order (n,) the rows in
    table order, rec (entries, 8) float32 the tree laid out depth first,
    an entry [lo.x lo.y lo.z skip | hi.x hi.y hi.z leaf], skip and leaf
    int32 bits: skip the entry after the entry's subtree (class-local),
    leaf first row * UNROLL + rows - 1 of a leaf, in table order, or -1
    above the leaves.

    The binary SAH tree of `_sah_split`, collapsed (`_collapse`) into the
    tree of up to `arity` children a node and leaves of 1 to UNROLL rows of
    least SAH cost at row_cost a row test and node_cost a box test; the
    leaves in depth-first order are the table's order. A leaf's box is its
    rows' float64 box padded (`padded_boxes`), a node's the float32 union
    of its children's: exact, so it holds each whole."""
    n = len(lo)
    if not n:
        return np.zeros(0, np.int64), np.zeros((0, 8), np.float32)
    order, start, count, kids, area, level = _sah_split(lo, hi)
    pick, part = _collapse(count, kids, area, level, row_cost, node_cost,
                           arity)
    start, count, kids = start.tolist(), count.tolist(), kids.tolist()
    pick, part = pick.tolist(), part.tolist()
    first, rows, parent, depth = [], [], [], []

    def forest(u, j):
        if j == 1:
            return [u]
        a = part[u][j]
        return forest(kids[u][0], a) + forest(kids[u][1], j - a)

    # the entries in depth-first order, children in table order
    todo = [(0, -1, 0)]
    while todo:
        u, up, dep = todo.pop()
        e = len(first)
        first.append(start[u])
        rows.append(0 if pick[u] else count[u])
        parent.append(up)
        depth.append(dep)
        if pick[u]:
            a = part[u][pick[u]]
            ch = forest(kids[u][0], a) + forest(kids[u][1], pick[u] - a)
            todo += [(c, e, dep + 1) for c in reversed(ch)]
    first, rows = np.asarray(first), np.asarray(rows)
    parent, depth = np.asarray(parent), np.asarray(depth)
    is_leaf = rows > 0
    blo = np.minimum.reduceat(lo[order], first[is_leaf])
    bhi = np.maximum.reduceat(hi[order], first[is_leaf])
    elo = np.full((len(first), 3), np.inf, np.float32)
    ehi = np.full((len(first), 3), -np.inf, np.float32)
    elo[is_leaf], ehi[is_leaf] = padded_boxes(blo, bhi)
    # each subtree's entries and box, from the deepest level up
    size = np.ones(len(first), np.int64)
    for dep in range(int(depth.max()), 0, -1):
        at = np.nonzero(depth == dep)[0]
        np.add.at(size, parent[at], size[at])
        np.minimum.at(elo, parent[at], elo[at])
        np.maximum.at(ehi, parent[at], ehi[at])
    skip = np.arange(len(first)) + size
    ints = np.stack([skip, np.where(
        is_leaf, first * UNROLL + rows - 1, -1)], -1).astype(np.int32)
    rec = np.concatenate([elo, ints[:, :1].view(np.float32), ehi,
                          ints[:, 1:].view(np.float32)], -1)
    return order, rec
