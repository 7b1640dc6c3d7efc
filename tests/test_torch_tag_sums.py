"""The sums by tag that finish K3, K4, K7 and K8 (csrc/tag_sums.cu), on the
CPU: the radix sort transcribed with torch ops in the kernels' order
(per-tile digit histograms, their exclusive scan, the warp-ranked scatter)
against torch.sort(stable=True), and the split segment sums transcribed as
the kernels' scalar loops against `segment_sums_plain`, bit for bit; both
against float64 sums."""

import numpy as np
import pytest
import torch

from kytpu_torch.kernels import bigscene as kbs
from kytpu_torch.kernels import wavefront as kwf
from kytpu_torch.scene import builders
import tests.torch_threads  # noqa: F401  (one torch thread a process)


# csrc/tag_sums.cu's tile (threads x items) and widest digit
SORT_THREADS = 256
SORT_TILE = 16 * SORT_THREADS
SORT_DIGIT_BITS = 11


def sort_passes(m_tags: int) -> list:
    """csrc/tag_sums.cu's sort_plan: (shift, width, bins) a pass, the digit
    bits shift .. shift + width - 1 of a key in [0, m_tags], `bins` of its
    values possible; the bits m_tags needs split evenly over passes of at
    most SORT_DIGIT_BITS."""
    bits = max(1, int(m_tags).bit_length())
    n_pass = -(-bits // SORT_DIGIT_BITS)
    width = -(-bits // n_pass)
    out = []
    for q in range(n_pass):
        shift = q * width
        w = min(width, bits - shift)
        out.append((shift, w, min(1 << w, (m_tags >> shift) + 1)))
    return out


def radix_sort_transcribed(tags, m_tags: int, mask: int = -1):
    """csrc/tag_sums.cu's kytpu_tag_sort in torch ops -> (perm, starts,
    passes). Each pass: the digits' counts per tile in (digit, tile) order,
    their exclusive scan, then each tile's entries in rounds of SORT_THREADS,
    a round's warps in order, each entry at its run's base (the tile's
    counter for its digit when its warp reached it) plus its rank among the
    equal digits of the lanes before it in its warp."""
    keys = tags.reshape(-1).long() & mask
    E = len(keys)
    W = SORT_THREADS // 32
    R = SORT_TILE // SORT_THREADS
    n_tiles = -(-E // SORT_TILE)
    vals = torch.arange(E)
    passes = sort_passes(m_tags)
    lane = torch.arange(32)
    before = lane[None, :] < lane[:, None]      # [i, j]: lane j before i
    for shift, width, bins in passes:
        d = ((keys >> shift) & ((1 << width) - 1)).clamp_max(bins - 1)
        tile = torch.arange(E) // SORT_TILE
        table = torch.bincount(d * n_tiles + tile, minlength=bins * n_tiles)
        table = torch.cumsum(table, 0) - table
        cnt = table.reshape(bins, n_tiles).T.clone()
        dp = torch.full((n_tiles * SORT_TILE,), -1, dtype=torch.long)
        dp[:E] = d
        dp = dp.reshape(n_tiles, R, W, 32)
        at = torch.empty(n_tiles, R, W, 32, dtype=torch.long)
        for r in range(R):
            for w in range(W):
                dw = dp[:, r, w]
                ok = dw >= 0
                dc = dw.clamp_min(0)
                rank = ((dw[:, :, None] == dw[:, None, :]) & before).sum(-1)
                at[:, r, w] = cnt.gather(1, dc) + rank
                cnt.scatter_add_(1, dc, ok.long())
        at = at.reshape(-1)[:E]
        sorted_keys, sorted_vals = torch.empty_like(keys), torch.empty_like(vals)
        sorted_keys[at] = keys
        sorted_vals[at] = vals
        keys, vals = sorted_keys, sorted_vals
    if len(passes) == 1:
        starts = torch.cat([table.reshape(bins, n_tiles)[:, 0],
                            torch.tensor([E])])
    else:
        starts = torch.searchsorted(keys, torch.arange(m_tags + 2))
    return vals, starts, len(passes)


def segment_sums_scalar(dout, perm, starts, n: int, B: int, PB: int):
    """csrc/tag_sums.cu's kytpu_segment_sums as its threads' scalar loops
    in float32: the piece table, each piece's block (thread t's strided
    adds, the shared-memory tree), each tag's pieces added in order."""
    f32 = np.float32
    dn = dout.numpy()
    perm, starts = perm.tolist(), starts.tolist()
    M, T, S = len(starts) - 2, kwf.SEG_THREADS, kwf.SEG_PIECE
    ps = [0]
    for m in range(M):
        ps.append(ps[-1] + (starts[m + 2] - starts[m + 1] + S - 1) // S)
    part = []
    for p in range(ps[M]):
        lo, hi = 0, M - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if ps[mid] <= p:
                lo = mid
            else:
                hi = mid - 1
        e0 = starts[lo + 1] + (p - ps[lo]) * S
        e1 = min(e0 + S, starts[lo + 2])
        a = [[f32(0.0)] * PB for _ in range(T)]
        for t in range(T):
            for j in range(e0 + t, e1, T):
                e = perm[j]
                b = e // n
                i = e - b * n
                if b < B:
                    for c in range(PB):
                        a[t][c] = f32(a[t][c] + dn[PB * b + c, i])
                elif PB >= 9:
                    for c in range(6, 9):
                        a[t][c] = f32(a[t][c] + dn[PB * B + c - 6, i])
        row = []
        for c in range(PB):
            s = [a[t][c] for t in range(T)]
            off = T // 2
            while off:
                for t in range(off):
                    s[t] = f32(s[t] + s[t + off])
                off //= 2
            row.append(s[0])
        part.append(row)
    out = np.zeros((M, PB), np.float32)
    for m in range(M):
        for c in range(PB):
            s = f32(0.0)
            for j in range(ps[m], ps[m + 1]):
                s = f32(s + part[j][c])
            out[m, c] = s
    return out


def sums_f64(dout, tags, M: int, n: int, B: int, PB: int):
    """The sums by tag in float64, entry by entry."""
    want = np.zeros((M + 1, PB))
    dn = dout.double().numpy()
    ids = tags.reshape(-1).numpy()
    for e, m in enumerate(ids):
        b, i = divmod(e, n)
        if b < B:
            want[m] += dn[PB * b:PB * b + PB, i]
        else:
            want[m, 6:9] += dn[PB * B:PB * B + 3, i]
    return want[1:]


def tag_set(kind: str):
    """(tags (J, n) int32, m_tags, mask, passes expected) of each kind."""
    rng = np.random.default_rng(11)
    if kind == "zeros":
        return np.zeros((3, 5000), np.int32), 6, -1, 1
    if kind == "ground":
        # one tag with 90% of the entries: 13 pieces of SEG_PIECE
        t = rng.integers(1, 40, (3, 20000))
        t[rng.random(t.shape) < 0.9] = 7
        return t.astype(np.int32), 40, -1, 1
    if kind == "rows":
        # K7's row tags: rows 0..1026 in bits 0-19, flags above them
        t = rng.integers(0, 1027, (4, 9000)) | (rng.integers(0, 8, (4, 9000))
                                                << 20)
        return t.astype(np.int32), 1026, kbs.RESI_ROW_MASK, 1
    if kind == "texels":
        t = rng.integers(0, 65537, (12, 9000))
        t[:, ::3] = 0
        return t.astype(np.int32), 65536, -1, 2
    # a ragged last tile: n not a multiple of SORT_TILE
    return rng.integers(0, 300, (3, 1001)).astype(np.int32), 299, -1, 1


@pytest.mark.parametrize("kind", ["zeros", "ground", "rows", "texels",
                                  "ragged"])
def test_radix_sort_is_torch_sort(kind):
    tags, m_tags, mask, n_pass = tag_set(kind)
    tags = torch.from_numpy(tags)
    perm, starts, passes = radix_sort_transcribed(tags, m_tags, mask)
    want_perm, want_starts = kwf.sort_tags(tags, m_tags, mask)
    assert passes == n_pass
    assert torch.equal(perm, want_perm)
    assert torch.equal(starts, want_starts)
    # the CPU wrapper is the plain version
    got = kwf.tag_sort(tags, m_tags, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, (want_perm,
                                                         want_starts)))


@pytest.mark.parametrize("kind,B,PB", [("ground", 2, 9), ("ground", 2, 10),
                                       ("ragged", 3, 3), ("zeros", 2, 9)])
def test_split_segment_sums(kind, B, PB):
    """The kernels' scalar loops = segment_sums_plain to the last bit; both
    within the float tolerance of a float64 sum. The ground tag spans 13
    pieces, so its order is the split one."""
    tags, m_tags, mask, _ = tag_set(kind)
    J, n = tags.shape
    rng = np.random.default_rng(5)
    planes = PB * B + 3 if PB >= 9 else PB * J
    dout = torch.tensor(rng.standard_normal((planes, n)), dtype=torch.float32)
    tags = torch.from_numpy(tags)
    B = B if PB >= 9 else J
    perm, starts = kwf.sort_tags(tags, m_tags, mask)
    got = kwf.seg_sums(dout, perm, starts, n, B, PB)
    want = segment_sums_scalar(dout, perm, starts, n, B, PB)
    assert np.array_equal(got.numpy(), want)
    ref = sums_f64(dout, tags & mask, m_tags, n, B, PB)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    if kind == "ground":
        piece_start, _, _ = kwf.seg_pieces(starts)
        assert int(piece_start[7] - piece_start[6]) > 10


def test_segment_sums_one_piece_as_one_block():
    """A tag of at most SEG_PIECE entries is one block's sum, as before the
    split: thread t's strided adds and the tree, then 0.0 + it."""
    rng = np.random.default_rng(3)
    n = 3000
    dout = torch.tensor(rng.standard_normal((9 * 2 + 3, n)),
                        dtype=torch.float32)
    tags = torch.from_numpy(rng.integers(0, 3, (3, n)).astype(np.int32))
    perm, starts = kwf.sort_tags(tags, 2)
    got = kwf.segment_sums_plain(dout, perm, starts, n, 2, 9)
    vals = kwf._entry_values(dout, perm, n, 2, 9)
    for m in (1, 2):
        seg = vals[starts[m]:starts[m + 1]]
        acc = torch.zeros(kwf.SEG_THREADS, 9)
        for k in range(0, len(seg), kwf.SEG_THREADS):
            chunk = seg[k:k + kwf.SEG_THREADS]
            acc[:len(chunk)] = acc[:len(chunk)] + chunk
        off = kwf.SEG_THREADS // 2
        while off:
            acc[:off] = acc[:off] + acc[off:2 * off]
            off //= 2
        assert torch.equal(got[m - 1], 0.0 + acc[0])


def test_rowtag_k3_takes_the_shared_route(monkeypatch):
    """Past DENSE_MAX_ROWS surfaces K3's lane row (denv, the lights'
    emission, the checker adjoints) fits a shared block; K4 keeps local
    rows there."""
    monkeypatch.setattr(kwf, "DENSE_MAX_ROWS", 0)
    cfg = kwf.KernelConfig(max_depth=2)
    tables = kwf.pack_tables(builders.cornell_box(width=8, height=8), cfg)
    assert kwf.row_tagged(tables.static)
    assert kwf._row_cols(tables, cfg) == 3 + 3 * len(tables.static["lights"])
    assert kwf.acc_route(tables, cfg) == "shared"
    assert kwf.acc_route(tables, cfg, replay=True) == "local"
    monkeypatch.setattr(kwf, "ACC_BUDGET", 0)
    assert kwf.acc_route(tables, cfg) == "local"
