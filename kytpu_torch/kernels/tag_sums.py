"""The sums by tag that K3, K4, K7 and K8 share: the host side of
csrc/tag_sums.cu (`tag_sort`, a stable int32 radix sort of the tags, and
`seg_sums`, the sums of each tag's sorted entries in pieces) and their
plain versions (`sort_tags`, `segment_sums_plain`), the same bits.
"""

from __future__ import annotations

import torch

from kytpu_torch.kernels.launch import on_card, run
from kytpu_torch.utils import profiling as kprof


# the segment sums' block and piece (csrc/tag_sums.cu SEG_THREADS, SEG_PIECE):
# a block sums SEG_PIECE sorted entries of one tag, and a tag's pieces are
# added in order
SEG_THREADS = 512
SEG_PIECE = 4096


def sort_tags(tags: torch.Tensor, m_rows: int, mask: int = -1):
    """The entries (plane j, lane i) of (J, N) integer tags, numbered
    j * N + i, sorted by tag & mask (a stable sort of integer keys: each
    tag's entries stay in plane, then lane order) -> (perm, starts): tag m's
    entries are perm[starts[m]:starts[m + 1]], tag 0 the entries that go
    nowhere. K7 and K8 tag by row + 1 (bits 0-19 of the int plane), K3's
    and K4's texel entries by texel + 1. The plain version of `tag_sort`'s
    kernel: torch.sort(stable=True), whose permutation the kernel gives to
    the last index."""
    ids = tags.reshape(-1).long() & mask
    _, perm = torch.sort(ids, stable=True)
    counts = torch.bincount(ids, minlength=m_rows + 1)
    starts = torch.zeros(m_rows + 2, dtype=torch.int64, device=ids.device)
    starts[1:] = torch.cumsum(counts, 0)
    return perm, starts


def entry_values(dout, ent, n: int, B: int, PB: int):
    """The PB adjoint columns of entries `ent` (any shape): dout's planes
    PB*b .. PB*b+PB-1 at lane i for b < B; for b = B (K7's and K8's
    horizon) 0, except de (columns 6-8) from its three planes."""
    b = ent // n
    lane = ent - b * n
    col = torch.arange(PB, device=dout.device)
    plane = torch.where(b[..., None] < B, PB * b[..., None] + col,
                        PB * B + (col - 6).clamp(0, 2))
    v = dout[plane, lane[..., None]]
    keep = (b[..., None] < B) | ((col >= 6) & (col < 9))
    return torch.where(keep, v, torch.zeros_like(v))


def seg_pieces(starts):
    """The segment sums' pieces of the sorted entries (csrc/tag_sums.cu):
    tag m >= 1's entries cut into pieces of SEG_PIECE -> (piece_start (M +
    1,): tag m's pieces start at piece_start[m - 1], piece_start[M] the
    pieces in all; each piece's first sorted place and length)."""
    S = SEG_PIECE
    starts = starts.long()
    lens = starts[2:] - starts[1:-1]
    n_pc = (lens + S - 1) // S
    piece_start = torch.zeros(len(lens) + 1, dtype=torch.int64,
                              device=starts.device)
    piece_start[1:] = torch.cumsum(n_pc, 0)
    tag = torch.repeat_interleave(torch.arange(len(lens), device=starts.device),
                                  n_pc)
    first = starts[1 + tag] + (torch.arange(len(tag), device=starts.device)
                               - piece_start[tag]) * S
    return piece_start, first, torch.minimum(first + S, starts[2 + tag]) - first


def segment_sums_plain(dout, perm, starts, n: int, B: int, PB: int):
    """(M, PB) sums by tag, in the segment-sum kernels' order: each tag's
    sorted entries (m >= 1) cut into pieces of SEG_PIECE (`seg_pieces`); in
    each piece, thread t of a SEG_THREADS block adds its entries t, t +
    SEG_THREADS, ... in turn (from 0.0), then the threads reduce as a tree
    (off = SEG_THREADS/2 .. 1); then each tag's pieces are added in order
    from 0.0. The same float additions in the same order as
    csrc/tag_sums.cu."""
    T = SEG_THREADS
    M = len(starts) - 2
    piece_start, first, plen = seg_pieces(starts)
    perm = perm.long()
    acc = dout.new_zeros((len(first), T, PB))
    tid = torch.arange(T, device=dout.device)
    for s0 in range(0, SEG_PIECE, T):
        rows = (plen > s0).nonzero().reshape(-1)
        if not len(rows):
            break
        pos = first[rows][:, None] + s0 + tid
        valid = (s0 + tid) < plen[rows][:, None]
        ent = perm[pos.clamp_max(len(perm) - 1)]
        vals = entry_values(dout, ent, n, B, PB)
        acc[rows] = acc[rows] + torch.where(valid[..., None], vals,
                                            torch.zeros_like(vals))
    off = T // 2
    while off:
        acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    part = acc[:, 0]
    n_pc = piece_start[1:] - piece_start[:-1]
    out = dout.new_zeros((M, PB))
    for j in range(int(n_pc.max()) if M else 0):
        rows = (n_pc > j).nonzero().reshape(-1)
        out[rows] = out[rows] + part[piece_start[rows] + j]
    return out


def tag_sort(tags: torch.Tensor, m_tags: int, mask: int = -1):
    """`sort_tags`' stable sort of the int32 tags & mask, each in [0,
    m_tags]: CUDA tags launch csrc/tag_sums.cu's radix sort -> (perm, starts)
    int32, or raise; CPU tags run `sort_tags`."""
    with kprof.kernel("tag_sort"):
        if not on_card(tags.device):
            return sort_tags(tags, m_tags, mask)
        return _launch_sort(tags, m_tags, mask)


def _launch_sort(tags: torch.Tensor, m_tags: int, mask: int):
    """`tag_sort` on CUDA tags."""
    from kytpu_torch.kernels import build

    if tags.dtype != torch.int32:
        raise ValueError(f"tags must be int32, got {tags.dtype}")
    tags = tags.contiguous()
    dev, E = tags.device, tags.numel()
    lib = build.load()
    perm = torch.empty((E,), dtype=torch.int32, device=dev)
    starts = torch.empty((m_tags + 2,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(1, lib.kytpu_tag_sort_scratch(E, m_tags)),),
                          dtype=torch.int32, device=dev)
    run(lib.kytpu_tag_sort, "tag_sort", "tag_sort", dev, tags.data_ptr(),
        mask, E, m_tags, perm.data_ptr(), starts.data_ptr(),
        scratch.data_ptr(), scratch.numel())
    return perm, starts


def seg_sums(dout, perm, starts, n: int, B: int, PB: int):
    """`segment_sums_plain`'s (M, PB) sums by tag of the entries of dout's
    planes: CUDA tensors (int32 perm and starts from `tag_sort`) launch
    csrc/tag_sums.cu's segment sums, the same bits, or raise; CPU tensors
    run `segment_sums_plain`."""
    with kprof.kernel("segment_sums"):
        if not on_card(dout.device):
            return segment_sums_plain(dout, perm, starts, n, B, PB)
        return _launch_seg(dout, perm, starts, n, B, PB)


def _launch_seg(dout, perm, starts, n: int, B: int, PB: int):
    """`seg_sums` on CUDA tensors."""
    from kytpu_torch.kernels import build

    for name, t, dt in (("dout", dout, torch.float32),
                        ("perm", perm, torch.int32),
                        ("starts", starts, torch.int32)):
        if t.dtype != dt or t.device != dout.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} on "
                             f"{dout.device}")
    dev, E, M = dout.device, perm.numel(), len(starts) - 2
    pieces = -(-E // SEG_PIECE) + M
    piece_start = torch.empty((M + 1,), dtype=torch.int32, device=dev)
    part = torch.empty((max(1, pieces), PB), dtype=torch.float32, device=dev)
    out = torch.empty((M, PB), dtype=torch.float32, device=dev)
    run(build.load().kytpu_segment_sums, "segment_sums", "segment_sums",
        dev, dout.data_ptr(), perm.data_ptr(), starts.data_ptr(),
        piece_start.data_ptr(), part.data_ptr(), max(1, pieces),
        out.data_ptr(), n, E, M, B, PB)
    return out


def segment_sums(dout, tags, m_tags: int, n_planes: int, n_cols: int,
                 mask: int = -1):
    """Tagged entries summed by tag & mask: the stable sort of the
    (n_planes [+ 1], n) tags (`tag_sort`), then the segment sums
    (`seg_sums`) -> (m_tags, n_cols), in `segment_sums_plain`'s order; on
    the card, kernels only."""
    perm, starts = tag_sort(tags, m_tags, mask)
    return seg_sums(dout, perm, starts, dout.shape[1], n_planes, n_cols)
