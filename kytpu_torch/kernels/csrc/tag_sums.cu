// The sums by tag that finish the row-tagged backwards, for NVIDIA Hopper
// (sm_90a): a stable sort of int32 tags and the fixed-order segment sums of
// the tagged entries.
//
// Replaces the segment sum that follows kytpu's big-scene cache backward
// (kytpu/kernels/bigscene.py::_bwd, jax.ops.segment_sum over the row-tagged
// planes that _make_res_bwd_kernel writes) and the in-kernel sums by texel of
// kytpu's K3 and K4. Here K7 and K8 (bigscene_bwd_res.cu, bigscene_fwd.cu),
// K3 and K4 past DENSE_MAX_ROWS surfaces (wavefront_bwd_res.cu,
// wavefront_fwd.cu) and every texel-tagged entry of K3, K4, K7 and K8 go
// through it. Its plain PyTorch versions are
// kytpu_torch/kernels/wavefront.py::sort_tags (torch.sort(stable=True)) and
// ::segment_sums_plain (the same float additions in the same order);
// chip_smoke.py holds each kernel against them bit for bit.
//
// The tag sort (kytpu_tag_sort). An entry e = j * n + i (tag plane j, lane i)
// has the key tags[e] & mask, in [0, m_tags]; the output is the stable order
// perm (int32: entries of one tag in index order) and starts (int32, m_tags +
// 2: tag m's entries are perm[starts[m] .. starts[m + 1])). A least
// significant digit radix sort over only the bits m_tags needs, in passes of
// at most DIGIT_BITS bits (the bits split evenly; one pass for up to 2,047
// tags, two for the texel tags), each pass three steps:
//   1. tag_hist_kernel: each tile of SORT_TILE entries counts its digits in
//      shared memory (one add a run of equal digits in a warp,
//      __match_any_sync) into a (digit, tile) table;
//   2. an exclusive scan of that table (scan_reduce, scan_top, scan_down):
//      entry (d, t) becomes the first place of tile t's digit-d entries;
//   3. tag_scatter_kernel: a tile's SORT_WARPS warps take its entries in
//      rounds of SORT_THREADS, entry i of the tile to thread i % SORT_THREADS
//      of round i / SORT_THREADS. Each warp ranks its 32 entries among equal
//      digits (__match_any_sync, __popc(peers & lanemask_lt)), and the warps
//      add their runs to the tile's shared-memory digit counters in warp
//      order, so entries keep their order within a digit: the sort is stable
//      by construction, and a stable sort is unique, so perm is
//      torch.sort(stable=True)'s to the last index.
// One pass's table gives starts directly (digit = tag); past one pass the
// last writes the sorted keys, and tag_bounds_kernel finds each tag's first
// place. Keys stay int32 throughout, the mask is applied as they are read
// (no masked or widened copy), and no float moves.
//
// The segment sums (kytpu_segment_sums). The sorted entries of each tag m =
// 1 .. M are cut into pieces of SEG_PIECE entries (seg_pieces_kernel: a scan
// of ceil(len / SEG_PIECE) on the device, so the host never waits), and one
// block of SEG_THREADS threads sums each piece (seg_piece_kernel): thread t
// adds the piece's entries t, t + SEG_THREADS, ... in turn from 0.0, then a
// shared-memory tree, into one row of a (pieces, PB) table; seg_finish_kernel
// adds each tag's pieces in order from 0.0. The grid is sized for the most
// pieces the entries can make (ceil(E / SEG_PIECE) + M), the surplus blocks
// return at once. So the ground row of a big scene, a large share of all
// entries, spreads over hundreds of blocks, where one block summed it alone
// before; the order of additions depends only on the sort and SEG_PIECE, and
// the sums repeat to the last bit. No float atomics. Entry e = b * n + i is
// bounce b of lane i: PB columns dout[PB * b + c][i] below B, and at b = B
// (K7's and K8's horizon) only de (columns 6-8) from dout[PB * B + c - 6][i].
//
// What bounds it on the H100: bytes. The sort reads each key once a pass and
// writes perm; the scatter's writes land in one run a digit a tile. The sums
// read each tagged entry's PB floats once, in index order within a tag, and
// the int32 perm. Built with --fmad=false (no multiply here to fuse).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SORT_THREADS = 256;
constexpr int SORT_ITEMS = 16;
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int DIGIT_BITS = 11;
constexpr int MAX_BINS = 1 << DIGIT_BITS;
constexpr int SCAN_THREADS = 1024, SCAN_ITEMS = 4, SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;
constexpr int SEG_THREADS = 512;  // SEG_THREADS in wavefront.py
constexpr int SEG_PIECE = 4096;   // SEG_PIECE in wavefront.py
constexpr int MAX_PASSES = 3;     // 33 bits: every int32 tag
static_assert(SEG_PIECE % SEG_THREADS == 0, "a piece is whole rounds of the block");
static_assert(SCAN_THREADS == 32 * 32, "the block scan's second level is one warp");

// one pass of the radix sort: the digit is bits shift .. shift + width - 1 of
// the key, of which `bins` values occur
struct Pass {
  int shift, width, bins;
};

__device__ __forceinline__ int digit_of(int key, Pass p) {
  const int d = (key >> p.shift) & ((1 << p.width) - 1);
  return d < p.bins ? d : p.bins - 1;
}

// Block-wide exclusive scan of data[0 .. len) (len <= SCAN_CHUNK) in place,
// carry added to every entry; returns the chunk's total (carry not
// included). Thread t holds entries t * SCAN_ITEMS .. + SCAN_ITEMS - 1. Every
// thread of a SCAN_THREADS block must call it.
__device__ int block_scan(int* data, int len, int carry) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = j0 + k < len ? data[j0 + k] : 0;
    s += v[k];
  }
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  int ex = carry + (warp ? warp_tot[warp - 1] : 0) + x - s;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (j0 + k < len) data[j0 + k] = ex;
    ex += v[k];
  }
  const int total = warp_tot[31];
  __syncthreads();
  return total;
}

// 1. tile blockIdx.x's digit counts -> table[d * n_tiles + tile]
__global__ void __launch_bounds__(SORT_THREADS)
tag_hist_kernel(const int* __restrict__ keys, int mask, int E, Pass p, int n_tiles,
                int* __restrict__ table) {
  __shared__ int cnt[MAX_BINS];
  for (int d = threadIdx.x; d < p.bins; d += SORT_THREADS) cnt[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * SORT_TILE;
#pragma unroll 4
  for (int r = 0; r < SORT_ITEMS; ++r) {
    const int i = base + r * SORT_THREADS + threadIdx.x;
    const bool ok = i < E;
    const int d = ok ? digit_of(__ldg(keys + i) & mask, p) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < p.bins; d += SORT_THREADS)
    table[(size_t)d * n_tiles + blockIdx.x] = cnt[d];
}

// 2a. each SCAN_CHUNK of the table summed -> bsum[blockIdx.x]
__global__ void __launch_bounds__(SCAN_THREADS)
scan_reduce_kernel(const int* __restrict__ table, int len, int* __restrict__ bsum) {
  __shared__ int warp_tot[32];
  const int j0 = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) s += j0 + k < len ? table[j0 + k] : 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = warp_tot[threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) bsum[blockIdx.x] = s;
  }
}

// 2b. the chunk sums scanned in place (one block)
__global__ void __launch_bounds__(SCAN_THREADS) scan_top_kernel(int* bsum, int nb) {
  int carry = 0;
  for (int c0 = 0; c0 < nb; c0 += SCAN_CHUNK)
    carry += block_scan(bsum + c0, nb - c0 < SCAN_CHUNK ? nb - c0 : SCAN_CHUNK, carry);
}

// 2c. each chunk scanned in place from its chunk's offset
__global__ void __launch_bounds__(SCAN_THREADS)
scan_down_kernel(int* table, int len, const int* __restrict__ bsum) {
  const int c0 = blockIdx.x * SCAN_CHUNK;
  block_scan(table + c0, len - c0 < SCAN_CHUNK ? len - c0 : SCAN_CHUNK, bsum[blockIdx.x]);
}

// 3. tile blockIdx.x's entries to their places: vals_out[place] = the entry's
// value (its index in the first pass, FIRST), keys_out[place] = its key
// (KEYS)
template <bool FIRST, bool KEYS>
__global__ void __launch_bounds__(SORT_THREADS)
tag_scatter_kernel(const int* __restrict__ keys, const int* __restrict__ vals, int mask, int E,
                   Pass p, int n_tiles, const int* __restrict__ table, int* __restrict__ keys_out,
                   int* __restrict__ vals_out) {
  __shared__ int cnt[MAX_BINS];
  const int tile = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < p.bins; d += SORT_THREADS)
    cnt[d] = __ldg(table + (size_t)d * n_tiles + tile);
  __syncthreads();
  const unsigned lanes_lt = (1u << lane) - 1u;
  for (int r = 0; r < SORT_ITEMS; ++r) {
    const int i = tile * SORT_TILE + r * SORT_THREADS + threadIdx.x;
    const bool ok = i < E;
    int key = 0, val = 0, d = -1;
    if (ok) {
      key = __ldg(keys + i) & mask;
      val = FIRST ? i : __ldg(vals + i);
      d = digit_of(key, p);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    // the warps take their runs in warp order: entries keep their order
    for (int w = 0; w < SORT_WARPS; ++w) {
      if (warp == w && ok && lane == leader) {
        base = cnt[d];
        cnt[d] = base + __popc(peers);
      }
      __syncthreads();
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    if (ok) {
      const int at = base + __popc(peers & lanes_lt);
      vals_out[at] = val;
      if (KEYS) keys_out[at] = key;
    }
  }
}

// one pass: starts[m] = the scanned table's (m, tile 0), starts[m_tags + 1] = E
__global__ void tag_starts_kernel(const int* __restrict__ table, int n_tiles, int m_tags, int E,
                                  int* __restrict__ starts) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m <= m_tags) starts[m] = table[(size_t)m * n_tiles];
  else if (m == m_tags + 1) starts[m] = E;
}

// past one pass: from the sorted keys, starts[k] = the first place of a key
// >= k, for every k in 0 .. m_tags + 1 (each written by one thread)
__global__ void tag_bounds_kernel(const int* __restrict__ sorted, int E, int m_tags,
                                  int* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > E) return;
  const int prev = i > 0 ? sorted[i - 1] : -1;
  const int cur = i < E ? sorted[i] : m_tags + 1;
  for (int k = prev + 1; k <= cur; ++k) starts[k] = i;
}

// the passes for keys in [0, m_tags] -> their number (the sort's tiles, digits
// and passes are mirrored in tests/test_torch_tag_sums.py)
int sort_plan(int m_tags, Pass* passes) {
  int bits = 1;
  while (bits < 31 && (m_tags >> bits) != 0) ++bits;
  const int np = (bits + DIGIT_BITS - 1) / DIGIT_BITS;
  const int width = (bits + np - 1) / np;
  for (int q = 0; q < np; ++q) {
    const int shift = q * width;
    const int w = bits - shift < width ? bits - shift : width;
    const int top = (m_tags >> shift) + 1;
    passes[q] = Pass{shift, w, top < (1 << w) ? top : (1 << w)};
  }
  return np;
}

size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }

// the int32 scratch of one sort: the (digit, tile) table, its chunk sums and,
// past one pass, the keys and values between passes
size_t sort_scratch(int E, int m_tags, Pass* passes, int* np) {
  *np = sort_plan(m_tags, passes);
  int bins = 1;
  for (int q = 0; q < *np; ++q) bins = passes[q].bins > bins ? passes[q].bins : bins;
  const size_t table = (size_t)bins * cdiv(E, SORT_TILE);
  const size_t between = *np == 1 ? 0 : (*np == 2 ? 3 : 4) * (size_t)E;
  return table + cdiv(table, SCAN_CHUNK) + between;
}

// 1. piece_start[m] = the first piece of tag m + 1 (m < M), piece_start[M] =
// the pieces in all (one block)
__global__ void __launch_bounds__(SCAN_THREADS)
seg_pieces_kernel(const int* __restrict__ starts, int M, int* piece_start) {
  int carry = 0;
  for (int c0 = 0; c0 <= M; c0 += SCAN_CHUNK) {
    const int len = M + 1 - c0 < SCAN_CHUNK ? M + 1 - c0 : SCAN_CHUNK;
    for (int j = threadIdx.x; j < len; j += SCAN_THREADS) {
      const int m = c0 + j;
      piece_start[m] = m < M ? (starts[m + 2] - starts[m + 1] + SEG_PIECE - 1) / SEG_PIECE : 0;
    }
    __syncthreads();
    carry += block_scan(piece_start + c0, len, carry);
  }
}

// 2. piece blockIdx.x summed -> part[piece, 0 .. PB)
template <int PB>
__global__ void __launch_bounds__(SEG_THREADS)
seg_piece_kernel(const float* __restrict__ dout, const int* __restrict__ perm,
                 const int* __restrict__ starts, const int* __restrict__ piece_start,
                 float* __restrict__ part, int n, int M, int B) {
  __shared__ float s[SEG_THREADS];
  const int p = blockIdx.x;
  if (p >= __ldg(piece_start + M)) return;
  // its tag: the last m with piece_start[m] <= p
  int lo = 0, hi = M - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(piece_start + mid) <= p) lo = mid;
    else hi = mid - 1;
  }
  const int e0 = __ldg(starts + lo + 1) + (p - __ldg(piece_start + lo)) * SEG_PIECE;
  const int end = __ldg(starts + lo + 2);
  const int e1 = e0 + SEG_PIECE < end ? e0 + SEG_PIECE : end;
  float a[PB];
#pragma unroll
  for (int c = 0; c < PB; ++c) a[c] = 0.f;
  for (int j = e0 + threadIdx.x; j < e1; j += SEG_THREADS) {
    const int e = __ldg(perm + j);
    const int b = e / n;
    const int lane = e - b * n;
    if (b < B) {
#pragma unroll
      for (int c = 0; c < PB; ++c) a[c] = a[c] + __ldg(dout + (size_t)(PB * b + c) * n + lane);
    } else if constexpr (PB >= 9) {
#pragma unroll
      for (int c = 6; c < 9; ++c) a[c] = a[c] + __ldg(dout + (size_t)(PB * B + c - 6) * n + lane);
    }
  }
#pragma unroll
  for (int c = 0; c < PB; ++c) {
    s[threadIdx.x] = a[c];
    __syncthreads();
    for (int off = SEG_THREADS / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + off];
      __syncthreads();
    }
    if (threadIdx.x == 0) part[(size_t)p * PB + c] = s[0];
    __syncthreads();
  }
}

// 3. out[m, c] = tag m + 1's pieces added in order from 0.0; a warp a tag,
// lane c a column
__global__ void __launch_bounds__(256)
seg_finish_kernel(const float* __restrict__ part, const int* __restrict__ piece_start,
                  float* __restrict__ out, int M, int PB) {
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5), c = threadIdx.x & 31;
  if (m >= M || c >= PB) return;
  float s = 0.f;
  for (int j = __ldg(piece_start + m); j < __ldg(piece_start + m + 1); ++j)
    s = s + __ldg(part + (size_t)j * PB + c);
  out[(size_t)m * PB + c] = s;
}

template <int PB>
void launch_pieces(int blocks, const float* dout, const int* perm, const int* starts,
                   const int* piece_start, float* part, int n, int M, int B, cudaStream_t st) {
  seg_piece_kernel<PB><<<blocks, SEG_THREADS, 0, st>>>(dout, perm, starts, piece_start, part, n,
                                                       M, B);
}

}  // namespace

// The int32 scratch kytpu_tag_sort needs for E entries of keys in [0,
// m_tags] (no CUDA call).
extern "C" long long kytpu_tag_sort_scratch(int E, int m_tags) {
  Pass passes[MAX_PASSES];
  int np = 0;
  return (long long)sort_scratch(E, m_tags, passes, &np);
}

// The stable sort of the E int32 keys tags[e] & mask (each in [0, m_tags]) on
// `stream` -> perm (E,) int32, starts (m_tags + 2,) int32, through `scratch`
// (scratch_len ints, at least kytpu_tag_sort_scratch). Returns
// cudaGetLastError() (or cudaErrorInvalidValue for what it does not take).
extern "C" int kytpu_tag_sort(const int* tags, int mask, int E, int m_tags, int* perm, int* starts,
                              int* scratch, long long scratch_len, void* stream) {
  Pass passes[MAX_PASSES];
  int np = 0;
  if (E < 0 || m_tags < 0 || (size_t)scratch_len < sort_scratch(E, m_tags, passes, &np))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (E == 0) {
    tag_bounds_kernel<<<1, 32, 0, st>>>(nullptr, 0, m_tags, starts);
    return (int)cudaGetLastError();
  }
  const int n_tiles = (int)cdiv(E, SORT_TILE);
  int bins = 1;
  for (int q = 0; q < np; ++q) bins = passes[q].bins > bins ? passes[q].bins : bins;
  int* table = scratch;
  int* bsum = table + (size_t)bins * n_tiles;
  int* buf = bsum + cdiv((size_t)bins * n_tiles, SCAN_CHUNK);
  int *k0 = buf, *v0 = buf + E, *k1 = buf + 2 * (size_t)E, *v1 = buf + 3 * (size_t)E;
  const int* keys_in = tags;
  const int* vals_in = nullptr;
  for (int q = 0; q < np; ++q) {
    const Pass p = passes[q];
    const bool first = q == 0, last = q == np - 1;
    const int kmask = first ? mask : -1;
    const int len = p.bins * n_tiles;
    const int nb = (int)cdiv(len, SCAN_CHUNK);
    tag_hist_kernel<<<n_tiles, SORT_THREADS, 0, st>>>(keys_in, kmask, E, p, n_tiles, table);
    scan_reduce_kernel<<<nb, SCAN_THREADS, 0, st>>>(table, len, bsum);
    scan_top_kernel<<<1, SCAN_THREADS, 0, st>>>(bsum, nb);
    scan_down_kernel<<<nb, SCAN_THREADS, 0, st>>>(table, len, bsum);
    int* keys_out = q % 2 ? k1 : k0;
    int* vals_out = last ? perm : (q % 2 ? v1 : v0);
    if (first && last)
      tag_scatter_kernel<true, false><<<n_tiles, SORT_THREADS, 0, st>>>(
          keys_in, vals_in, kmask, E, p, n_tiles, table, nullptr, vals_out);
    else if (first)
      tag_scatter_kernel<true, true><<<n_tiles, SORT_THREADS, 0, st>>>(
          keys_in, vals_in, kmask, E, p, n_tiles, table, keys_out, vals_out);
    else
      tag_scatter_kernel<false, true><<<n_tiles, SORT_THREADS, 0, st>>>(
          keys_in, vals_in, kmask, E, p, n_tiles, table, keys_out, vals_out);
    if (last && np == 1)
      tag_starts_kernel<<<(m_tags + 2 + 255) / 256, 256, 0, st>>>(table, n_tiles, m_tags, E,
                                                                   starts);
    else if (last)
      tag_bounds_kernel<<<(int)cdiv((size_t)E + 1, 256), 256, 0, st>>>(keys_out, E, m_tags,
                                                                      starts);
    keys_in = keys_out;
    vals_in = vals_out;
  }
  return (int)cudaGetLastError();
}

// The tagged entries summed by tag on `stream`: for each tag m = 1 .. M, its
// entries perm[starts[m] .. starts[m + 1]) (perm, starts from kytpu_tag_sort,
// E entries) -> out (M, PB), through piece_start (M + 1,) int32 and part
// (max_pieces, PB) float scratch, max_pieces = ceil(E / SEG_PIECE) + M.
// PB is 3 (texel entries), 9 or 10 (row-tagged planes). Returns
// cudaGetLastError() (or cudaErrorInvalidValue for what it does not take).
extern "C" int kytpu_segment_sums(const float* dout, const int* perm, const int* starts,
                                  int* piece_start, float* part, long long max_pieces,
                                  float* out, int n, int E, int M, int B, int PB, void* stream) {
  if ((PB != 3 && PB != 9 && PB != 10) || M < 0 || E < 0 || (n <= 0 && E > 0) ||
      max_pieces < (long long)cdiv(E, SEG_PIECE) + M)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (int)(max_pieces > 0 ? max_pieces : 1);
  seg_pieces_kernel<<<1, SCAN_THREADS, 0, st>>>(starts, M, piece_start);
  if (PB == 3)
    launch_pieces<3>(blocks, dout, perm, starts, piece_start, part, n, M, B, st);
  else if (PB == 9)
    launch_pieces<9>(blocks, dout, perm, starts, piece_start, part, n, M, B, st);
  else
    launch_pieces<10>(blocks, dout, perm, starts, piece_start, part, n, M, B, st);
  seg_finish_kernel<<<(M + 7) / 8, 256, 0, st>>>(part, piece_start, out, M, PB);
  return (int)cudaGetLastError();
}
