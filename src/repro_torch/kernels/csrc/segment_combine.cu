// Sorted-segment combine for the scatter-combine channel, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/segment_combine.py, segment_combine_pallas
// (the Pallas `_kernel` and `_segmented_scan`). For each row r of
// (rows, E, D) values with sorted segment ids seg[r, :] it computes
//   out[r, s, :] = combine(vals[r, e, :] for seg[r, e] == s),  s in [0, N)
// with the combiner's identity for empty segments; ids outside [0, N)
// are dropped. The combiners: sum, min, max, prod, and min_by_first,
// Boruvka's argmin over column 0 that carries the whole D-wide row of
// the winner (ties: the later entry; an empty segment holds key +inf or
// INT32_MAX and a zero payload, the plain version's identity_like).
//
// Bound: memory, counted on the entries the input needs. Each real id
// and value is read once and each output written once: R * (4 + 4 D)
// + N * 4 D bytes per row for R ids in [0, N). The dropped tail (the
// plan pads each row with id N after its real entries) costs one id per
// tile. One combine per value is far below the card's arithmetic rate.
// min_by_first reads the ids and the key column, and each winner's row
// once more: R * 8 + (winners) * 4 D + N * 4 D bytes.
//
// Design: a flat segmented reduction over entries, not over segments.
//   1. tile_kernel: each block takes one tile of kTile = 256 x 8 entries
//      of a row. A thread loads its 8 entries contiguously (16-byte loads
//      for D = 1), reduces its own runs, and a segmented scan with head
//      flags (warp shuffles, then the 8 warp totals through shared
//      memory) carries runs across threads. A segment that starts and
//      ends inside the tile is written once, by the thread holding its
//      last entry. A segment that crosses a tile boundary leaves a
//      partial instead: the tile's first run (if it continues from the
//      previous tile and ends here) and its last run (if it continues
//      into the next), in a (rows, tiles) scratch table.
//   2. join_kernel: one block per row scans the tiles' last-run partials
//      in tile order (a segmented scan, reset where a run starts inside a
//      tile) and writes each crossing segment where it ends; beside it up
//      to kFillBlocks blocks per row store the marked chunks.
//   Both passes share one block-wide segmented scan (block_seg_scan).
//   Empty segments need no offsets table: the thread holding position p
//   fills the segments strictly between seg[p] and seg[p + 1] (and tile
//   0 those below seg[0]) with the identity. Short gaps are stored by the
//   thread, longer ones by its warp together with 16-byte stores. A gap
//   longer than two chunks of kChunk output elements (a sparse row: a
//   compact id space whose ids end far below N, every id dropped) would
//   keep one warp busy for milliseconds, so the warp stores only its
//   partial head and tail chunks and marks the whole chunks in a (rows,
//   chunks) table; pass 2's fill blocks store every marked chunk, across
//   the card, and clear its mark. The table is zero between launches, and
//   no launch passes anything of its own to the next through it: a launch
//   captured into a CUDA graph and replayed finds the table as a fresh
//   launch does, with no memset and no host-side epoch. A tile
//   whose first id is dropped past N exits after reading it: the tile
//   before it filled up to N. So every output element is written exactly
//   once, with no initialisation pass.
//
// What this does about the previous design (one warp per output
// segment after a CSR offsets pass): no lane idles on a short segment,
// a hub segment is spread over as many tiles as it has entries and
// joined by the light second pass, and the (rows, N + 1) offsets table
// is neither written nor read. No float atomics: the order of every
// combine depends only on positions, so two runs give bit-identical
// results. min, max and int32 sum are exact (int32 sum wraps in two's
// complement, as the plain version); float32 sum differs from a
// sequential order only by reassociation; min and max keep +-inf and
// propagate NaN like torch.minimum/maximum; prod of int32 wraps in two's
// complement and of float32 differs from a sequential order only by
// reassociation. Ids are clamped to [-1, N] before use, so unsorted input
// gives a wrong answer but no out-of-bounds access.
//
// min_by_first as a segmented argmin: the scan value of entry p is one
// 64-bit word, (monotone rank of the key) << 32 | (0xfffffffe - p), and
// the combine is a plain unsigned min. The rank orders float keys as
// their values (-0.0 ties 0.0; a NaN ranks below every key when it opens
// its segment and above every key elsewhere, which is what folding the
// pairwise rule "the later entry if its key <= the earlier's" over the
// segment in position order gives) and int32 keys as themselves; the low
// word makes the later of two equal ranks the smaller word. So the
// combine is commutative and associative and the tiles may meet in any
// order: the writer of a segment decodes the winner's position and
// copies its D values.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Launches of tile_kernel and join_kernel since the library loaded, each
// counted by the kernel itself (block (0, 0)): a launch replayed from a
// captured CUDA graph counts too, which no host-side count can see.
__device__ unsigned long long g_launches[2];

enum Op { kSum = 0, kMin = 1, kMax = 2, kProd = 3, kArgMin = 4 };
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr long long kTile = (long long)kThreads * kItems;
constexpr long long kSmallGap = 8;  // elements a thread fills alone
constexpr long long kChunk = 8192;  // output elements of a chunk fill
constexpr int kFillBlocks = 64;     // chunk-fill blocks per row
constexpr long long kGridRows = 65535;  // gridDim.y
static_assert(kItems % 4 == 0, "16-byte loads of a thread's entries");

template <typename T, int OP>
struct Combine;

template <int OP>
struct Combine<float, OP> {
  static __device__ __forceinline__ float ident() {
    if (OP == kProd) return 1.0f;
    return OP == kSum ? 0.0f : (OP == kMin ? INFINITY : -INFINITY);
  }
  static __device__ __forceinline__ float apply(float a, float b) {
    if (OP == kSum) return a + b;
    if (OP == kProd) return a * b;
    if (OP == kMin) return (a < b || a != a) ? a : b;  // a != a: NaN
    return (a > b || a != a) ? a : b;
  }
};

template <int OP>
struct Combine<int, OP> {
  static __device__ __forceinline__ int ident() {
    if (OP == kProd) return 1;
    return OP == kSum ? 0 : (OP == kMin ? INT_MAX : INT_MIN);
  }
  static __device__ __forceinline__ int apply(int a, int b) {
    if (OP == kSum) return (int)((unsigned)a + (unsigned)b);
    if (OP == kProd) return (int)((unsigned)a * (unsigned)b);
    if (OP == kMin) return a < b ? a : b;
    return a > b ? a : b;
  }
};

// The argmin words of min_by_first (see the header).
template <>
struct Combine<unsigned long long, kMin> {
  static __device__ __forceinline__ unsigned long long ident() {
    return ~0ull;
  }
  static __device__ __forceinline__ unsigned long long apply(
      unsigned long long a, unsigned long long b) {
    return a < b ? a : b;
  }
};

// What a row's entries are scanned as: the value itself, or for
// min_by_first (T the value type) the argmin word under kMin.
template <typename T, int OP>
struct Scan {
  using S = T;
  static constexpr int kOp = OP;
};
template <typename T>
struct Scan<T, kArgMin> {
  using S = unsigned long long;
  static constexpr int kOp = kMin;
};

// Monotone 32-bit rank of a min_by_first key; `opens`: the entry opens
// its segment.
__device__ __forceinline__ int key_rank(float k, bool opens) {
  if (k != k) return opens ? -0x7f800001 : 0x7f800001;  // NaN, past +-inf
  const int b = __float_as_int(k);
  return b >= 0 ? b : -(b & 0x7fffffff);
}
__device__ __forceinline__ int key_rank(int k, bool) { return k; }

template <typename T>
__device__ __forceinline__ unsigned long long argmin_word(T key, long long p,
                                                          bool opens) {
  const unsigned hi = (unsigned)key_rank(key, opens) ^ 0x80000000u;
  return (unsigned long long)hi << 32 | (0xfffffffeu - (unsigned)p);
}

__device__ __forceinline__ long long argmin_pos(unsigned long long w) {
  return 0xfffffffeu - (unsigned)(w & 0xffffffffu);
}

// The identity at output element t of a segment fill: the combiner's,
// or for min_by_first the key's identity in column 0 and a zero payload.
template <typename T, int OP>
__device__ __forceinline__ T fill_at(long long t, int d, T fill) {
  return (OP != kArgMin || t % d == 0) ? fill : T(0);
}

// Write the result `run` of segment sk (column j): the value, or for
// min_by_first the D values of the winning row of v.
template <typename T, int OP>
__device__ __forceinline__ void emit(T* o, const T* v, int sk, int d, int j,
                                     typename Scan<T, OP>::S run) {
  if constexpr (OP == kArgMin) {
    const long long p = argmin_pos(run);
    for (int c = 0; c < d; ++c) o[(long long)sk * d + c] = v[p * d + c];
  } else {
    o[(long long)sk * d + j] = run;
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(int b) {
  T x;
  memcpy(&x, &b, sizeof(T));
  return x;
}

// kItems 4-byte values from p, 16 bytes per load (p 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load4(const T* p, T* x) {
#pragma unroll
  for (int q = 0; q < kItems / 4; ++q) {
    const int4 a = *reinterpret_cast<const int4*>(p + 4 * q);
    x[4 * q] = from_bits<T>(a.x);
    x[4 * q + 1] = from_bits<T>(a.y);
    x[4 * q + 2] = from_bits<T>(a.z);
    x[4 * q + 3] = from_bits<T>(a.w);
  }
}

// Column j of a thread's kItems entries from base; the identity past the
// row. full: all kItems entries lie in the row and 16-byte loads may be
// used.
template <typename T>
__device__ __forceinline__ void load_column(const T* v, long long base,
                                            long long e, int d, int j,
                                            bool full, T ident, T* x) {
  if (full && d == 1) {
    load4<T>(v + base, x);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      x[k] = base + k < e ? v[(base + k) * d + j] : ident;
  }
}

// Segment id of position i as the kernel sees it: -1 below the range, n
// for every dropped id at or past it and for positions past the row.
__device__ __forceinline__ int key_at(const int* s, long long i, long long e,
                                      int n) {
  if (i >= e) return n;
  const int k = s[i];
  return k < 0 ? -1 : (k > n ? n : k);
}

// Identity into o[lo, hi) by `count` threads of which this is `rank`:
// scalar stores up to a 16-byte boundary, then 16-byte stores.
template <typename T>
__device__ void range_fill(T* o, long long lo, long long hi, T ident,
                           int rank, int count) {
  static_assert(sizeof(T) == 4, "4-byte values only");
  const long long mis = ((uintptr_t)(o + lo) >> 2) & 3;
  const long long head = mis ? min(hi - lo, 4 - mis) : 0;
  if (rank < head) o[lo + rank] = ident;
  lo += head;
  int bits;
  memcpy(&bits, &ident, 4);
  const int4 pat = make_int4(bits, bits, bits, bits);
  int4* o4 = reinterpret_cast<int4*>(o + lo);
  const long long nv = (hi - lo) >> 2;
  for (long long t = rank; t < nv; t += count) o4[t] = pat;
  for (long long t = lo + nv * 4 + rank; t < hi; t += count) o[t] = ident;
}

// The identity into o[lo, hi) by `count` threads of which this is
// `rank`: the combiner's (16-byte stores), or min_by_first's per-segment
// pattern (key identity in column 0, zero payload; one 16-byte store a
// segment for D = 4).
template <typename T, int OP>
__device__ void gap_fill(T* o, long long lo, long long hi, int d, T fill,
                         int rank, int count) {
  if (OP != kArgMin || d == 1) {
    range_fill(o, lo, hi, fill, rank, count);
  } else if (d == 4 && lo % 4 == 0 && ((uintptr_t)o & 15) == 0) {
    int bits;
    memcpy(&bits, &fill, 4);
    const int4 row = make_int4(bits, 0, 0, 0);
    int4* o4 = reinterpret_cast<int4*>(o + lo);
    for (long long t = rank; t < (hi - lo) / 4; t += count) o4[t] = row;
  } else {
    for (long long t = lo + rank; t < hi; t += count)
      o[t] = fill_at<T, OP>(t, d, fill);
  }
}

// Block-wide inclusive segmented scan of one (flag, value) a thread, in
// thread order, with carry in front of thread 0:
//   (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2).
// Returns the thread's exclusive prefix (the value of the run that
// reaches it from earlier threads, or the carry) and sets *total to the
// whole block's result, the carry of what follows. Every thread calls it.
template <typename T, int OP>
__device__ __forceinline__ T block_seg_scan(T val, int flag, T carry,
                                            T* total) {
  using C = Combine<T, OP>;
  __shared__ T warp_val[kWarps];
  __shared__ int warp_flag[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = val;
  int finc = flag;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T ov = __shfl_up_sync(kFull, inc, off);
    const int of = __shfl_up_sync(kFull, finc, off);
    if (lane >= off) {
      if (!finc) inc = C::apply(ov, inc);
      finc |= of;
    }
  }
  const T ex = __shfl_up_sync(kFull, inc, 1);
  const int fex = __shfl_up_sync(kFull, finc, 1);
  if (lane == 31) {
    warp_val[warp] = inc;
    warp_flag[warp] = finc;
  }
  __syncthreads();
  T pre = carry, tot = carry;  // the earlier warps' trailing run, in order
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = tot;
    tot = warp_flag[w] ? warp_val[w] : C::apply(tot, warp_val[w]);
  }
  if (lane > 0) pre = fex ? ex : C::apply(pre, ex);
  __syncthreads();  // warp_val is reused by the next call
  *total = tot;
  return pre;
}

// Pass 1: one tile of one row. meta[row, tile] = (key of the tile's
// first run if that run continues from the previous tile and ends here,
// else -1; 1 if the tile's last run starts inside the tile or does not
// continue into the next, else 0). part[row, tile, 0, :] = that first
// run's value, part[row, tile, 1, :] = the last run's value.
template <typename T, int OP>
__device__ __forceinline__ void tile_row(
    const T* __restrict__ vals, const int* __restrict__ seg,
    T* __restrict__ out, int2* __restrict__ meta,
    typename Scan<T, OP>::S* __restrict__ part,
    unsigned* __restrict__ chunks, long long e, int n, int d,
    long long ntiles, long long nchunks, int vec, long long row) {
  using S = typename Scan<T, OP>::S;
  using C = Combine<S, Scan<T, OP>::kOp>;
  const long long tile = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  if (row == 0 && tile == 0 && tid == 0) atomicAdd(&g_launches[0], 1ull);
  const int* s = seg + row * e;
  const T* v = vals + row * e * d;
  T* o = out + row * (long long)n * d;
  const int cols = OP == kArgMin ? 1 : d;  // columns scanned
  const long long cell = row * ntiles + tile;
  S* hpart = part + cell * 2 * cols;
  S* tpart = hpart + cols;
  const long long t0 = tile * kTile;
  const S ident = C::ident();
  const T fill = Combine<T, OP == kArgMin ? kMin : OP>::ident();

  const int first = key_at(s, t0, e, n);
  if (first == n && t0 > 0) {  // dropped tail: the tile before filled to n
    if (tid == 0) meta[cell] = make_int2(-1, 1);
    return;
  }
  const int before = t0 == 0 ? -2 : key_at(s, t0 - 1, e, n);
  const int last = key_at(s, t0 + kTile - 1, e, n);
  const int after = key_at(s, t0 + kTile, e, n);
  const bool cont = before == first;  // the first run began in a tile before

  const long long base = t0 + (long long)tid * kItems;
  const bool full = vec && base + kItems <= e;
  int key[kItems];
  if (full) {
    load4<int>(s + base, key);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      key[k] = key[k] < 0 ? -1 : (key[k] > n ? n : key[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) key[k] = key_at(s, base + k, e, n);
  }
  T xt[kItems];  // column 0's values, in flight while the gaps are filled
  load_column(v, base, e, d, 0, full, fill, xt);
  const int prev = tid == 0 ? before : key_at(s, base - 1, e, n);
  const int next = key_at(s, base + kItems, e, n);
  // bit k: a run starts (in this block's scan) / a segment opens / a run
  // ends at entry k
  unsigned head = 0, opens = 0, end = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int pk = k == 0 ? prev : key[k - 1];
    const int nk = k == kItems - 1 ? next : key[k + 1];
    if (key[k] != pk) opens |= 1u << k;
    if ((k == 0 && tid == 0) || key[k] != pk) head |= 1u << k;
    if (key[k] != nk) end |= 1u << k;
  }

  // -- empty segments: between key[k] and the key after it ------------------
  for (int k = -1; k < kItems; ++k) {
    int a, b;
    if (k < 0) {  // below the row's first id, by tile 0's first thread
      a = -1;
      b = (tid == 0 && t0 == 0) ? key[0] : -1;
    } else {
      a = key[k];
      b = k == kItems - 1 ? next : key[k + 1];
    }
    const long long lo = (long long)(a + 1) * d;
    const long long hi = b > a + 1 ? (long long)b * d : lo;
    const bool by_warp = hi - lo > kSmallGap;
    if (!by_warp)
      for (long long t = lo; t < hi; ++t) o[t] = fill_at<T, OP>(t, d, fill);
    unsigned todo = __ballot_sync(kFull, by_warp);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long wlo = __shfl_sync(kFull, lo, src);
      const long long whi = __shfl_sync(kFull, hi, src);
      if (whi - wlo > 2 * kChunk) {  // whole chunks go to pass 2
        const long long c0 = (wlo + kChunk - 1) / kChunk, c1 = whi / kChunk;
        unsigned* ch = chunks + row * nchunks;
        for (long long c = c0 + lane; c < c1; c += 32) ch[c] = 1u;
        gap_fill<T, OP>(o, wlo, c0 * kChunk, d, fill, lane, 32);
        gap_fill<T, OP>(o, c1 * kChunk, whi, d, fill, lane, 32);
      } else {
        gap_fill<T, OP>(o, wlo, whi, d, fill, lane, 32);
      }
    }
  }

  // -- values, one column at a time ------------------------------------------
  for (int j = 0; j < cols; ++j) {
    S x[kItems];
    if constexpr (OP == kArgMin) {
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        x[k] = base + k < e ? argmin_word(xt[k], base + k, opens >> k & 1)
                            : ident;
    } else {
      if (j > 0) load_column(v, base, e, d, j, full, ident, xt);
#pragma unroll
      for (int k = 0; k < kItems; ++k) x[k] = xt[k];
    }
    // the thread's own part: the value of its last run, and whether a run
    // starts inside it
    S agg = x[0];
#pragma unroll
    for (int k = 1; k < kItems; ++k)
      agg = (head >> k & 1) ? x[k] : C::apply(agg, x[k]);
    S block_total;
    const S carry = block_seg_scan<S, Scan<T, OP>::kOp>(agg, head != 0, ident,
                                                        &block_total);

    S run = carry;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      run = (head >> k & 1) ? x[k] : C::apply(run, x[k]);
      if (end >> k & 1) {
        const int sk = key[k];
        if (sk >= 0 && sk < n) {
          if (sk == first && cont) hpart[j] = run;  // joined by pass 2
          else emit<T, OP>(o, v, sk, d, j, run);
        }
      }
    }
    if (tid == kThreads - 1) tpart[j] = run;
  }
  if (tid == 0) {
    const bool hvalid = cont && first >= 0 && first < n &&
                        (last != first || after != first);
    const bool tstarts = !(after == last && last == first && cont);
    meta[cell] = make_int2(hvalid ? first : -1, tstarts ? 1 : 0);
  }
}

// Rows ride on gridDim.y. Past 65,535 rows (kLoop) a block takes every
// gridDim.y-th row in turn.
template <typename T, int OP, bool kLoop>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const T* __restrict__ vals, const int* __restrict__ seg,
                T* __restrict__ out, int2* __restrict__ meta,
                typename Scan<T, OP>::S* __restrict__ part,
                unsigned* __restrict__ chunks, long long e, int n, int d,
                long long ntiles, long long nchunks, int vec,
                long long rows) {
  if constexpr (!kLoop) {
    tile_row<T, OP>(vals, seg, out, meta, part, chunks, e, n, d, ntiles,
                    nchunks, vec, blockIdx.y);
  } else {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
      tile_row<T, OP>(vals, seg, out, meta, part, chunks, e, n, d, ntiles,
                      nchunks, vec, row);
      __syncthreads();
    }
  }
}

// Pass 2, block 0 of each row: joins the segments that cross tile
// boundaries. S[t] = (reset[t] ? 0 : S[t - 1]) + last-run partial of
// tile t, by a segmented scan in tile order; a tile whose first run ends
// inside it and began earlier writes S[t - 1] + its first-run partial.
// The row's other blocks store the chunks pass 1 marked, and clear the
// marks.
template <typename T, int OP>
__device__ __forceinline__ void join_row(
    const T* __restrict__ vals, const int2* __restrict__ meta,
    const typename Scan<T, OP>::S* __restrict__ part,
    unsigned* __restrict__ chunks, T* __restrict__ out, long long e,
    long long ntiles, int n, int d, long long nchunks, long long row) {
  using S = typename Scan<T, OP>::S;
  using C = Combine<S, Scan<T, OP>::kOp>;
  const int tid = threadIdx.x;
  if (row == 0 && blockIdx.x == 0 && tid == 0)
    atomicAdd(&g_launches[1], 1ull);
  T* o = out + row * (long long)n * d;
  if (blockIdx.x > 0) {
    unsigned* ch = chunks + row * nchunks;
    const T fill = Combine<T, OP == kArgMin ? kMin : OP>::ident();
    for (long long c = blockIdx.x - 1; c < nchunks; c += gridDim.x - 1) {
      const bool marked = ch[c] != 0u;
      __syncthreads();  // every thread has read the mark before it goes
      if (marked) {
        gap_fill<T, OP>(o, c * kChunk, (c + 1) * kChunk, d, fill, tid,
                        kThreads);
        if (tid == 0) ch[c] = 0u;
      }
    }
    return;
  }
  const int cols = OP == kArgMin ? 1 : d;
  const int2* m = meta + row * ntiles;
  const S* p = part + row * ntiles * 2 * cols;
  const T* v = vals + row * e * d;
  const S ident = C::ident();
  for (int j = 0; j < cols; ++j) {
    S carry = ident;  // S of the previous chunk's last tile
    for (long long c0 = 0; c0 < ntiles; c0 += kThreads) {
      const long long t = c0 + tid;
      const bool in = t < ntiles;
      const int2 mt = in ? m[t] : make_int2(-1, 1);
      const S pre = block_seg_scan<S, Scan<T, OP>::kOp>(
          in ? p[(2 * t + 1) * cols + j] : ident, mt.y, carry, &carry);
      if (in && mt.x >= 0 && mt.x < n)  // S[t - 1] + the first-run partial
        emit<T, OP>(o, v, mt.x, d, j, C::apply(pre, p[2 * t * cols + j]));
    }
  }
}

// Rows as in tile_kernel.
template <typename T, int OP, bool kLoop>
__global__ void __launch_bounds__(kThreads)
    join_kernel(const T* __restrict__ vals, const int2* __restrict__ meta,
                const typename Scan<T, OP>::S* __restrict__ part,
                unsigned* __restrict__ chunks, T* __restrict__ out,
                long long e, long long ntiles, int n, int d,
                long long nchunks, long long rows) {
  if constexpr (!kLoop) {
    join_row<T, OP>(vals, meta, part, chunks, out, e, ntiles, n, d, nchunks,
                    blockIdx.y);
  } else {
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
      join_row<T, OP>(vals, meta, part, chunks, out, e, ntiles, n, d,
                      nchunks, row);
      __syncthreads();
    }
  }
}

long long tiles_per_row(long long e) {
  return e > 0 ? (e + kTile - 1) / kTile : 1;
}

long long chunks_per_row(int n, int d) {
  return ((long long)n * d + kChunk - 1) / kChunk;
}

struct Args {
  const void* vals;
  const int* seg;
  void* out;
  void* scratch;
  unsigned* chunks;
  long long rows;
  long long e;
  int n, d, vec;
  cudaStream_t stream;
};

template <typename T, int OP, bool kLoop>
void launch_rows(const Args& a) {
  using S = typename Scan<T, OP>::S;
  const long long ntiles = tiles_per_row(a.e);
  const long long nchunks = chunks_per_row(a.n, a.d);
  // a marked chunk lies inside a gap of more than two chunks
  const long long fill_blocks =
      nchunks <= 2 ? 0 : (nchunks < kFillBlocks ? nchunks : kFillBlocks);
  int2* meta = static_cast<int2*>(a.scratch);
  S* part = reinterpret_cast<S*>(meta + (long long)a.rows * ntiles);
  const T* vals = static_cast<const T*>(a.vals);
  T* out = static_cast<T*>(a.out);
  const unsigned grid_rows = (unsigned)(a.rows < kGridRows ? a.rows
                                                           : kGridRows);
  tile_kernel<T, OP, kLoop><<<dim3((unsigned)ntiles, grid_rows), kThreads, 0,
                       a.stream>>>(vals, a.seg, out, meta, part, a.chunks,
                                   a.e, a.n, a.d, ntiles, nchunks, a.vec,
                                   a.rows);
  join_kernel<T, OP, kLoop><<<dim3((unsigned)(1 + fill_blocks), grid_rows),
                       kThreads, 0, a.stream>>>(vals, meta, part, a.chunks,
                                                out, a.e, ntiles, a.n, a.d,
                                                nchunks, a.rows);
}

template <typename T, int OP>
void launch(const Args& a) {
  if (a.rows > kGridRows)
    launch_rows<T, OP, true>(a);
  else
    launch_rows<T, OP, false>(a);
}

template <typename T>
void launch_op(int op, const Args& a) {
  if (op == kSum) launch<T, kSum>(a);
  if (op == kMin) launch<T, kMin>(a);
  if (op == kMax) launch<T, kMax>(a);
  if (op == kProd) launch<T, kProd>(a);
  if (op == kArgMin) launch<T, kArgMin>(a);
}

}  // namespace

// 4-byte words of scratch that segment_combine_launch needs for (rows, e,
// d) and op: per tile an int2 of flags and two partials, d-wide 4-byte
// values, or one 8-byte argmin word each for min_by_first.
// out[0], out[1]: launches of tile_kernel and join_kernel since the
// library loaded, read after the device has finished all its work.
extern "C" int segment_combine_device_launches(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return (int)err;
}

extern "C" long long segment_combine_scratch_words(long long rows,
                                                   long long e, int d,
                                                   int op) {
  const long long words = op == kArgMin ? 2 : d;
  return rows * tiles_per_row(e) * (2 + 2 * words);
}

// 4-byte words of the chunk table for (rows, n, d): one mark per chunk of
// kChunk output elements. The caller keeps the table from launch to
// launch, zeroed once; every launch leaves it zero.
extern "C" long long segment_combine_chunk_words(long long rows, int n,
                                                 int d) {
  return rows * chunks_per_row(n, d);
}

// vals: (rows, e, d); seg: (rows, e) int32 sorted per row; out: (rows, n,
// d); scratch: segment_combine_scratch_words(rows, e, d, op) 4-byte
// words, 8-byte aligned; chunks: segment_combine_chunk_words(rows, n, d)
// words, all zero (each launch leaves them so). dtype 0 = float32, 1 = int32;
// op 0 = sum, 1 = min, 2 = max, 3 = prod, 4 = min_by_first (key in column
// 0; rows of at most 2^32 - 2 entries). A row's tiles of 2048 entries
// ride on gridDim.x, the rows on gridDim.y, at most 65,535 of them, each
// block looping over every 65,535th row beyond that. Returns
// cudaGetLastError().
extern "C" int segment_combine_launch(const void* vals, const int* seg,
                                      void* out, void* scratch, void* chunks,
                                      long long rows, long long e, int n,
                                      int d, int dtype, int op,
                                      void* stream) {
  if (rows < 1 || n < 1 || d < 1 || e < 0 || dtype < 0 ||
      dtype > 1 || op < 0 || op > 4 || tiles_per_row(e) > INT_MAX ||
      (op == kArgMin && e > 0xfffffffeLL) || ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads of a thread's 8 entries: every row starts 16-byte aligned
  const int vec = e % 4 == 0 && ((uintptr_t)seg & 15) == 0 &&
                  ((uintptr_t)vals & 15) == 0;
  const Args a{vals, seg, out, scratch, static_cast<unsigned*>(chunks), rows,
               e, n, d, vec, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    launch_op<float>(op, a);
  else
    launch_op<int>(op, a);
  return (int)cudaGetLastError();
}
