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
//   D > 1 with D % 4 == 0 and 16-byte aligned values and output (but
//   min_by_first) takes the multi-column path instead (cols_tile_kernel,
//   cols_join_kernel; see its section): the same tiles and scans on
//   groups of 8 columns at once, so that each column is bit for bit the
//   kernel's D = 1 call on that column. Other D > 1 calls run both passes
//   one column at a time.
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
// Of those, the launches of the multi-column path's two kernels
// (cols_tile_kernel, cols_join_kernel), counted the same way.
__device__ unsigned long long g_group_launches[2];

enum Op { kSum = 0, kMin = 1, kMax = 2, kProd = 3, kArgMin = 4 };
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr long long kTile = (long long)kThreads * kItems;
constexpr long long kSmallGap = 8;  // elements a thread fills alone
constexpr long long kSmallGapVec = 64;  // the same with 16-byte stores
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

template <typename T>
__device__ __forceinline__ int to_bits(T x) {
  int b;
  memcpy(&b, &x, sizeof(T));
  return b;
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

// A thread's kItems entries of a tile on the multi-column path, as
// tile_row computes them inline: the clamped ids, and bit k of head /
// end: a run starts (in this block's scan) / a run ends at entry k.
struct Entries {
  long long base;  // the thread's first entry
  int key[kItems];
  int next;        // the id after the thread's last entry
  unsigned head, end;
};

// The Entries of this thread in the tile from t0; `before`: the id at t0
// - 1 (-2 in tile 0).
__device__ __forceinline__ Entries entries_of(const int* s, long long t0,
                                              long long e, int n, int vec,
                                              int before) {
  const int tid = threadIdx.x;
  Entries q;
  q.base = t0 + (long long)tid * kItems;
  if (vec && q.base + kItems <= e) {  // 16-byte id loads
    load4<int>(s + q.base, q.key);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      q.key[k] = q.key[k] < 0 ? -1 : (q.key[k] > n ? n : q.key[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) q.key[k] = key_at(s, q.base + k, e, n);
  }
  const int prev = tid == 0 ? before : key_at(s, q.base - 1, e, n);
  q.next = key_at(s, q.base + kItems, e, n);
  q.head = q.end = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int pk = k == 0 ? prev : q.key[k - 1];
    const int nk = k == kItems - 1 ? q.next : q.key[k + 1];
    if ((k == 0 && tid == 0) || q.key[k] != pk) q.head |= 1u << k;
    if (q.key[k] != nk) q.end |= 1u << k;
  }
  return q;
}

// The empty segments between each of the thread's ids and the id after
// it (and, by tile 0's first thread, those below the row's first id), as
// tile_row fills them, with 16-byte stores (D % 4 == 0, the output
// 16-byte aligned): gaps of up to kSmallGapVec elements by the thread (an
// empty segment of 32 columns is 8 stores), longer ones by its warp,
// whole chunks of the longest marked in the row's chunk table `ch` for
// pass 2.
template <typename T, int OP>
__device__ __forceinline__ void fill_gaps(T* o, unsigned* ch,
                                          const Entries& q, long long t0,
                                          int d, T fill) {
  const int tid = threadIdx.x, lane = tid & 31;
  int4 pat;
  pat.x = pat.y = pat.z = pat.w = to_bits(fill);
#pragma unroll
  for (int k = -1; k < kItems; ++k) {
    int a, b;
    if (k < 0) {  // below the row's first id, by tile 0's first thread
      a = -1;
      b = (tid == 0 && t0 == 0) ? q.key[0] : -1;
    } else {
      a = q.key[k];
      b = k == kItems - 1 ? q.next : q.key[k + 1];
    }
    const long long lo = (long long)(a + 1) * d;
    const long long hi = b > a + 1 ? (long long)b * d : lo;
    const bool by_warp = hi - lo > kSmallGapVec;
    if (!by_warp) {
      for (long long t = lo; t < hi; t += 4)
        *reinterpret_cast<int4*>(o + t) = pat;
    }
    unsigned todo = __ballot_sync(kFull, by_warp);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long wlo = __shfl_sync(kFull, lo, src);
      const long long whi = __shfl_sync(kFull, hi, src);
      if (whi - wlo > 2 * kChunk) {  // whole chunks go to pass 2
        const long long c0 = (wlo + kChunk - 1) / kChunk, c1 = whi / kChunk;
        for (long long c = c0 + lane; c < c1; c += 32) ch[c] = 1u;
        range_fill(o, wlo, c0 * kChunk, fill, lane, 32);
        range_fill(o, c1 * kChunk, whi, fill, lane, 32);
      } else {
        range_fill(o, wlo, whi, fill, lane, 32);
      }
    }
  }
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

// -- the multi-column path: D > 1, sum / min / max / prod -------------------
//
// Why a path of its own: one column at a time, as tile_row and join_row
// go, D > 1 costs D strided loads of every entry (a warp-wide load
// touching 32 sectors to use 128 bytes), D block scans, and D passes of
// stores and joins. Where D % 4 == 0 and the values and the output start
// 16-byte aligned (so every row and group does), the columns go instead
// in groups of kGroup = 8 contiguous columns, with a last group of 4
// where D % 8 == 4 (group_width), each group as one G-wide value:
//   - loads: a thread reads each of its entries' G columns as 16-byte
//     vectors (a group of 8: one whole 32-byte sector an entry);
//   - one scan a group: the head flags' part of the warp scan (which
//     lanes combine at each Hillis-Steele step, the flag before and the
//     warp's flag) is taken once a tile, and each step then shuffles the
//     G values alone;
//   - stores: a segment's 8 results are one 32-byte sector of its output
//     row, written by the lane that holds them and its partner lane
//     together (store_pairs), so that a warp's store writes 16 whole
//     sectors and not 32 halves; a group of 4 leaves as one vector store.
//     The tile partials, [cell][2][D] 16-byte aligned, are written and
//     read G at a time; pass 2 joins each group in a block of its own.
// Other D > 1 calls scan one column at a time (tile_kernel, join_kernel).
// The tile, the thread's entries, the scan's offsets, the warp order and
// the tile join are those of the one-column path, so each column meets
// the same combines in the same order as the kernel's D = 1 call on that
// column alone: bit for bit the same result. What still bounds it: the
// 8 x 8 values and the scan's G-wide state take more than 128 registers
// a thread (held to 128, it spills and runs slower), so one block of 8
// warps runs on an SM; and each warp load or store still touches 16-32
// lines, one per entry or segment.

constexpr int kGroup = 8;  // columns a group, 16-byte loads
static_assert(kGroup == 8, "two 16-byte vectors a group; a last group of 4");

// Columns of the group from column c0 of d (d % 4 == 0): kGroup, or the
// last 4.
__host__ __device__ __forceinline__ int group_width(int d, int c0) {
  return d - c0 >= kGroup ? kGroup : 4;
}

// G values from p as 16-byte loads (p 16-byte aligned).
template <typename T, int G>
__device__ __forceinline__ void load_group(const T* p, T (&x)[G]) {
  static_assert(G % 4 == 0, "16-byte vectors");
#pragma unroll
  for (int q = 0; q < G / 4; ++q) {
    const int4 a = *reinterpret_cast<const int4*>(p + 4 * q);
    x[4 * q] = from_bits<T>(a.x);
    x[4 * q + 1] = from_bits<T>(a.y);
    x[4 * q + 2] = from_bits<T>(a.z);
    x[4 * q + 3] = from_bits<T>(a.w);
  }
}

// G values to p, as load_group reads them.
template <typename T, int G>
__device__ __forceinline__ void store_group(T* p, const T (&x)[G]) {
  static_assert(G % 4 == 0, "16-byte vectors");
#pragma unroll
  for (int q = 0; q < G / 4; ++q)
    *reinterpret_cast<int4*>(p + 4 * q) =
        make_int4(to_bits(x[4 * q]), to_bits(x[4 * q + 1]),
                  to_bits(x[4 * q + 2]), to_bits(x[4 * q + 3]));
}

// The head flags' part of block_seg_scan's warp scan for one flag a
// thread: bit s of `steps`, the lane combines the value 2^s lanes before
// it at step s; `fex`, the inclusive flag of the lane before; `finc`,
// this lane's inclusive flag.
struct Steps {
  unsigned steps;
  int fex, finc;
};

__device__ __forceinline__ Steps scan_steps(int flag) {
  const int lane = threadIdx.x & 31;
  Steps st{0u, 0, flag};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int of = __shfl_up_sync(kFull, st.finc, 1 << s);
    if (lane >= (1 << s)) {
      if (!st.finc) st.steps |= 1u << s;
      st.finc |= of;
    }
  }
  st.fex = __shfl_up_sync(kFull, st.finc, 1);
  return st;
}

// block_seg_scan on G columns at once, the flags' part given: each
// column meets block_seg_scan's combines in its order. wv (kWarps x
// kGroup values) and wf (kWarps flags) are the block's shared words;
// carry and total may be the same array.
template <typename T, int OP, int G>
__device__ __forceinline__ void group_seg_scan(const T (&val)[G],
                                               const Steps& st,
                                               const T (&carry)[G],
                                               T (&pre)[G], T (&total)[G],
                                               T* wv, int* wf) {
  using C = Combine<T, OP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc[G];
#pragma unroll
  for (int c = 0; c < G; ++c) inc[c] = val[c];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const T ov = __shfl_up_sync(kFull, inc[c], 1 << s);
      if (st.steps >> s & 1) inc[c] = C::apply(ov, inc[c]);
    }
  }
  T ex[G];
#pragma unroll
  for (int c = 0; c < G; ++c) ex[c] = __shfl_up_sync(kFull, inc[c], 1);
  if (lane == 31) {
    store_group<T, G>(wv + warp * kGroup, inc);
    wf[warp] = st.finc;
  }
  __syncthreads();
  T p[G], tot[G];  // the earlier warps' trailing run, in order
#pragma unroll
  for (int c = 0; c < G; ++c) p[c] = tot[c] = carry[c];
  for (int w = 0; w < kWarps; ++w) {
    const int fw = wf[w];
    T wt[G];
    load_group<T, G>(wv + w * kGroup, wt);
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (w == warp) p[c] = tot[c];
      tot[c] = fw ? wt[c] : C::apply(tot[c], wt[c]);
    }
  }
  if (lane > 0) {
#pragma unroll
    for (int c = 0; c < G; ++c) p[c] = st.fex ? ex[c] : C::apply(p[c], ex[c]);
  }
  __syncthreads();  // wv is reused by the next call
#pragma unroll
  for (int c = 0; c < G; ++c) {
    pre[c] = p[c];
    total[c] = tot[c];
  }
}

// The 8 values `run` of segment sk (`mine`: this lane writes one) to
// o + sk * d, 16-byte aligned, by the lane and its partner (lane ^ 1)
// together: the even lane's segment first, then the odd lane's, each as
// one 32-byte sector, the even lane writing its first 16 bytes and the
// odd lane its last. Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void store_pairs(T* o, int d, int sk, bool mine,
                                           const T (&run)[8]) {
  const bool odd = threadIdx.x & 1;
  T give[4], got[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    give[c] = run[odd ? c : c + 4];  // the half the partner writes
    got[c] = __shfl_xor_sync(kFull, give[c], 1);
  }
  const int other = __shfl_xor_sync(kFull, sk, 1);
  const bool theirs = __shfl_xor_sync(kFull, (int)mine, 1);
  T half[4];
  // the even lane's segment: its first half, then its last from the odd
#pragma unroll
  for (int c = 0; c < 4; ++c) half[c] = odd ? got[c] : run[c];
  if (odd ? theirs : mine)
    store_group<T, 4>(o + (long long)(odd ? other : sk) * d + (odd ? 4 : 0),
                      half);
  // the odd lane's segment: its first half from the even, then its last
#pragma unroll
  for (int c = 0; c < 4; ++c) half[c] = odd ? run[c + 4] : got[c];
  if (odd ? mine : theirs)
    store_group<T, 4>(o + (long long)(odd ? sk : other) * d + (odd ? 4 : 0),
                      half);
}

// tile_row's column loop for the G columns from c0 at once: the thread's
// entries' values (the identity past the row), the run fold, the scan, a
// segment's G results, the tile's two partials. `gaps`: the group is the
// row's first, and the empty segments are filled while its loads are in
// flight.
template <typename T, int OP, int G>
__device__ __forceinline__ void tile_group(const T* v, const Entries& q,
                                           const Steps& st, long long e,
                                           int c0, T* o, unsigned* ch,
                                           long long t0, T* hpart, T* tpart,
                                           int n, int d, int first, bool cont,
                                           bool gaps, T* wv, int* wf) {
  using C = Combine<T, OP>;
  const T fill = C::ident();
  T x[kItems][G];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (q.base + k < e) {
      load_group<T, G>(v + (q.base + k) * d + c0, x[k]);
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c) x[k][c] = fill;
    }
  }
  if (gaps) fill_gaps<T, OP>(o, ch, q, t0, d, fill);
  T agg[G], ident[G], carry[G], total[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    ident[c] = fill;
    agg[c] = x[0][c];
  }
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
#pragma unroll
    for (int c = 0; c < G; ++c)
      agg[c] = (q.head >> k & 1) ? x[k][c] : C::apply(agg[c], x[k][c]);
  }
  group_seg_scan<T, OP, G>(agg, st, ident, carry, total, wv, wf);
  T run[G];
#pragma unroll
  for (int c = 0; c < G; ++c) run[c] = carry[c];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int c = 0; c < G; ++c)
      run[c] = (q.head >> k & 1) ? x[k][c] : C::apply(run[c], x[k][c]);
    const int sk = q.key[k];
    const bool ends = (q.end >> k & 1) && sk >= 0 && sk < n;
    const bool joined = ends && sk == first && cont;  // joined by pass 2
    if (joined) store_group<T, G>(hpart + c0, run);
    if constexpr (G == 8)
      store_pairs<T>(o + c0, d, sk, ends && !joined, run);
    else if (ends && !joined)
      store_group<T, G>(o + (long long)sk * d + c0, run);
  }
  if (threadIdx.x == kThreads - 1) store_group<T, G>(tpart + c0, run);
}

// Pass 1 of the multi-column path: tile_row's meta and partials.
template <typename T, int OP>
__device__ __forceinline__ void cols_tile_row(
    const T* __restrict__ vals, const int* __restrict__ seg,
    T* __restrict__ out, int2* __restrict__ meta, T* __restrict__ part,
    unsigned* __restrict__ chunks, long long e, int n, int d,
    long long ntiles, long long nchunks, int vec, long long row, T* wv,
    int* wf) {
  const long long tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (row == 0 && tile == 0 && tid == 0) {
    atomicAdd(&g_launches[0], 1ull);
    atomicAdd(&g_group_launches[0], 1ull);
  }
  const int* s = seg + row * e;
  const T* v = vals + row * e * d;
  T* o = out + row * (long long)n * d;
  const long long cell = row * ntiles + tile;
  T* hpart = part + cell * 2 * d;
  T* tpart = hpart + d;
  const long long t0 = tile * kTile;

  const int first = key_at(s, t0, e, n);
  if (first == n && t0 > 0) {  // dropped tail: the tile before filled to n
    if (tid == 0) meta[cell] = make_int2(-1, 1);
    return;
  }
  const int before = t0 == 0 ? -2 : key_at(s, t0 - 1, e, n);
  const int last = key_at(s, t0 + kTile - 1, e, n);
  const int after = key_at(s, t0 + kTile, e, n);
  const bool cont = before == first;  // the first run began in a tile before
  const Entries q = entries_of(s, t0, e, n, vec, before);
  const Steps st = scan_steps(q.head != 0);
  unsigned* ch = chunks + row * nchunks;
  for (int c0 = 0; c0 < d; c0 += kGroup) {
    if (group_width(d, c0) == kGroup)
      tile_group<T, OP, kGroup>(v, q, st, e, c0, o, ch, t0, hpart, tpart, n,
                                d, first, cont, c0 == 0, wv, wf);
    else
      tile_group<T, OP, 4>(v, q, st, e, c0, o, ch, t0, hpart, tpart, n, d,
                           first, cont, c0 == 0, wv, wf);
  }
  if (tid == 0) {
    const bool hvalid = cont && first >= 0 && first < n &&
                        (last != first || after != first);
    const bool tstarts = !(after == last && last == first && cont);
    meta[cell] = make_int2(hvalid ? first : -1, tstarts ? 1 : 0);
  }
}

// Rows ride on gridDim.y; a block takes every gridDim.y-th row in turn.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    cols_tile_kernel(const T* __restrict__ vals, const int* __restrict__ seg,
                     T* __restrict__ out, int2* __restrict__ meta,
                     T* __restrict__ part, unsigned* __restrict__ chunks,
                     long long e, int n, int d, long long ntiles,
                     long long nchunks, int vec, long long rows) {
  __shared__ __align__(16) T wv[kWarps * kGroup];
  __shared__ int wf[kWarps];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    cols_tile_row<T, OP>(vals, seg, out, meta, part, chunks, e, n, d, ntiles,
                         nchunks, vec, row, wv, wf);
    __syncthreads();
  }
}

// join_row's scan of the tiles' partials for the G columns from c0 at
// once.
template <typename T, int OP, int G>
__device__ __forceinline__ void join_group(const int2* m, const T* p, T* o,
                                           long long ntiles, int n, int d,
                                           int c0, T* wv, int* wf) {
  using C = Combine<T, OP>;
  const int tid = threadIdx.x;
  T carry[G];  // S of the previous chunk's last tile
#pragma unroll
  for (int c = 0; c < G; ++c) carry[c] = C::ident();
  for (long long c0t = 0; c0t < ntiles; c0t += kThreads) {
    const long long t = c0t + tid;
    const bool in = t < ntiles;
    const int2 mt = in ? m[t] : make_int2(-1, 1);
    T tail[G], pre[G];
    if (in) {
      load_group<T, G>(p + (2 * t + 1) * d + c0, tail);
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c) tail[c] = C::ident();
    }
    group_seg_scan<T, OP, G>(tail, scan_steps(mt.y), carry, pre, carry, wv,
                             wf);
    if (in && mt.x >= 0 && mt.x < n) {  // S[t - 1] + the first-run partial
      T head[G];
      load_group<T, G>(p + 2 * t * d + c0, head);
#pragma unroll
      for (int c = 0; c < G; ++c) head[c] = C::apply(pre[c], head[c]);
      store_group<T, G>(o + (long long)mt.x * d + c0, head);
    }
  }
}

// Pass 2 of the multi-column path: block g < ceil(d / kGroup) of each
// row joins the crossing segments of column group g, each group on its
// own as join_row joins a column; the row's other blocks store the
// marked chunks and clear them, as join_row's do.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    cols_join_kernel(const int2* __restrict__ meta, const T* __restrict__ part,
                     unsigned* __restrict__ chunks, T* __restrict__ out,
                     long long ntiles, int n, int d, long long nchunks,
                     long long rows) {
  __shared__ __align__(16) T wv[kWarps * kGroup];
  __shared__ int wf[kWarps];
  const int groups = (d + kGroup - 1) / kGroup;
  const int tid = threadIdx.x;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    T* o = out + row * (long long)n * d;
    if (blockIdx.x >= groups) {
      unsigned* ch = chunks + row * nchunks;
      const T fill = Combine<T, OP>::ident();
      for (long long c = blockIdx.x - groups; c < nchunks;
           c += gridDim.x - groups) {
        const bool marked = ch[c] != 0u;
        __syncthreads();  // every thread has read the mark before it goes
        if (marked) {
          range_fill(o, c * kChunk, (c + 1) * kChunk, fill, tid, kThreads);
          if (tid == 0) ch[c] = 0u;
        }
      }
    } else {
      if (row == 0 && blockIdx.x == 0 && tid == 0) {
        atomicAdd(&g_launches[1], 1ull);
        atomicAdd(&g_group_launches[1], 1ull);
      }
      const int2* m = meta + row * ntiles;
      const T* p = part + row * ntiles * 2 * d;
      const int c0 = blockIdx.x * kGroup;
      if (group_width(d, c0) == kGroup)
        join_group<T, OP, kGroup>(m, p, o, ntiles, n, d, c0, wv, wf);
      else
        join_group<T, OP, 4>(m, p, o, ntiles, n, d, c0, wv, wf);
    }
    __syncthreads();
  }
}

long long tiles_per_row(long long e) {
  return e > 0 ? (e + kTile - 1) / kTile : 1;
}

long long chunks_per_row(int n, int d) {
  return ((long long)n * d + kChunk - 1) / kChunk;
}

// Scratch laid out for the multi-column path: D > 1 and an op other than
// min_by_first (a call takes the path if its rows are 16-byte aligned as
// well: takes_groups).
bool wide(int d, int op) { return d > 1 && op != kArgMin; }

// The multi-column path takes the call: wide, D % 4 == 0, and the values
// and the output start 16-byte aligned, so every row and group does.
bool takes_groups(int d, int op, const void* vals, const void* out) {
  return wide(d, op) && d % 4 == 0 && ((uintptr_t)vals & 15) == 0 &&
         ((uintptr_t)out & 15) == 0;
}

// 4-byte words before the partials: the meta table, rounded up to 16
// bytes where the scratch is laid out for the multi-column path.
long long meta_words(long long cells, bool groups) {
  return groups ? (2 * cells + 3) / 4 * 4 : 2 * cells;
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
void launch_groups(const Args& a) {
  const long long ntiles = tiles_per_row(a.e);
  const long long nchunks = chunks_per_row(a.n, a.d);
  const long long fill_blocks =
      nchunks <= 2 ? 0 : (nchunks < kFillBlocks ? nchunks : kFillBlocks);
  int2* meta = static_cast<int2*>(a.scratch);
  T* part = reinterpret_cast<T*>(static_cast<int*>(a.scratch) +
                                 meta_words(a.rows * ntiles, true));
  const T* vals = static_cast<const T*>(a.vals);
  T* out = static_cast<T*>(a.out);
  const unsigned grid_rows = (unsigned)(a.rows < kGridRows ? a.rows
                                                           : kGridRows);
  cols_tile_kernel<T, OP><<<dim3((unsigned)ntiles, grid_rows), kThreads, 0,
                            a.stream>>>(vals, a.seg, out, meta, part,
                                        a.chunks, a.e, a.n, a.d, ntiles,
                                        nchunks, a.vec, a.rows);
  const long long groups = (a.d + kGroup - 1) / kGroup;
  cols_join_kernel<T, OP><<<dim3((unsigned)(groups + fill_blocks), grid_rows),
                            kThreads, 0, a.stream>>>(
      meta, part, a.chunks, out, ntiles, a.n, a.d, nchunks, a.rows);
}

template <typename T, int OP>
void launch(const Args& a) {
  if constexpr (OP != kArgMin) {
    if (takes_groups(a.d, OP, a.vals, a.out)) return launch_groups<T, OP>(a);
  }
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

// out[0], out[1]: launches of the first and second kernel (tile_kernel or
// cols_tile_kernel, join_kernel or cols_join_kernel) since the library
// loaded, read after the device has finished all its work.
extern "C" int segment_combine_device_launches(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return (int)err;
}

// out[0], out[1]: of those, the launches of the multi-column path's
// cols_tile_kernel and cols_join_kernel, read the same way.
extern "C" int segment_combine_group_launches(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_group_launches,
                               sizeof(g_group_launches));
  return (int)err;
}

// Columns a group of the multi-column path (its last group may hold 4).
extern "C" int segment_combine_group_columns() { return kGroup; }

// 4-byte words of scratch that segment_combine_launch needs for (rows, e,
// d) and op: per tile an int2 of flags and two partials, d-wide 4-byte
// values, or one 8-byte argmin word each for min_by_first; for d > 1 (not
// min_by_first), which the multi-column path may take, the flags are
// rounded up to 16 bytes.
extern "C" long long segment_combine_scratch_words(long long rows,
                                                   long long e, int d,
                                                   int op) {
  const long long cells = rows * tiles_per_row(e);
  if (wide(d, op)) return meta_words(cells, true) + cells * 2 * d;
  const long long words = op == kArgMin ? 2 : d;
  return cells * (2 + 2 * words);
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
// words, 8-byte aligned (16-byte for d > 1, not min_by_first); chunks:
// segment_combine_chunk_words(rows, n, d) words, all zero (each launch
// leaves them so). dtype 0 = float32, 1 = int32; op 0 = sum, 1 = min, 2 =
// max, 3 = prod, 4 = min_by_first (key in column 0; rows of at most 2^32
// - 2 entries). A row's tiles of 2048 entries ride on gridDim.x, the rows
// on gridDim.y, at most 65,535 of them, each block looping over every
// 65,535th row beyond that. Returns cudaGetLastError().
extern "C" int segment_combine_launch(const void* vals, const int* seg,
                                      void* out, void* scratch, void* chunks,
                                      long long rows, long long e, int n,
                                      int d, int dtype, int op,
                                      void* stream) {
  if (rows < 1 || n < 1 || d < 1 || e < 0 || dtype < 0 ||
      dtype > 1 || op < 0 || op > 4 || tiles_per_row(e) > INT_MAX ||
      (op == kArgMin && e > 0xfffffffeLL) ||
      ((uintptr_t)scratch & (wide(d, op) ? 15 : 7)))
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
