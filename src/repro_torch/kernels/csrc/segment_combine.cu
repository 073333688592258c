// Sorted-segment combine for the scatter-combine channel, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/segment_combine.py, segment_combine_pallas
// (the Pallas `_kernel` and `_segmented_scan`). For each row r of
// (rows, E, D) values with sorted segment ids seg[r, :] it computes
//   out[r, s, :] = combine(vals[r, e, :] for seg[r, e] == s),  s in [0, N)
// with the combiner's identity for empty segments; ids outside [0, N)
// are dropped.
//
// Bound: memory. Each value and id is read once and each output written
// once: E * (4 D + 4) + N * 4 D bytes per row, against one combine per
// value — far below the card's arithmetic rate.
//
// Design: the TPU kernel pulls segment-end partials out of a segmented
// scan with a one-hot matmul on the MXU; that product turns any +-inf
// into NaN and refuses int32 sums. Here there is no matmul:
//   1. offsets_kernel: one thread per position finds the segment ids it
//      starts, and its warp writes their lower bounds (a CSR offset table,
//      N + 1 per row) from the sorted ids alone — O(E + N);
//   2. combine_kernel: one warp per output segment reads its [lo, hi)
//      range; lanes stride over the edges (one column of D at a time) and
//      a fixed-order shuffle tree combines the 32 lane partials.
// The order of every combine depends only on (lo, hi), never on
// scheduling, so two runs give bit-identical results: exact for min,
// max and int32 sum (two's-complement wrap, as the plain version), and
// float32 sum differs from a sequential order only by reassociation. min
// and max keep +-inf and propagate NaN like torch.minimum/maximum.
// Offsets are clamped to [0, E] before use, so unsorted input gives a
// wrong answer but no out-of-bounds read.
//
// Known weakness: an R-MAT hub segment leaves one warp with most of a
// row's edges while the others idle.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

enum Op { kSum = 0, kMin = 1, kMax = 2 };
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

template <typename T, int OP>
struct Combine;

template <int OP>
struct Combine<float, OP> {
  static __device__ __forceinline__ float ident() {
    return OP == kSum ? 0.0f : (OP == kMin ? INFINITY : -INFINITY);
  }
  static __device__ __forceinline__ float apply(float a, float b) {
    if (OP == kSum) return a + b;
    if (OP == kMin) return (a < b || a != a) ? a : b;  // a != a: NaN
    return (a > b || a != a) ? a : b;
  }
};

template <int OP>
struct Combine<int, OP> {
  static __device__ __forceinline__ int ident() {
    return OP == kSum ? 0 : (OP == kMin ? INT_MAX : INT_MIN);
  }
  static __device__ __forceinline__ int apply(int a, int b) {
    if (OP == kSum) return (int)((unsigned)a + (unsigned)b);
    if (OP == kMin) return a < b ? a : b;
    return a > b ? a : b;
  }
};

// Segment id of position i as the offset search sees it: -1 below the
// range, n for every dropped id at or past it.
__device__ __forceinline__ long long seg_key(const int* seg, long long i,
                                             int n) {
  const int s = seg[i];
  return s < 0 ? -1 : (s > n ? n : s);
}

// off[row, s] = first position whose id is >= s, for s in [0, n].
// Position i starts every id in (key(i - 1), key(i)]. Such a range is
// long where ids skip many segments — at the latest before the dropped
// tail, which skips every empty segment up to n — so the warp writes its
// lanes' ranges together, 32 entries per store, instead of one thread
// looping alone over a long range.
__global__ void offsets_kernel(const int* __restrict__ seg,
                               int* __restrict__ off, long long e, int n) {
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int* s = seg + (long long)row * e;
  int* o = off + (long long)row * (n + 1);
  long long prev = 0, cur = 0;  // past the row: an empty range
  if (i <= e) {
    prev = i == 0 ? -1 : seg_key(s, i - 1, n);
    cur = i == e ? (long long)n : seg_key(s, i, n);
  }
  unsigned todo = __ballot_sync(kFull, cur > prev);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long a = __shfl_sync(kFull, prev, src) + 1;
    const long long b = __shfl_sync(kFull, cur, src);
    const int pos = (int)__shfl_sync(kFull, i, src);
    for (long long t = a + lane; t <= b; t += 32) o[t] = pos;
  }
}

template <typename T, int OP>
__global__ void combine_kernel(const T* __restrict__ vals,
                               const int* __restrict__ off,
                               T* __restrict__ out, int rows, long long e,
                               int n, int d) {
  using C = Combine<T, OP>;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)rows * n) return;  // uniform across the warp
  const long long row = warp / n;
  const long long s = warp % n;
  const int* o = off + row * (n + 1);
  const long long lo = min(max((long long)o[s], 0LL), e);
  const long long hi = min(max((long long)o[s + 1], lo), e);
  const T* v = vals + row * e * d;
  T* dst = out + (row * n + s) * d;
  for (int j = 0; j < d; ++j) {
    T acc = C::ident();
#pragma unroll 4
    for (long long k = lo + lane; k < hi; k += 32)
      acc = C::apply(acc, v[k * d + j]);
    for (int sh = 16; sh > 0; sh >>= 1)
      acc = C::apply(acc, __shfl_down_sync(kFull, acc, sh));
    if (lane == 0) dst[j] = acc;
  }
}

template <typename T, int OP>
void launch_combine(const void* vals, const int* off, void* out, int rows,
                    long long e, int n, int d, cudaStream_t s) {
  const long long threads = (long long)rows * n * 32;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  combine_kernel<T, OP><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(vals), off, static_cast<T*>(out), rows, e, n, d);
}

}  // namespace

// vals: (rows, e, d); seg: (rows, e) int32 sorted per row; out: (rows, n,
// d); offsets: (rows, n + 1) int32 scratch. dtype 0 = float32, 1 = int32;
// op 0 = sum, 1 = min, 2 = max. Returns cudaGetLastError().
extern "C" int segment_combine_launch(const void* vals, const int* seg,
                                      void* out, int* offsets, int rows,
                                      long long e, int n, int d, int dtype,
                                      int op, void* stream) {
  if (rows < 1 || rows > 65535 || n < 1 || d < 1 || e < 0 || dtype < 0 ||
      dtype > 1 || op < 0 || op > 2)
    return (int)cudaErrorInvalidValue;
  if ((long long)rows * n * 32 / kThreads >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 ogrid((unsigned)((e + 1 + kThreads - 1) / kThreads),
                   (unsigned)rows);
  offsets_kernel<<<ogrid, kThreads, 0, s>>>(seg, offsets, e, n);
  if (dtype == 0) {
    if (op == kSum) launch_combine<float, kSum>(vals, offsets, out, rows, e, n, d, s);
    if (op == kMin) launch_combine<float, kMin>(vals, offsets, out, rows, e, n, d, s);
    if (op == kMax) launch_combine<float, kMax>(vals, offsets, out, rows, e, n, d, s);
  } else {
    if (op == kSum) launch_combine<int, kSum>(vals, offsets, out, rows, e, n, d, s);
    if (op == kMin) launch_combine<int, kMin>(vals, offsets, out, rows, e, n, d, s);
    if (op == kMax) launch_combine<int, kMax>(vals, offsets, out, rows, e, n, d, s);
  }
  return (int)cudaGetLastError();
}
