// Stable bucket ranks for the routed exchange, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bucket_route.py, bucket_ranks_pallas (the
// Pallas `_kernel`). For each row of keys in [0, B] (B = the invalid
// sentinel, still ranked) it computes every key's stable arrival rank
// within its bucket and the (B + 1) occupancy histogram of the row.
//
// Bound: memory. The function must read 4 bytes (the key) and write 4
// bytes (the rank) per key, plus (B + 1) counts per row; it does almost
// no arithmetic, so its least time is 8 bytes per key over the card's
// memory rate.
//
// Design: the TPU kernel is a sequential grid that carries the running
// occupancy from chunk to chunk. Blocks on a GPU run in no order, so the
// carry becomes three parallel passes over (rows, chunks of 1024 keys):
//   1. count_kernel: one block per (row, chunk), one thread per key,
//      writes the chunk's per-bucket counts;
//   2. scan_kernel: one block per (row, bucket) turns the chunk counts
//      into exclusive chunk offsets and writes the row's histogram;
//   3. rank_kernel: recomputes the in-chunk ranks and adds the offsets.
// Inside a chunk, a warp ranks its 32 keys with __match_any_sync and a
// popcount of the lower peer lanes; per-warp bucket counts in shared
// memory, scanned across the chunk's 32 warps, order the warps. Order is
// (chunk, warp, lane) = key index, so the ranks are stable, and the
// counts are integers, so the result is exact and bit-identical to the
// plain version. Pass 3 reads the keys again rather than storing the
// pass-1 ranks: 12 bytes per key move instead of 8.
//
// Limits: B + 1 <= kMaxBuckets (64); the wrapper raises above it. Keys
// outside [0, B] are ranked as the sentinel B so that no input can index
// outside shared memory.
//
// bucket_ranks_lanes replaces: src/repro/kernels/bucket_route.py,
// bucket_ranks_lanes_pallas (`_kernel_lanes`), the one route pass of the
// batched query plane. Besides the shared ranks and histogram above it
// counts, per row, lane_counts[b][q] = #{i : key[i] == b and lanes[i][q]}
// for Q query lanes whose membership arrives as (M, Q) bytes.
//
// Bound: memory. Per key it must read 4 + Q bytes (key and membership) and
// write 4 (the rank), plus (B + 1)(Q + 1) counts per row.
//
// Design: the TPU kernel gets the lane counts from an f32 one-hot matmul
// on the MXU. Here they are a counting pass folded into pass 1
// (count_lanes_kernel): each thread reads its key's Q membership bytes in
// 16-byte loads; for each lane a warp ballots the membership bit and the
// lowest thread of every group of equal keys (the __match_any_sync peers)
// adds the popcount of its group's bits into a (B + 1) x (Q + 1) int32
// tile in shared memory (the extra column spreads the buckets over the
// banks). One integer atomicAdd per non-zero tile entry then adds the
// block's tile into lane_counts, which the wrapper zeroes. Integer atomics
// are exact and order-free, so the result is bit-identical to the plain
// version on every run. Passes 2 and 3 are bucket_ranks' own. The tile must
// fit kMaxLaneTileBytes of dynamic shared memory; the wrapper raises above.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;  // keys per block, one per thread
constexpr int kWarps = kChunk / 32;
constexpr int kMaxBuckets = 64;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory for the lane tile; with the 8 KB static wcount it
// stays under the 48 KB a block gets without an opt-in
constexpr int kMaxLaneTileBytes = 32768;

__device__ __forceinline__ int load_key(const int* keys, long long i,
                                        long long m, int nb) {
  if (i >= m) return nb;  // past the row: a bucket id no real key has
  int k = keys[i];
  return (k < 0 || k >= nb) ? nb - 1 : k;
}

// Zeroes the per-warp counts, then leaves in wcount[warp][b] the number of
// this warp's keys in bucket b and returns this key's rank in its warp.
__device__ __forceinline__ int warp_ranks(int key,
                                          int (*wcount)[kMaxBuckets + 1]) {
  int* flat = &wcount[0][0];
  for (int j = threadIdx.x; j < kWarps * (kMaxBuckets + 1); j += blockDim.x)
    flat[j] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned lower = peers & ((1u << lane) - 1u);
  if (lower == 0u) wcount[threadIdx.x >> 5][key] = __popc(peers);
  __syncthreads();
  return __popc(lower);
}

__global__ void count_kernel(const int* __restrict__ keys,
                             int* __restrict__ chunk_counts, long long m,
                             int nb, int nchunks) {
  __shared__ int wcount[kWarps][kMaxBuckets + 1];
  const int row = blockIdx.y, chunk = blockIdx.x;
  const long long i = (long long)chunk * kChunk + threadIdx.x;
  const int key = load_key(keys + (long long)row * m, i, m, nb);
  warp_ranks(key, wcount);
  if ((int)threadIdx.x < nb) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += wcount[w][threadIdx.x];
    chunk_counts[((long long)row * nb + threadIdx.x) * nchunks + chunk] =
        total;
  }
}

// Byte j (0..15, a constant after unrolling) of a 16-byte load.
__device__ __forceinline__ unsigned byte_of(const uint4& v, int j) {
  const unsigned w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xffu;
}

// Pass 1 of bucket_ranks_lanes: count_kernel's chunk counts, plus the
// chunk's per-(bucket, lane) membership counts added into lane_counts
// ((nb, q) per row). vec16: q % 16 == 0 and lanes 16-byte aligned.
__global__ void count_lanes_kernel(const int* __restrict__ keys,
                                   const unsigned char* __restrict__ lanes,
                                   int* __restrict__ chunk_counts,
                                   int* __restrict__ lane_counts, long long m,
                                   int nb, int nchunks, int q, bool vec16) {
  __shared__ int wcount[kWarps][kMaxBuckets + 1];
  extern __shared__ int tile[];  // nb rows of q + 1 (one pad column)
  const int row = blockIdx.y, chunk = blockIdx.x;
  const int stride = q + 1;
  const long long i = (long long)chunk * kChunk + threadIdx.x;
  const int key = load_key(keys + (long long)row * m, i, m, nb);
  for (int j = threadIdx.x; j < nb * stride; j += blockDim.x) tile[j] = 0;
  warp_ranks(key, wcount);  // its barriers also publish the zeroed tile
  if ((int)threadIdx.x < nb) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += wcount[w][threadIdx.x];
    chunk_counts[((long long)row * nb + threadIdx.x) * nchunks + chunk] =
        total;
  }

  const unsigned lane = threadIdx.x & 31u;
  const unsigned peers = __match_any_sync(kFull, key);
  const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
  const bool in_row = i < m;
  // past-the-row threads (key nb) read nothing and set no bit, and their
  // peers are past-the-row threads only, so they never touch the tile
  const unsigned char* mine =
      lanes + ((long long)row * m + (in_row ? i : 0)) * q;
  for (int q0 = 0; q0 < q; q0 += 16) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (in_row) {
      if (vec16) {
        v = *reinterpret_cast<const uint4*>(mine + q0);
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (q0 + j < q) w[j >> 2] |= (unsigned)mine[q0 + j] << (8 * (j & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (q0 + j >= q) break;  // uniform: every thread of the warp breaks
      const unsigned set = __ballot_sync(kFull, byte_of(v, j) != 0u);
      const int n = __popc(set & peers);
      if (leader && n) atomicAdd(&tile[key * stride + q0 + j], n);
    }
  }
  __syncthreads();
  int* out = lane_counts + (long long)row * nb * q;
  for (int j = threadIdx.x; j < nb * q; j += blockDim.x) {
    const int t = tile[(j / q) * stride + j % q];
    if (t) atomicAdd(&out[j], t);
  }
}

// Exclusive scan over the chunks of one (row, bucket), in place; the
// last thread also writes the row's total for the bucket.
__global__ void scan_kernel(int* __restrict__ chunk_counts,
                            int* __restrict__ counts, int nb, int nchunks) {
  __shared__ int warp_sums[32];
  const int bucket = blockIdx.x, row = blockIdx.y;
  int* c = chunk_counts + ((long long)row * nb + bucket) * nchunks;
  const int per = (nchunks + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, nchunks);
  const int hi = min(lo + per, nchunks);
  int local = 0;
  for (int j = lo; j < hi; ++j) local += c[j];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
  for (int sh = 1; sh < 32; sh <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, sh);
    if (lane >= sh) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int s = lane < nwarps ? warp_sums[lane] : 0;
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int up = __shfl_up_sync(kFull, s, sh);
      if (lane >= sh) s += up;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int v = c[j];
    c[j] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) counts[(long long)row * nb + bucket] = run;
}

__global__ void rank_kernel(const int* __restrict__ keys,
                            const int* __restrict__ chunk_offsets,
                            int* __restrict__ rank, long long m, int nb,
                            int nchunks) {
  __shared__ int wcount[kWarps][kMaxBuckets + 1];
  const int row = blockIdx.y, chunk = blockIdx.x;
  const long long i = (long long)chunk * kChunk + threadIdx.x;
  const int key = load_key(keys + (long long)row * m, i, m, nb);
  const int within = warp_ranks(key, wcount);
  if ((int)threadIdx.x < nb) {
    int run =
        chunk_offsets[((long long)row * nb + threadIdx.x) * nchunks + chunk];
    for (int w = 0; w < kWarps; ++w) {
      const int t = wcount[w][threadIdx.x];
      wcount[w][threadIdx.x] = run;
      run += t;
    }
  }
  __syncthreads();
  if (i < m) rank[(long long)row * m + i] = wcount[threadIdx.x >> 5][key] + within;
}

}  // namespace

// keys, rank: (rows, m) int32; counts: (rows, nb) int32; scratch: rows * nb
// * ceil(m / 1024) int32. nb = B + 1. Returns cudaGetLastError().
extern "C" int bucket_ranks_launch(const int* keys, int* rank, int* counts,
                                   int* scratch, int rows, long long m, int nb,
                                   void* stream) {
  if (nb < 1 || nb > kMaxBuckets || rows < 1 || rows > 65535 || m < 1)
    return (int)cudaErrorInvalidValue;
  const long long nchunks = (m + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nchunks, (unsigned)rows);
  count_kernel<<<grid, kChunk, 0, s>>>(keys, scratch, m, nb, (int)nchunks);
  scan_kernel<<<dim3((unsigned)nb, (unsigned)rows), 1024, 0, s>>>(
      scratch, counts, nb, (int)nchunks);
  rank_kernel<<<grid, kChunk, 0, s>>>(keys, scratch, rank, m, nb,
                                      (int)nchunks);
  return (int)cudaGetLastError();
}

// keys, rank: (rows, m) int32; lanes: (rows, m, q) bytes, 0 = not a
// member; counts: (rows, nb) int32; lane_counts: (rows, nb, q) int32,
// zeroed by the caller; scratch: rows * nb * ceil(m / 1024) int32.
// nb = B + 1. Returns cudaGetLastError().
extern "C" int bucket_ranks_lanes_launch(const int* keys,
                                         const unsigned char* lanes,
                                         int* rank, int* counts,
                                         int* lane_counts, int* scratch,
                                         int rows, long long m, int nb, int q,
                                         void* stream) {
  if (nb < 1 || nb > kMaxBuckets || rows < 1 || rows > 65535 || m < 1 ||
      q < 1)
    return (int)cudaErrorInvalidValue;
  const long long tile_bytes = (long long)nb * (q + 1) * (long long)4;
  if (tile_bytes > kMaxLaneTileBytes) return (int)cudaErrorInvalidValue;
  const long long nchunks = (m + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec16 =
      q % 16 == 0 && (reinterpret_cast<std::uintptr_t>(lanes) & 15u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)nchunks, (unsigned)rows);
  count_lanes_kernel<<<grid, kChunk, (size_t)tile_bytes, s>>>(
      keys, lanes, scratch, lane_counts, m, nb, (int)nchunks, q, vec16);
  scan_kernel<<<dim3((unsigned)nb, (unsigned)rows), 1024, 0, s>>>(
      scratch, counts, nb, (int)nchunks);
  rank_kernel<<<grid, kChunk, 0, s>>>(keys, scratch, rank, m, nb,
                                      (int)nchunks);
  return (int)cudaGetLastError();
}
