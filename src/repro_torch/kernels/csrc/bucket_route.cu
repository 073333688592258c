// Stable bucket ranks for the routed exchange, for Hopper (sm_90a): one
// pass over the keys with a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//
// bucket_ranks replaces src/repro/kernels/bucket_route.py:87,
// bucket_ranks_pallas (the Pallas `_kernel`). For each row of keys in
// [0, B] (B = the sentinel, still ranked and counted) it computes every
// key's stable arrival rank within its bucket and the (B + 1) occupancy
// histogram of the row. A key outside [0, B] gets rank 0 and is counted
// in no bucket, as in the Pallas kernel (its one-hot row is all zero).
//
// bucket_ranks_lanes replaces src/repro/kernels/bucket_route.py:128,
// bucket_ranks_lanes_pallas (`_kernel_lanes`), the one route pass of the
// batched query plane: the same ranks and histogram, plus per row
// lane_counts[b][q] = #{i : key[i] == b < B and lanes[i][q] == 1} for Q
// query lanes whose membership arrives as (M, Q) bytes of 0 or 1. The
// TPU kernel gets it from an f32 one-hot matmul on the MXU; here it is
// counted with warp bit operations and integer atomics. Both drop the
// sentinel bucket's lane counts, so the membership bytes of sentinel (and
// out-of-range) entries, all zero by the caller's contract, are never read.
//
// Bound: memory. bucket_ranks must read each 4-byte key and write its
// 4-byte rank: 8 bytes per key. bucket_ranks_lanes adds the Q membership
// bytes of each real (non-sentinel) entry, and (B + 1)(Q + 1) counts per
// row. Neither does more than a few integer operations per byte.
//
// Design. The TPU kernel is a sequential grid that carries the running
// occupancy from chunk to chunk. Here one launch covers every row, a block
// of 512 threads per tile of kTile = 8192 keys, and the carry becomes a
// chained scan:
//   1. A block draws its tile from an atomic ticket, not from blockIdx.
//      Tickets run over (tile, row) with the row fastest, so a tile's
//      predecessors in its row drew earlier tickets: they are running or
//      done, and the look-back never waits on a block that was not
//      scheduled. No deadlock. (Row fastest also spreads the tiles in
//      flight over the rows, which keeps each look-back short.)
//   2. Each warp loads its 512 consecutive keys, 16 a thread, coalesced,
//      into registers, and ranks them in key order: slot by slot, one
//      ballot per bit of the bucket id finds the equal keys, the group's
//      lowest thread reads and advances the warp's count of that bucket in
//      shared memory, and a key's rank is that count plus the number of
//      its lower peers.
//   3. A scan over the 16 warps gives each warp's offset and the tile's
//      count per bucket, which the block publishes at once as a status
//      word per bucket: (tag, count), the tag marking it an aggregate (an
//      inclusive prefix in a row's first tile).
//   4. One warp per bucket looks back over up to 32 earlier tiles of the
//      row at a time, waiting until each has published, and sums their
//      counts back to the nearest inclusive prefix. It publishes the
//      tile's inclusive prefix, so later tiles stop there.
//   5. Each key's rank = the exclusive prefix of its bucket + its warp's
//      offset + its rank in the warp, written once. The row's last tile
//      writes the row's histogram from its inclusive prefixes.
//   6. The lanes kernel then counts the tile's lanes, so no later tile's
//      look-back waits on it. A slot with no real key reads nothing. For
//      Q a multiple of 32 on 16-byte aligned rows (the batched plane's
//      Q = 32), a thread packs its entry's 32 bytes into a bit row, a warp
//      transpose of the 32 x 32 bit matrix (five shuffle steps) gives lane
//      l the slot's members of lane c0 + l, and per group of equal keys
//      one popcount and one shared atomic on 32 distinct words count them;
//      the next slot's bytes load meanwhile. Other Q ballot each lane. The
//      tile adds its (B + 1) x (Q + 1) shared counts to a per-row
//      accumulator with integer atomics, and the row's last tile to
//      finish (a per-row count of finished tiles) moves the sums out.
// The keys are read once and the ranks written once: 8 bytes per key,
// plus tiles x (B + 1) 8-byte status words. One kernel launch per call,
// no memset. The status words carry the call's epoch in their tag, so
// the words of earlier calls never count. The epoch lives on the device,
// in the high half of the ticket word: every block reads it with its
// ticket, and the last block to draw a ticket advances it and resets the
// ticket in one exchange. So a call captured into a CUDA graph reads a
// new epoch on every replay; nothing of the host's is frozen into it.
// The epoch runs 1 .. kEpochLimit; the call at kEpochLimit also zeroes
// every status word the scratch holds (its last block to finish, after
// every look-back of the call is done), so the epochs that follow never
// meet a tag of the previous lap. The per-row finished-tile counts and
// the accumulator are restored to zero by the kernel itself (by the last
// tile of each row).
//
// Exact and bit-identical: ranks and counts are integers that depend only
// on key positions; the look-back adds the same integers whichever tiles
// it finds published, and integer atomics are order-free.
//
// Two kernels of each kind, the narrow ranks_kernel and the wide
// wide_ranks_kernel. The narrow one, for B + 1 <= kMaxBuckets (64), at
// most 65,535 rows (gridDim.y, a row's tiles on gridDim.x) and a lane tile
// that fits shared memory (past 48 KB with the opt-in), keeps its
// per-warp counts in a static (16, 64) shared array and a key + 1 in the
// low 7 bits of a slot. The wide one takes any B + 1 up to 2^22 - 1 (a key
// + 1 in the low 22 bits, the rank in the warp, < 512, in the 9 above): its
// per-warp counts, the tile's counts and its exclusive prefixes, (16 + 2)
// x (B + 1) ints, live in dynamic shared memory (the opt-in above 48 KB,
// up to the card's per-block limit) or, beyond it, in a per-block slab of
// global memory (`work`) that the block zeroes itself. Every warp's
// look-back takes ceil((B + 1) / 16) buckets. A lane tile that does not
// fit beside them is not staged in shared memory: each tile adds its lane
// counts straight into the row's global accumulator with integer atomics,
// and the row's last tile moves the sums out as before. The host
// (kernels/bucket_route.py, launch_plan) picks the kernel and the places;
// the launcher checks its byte counts against the device.
//
// The wide kernel puts the tiles of all rows on gridDim.x (a ticket per
// block, at most 2^31 - 1 of them), so it also takes any number of rows:
// the host sends more than 65,535 rows to it whatever B is.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;  // keys a thread holds
constexpr int kWarpKeys = 32 * kPerThread;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxBuckets = 64;  // the narrow kernel's B + 1
constexpr unsigned kFull = 0xffffffffu;
// the narrow kernel's static shared arrays take under this; the rest of the
// device's per-block opt-in is left to the dynamic part
constexpr long long kStaticReserve = 8192;
// a block's dynamic shared memory without cudaFuncSetAttribute
constexpr long long kDefaultDynamic = 48 * 1024 - kStaticReserve;
// the wide kernel's slot: key + 1 in the low kWideKeyBits bits
constexpr int kWideKeyBits = 22;
constexpr long long kMaxGrid = 0x7fffffffLL;  // gridDim.x
constexpr long long kMaxGridRows = 65535;     // gridDim.y: the narrow rows

// the epochs of the status tags run 1 .. kEpochLimit
constexpr unsigned kEpochLimit = 1u << 30;

struct Args {
  const int* keys;                 // (rows, m)
  const unsigned char* lanes;      // (rows, m, q), rows lanes_stride apart
  int* rank;                       // (rows, m)
  int* counts;                     // (rows, nb)
  int* lane_counts;                // (rows, nb, q), lanes kernel only
  unsigned long long* status;      // rows * tiles_per_row * nb words
  long long status_words;          // words the status buffer holds
  // ctrl[0]: (epoch - 1) << 32 | ticket, ticket 0 between calls;
  // ctrl[1]: finished blocks of a call at kEpochLimit, 0 between calls
  unsigned long long* ctrl;
  unsigned* row_done;              // (rows,), zero between calls
  int* lane_acc;                   // (rows, nb, q), zero between calls
  long long m;
  long long lanes_stride;          // bytes from one row of lanes to the next
  long long tiles_per_row;
  int nb;
  int q;
  bool vec16;                      // q % 16 == 0 and lanes 16-byte aligned
  // the wide kernel's
  bool counts_shared;              // the counts in dynamic shared memory
  bool lanes_shared;               // the lane tile after them
  int* work;                       // counts in global memory: per block
                                   // (kWarps + 2) * nb ints
  long long rows;
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned tag, unsigned count) {
  const unsigned long long v =
      ((unsigned long long)tag << 32) | (unsigned long long)count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The lanes of the warp whose key equals this lane's, from one ballot per
// bit of key + 1 (in 0 .. nb, so nbits = bit width of nb): cheaper than
// __match_any_sync for the few bits a bucket id has.
__device__ __forceinline__ unsigned peers_of(int key, int nbits) {
  const unsigned v = (unsigned)(key + 1);
  unsigned peers = kFull;
  for (int b = 0; b < nbits; ++b) {  // uniform trip count
    const unsigned bit = (v >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// Adds 16 membership bytes of a slot's entries (from lane q0 on) to the
// shared lane tile: for each lane a ballot of the members, and the lowest
// thread of each group of equal keys adds its group's popcount.
__device__ __forceinline__ void ballot_bytes(int* tile, int stride, int key,
                                             unsigned peers, bool leader,
                                             int q0, int q, const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (q0 + j >= q) break;  // uniform: every thread of the warp breaks
    const unsigned set =
        __ballot_sync(kFull, ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0u);
    const int n = __popc(set & peers);
    if (leader && n) atomicAdd(&tile[key * stride + q0 + j], n);
  }
}

// Q membership bytes of one entry from byte q0 on, 16 of them, zero past q.
__device__ __forceinline__ uint4 load_bytes(const unsigned char* mine, int q0,
                                            int q) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (q0 + j < q) w[j >> 2] |= (unsigned)mine[q0 + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 32 membership bytes of this thread's entry in a slot (16-byte aligned)
// as two 16-byte loads; zeros, and no load, unless the entry is real. The
// slot's key + 1 lies in its kKeyMask bits.
template <int kKeyMask = 127>
__device__ __forceinline__ void load32(const unsigned char* slot_lanes, int q,
                                       int lane, int slot, int nb, uint4* v) {
  const int k = (slot & kKeyMask) - 1;
  v[0] = v[1] = make_uint4(0u, 0u, 0u, 0u);
  if (k >= 0 && k < nb - 1) {
    const uint4* p = reinterpret_cast<const uint4*>(slot_lanes + lane * q);
    v[0] = p[0];
    v[1] = p[1];
  }
}

// Lane l's column of the slot: bit e set when entry e (the entry of lane e)
// is a member of the l-th of the 32 lanes in v. Each thread packs its 32
// bytes into a 32-bit row, then a warp transpose of the 32 x 32 bit matrix
// (five shuffle steps, each swapping two off-diagonal blocks) turns rows
// into columns.
__device__ __forceinline__ unsigned column_bits(const uint4* v, int lane) {
  const unsigned w[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                         v[1].x, v[1].y, v[1].z, v[1].w};
  unsigned x = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    x |= ((w[c] * 0x01020408u) >> 24) << (4 * c);  // 0/1 bytes to 4 bits
  }
  const unsigned lo[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                          0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const unsigned y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~lo[s]) | ((y >> j) & lo[s])
                   : (x & lo[s]) | ((y & lo[s]) << j);
  }
  return x;
}

// The end of a call at kEpochLimit, the last of an epoch lap: its last
// block to finish zeroes every status word the scratch holds. By then no
// block of the call reads a status word any more (each counts itself
// finished after its look-back), and the next call, in stream order,
// starts the lap again at epoch 1 on zeroed words. Every thread calls it.
__device__ __forceinline__ void end_of_call(const Args& a,
                                            unsigned long long total,
                                            unsigned epoch) {
  __shared__ bool s_clear;
  if (epoch != kEpochLimit) return;  // the same for every block of a call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_clear = atomicAdd(a.ctrl + 1, 1ull) == total - 1;
  }
  __syncthreads();
  if (s_clear) {
    __threadfence();
    for (long long j = threadIdx.x; j < a.status_words; j += kThreads)
      a.status[j] = 0ull;
    if (threadIdx.x == 0) a.ctrl[1] = 0ull;
  }
}

// Launches of the bucket_ranks kernels (narrow and wide, [0]) and the
// bucket_ranks_lanes kernels ([1]) since the library loaded, each counted
// by the block that draws ticket 0: a launch replayed from a captured CUDA
// graph counts too, which no host-side count can see.
__device__ unsigned long long g_launches[2];

// The narrow kernel: B + 1 <= kMaxBuckets, rows <= 65,535 on gridDim.y.
template <bool kLanes>
__global__ void __launch_bounds__(kThreads, 2)
    ranks_kernel(const Args a) {
  __shared__ int wcount[kWarps][kMaxBuckets];  // counts, then warp offsets
  __shared__ int tile_agg[kMaxBuckets];
  __shared__ int tile_excl[kMaxBuckets];  // earlier tiles of the row
  __shared__ unsigned long long s_tile;
  __shared__ unsigned s_epoch;
  __shared__ bool s_last;
  extern __shared__ int lane_tile[];  // kLanes: nb rows of q + 1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nb, nbits = 32 - __clz(nb);
  const unsigned long long total = (unsigned long long)gridDim.x * gridDim.y;
  if (threadIdx.x == 0) {
    // the ticket and the call's epoch in one draw; the last draw moves the
    // word on to the next call's epoch and ticket 0
    const unsigned long long word = atomicAdd(a.ctrl, 1ull);
    const unsigned long long t = word & 0xffffffffull;
    const unsigned epoch = (unsigned)(word >> 32) + 1u;
    if (t == total - 1)
      atomicExch(a.ctrl, (unsigned long long)(epoch == kEpochLimit ? 0u
                                                                   : epoch)
                             << 32);
    if (t == 0) atomicAdd(&g_launches[kLanes], 1ull);
    s_tile = t;
    s_epoch = epoch;
  }
  for (int j = threadIdx.x; j < kWarps * kMaxBuckets; j += kThreads)
    (&wcount[0][0])[j] = 0;
  if (kLanes)
    for (int j = threadIdx.x; j < nb * (a.q + 1); j += kThreads)
      lane_tile[j] = 0;
  __syncthreads();

  // tickets run over (tile, row) with the row fastest, so the tiles in
  // flight spread over every row and each row's look-back stays short
  const long long tile = (long long)s_tile;
  const long long row = tile % gridDim.y;
  const long long in_row = tile / gridDim.y;
  // this warp's keys: first + j * 32 + lane, j < kPerThread, of the row
  const long long first = in_row * kTile + (long long)warp * kWarpKeys;
  const int left = (int)min(a.m - first, (long long)kWarpKeys);  // may be <= 0
  const int* keys = a.keys + row * a.m + first;

  // key + 1 (0: no bucket) in the low 7 bits, the rank within the warp's
  // keys above them
  int slot[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * 32 + lane;
    const int k = i < left ? keys[i] : -1;
    slot[j] = (k >= 0 && k < nb) ? k + 1 : 0;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = slot[j] - 1;
    const unsigned peers = peers_of(k, nbits);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && k >= 0) {
      before = wcount[warp][k];
      wcount[warp][k] = before + __popc(peers);
    }
    const int within = __shfl_sync(kFull, before, leader) +
                       __popc(peers & ((1u << lane) - 1u));
    slot[j] |= within << 7;
    __syncwarp();
  }
  __syncthreads();

  // warp offsets and the tile's counts, published at once
  unsigned long long* status = a.status + row * a.tiles_per_row * nb;
  const unsigned tag_agg = 2u * s_epoch, tag_incl = tag_agg + 1u;
  if ((int)threadIdx.x < nb) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w][threadIdx.x];
      wcount[w][threadIdx.x] = run;
      run += c;
    }
    tile_agg[threadIdx.x] = run;
    if (in_row == 0) tile_excl[threadIdx.x] = 0;
    store_status(status + in_row * nb + threadIdx.x,
                 in_row == 0 ? tag_incl : tag_agg, (unsigned)run);
  }
  __syncthreads();

  // look-back: one warp per bucket, 32 earlier tiles at a time
  if (in_row > 0) {
    for (int b = warp; b < nb; b += kWarps) {
      unsigned excl = 0;
      for (long long newest = in_row - 1;; newest -= 32) {
        const long long p = newest - lane;
        bool incl = true;  // before the row's first tile: nothing to add
        unsigned count = 0;
        if (p >= 0) {
          unsigned long long word;
          unsigned tag;
          do {
            word = load_status(status + p * nb + b);
            tag = (unsigned)(word >> 32);
          } while (tag != tag_agg && tag != tag_incl);
          incl = tag == tag_incl;
          count = (unsigned)word;
        }
        const unsigned found = __ballot_sync(kFull, incl);
        const int stop = found ? __ffs(found) - 1 : 31;
        excl += __reduce_add_sync(kFull, lane <= stop ? count : 0u);
        if (found) break;
      }
      if (lane == 0) {
        tile_excl[b] = (int)excl;
        store_status(status + in_row * nb + b, tag_incl,
                     excl + (unsigned)tile_agg[b]);
      }
    }
  }
  __syncthreads();

  int* rank = a.rank + row * a.m + first;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * 32 + lane, k = (slot[j] & 127) - 1;
    if (i < left)
      rank[i] = k >= 0 ? tile_excl[k] + wcount[warp][k] + (slot[j] >> 7) : 0;
  }
  if (in_row == a.tiles_per_row - 1 && (int)threadIdx.x < nb)
    a.counts[row * nb + threadIdx.x] =
        tile_excl[threadIdx.x] + tile_agg[threadIdx.x];
  if (!kLanes) {
    end_of_call(a, total, s_epoch);
    return;
  }

  // lane counts, after the ranks so that no later tile waits on them. Each
  // slot with a real (not sentinel) key reads the members' bytes; a
  // sentinel's are never read.
  const int q = a.q, stride = q + 1;
  const unsigned char* lanes = a.lanes + row * a.lanes_stride + first * q;
  if (a.vec16 && q % 32 == 0) {
    // 32 lanes at a time (the batched plane's Q = 32: once), each entry's
    // 32 bytes as two 16-byte loads, the next slot's issued before this
    // one's are counted. Lane l takes column c0 + l of the slot's bit
    // matrix and adds its members per group of equal keys: one shared
    // atomic per group, on 32 distinct words.
    for (int c0 = 0; c0 < q; c0 += 32) {
      const unsigned char* base = lanes + c0;
      uint4 cur[2], nxt[2];
      load32(base, q, lane, slot[0], nb, cur);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (j + 1 < kPerThread)
          load32(base + (j + 1) * 32 * q, q, lane, slot[j + 1], nb, nxt);
        const int k = (slot[j] & 127) - 1;
        unsigned todo = __ballot_sync(kFull, k >= 0 && k < nb - 1);
        if (todo) {  // uniform
          const unsigned col = column_bits(cur, lane);
          const unsigned peers = peers_of(k, nbits);
          do {
            const int lead = __ffs(todo) - 1;
            const unsigned group = __shfl_sync(kFull, peers, lead);
            const int key = __shfl_sync(kFull, k, lead);
            const int n = __popc(col & group);
            if (n) atomicAdd(&lane_tile[key * stride + c0 + lane], n);
            todo &= ~group;
          } while (todo);
        }
        if (j + 1 < kPerThread) {
          cur[0] = nxt[0];
          cur[1] = nxt[1];
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = j * 32 + lane, k = (slot[j] & 127) - 1;
      const bool real = k >= 0 && k < nb - 1;
      if (!__any_sync(kFull, real)) continue;  // sentinels: nothing to read
      const unsigned peers = peers_of(k, nbits);
      const bool leader = (peers & ((1u << lane) - 1u)) == 0u && real;
      const unsigned char* mine = lanes + (long long)(real ? i : 0) * q;
      for (int q0 = 0; q0 < q; q0 += 16) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (real)
          v = a.vec16 ? *reinterpret_cast<const uint4*>(mine + q0)
                      : load_bytes(mine, q0, q);
        ballot_bytes(lane_tile, stride, k, peers, leader, q0, q, v);
      }
    }
  }
  __syncthreads();

  // the tile's lane counts into the row's accumulator; the row's last
  // tile to finish moves the sums out and leaves the accumulator zero
  int* acc = a.lane_acc + row * nb * q;
  for (int j = threadIdx.x; j < nb * q; j += kThreads) {
    const int t = lane_tile[(j / q) * stride + j % q];
    if (t) atomicAdd(&acc[j], t);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&a.row_done[row], 1u) ==
             (unsigned)(a.tiles_per_row - 1);
  __syncthreads();
  if (s_last) {
    __threadfence();
    int* out = a.lane_counts + row * nb * q;
    for (int j = threadIdx.x; j < nb * q; j += kThreads)
      out[j] = atomicExch(&acc[j], 0);
    if (threadIdx.x == 0) a.row_done[row] = 0u;
  }
  end_of_call(a, total, s_epoch);
}

// The wide kernel: the narrow one's algorithm for any B + 1 up to 2^22 - 1
// and any number of rows (tiles x rows on gridDim.x), its counts in
// dynamic shared memory or global slabs and its lane counts in shared
// memory or the global accumulator (see the header).
template <bool kLanes>
__global__ void __launch_bounds__(kThreads, 2)
    wide_ranks_kernel(const Args a) {
  __shared__ unsigned long long s_tile;
  __shared__ unsigned s_epoch;
  __shared__ bool s_last;
  extern __shared__ int dyn[];  // the counts, then the lane tile, as planned

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = a.nb, nbits = 32 - __clz(nb);
  constexpr int kKeyBits = kWideKeyBits;
  constexpr int kKeyMask = (1 << kKeyBits) - 1;
  // per-warp counts (then warp offsets) at [w * nb + b], the tile's
  // counts, its earlier tiles' counts, and the lane tile (stride q + 1)
  int* counts_base = a.counts_shared
                         ? dyn
                         : a.work + (long long)blockIdx.x * (kWarps + 2) * nb;
  int* wcount = counts_base;
  int* tile_agg = counts_base + kWarps * nb;
  int* tile_excl = tile_agg + nb;
  int* lane_tile = dyn + (kWarps + 2) * nb;
  const bool tile_lanes = a.lanes_shared;
  const int ws = nb;
  const unsigned long long total = gridDim.x;
  if (threadIdx.x == 0) {
    // the ticket and the call's epoch in one draw; the last draw moves the
    // word on to the next call's epoch and ticket 0
    const unsigned long long word = atomicAdd(a.ctrl, 1ull);
    const unsigned long long t = word & 0xffffffffull;
    const unsigned epoch = (unsigned)(word >> 32) + 1u;
    if (t == total - 1)
      atomicExch(a.ctrl, (unsigned long long)(epoch == kEpochLimit ? 0u
                                                                   : epoch)
                             << 32);
    if (t == 0) atomicAdd(&g_launches[kLanes], 1ull);
    s_tile = t;
    s_epoch = epoch;
  }
  for (int j = threadIdx.x; j < kWarps * ws; j += kThreads) wcount[j] = 0;
  if (kLanes && tile_lanes)
    for (int j = threadIdx.x; j < nb * (a.q + 1); j += kThreads)
      lane_tile[j] = 0;
  __syncthreads();

  // tickets run over (tile, row) with the row fastest, so the tiles in
  // flight spread over every row and each row's look-back stays short
  const long long tile = (long long)s_tile;
  const long long row = tile % a.rows;
  const long long in_row = tile / a.rows;
  // this warp's keys: first + j * 32 + lane, j < kPerThread, of the row
  const long long first = in_row * kTile + (long long)warp * kWarpKeys;
  const int left = (int)min(a.m - first, (long long)kWarpKeys);  // may be <= 0
  const int* keys = a.keys + row * a.m + first;

  // key + 1 (0: no bucket) in the low kKeyBits bits, the rank within the
  // warp's keys above them
  int slot[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * 32 + lane;
    const int k = i < left ? keys[i] : -1;
    slot[j] = (k >= 0 && k < nb) ? k + 1 : 0;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = slot[j] - 1;
    const unsigned peers = peers_of(k, nbits);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && k >= 0) {
      before = wcount[warp * ws + k];
      wcount[warp * ws + k] = before + __popc(peers);
    }
    const int within = __shfl_sync(kFull, before, leader) +
                       __popc(peers & ((1u << lane) - 1u));
    slot[j] |= within << kKeyBits;
    __syncwarp();
  }
  __syncthreads();

  // warp offsets and the tile's counts, published at once
  unsigned long long* status = a.status + row * a.tiles_per_row * nb;
  const unsigned tag_agg = 2u * s_epoch, tag_incl = tag_agg + 1u;
  auto publish = [&](int b) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w * ws + b];
      wcount[w * ws + b] = run;
      run += c;
    }
    tile_agg[b] = run;
    if (in_row == 0) tile_excl[b] = 0;
    store_status(status + in_row * nb + b, in_row == 0 ? tag_incl : tag_agg,
                 (unsigned)run);
  };
  for (int b = threadIdx.x; b < nb; b += kThreads) publish(b);
  __syncthreads();

  // look-back: one warp per bucket, 32 earlier tiles at a time
  if (in_row > 0) {
    for (int b = warp; b < nb; b += kWarps) {
      unsigned excl = 0;
      for (long long newest = in_row - 1;; newest -= 32) {
        const long long p = newest - lane;
        bool incl = true;  // before the row's first tile: nothing to add
        unsigned count = 0;
        if (p >= 0) {
          unsigned long long word;
          unsigned tag;
          do {
            word = load_status(status + p * nb + b);
            tag = (unsigned)(word >> 32);
          } while (tag != tag_agg && tag != tag_incl);
          incl = tag == tag_incl;
          count = (unsigned)word;
        }
        const unsigned found = __ballot_sync(kFull, incl);
        const int stop = found ? __ffs(found) - 1 : 31;
        excl += __reduce_add_sync(kFull, lane <= stop ? count : 0u);
        if (found) break;
      }
      if (lane == 0) {
        tile_excl[b] = (int)excl;
        store_status(status + in_row * nb + b, tag_incl,
                     excl + (unsigned)tile_agg[b]);
      }
    }
  }
  __syncthreads();

  int* rank = a.rank + row * a.m + first;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = j * 32 + lane, k = (slot[j] & kKeyMask) - 1;
    if (i < left)
      rank[i] = k >= 0 ? tile_excl[k] + wcount[warp * ws + k] +
                             (slot[j] >> kKeyBits)
                       : 0;
  }
  if (in_row == a.tiles_per_row - 1)
    for (int b = threadIdx.x; b < nb; b += kThreads)
      a.counts[row * nb + b] = tile_excl[b] + tile_agg[b];
  if (!kLanes) {
    end_of_call(a, total, s_epoch);
    return;
  }

  // lane counts, after the ranks so that no later tile waits on them. Each
  // slot with a real (not sentinel) key reads the members' bytes; a
  // sentinel's are never read. Counted into the shared tile, or straight
  // into the row's accumulator when the tile does not fit.
  const int q = a.q;
  int* acc = a.lane_acc + row * nb * q;
  int* counts_to = tile_lanes ? lane_tile : acc;
  const int stride = tile_lanes ? q + 1 : q;
  const unsigned char* lanes = a.lanes + row * a.lanes_stride + first * q;
  if (a.vec16 && q % 32 == 0) {
    // 32 lanes at a time (the batched plane's Q = 32: once), each entry's
    // 32 bytes as two 16-byte loads, the next slot's issued before this
    // one's are counted. Lane l takes column c0 + l of the slot's bit
    // matrix and adds its members per group of equal keys: one shared
    // atomic per group, on 32 distinct words.
    for (int c0 = 0; c0 < q; c0 += 32) {
      const unsigned char* base = lanes + c0;
      uint4 cur[2], nxt[2];
      load32<kKeyMask>(base, q, lane, slot[0], nb, cur);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (j + 1 < kPerThread)
          load32<kKeyMask>(base + (j + 1) * 32 * q, q, lane, slot[j + 1],
                           nb, nxt);
        const int k = (slot[j] & kKeyMask) - 1;
        unsigned todo = __ballot_sync(kFull, k >= 0 && k < nb - 1);
        if (todo) {  // uniform
          const unsigned col = column_bits(cur, lane);
          const unsigned peers = peers_of(k, nbits);
          do {
            const int lead = __ffs(todo) - 1;
            const unsigned group = __shfl_sync(kFull, peers, lead);
            const int key = __shfl_sync(kFull, k, lead);
            const int n = __popc(col & group);
            if (n) atomicAdd(&counts_to[key * stride + c0 + lane], n);
            todo &= ~group;
          } while (todo);
        }
        if (j + 1 < kPerThread) {
          cur[0] = nxt[0];
          cur[1] = nxt[1];
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int i = j * 32 + lane, k = (slot[j] & kKeyMask) - 1;
      const bool real = k >= 0 && k < nb - 1;
      if (!__any_sync(kFull, real)) continue;  // sentinels: nothing to read
      const unsigned peers = peers_of(k, nbits);
      const bool leader = (peers & ((1u << lane) - 1u)) == 0u && real;
      const unsigned char* mine = lanes + (long long)(real ? i : 0) * q;
      for (int q0 = 0; q0 < q; q0 += 16) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (real)
          v = a.vec16 ? *reinterpret_cast<const uint4*>(mine + q0)
                      : load_bytes(mine, q0, q);
        ballot_bytes(counts_to, stride, k, peers, leader, q0, q, v);
      }
    }
  }
  __syncthreads();

  // the tile's lane counts into the row's accumulator; the row's last
  // tile to finish moves the sums out and leaves the accumulator zero
  if (tile_lanes)
    for (int j = threadIdx.x; j < nb * q; j += kThreads) {
      const int t = lane_tile[(j / q) * stride + j % q];
      if (t) atomicAdd(&acc[j], t);
    }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&a.row_done[row], 1u) ==
             (unsigned)(a.tiles_per_row - 1);
  __syncthreads();
  if (s_last) {
    __threadfence();
    int* out = a.lane_counts + row * nb * q;
    for (int j = threadIdx.x; j < nb * q; j += kThreads)
      out[j] = atomicExch(&acc[j], 0);
    if (threadIdx.x == 0) a.row_done[row] = 0u;
  }
  end_of_call(a, total, s_epoch);
}

long long tiles_per_row(long long m) { return (m + kTile - 1) / kTile; }

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <bool kLanes, bool kWide>
int start(const Args& a, long long dyn_bytes, cudaStream_t s) {
  const auto kernel =
      kWide ? wide_ranks_kernel<kLanes> : ranks_kernel<kLanes>;
  if (dyn_bytes > kDefaultDynamic) {  // the opt-in; never on the narrow
    // kernel's usual launches (a lane tile of at most 32 KB)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid = kWide ? dim3((unsigned)(a.tiles_per_row * a.rows))
                         : dim3((unsigned)a.tiles_per_row, (unsigned)a.rows);
  kernel<<<grid, kThreads, (size_t)dyn_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// wide: 0 = the narrow kernel, 1 = the wide one. dyn_bytes: the dynamic
// shared memory the host's plan gives the launch; work_words: the ints at
// a.work (wide kernel with its counts in global memory).
int launch(const Args& a, bool lanes, int wide, long long dyn_bytes,
           long long work_words, void* stream) {
  const long long counts_bytes = (long long)(kWarps + 2) * a.nb * 4;
  const long long lane_bytes = lanes ? (long long)a.nb * (a.q + 1) * 4 : 0;
  const long long want =
      !wide ? lane_bytes
            : (a.counts_shared ? counts_bytes : 0) +
                  (a.lanes_shared ? lane_bytes : 0);
  if (a.nb < 1 || a.rows < 1 || a.m < 1 || a.q < 0 ||
      a.nb > (wide ? (1 << kWideKeyBits) - 1 : kMaxBuckets) ||
      (!wide && a.rows > kMaxGridRows) ||
      a.tiles_per_row != tiles_per_row(a.m) ||
      a.tiles_per_row * a.rows > kMaxGrid ||  // tickets, gridDim.x
      a.status_words < a.tiles_per_row * a.rows * a.nb ||
      dyn_bytes != want || (a.lanes_shared && !a.counts_shared) ||
      (wide && !a.counts_shared &&
       work_words < a.tiles_per_row * a.rows * (kWarps + 2) * a.nb) ||
      (dyn_bytes > kDefaultDynamic &&
       dyn_bytes > (long long)smem_optin() - kStaticReserve))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes)
    return wide ? start<true, true>(a, dyn_bytes, s)
                : start<true, false>(a, dyn_bytes, s);
  return wide ? start<false, true>(a, dyn_bytes, s)
              : start<false, false>(a, dyn_bytes, s);
}

}  // namespace

// 8-byte status words both kernels need for (rows, m) keys in nb buckets.
extern "C" long long bucket_ranks_status_words(long long rows, long long m,
                                               int nb) {
  return rows * tiles_per_row(m) * nb;
}

// out[0], out[1]: launches of bucket_ranks and bucket_ranks_lanes since
// the library loaded, read after the device has finished all its work.
extern "C" int bucket_ranks_device_launches(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return (int)err;
}

// The last epoch of a lap (see the header): the scratch's ctrl[0] holds
// (epoch - 1) << 32 between calls.
extern "C" unsigned bucket_ranks_epoch_limit() { return kEpochLimit; }

// The current device's shared memory a block may opt in to (bytes).
extern "C" int bucket_ranks_smem_optin() { return smem_optin(); }

// keys, rank: (rows, m) int32; counts: (rows, nb) int32, all written.
// status: status_words >= bucket_ranks_status_words(rows, m, nb) 8-byte
// words, zero when first used, then left to the kernel (a call at the
// epoch limit zeroes all status_words of them). ctrl: 2 8-byte words,
// zero when first used, then left to the kernel: the epoch and the
// ticket, and the count of finished blocks of a call at the epoch limit.
// nb = B + 1. wide, counts_shared, dyn_bytes, work, work_words: the
// host's launch plan (kernels/bucket_route.py, launch_plan), checked here.
// Returns cudaGetLastError().
extern "C" int bucket_ranks_launch(const int* keys, int* rank, int* counts,
                                   void* status, long long status_words,
                                   void* ctrl, long long rows, long long m,
                                   int nb, int wide, int counts_shared,
                                   long long dyn_bytes, void* work,
                                   long long work_words, void* stream) {
  Args a{};
  a.keys = keys;
  a.rank = rank;
  a.counts = counts;
  a.status = static_cast<unsigned long long*>(status);
  a.status_words = status_words;
  a.ctrl = static_cast<unsigned long long*>(ctrl);
  a.work = static_cast<int*>(work);
  a.rows = rows;
  a.m = m;
  a.tiles_per_row = tiles_per_row(m);
  a.nb = nb;
  a.counts_shared = counts_shared != 0;
  return launch(a, false, wide, dyn_bytes, work_words, stream);
}

// As bucket_ranks_launch, plus lanes: (rows, m, q) bytes, 1 = a member,
// 0 = not, each row's (m, q) block contiguous and lanes_stride bytes
// after the last; lane_counts: (rows, nb, q) int32, all written; zero:
// >= rows + rows * nb * q 4-byte words (the rows' finished-tile counts,
// the lane accumulator), zero between calls (the kernel restores it).
// The plan as for bucket_ranks_launch, plus lanes_shared. Returns
// cudaGetLastError().
extern "C" int bucket_ranks_lanes_launch(
    const int* keys, const unsigned char* lanes, int* rank, int* counts,
    int* lane_counts, void* status, long long status_words, void* ctrl,
    void* zero, long long rows, long long m, int nb, int q,
    long long lanes_stride, int wide, int counts_shared, int lanes_shared,
    long long dyn_bytes, void* work, long long work_words, void* stream) {
  Args a{};
  a.keys = keys;
  a.lanes = lanes;
  a.rank = rank;
  a.counts = counts;
  a.lane_counts = lane_counts;
  a.status = static_cast<unsigned long long*>(status);
  a.status_words = status_words;
  a.ctrl = static_cast<unsigned long long*>(ctrl);
  a.row_done = static_cast<unsigned*>(zero);
  a.lane_acc = static_cast<int*>(zero) + rows;
  a.work = static_cast<int*>(work);
  a.rows = rows;
  a.m = m;
  a.tiles_per_row = tiles_per_row(m);
  a.nb = nb;
  a.q = q;
  a.lanes_stride = lanes_stride;
  a.vec16 = q % 16 == 0 && lanes_stride % 16 == 0 &&
            (reinterpret_cast<std::uintptr_t>(lanes) & 15u) == 0;
  a.counts_shared = counts_shared != 0;
  a.lanes_shared = lanes_shared != 0;
  return launch(a, true, wide, dyn_bytes, work_words, stream);
}
