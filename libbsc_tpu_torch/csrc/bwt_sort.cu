// K11-K14: the forward BWT's suffix sort by prefix quadrupling, around
// torch's stable sorts.
//
// Replaces the XLA program of the JAX package's suffix_array
// (libbsc_tpu/ops/bwt.py:265) and _extract_bwt_impl (:754), which the
// port carried over op for op up to PR 13: each round built its keys from
// shifted copies of the ranks (one full-length copy a shift), found the
// group starts with a 1-D cummax (on CUDA torch.cummax runs in one
// block), and scattered ranks and mask with separate passes.  A round is
// now: K11 or K12 (its two int64 keys), two stable torch.sort calls with
// K13's pre-pass between them, and K13 (heads, group starts, ranks, the
// still-unresolved list and its count).  The extraction is K14.
//
// Layouts, kept from the torch version so that every route keeps its
// bytes: ranks are int64 in position order, group-start convention (a
// group's rank is the sorted position of its first member); a round sorts
// by the packed pair (key_a, key_b) of int64s, low key first, both sorts
// stable, so ties keep the input order.
//
// K11 bwt_boot_keys_kernel (JAX _bootstrap, :74): the depth-15 bootstrap's
// keys, bytes 0-11 of suffix p big-endian in key_hi (sign bit flipped, so
// the signed order is the unsigned one) and bytes 12-14 with the clamped
// remaining length min(max(n - p, 1), 15) in key_lo; bytes past the end
// read 0.  In the sample mode (DC3's _dc3_sample_rank) row j is text
// position 3 (j / 2) + j % 2 + 1.  Bound by bytes: 1 read, 16 written a
// row.  A block stages its rows' bytes plus the 14-byte halo in shared
// memory with coalesced loads, so each byte is read from device memory
// once, and each thread writes its rows' keys coalesced.
//
// K12 bwt_round_keys_kernel (JAX _full_round4 :153, _bucket_round_compact4
// :222): a round's keys from rank at i, i + k, i + 2k, i + 3k (-1 past the
// end): key_a = r(i) 2^32 + r(i+k) + 1, key_b = (r(i+2k) + 1) 2^32 +
// r(i+3k) + 1, over all n rows or over the unresolved positions uidx.
// Bound by bytes: 8 read (the rank, once), 16 written a row.  One thread a
// row, four loads that are each coalesced over all n; what it replaces
// wrote three shifted full-length copies of the ranks first.
//
// K13 (JAX _rank_mask_to_position_order :120, and the heads and cummax of
// _bucket_round_compact4 :222): a row of the sorted order is a group head
// when it is row 0 or its (key_a, key_b) differs from the row before's;
// its group start is the last head at or before it, a max scan.  Full
// form: rank[pos] = group start for the row's position pos, and the
// unresolved positions (not head(i) and head(i + 1)) as a list in sorted
// order with its count.  Compact form (rows are the unresolved positions
// uidx): the first-key groups h1 (key_a >> 32 is the old rank) give s1,
// all keys give sall, rank[pos] = old rank + sall - s1, and the list and
// count as above.  Bound by bytes: 41 a row for the function (the sorted
// keys, the permutation, rank and mask); the accesses that cost are the
// random ones, a 32-byte sector each.  Two launches:
//   bwt_heads_pay_kernel, between the two sorts: reads the first sort's
//     values lo_s and indices o1 coalesced, gathers key_hi[o1] (the second
//     sort's input, the gather torch made there before) and writes pay =
//     (the first row of the row's run of equal lo_s) << 32 | pos, so that
//     two rows' low keys are equal exactly when their pay's high halves
//     are: one random access a row, 40 bytes;
//   bwt_heads_kernel: per row o2 and hi_s coalesced and one gather,
//     pay[o2[r]], where the design up to 34e0e9c chained o1[o2[r]] and
//     lo[o1[o2[r]]]; one scatter, rank[pos], where it also scattered a
//     byte mask; the list goes out in sorted order, placed by a second
//     look-back of sums: 32 bytes a row and 8 an unresolved row.
// On the 25 MiB corpus block (NVIDIA H100, 700 W) the mask scatter took
// 1.9 of 34e0e9c's 5.2 ms and the rank scatter 1.7.  The scan is one pass
// over tiles of 1,024 rows with decoupled look-back: a block takes the
// next tile from a counter (so every tile it waits for is already
// running), stages its rows plus one on each side in shared memory (each
// thread's gathers all issued before the first is used), scans them, and
// publishes its tile's last head at once when it has one (a later head
// dominates every earlier one, so such a tile never waits); only a tile
// with no head at its first row reads its predecessors' status words, a
// warp at a time, 32 tiles a step, back to the first that is final.
// torch.cummax, which this replaces, ran in one block: 78.7 ms over 25
// MiB positions on the H100.
//
// K14 (JAX _extract_bwt_impl, :754): U, the primary index and the aux
// indexes straight from the position-order ranks, with no suffix array:
// suffix i != 0 of rank j writes T[i - 1] to U[j + (j < r0)] (r0 = rank of
// suffix 0), suffix 0 writes T[n - 1] to U[0], primary = r0 + 1, aux[t] =
// rank[(t + 1) r] as int32.  Bound by bytes: 10 a row (T and rank read, U
// written).  Writing each byte to its slot is a random one-byte store (a
// 32-byte sector each); instead the ranks are a permutation, so bucket b
// of U's slots [b 2^16, (b + 1) 2^16) receives exactly min(2^16, n - b
// 2^16) bytes and its place in a staging array is known with no count
// pass.  Pass 1 (bwt_extract_bin_kernel) bins a block's 8,192 suffixes by
// bucket in shared memory and writes each bucket's run of u32 entries
// (slot in the bucket << 8 | byte) at a cursor taken by one atomicAdd a
// bucket; pass 2 (bwt_extract_place_kernel, a block a bucket) places the
// bytes in a 64 KiB slice of U in shared memory and writes it coalesced:
// 18 bytes a row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;

// ---------------------------------------------------------------- K11

constexpr int kBootRows = 2048;  // rows a block
// the bytes a block stages: its rows' positions span 1.5 x the rows in
// the sample mode, plus the 14-byte halo
constexpr int kBootBytes = kBootRows * 3 / 2 + 16;

__device__ __forceinline__ i64 boot_pos(i64 j, int sample) {
  return sample ? 3 * (j >> 1) + (j & 1) + 1 : j;
}

__global__ void __launch_bounds__(kThreads)
bwt_boot_keys_kernel(const uint8_t* __restrict__ data, i64 n, i64 rows,
                     int sample, i64* __restrict__ key_hi,
                     i64* __restrict__ key_lo) {
  __shared__ uint8_t tile[kBootBytes];
  const i64 base = (i64)blockIdx.x * kBootRows;
  const i64 last = (base + kBootRows < rows ? base + kBootRows : rows) - 1;
  const i64 p0 = boot_pos(base, sample);
  const int span = (int)(boot_pos(last, sample) - p0) + 15;
  for (int t = threadIdx.x; t < span; t += kThreads)
    tile[t] = p0 + t < n ? data[p0 + t] : 0;
  __syncthreads();
  for (i64 j = base + threadIdx.x; j <= last; j += kThreads) {
    const i64 p = boot_pos(j, sample);
    const uint8_t* b = tile + (p - p0);
    unsigned w[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      w[q] = (unsigned)b[4 * q] << 24 | (unsigned)b[4 * q + 1] << 16 |
             (unsigned)b[4 * q + 2] << 8 | b[4 * q + 3];
    const i64 left = n - p;
    const unsigned rem = left < 1 ? 1u : left > 15 ? 15u : (unsigned)left;
    const unsigned w3 = (unsigned)b[12] << 24 | (unsigned)b[13] << 16 |
                        (unsigned)b[14] << 8 | rem;
    key_hi[j] = (i64)(((u64)w[0] << 32 | w[1]) ^ (1ull << 63));
    key_lo[j] = (i64)(((u64)w[2] << 32 | w3) ^ (1ull << 63));
  }
}

// ---------------------------------------------------------------- K12

__global__ void __launch_bounds__(kThreads)
bwt_round_keys_kernel(const i64* __restrict__ rank, i64 n, i64 k,
                      const i64* __restrict__ uidx, i64 rows,
                      i64* __restrict__ key_a, i64* __restrict__ key_b) {
  const i64 t = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows) return;
  const i64 i = uidx ? __ldg(uidx + t) : t;
  const i64 r1 = __ldg(rank + i);
  const i64 r2 = i + k < n ? __ldg(rank + i + k) : -1;
  const i64 r3 = i + 2 * k < n ? __ldg(rank + i + 2 * k) : -1;
  const i64 r4 = i + 3 * k < n ? __ldg(rank + i + 3 * k) : -1;
  key_a[t] = (i64)((u64)r1 << 32) + r2 + 1;
  key_b[t] = (i64)((u64)(r3 + 1) << 32) + r4 + 1;
}

// ---------------------------------------------------------------- K13

constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // 1,024 rows a tile
constexpr int kWarps = kThreads / 32;
// status word: flag in the top two bits, value below
constexpr u64 kAgg = 1ull << 62;
constexpr u64 kIncl = 2ull << 62;
constexpr u64 kVal = kAgg - 1;
constexpr u64 kHalf = (1ull << 31) - 1;

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

// The max scan's status value: each group start + 1 (0: none) in one
// field (full form), or s1 and sall in two fields of 31 bits (compact).
struct MaxFields {
  __device__ __forceinline__ u64 operator()(u64 a, u64 b) const {
    const u64 lo = (a & kHalf) > (b & kHalf) ? a & kHalf : b & kHalf;
    const u64 hi = (a >> 31) > (b >> 31) ? a >> 31 : b >> 31;
    return hi << 31 | lo;
  }
};

struct MaxOne {
  __device__ __forceinline__ u64 operator()(u64 a, u64 b) const {
    return a > b ? a : b;
  }
};

struct Add {
  __device__ __forceinline__ u64 operator()(u64 a, u64 b) const {
    return a + b;
  }
};

// Warp 0 reads the status words of the tiles before ``tile``, 32 a step
// (lane l the l-th one back), waits for each to be published, and folds
// with ``op`` every value up to and including the nearest final one.
template <typename Op>
__device__ u64 look_back(const u64* status, int tile, Op op) {
  const int lane = threadIdx.x & 31;
  u64 acc = 0;
  for (int p = tile - 1;; p -= 32) {
    const int q = p - lane;
    u64 s = kIncl;  // before tile 0: final, nothing
    if (q >= 0) {
      do {
        s = load_status(status + q);
      } while ((s & ~kVal) == 0);
    }
    const unsigned fin = __ballot_sync(~0u, (s & ~kVal) == kIncl);
    const int first = fin ? __ffs(fin) - 1 : 31;
    u64 v = lane <= first ? s & kVal : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v = op(v, __shfl_xor_sync(~0u, v, d));
    acc = op(acc, v);
    if (fin) return acc;
  }
}

// Exclusive scan of one value a thread over a block of kN threads with
// ``op`` (identity 0); *total gets the block's fold.  Ends synchronized.
template <int kN = kThreads, typename Op>
__device__ u64 block_exclusive(u64 v, Op op, u64* warp_tot, u64* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  u64 x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 y = __shfl_up_sync(~0u, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) warp_tot[w] = x;
  u64 ex = __shfl_up_sync(~0u, x, 1);
  if (lane == 0) ex = 0;
  __syncthreads();
  u64 pre = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kN / 32; ++i) {
    if (i < w) pre = op(pre, warp_tot[i]);
    tot = op(tot, warp_tot[i]);
  }
  *total = tot;
  __syncthreads();
  return op(pre, ex);
}

// K13's pre-pass, between the two sorts.  Row s of the first sort (its
// values lo_s, the low keys sorted, and its indices o1) gets hi1[s] =
// key_hi[o1[s]], the second sort's input, and pay[s] = g(s) << 32 |
// pos(s): g(s) the first row of s's run of equal lo_s (a max scan over the
// tiles with look-back, as the main pass), pos(s) = o1[s], or uidx[o1[s]]
// over the compact round's rows.  Two final rows have equal low keys
// exactly when their g are equal, so the main pass needs neither lo nor
// o1.  Each thread's gathers are issued before the scan and written after
// it, so they are in flight through it.
__global__ void __launch_bounds__(kThreads)
bwt_heads_pay_kernel(const i64* __restrict__ lo_s, const i64* __restrict__ o1,
                     const i64* __restrict__ key_hi,
                     const i64* __restrict__ uidx, i64 m,
                     i64* __restrict__ hi1, i64* __restrict__ pay,
                     u64* status, unsigned* tile_counter) {
  __shared__ i64 s_lo[kTile + 1];
  __shared__ unsigned s_g[kTile];
  __shared__ u64 s_warp[kWarps];
  __shared__ u64 s_pre;
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const i64 base = (i64)tile * kTile;

  // this thread's rows base + tid + j kThreads (coalesced), lo_s at s_lo
  // index row - base + 1, with the row before the tile at 0
  i64 p[kItems], hv[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const i64 r = base + threadIdx.x + j * kThreads;
    p[j] = r < m ? __ldg(o1 + r) : -1;
    if (r < m) s_lo[threadIdx.x + j * kThreads + 1] = __ldg(lo_s + r);
  }
  if (threadIdx.x == 0 && base > 0) s_lo[0] = __ldg(lo_s + base - 1);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (p[j] >= 0) {
      hv[j] = __ldg(key_hi + p[j]);
      if (uidx) p[j] = __ldg(uidx + p[j]);
    }
  __syncthreads();

  // the local max scan over rows base + 4 tid + q: each run start + 1
  const int first = threadIdx.x * kItems;
  u64 loc[kItems];
  u64 run = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const i64 r = base + first + q;
    if (r < m && (r == 0 || s_lo[first + q + 1] != s_lo[first + q]))
      run = (u64)r + 1;
    loc[q] = run;
  }
  u64 tile_max;
  const u64 ex = block_exclusive(run, MaxOne(), s_warp, &tile_max);
  if (threadIdx.x < 32) {
    // a tile that starts a run needs nothing from before it
    const bool own = tile_max != 0;
    const bool starts = base == 0 || s_lo[1] != s_lo[0];
    if (threadIdx.x == 0)
      store_status(status + tile, (own ? kIncl : kAgg) | tile_max);
    u64 pre = 0;
    if (tile > 0 && !starts) pre = look_back(status, tile, MaxOne());
    if (threadIdx.x == 0) {
      if (!own) store_status(status + tile, kIncl | pre);
      s_pre = pre;
    }
  }
  __syncthreads();
  const u64 pre = MaxOne()(s_pre, ex);
#pragma unroll
  for (int q = 0; q < kItems; ++q)
    s_g[first + q] = (unsigned)(MaxOne()(pre, loc[q]) - 1);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (p[j] < 0) continue;
    const int t = threadIdx.x + j * kThreads;
    hi1[base + t] = hv[j];
    pay[base + t] = (i64)((u64)s_g[t] << 32 | (u64)p[j]);
  }
}

// K13's main pass: per row o2[r] and hi_s[r] coalesced and one gather,
// pay[o2[r]]; a row is a head when hi_s or g differs from the row
// before's.  Writes rank[pos] (the one scatter) and the unresolved
// positions in sorted order (a second look-back of sums), and adds the
// tile's count.
template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
bwt_heads_kernel(const i64* __restrict__ hi_s, const i64* __restrict__ o2,
                 const i64* __restrict__ pay, i64 m, i64* __restrict__ rank,
                 i64* __restrict__ still, u64* status, u64* status_sum,
                 unsigned* tile_counter, u64* count) {
  __shared__ i64 s_hi[kTile + 2];
  __shared__ unsigned s_g[kTile + 2], s_pos[kTile];
  __shared__ u64 s_warp[kWarps];
  __shared__ u64 s_pre[2];
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const i64 base = (i64)tile * kTile;

  // rows base - 1 .. base + kTile at s_* index row - base + 1; every
  // gather of a thread issued before the first is used
  constexpr int kLoads = (kTile + 2 + kThreads - 1) / kThreads;
  i64 p[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int t = threadIdx.x + j * kThreads;
    const i64 r = base - 1 + t;
    const bool in = t < kTile + 2 && r >= 0 && r < m;
    p[j] = in ? __ldg(o2 + r) : -1;
    if (in) s_hi[t] = __ldg(hi_s + r);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j)
    if (p[j] >= 0) p[j] = __ldg(pay + p[j]);
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (p[j] < 0) continue;
    const int t = threadIdx.x + j * kThreads;
    s_g[t] = (unsigned)((u64)p[j] >> 32);
    if (t >= 1 && t <= kTile) s_pos[t - 1] = (unsigned)p[j];
  }
  __syncthreads();

  // heads of this thread's rows and of the row after them; bit q of hall
  // / h1 for row base + 4 tid + q, bit 4 for the next row
  const int first = threadIdx.x * kItems;
  unsigned hall = 0, h1 = 0;
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    const i64 r = base + first + q;
    const int t = first + q + 1;
    bool ha = true, hb = true;
    if (r > 0 && r < m) {
      ha = s_hi[t] != s_hi[t - 1] || s_g[t] != s_g[t - 1];
      hb = (s_hi[t] >> 32) != (s_hi[t - 1] >> 32);
    }
    hall |= (unsigned)ha << q;
    h1 |= (unsigned)hb << q;
  }

  // the local max scan: each row's group start + 1 within the tile (0:
  // no head yet), two fields in the compact form
  u64 loc[kItems];
  u64 run = 0;
  unsigned left = 0;  // the unresolved rows
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const i64 r = base + first + q;
    const u64 pos1 = (u64)r + 1;
    if (r >= m) {
      // past the last row: no head, nothing written
    } else if (kCompact) {
      const u64 v = ((h1 >> q & 1) ? pos1 << 31 : 0) |
                    ((hall >> q & 1) ? pos1 : 0);
      run = MaxFields()(run, v);
    } else if (hall >> q & 1) {
      run = pos1;
    }
    loc[q] = run;
    if (r < m && !((hall >> q & 1) && (hall >> (q + 1) & 1)))
      left |= 1u << q;
  }
  u64 tile_max, tile_left;
  const u64 ex = kCompact
                     ? block_exclusive(run, MaxFields(), s_warp, &tile_max)
                     : block_exclusive(run, MaxOne(), s_warp, &tile_max);
  const u64 ex_left =
      block_exclusive((u64)__popc(left), Add(), s_warp, &tile_left);

  // publish, then look back where the tile needs its predecessors
  if (threadIdx.x < 32) {
    // the tile's first row starts a group of both kinds: no row here
    // needs a head from before the tile
    const bool own = kCompact ? (tile_max >> 31) != 0 : tile_max != 0;
    const bool starts = base == 0 ||
                        (kCompact ? (s_hi[1] >> 32) != (s_hi[0] >> 32)
                                  : s_hi[1] != s_hi[0] || s_g[1] != s_g[0]);
    if (threadIdx.x == 0) {
      store_status(status + tile, (own || tile == 0 ? kIncl : kAgg) |
                                      tile_max);
      store_status(status_sum + tile,
                   (tile == 0 ? kIncl : kAgg) | tile_left);
    }
    u64 pre = 0;
    if (tile > 0 && !starts)
      pre = kCompact ? look_back(status, tile, MaxFields())
                     : look_back(status, tile, MaxOne());
    const u64 pre_left = tile > 0 ? look_back(status_sum, tile, Add()) : 0;
    if (threadIdx.x == 0) {
      if (!own && tile > 0)
        store_status(status + tile,
                     kIncl | (kCompact ? MaxFields()(pre, tile_max)
                                       : MaxOne()(pre, tile_max)));
      if (tile > 0)
        store_status(status_sum + tile, kIncl | (pre_left + tile_left));
      s_pre[0] = pre;
      s_pre[1] = pre_left;
    }
  }
  __syncthreads();
  const u64 pre = kCompact ? MaxFields()(s_pre[0], ex) : MaxOne()(s_pre[0], ex);

  u64 slot = s_pre[1] + ex_left;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const i64 r = base + first + q;
    if (r >= m) break;
    const i64 pos = s_pos[first + q];
    if (kCompact) {
      const u64 g = MaxFields()(pre, loc[q]);
      const i64 s1 = (i64)(g >> 31) - 1, sall = (i64)(g & kHalf) - 1;
      rank[pos] = (s_hi[first + q + 1] >> 32) + (sall - s1);
    } else {
      rank[pos] = (i64)MaxOne()(pre, loc[q]) - 1;
    }
    if (left >> q & 1) still[slot++] = pos;
  }
  if (threadIdx.x == 0 && tile_left) atomicAdd(count, tile_left);
}

// ---------------------------------------------------------------- K14

constexpr int kBucketBits = 16;  // U's slots a bucket
constexpr int kBucket = 1 << kBucketBits;
constexpr int kBinThreads = 512;
constexpr int kBinItems = 16;
constexpr int kBinRows = kBinThreads * kBinItems;  // 8,192 rows a block
constexpr int kPlaceThreads = 1024;
// a bucket's word in pass 1: its base among the bucket's slots above
// kStartBits, its start among the block's rows below
constexpr int kStartBits = 14;
static_assert(kBinRows < (1 << kStartBits), "a block's rows in 14 bits");

__device__ __forceinline__ i64 i64_min(i64 a, i64 b) { return a < b ? a : b; }

// Pass 1, a block of 8,192 suffixes: each suffix's slot d and byte (suffix
// i != 0 of rank j: d = j + (j < r0), T[i - 1]; suffix 0: d = 0, T[n -
// 1]) as the entry (d & 0xFFFF) << 8 | byte, binned by its bucket d >> 16
// in shared memory, then written in runs, one a bucket, at the bucket's
// cursor (one atomicAdd a bucket a block).  Every bucket receives exactly
// its min(2^16, n - b 2^16) slots, so its place in stage is b 2^16 with
// no count pass.  Shared memory: the buckets' words, then the entries in
// bucket order and their buckets.
__global__ void __launch_bounds__(kBinThreads, 2)
bwt_extract_bin_kernel(const uint8_t* __restrict__ data,
                       const i64* __restrict__ rank, i64 n, i64 r,
                       i64 n_aux, int buckets, unsigned* __restrict__ cursor,
                       unsigned* __restrict__ stage, i64* __restrict__ primary,
                       int* __restrict__ aux) {
  extern __shared__ unsigned smem[];
  unsigned* s_word = smem;
  unsigned* s_ent = smem + buckets;
  unsigned short* s_bid = (unsigned short*)(s_ent + kBinRows);
  __shared__ u64 s_warp[kBinThreads / 32];
  const i64 base = (i64)blockIdx.x * kBinRows;
  for (int b = threadIdx.x; b < buckets; b += kBinThreads) s_word[b] = 0;
  const i64 r0 = __ldg(rank);
  if (blockIdx.x == 0 && threadIdx.x == 0) *primary = r0 + 1;
  i64 jv[kBinItems];
  uint8_t cv[kBinItems];
#pragma unroll
  for (int k = 0; k < kBinItems; ++k) {
    const i64 i = base + threadIdx.x + k * kBinThreads;
    jv[k] = i < n ? __ldg(rank + i) : -1;
    cv[k] = i < n ? __ldg(data + (i == 0 ? n - 1 : i - 1)) : 0;
    if (i < n_aux) aux[i] = (int)__ldg(rank + (i + 1) * r);
  }
  __syncthreads();
  unsigned ent[kBinItems], loc[kBinItems];
#pragma unroll
  for (int k = 0; k < kBinItems; ++k) {
    const i64 i = base + threadIdx.x + k * kBinThreads;
    const i64 j = jv[k];
    const i64 d = i == 0 ? 0 : j + (j < r0);
    loc[k] = ~0u;
    if (i < n && j >= 0 && d < n) {  // a rank outside [0, n): no slot
      const unsigned b = (unsigned)(d >> kBucketBits);
      ent[k] = (unsigned)(d & (kBucket - 1)) << 8 | cv[k];
      loc[k] = b << kStartBits | atomicAdd(s_word + b, 1u);
    }
  }
  __syncthreads();

  // each thread a run of buckets: the block's start of each (exclusive
  // sums of the counts) and its base in the bucket (its cursor)
  const int per = (buckets + kBinThreads - 1) / kBinThreads;
  const int b0 = threadIdx.x * per, b1 = min(b0 + per, buckets);
  unsigned sum = 0;
  for (int b = b0; b < b1; ++b) {
    const unsigned c = s_word[b];
    const unsigned g = c ? min(atomicAdd(cursor + b, c), (unsigned)kBucket)
                         : 0;
    s_word[b] = g << kStartBits | sum;
    sum += c;
  }
  u64 total;
  const unsigned ex = (unsigned)block_exclusive<kBinThreads>(
      (u64)sum, Add(), s_warp, &total);
  for (int b = b0; b < b1; ++b) s_word[b] += ex;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kBinItems; ++k) {
    if (loc[k] == ~0u) continue;
    const unsigned b = loc[k] >> kStartBits;
    const unsigned at = (s_word[b] & ((1u << kStartBits) - 1)) +
                        (loc[k] & ((1u << kStartBits) - 1));
    s_ent[at] = ent[k];
    s_bid[at] = (unsigned short)b;
  }
  __syncthreads();
  // the runs, each thread the next entry: a bucket's run is contiguous
  for (int t = threadIdx.x; t < (int)total; t += kBinThreads) {
    const unsigned b = s_bid[t];
    const unsigned w = s_word[b];
    const i64 at = (i64)(w >> kStartBits) + t -
                   (w & ((1u << kStartBits) - 1));
    const i64 lo = (i64)b << kBucketBits;
    if (at < i64_min(kBucket, n - lo)) stage[lo + at] = s_ent[t];
  }
}

// Pass 2, a block a bucket: its entries read coalesced, each byte placed
// in a 64 KiB slice of U in shared memory, the slice written coalesced.
__global__ void __launch_bounds__(kPlaceThreads)
bwt_extract_place_kernel(const unsigned* __restrict__ stage, i64 n,
                         uint8_t* __restrict__ U) {
  extern __shared__ unsigned smem[];
  uint8_t* s = (uint8_t*)smem;
  const i64 lo = (i64)blockIdx.x << kBucketBits;
  const int size = (int)i64_min(kBucket, n - lo);
  const int quads = size >> 2;
  const uint4* st4 = reinterpret_cast<const uint4*>(stage + lo);
  for (int k = threadIdx.x; k < quads; k += kPlaceThreads) {
    const uint4 e = __ldg(st4 + k);
    s[(e.x >> 8) & (kBucket - 1)] = (uint8_t)e.x;
    s[(e.y >> 8) & (kBucket - 1)] = (uint8_t)e.y;
    s[(e.z >> 8) & (kBucket - 1)] = (uint8_t)e.z;
    s[(e.w >> 8) & (kBucket - 1)] = (uint8_t)e.w;
  }
  for (int k = 4 * quads + threadIdx.x; k < size; k += kPlaceThreads) {
    const unsigned e = __ldg(stage + lo + k);
    s[(e >> 8) & (kBucket - 1)] = (uint8_t)e;
  }
  __syncthreads();
  const int whole = size & ~15;
  for (int k = 16 * threadIdx.x; k < whole; k += 16 * kPlaceThreads)
    *reinterpret_cast<uint4*>(U + lo + k) =
        *reinterpret_cast<const uint4*>(s + k);
  for (int k = whole + threadIdx.x; k < size; k += kPlaceThreads)
    U[lo + k] = s[k];
}

unsigned blocks_of(i64 rows, i64 per_block) {
  return (unsigned)((rows + per_block - 1) / per_block);
}

}  // namespace

// data: u8 [n]; key_hi, key_lo: i64 [rows] (rows = n, or the sample's
// n - (n + 2) / 3 when sample != 0).
extern "C" int bwt_boot_keys_launch(const uint8_t* data, i64 n, i64 rows,
                                    int sample, i64* key_hi, i64* key_lo,
                                    void* stream) {
  if (rows <= 0) return 0;
  bwt_boot_keys_kernel<<<blocks_of(rows, kBootRows), kThreads, 0,
                         (cudaStream_t)stream>>>(data, n, rows, sample,
                                                 key_hi, key_lo);
  return (int)cudaGetLastError();
}

// rank: i64 [n]; uidx: i64 [rows] or null (rows = n); key_a, key_b: i64
// [rows].
extern "C" int bwt_round_keys_launch(const i64* rank, i64 n, i64 k,
                                     const i64* uidx, i64 rows, i64* key_a,
                                     i64* key_b, void* stream) {
  if (rows <= 0) return 0;
  bwt_round_keys_kernel<<<blocks_of(rows, kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(rank, n, k, uidx, rows,
                                                  key_a, key_b);
  return (int)cudaGetLastError();
}

// lo_s, o1, key_hi: i64 [m] (the first sort's values and indices, the
// high keys in input order); uidx: i64 [m] or null; hi1, pay: i64 [m]
// written.  scratch: u64 [tiles + 1] of zeros (the status words, the tile
// counter); tiles = ceil(m / 1024).
extern "C" int bwt_heads_pay_launch(const i64* lo_s, const i64* o1,
                                    const i64* key_hi, const i64* uidx, i64 m,
                                    i64* hi1, i64* pay, u64* scratch,
                                    void* stream) {
  if (m <= 0) return 0;
  const unsigned tiles = blocks_of(m, kTile);
  bwt_heads_pay_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(
      lo_s, o1, key_hi, uidx, m, hi1, pay, scratch,
      (unsigned*)(scratch + tiles));
  return (int)cudaGetLastError();
}

// hi_s, o2: i64 [m] (the second sort's values and indices), pay: i64 [m]
// from bwt_heads_pay_launch; rank: i64 [m] written (full), or i64 [n]
// updated in place (compact); still: i64 [m], its first count elements
// written.  scratch: u64 [2 tiles + 2] of zeros (the two status arrays,
// the tile counter, the count at scratch[2 tiles + 1]).
extern "C" int bwt_heads_launch(int compact, const i64* hi_s, const i64* o2,
                                const i64* pay, i64 m, i64* rank, i64* still,
                                u64* scratch, void* stream) {
  if (m <= 0) return 0;
  const unsigned tiles = blocks_of(m, kTile);
  u64* status = scratch;
  u64* status_sum = scratch + tiles;
  unsigned* counter = (unsigned*)(scratch + 2 * (i64)tiles);
  u64* count = scratch + 2 * (i64)tiles + 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (compact)
    bwt_heads_kernel<true><<<tiles, kThreads, 0, s>>>(
        hi_s, o2, pay, m, rank, still, status, status_sum, counter, count);
  else
    bwt_heads_kernel<false><<<tiles, kThreads, 0, s>>>(
        hi_s, o2, pay, m, rank, still, status, status_sum, counter, count);
  return (int)cudaGetLastError();
}

// K14's pass 1.  data: u8 [n]; rank: i64 [n], all distinct; cursor: u32
// [buckets] of zeros, buckets = ceil(n / 2^16); stage: u32 [n] written;
// primary: i64 [1]; aux: i32 [n_aux], n_aux = (n - 1) / r.
extern "C" int bwt_extract_bins_launch(const uint8_t* data, const i64* rank,
                                       i64 n, i64 r, i64 n_aux,
                                       unsigned* cursor, unsigned* stage,
                                       i64* primary, int* aux, void* stream) {
  if (n <= 0) return 0;
  const int buckets = (int)blocks_of(n, kBucket);
  const size_t smem = (size_t)buckets * 4 + (size_t)kBinRows * 6;
  cudaError_t e = cudaFuncSetAttribute(
      bwt_extract_bin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  bwt_extract_bin_kernel<<<blocks_of(n, kBinRows), kBinThreads, smem,
                           (cudaStream_t)stream>>>(
      data, rank, n, r, n_aux, buckets, cursor, stage, primary, aux);
  return (int)cudaGetLastError();
}

// K14's pass 2.  stage: u32 [n] from pass 1; U: u8 [n] written.
extern "C" int bwt_extract_place_launch(const unsigned* stage, i64 n,
                                        uint8_t* U, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      bwt_extract_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBucket);
  if (e != cudaSuccess) return (int)e;
  bwt_extract_place_kernel<<<blocks_of(n, kBucket), kPlaceThreads, kBucket,
                             (cudaStream_t)stream>>>(stage, n, U);
  return (int)cudaGetLastError();
}
