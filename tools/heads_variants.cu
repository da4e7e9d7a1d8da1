// Variants of K13's full form as it stood in 34e0e9c (bwt_heads_kernel
// <false> of libbsc_tpu_torch/csrc/bwt_sort.cu, copied here with its
// helpers so that this file builds beside any tree), for
// tools/heads_variants.py.  Each variant drops or replaces one class of
// K13's accesses, to measure what each costs; none is a route, and only
// kBase computes the function:
//   kBase        the kernel of 34e0e9c: o2[r] and hi_s[r] coalesced, the
//                gathers o1[o2[r]] and lo[o1[o2[r]]], the scatters
//                rank[pos] (8 B) and mask[pos] (1 B);
//   kNoMask      without the mask scatter;
//   kRankAtRow   the rank written coalesced at r instead of at pos;
//   kLoDirect    the low key read as the first sort's values lo_s at
//                o2[r], beside o1[o2[r]], instead of through o1;
//   kGathersOnly the gathers alone, no write (a checksum no row can hit
//                keeps them live).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr u64 kAgg = 1ull << 62;
constexpr u64 kIncl = 2ull << 62;
constexpr u64 kVal = kAgg - 1;

enum { kBase, kNoMask, kRankAtRow, kLoDirect, kGathersOnly };

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

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

template <typename Op>
__device__ u64 look_back(const u64* status, int tile, Op op) {
  const int lane = threadIdx.x & 31;
  u64 acc = 0;
  for (int p = tile - 1;; p -= 32) {
    const int q = p - lane;
    u64 s = kIncl;
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

template <typename Op>
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
  for (int i = 0; i < kWarps; ++i) {
    if (i < w) pre = op(pre, warp_tot[i]);
    tot = op(tot, warp_tot[i]);
  }
  *total = tot;
  __syncthreads();
  return op(pre, ex);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
heads_variant_kernel(const i64* __restrict__ hi_s, const i64* __restrict__ lo,
                     const i64* __restrict__ lo_s,
                     const i64* __restrict__ o1, const i64* __restrict__ o2,
                     i64 m, i64* __restrict__ rank,
                     uint8_t* __restrict__ mask, u64* status,
                     unsigned* tile_counter, u64* count) {
  __shared__ i64 s_hi[kTile + 2], s_lo[kTile + 2], s_pos[kTile];
  __shared__ u64 s_warp[kWarps];
  __shared__ u64 s_pre;
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(tile_counter, 1u);
  __syncthreads();
  const int tile = s_tile;
  const i64 base = (i64)tile * kTile;

  constexpr int kLoads = (kTile + 2 + kThreads - 1) / kThreads;
  i64 p[kLoads], lv[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int t = threadIdx.x + j * kThreads;
    const i64 r = base - 1 + t;
    p[j] = t < kTile + 2 && r >= 0 && r < m ? __ldg(o2 + r) : -1;
  }
  if (V == kLoDirect) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (p[j] >= 0) {
        lv[j] = __ldg(lo_s + p[j]);
        p[j] = __ldg(o1 + p[j]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (p[j] >= 0) p[j] = __ldg(o1 + p[j]);
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (p[j] >= 0) lv[j] = __ldg(lo + p[j]);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (p[j] < 0) continue;
    const int t = threadIdx.x + j * kThreads;
    s_hi[t] = __ldg(hi_s + base - 1 + t);
    s_lo[t] = lv[j];
    if (t >= 1 && t <= kTile) s_pos[t - 1] = p[j];
  }
  __syncthreads();

  const int first = threadIdx.x * kItems;
  unsigned hall = 0;
#pragma unroll
  for (int q = 0; q <= kItems; ++q) {
    const i64 r = base + first + q;
    const int t = first + q + 1;
    bool ha = true;
    if (r > 0 && r < m)
      ha = s_hi[t] != s_hi[t - 1] || s_lo[t] != s_lo[t - 1];
    hall |= (unsigned)ha << q;
  }
  u64 loc[kItems];
  u64 run = 0;
  unsigned left = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const i64 r = base + first + q;
    if (r < m && (hall >> q & 1)) run = (u64)r + 1;
    loc[q] = run;
    if (r < m && !((hall >> q & 1) && (hall >> (q + 1) & 1)))
      left |= 1u << q;
  }
  u64 tile_max;
  const u64 ex = block_exclusive(run, MaxOne(), s_warp, &tile_max);
  if (threadIdx.x < 32) {
    const bool own = tile_max != 0;
    const bool starts = base == 0 || s_hi[1] != s_hi[0] || s_lo[1] != s_lo[0];
    if (threadIdx.x == 0)
      store_status(status + tile, (own || tile == 0 ? kIncl : kAgg) |
                                      tile_max);
    u64 pre = 0;
    if (tile > 0 && !starts) pre = look_back(status, tile, MaxOne());
    if (threadIdx.x == 0) {
      if (!own && tile > 0)
        store_status(status + tile, kIncl | MaxOne()(pre, tile_max));
      s_pre = pre;
    }
  }
  __syncthreads();
  const u64 pre = MaxOne()(s_pre, ex);

  unsigned open = 0;
  u64 sum = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const i64 r = base + first + q;
    if (r >= m) break;
    const i64 pos = s_pos[first + q];
    const bool unresolved = left >> q & 1;
    const i64 g = (i64)MaxOne()(pre, loc[q]) - 1;
    if (V == kGathersOnly) {
      sum += (u64)g ^ (u64)pos ^ unresolved;
    } else {
      rank[V == kRankAtRow ? r : pos] = g;
      if (V != kNoMask) mask[pos] = unresolved;
    }
    open += unresolved;
  }
  if (V == kGathersOnly && sum == 0x5bd1e9955bd1e995ull) count[1] = sum;
  u64 tile_open;
  block_exclusive((u64)open, Add(), s_warp, &tile_open);
  if (threadIdx.x == 0 && tile_open) atomicAdd(count, tile_open);
}

template <int V>
void launch(const i64* hi_s, const i64* lo, const i64* lo_s, const i64* o1,
            const i64* o2, i64 m, i64* rank, uint8_t* mask, u64* scratch,
            cudaStream_t s) {
  const unsigned tiles = (unsigned)((m + kTile - 1) / kTile);
  heads_variant_kernel<V><<<tiles, kThreads, 0, s>>>(
      hi_s, lo, lo_s, o1, o2, m, rank, mask, scratch,
      (unsigned*)(scratch + tiles), scratch + tiles + 1);
}

}  // namespace

// variant: kBase .. kGathersOnly.  hi_s, lo, lo_s, o1, o2: i64 [m]; rank
// i64 [m], mask u8 [m]; scratch: u64 [tiles + 3], zeroed here (the status
// words, the tile counter, the count at scratch[tiles + 1]).
extern "C" int heads_variant_launch(int variant, const i64* hi_s,
                                    const i64* lo, const i64* lo_s,
                                    const i64* o1, const i64* o2, i64 m,
                                    i64* rank, uint8_t* mask, u64* scratch,
                                    void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const i64 tiles = (m + kTile - 1) / kTile;
  cudaMemsetAsync(scratch, 0, (tiles + 3) * sizeof(u64), s);
  switch (variant) {
#define VARIANT(V)                                                     \
  case V:                                                              \
    launch<V>(hi_s, lo, lo_s, o1, o2, m, rank, mask, scratch, s);      \
    break;
    VARIANT(kBase)
    VARIANT(kNoMask)
    VARIANT(kRankAtRow)
    VARIANT(kLoDirect)
    VARIANT(kGathersOnly)
#undef VARIANT
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
