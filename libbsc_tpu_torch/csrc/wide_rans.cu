// K2, the wide coder's binary rANS pass (v3 encode pass B).
//
// Replaces the Pallas kernel _build_rans_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py.  Each lane walks its bits BACKWARD with
// the probabilities K1 wrote: f = p for a zero bit, 4096 - p for a one;
// when x >= f << 20 the lane emits x & 0xFFFF and shifts x down 16; then
// x = (x / f) << 12 + x % f + (bit ? p : 0).  The final states are the
// decoder's warm-up words.  Within a group the decoder consumes units in
// (iteration asc, lane asc) order; group g's units end up, in that order,
// at the tail of its buffer: units[g, cap - counts[g]:].
//
// What bounds it on the H100: each lane's chain of iters dependent steps
// (some 62,000 for a 25 MiB block).  The bytes (planes and probabilities
// in, units out) would take about 0.08 ms at 3.35 TB/s.  The design up to
// commit fcee879 took about 1,350 cycles a step: two dependent
// device-memory loads, a native u32 divide and a __syncthreads a step for
// the group's unit prefix (tools/encode_step_split.py).  This design
// leaves each step only its chain: a compare and select for the
// renormalisation, a multiply-high, and two multiply-adds and a select
// for the quotient's correction.
//
// Two kernels:
//
//  - The chain kernel: one warp a block, one thread a lane, 32 blocks, so
//    the 32 warps spread over 32 SMs and no warp waits on another.  The
//    probability rows (128 B a warp and step) and plane rows (32 B a warp
//    and four steps) of the coming steps stream backward into a ring
//    private to the warp by cp.async, kRing chunks of kSteps steps deep,
//    kAhead chunks ahead of the walk; a __syncwarp, not a block barrier,
//    hands a chunk over.  A chunk's loads come first: every step's p and
//    field (p is loaded unconditionally, K1 writes 0 where a lane is
//    inactive; an inactive step takes f = 4096 and base 0, which leaves x
//    as it is), f, and the quotient multiplier of f from a table in
//    shared memory, into registers.  Then the 32 steps run with no load
//    on the chain.  Each step stores x's low half to the step's row of a
//    dense unit plane (u16 [iters, 1024], whether or not the lane emits)
//    and ballots its emission; lane j keeps step j's ballot word, stored
//    once a chunk with the warp's emission count.
//  - The placement kernel: one block of 128 threads per group and tile of
//    kTile iterations.  The warp counts of the chunks before the tile give
//    its first slot; per iteration the group's four ballot words give
//    every emitting lane its slot (the emissions of earlier iterations,
//    of the lower warps and of the lower lanes), and it copies its unit
//    from the dense plane.
//
// The quotient (ops/wide_kernels.py rans_table, proved on the CPU by
// tests/test_torch_wide_rans_design.py).  For f in [1, 4096] the table
// holds m_f = floor((2^32 - 1) / f), and q' = umulhi(x, m_f) for any u32
// x.  Then q - 1 <= q' <= q for q = floor(x / f): m_f <= 2^32 / f gives
// x m_f / 2^32 <= x / f, and m_f >= (2^32 - f) / f gives x m_f / 2^32 >=
// x / f - x / 2^32 > x / f - 1.  So r' = x - q' f lies in [0, 2 f), and
// q = q' + (r' >= f).  The new state q 4096 + r + base equals
// x + (q' + (r' >= f)) (4096 - f) + base, computed mod 2^32 and exact
// because it is below 2^32: after the renormalisation x < f 2^20, so
// q < 2^20, and r + base < 4096 (base is p, and f = 4096 - p, when the
// bit is one).  f = 4096 gives q 4096 + r = x: an inactive step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"

using namespace wide;

namespace {

constexpr int kSteps = 32;           // steps of a chunk: one ballot a lane
constexpr int kRing = 8;             // chunks the ring holds
constexpr int kAhead = kRing - 1;    // chunks in flight ahead of the walk
constexpr int kChains = kLanes / 32; // chain warps (and blocks)
constexpr int kTableSize = 4097;     // multipliers for f in [0, 4096]
constexpr int kTile = 256;           // iterations a placement block places
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kProbBytes = kRing * kSteps * 32 * 4;
constexpr int kPlaneBytes = kRing * (kSteps / 4) * 32;
constexpr int kChainSmem = kProbBytes + kPlaneBytes + kTableSize * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Walk index s (chunk nchunks - 1 - s) into ring slot s % kRing: thread t
// copies 16 bytes of 8 probability rows (row q >> 3, part q & 7 for
// q = 32 j + t) and threads 0-15 16 bytes of the 8 plane rows.  Rows at or
// past the last step are not copied; the walk masks their steps.  One
// commit group a call, empty past chunk 0.
__device__ __forceinline__ void stage(uint32_t* ring_p, uint8_t* ring_b,
                                      const int* probs,
                                      const uint8_t* planes, int s,
                                      int nchunks, int iters, int w, int t) {
  const int c = nchunks - 1 - s;
  if (c >= 0) {
    const int slot = s & (kRing - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j * 32 + t;
      const int row = c * kSteps + (q >> 3);
      if (row < iters)
        cp_async16(ring_p + (slot * kSteps + (q >> 3)) * 32 + (q & 7) * 4,
                   probs + (size_t)row * kLanes + w * 32 + (q & 7) * 4);
    }
    const int prow = c * (kSteps / 4) + (t >> 1);
    if (t < 16 && 4 * prow < iters)
      cp_async16(ring_b + (slot * (kSteps / 4) + (t >> 1)) * 32 + (t & 1) * 16,
                 planes + (size_t)prow * kLanes + w * 32 + (t & 1) * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
wide_rans_chain_kernel(const uint8_t* __restrict__ planes,
                       const int* __restrict__ probs, int iters,
                       const uint32_t* __restrict__ table,
                       uint16_t* __restrict__ dense,
                       uint32_t* __restrict__ ballots,
                       int* __restrict__ chunk_cnt,
                       uint32_t* __restrict__ fx) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ring_p = reinterpret_cast<uint32_t*>(smem);
  uint8_t* ring_b = smem + kProbBytes;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + kProbBytes + kPlaneBytes);
  const int t = threadIdx.x;
  const int w = blockIdx.x;
  const int lane = w * 32 + t;
  const int nchunks = (iters + kSteps - 1) / kSteps;

  for (int s = 0; s < kAhead; ++s)
    stage(ring_p, ring_b, probs, planes, s, nchunks, iters, w, t);
  for (int k = t; k < kTableSize; k += 32) tab[k] = table[k];

  uint32_t x = 1u << 16;
  for (int s = 0; s < nchunks; ++s) {
    const int c = nchunks - 1 - s;
    const int slot = s & (kRing - 1);
    // chunk s has landed; every lane is past chunk s - 1, whose slot the
    // copy of chunk s + kAhead takes
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncwarp();
    stage(ring_p, ring_b, probs, planes, s + kAhead, nchunks, iters, w, t);

    const uint32_t* pr = ring_p + slot * kSteps * 32 + t;
    const uint8_t* br = ring_b + slot * (kSteps / 4) * 32 + t;
    const int lim = iters - c * kSteps;  // the chunk's steps below iters
    uint32_t m[kSteps], fb[kSteps];      // multiplier; f | base << 13
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const uint32_t fld = (uint32_t)br[(j >> 2) * 32] >> (2 * (j & 3));
      const uint32_t p = pr[j * 32];
      const bool active = (fld & 2) != 0 && j < lim;
      const bool one = (fld & 1) != 0;
      const uint32_t f = active ? (one ? 4096u - p : p) : 4096u;
      m[j] = tab[f];
      fb[j] = f | (active && one ? p << 13 : 0u);
    }

    uint16_t* dst = dense + (size_t)c * kSteps * kLanes + lane;
    uint32_t mine = 0;  // lane j: the ballot of step j
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      const uint32_t f = fb[j] & 8191u;
      const uint32_t c4 = 4096u - f;
      const bool ren = x > (f << 20) - 1u;  // f = 4096: never
      dst[j * kLanes] = (uint16_t)x;        // the unit, when ren
      const uint32_t xr = ren ? x >> 16 : x;
      const uint32_t q = __umulhi(xr, m[j]);
      const uint32_t r = xr - q * f;
      x = xr + q * c4 + (fb[j] >> 13) + (r >= f ? c4 : 0u);
      const unsigned b = __ballot_sync(kFull, ren);
      mine = t == j ? b : mine;
    }
    const size_t npad = (size_t)nchunks * kSteps;
    ballots[w * npad + (size_t)c * kSteps + t] = mine;
    const unsigned cnt = __reduce_add_sync(kFull, (unsigned)__popc(mine));
    if (t == 0) chunk_cnt[w * nchunks + c] = (int)cnt;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fx[lane] = x;
}

__global__ void __launch_bounds__(kGroup)
wide_rans_place_kernel(const uint16_t* __restrict__ dense,
                       const uint32_t* __restrict__ ballots,
                       const int* __restrict__ chunk_cnt, int iters, int cap,
                       int* __restrict__ units, int* __restrict__ counts) {
  __shared__ uint4 words[kTile];  // per iteration, the group's 4 ballots
  __shared__ int red[2][4];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int l = t & 31;
  const int g = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int nchunks = (iters + kSteps - 1) / kSteps;
  const size_t npad = (size_t)nchunks * kSteps;

  // the group's emissions in all chunks, and in the chunks before the tile
  int before = 0, total = 0;
  for (int k = t; k < 4 * nchunks; k += kGroup) {
    const int v = chunk_cnt[(4 * g + (k & 3)) * nchunks + (k >> 2)];
    total += v;
    before += (k >> 2) * kSteps < i0 ? v : 0;
  }
  before = __reduce_add_sync(kFull, before);
  total = __reduce_add_sync(kFull, total);
  if (l == 0) {
    red[0][warp] = before;
    red[1][warp] = total;
  }
  uint32_t* wd = reinterpret_cast<uint32_t*>(words);
  for (int k = t; k < 4 * kTile; k += kGroup) {
    const int i = i0 + (k % kTile);
    wd[(k % kTile) * 4 + k / kTile] =
        i < iters ? ballots[(4 * g + k / kTile) * npad + i] : 0u;
  }
  __syncthreads();
  before = red[0][0] + red[0][1] + red[0][2] + red[0][3];
  total = red[1][0] + red[1][1] + red[1][2] + red[1][3];

  int* gu = units + (size_t)g * cap + cap - total + before;
  const uint16_t* src = dense + (size_t)i0 * kLanes + g * kGroup + t;
  const unsigned below = (1u << l) - 1u;
  const int n_i = min(kTile, iters - i0);
  int run = 0;  // the group's emissions in the tile's earlier iterations
#pragma unroll 4
  for (int ii = 0; ii < n_i; ++ii) {
    const uint4 v = words[ii];
    const int px = __popc(v.x), py = __popc(v.y), pz = __popc(v.z);
    const uint32_t mw = warp == 0 ? v.x : warp == 1 ? v.y
                                     : warp == 2 ? v.z : v.w;
    const int lower = (warp > 0 ? px : 0) + (warp > 1 ? py : 0) +
                      (warp > 2 ? pz : 0);
    if ((mw >> l) & 1)
      gu[run + lower + __popc(mw & below)] = src[(size_t)ii * kLanes];
    run += px + py + pz + __popc(v.w);
  }
  if (blockIdx.x == gridDim.x - 1 && t == 0) counts[g] = total;
}

}  // namespace

// planes: u8 [rows, 1024] packed 2-bit (bit | active) fields with 4 rows
// >= iters; probs: i32 [>= iters, 1024], K1's plane, 0 where a lane is
// inactive; both 16-byte aligned.  table: u32 [4097], m_f =
// floor((2^32 - 1) / f) (ops/wide_kernels.py rans_table).  scratch: the
// dense units u16 [npad, 1024], the ballots u32 [32, npad] and the chunk
// counts i32 [32, npad / 32], npad = 32 ceil(iters / 32)
// (ops/wide_kernels.py rans_scratch_bytes).  units: i32 [8, cap] with cap
// >= 128 * iters; counts: i32 [8]; fx: u32 [1024].
extern "C" int wide_rans_launch(const uint8_t* planes, const int* probs,
                                int iters, int cap, const uint32_t* table,
                                void* scratch, int* units, int* counts,
                                uint32_t* fx, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nchunks = (iters + kSteps - 1) / kSteps;
  const size_t npad = (size_t)nchunks * kSteps;
  uint16_t* dense = static_cast<uint16_t*>(scratch);
  uint32_t* ballots = reinterpret_cast<uint32_t*>(dense + npad * kLanes);
  int* chunk_cnt = reinterpret_cast<int*>(ballots + kChains * npad);
  cudaError_t err = cudaFuncSetAttribute(
      wide_rans_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kChainSmem);
  if (err != cudaSuccess) return (int)err;
  wide_rans_chain_kernel<<<kChains, 32, kChainSmem, st>>>(
      planes, probs, iters, table, dense, ballots, chunk_cnt, fx);
  if (nchunks == 0) {
    err = cudaMemsetAsync(counts, 0, kGroups * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  } else {
    const dim3 grid((iters + kTile - 1) / kTile, kGroups);
    wide_rans_place_kernel<<<grid, kGroup, 0, st>>>(
        dense, ballots, chunk_cnt, iters, cap, units, counts);
  }
  return (int)cudaGetLastError();
}
