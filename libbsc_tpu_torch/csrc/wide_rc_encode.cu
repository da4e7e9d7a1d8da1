// K5, the wide coder's v2 encode (carry-less range coder, one pass).
//
// Replaces the Pallas kernel _build_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py.  For every lane and iteration it runs the
// lane's state machine over the scheduled bits, looks up and adapts the
// context's 12-bit probability, and takes one forward range-coder step:
// r = (rng >> 12) * p; a one bit keeps [low + r, rng - r), a zero [low, r).
// When rng falls under 2^16 the lane renormalises: an interval that
// straddles a 2^16 boundary is clamped to its larger side (the upper one
// only when strictly larger), the lane emits low >> 16, and low and rng
// shift up 16.  After the last bit every live lane flushes low's two
// halves.
//
// The v2 format delays each lane's units by two (ops/wide.py of the JAX
// package; the JAX kernel tags units with their lane and a host pass,
// _assemble, reorders them).  A group's stream is: two warm-up units per
// live lane, in lane order; then, for each renormalisation event e in
// (iteration, lane) order, unit r_e + 2 of that lane, where r_e counts the
// lane's earlier events and a lane's units are its emissions followed by
// its two flush units.  The decoder renormalises exactly where the encoder
// did, so a lane's r-th emission belongs in the slot of its event r - 2
// (or warm-up slot r when r < 2).  This kernel writes it there directly:
// each lane keeps the slots of its last two events in registers, and the
// group's buffer head is the finished stream, so the payload is a plain
// concatenation.
//
// What bounds it on the H100: the serial chain of iters dependent steps
// per lane (the next bit's context and coder state depend on this step),
// plus one block-wide barrier per iteration for the event prefix.  The
// bytes (planes in, units out) would take about 0.007 ms at 3.35 TB/s for
// a 25 MiB block, whose longest lane needs some 62,000 dependent steps.
//
// Design: one block of 128 threads per group, one thread per lane.  The
// lane's model is a u16 column of [281][128] in dynamic shared memory
// (71,936 B per block), read and updated in the same step.  An event's
// slot comes from __ballot_sync + __popc in the warp plus an exclusive
// prefix over the group's four warp counts (double-buffered by iteration
// parity: one barrier per iteration).  A live lane is one whose first
// field is active: the schedule packs each lane's bits from iteration 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"

using namespace wide;

namespace {

constexpr int kSmem = kNctx * kGroup * 2;

// exclusive prefix of the four warp counts in cnt, and their total
__device__ __forceinline__ void group_prefix(const int* cnt, int warp,
                                             int& before, int& total) {
  before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    before += w < warp ? cnt[w] : 0;
    total += cnt[w];
  }
}

__global__ void __launch_bounds__(kGroup)
wide_rc_encode_kernel(const uint8_t* __restrict__ planes, int iters, int cap,
                      const int* __restrict__ priors, int* __restrict__ units,
                      int* __restrict__ counts) {
  extern __shared__ uint16_t model[];  // [kNctx][kGroup]
  __shared__ int live_cnt[4];
  __shared__ int warp_cnt[2][4];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int lane = g * kGroup + tid;
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  for (int c = 0; c < kNctx; ++c) model[c * kGroup + tid] = priors[c];
  int* gu = units + (size_t)g * cap;

  const bool live = iters > 0 && (planes[lane] & 2) != 0;
  const unsigned lmask = __ballot_sync(0xFFFFFFFFu, live);
  if ((tid & 31) == 0) live_cnt[warp] = __popc(lmask);
  __syncthreads();
  int live_before, n_live;
  group_prefix(live_cnt, warp, live_before, n_live);
  const int warm = 2 * (live_before + __popc(lmask & below));
  int cursor = 2 * n_live;  // next event slot, same in every thread

  LaneState s = fresh_state(kRFlag);
  uint32_t low = 0, rng = 0xFFFFFFFFu;
  int emitted = 0;            // units this lane has written
  int slot_a = 0, slot_b = 0;  // slots of its events emitted - 2, - 1
  int packed = 0;
  for (int i = 0; i < iters; ++i) {
    if ((i & 3) == 0) packed = planes[(size_t)(i >> 2) * kLanes + lane];
    const int fld = (packed >> ((i & 3) * 2)) & 3;
    bool ren = false;
    uint32_t unit = 0;
    if (fld & 2) {
      const int bit = fld & 1;
      uint16_t* mp = &model[sm_ctx(s) * kGroup + tid];
      const uint32_t p = *mp;
      *mp = (uint16_t)adapt(p, bit);
      sm_next(s, bit);
      const uint32_t r = (rng >> 12) * p;
      if (bit) {
        low += r;
        rng -= r;
      } else {
        rng = r;
      }
      if (rng < (1u << 16)) {
        if (((low ^ (low + rng - 1u)) >> 16) != 0) {
          const uint32_t lo_part = 0x10000u - (low & 0xFFFFu);
          const uint32_t hi_part = rng - lo_part;
          if (hi_part > lo_part) {
            low += lo_part;
            rng = hi_part;
          } else {
            rng = lo_part;
          }
        }
        ren = true;
        unit = low >> 16;
        low <<= 16;
        rng <<= 16;
      }
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);
    int* wc = warp_cnt[i & 1];
    if ((tid & 31) == 0) wc[warp] = __popc(mask);
    __syncthreads();
    int before, m;
    group_prefix(wc, warp, before, m);
    if (ren) {
      const int slot = cursor + before + __popc(mask & below);
      gu[emitted < 2 ? warm + emitted : slot_a] = (int)unit;
      slot_a = slot_b;
      slot_b = slot;
      ++emitted;
    }
    cursor += m;
  }
  if (live) {  // the two flush units: low's high half, then its low half
    for (int f = 0; f < 2; ++f) {
      gu[emitted < 2 ? warm + emitted : slot_a] = (int)(low >> 16);
      low <<= 16;
      slot_a = slot_b;
      ++emitted;
    }
  }
  if (tid == 0) counts[g] = cursor;
}

}  // namespace

// planes: u8 [ceil(iters/4), 1024] packed 2-bit (bit | active) fields;
// units: i32 [8, cap] with cap >= 128 * (iters + 2); counts: i32 [8].
// Group g's stream, in the decoder's consumption order, is
// units[g, 0:counts[g]] (u16 values).
extern "C" int wide_rc_encode_launch(const uint8_t* planes, int iters,
                                     int cap, const int* priors, int* units,
                                     int* counts, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_rc_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  wide_rc_encode_kernel<<<kGroups, kGroup, kSmem, (cudaStream_t)stream>>>(
      planes, iters, cap, priors, units, counts);
  return (int)cudaGetLastError();
}
