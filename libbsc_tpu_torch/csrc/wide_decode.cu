// K3 and K4, the wide decoder: v3 (binary rANS lanes, K3) and v2
// (carry-less range coder, K4), one template.
//
// Replaces the Pallas kernel _build_decode_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py: rans=True (K3) and rans=False (K4).  Per
// lane and iteration the lane decodes one bit with its context's
// probability p and adapts the context:
//   v3: slot = x & 0xFFF picks the bit (slot >= p) and x contracts by the
//       bit's frequency; the lane renormalises when x falls under 2^16.
//   v2: r = (rng >> 12) * p, bit = (code - low) >= r, and the bit's side
//       of [low, low + rng) is kept; when rng falls under 2^16 the lane
//       clamps an interval that straddles a 2^16 boundary to its larger
//       side (the upper one only when strictly larger), and low and rng
//       shift up 16.
// A renormalising lane takes the group's next stream unit into x (v3) or
// code (v2): renormalising lanes consume units in lane order, so a lane's
// unit is stream[cursor + (renormalising lanes before it)].  The state
// machine (wide_sm.cuh) turns bits into (rank, run) pairs; a completed run
// moves its symbol to the front of the lane's MTF table and is written
// straight into the lane's span of the output block.
//
// What bounds it on the H100: the serial chain of IT dependent steps per
// lane (the next bit's context depends on this one), plus one block-wide
// barrier per iteration for the unit prefix.  The bytes (the payload in,
// the block out) would take about 0.01 ms at 3.35 TB/s for a 25 MiB block,
// whose longest lane needs some 62,000 dependent steps.
//
// Design: one block of 128 threads per group, one thread per lane.  The
// lane's model is a u16 column of [281][128] and its MTF table a u8 column
// of [256][128] in dynamic shared memory (104,704 B per block); a run's
// symbol is one indexed load and its move-to-front a loop over the rank's
// entries.  Writing runs in place removes the JAX route's record staging,
// scatter and cumsum.  The group stops as soon as all its lanes are done.
// The two coders differ only in the bit step; the template keeps the rest
// one code path, and all u32 wrap-around is native.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"

using namespace wide;

namespace {

constexpr int kModelBytes = kNctx * kGroup * 2;
constexpr int kSmem = kModelBytes + 256 * kGroup;

template <bool kRans>
__global__ void __launch_bounds__(kGroup)
wide_decode_kernel(const uint32_t* __restrict__ warm,
                   const int* __restrict__ goff,
                   const int* __restrict__ lane_sz,
                   const int* __restrict__ lstart,
                   const int* __restrict__ stream, int srow, int iters,
                   const int* __restrict__ priors, uint8_t* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  uint16_t* model = reinterpret_cast<uint16_t*>(smem);  // [kNctx][kGroup]
  uint8_t* mtf = smem + kModelBytes;                    // [256][kGroup]
  __shared__ int warp_cnt[4];

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int lane = g * kGroup + tid;
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  for (int c = 0; c < kNctx; ++c) model[c * kGroup + tid] = priors[c];
  for (int r = 0; r < 256; ++r) mtf[r * kGroup + tid] = (uint8_t)r;

  const int* gs = stream + (size_t)g * srow;
  int left = lane_sz[lane];
  LaneState s = fresh_state(left > 0 ? kRFlag : kDone);
  uint32_t x = warm[lane];  // v3: the rANS state; v2: the code word
  uint32_t low = 0, rng = 0xFFFFFFFFu;  // v2 only
  int cursor = goff[lane];  // same value in every thread of the group
  uint8_t* dst = out + lstart[lane];

  for (int i = 0; i < iters; ++i) {
    const bool active = s.phase != kDone;
    if (!__syncthreads_or(active)) break;
    bool ren = false;
    int bit = 0;
    if (active) {
      uint16_t* m = &model[sm_ctx(s) * kGroup + tid];
      const uint32_t p = *m;
      if (kRans) {
        const uint32_t slot = x & 0xFFFu;
        const uint32_t hi = x >> 12;
        bit = slot >= p;
        x = bit ? (4096u - p) * hi + slot - p : p * hi + slot;
        ren = x < (1u << 16);
      } else {
        const uint32_t r = (rng >> 12) * p;
        bit = x - low >= r;
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
          low <<= 16;
          rng <<= 16;
          ren = true;
        }
      }
      *m = (uint16_t)adapt(p, bit);
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);
    if ((tid & 31) == 0) warp_cnt[warp] = __popc(mask);
    __syncthreads();
    int before = 0, n_ren = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      n_ren += warp_cnt[w];
    }
    if (ren) {
      const int at = cursor + before + __popc(mask & below);
      x = (x << 16) | (at < srow ? (uint32_t)gs[at] & 0xFFFFu : 0u);
    }
    cursor += n_ren;
    if (active) {
      int run = sm_next(s, bit);
      if (run) {
        const int r = s.rank;
        const uint8_t sym = mtf[r * kGroup + tid];
        for (int j = r; j > 0; --j)
          mtf[j * kGroup + tid] = mtf[(j - 1) * kGroup + tid];
        mtf[tid] = sym;
        run = min(run, left);
        for (int j = 0; j < run; ++j) dst[j] = sym;
        dst += run;
        left -= run;
        if (left <= 0) s.phase = kDone;
      }
    }
  }
}

template <bool kRans>
int launch(const uint32_t* warm, const int* goff, const int* lane_sz,
           const int* lstart, const int* stream, int srow, int iters,
           const int* priors, uint8_t* out, void* stream_handle) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_decode_kernel<kRans>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  wide_decode_kernel<kRans>
      <<<kGroups, kGroup, kSmem, (cudaStream_t)stream_handle>>>(
          warm, goff, lane_sz, lstart, stream, srow, iters, priors, out);
  return (int)cudaGetLastError();
}

}  // namespace

// warm: u32 [1024] initial states (v3) or code words (v2); goff: i32
// [1024] first unit after the warm-up pairs (per group); lane_sz, lstart:
// i32 [1024] lane sizes and absolute byte starts; stream: i32 [8, srow]
// unit segments (u16 values); out: u8 [sum(lane_sz)].
extern "C" int wide_decode_launch(const uint32_t* warm, const int* goff,
                                  const int* lane_sz, const int* lstart,
                                  const int* stream, int srow, int iters,
                                  const int* priors, uint8_t* out,
                                  void* stream_handle) {
  return launch<true>(warm, goff, lane_sz, lstart, stream, srow, iters,
                      priors, out, stream_handle);
}

extern "C" int wide_decode_v2_launch(const uint32_t* warm, const int* goff,
                                     const int* lane_sz, const int* lstart,
                                     const int* stream, int srow, int iters,
                                     const int* priors, uint8_t* out,
                                     void* stream_handle) {
  return launch<false>(warm, goff, lane_sz, lstart, stream, srow, iters,
                       priors, out, stream_handle);
}
