// K2, the wide coder's binary rANS pass (v3 encode pass B).
//
// Replaces the Pallas kernel _build_rans_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py.  Each lane walks its bits BACKWARD with
// the probabilities K1 wrote: f = p for a zero bit, 4096 - p for a one;
// when x >= f << 20 the lane emits x & 0xFFFF and shifts x down 16; then
// x = (x / f) << 12 + x % f + (bit ? p : 0).  The final states are the
// decoder's warm-up words.
//
// Within a group the decoder consumes units in (iteration asc, lane asc)
// order.  The kernel walks iterations descending and writes each
// iteration's emissions, lane ascending, just below the previous ones,
// filling the group's buffer from its END: the buffer's tail is then the
// group's stream in consumption order, with no host reordering.
//
// What bounds it on the H100: the serial chain of iters dependent steps
// per lane (a u32 divide each), plus one block-wide barrier per iteration
// for the emission prefix; the bytes (planes, probabilities, units) would
// take about 0.08 ms at 3.35 TB/s for a 25 MiB block.
//
// Design: one block of 128 threads per group, one thread per lane, native
// u32 division.  An emitting lane finds its slot with __ballot_sync +
// __popc inside its warp plus an exclusive prefix over the group's four
// warp counts in shared memory (double-buffered by iteration parity, so one
// barrier per iteration suffices).  Inactive lanes leave x unchanged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"

using namespace wide;

namespace {

__global__ void __launch_bounds__(kGroup)
wide_rans_kernel(const uint8_t* __restrict__ planes,
                 const int* __restrict__ probs, int iters, int cap,
                 int* __restrict__ units, int* __restrict__ counts,
                 uint32_t* __restrict__ fx) {
  __shared__ int warp_cnt[2][4];
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int lane = g * kGroup + tid;
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  int* gu = units + (size_t)g * cap;

  uint32_t x = 1u << 16;
  int cursor = cap;  // same value in every thread of the group
  for (int i = iters - 1; i >= 0; --i) {
    const int fld = (planes[(size_t)(i >> 2) * kLanes + lane]
                     >> ((i & 3) * 2)) & 3;
    bool ren = false;
    uint32_t unit = 0;
    if (fld & 2) {
      const int bit = fld & 1;
      const uint32_t p = (uint32_t)probs[(size_t)i * kLanes + lane];
      const uint32_t f = bit ? 4096u - p : p;
      if (x >= (f << 20)) {
        ren = true;
        unit = x & 0xFFFFu;
        x >>= 16;
      }
      x = ((x / f) << 12) + (x % f) + (bit ? p : 0u);
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);
    int* wc = warp_cnt[i & 1];
    if ((tid & 31) == 0) wc[warp] = __popc(mask);
    __syncthreads();
    int before = 0, m = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      before += w < warp ? wc[w] : 0;
      m += wc[w];
    }
    if (ren) gu[cursor - m + before + __popc(mask & below)] = (int)unit;
    cursor -= m;
  }
  fx[lane] = x;
  if (tid == 0) counts[g] = cap - cursor;
}

}  // namespace

// planes: u8 [ceil(iters/4), 1024]; probs: i32 [iters, 1024];
// units: i32 [8, cap] with cap >= 128 * iters (at most one unit per lane
// and iteration); counts: i32 [8]; fx: u32 [1024].
extern "C" int wide_rans_launch(const uint8_t* planes, const int* probs,
                                int iters, int cap, int* units, int* counts,
                                uint32_t* fx, void* stream) {
  wide_rans_kernel<<<kGroups, kGroup, 0, (cudaStream_t)stream>>>(
      planes, probs, iters, cap, units, counts, fx);
  return (int)cudaGetLastError();
}
