// K1, the wide coder's model pass (v3 encode pass A).
//
// Replaces the Pallas kernel _build_model_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py.  For every lane and every iteration it
// runs the lane's state machine over the scheduled bits, looks up the
// probability of the lane's current context, writes it into the
// probability plane and adapts that context.
//
// What bounds it on the H100: not bytes (the plane is iters x 1024 x 4 B,
// about 0.08 ms at 3.35 TB/s for a 25 MiB block, iters ~ 62,000) but the
// serial chain of iters dependent steps per lane: each step's context
// depends on the previous step's state, and the model entry it reads may be
// the one the previous step wrote.  Only 1024 chains exist, so the card
// holds 8 blocks on 8 of its 132 SMs.
//
// Design: one thread per lane, one block of 128 threads per group.  The
// lane's 281-entry model lives in its own column of dynamic shared memory
// (u16, [281][128], 71,936 B per block) and is read and updated in the
// same step with one indexed access; there is no cross-thread traffic and
// no barrier.  Inactive lanes (past their last bit) write p = 0 and do not
// adapt.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"

using namespace wide;

namespace {

constexpr int kSmem = kNctx * kGroup * 2;

__global__ void __launch_bounds__(kGroup)
wide_model_kernel(const uint8_t* __restrict__ planes, int iters,
                  const int* __restrict__ priors, int* __restrict__ probs) {
  extern __shared__ uint16_t model[];  // [kNctx][kGroup]
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kGroup + tid;
  for (int c = 0; c < kNctx; ++c) model[c * kGroup + tid] = priors[c];

  LaneState s = fresh_state(kRFlag);
  int packed = 0;
  for (int i = 0; i < iters; ++i) {
    if ((i & 3) == 0) packed = planes[(size_t)(i >> 2) * kLanes + lane];
    const int fld = (packed >> ((i & 3) * 2)) & 3;
    int p = 0;
    if (fld & 2) {
      const int bit = fld & 1;
      uint16_t* m = &model[sm_ctx(s) * kGroup + tid];
      p = *m;
      *m = (uint16_t)adapt(p, bit);
      sm_next(s, bit);
    }
    probs[(size_t)i * kLanes + lane] = p;
  }
}

}  // namespace

// planes: u8 [ceil(iters/4), 1024] packed 2-bit (bit | active) fields;
// probs: i32 [iters, 1024] (rows past iters are the caller's).
extern "C" int wide_model_launch(const uint8_t* planes, int iters,
                                 const int* priors, int* probs,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_model_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  wide_model_kernel<<<kGroups, kGroup, kSmem, (cudaStream_t)stream>>>(
      planes, iters, priors, probs);
  return (int)cudaGetLastError();
}
