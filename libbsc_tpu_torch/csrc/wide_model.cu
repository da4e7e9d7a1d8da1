// K1, the wide coder's model pass (v3 encode pass A).
//
// Replaces the Pallas kernel _build_model_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py.  For every lane and every iteration it
// runs the lane's state machine over the scheduled bits, looks up the
// probability of the lane's current context, writes it into the
// probability plane and adapts that context.  Inactive lanes (past their
// last bit) write p = 0.
//
// What bounds it on the H100: not bytes (the plane is iters x 1024 x 4 B,
// about 0.08 ms at 3.35 TB/s for a 25 MiB block, iters ~ 62,000) but each
// lane's serial chain of iters dependent steps, 1024 chains on 8 of the
// 132 SMs.  The switch-form design took about 1,670 cycles a step
// (tools/encode_step_split.py): the six phases of a warp ran the state
// machine and the model one after another, and every fourth step waited
// on a device-memory load.  This design takes about 170: the state warps'
// table walk, issued at about one instruction every two cycles with only
// two warps on a scheduler, is the longer chain.
//
// Design (wide_encode_step.cuh): one block of 256 threads per group; the
// state warps walk the table ahead of the model warps, one chunk of 32
// steps at a time.  A model thread's model is a u16 column of [282][128]
// in shared memory (row 281 the sink of finished lanes); each step loads
// the next step's p before storing its own update (the stored value
// replaces it when both steps share the context) and writes p, or 0 for
// an inactive step, with one predicated coalesced store.  48 registers,
// 118,960 B of dynamic shared memory (ptxas -v; chip_smoke.py phase 1
// prints it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_encode_step.cuh"

using namespace wide;

namespace {

__global__ void __launch_bounds__(kThreads)
wide_model_kernel(const uint8_t* __restrict__ planes, int iters,
                  const int* __restrict__ priors,
                  const uint4* __restrict__ table, int* __restrict__ probs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const EncodeSmem m = encode_smem(smem);
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  encode_begin(m, priors, table, planes, (iters + 3) >> 2, g, tid);
  if (tid < kGroup) {
    encode_states(m, planes, iters, g, tid);
    return;
  }
  const int lane = tid - kGroup;
  const int nchunks = (iters + kSteps - 1) / kSteps;
  uint16_t* col = m.model + lane;
  int* out = probs + g * kGroup + lane;
  for (int c = 0; c < nchunks; ++c) {
    uint32_t wv[kSteps];
    take_chunk(m, c, nchunks, lane, wv);
    // p of the next step is loaded before this step's store and taken
    // from the store instead when both steps share the context.  Steps
    // past iters are inactive words: they adapt the sink row and store
    // nothing.
    uint32_t p = col[(wv[0] & kWordCtx) * kGroup];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int ctx = wv[j] & kWordCtx;
      const int bit = (wv[j] >> 9) & 1;
      const uint32_t np = adapt(p, bit);
      const uint32_t out_p = (wv[j] & kWordActive) ? p : 0;
      if (j + 1 < kSteps) {
        const int nctx = wv[j + 1] & kWordCtx;
        const uint32_t q = col[nctx * kGroup];
        col[ctx * kGroup] = (uint16_t)np;
        p = nctx == ctx ? np : q;
      } else {
        col[ctx * kGroup] = (uint16_t)np;
      }
      store_if(out, (int)out_p, c * kSteps + j < iters);
      out += kLanes;
    }
  }
}

}  // namespace

// planes: u8 [rows, 1024] packed 2-bit (bit | active) fields, 4 rows >=
// iters, 16-byte aligned; table: i32 [363, 4] (ops/wide_kernels.py
// sm_table); probs: i32 [iters, 1024] (rows past iters are the caller's).
extern "C" int wide_model_launch(const uint8_t* planes, int iters,
                                 const int* priors, const int* table,
                                 int* probs, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_model_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kEncSmem);
  if (err != cudaSuccess) return (int)err;
  wide_model_kernel<<<kGroups, kThreads, kEncSmem, (cudaStream_t)stream>>>(
      planes, iters, priors, reinterpret_cast<const uint4*>(table), probs);
  return (int)cudaGetLastError();
}
