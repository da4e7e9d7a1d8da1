// K8, the wide-aux chase: the inverse BWT of the wide-aux profile.
//
// Replaces the XLA program _unbwt_wideaux_jit in the JAX package's
// libbsc_tpu/ops/bwt.py:870, a lax.scan of r gather steps over all
// chains at once (one vector gather a step, because a TPU core runs
// vectors, not thousands of threads).  Its torch port, the plain version
// (ops/bwt.chase_plain), launches a gather, a shift, a cast, a mask and a
// row store for each of the r steps.
//
// Input: the packed table int64 [n + 1], row k = (first char of row k)
// << 32 | PSI[k], and the chains' start rows (ops/bwt.chase_inputs):
// chain 0 at the primary, chain t at aux[t - 1] + 1.  Chain t emits
// output positions [t r, (t + 1) r), cut at n.  The table is int64
// because char << 25 | PSI does not fit 32 bits: 8 + 25 bits are 33 (the
// JAX package's u32 packing drops bit 7 of the char).  The caller has
// checked the indexes (api._check_wideaux): every start row and every
// PSI value lies in [0, n], so the kernel trusts them.
//
// What bounds it on the H100: latency.  Each chain makes r dependent
// loads at random rows of a table of 8 (n + 1) bytes, four times the
// 50 MB L2 at 25 MiB, so a step costs about one device-memory round
// trip.  At 25 MiB, r = 2,048 and there are about 12,800 chains: under
// four warps an SM, so nothing hides that latency, and the kernel takes
// about r round trips whatever it does.  The bytes (the table read once,
// n bytes written) take about 0.07 ms at 3.35 TB/s.
//
// Design: one thread a chain, all chains in one wave (64 threads a
// block, so the chains spread over every SM and each SM keeps its
// share of loads in flight).  A thread gathers 16 steps into four
// registers and stores them as one 16-byte write: when r is a multiple
// of 16 (r is a power of two of at least 256 on every route through the
// API) each chain's span starts 16-byte aligned.  Any other r takes a
// byte store a step.  A chain stops at n: the steps past it emit
// nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
unbwt_chase_kernel(const long long* __restrict__ packed,
                   const long long* __restrict__ start_rows, int chains,
                   int r, long long n, uint8_t* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= chains) return;
  unsigned long long k = (unsigned long long)start_rows[t];
  const long long o = (long long)t * r;
  if (kVec16) {
    for (int s0 = 0; s0 < r && o + s0 < n; s0 += 16) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const unsigned long long x =
            (unsigned long long)__ldg(packed + k);
        w[i >> 2] |= (unsigned)((x >> 32) & 0xFF) << ((i & 3) * 8);
        k = x & 0xFFFFFFFFull;
      }
      const long long pos = o + s0;
      if (pos + 16 <= n) {
        *reinterpret_cast<uint4*>(out + pos) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int i = 0; pos + i < n; ++i)
          out[pos + i] = (uint8_t)(w[i >> 2] >> ((i & 3) * 8));
      }
    }
  } else {
    for (int s = 0; s < r && o + s < n; ++s) {
      const unsigned long long x = (unsigned long long)__ldg(packed + k);
      out[o + s] = (uint8_t)(x >> 32);
      k = x & 0xFFFFFFFFull;
    }
  }
}

}  // namespace

// packed: i64 [n + 1]; start_rows: i64 [chains]; out: u8 [min(n, chains
// * r)], 16-byte aligned.
extern "C" int unbwt_chase_launch(const long long* packed,
                                  const long long* start_rows, int chains,
                                  int r, long long n, uint8_t* out,
                                  void* stream) {
  if (chains <= 0 || r <= 0 || n <= 0) return 0;
  const unsigned blocks = (unsigned)((chains + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (r % 16 == 0 && ((uintptr_t)out & 15) == 0)
    unbwt_chase_kernel<true><<<blocks, kThreads, 0, s>>>(
        packed, start_rows, chains, r, n, out);
  else
    unbwt_chase_kernel<false><<<blocks, kThreads, 0, s>>>(
        packed, start_rows, chains, r, n, out);
  return (int)cudaGetLastError();
}
