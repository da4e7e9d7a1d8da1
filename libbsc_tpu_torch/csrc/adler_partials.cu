// K7, the Adler-32 chunk partials.
//
// Replaces the Pallas kernel _adler_partials (_adler_kernel) in the JAX
// package's libbsc_tpu/ops/pallas_kernels.py.  For every 2048-byte chunk
// of the input it writes s1 = sum x_j and s2 = sum (2048 - j) x_j, the
// last chunk as if zero-padded, into int32 [n_chunks, 2]; the wrapper
// combines them exactly into the Adler-32 (adler32_device).  A chunk's s2
// is at most 255 * 2048 * 2049 / 2 < 2^31, and every partial sum of it is
// smaller, so int32 cannot overflow.
//
// What bounds it on the H100: the bytes.  n bytes in, 8 bytes a chunk out:
// a 25 MiB block takes 0.0079 ms at 3.35 TB/s.  Operations are two
// multiply-adds a byte.
//
// Design: one warp a chunk, eight chunks a block.  When the input is
// 16-byte aligned and the chunk is whole, each lane reads four uint4 (in
// each of four rounds the warp reads 512 neighbouring bytes); otherwise
// the lanes read one byte each, stride 32, and stop at n.  The lanes'
// partial sums meet in a shuffle reduction, and lane 0 writes the pair.
// The TPU kernel's [R, 2048] tiles, its padding and its lane-padded
// [R, 128] output are gone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 2048;
constexpr int kWarps = 8;  // chunks a block

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
adler_partials_kernel(const uint8_t* __restrict__ data, long long n,
                      long long n_chunks, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // c is the same for the whole warp
  const long long base = c * kChunk;
  const uint8_t* p = data + base;
  int s1 = 0, s2 = 0;
  if (kVec && base + kChunk <= n) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j0 = r * 512 + lane * 16;
      const uint4 v = *reinterpret_cast<const uint4*>(p + j0);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int x = (w[q] >> (8 * b)) & 0xFF;
          s1 += x;
          s2 += (kChunk - (j0 + 4 * q + b)) * x;
        }
      }
    }
  } else {
    const long long left = n - base;
    const int k = left < kChunk ? (int)left : kChunk;
    for (int j = lane; j < k; j += 32) {
      const int x = p[j];
      s1 += x;
      s2 += (kChunk - j) * x;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  if (lane == 0) {
    out[2 * c] = s1;
    out[2 * c + 1] = s2;
  }
}

}  // namespace

// data: u8 [n] at any address; out: i32 [ceil(n / 2048), 2].
extern "C" int adler_partials_launch(const uint8_t* data, long long n,
                                     int* out, void* stream) {
  if (n <= 0) return 0;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const unsigned blocks = (unsigned)((n_chunks + kWarps - 1) / kWarps);
  if (((uintptr_t)data & 15) == 0)
    adler_partials_kernel<true><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        data, n, n_chunks, out);
  else
    adler_partials_kernel<false><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
        data, n, n_chunks, out);
  return (int)cudaGetLastError();
}
