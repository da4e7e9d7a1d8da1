// K6, the 256-bin byte histogram.
//
// Replaces the Pallas kernel byte_histogram (_hist_kernel) in the JAX
// package's libbsc_tpu/ops/pallas_kernels.py.  That kernel pads the input
// to 128 KiB tiles and sweeps each tile once per symbol value
// (compare-reduce), because Mosaic has no scatter; the padding is then
// subtracted from bin 0.  Hopper has fast shared-memory atomics, so this
// kernel reads each byte once and counts it where it lies: no padding, no
// sweep.
//
// What bounds it on the H100: the bytes.  n bytes in, 1 KiB out: a 25 MiB
// block takes 0.0078 ms at 3.35 TB/s.  Operations are one increment a byte.
//
// Design: a grid-stride loop of 16-byte vector loads (one uint4 a thread,
// neighbouring threads on neighbouring addresses) into a shared-memory
// histogram per warp, so the warps of a block never contend.  Within a
// warp, skewed input (a run of one byte, an all-zero block) would put all
// 32 lanes on one bin and serialise their atomics 32 ways:
// __match_any_sync groups the lanes that hold the same byte, and only the
// lowest lane of each group adds the group's size.  A shard is a view at
// any byte offset, so the unaligned head (up to 15 bytes before the first
// 16-byte boundary) and the tail (under 16 bytes) are counted by warp 0 of
// block 0, one byte a lane.  At the end each thread sums one bin over the
// block's warps and adds it into the int32[256] output, which the wrapper
// zeroes, with one global atomic per non-zero bin.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // also the bin count: one bin a thread at the end
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr unsigned kNone = 256;  // a lane with no byte to count

// Every lane of the warp calls this with its byte, or kNone.
__device__ __forceinline__ void count(unsigned* h, unsigned v, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, v);
  if (v != kNone && lane == __ffs(peers) - 1)
    atomicAdd(&h[v], (unsigned)__popc(peers));
}

__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const uint8_t* __restrict__ data, int head, long long n_vec,
                 int tail, int* __restrict__ out) {
  __shared__ unsigned hist[kWarps * 256];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* h = hist + warp * 256;
  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  const long long stride = (long long)gridDim.x * kThreads;
  // base is the same for the whole warp, so every lane reaches each
  // __match_any_sync
  for (long long base = (long long)blockIdx.x * kThreads + warp * 32;
       base < n_vec; base += stride) {
    const long long i = base + lane;
    const bool ok = i < n_vec;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ok) v = vec[i];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        count(h, ok ? (w[q] >> (8 * b)) & 0xFF : kNone, lane);
    }
  }
  if (blockIdx.x == 0 && warp == 0) {  // head + tail <= 30 bytes
    unsigned v = kNone;
    if (lane < head)
      v = data[lane];
    else if (lane - head < tail)
      v = data[head + 16 * n_vec + (lane - head)];
    count(h, v, lane);
  }
  __syncthreads();

  unsigned s = 0;
  for (int w = 0; w < kWarps; ++w) s += hist[w * 256 + threadIdx.x];
  if (s) atomicAdd(&out[threadIdx.x], (int)s);
}

}  // namespace

// data: u8 [n] at any address; out: i32 [256], zeroed by the caller.
extern "C" int byte_hist_launch(const uint8_t* data, long long n, int* out,
                                void* stream) {
  if (n <= 0) return 0;
  int head = (int)((16 - ((uintptr_t)data & 15)) & 15);
  if (head > n) head = (int)n;
  const long long n_vec = (n - head) / 16;
  const int tail = (int)(n - head - 16 * n_vec);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSm) blocks = (long long)sms * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  byte_hist_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, head, n_vec, tail, out);
  return (int)cudaGetLastError();
}
