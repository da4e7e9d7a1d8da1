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
// Design: a grid-stride loop over tiles of kVec 16-byte loads a thread
// (all issued before any is counted, neighbouring threads on neighbouring
// addresses), each byte counted by one plain atomic into its warp's
// shared-memory histogram.  A block holds 8 KiB of histograms, so eight
// blocks (64 warps) fit an SM and keep enough loads in flight; that, not
// sparing the atomics, is what the bytes need.  The design up to commit
// fcee879 grouped a warp's lanes that held one byte with __match_any_sync
// (one match a byte) and took 0.131 ms on text, 0.030 on zeros.
// tools/byte_hist_variants.py times the grid of candidates (histograms a
// warp 1-16, runs merged in registers or not, 1-4 loads a thread); this
// one led on text and zeros: 0.0134 / 0.0132 ms a 25 MiB block (NVIDIA
// H100 80GB HBM3, 700.00 W).  More histograms a warp cost occupancy, and
// the run merge's compares cost more than the atomics it spares, even on
// zeros.
// A shard is a view at any byte offset, so the unaligned head (up to 15
// bytes before the first 16-byte boundary) and the tail (under 16 bytes)
// are counted by warp 0 of block 0, one byte a lane.  At the end each
// thread sums one bin over the block's warps and adds it into the
// int32[256] output, which the wrapper zeroes, with one global atomic per
// non-zero bin.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // also the bin count: one bin a thread at the end
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 2;        // 16-byte loads a thread in flight
constexpr int kSmem = kWarps * 256 * 4;

// a thread's 16 bytes into its warp's histogram h
__device__ __forceinline__ void count16(unsigned* h, uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) atomicAdd(&h[(w[q] >> (8 * b)) & 0xFF], 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const uint8_t* __restrict__ data, int head, long long n_vec,
                 int tail, int* __restrict__ out) {
  extern __shared__ unsigned hist[];  // [kWarps][256]
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* h = hist + warp * 256;
  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  const long long tile = (long long)kThreads * kVec;
  for (long long base = blockIdx.x * tile; base < n_vec;
       base += (long long)gridDim.x * tile) {
    uint4 v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long i = base + threadIdx.x + j * kThreads;
      v[j] = i < n_vec ? vec[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (base + threadIdx.x + j * kThreads < n_vec) count16(h, v[j]);
  }
  if (blockIdx.x == 0 && warp == 0) {  // head + tail <= 30 bytes
    if (lane < head)
      atomicAdd(&h[data[lane]], 1u);
    else if (lane - head < tail)
      atomicAdd(&h[data[head + 16 * n_vec + (lane - head)]], 1u);
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
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, byte_hist_kernel, kThreads, kSmem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n_vec + kThreads * kVec - 1) / (kThreads * kVec);
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  byte_hist_kernel<<<(unsigned)blocks, kThreads, kSmem,
                     (cudaStream_t)stream>>>(data, head, n_vec, tail, out);
  return (int)cudaGetLastError();
}
