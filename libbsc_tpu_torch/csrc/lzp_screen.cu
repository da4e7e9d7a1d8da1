// K15, the LZP screen: for each LZP part of a block, whether any two of its
// match-eligible windows of min_len bytes may be equal.
//
// Replaces no TPU kernel: the JAX package has none like it.  It was added
// to spare the host its LZP attempt on blocks where LZP cannot pay.  The
// native encoder (native/lzp.cc lzp_encode_block) takes a match at
// position i only from an earlier position c of the same part whose first
// min_len bytes equal those at i, both in [4, m - min_len - 32); a part
// with no such pair comes out as literals (and 0xF2 escapes), never
// shorter than itself, so lzp_compress rejects the block when no part has
// one.  A part's flag is 0 only if no two of its windows have equal
// fingerprints, and equal windows have equal fingerprints, so a 0 is a
// proof; a 1 (a repeat, a fingerprint collision, a full bucket) only
// means the host tries LZP as it would without the screen.
//
// The function (ops/lzp_screen.screen_plain computes the same flags):
//   key(g) = mix64(sum_k b[g + k] * kBase^(min_len - 1 - k) mod 2^64) | 1
// for each window start g of a part p (start s_p, size m_p: the native
// split of lzp_num_blocks) with 4 <= g - s_p < m_p - min_len - 32;
// bucket(g) = p * per_part + ((key >> 32) * per_part >> 32);
// flag[p] = some key of p occurs twice, or some bucket of p holds more
// than kCap keys.
//
// What bounds it on the H100: the bytes of the keys.  n bytes in, then
// 8 bytes a window written and read back once: a 25 MiB block takes
// (26.2 MB + 2 x 210 MB) / 3.35 TB/s = 0.133 ms.  Operations are about
// 10 64-bit multiply-adds a window.
//
// Design: two kernels, no library call.
// 1. keys: a block stages 8,448 positions and the min_len - 1 byte halo
//    in shared memory; each thread rolls the fingerprint over 33
//    consecutive positions and writes each key into its bucket's fixed
//    region of kCap slots, at an atomic cursor (one a 32-byte sector, so
//    that no two cursors share one).  Keys land in random 8-byte slots:
//    the write amplification of the design.  A bucket's keys are about
//    2,048 with a standard deviation of 45 (the keys are hashed), so a
//    cursor past kCap means repeats, or a bucket whose keys are not
//    written: its part reads "may match".
// 2. dedup: a block a bucket inserts its keys into a table of kSlots in
//    shared memory by 64-bit compare-and-swap with linear probing; a key
//    found there sets its part's flag.
// The design first counted the keys of each bucket in a pass of its own
// for exact offsets (1.31 ms) before placing them (1.63 ms; the dedup
// 0.29 ms): both passes were bound by their global atomics, one a window,
// since the same passes on all-zero bytes, which emit almost nothing,
// took 0.26 and 0.20 ms.
// Skewed blocks would pile onto a few cursors (all-zero bytes: one key a
// part), so a thread compares each key with its last 8 and, on a repeat,
// sets the flag itself; a thread whose part's flag is set (read at the
// start of its run) writes nothing more for that part, and the dedup
// skips a flagged part: a part keeps every key until it is flagged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

using u64 = unsigned long long;

constexpr u64 kBase = 0x9E3779B97F4A7C15ull;  // odd: invertible mod 2^64
constexpr int kThreads = 256;
constexpr int kPer = 33;  // consecutive positions a thread: odd, so a
                          // warp's byte reads fall in distinct banks
constexpr int kTile = kThreads * kPer;        // positions a block
constexpr int kMaxLen = 255;                  // the format's largest min_len
constexpr int kDedupThreads = 256;
constexpr int kSlots = 4096;                  // 32 KiB of u64 a table
constexpr unsigned kCap = 3072;               // keys a bucket, load <= 0.75
constexpr int kStride = 8;                    // a cursor a 32-byte sector

__device__ __forceinline__ u64 mix64(u64 z) {  // splitmix64's finalizer
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

__global__ void __launch_bounds__(kThreads)
lzp_screen_keys_kernel(const uint8_t* __restrict__ data, long long n,
                       long long chunk, int parts, int min_len, u64 pow_top,
                       int per_part, unsigned* __restrict__ cursor,
                       u64* __restrict__ entries, int* flags) {
  __shared__ uint8_t tile[kTile + kMaxLen];
  const long long base = (long long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile + min_len - 1; i += kThreads) {
    const long long g = base + i;
    tile[i] = g < n ? data[g] : 0;
  }
  __syncthreads();

  const int j0 = threadIdx.x * kPer;
  const long long g0 = base + j0;
  if (g0 >= n) return;
  long long p = g0 / chunk;
  if (p > parts - 1) p = parts - 1;
  long long lo = p * chunk + 4;  // the part's eligible window starts
  long long hi = (p == parts - 1 ? n : (p + 1) * chunk) - min_len - 32;
  bool skip = *(volatile int*)&flags[p] != 0;
  u64 r0 = 0, r1 = 0, r2 = 0, r3 = 0, r4 = 0, r5 = 0, r6 = 0, r7 = 0;

  u64 f = 0;
  for (int k = 0; k < min_len; ++k) f = f * kBase + tile[j0 + k];
  for (int q = 0; q < kPer; ++q) {
    const long long g = g0 + q;
    if (q) f = (f - tile[j0 + q - 1] * pow_top) * kBase
               + tile[j0 + q - 1 + min_len];
    if (p < parts - 1 && g >= (p + 1) * chunk) {  // into the next part
      ++p;
      lo = p * chunk + 4;
      hi = (p == parts - 1 ? n : (p + 1) * chunk) - min_len - 32;
      skip = *(volatile int*)&flags[p] != 0;
      r0 = r1 = r2 = r3 = r4 = r5 = r6 = r7 = 0;
    }
    if (skip || g < lo || g >= hi) continue;
    const u64 key = mix64(f) | 1ull;
    if (key == r0 || key == r1 || key == r2 || key == r3 || key == r4 ||
        key == r5 || key == r6 || key == r7) {
      atomicOr(&flags[p], 1);
      skip = true;
      continue;
    }
    r7 = r6; r6 = r5; r5 = r4; r4 = r3; r3 = r2; r2 = r1; r1 = r0; r0 = key;
    const unsigned b = (unsigned)(p * per_part) +
        (unsigned)(((key >> 32) * (u64)per_part) >> 32);
    const unsigned at = atomicAdd(&cursor[(size_t)b * kStride], 1u);
    if (at < kCap) entries[(size_t)b * kCap + at] = key;
  }
}

__global__ void __launch_bounds__(kDedupThreads)
lzp_screen_dedup_kernel(const u64* __restrict__ entries,
                        const unsigned* __restrict__ cursor, int per_part,
                        int* flags) {
  extern __shared__ u64 table[];  // kSlots, 0 empty (every key is odd)
  __shared__ int done;
  const int b = blockIdx.x;
  const int p = b / per_part;
  const unsigned cnt = cursor[(size_t)b * kStride];
  if (cnt < 2) return;
  if (threadIdx.x == 0) done = *(volatile int*)&flags[p];
  __syncthreads();
  if (done) return;
  if (cnt > kCap) {  // keys not written: no proof, so "may match"
    if (threadIdx.x == 0) atomicOr(&flags[p], 1);
    return;
  }
  for (int i = threadIdx.x; i < kSlots; i += kDedupThreads) table[i] = 0;
  __syncthreads();
  const u64* keys = entries + (size_t)b * kCap;
  for (unsigned i = threadIdx.x; i < cnt && !*(volatile int*)&done;
       i += kDedupThreads) {
    const u64 key = keys[i];
    unsigned s = (unsigned)(key >> 1) & (kSlots - 1);
    for (;;) {
      const u64 prev = atomicCAS(&table[s], 0ull, key);
      if (prev == 0ull) break;
      if (prev == key) {
        done = 1;
        break;
      }
      s = (s + 1) & (kSlots - 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && done) atomicOr(&flags[p], 1);
}

}  // namespace

// data: u8 [n]; pow_top: kBase^(min_len - 1) mod 2^64; cursor: u32
// [parts * per_part * kStride], zeroed by the caller; entries: u64
// [parts * per_part * kCap]; flags: i32 [parts], zeroed.
extern "C" int lzp_screen_launch(const uint8_t* data, long long n,
                                 long long chunk, int parts, int min_len,
                                 u64 pow_top, int per_part, unsigned* cursor,
                                 u64* entries, int* flags, void* stream) {
  if (n <= 0) return 0;
  if (min_len < 1 || min_len > kMaxLen) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned tiles = (unsigned)((n + kTile - 1) / kTile);
  lzp_screen_keys_kernel<<<tiles, kThreads, 0, s>>>(
      data, n, chunk, parts, min_len, pow_top, per_part, cursor, entries,
      flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lzp_screen_dedup_kernel<<<parts * per_part, kDedupThreads,
                            kSlots * sizeof(u64), s>>>(entries, cursor,
                                                       per_part, flags);
  return (int)cudaGetLastError();
}
