// K8, the wide-aux inverse BWT: its table and its chase.
//
// Replaces the XLA program _unbwt_wideaux_jit in the JAX package's
// libbsc_tpu/ops/bwt.py:870, which builds PSI with one stable sort, packs
// (first char << 25 | PSI) into one u32 a row, and chases the table with
// a lax.scan of r gather steps over all chains at once.  Two of its
// choices were the TPU's and are not kept:
// - The char sits beside PSI there because a TPU core has no cheap
//   indexed load (and the u32 keeps 7 bits of it).  Here the rows are
//   sorted by their first char, so row k's char is the bucket that holds
//   k, found among the 256 bucket ends in shared memory.
// - Its docstring rejects a two-step table because the extra setup
//   gather cancels the step savings on a TPU.  On the H100 that gather
//   runs over all n + 1 rows at once with full memory-level parallelism,
//   while the chase has one load in flight a chain; so the table here
//   is two-step and a chain takes r / 2 loads.
//
// unbwt_table_kernel: row k of the table, one int64, is PSI[PSI[k]] in
// the low 32 bits and the first char of row PSI[k] above them, from the
// stable sort's int64 indices u_sorted [n] (ops/bwt.chase_inputs): PSI[0]
// is the primary, PSI[k >= 1] is u + (u >= primary) with u =
// u_sorted[k - 1].  A thread a row: a coalesced load of u_sorted[k - 1],
// a random one of u_sorted[PSI[k] - 1], the char of row PSI[k] by the
// bucket search, one store.  Bytes: 8 n read, 8 (n + 1) written.
//
// unbwt_chase_kernel: chain 0 starts at the primary, chain t at
// aux[t - 1] + 1, and chain t emits output positions [t r, (t + 1) r),
// cut at n.  A step of two issues the load of row k first, then finds
// row k's own char while that load is in flight: ends[c] = 1 + #(bytes
// <= c) is the end of bucket c, so the char of row k is the number of
// ends at or below k, a branch-free search of 8 steps in shared memory
// (row 0, the sentinel, gets 0).  It emits that char and the row's
// stored one and moves to PSI[PSI[k]]; a chain of odd length ends with a
// single step (its char, no load).  The caller has checked the indexes
// (api._check_wideaux) and the sort's indices lie in range, so every
// start row and every table value lies in [0, n] and the kernel trusts
// them.
//
// What bounds the chase on the H100: the latency of its dependent loads.
// At 25 MiB, r = 2,048 and there are 12,800 chains: under four warps an
// SM, too few to hide a round trip, so the chase takes about r / 2
// loaded round trips whatever it computes between them.  On an NVIDIA
// H100 80GB HBM3 at 700 W (tools/chase_variants.py), one chain alone,
// with nothing else in flight, takes about 0.39 ms and all of them about
// 0.71; the number of random loads a step counts, not their size: a u32
// PSI table beside a u8 char array (two loads a step) took 1.81 ms
// against 1.42 for the int64 table of one load a step, and a 4-byte PSI
// table (one load a step, the char from the bucket ends) 1.34-1.36.  The
// bytes (the rows the chains load, 8 n / 2, the ends and start rows read
// once, n bytes written) take about 0.039 ms at 3.35 TB/s.
//
// Design: one thread a chain, all chains in one wave (64 threads a
// block, so the chains spread over every SM and each SM keeps its share
// of loads in flight); each block loads the bucket ends into shared
// memory once.  A thread gathers 16 bytes (8 steps of two) into four
// registers and stores them as one 16-byte write: when r is a multiple
// of 16 (r is a power of two of at least 256 on every route through the
// API) each chain's span starts 16-byte aligned.  Any other r stores a
// byte at a time.  A chain stops at n: the bytes past it are not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kTableThreads = 256;

// ends: 256 bucket ends in shared memory, ends[c] = 1 + #(bytes <= c).
// The first char of row k is the number of ends at or below k; it is
// below 256 because ends[255] = n + 1 > k.
__device__ __forceinline__ unsigned row_char(const unsigned* ends,
                                             unsigned k) {
  unsigned c = 0;
#pragma unroll
  for (unsigned s = 128; s; s >>= 1) c += ends[c + s - 1] <= k ? s : 0u;
  return c;
}

__device__ __forceinline__ void load_ends(unsigned* ends,
                                          const unsigned* ends_g) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) ends[i] = ends_g[i];
  __syncthreads();
}

// PSI[k] from the sort's indices: the primary for row 0.
__device__ __forceinline__ unsigned psi_of(const long long* u_sorted,
                                           unsigned k, unsigned primary) {
  if (k == 0) return primary;
  const unsigned u = (unsigned)__ldg(u_sorted + k - 1);
  return u + (u >= primary);
}

__global__ void __launch_bounds__(kTableThreads)
unbwt_table_kernel(const long long* __restrict__ u_sorted, long long n,
                   unsigned primary, const unsigned* __restrict__ ends_g,
                   unsigned long long* __restrict__ pairs) {
  __shared__ unsigned ends[256];
  load_ends(ends, ends_g);
  const long long k = (long long)blockIdx.x * kTableThreads + threadIdx.x;
  if (k > n) return;
  const unsigned p = psi_of(u_sorted, (unsigned)k, primary);
  const unsigned q = psi_of(u_sorted, p, primary);
  pairs[k] = (unsigned long long)row_char(ends, p) << 32 | q;
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
unbwt_chase_kernel(const unsigned long long* __restrict__ pairs,
                   const unsigned* __restrict__ ends_g,
                   const unsigned* __restrict__ start_rows, int chains,
                   int r, long long n, uint8_t* __restrict__ out) {
  __shared__ unsigned ends[256];
  load_ends(ends, ends_g);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= chains) return;
  unsigned k = __ldg(start_rows + t);
  const long long o = (long long)t * r;
  if (kVec16) {
    for (int s0 = 0; s0 < r && o + s0 < n; s0 += 16) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned long long x = __ldg(pairs + k);
        const unsigned two = row_char(ends, k) | (unsigned)(x >> 32) << 8;
        w[i >> 1] |= two << ((i & 1) * 16);
        k = (unsigned)x;
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
    const long long m = n - o < r ? n - o : r;  // this chain's bytes
    long long s = 0;
    for (; s + 1 < m; s += 2) {
      const unsigned long long x = __ldg(pairs + k);
      out[o + s] = (uint8_t)row_char(ends, k);
      out[o + s + 1] = (uint8_t)(x >> 32);
      k = (unsigned)x;
    }
    if (s < m) out[o + s] = (uint8_t)row_char(ends, k);
  }
}

}  // namespace

// u_sorted: i64 [n], the stable sort's indices; ends: u32 [256]; pairs:
// u64 [n + 1].
extern "C" int unbwt_table_launch(const long long* u_sorted, long long n,
                                  unsigned primary, const unsigned* ends,
                                  unsigned long long* pairs, void* stream) {
  if (n < 0) return 0;
  const long long blocks = (n + kTableThreads) / kTableThreads;
  unbwt_table_kernel<<<(unsigned)blocks, kTableThreads, 0,
                       (cudaStream_t)stream>>>(u_sorted, n, primary, ends,
                                               pairs);
  return (int)cudaGetLastError();
}

// pairs: u64 [n + 1]; ends: u32 [256]; start_rows: u32 [chains]; out: u8
// [min(n, chains * r)], 16-byte aligned.
extern "C" int unbwt_chase_launch(const unsigned long long* pairs,
                                  const unsigned* ends,
                                  const unsigned* start_rows, int chains,
                                  int r, long long n, uint8_t* out,
                                  void* stream) {
  if (chains <= 0 || r <= 0 || n <= 0) return 0;
  const unsigned blocks = (unsigned)((chains + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (r % 16 == 0 && ((uintptr_t)out & 15) == 0)
    unbwt_chase_kernel<true><<<blocks, kThreads, 0, s>>>(
        pairs, ends, start_rows, chains, r, n, out);
  else
    unbwt_chase_kernel<false><<<blocks, kThreads, 0, s>>>(
        pairs, ends, start_rows, chains, r, n, out);
  return (int)cudaGetLastError();
}
