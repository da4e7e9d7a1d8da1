// Other designs of K8, the wide-aux inverse BWT, for
// tools/chase_variants.py, beside the package's kernels (included below:
// the two-step int64 table built from the sort's indices, and its chase):
//   packed:     the design up to f242faf, an int64 table, row k =
//               (first char of row k) << 32 | PSI[k], one load a step;
//   split:      a u32 PSI table beside a u8 array of the rows' chars,
//               two loads a step;
//   bucket:     a u32 PSI table (psi_table_kernel) and one load a step,
//               the row's char from the bucket ends (row_char);
//   pairs5:     the two-step table as a u32 PSI^2 array beside a u8 array
//               of the chars of rows PSI[k], two loads a step of two;
//   pairs8_psi: the package's two-step int64 table, built from the u32
//               PSI table instead of the sort's indices.
// Every chase here takes r a multiple of 16 and 16-byte stores.

#include "unbwt_chase.cu"

namespace {

__device__ __forceinline__ void store16(uint8_t* out, long long pos,
                                        long long n, const unsigned* w) {
  if (pos + 16 <= n) {
    *reinterpret_cast<uint4*>(out + pos) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = 0; pos + i < n; ++i)
      out[pos + i] = (uint8_t)(w[i >> 2] >> ((i & 3) * 8));
  }
}

__global__ void __launch_bounds__(kThreads)
packed_chase_kernel(const long long* __restrict__ packed,
                    const long long* __restrict__ start_rows, int chains,
                    int r, long long n, uint8_t* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= chains) return;
  unsigned long long k = (unsigned long long)start_rows[t];
  const long long o = (long long)t * r;
  for (int s0 = 0; s0 < r && o + s0 < n; s0 += 16) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned long long x = (unsigned long long)__ldg(packed + k);
      w[i >> 2] |= (unsigned)((x >> 32) & 0xFF) << ((i & 3) * 8);
      k = x & 0xFFFFFFFFull;
    }
    store16(out, o + s0, n, w);
  }
}

// chars null: the row's char from the bucket ends (bucket), else from
// the u8 array (split).
template <bool kBucket>
__global__ void __launch_bounds__(kThreads)
psi_chase_kernel(const unsigned* __restrict__ psi,
                 const uint8_t* __restrict__ chars,
                 const unsigned* __restrict__ ends_g,
                 const unsigned* __restrict__ start_rows, int chains, int r,
                 long long n, uint8_t* __restrict__ out) {
  __shared__ unsigned ends[256];
  if (kBucket) load_ends(ends, ends_g);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= chains) return;
  unsigned k = start_rows[t];
  const long long o = (long long)t * r;
  for (int s0 = 0; s0 < r && o + s0 < n; s0 += 16) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned next = __ldg(psi + k);
      const unsigned c = kBucket ? row_char(ends, k) : __ldg(chars + k);
      w[i >> 2] |= c << ((i & 3) * 8);
      k = next;
    }
    store16(out, o + s0, n, w);
  }
}

__global__ void __launch_bounds__(kTableThreads)
psi_table_kernel(const long long* __restrict__ u_sorted, long long n,
                 unsigned primary, unsigned* __restrict__ psi) {
  const long long k = (long long)blockIdx.x * kTableThreads + threadIdx.x;
  if (k <= n) psi[k] = psi_of(u_sorted, (unsigned)k, primary);
}

// kFromPsi: the int64 two-step table from the PSI table; else the u32
// and u8 arrays from the sort's indices.
template <bool kFromPsi>
__global__ void __launch_bounds__(kTableThreads)
pairs_table_kernel(const long long* __restrict__ u_sorted,
                   const unsigned* __restrict__ psi, long long n,
                   unsigned primary, const unsigned* __restrict__ ends_g,
                   unsigned long long* __restrict__ pairs,
                   unsigned* __restrict__ psi2, uint8_t* __restrict__ c2) {
  __shared__ unsigned ends[256];
  load_ends(ends, ends_g);
  const long long k = (long long)blockIdx.x * kTableThreads + threadIdx.x;
  if (k > n) return;
  if (kFromPsi) {
    const unsigned p = __ldg(psi + k);
    pairs[k] = (unsigned long long)row_char(ends, p) << 32 | __ldg(psi + p);
  } else {
    const unsigned p = psi_of(u_sorted, (unsigned)k, primary);
    psi2[k] = psi_of(u_sorted, p, primary);
    c2[k] = (uint8_t)row_char(ends, p);
  }
}

__global__ void __launch_bounds__(kThreads)
pairs5_chase_kernel(const unsigned* __restrict__ psi2,
                    const uint8_t* __restrict__ c2,
                    const unsigned* __restrict__ ends_g,
                    const unsigned* __restrict__ start_rows, int chains,
                    int r, long long n, uint8_t* __restrict__ out) {
  __shared__ unsigned ends[256];
  load_ends(ends, ends_g);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= chains) return;
  unsigned k = __ldg(start_rows + t);
  const long long o = (long long)t * r;
  for (int s0 = 0; s0 < r && o + s0 < n; s0 += 16) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned next = __ldg(psi2 + k);
      const unsigned c1 = __ldg(c2 + k);
      w[i >> 1] |= (row_char(ends, k) | c1 << 8) << ((i & 1) * 16);
      k = next;
    }
    store16(out, o + s0, n, w);
  }
}

unsigned chase_blocks(int chains) {
  return (unsigned)((chains + kThreads - 1) / kThreads);
}

unsigned table_blocks(long long n) {
  return (unsigned)((n + kTableThreads) / kTableThreads);
}

}  // namespace

extern "C" int packed_chase_launch(const long long* packed,
                                   const long long* start_rows, int chains,
                                   int r, long long n, uint8_t* out,
                                   void* stream) {
  if (r % 16) return (int)cudaErrorInvalidValue;
  packed_chase_kernel<<<chase_blocks(chains), kThreads, 0,
                        (cudaStream_t)stream>>>(packed, start_rows, chains,
                                                r, n, out);
  return (int)cudaGetLastError();
}

// chars null: bucket, else split.
extern "C" int psi_chase_launch(const unsigned* psi, const uint8_t* chars,
                                const unsigned* ends,
                                const unsigned* start_rows, int chains,
                                int r, long long n, uint8_t* out,
                                void* stream) {
  if (r % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (chars)
    psi_chase_kernel<false><<<chase_blocks(chains), kThreads, 0, s>>>(
        psi, chars, ends, start_rows, chains, r, n, out);
  else
    psi_chase_kernel<true><<<chase_blocks(chains), kThreads, 0, s>>>(
        psi, chars, ends, start_rows, chains, r, n, out);
  return (int)cudaGetLastError();
}

extern "C" int psi_table_launch(const long long* u_sorted, long long n,
                                unsigned primary, unsigned* psi,
                                void* stream) {
  psi_table_kernel<<<table_blocks(n), kTableThreads, 0,
                     (cudaStream_t)stream>>>(u_sorted, n, primary, psi);
  return (int)cudaGetLastError();
}

// psi given: pairs from it (pairs8_psi); else psi2 and c2 (pairs5).
extern "C" int pairs_table_launch(const long long* u_sorted,
                                  const unsigned* psi, long long n,
                                  unsigned primary, const unsigned* ends,
                                  unsigned long long* pairs, unsigned* psi2,
                                  uint8_t* c2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (psi)
    pairs_table_kernel<true><<<table_blocks(n), kTableThreads, 0, s>>>(
        u_sorted, psi, n, primary, ends, pairs, psi2, c2);
  else
    pairs_table_kernel<false><<<table_blocks(n), kTableThreads, 0, s>>>(
        u_sorted, psi, n, primary, ends, pairs, psi2, c2);
  return (int)cudaGetLastError();
}

extern "C" int pairs5_chase_launch(const unsigned* psi2, const uint8_t* c2,
                                   const unsigned* ends,
                                   const unsigned* start_rows, int chains,
                                   int r, long long n, uint8_t* out,
                                   void* stream) {
  if (r % 16) return (int)cudaErrorInvalidValue;
  pairs5_chase_kernel<<<chase_blocks(chains), kThreads, 0,
                        (cudaStream_t)stream>>>(psi2, c2, ends, start_rows,
                                                chains, r, n, out);
  return (int)cudaGetLastError();
}
