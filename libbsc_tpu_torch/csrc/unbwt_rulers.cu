// K16, the default format's inverse BWT on the card: a ruling-set chase.
//
// Replaces no TPU kernel.  The JAX package inverts the default format by
// list ranking the whole LF permutation (libbsc_tpu/ops/bwt.py
// bwt_decode: ceil(log2 n) rounds of gathers over n slots), and the
// port's native runtime chases the aux indexes' chains (native/bwt.cc
// unbwt_bigram).  Neither suits the H100: list ranking moves about 25
// n-slot gathers, and the format's aux rate (bwt.cpp:192-197) leaves 8 to
// 16 chains of n / 8 to n / 16 rows, so a chase a chain (K8's design)
// waits n / 32 dependent loads or more, ~400 ms at 25 MiB.  A ruling set
// cuts the one cycle of PSI into ~n / 64 short chains instead.
//
// Rows are the default format's: row 0 is the sentinel, rows 1..n the
// sorted suffixes, PSI[0] = primary and PSI[k >= 1] = u + (u >= primary)
// with u = u_sorted[k - 1] from one stable sort of the BWT's chars; the
// first char of row k is the number of bucket ends at or below k (ends[c]
// = 1 + #(chars <= c)).  Walking PSI from the primary gives the text's
// chars in order; the walk reaches row 0 after n steps.
//
// Rulers (nodes of the ranking), numbered:
// - tile t < tiles (tiles = ceil((n + 1) / 64)): row 64 t + hash(t),
//   the hash a Fibonacci hash of t (the top kTileShift = 6 bits of t *
//   0x9E3779B1); a tile whose row passes n, is row 0 or is a start row
//   has no ruler of its own.  A stride would line up with the row ranges
//   that periodic blocks walk one row a period; the hashed offsets do not.
// - tiles + j for the start rows, sorted: the primary (output offset 0)
//   and each aux index + 1 (offset t r), whose offsets are known.
// - tiles + starts: the sentinel row 0, the terminal (offset n).
//
// Four launches after the sort and the bucket ends:
// rulers_table_kernel: a thread a row k: p = PSI[k]; the int64 holds, in
//   its low 32 bits, p when p is a ruler (bit 41 set), else PSI[p]; the
//   first char of row p in bits 32-39; bit 40 says row k is a ruler.  A
//   two-step chase never sees the index of the row it skips, so the
//   table stops it there (bit 41) and it learns which ruler it met.
// rulers_gaps_kernel: a thread a ruler walks the table, one or two rows a
//   load, to the next ruler, and writes that ruler's node and the gap
//   (rows passed).  No walk passes n rows.
// rulers_rank_kernel: pointer doubling over the nodes, ceil(log2 nodes)
//   launches in one call (it reports how many): each round a node takes its successor's
//   successor and adds its distance.  A node whose final successor is the
//   sentinel is reached, at output offset n - distance.
// rulers_write_kernel: a thread a reached ruler walks its gap again and
//   writes its chars from that offset; a start row whose offset is not
//   its own, or that is not reached, sets the status word.
//
// Bytes that are no BWT still give a permutation, of several cycles: a
// ruler off the sentinel's cycle is not reached and writes nothing; a
// reached ruler's chars lie in [offset, offset + gap), inside [0, n); the
// primary's offset is 0 exactly when PSI is one cycle, so the status word
// is 0 exactly when the block is a BWT of its primary (and aux indexes).
//
// What bounds it on the H100: the latency of the dependent loads of the
// longest gap, twice (the table's 8 (n + 1) bytes sit in HBM, not L2),
// against the number of loads in flight.  A ruler a 2^s rows gives gaps
// of 2^s rows on average and the longest near 2^s ln(nodes).  On 25 MiB
// blocks (NVIDIA H100 80GB HBM3 at 700 W; text, all zeros, a 1,000-byte
// period, random) a ruler a 64 rows (410,000 chains, longest gap 104-869
// rows) took 1.54-3.02 ms for the whole inverse, a 256 rows 1.58-3.64 and
// a 512 1.67-4.84: the chases shrink with the longest gap, the ranking
// grows with the nodes (0.19-0.23 ms at 64, 0.12-0.14 at 256).
// The bytes (the sort's 8 n read and the table's 8 (n + 1) written, each
// chase's n / 2 loads of 8 bytes, n bytes written) take about 0.2 ms at
// 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;  // a chase's threads a block: chains spread
constexpr int kTableThreads = 256;
constexpr int kRankThreads = 256;
constexpr int kMaxStarts = 256;  // the primary and 255 aux indexes (u8)
constexpr int kTileShift = 6;    // a ruler a 64 rows (TILE_SHIFT)

constexpr unsigned long long kSelf = 1ull << 40;  // row k is a ruler
constexpr unsigned long long kNext = 1ull << 41;  // row PSI[k] is a ruler

struct Starts {  // the sorted start rows, in shared memory
  unsigned rows[kMaxStarts];
  int count;
};

__device__ __forceinline__ void load_starts(Starts& s, const unsigned* rows,
                                            int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) s.rows[i] = rows[i];
  if (threadIdx.x == 0) s.count = count;
}

__device__ __forceinline__ void load_ends(unsigned* ends,
                                          const unsigned* ends_g) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) ends[i] = ends_g[i];
}

// The slot of row k among the sorted start rows, or -1.
__device__ __forceinline__ int start_slot(const Starts& s, unsigned k) {
  int lo = 0, hi = s.count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s.rows[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo < s.count && s.rows[lo] == k ? lo : -1;
}

// Tile t's ruler row (before the checks of is_ruler).
__device__ __forceinline__ unsigned long long tile_row(unsigned t) {
  const unsigned h = (t * 0x9E3779B1u) >> (32 - kTileShift);
  return ((unsigned long long)t << kTileShift) + h;
}

__device__ __forceinline__ bool is_ruler(const Starts& s, unsigned k) {
  return k == 0 || tile_row(k >> kTileShift) == k || start_slot(s, k) >= 0;
}

// The node of ruler row k.
__device__ __forceinline__ int node_of(const Starts& s, unsigned k,
                                      int tiles) {
  if (k == 0) return tiles + s.count;
  const int j = start_slot(s, k);
  return j >= 0 ? tiles + j : (int)(k >> kTileShift);
}

// The first char of row k: the number of ends at or below it.
__device__ __forceinline__ unsigned row_char(const unsigned* ends,
                                             unsigned k) {
  unsigned c = 0;
#pragma unroll
  for (unsigned b = 128; b; b >>= 1) c += ends[c + b - 1] <= k ? b : 0u;
  return c;
}

__device__ __forceinline__ unsigned psi_of(const long long* u_sorted,
                                           unsigned k, unsigned primary) {
  if (k == 0) return primary;
  const unsigned u = (unsigned)__ldg(u_sorted + k - 1);
  return u + (u >= primary);
}

// The ruler row of node i < tiles + starts, or 0 where the tile has none.
__device__ __forceinline__ unsigned node_row(const Starts& s, int i,
                                            int tiles, long long n) {
  if (i >= tiles) return s.rows[i - tiles];
  const unsigned long long k = tile_row((unsigned)i);
  if (k == 0 || k > (unsigned long long)n || start_slot(s, (unsigned)k) >= 0)
    return 0;
  return (unsigned)k;
}

__global__ void __launch_bounds__(kTableThreads)
rulers_table_kernel(const long long* __restrict__ u_sorted, long long n,
                    unsigned primary, const unsigned* __restrict__ ends_g,
                    const unsigned* __restrict__ start_rows, int starts,
                    unsigned long long* __restrict__ pairs) {
  __shared__ unsigned ends[256];
  __shared__ Starts s;
  load_ends(ends, ends_g);
  load_starts(s, start_rows, starts);
  __syncthreads();
  const long long k = (long long)blockIdx.x * kTableThreads + threadIdx.x;
  if (k > n) return;
  const unsigned p = psi_of(u_sorted, (unsigned)k, primary);
  const bool stop = is_ruler(s, p);
  const unsigned low = stop ? p : psi_of(u_sorted, p, primary);
  pairs[k] = (is_ruler(s, (unsigned)k) ? kSelf : 0ull) |
             (stop ? kNext : 0ull) |
             (unsigned long long)row_char(ends, p) << 32 | low;
}

__global__ void __launch_bounds__(kThreads)
rulers_gaps_kernel(const unsigned long long* __restrict__ pairs, long long n,
                   const unsigned* __restrict__ start_rows, int starts,
                   int tiles, int* __restrict__ succ,
                   long long* __restrict__ gap) {
  __shared__ Starts s;
  load_starts(s, start_rows, starts);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int sentinel = tiles + starts;
  if (i > sentinel) return;
  const unsigned row = i < sentinel ? node_row(s, i, tiles, n) : 0u;
  if (row == 0) {  // the terminal, or a tile with no ruler
    succ[i] = i;
    gap[i] = 0;
    return;
  }
  unsigned k = row;
  long long g = 0;
  bool lost = false;
  for (;;) {
    const unsigned long long x = __ldg(pairs + k);
    if (g > 0 && (x & kSelf)) break;
    k = (unsigned)x;
    if (x & kNext) {
      g += 1;
      break;
    }
    g += 2;
    if (g > n) {  // no gap passes n rows: the sentinel is a ruler
      lost = true;
      break;
    }
  }
  succ[i] = lost ? i : node_of(s, k, tiles);
  gap[i] = lost ? 0 : g;
}

__global__ void __launch_bounds__(kRankThreads)
rulers_rank_kernel(const int* __restrict__ succ_in,
                   const long long* __restrict__ dist_in,
                   int* __restrict__ succ_out,
                   long long* __restrict__ dist_out, int nodes) {
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  if (i >= nodes) return;
  const int s = succ_in[i];
  succ_out[i] = succ_in[s];
  dist_out[i] = dist_in[i] + dist_in[s];
}

__global__ void __launch_bounds__(kThreads)
rulers_write_kernel(const unsigned long long* __restrict__ pairs,
                    const unsigned* __restrict__ ends_g, long long n,
                    const unsigned* __restrict__ start_rows,
                    const long long* __restrict__ offsets, int starts,
                    int tiles, const int* __restrict__ succ,
                    const long long* __restrict__ dist,
                    const long long* __restrict__ gap,
                    uint8_t* __restrict__ out, int* __restrict__ status) {
  __shared__ unsigned ends[256];
  __shared__ Starts s;
  load_ends(ends, ends_g);
  load_starts(s, start_rows, starts);
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int sentinel = tiles + starts;
  if (i >= sentinel) return;
  const bool reached = succ[i] == sentinel;
  const long long pos = n - dist[i];
  if (i >= tiles && !(reached && pos == offsets[i - tiles]))
    atomicOr(status, 1);
  const long long g = gap[i];
  if (!reached || g <= 0 || pos < 0 || pos + g > n) return;
  unsigned k = node_row(s, i, tiles, n);
  const long long end = pos + g;
  for (long long w = pos;;) {
    const unsigned long long x = __ldg(pairs + k);
    out[w++] = (uint8_t)row_char(ends, k);
    if (w == end) break;
    out[w++] = (uint8_t)(x >> 32);
    if (w == end) break;
    k = (unsigned)x;
  }
}

}  // namespace

// u_sorted: i64 [n], the stable sort's indices; ends: u32 [256];
// start_rows: u32 [starts], sorted; pairs: u64 [n + 1].
extern "C" int rulers_table_launch(const long long* u_sorted, long long n,
                                   unsigned primary, const unsigned* ends,
                                   const unsigned* start_rows, int starts,
                                   unsigned long long* pairs, void* stream) {
  if (n < 0 || starts > kMaxStarts) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kTableThreads) / kTableThreads;
  rulers_table_kernel<<<(unsigned)blocks, kTableThreads, 0,
                        (cudaStream_t)stream>>>(u_sorted, n, primary, ends,
                                                start_rows, starts, pairs);
  return (int)cudaGetLastError();
}

// succ: i32 [nodes], gap: i64 [nodes], nodes = tiles + starts + 1, tiles
// = ceil((n + 1) / 64).
extern "C" int rulers_gaps_launch(const unsigned long long* pairs,
                                  long long n, const unsigned* start_rows,
                                  int starts, int tiles, int* succ,
                                  long long* gap, void* stream) {
  if (starts > kMaxStarts) return (int)cudaErrorInvalidValue;
  const int nodes = tiles + starts + 1;
  rulers_gaps_kernel<<<(nodes + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(pairs, n, start_rows, starts,
                                               tiles, succ, gap);
  return (int)cudaGetLastError();
}

// succ, gap: i32 and i64 [nodes], the first chase's; succ2, dist2: i32
// and i64 [2 nodes], the rounds' two halves.  *rounds is set to the
// launches made; the result is in half (*rounds - 1) & 1.
extern "C" int rulers_rank_launch(const int* succ, const long long* gap,
                                  int* succ2, long long* dist2, int nodes,
                                  int* rounds, void* stream) {
  const int blocks = (nodes + kRankThreads - 1) / kRankThreads;
  const int* s_in = succ;
  const long long* d_in = gap;
  int h = 0;
  *rounds = 0;
  for (long long span = 1; span < nodes; span <<= 1) {
    int* s_out = succ2 + (long long)h * nodes;
    long long* d_out = dist2 + (long long)h * nodes;
    rulers_rank_kernel<<<blocks, kRankThreads, 0, (cudaStream_t)stream>>>(
        s_in, d_in, s_out, d_out, nodes);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
    ++*rounds;
    s_in = s_out;
    d_in = d_out;
    h ^= 1;
  }
  return 0;
}

// offsets: i64 [starts], the start rows' output offsets; out: u8 [n];
// status: i32, zeroed here, nonzero after the launch for a non-BWT.
extern "C" int rulers_write_launch(const unsigned long long* pairs,
                                   const unsigned* ends, long long n,
                                   const unsigned* start_rows,
                                   const long long* offsets, int starts,
                                   int tiles, const int* succ,
                                   const long long* dist,
                                   const long long* gap, uint8_t* out,
                                   int* status, void* stream) {
  if (starts > kMaxStarts) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(status, 0, sizeof(int), st);
  if (rc) return rc;
  const int nodes = tiles + starts;
  rulers_write_kernel<<<(nodes + kThreads - 1) / kThreads, kThreads, 0,
                        st>>>(pairs, ends, n, start_rows, offsets, starts,
                              tiles, succ, dist, gap, out, status);
  return (int)cudaGetLastError();
}
