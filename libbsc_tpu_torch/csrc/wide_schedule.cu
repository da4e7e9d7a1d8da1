// K9 and K10, the wide coder's bit schedule: per-run move-to-front ranks
// and bit counts (K9), then the packed 2-bit (bit | active) planes (K10).
//
// Replace the XLA programs _events2_call (K9) and _expand2_call (K10) in
// the JAX package's libbsc_tpu/ops/wide_schedule.py:262 and :371.  The
// JAX package lays the runs on an [L, E] grid and computes each rank with
// no move-to-front table (one running-max pass over the grid per byte
// value, up to 256), then forward-fills one packed word per run over
// [L, IT] by scatter and cummax, because a TPU core has no cheap per-lane
// table and no gather.  Their torch ports are the plain versions
// (ops/wide_schedule.schedule_events_plain, schedule_planes_plain).  The
// serial reference is the native walker, native/wide.cc mtf_rank,
// next_run_encode and wide_schedule_packed.
//
// A lane k holds the bytes [starts[k], starts[k] + sizes[k]); its runs
// are maximal runs of one byte inside the lane (a lane start is always a
// run start) and have the global run ids frid[k] .. frid[k + 1] - 1.
// Every run is one event: a rank flag, the rank's unary exponent and
// mantissa, a run flag, the run length's exponent and mantissa,
// B = 1 + rlen + rmlen + 1 + ulen + umlen bits in all (ops/wide.py).
//
// What bounds them on the H100.  K9: the serial chain of move-to-front
// steps, one a run; a lane's runs must be ranked in order.  At 25 MiB
// the corpus has 6,874 runs a lane over 1,024 lanes, eight warps an SM,
// and a step is a shuffle and a warp reduction deep (about 700 cycles a
// run as measured, so latency and issue, not bytes).  Its bytes (the
// block read once, 12 bytes a run and 8 a lane written) take about
// 0.03 ms at 3.35 TB/s.
// K10: the bytes: 12 bytes a run read and the planes, L x IT / 4 bytes
// (16 MB at 25 MiB), written once.
//
// K9 design: one warp a lane.  The warp reads its lane 2 KiB a step
// (four 16-byte loads a thread, the next step's issued before this
// step's runs are ranked) and finds the run starts of each 512 bytes
// with one ballot, so a lane of long runs costs a load a 2 KiB, not a
// round trip a 32 bytes: a lane balanced by run count holds up to 910 KB
// of the corpus's 25 MiB block (a run of 818,738 bytes), and a first
// design that read 32 bytes a step took 11.1 ms, most of it that lane
// (this one 2.5 ms, NVIDIA H100 80GB HBM3, 700 W).  The move-to-front
// table is a last-use time per byte value, 8 values in each thread's
// registers (value c in thread c % 32, slot c / 32), initialized to
// -c - 1: that order is the identity table, and a used value gets the
// lane's run counter, newer than every other.  A run's rank is the
// number of values used more recently than its char: one compare a slot
// and one __reduce_add_sync, with no table shifted.  Each run's rank,
// length and bit count go to the lane that holds run q % 32 and leave as
// one coalesced store per 32 runs; lane 0 writes the lane's bit total.
//
// K10 design: one block a lane.  The block scans the lane's bit counts
// (exclusive, into a scratch int32 a run: each run's first bit), then
// each thread owns one 32-bit word of the row (16 fields) at a time,
// finds the run holding the word's first field by binary search, and
// walks its fields, so every word is written once, coalesced, with no
// atomics and no shared-memory row: any IT works (v2 caps it below 2^19,
// v1 does not).  Fields at or past the lane's total are 0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRankExpCap = 8;   // ops/wide.py RANK_EXP_CAP
constexpr int kRunExpCap = 25;   // ops/wide.py RUN_EXP_CAP
constexpr int kEventWarps = 4;   // K9: lanes a block
constexpr int kTileLoads = 4;    // K9: 16-byte loads a thread a step
constexpr int kPlaneThreads = 256;  // K10: threads a lane
constexpr int kPlaneWarps = kPlaneThreads / 32;

__device__ __forceinline__ int bitlen(int x) { return 32 - __clz(x); }

// B of a run with move-to-front rank `rank` and length `len`
__device__ __forceinline__ int event_bits(int rank, int len) {
  int b = 2;  // the rank flag and the run flag
  if (rank > 0) {
    const int brs = bitlen(rank);
    b += 2 * (brs - 1) + (brs < kRankExpCap);
  }
  if (len != 1) {
    const int ubrs = bitlen(len);
    b += 2 * (ubrs - 1) + (ubrs < kRunExpCap);
  }
  return b;
}

// byte i (0-15) of a 16-byte word held as four u32
__device__ __forceinline__ int byte_of(unsigned w0, unsigned w1, unsigned w2,
                                       unsigned w3, int i) {
  const unsigned w = i < 8 ? (i < 4 ? w0 : w1) : (i < 12 ? w2 : w3);
  return (w >> (8 * (i & 3))) & 0xFF;
}

__global__ void __launch_bounds__(kEventWarps * 32)
sched_events_kernel(const uint4* __restrict__ data16,
                    const long long* __restrict__ starts,
                    const long long* __restrict__ sizes,
                    const long long* __restrict__ frid, int L,
                    int* __restrict__ rank_out, int* __restrict__ len_out,
                    int* __restrict__ bits_out,
                    long long* __restrict__ total_out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kEventWarps + (threadIdx.x >> 5);
  if (k >= L) return;  // k is the same for the whole warp
  const long long lo = starts[k];
  const long long hi = lo + sizes[k];
  const long long g0 = frid[k];

  int ts[8];  // last-use time of byte value lane + 32 j
#pragma unroll
  for (int j = 0; j < 8; ++j) ts[j] = -(lane + 32 * j) - 1;
  int clock = 0;
  long long total = 0;
  long long pstart = -1;  // the open run's start and rank
  int prank = 0;
  int q = 0;  // runs closed so far
  int br = 0, bl = 0, bb = 0;  // run (q & ~31) + lane, until it is stored

  auto close_run = [&](int rank, int len) {
    const int b = event_bits(rank, len);
    total += b;
    if (lane == (q & 31)) {
      br = rank;
      bl = len;
      bb = b;
    }
    if ((q & 31) == 31) {
      const long long at = g0 + (q - 31) + lane;
      rank_out[at] = br;
      len_out[at] = bl;
      bits_out[at] = bb;
    }
    ++q;
  };

  // The lane's 16-byte words [a0, a1), 32 kTileLoads a step (thread `lane`
  // loads words at + u * 32 + lane), the next step's loads issued before
  // this step's runs are ranked.
  const long long a0 = lo >> 4;
  const long long a1 = (hi + 15) >> 4;
  uint4 cur[kTileLoads], nxt[kTileLoads];
  auto load = [&](uint4* v, long long at) {
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const long long w = at + u * 32 + lane;
      v[u] = w < a1 ? data16[w] : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (a0 < a1) load(cur, a0);
  int prev = -1;  // the byte before this 512-byte span (none at lo)
  for (long long at = a0; at < a1; at += 32 * kTileLoads) {
    if (at + 32 * kTileLoads < a1) load(nxt, at + 32 * kTileLoads);
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) {
      const long long w0 = at + u * 32;
      if (w0 >= a1) break;
      const unsigned x = cur[u].x, y = cur[u].y, z = cur[u].z, v = cur[u].w;
      const long long p0 = (w0 + lane) * 16;  // this thread's first byte
      int before = __shfl_up_sync(kFull, (int)(v >> 24), 1);
      if (lane == 0) before = prev;
      prev = __shfl_sync(kFull, (int)(v >> 24), 31);
      unsigned m = 0;  // bit i: byte p0 + i starts a run of the lane
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = byte_of(x, y, z, v, i);
        const long long p = p0 + i;
        if (p >= lo && p < hi && (p == lo || c != before)) m |= 1u << i;
        before = c;
      }
      unsigned act = __ballot_sync(kFull, m != 0);
      while (act) {
        const int t = __ffs(act) - 1;
        act &= act - 1;
        unsigned mt = __shfl_sync(kFull, m, t);
        const unsigned tx = __shfl_sync(kFull, x, t);
        const unsigned ty = __shfl_sync(kFull, y, t);
        const unsigned tz = __shfl_sync(kFull, z, t);
        const unsigned tv = __shfl_sync(kFull, v, t);
        const long long pt = (w0 + t) * 16;
        while (mt) {
          const int i = __ffs(mt) - 1;
          mt &= mt - 1;
          const int cc = byte_of(tx, ty, tz, tv, i);
          const int slot = cc >> 5;
          const int s01 = slot & 1 ? ts[1] : ts[0];
          const int s23 = slot & 1 ? ts[3] : ts[2];
          const int s45 = slot & 1 ? ts[5] : ts[4];
          const int s67 = slot & 1 ? ts[7] : ts[6];
          const int s03 = slot & 2 ? s23 : s01;
          const int s47 = slot & 2 ? s67 : s45;
          const int tc = __shfl_sync(kFull, slot & 4 ? s47 : s03, cc & 31);
          const int newer = (((ts[0] > tc) + (ts[1] > tc)) +
                             ((ts[2] > tc) + (ts[3] > tc))) +
                            (((ts[4] > tc) + (ts[5] > tc)) +
                             ((ts[6] > tc) + (ts[7] > tc)));
          const int rank = __reduce_add_sync(kFull, newer);
          if (lane == (cc & 31)) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (slot == j) ts[j] = clock;
          }
          ++clock;
          // a warp issues in order: the previous run is closed after the
          // reduction is issued, so it waits on nothing
          if (pstart >= 0) close_run(prank, (int)(pt + i - pstart));
          prank = rank;
          pstart = pt + i;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTileLoads; ++u) cur[u] = nxt[u];
  }
  if (pstart >= 0) close_run(prank, (int)(hi - pstart));
  if (lane < (q & 31)) {
    const long long at = g0 + (q & ~31) + lane;
    rank_out[at] = br;
    len_out[at] = bl;
    bits_out[at] = bb;
  }
  if (lane == 0) total_out[k] = total;
}

struct Event {
  int rank, len, start, bits;  // start: the event's first bit in the lane
  int brs, rlen, uoff, ubrs, ulen;
};

__device__ __forceinline__ Event load_event(const int* rank, const int* len,
                                            const int* bits, const int* S,
                                            long long i) {
  Event e;
  e.rank = rank[i];
  e.len = len[i];
  e.start = S[i];
  e.bits = bits[i];
  e.brs = e.rank > 0 ? bitlen(e.rank) : 0;
  e.rlen = e.rank > 0 ? e.brs - 1 + (e.brs < kRankExpCap) : 0;
  e.uoff = 1 + e.rlen + (e.rank > 0 ? e.brs - 1 : 0);
  e.ubrs = e.len != 1 ? bitlen(e.len) : 0;
  e.ulen = e.len != 1 ? e.ubrs - 1 + (e.ubrs < kRunExpCap) : 0;
  return e;
}

// bit j of the event (0 <= j < e.bits), in _expand2's order
__device__ __forceinline__ unsigned event_bit(const Event& e, int j) {
  if (j == 0) return e.rank > 0;
  if (j < 1 + e.rlen) return (j - 1) < (e.brs - 1);
  if (j < e.uoff) return (e.rank >> (e.brs - 2 - (j - 1 - e.rlen))) & 1;
  if (j == e.uoff) return e.len != 1;
  if (j < e.uoff + 1 + e.ulen) return (j - e.uoff - 1) < (e.ubrs - 1);
  return (e.len >> (e.ubrs - 2 - (j - e.uoff - 1 - e.ulen))) & 1;
}

__global__ void __launch_bounds__(kPlaneThreads)
sched_planes_kernel(const int* __restrict__ rank, const int* __restrict__ len,
                    const int* __restrict__ bits,
                    const long long* __restrict__ total,
                    const long long* __restrict__ frid, long long words,
                    int* S, unsigned* __restrict__ out) {
  __shared__ int warp_sum[kPlaneWarps];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long e0 = frid[k];
  const int ne = (int)(frid[k + 1] - e0);

  // each run's first bit: an exclusive scan of the lane's bit counts
  int carry = 0;
  for (int b0 = 0; b0 < ne; b0 += kPlaneThreads) {
    const int i = b0 + threadIdx.x;
    const int v = i < ne ? bits[e0 + i] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kPlaneWarps; ++w) {
      const int s = warp_sum[w];
      before += w < warp ? s : 0;
      all += s;
    }
    if (i < ne) S[e0 + i] = carry + before + x - v;
    carry += all;
    __syncthreads();
  }

  const long long tot = total[k];
  unsigned* row = out + (long long)k * words;
  int e = 0;  // this thread's words only move forward
  for (long long w = threadIdx.x; w < words; w += kPlaneThreads) {
    const long long it0 = 16 * w;
    unsigned word = 0;
    if (it0 < tot) {
      int a = e, z = ne - 1;  // the last run starting at or before it0
      while (a < z) {
        const int mid = (a + z + 1) >> 1;
        if (S[e0 + mid] <= it0) a = mid;
        else z = mid - 1;
      }
      e = a;
      Event ev = load_event(rank, len, bits, S, e0 + e);
      for (int f = 0; f < 16 && it0 + f < tot; ++f) {
        int j = (int)(it0 + f - ev.start);
        if (j >= ev.bits) {  // runs take at least 2 bits: one step at most
          ++e;
          ev = load_event(rank, len, bits, S, e0 + e);
          j = (int)(it0 + f - ev.start);
        }
        word |= (event_bit(ev, j) | 2u) << (2 * f);
      }
    }
    row[w] = word;
  }
}

}  // namespace

// K9.  data: u8 [n], 16-byte aligned (its last 16-byte word is read
// whole); starts, sizes: i64 [L]; frid: i64 [L + 1]; rank, len, bits:
// i32 [frid[L]]; total: i64 [L].
extern "C" int sched_events_launch(const uint8_t* data,
                                   const long long* starts,
                                   const long long* sizes,
                                   const long long* frid, int L, int* rank,
                                   int* len, int* bits, long long* total,
                                   void* stream) {
  if (L <= 0) return 0;
  const unsigned blocks = (unsigned)((L + kEventWarps - 1) / kEventWarps);
  if ((uintptr_t)data & 15) return (int)cudaErrorMisalignedAddress;
  sched_events_kernel<<<blocks, kEventWarps * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(data), starts, sizes, frid, L, rank,
      len, bits, total);
  return (int)cudaGetLastError();
}

// K10.  rank, len, bits: i32 [R]; total: i64 [L]; frid: i64 [L + 1];
// S: i32 [R] scratch; out: u32 [L, words] (u8 [L, IT / 4], words = IT / 16).
extern "C" int sched_planes_launch(const int* rank, const int* len,
                                   const int* bits, const long long* total,
                                   const long long* frid, int L,
                                   long long words, int* S, unsigned* out,
                                   void* stream) {
  if (L <= 0 || words <= 0) return 0;
  sched_planes_kernel<<<L, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      rank, len, bits, total, frid, words, S, out);
  return (int)cudaGetLastError();
}
