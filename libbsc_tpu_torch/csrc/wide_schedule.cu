// K9 and K10, the wide coder's bit schedule: per-run move-to-front ranks,
// lengths, bit counts and first bits (K9), then the packed 2-bit
// (bit | active) planes (K10).
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
// run start) and have the global run ids frid[k] .. frid[k + 1] - 1; run
// g starts at rs[g] (ops/wide_schedule.lane_runs finds them).  Every run
// is one event: a rank flag, the rank's unary exponent and mantissa, a
// run flag, the run length's exponent and mantissa, B = 1 + rlen + rmlen
// + 1 + ulen + umlen bits in all (ops/wide.py), at most 76.  Its first
// bit S is the sum of the B of the lane's runs before it.
//
// What bounds them on the H100.  K9: the move-to-front chain: a lane's
// runs must be ranked in order, and 1,024 lanes give a warp each, eight
// warps an SM (6,874 runs a lane at 25 MiB), so every cycle of a warp
// step's latency shows.  Its bytes (the block read once, 16 bytes a run
// and 8 a lane written) take about 0.04 ms at 3.35 TB/s.
// K10: the bytes: 12 bytes a run read and the planes, L x IT / 4 bytes
// (16 MB at 25 MiB), written once.
//
// K9 design: one warp a lane, 32 runs a warp step.  Thread j holds run j
// of the batch: its start (rs, loaded two batches ahead), its char (one
// batch ahead) and its length (the next run's start), so the warp reads
// no byte of a run but its first, and a lane of one long run costs what
// any other lane of as many runs costs.  The move-to-front table is a
// position table pos[256] and its inverse order[256] in shared memory,
// one pair a warp, the identity at the lane's start.  With W_j the
// distinct chars of the batch's runs before j:
//   - c_j in W_j: its rank is the number of chars used since its last use
//     in the batch: the runs after that use whose char is not used again
//     before j (each run's previous and next use of its own char from
//     __match_any_sync; "next use >= j" for every run at once from six
//     ballots of the next uses' bits);
//   - else: rank = |W_j| + pos[c_j] - #{v in W_j : pos[v] < pos[c_j]},
//     the count from eight ballots of the positions' bits over the
//     batch's first uses.
// Then the table takes the whole batch: its distinct chars to the front,
// the last used first, the rest shifted down in order.  Thread j owns the
// entries of order at ranks 8j .. 8j + 7: the ballots of the batch's
// chars' positions, compared with 8j bit by bit, give the ranks the batch
// takes there and below, and so each kept entry's new rank.  Each run's
// bits and their prefix over the lane (its first bit S, which K10 reads;
// the batch's part from seven ballots of the bit counts' bits) leave as
// coalesced stores, 32 runs a store; lane 0 writes the lane's bit total.
// No step of a batch waits on a chain of shuffles or reductions: 0.20 ms
// at 25 MiB, 58 cycles a run, the lane of 910 KB alone 0.15 ms (NVIDIA
// H100 80GB HBM3, 700 W; tools/schedule_step_split.py).  The serial
// design (up to commit 4f7f1b7) read its lane 2 KiB a step and ranked a
// run at a time against last-use times in registers: 2.47 ms, 713 cycles
// a run, of which the rank's shuffle and reduction 363 and the run's
// close 176 (clock64() counters), the lane of 910 KB alone 2.18 ms.
//
// K10 design: one block a lane, the lane's runs in tiles of kTile.  The
// block stages a tile's runs in shared memory, 16 bytes each: its bit
// pattern (up to 76 bits, LSB first, built once a run from its rank part
// and its run part), its bit count and its first bit S (from K9).  The
// thread that stages a run also marks it as the first run of every word
// (16 fields) whose first field it holds, so a thread finds its word's
// first run with one shared load and no search.  It takes the word's 16
// bits from that run and the next ones (at most 8 more: a run takes at
// least 2 bits) by shifts and masks, spreads them to the fields' low
// bits, sets their active bits and writes the word once, coalesced, with
// no atomics.  A word belongs to the tile of its first run, so a tile
// stages kHalo runs past its end; a thread starts all its loads of a
// tile before it uses any.  Any IT below 2^31 works; fields at or past
// the lane's total are 0.  0.081 ms at 25 MiB; the first design scanned
// the bit counts itself and found each word's first run by a binary
// search in device memory (0.29 ms).
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
constexpr int kPlaneThreads = 256;  // K10: threads a lane
constexpr int kTile = 512;          // K10: runs a tile
constexpr int kHalo = 8;            // K10: runs past a tile a word reaches
constexpr int kMaxBits = 76;        // the longest event
constexpr int kTileWords = kTile * kMaxBits / 16 + 1;  // words a tile owns
constexpr int kStage = (kTile + kHalo + kPlaneThreads - 1) / kPlaneThreads;

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

__global__ void __launch_bounds__(kEventWarps * 32)
sched_events_kernel(const uint8_t* __restrict__ data,
                    const long long* __restrict__ rs,
                    const long long* __restrict__ starts,
                    const long long* __restrict__ sizes,
                    const long long* __restrict__ frid, int L,
                    int* __restrict__ rank_out, int* __restrict__ len_out,
                    int* __restrict__ bits_out, int* __restrict__ S_out,
                    long long* __restrict__ total_out) {
  __shared__ __align__(8) uint8_t s_pos[kEventWarps][256];
  __shared__ __align__(8) uint8_t s_order[kEventWarps][256];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kEventWarps + (threadIdx.x >> 5);
  if (k >= L) return;  // k is the same for the whole warp
  uint8_t* pos = s_pos[threadIdx.x >> 5];      // char -> rank
  uint8_t* order = s_order[threadIdx.x >> 5];  // rank -> char
  {  // the identity, at ranks and chars 8 lane .. 8 lane + 7
    const unsigned b = 8u * lane * 0x01010101u;
    const uint2 id = make_uint2(b + 0x03020100u, b + 0x07060504u);
    reinterpret_cast<uint2*>(pos)[lane] = id;
    reinterpret_cast<uint2*>(order)[lane] = id;
  }
  __syncwarp();
  const long long g0 = frid[k];
  const int nr = (int)(frid[k + 1] - g0);
  const long long end = starts[k] + sizes[k];
  const unsigned below = (1u << lane) - 1;  // the threads before this one
  // run i's start; the lane's end past its last run
  auto start_of = [&](int i) { return i < nr ? rs[g0 + i] : end; };
  long long p = start_of(lane);
  long long pn = start_of(32 + lane);
  int c = lane < nr ? data[p] : 256 + lane;  // past the lane: a char alone
  long long carry = 0;  // the lane's bits so far
  for (int b0 = 0; b0 < nr; b0 += 32) {
    // the next batch's chars and the one after's starts, in flight
    const long long pnn = start_of(b0 + 64 + lane);
    const int cn = b0 + 32 + lane < nr ? data[pn] : 256 + lane;
    long long pe = __shfl_down_sync(kFull, p, 1);
    const long long pn0 = __shfl_sync(kFull, pn, 0);
    if (lane == 31) pe = pn0;
    const bool valid = b0 + lane < nr;
    const int len = (int)(pe - p);

    // W: the distinct chars of the batch's runs before this one
    const unsigned same = __match_any_sync(kFull, c);
    const unsigned prev = same & below, next = same & ~((2u << lane) - 1);
    const int last = prev ? 31 - __clz(prev) : -1;  // c's last use in W
    const int nxt = next ? __ffs(next) - 1 : 32;    // and its next use
    // the last use of each char of W: the runs before this one whose
    // char is not used again before it (next use >= lane, compared bit by
    // bit over the ballots of the next uses)
    unsigned gt = 0, eq = kFull;
#pragma unroll
    for (int bt = 5; bt >= 0; --bt) {
      const unsigned ones = __ballot_sync(kFull, (nxt >> bt) & 1);
      if ((lane >> bt) & 1) {
        eq &= ones;
      } else {
        gt |= eq & ones;
        eq &= ~ones;
      }
    }
    const unsigned fresh = below & (gt | eq);
    const int pc = valid ? pos[c] : 0;
    // W's chars by their first use, and how many stand before c
    unsigned cand = __ballot_sync(kFull, valid && last < 0) & below;
    int less = 0;
    unsigned pcb[8];  // ballots of the positions' bits
#pragma unroll
    for (int bt = 7; bt >= 0; --bt) {
      const bool one = (pc >> bt) & 1;
      pcb[bt] = __ballot_sync(kFull, one);
      if (one) less += __popc(cand & ~pcb[bt]);
      cand &= one ? pcb[bt] : ~pcb[bt];
    }
    const int rank = last >= 0
        ? __popc(fresh & ~((2u << last) - 1))
        : __popc(fresh) + pc - less;

    // the table takes the batch: its chars to the front, the last used
    // first, the other entries down in order
    const unsigned lasts = __ballot_sync(kFull, valid && nxt == 32);
    const bool is_last = (lasts >> lane) & 1;
    // the ranks it takes are its chars' positions: those below 8 lane,
    // and those among 8 lane .. 8 lane + 7, compared bit by bit over the
    // ballots of the positions' bits (8 lane has no low bits)
    unsigned lt = 0, hit = lasts;
#pragma unroll
    for (int bt = 7; bt >= 3; --bt) {
      if ((lane >> (bt - 3)) & 1) {
        lt |= hit & ~pcb[bt];
        hit &= pcb[bt];
      } else {
        hit &= ~pcb[bt];
      }
    }
    unsigned gone = 0;  // bit i: the batch takes rank 8 lane + i
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned low = (i & 4 ? pcb[2] : ~pcb[2]) &
                           (i & 2 ? pcb[1] : ~pcb[1]) &
                           (i & 1 ? pcb[0] : ~pcb[0]);
      gone |= (unsigned)((hit & low) != 0) << i;
    }
    const unsigned kept = ~gone & 0xFFu;
    int to = __popc(lasts) + 8 * lane - __popc(lt);  // its first kept rank
    const uint2 mine = reinterpret_cast<const uint2*>(order)[lane];
    __syncwarp();  // every read of the table is done
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if ((kept >> i) & 1) {
        const int v = ((i < 4 ? mine.x : mine.y) >> (8 * (i & 3))) & 0xFF;
        order[to] = (uint8_t)v;
        pos[v] = (uint8_t)to;
        ++to;
      }
    }
    if (is_last) {
      const int r = __popc(lasts & ~((2u << lane) - 1));
      order[r] = (uint8_t)c;
      pos[c] = (uint8_t)r;
    }
    __syncwarp();  // the table holds the batch

    const int bits = valid ? event_bits(rank, len) : 0;  // below 128
    int upto = 0, all = 0;  // the batch's bits before this run, and all
#pragma unroll
    for (int bt = 0; bt < 7; ++bt) {
      const unsigned ones = __ballot_sync(kFull, (bits >> bt) & 1);
      upto += __popc(ones & below) << bt;
      all += __popc(ones) << bt;
    }
    if (valid) {
      const long long at = g0 + b0 + lane;
      rank_out[at] = rank;
      len_out[at] = len;
      bits_out[at] = bits;
      S_out[at] = (int)(carry + upto);
    }
    carry += all;
    p = pn;
    pn = pnn;
    c = cn;
  }
  if (lane == 0) total_out[k] = carry;
}

// the nb (>= 1) low bits of x, last bit first
__device__ __forceinline__ unsigned reversed(unsigned x, int nb) {
  return __brev(x) >> (32 - nb);
}

// A run as K10 stages it: its pattern, bit j = the event's bit j in
// _expand2's order (x, y: bits 0-63; z: bits 64-75 and B << 24), and its
// first bit S (w).  The rank part (flag, exponent, mantissa last bit
// first) takes at most 15 bits, the run part at most 61.
__device__ __forceinline__ uint4 stage_run(int rank, int len, int start) {
  unsigned rp = rank > 0;
  int rl = 1;
  if (rank > 0) {
    const int brs = bitlen(rank);
    const int rlen = brs - 1 + (brs < kRankExpCap);
    rp |= ((1u << (brs - 1)) - 1) << 1;
    if (brs > 1) rp |= reversed(rank, brs - 1) << (1 + rlen);
    rl += rlen + brs - 1;
  }
  unsigned long long up = len != 1;
  int ul = 1;
  if (len != 1) {
    const int ubrs = bitlen(len);
    const int ulen = ubrs - 1 + (ubrs < kRunExpCap);
    up |= (unsigned long long)((1u << (ubrs - 1)) - 1) << 1;
    if (ubrs > 1)
      up |= (unsigned long long)reversed(len, ubrs - 1) << (1 + ulen);
    ul += ulen + ubrs - 1;
  }
  const unsigned long long lo = rp | (up << rl);
  const unsigned hi = (unsigned)(up >> (64 - rl));  // 1 <= rl <= 15
  return make_uint4((unsigned)lo, (unsigned)(lo >> 32),
                    hi | ((unsigned)(rl + ul) << 24), (unsigned)start);
}

// 16 bits (and more) of a staged run's pattern from bit j (< B)
__device__ __forceinline__ unsigned pattern_bits(uint4 r, int j) {
  const unsigned hi = r.z & 0xFFFFFFu;
  if (j >= 64) return hi >> (j - 64);
  const unsigned long long lo = ((unsigned long long)r.y << 32) | r.x;
  unsigned long long v = lo >> j;
  if (j > 48) v |= (unsigned long long)hi << (64 - j);
  return (unsigned)v;
}

// bit f of x to bit 2f
__device__ __forceinline__ unsigned spread(unsigned x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

__global__ void __launch_bounds__(kPlaneThreads)
sched_planes_kernel(const int* __restrict__ rank, const int* __restrict__ len,
                    const int* __restrict__ S,
                    const long long* __restrict__ total,
                    const long long* __restrict__ frid, long long words,
                    unsigned* __restrict__ out) {
  __shared__ uint4 s_run[kTile + kHalo];
  __shared__ unsigned short s_first[kTileWords];  // word -> its first run
  const int k = blockIdx.x;
  const long long e0 = frid[k];
  const int ne = (int)(frid[k + 1] - e0);
  const long long tot = total[k];
  unsigned* row = out + (long long)k * words;
  for (int a = 0; a < ne; a += kTile) {
    const int nt = min(kTile, ne - a);          // the tile's own runs
    const int ns = min(kTile + kHalo, ne - a);  // and the halo
    // the words whose first field lies in the tile's own runs
    const long long w_lo = ((long long)S[e0 + a] + 15) >> 4;
    const long long w_hi =
        min(words, ((a + nt < ne ? S[e0 + a + nt] : tot) + 15) >> 4);
    int rk[kStage], ln[kStage], st[kStage];
#pragma unroll
    for (int m = 0; m < kStage; ++m) {  // the tile's loads, all in flight
      const int i = threadIdx.x + m * kPlaneThreads;
      if (i < ns) {
        const long long g = e0 + a + i;
        rk[m] = rank[g];
        ln[m] = len[g];
        st[m] = S[g];
      }
    }
#pragma unroll
    for (int m = 0; m < kStage; ++m) {
      const int i = threadIdx.x + m * kPlaneThreads;
      if (i >= ns) break;
      const uint4 r = stage_run(rk[m], ln[m], st[m]);
      s_run[i] = r;
      if (i < nt) {  // mark the words whose first field it holds
        const long long end = (long long)st[m] + (r.z >> 24);
        for (long long w = ((long long)st[m] + 15) >> 4;
             w < w_hi && 16 * w < end; ++w)
          s_first[w - w_lo] = (unsigned short)i;
      }
    }
    __syncthreads();
    for (long long w = w_lo + threadIdx.x; w < w_hi; w += kPlaneThreads) {
      const long long it0 = 16 * w;
      const int nf = (int)min(16LL, tot - it0);  // the word's live fields
      int i = s_first[w - w_lo];
      uint4 r = s_run[i];
      int j = (int)(it0 - (int)r.w);  // the word's first bit in run i
      unsigned x = 0;
      for (int f = 0;;) {
        const int take = min((int)(r.z >> 24) - j, nf - f);
        x |= (pattern_bits(r, j) & ((1u << take) - 1)) << f;
        f += take;
        if (f >= nf) break;
        r = s_run[++i];
        j = 0;
      }
      const unsigned active =
          nf == 16 ? 0xAAAAAAAAu : 0xAAAAAAAAu & ((1u << (2 * nf)) - 1);
      row[w] = spread(x) | active;
    }
    __syncthreads();
  }
  // the words at or past the lane's total
  for (long long w = ((tot + 15) >> 4) + threadIdx.x; w < words;
       w += kPlaneThreads)
    row[w] = 0;
}

}  // namespace

// K9.  data: u8 [n]; rs: i64 [R], the block's run starts in order (a
// lane start is one); starts, sizes: i64 [L]; frid: i64 [L + 1]; rank,
// len, bits, S: i32 [R]; total: i64 [L].
extern "C" int sched_events_launch(const uint8_t* data, const long long* rs,
                                   const long long* starts,
                                   const long long* sizes,
                                   const long long* frid, int L, int* rank,
                                   int* len, int* bits, int* S,
                                   long long* total, void* stream) {
  if (L <= 0) return 0;
  const unsigned blocks = (unsigned)((L + kEventWarps - 1) / kEventWarps);
  sched_events_kernel<<<blocks, kEventWarps * 32, 0, (cudaStream_t)stream>>>(
      data, rs, starts, sizes, frid, L, rank, len, bits, S, total);
  return (int)cudaGetLastError();
}

// K10.  rank, len, S: i32 [R]; total: i64 [L]; frid: i64 [L + 1]; out:
// u32 [L, words] (u8 [L, IT / 4], words = IT / 16).
extern "C" int sched_planes_launch(const int* rank, const int* len,
                                   const int* S, const long long* total,
                                   const long long* frid, int L,
                                   long long words, unsigned* out,
                                   void* stream) {
  if (L <= 0 || words <= 0) return 0;
  sched_planes_kernel<<<L, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      rank, len, S, total, frid, words, out);
  return (int)cudaGetLastError();
}
