// K3 and K4, the wide decoder: v3 (binary rANS lanes, K3) and v2
// (carry-less range coder, K4), one template.
//
// Replaces the Pallas kernel _build_decode_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py: rans=True (K3) and rans=False (K4).  Per
// lane and iteration the lane decodes one bit with its context's
// probability p and adapts the context:
//   v3: slot = x & 0xFFF picks the bit (slot >= p) and x contracts by the
//       bit's frequency; the lane renormalises when x falls under 2^16.
//   v2: r = (rng >> 12) * p, bit = (code - low) >= r, and the bit's side
//       of [low, low + rng) is kept; when rng falls under 2^16 the lane
//       clamps an interval that straddles a 2^16 boundary to its larger
//       side (the upper one only when strictly larger), and low and rng
//       shift up 16.
// A renormalising lane takes the group's next stream unit into x (v3) or
// code (v2): renormalising lanes consume units in lane order, so a lane's
// unit is stream[cursor + (renormalising lanes before it)].  The state
// machine turns bits into (rank, run) pairs, and each lane's pairs go
// through its move-to-front table into its span of the block.
//
// What bounds it on the H100: the serial chain of some 62,000 dependent
// steps per lane at 25 MiB (the next bit's context and state depend on
// this one), with 1024 lanes in 8 groups that share a unit stream each,
// so 8 blocks of 4 warps on 8 of 132 SMs and one warp per scheduler:
// every dependent instruction's latency is exposed.  The bytes (the
// payload in, the block out) would take about 0.01 ms at 3.35 TB/s.  In
// the single-kernel design a step took about 3,570 cycles, of which the
// model and the switch-form state machine (divergent across six phases)
// 1,640, the two barriers 600, the move-to-front loop 560, the unit load
// from device memory 440 and the byte-wise run stores 330
// (tools/decode_step_split.py).  This design's step takes about 700:
// the bit step 40-70, the table transition and record 220, the ballots
// and next context 175, the barrier 25, the unit prefix and ring read
// 140, the stop test and refill 80.  What bounds it now is one warp per
// scheduler issuing the step's mostly dependent instructions: computing
// both bits' transitions ahead of the bit, to shorten the chain, added
// more issue than it saved (about 890 cycles a step).
//
// Design: two kernels, one launch call.
//  - The chain kernel: one block of 128 threads per group, one thread per
//    lane.  The lane's model is a u16 column of [282][128] in shared
//    memory (row 281 a sink that finished lanes write).  The state machine
//    is the table of wide_sm_table.cuh in shared memory: context and next
//    state by selects, so a warp's lanes take one path.  The group's unit
//    stream (u16) streams into a 4,096-unit ring in shared memory by
//    cp.async, 1,024 units a refill, at least 1,920 units ahead of the
//    cursor; a renormalising lane reads the ring.  Each warp publishes
//    its count of renormalising lanes and whether it has a live lane into
//    a double-buffered [2][4] array, so one __syncthreads a step serves
//    both the unit prefix and the stop test; the next context's model
//    load and table load are issued before it.  A completed run is one
//    int32 record (run << 8 | rank) stored into the lane's region of a
//    record buffer, off the bit chain.
//  - The expand kernel: one warp per lane.  The warp holds the lane's
//    256-entry move-to-front table, 8 entries a thread; a record's symbol
//    is one shuffle, its move to the front one __shfl_up_sync and a byte
//    mask, and its run is written by the warp, 16-byte stores where it is
//    long.
// The two coders differ only in the bit step; all u32 wrap-around is
// native.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"
#include "wide_sm_table.cuh"

using namespace wide;

namespace {

constexpr int kRing = 4096;   // units of a group's ring
constexpr int kChunk = 1024;  // units one refill copies, 16 B a thread
constexpr int kAhead = 2048;  // refill when fewer units are ahead
constexpr int kModelBytes = (kNctx + 1) * kGroup * 2;  // + the sink row
constexpr int kRingBytes = kRing * 2;
constexpr int kSmem = kModelBytes + kRingBytes + kSmPositions * 16;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kChunk == kGroup * 8, "one 16-byte copy per thread");
static_assert(kModelBytes % 16 == 0, "the ring and table stay aligned");
static_assert(kSink == kNctx, "the sink row follows the model");

// Thread tid's 16 bytes of the refill of units [from, from + kChunk):
// an asynchronous copy, or zeros past the stream's end (srow is a
// multiple of kChunk).  One commit group per refill.
__device__ __forceinline__ void ring_fill(uint16_t* ring, const uint16_t* gs,
                                          int from, int srow, int tid) {
  uint16_t* dst = ring + (from & (kRing - 1)) + tid * 8;
  if (from < srow) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gs + from + tid * 8)
                 : "memory");
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kRans>
__global__ void __launch_bounds__(kGroup)
wide_chain_kernel(const uint32_t* __restrict__ warm,
                  const int* __restrict__ goff,
                  const int* __restrict__ lane_sz,
                  const int* __restrict__ lstart,
                  const uint16_t* __restrict__ stream, int srow, int iters,
                  const int* __restrict__ priors,
                  const uint4* __restrict__ table, int* __restrict__ rec,
                  int* __restrict__ nrec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* model = reinterpret_cast<uint16_t*>(smem);  // [kNctx+1][kGroup]
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kModelBytes);
  uint4* tab = reinterpret_cast<uint4*>(smem + kModelBytes + kRingBytes);
  // per step and warp: renormalising lanes | 256 when a lane is live
  __shared__ int4 info[2];

  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int lane = g * kGroup + tid;
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  for (int c = 0; c < kNctx; ++c) model[c * kGroup + tid] = priors[c];
  model[kSink * kGroup + tid] = 2048;
  for (int k = tid; k < kSmPositions; k += kGroup) tab[k] = table[k];
  const uint16_t* gs = stream + (size_t)g * srow;
  int cursor = goff[lane];  // same value in every thread of the group
  int filled = 0;           // units [0, filled) are in or on their way
  for (; filled < kRing - kChunk; filled += kChunk)
    ring_fill(ring, gs, filled, srow, tid);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  int left = lane_sz[lane];
  TableLane s = table_lane(left > 0);
  uint32_t x = warm[lane];  // v3: the rANS state; v2: the code word
  uint32_t low = 0, rng = 0xFFFFFFFFu;  // v2 only
  int* out = rec + lstart[lane];
  int n_out = 0;
  int ctx = table_ctx(s);
  uint32_t p = model[ctx * kGroup + tid];
  uint4 e = tab[s.pos];

  for (int i = 0; i < iters; ++i) {
    const bool active = s.pos != kSmDone;
    int bit;
    bool ren;
    if (kRans) {
      const uint32_t slot = x & 0xFFFu;
      const uint32_t hi = x >> 12;
      bit = active && slot >= p;
      const uint32_t nx = bit ? (4096u - p) * hi + slot - p : p * hi + slot;
      x = active ? nx : x;
      ren = active && x < (1u << 16);
    } else {
      const uint32_t r = (rng >> 12) * p;
      bit = active && x - low >= r;
      uint32_t nlow = bit ? low + r : low;
      uint32_t nrng = bit ? rng - r : r;
      ren = active && nrng < (1u << 16);
      const uint32_t lo_part = 0x10000u - (nlow & 0xFFFFu);
      const uint32_t hi_part = nrng - lo_part;
      const bool clamp = ren && ((nlow ^ (nlow + nrng - 1u)) >> 16) != 0;
      const bool take_hi = clamp && hi_part > lo_part;
      nlow = take_hi ? nlow + lo_part : nlow;
      nrng = clamp ? (take_hi ? hi_part : lo_part) : nrng;
      low = ren ? nlow << 16 : (active ? nlow : low);
      rng = ren ? nrng << 16 : (active ? nrng : rng);
    }
    model[ctx * kGroup + tid] = (uint16_t)adapt(p, bit);

    int run = table_next(s, e, bit);  // a finished lane stays finished
    if (run) {
      run = min(run, left);
      out[n_out++] = (run << 8) | s.rank;
      left -= run;
      if (left <= 0) s = table_lane(false);
    }
    const unsigned mask = __ballot_sync(kFull, ren);
    const unsigned live = __ballot_sync(kFull, s.pos != kSmDone);
    if ((tid & 31) == 0)
      reinterpret_cast<int*>(&info[i & 1])[warp] =
          __popc(mask) | (live ? 256 : 0);
    ctx = table_ctx(s);
    p = model[ctx * kGroup + tid];
    e = tab[s.pos];
    __syncthreads();

    const int4 v = info[i & 1];
    const int c0 = v.x & 255, c1 = v.y & 255, c2 = v.z & 255, c3 = v.w & 255;
    const int before =
        (warp > 0 ? c0 : 0) + (warp > 1 ? c1 : 0) + (warp > 2 ? c2 : 0);
    if (ren)
      x = (x << 16) |
          ring[(cursor + before + __popc(mask & below)) & (kRing - 1)];
    cursor += c0 + c1 + c2 + c3;
    if (!((v.x | v.y | v.z | v.w) & 256)) break;
    if (filled - cursor < kAhead) {
      // the slot it overwrites is consumed, and the wait leaves only this
      // refill in flight: the units the next step reads landed before
      // the next barrier
      ring_fill(ring, gs, filled, srow, tid);
      filled += kChunk;
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  nrec[lane] = n_out;
}

// The warp writes len bytes of sym at p: byte stores for a short run,
// 16-byte stores for the aligned body of a long one.
__device__ __forceinline__ void fill_run(uint8_t* p, int len, uint32_t sym,
                                         int t) {
  if (len <= 32) {
    if (t < len) p[t] = (uint8_t)sym;
    return;
  }
  const int head = (int)((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u);
  if (t < head) p[t] = (uint8_t)sym;
  p += head;
  len -= head;
  const uint32_t w = sym * 0x01010101u;
  const uint4 v = make_uint4(w, w, w, w);
  const int body = len & ~15;
  for (int j = t * 16; j < body; j += 32 * 16)
    *reinterpret_cast<uint4*>(p + j) = v;
  if (t < len - body) p[body + t] = (uint8_t)sym;
}

__global__ void __launch_bounds__(128)
wide_expand_kernel(const int* __restrict__ rec, const int* __restrict__ nrec,
                   const int* __restrict__ lstart, uint8_t* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int cnt = nrec[lane];
  const int* r = rec + lstart[lane];
  uint8_t* dst = out + lstart[lane];
  // entries 8t .. 8t+7 of the lane's move-to-front table, byte j = 8t + j
  uint64_t m = 0x0706050403020100ull + 0x0808080808080808ull * (uint64_t)t;
  int pos = 0;
  for (int b = 0; b < cnt; b += 32) {
    const int mine = b + t < cnt ? r[b + t] : 0;
    const int n = min(32, cnt - b);
    for (int k = 0; k < n; ++k) {
      const uint32_t rc = (uint32_t)__shfl_sync(kFull, mine, k);
      const int rank = rc & 255;
      const int run = (int)(rc >> 8);
      const uint32_t word = (rank & 4) ? (uint32_t)(m >> 32) : (uint32_t)m;
      const uint32_t sym =
          (__shfl_sync(kFull, word, rank >> 3) >> ((rank & 3) * 8)) & 255u;
      // entries 1..rank take their predecessor, entry 0 the symbol
      uint32_t carry = __shfl_up_sync(kFull, (uint32_t)(m >> 56), 1);
      carry = t == 0 ? sym : carry;
      const uint64_t shifted = (m << 8) | carry;
      const int lim = rank - 8 * t;  // bytes j <= lim move
      const uint64_t keep =
          lim >= 7 ? 0ull : (lim < 0 ? ~0ull : ~0ull << (8 * (lim + 1)));
      m = (shifted & ~keep) | (m & keep);
      fill_run(dst + pos, run, sym, t);
      pos += run;
    }
  }
}

template <bool kRans>
int launch(const uint32_t* warm, const int* goff, const int* lane_sz,
           const int* lstart, const uint16_t* stream, int srow, int iters,
           const int* priors, const int* table, int* rec, int* nrec,
           uint8_t* out, void* stream_handle) {
  const cudaStream_t st = (cudaStream_t)stream_handle;
  cudaError_t err = cudaFuncSetAttribute(
      wide_chain_kernel<kRans>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  wide_chain_kernel<kRans><<<kGroups, kGroup, kSmem, st>>>(
      warm, goff, lane_sz, lstart, stream, srow, iters, priors,
      reinterpret_cast<const uint4*>(table), rec, nrec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_expand_kernel<<<kLanes / 4, 128, 0, st>>>(rec, nrec, lstart, out);
  return (int)cudaGetLastError();
}

}  // namespace

// warm: u32 [1024] initial states (v3) or code words (v2); goff: i32
// [1024] first unit after the warm-up pairs (per group); lane_sz, lstart:
// i32 [1024] lane sizes and absolute byte starts; stream: u16 [8, srow]
// unit segments, srow a multiple of 1024; priors: i32 [281]; table: i32
// [363, 4] (ops/wide_kernels.py sm_table); rec: i32 [sum(lane_sz)]
// records, nrec: i32 [1024] their counts (scratch); out: u8
// [sum(lane_sz)].
extern "C" int wide_decode_launch(const uint32_t* warm, const int* goff,
                                  const int* lane_sz, const int* lstart,
                                  const uint16_t* stream, int srow, int iters,
                                  const int* priors, const int* table,
                                  int* rec, int* nrec, uint8_t* out,
                                  void* stream_handle) {
  return launch<true>(warm, goff, lane_sz, lstart, stream, srow, iters,
                      priors, table, rec, nrec, out, stream_handle);
}

extern "C" int wide_decode_v2_launch(const uint32_t* warm, const int* goff,
                                     const int* lane_sz, const int* lstart,
                                     const uint16_t* stream, int srow,
                                     int iters, const int* priors,
                                     const int* table, int* rec, int* nrec,
                                     uint8_t* out, void* stream_handle) {
  return launch<false>(warm, goff, lane_sz, lstart, stream, srow, iters,
                       priors, table, rec, nrec, out, stream_handle);
}
