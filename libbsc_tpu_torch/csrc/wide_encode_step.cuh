// The forward walk shared by the wide encoder's K1 (wide_model.cu) and K5
// (wide_rc_encode.cu): shared-memory layout, plane staging, and the
// lane's state machine run ahead of its model in warps of their own.
//
// Both kernels run one block of 256 threads per group over the packed
// planes (u8 [rows, 1024], four 2-bit bit | active fields a byte, lane =
// group * 128 + lane-in-group).  Each lane's active fields are a prefix of
// the iterations (the schedule packs its bits from iteration 0), so a lane
// whose field is inactive is finished: its context is the sink row kSink,
// which no live lane reads.
//
// The encoders know every bit in advance, so a lane's contexts depend on
// its bits alone, never on the model.  Warps 0-3 (the state warps, one
// thread per lane) run the state machine: they stage the plane rows, walk
// the encoders' form of the table (wide_sm_table.cuh) and write one word
// per lane and step, ctx | bit << 9 | active << 10, into a shared ring of
// context chunks.  Warps 4-7 (the model warps, one thread per lane) read a
// chunk's words into registers, hand the chunk back, and run the model
// (and K5's coder) over them.  Each chain has its own warps, so each SM
// scheduler holds one warp of each and issues from whichever is ready: the
// two dependent chains overlap without either waiting on the other's
// latency.
//
//  - Plane rows staged ahead.  The group's 128 bytes of each plane row go
//    into a 64-row shared ring by cp.async, 16 rows a refill (16 bytes a
//    state thread).  At the start of every 16 rows the state warps wait
//    for the copies of the next 32 rows and meet at a named barrier; then
//    they refill the 16 rows that all of them have finished.  A row is
//    copied about 200 steps before it is read.
//  - The encoders' table (ops/wide_kernels.py sm_enc_table) in shared
//    memory; a step loads only its bit's 8-byte half of the position's
//    entry, so the state chain is that load, the next position and its
//    address.
//  - The context ring: kCtxChunks chunks of kSteps steps x 128 lanes of
//    u16 words.  Chunk slot k has two named barriers: kBarFull + k (the
//    state warps arrive once the chunk is written, the model warps sync
//    before reading it) and kBarEmpty + k (the model warps arrive once
//    the words are in registers, the state warps sync before writing the
//    slot again).  Neither side can arrive twice on one barrier before
//    the other side has synced on it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_sm.cuh"
#include "wide_sm_table.cuh"

namespace wide {

constexpr int kThreads = 2 * kGroup;  // state warps 0-3, model warps 4-7
constexpr int kSteps = 32;            // steps of a context chunk
constexpr int kCtxChunks = 4;         // chunks the context ring holds
constexpr int kStageRows = 16;        // plane rows one refill copies
constexpr int kRingRows = 64;         // plane rows the ring holds
constexpr int kEncModelBytes = (kNctx + 1) * kGroup * 2;  // + the sink row
constexpr int kCtxBytes = kCtxChunks * kSteps * kGroup * 2;
constexpr int kEncRingBytes = kRingRows * kGroup;
constexpr int kEncSmem =
    kEncModelBytes + kCtxBytes + kEncRingBytes + kSmPositions * 16;
// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;
constexpr int kBarEmpty = kBarFull + kCtxChunks;
constexpr int kBarStage = kBarEmpty + kCtxChunks;  // the state warps
constexpr int kBarModel = kBarStage + 1;           // the model warps
static_assert(kBarModel < 16, "16 named barriers");
static_assert(kSteps % 4 == 0, "whole plane rows a chunk");
static_assert(kStageRows * kGroup == kGroup * 16, "16 bytes a thread");
static_assert(kEncModelBytes % 16 == 0 && kCtxBytes % 16 == 0,
              "the ring and table stay aligned");
static_assert(kSink == kNctx, "the sink row follows the model");

constexpr uint32_t kWordCtx = 511;
constexpr uint32_t kWordActive = 1024;

struct EncodeSmem {
  uint16_t* model;  // [kNctx + 1][kGroup]
  uint16_t* ctx;    // [kCtxChunks][kSteps][kGroup]
  uint8_t* ring;    // [kRingRows][kGroup]
  uint4* tab;       // [kSmPositions]
};

__device__ __forceinline__ EncodeSmem encode_smem(unsigned char* smem) {
  EncodeSmem m;
  m.model = reinterpret_cast<uint16_t*>(smem);
  m.ctx = reinterpret_cast<uint16_t*>(smem + kEncModelBytes);
  m.ring = smem + kEncModelBytes + kCtxBytes;
  m.tab = reinterpret_cast<uint4*>(smem + kEncModelBytes + kCtxBytes +
                                   kEncRingBytes);
  return m;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// State thread t's 16 bytes of the refill of rows [16 c, 16 c + 16): row
// 16 c + t / 8, bytes 16 (t % 8) of the group's 128; zeros (inactive
// fields) past the last row.  One commit group per refill.
__device__ __forceinline__ void stage_rows(uint8_t* ring,
                                           const uint8_t* planes, int c,
                                           int nrows, int g, int t) {
  const int row = c * kStageRows + (t >> 3);
  uint8_t* dst = ring + (row & (kRingRows - 1)) * kGroup + (t & 7) * 16;
  if (row < nrows) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(planes + (size_t)row * kLanes + g * kGroup +
                     (t & 7) * 16)
                 : "memory");
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every thread: the table; the model warps: their lanes' model columns
// (the priors and the sink row); the state warps: refills 0, 1 and 2 in
// flight.  Ends in __syncthreads.
__device__ __forceinline__ void encode_begin(const EncodeSmem& m,
                                             const int* priors,
                                             const uint4* table,
                                             const uint8_t* planes,
                                             int nrows, int g, int tid) {
  if (tid < kGroup) {
    for (int c = 0; c < 3; ++c) stage_rows(m.ring, planes, c, nrows, g, tid);
  } else {
    uint16_t* col = m.model + (tid - kGroup);
    for (int c = 0; c < kNctx; ++c) col[c * kGroup] = priors[c];
    col[kSink * kGroup] = 2048;
  }
  for (int k = tid; k < kSmPositions; k += kThreads) m.tab[k] = table[k];
  __syncthreads();
}

// At row 16 c: rows up to 16 c + 31 have landed and are visible to the
// state warps, all of them have read the rows below 16 c, and the refill
// of rows 16 (c + 3) .. takes the ring slots of rows 16 (c - 1) ...
__device__ __forceinline__ void stage_turn(uint8_t* ring,
                                           const uint8_t* planes, int c,
                                           int nrows, int g, int t) {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  bar_sync(kBarStage, kGroup);
  stage_rows(ring, planes, c + 3, nrows, g, t);
}

// The state warps (thread t = lane in the group): every step's word, chunk
// by chunk, for the steps [0, kSteps * ceil(iters / kSteps)); a step past
// iters is inactive.  The lane walks the encoders' form of the table
// (EncLane, enc_ctx, enc_next in wide_sm_table.cuh): selects, no branch.
// The state chain is a step's table load, its next position and the next
// step's table load: that load is issued first, and the step's context and
// history updates fill its latency.  A thread keeps its shared-memory
// accesses in program order, so a plane row's four word stores come after
// its table loads, and the next row's plane byte is read before them.
__device__ __forceinline__ void encode_states(const EncodeSmem& m,
                                              const uint8_t* planes,
                                              int iters, int g, int t) {
  const int nrows = (iters + 3) >> 2;
  const int nchunks = (iters + kSteps - 1) / kSteps;
  const uint2* tab2 = reinterpret_cast<const uint2*>(m.tab);
  EncLane s = enc_lane();
  uint32_t byte = 0;  // the fields of the current row
  uint2 ab;           // the current step's half entry: (A, B) for its bit
  for (int c = 0; c < nchunks; ++c) {
    const int k = c & (kCtxChunks - 1);
    if (c >= kCtxChunks) bar_sync(kBarEmpty + k, kThreads);
    uint16_t* dst = m.ctx + k * kSteps * kGroup + t;
    for (int rr = 0; rr < kSteps / 4; ++rr) {
      const int r = c * (kSteps / 4) + rr;
      if ((r & (kStageRows - 1)) == 0) {
        stage_turn(m.ring, planes, r / kStageRows, nrows, g, t);
        if (r == 0) {
          byte = m.ring[t];
          ab = tab2[byte & 1];
        }
      }
      const uint32_t next = m.ring[((r + 1) & (kRingRows - 1)) * kGroup + t];
      const uint32_t w = byte | next << 8;
      const int left = iters - 4 * r;  // steps of this row before iters
      uint32_t word[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t f = w >> (2 * j);
        const uint32_t bit = f & 1;
        const bool active = (f & 2) != 0 && j < left;
        const uint2 nab = tab2[2 * (ab.x & 511) + ((f >> 2) & 1)];
        const uint32_t ctx = enc_ctx(s);
        word[j] = (active ? ctx : kSink) | bit << 9 |
                  (active ? kWordActive : 0);
        enc_next(s, ab, bit);
        ab = nab;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[(4 * rr + j) * kGroup] = (uint16_t)word[j];
      byte = next;
    }
    bar_arrive(kBarFull + k, kThreads);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// *p = v where pred: one predicated store, with no branch around it to
// stop the scheduler moving the next step's work above it.
__device__ __forceinline__ void store_if(int* p, int v, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.u32 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"((unsigned)pred)
      : "memory");
}

// The model warps: chunk c's words into registers, then the slot goes
// back to the state warps (unless no later chunk will take it).
__device__ __forceinline__ void take_chunk(const EncodeSmem& m, int c,
                                           int nchunks, int lane,
                                           uint32_t (&wv)[kSteps]) {
  const int k = c & (kCtxChunks - 1);
  bar_sync(kBarFull + k, kThreads);
  const uint16_t* src = m.ctx + k * kSteps * kGroup + lane;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) wv[j] = src[j * kGroup];
  if (c + kCtxChunks < nchunks) bar_arrive(kBarEmpty + k, kThreads);
}

}  // namespace wide
