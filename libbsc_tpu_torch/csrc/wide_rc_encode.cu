// K5, the wide coder's v2 encode (carry-less range coder, one pass).
//
// Replaces the Pallas kernel _build_kernel in the JAX package's
// libbsc_tpu/ops/wide_kernels.py.  For every lane and iteration it runs the
// lane's state machine over the scheduled bits, looks up and adapts the
// context's 12-bit probability, and takes one forward range-coder step:
// r = (rng >> 12) * p; a one bit keeps [low + r, rng - r), a zero [low, r).
// When rng falls under 2^16 the lane renormalises: an interval that
// straddles a 2^16 boundary is clamped to its larger side (the upper one
// only when strictly larger), the lane emits low >> 16, and low and rng
// shift up 16.  After the last bit every live lane flushes low's two
// halves.
//
// The v2 format delays each lane's units by two (ops/wide.py of the JAX
// package; the JAX kernel tags units with their lane and a host pass,
// _assemble, reorders them).  A group's stream is: two warm-up units per
// live lane, in lane order; then, for each renormalisation event e in
// (iteration, lane) order, unit r_e + 2 of that lane, where r_e counts the
// lane's earlier events and a lane's units are its emissions followed by
// its two flush units.  The decoder renormalises exactly where the encoder
// did, so a lane's r-th emission belongs in the slot of its event r - 2
// (or warm-up slot r when r < 2).  This kernel writes it there directly:
// each lane keeps the slots of its last two events in registers, and the
// group's buffer head is the finished stream, so the payload is a plain
// concatenation.
//
// What bounds it on the H100: each lane's serial chain of iters dependent
// steps (some 62,000 for a 25 MiB block), 1024 chains on 8 of 132 SMs, and
// the group-wide prefix that places the units.  The bytes (planes in,
// units out) would take about 0.007 ms at 3.35 TB/s.  The switch-form
// design took about 2,040 cycles a step (tools/encode_step_split.py):
// divergent phases, the renormalise and clamp branches, a device-memory
// plane load every fourth step, and a barrier a step that waited for the
// slowest warp of that divergent work.  This design takes about 230: the
// model warps' model, coder and slot work.
//
// Design (wide_encode_step.cuh): one block of 256 threads per group; the
// state warps walk the table ahead of the model warps, one chunk of 32
// steps at a time.  A model thread keeps its lane's model (a u16 column of
// [282][128] in shared memory, row 281 the sink of finished lanes) and
// coder state; the coder step, the renormalisation and the clamp are
// selects, as in K4's bit step (wide_decode.cu), so no work diverges.  An
// event's slot is the group's cursor plus the events of the lower warps at
// that step (their __ballot_sync counts) plus __popc of the lower lanes of
// the ballot: each warp stores its counts, one byte a step, and one named
// barrier a chunk (not a step) publishes them; a slot pass then places the
// chunk's units in step order with predicated stores.  The two slots of a
// lane's last two events stay in registers (slot_a, slot_b).  121
// registers, 118,960 B of dynamic and 272 B of static shared memory
// (ptxas -v; chip_smoke.py phase 1 prints it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (libbsc_tpu_torch/ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "wide_encode_step.cuh"

using namespace wide;

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// exclusive prefix of the four warp counts in v, and their total
__device__ __forceinline__ void group_prefix(int4 v, int warp, int& before,
                                             int& total) {
  before = (warp > 0 ? v.x : 0) + (warp > 1 ? v.y : 0) + (warp > 2 ? v.z : 0);
  total = v.x + v.y + v.z + v.w;
}

__global__ void __launch_bounds__(kThreads)
wide_rc_encode_kernel(const uint8_t* __restrict__ planes, int iters, int cap,
                      const int* __restrict__ priors,
                      const uint4* __restrict__ table,
                      int* __restrict__ units, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  // per chunk parity and step, the renormalising lanes of each model warp
  // (byte w: warp w); and the live lanes of each model warp
  __shared__ __align__(16) uint32_t cnt[2][kSteps];
  __shared__ int4 live_cnt;
  const EncodeSmem m = encode_smem(smem);
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  encode_begin(m, priors, table, planes, (iters + 3) >> 2, g, tid);
  if (tid < kGroup) {
    encode_states(m, planes, iters, g, tid);
    return;
  }
  const int lane = tid - kGroup;
  const int warp = lane >> 5;
  const unsigned below = (1u << (lane & 31)) - 1u;
  const int nchunks = (iters + kSteps - 1) / kSteps;
  int* gu = units + (size_t)g * cap;
  uint16_t* col = m.model + lane;

  bool live = false;  // no field of a dead lane is active
  int warm = 0, cursor = 0;  // cursor: next event slot, same in every lane
  uint32_t low = 0, rng = 0xFFFFFFFFu;
  int emitted = 0;             // units this lane has written
  int slot_a = 0, slot_b = 0;  // slots of its events emitted - 2, - 1
  for (int c = 0; c < nchunks; ++c) {
    uint32_t wv[kSteps];
    take_chunk(m, c, nchunks, lane, wv);
    if (c == 0) {
      live = (wv[0] & kWordActive) != 0;
      const unsigned lmask = __ballot_sync(kFull, live);
      if ((lane & 31) == 0)
        reinterpret_cast<int*>(&live_cnt)[warp] = __popc(lmask);
      bar_sync(kBarModel, kGroup);
      int live_before, n_live;
      group_prefix(live_cnt, warp, live_before, n_live);
      warm = 2 * (live_before + __popc(lmask & below));
      cursor = 2 * n_live;
    }
    uint8_t* cc = reinterpret_cast<uint8_t*>(cnt[c & 1]);
    uint32_t ur[kSteps];  // the unit, | its rank among the warp's events
    uint32_t rens = 0;    // bit j: this lane renormalised at step j
    // p of the next step is loaded before this step's store and taken
    // from the store instead when both steps share the context.  Steps
    // past iters are inactive words: they adapt the sink row only.
    uint32_t p = col[(wv[0] & kWordCtx) * kGroup];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int ctx = wv[j] & kWordCtx;
      const int bit = (wv[j] >> 9) & 1;
      const bool active = (wv[j] & kWordActive) != 0;

      const uint32_t rr = (rng >> 12) * p;
      uint32_t nlow = bit ? low + rr : low;
      uint32_t nrng = bit ? rng - rr : rr;
      const bool ren = active && nrng < (1u << 16);
      const uint32_t lo_part = 0x10000u - (nlow & 0xFFFFu);
      const uint32_t hi_part = nrng - lo_part;
      const bool clamp = ren && ((nlow ^ (nlow + nrng - 1u)) >> 16) != 0;
      const bool take_hi = clamp && hi_part > lo_part;
      nlow = take_hi ? nlow + lo_part : nlow;
      nrng = clamp ? (take_hi ? hi_part : lo_part) : nrng;
      const uint32_t unit = nlow >> 16;
      low = ren ? nlow << 16 : (active ? nlow : low);
      rng = ren ? nrng << 16 : (active ? nrng : rng);

      const uint32_t np = adapt(p, bit);
      if (j + 1 < kSteps) {
        const int nctx = wv[j + 1] & kWordCtx;
        const uint32_t q = col[nctx * kGroup];
        col[ctx * kGroup] = (uint16_t)np;
        p = nctx == ctx ? np : q;
      } else {
        col[ctx * kGroup] = (uint16_t)np;
      }
      const unsigned mask = __ballot_sync(kFull, ren);
      if ((lane & 31) == 0) cc[4 * j + warp] = (uint8_t)__popc(mask);
      ur[j] = unit | (uint32_t)__popc(mask & below) << 16;
      rens |= (uint32_t)ren << j;
    }
    // one barrier a chunk, then each step's event slots in step order:
    // the exclusive prefix of the four warps' counts (bytes of one word)
    bar_sync(kBarModel, kGroup);
    const uint4* c4 = reinterpret_cast<const uint4*>(cnt[c & 1]);
#pragma unroll
    for (int j4 = 0; j4 < kSteps; j4 += 4) {
      const uint4 v = c4[j4 / 4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j4 + q;
        const uint32_t wd = q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
        const int before = ((wd * 0x01010100u) >> (8 * warp)) & 0xFF;
        const bool ren = (rens >> j) & 1;
        const int slot = cursor + before + (int)(ur[j] >> 16);
        store_if(gu + (emitted < 2 ? warm + emitted : slot_a),
                 (int)(ur[j] & 0xFFFFu), ren);
        slot_a = ren ? slot_b : slot_a;
        slot_b = ren ? slot : slot_b;
        emitted += ren;
        cursor += (int)((wd * 0x01010101u) >> 24);
      }
    }
  }
  if (live) {  // the two flush units: low's high half, then its low half
    for (int f = 0; f < 2; ++f) {
      gu[emitted < 2 ? warm + emitted : slot_a] = (int)(low >> 16);
      low <<= 16;
      slot_a = slot_b;
      ++emitted;
    }
  }
  if (lane == 0) counts[g] = cursor;
}

}  // namespace

// planes: u8 [rows, 1024] packed 2-bit (bit | active) fields, 4 rows >=
// iters, 16-byte aligned; table: i32 [363, 4] (ops/wide_kernels.py
// sm_table); units: i32 [8, cap] with cap >= 128 * (iters + 2); counts:
// i32 [8].  Group g's stream, in the decoder's consumption order, is
// units[g, 0:counts[g]] (u16 values).
extern "C" int wide_rc_encode_launch(const uint8_t* planes, int iters,
                                     int cap, const int* priors,
                                     const int* table, int* units,
                                     int* counts, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wide_rc_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kEncSmem);
  if (err != cudaSuccess) return (int)err;
  wide_rc_encode_kernel<<<kGroups, kThreads, kEncSmem,
                          (cudaStream_t)stream>>>(
      planes, iters, cap, priors, reinterpret_cast<const uint4*>(table),
      units, counts);
  return (int)cudaGetLastError();
}
