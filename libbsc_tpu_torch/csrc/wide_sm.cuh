// The CODER_QLFC_WIDE per-lane state machine and model update, shared by
// the model kernel (wide_model.cu) and the decode kernel (wide_decode.cu).
//
// One lane codes its runs as: rank flag, rank exponent in unary (capped at
// RANK_EXP_CAP), rank mantissa, run flag, run exponent in unary (capped at
// RUN_EXP_CAP), run mantissa.  sm_ctx picks the model context (0..280) of
// the next bit from the lane's state; sm_next applies one coded bit.  Both
// are the scalar form of _sm_ctx/_sm_next in the JAX package's
// ops/wide_kernels.py (the format is specified in its ops/wide.py).
#pragma once

#include <cstdint>

namespace wide {

constexpr int kNctx = 281;
constexpr int kGroup = 128;        // lanes per group: one block, one stream
constexpr int kGroups = 8;
constexpr int kLanes = kGroups * kGroup;
constexpr int kRankExpCap = 8;
constexpr int kRunExpCap = 25;

enum Phase { kRFlag, kRExp, kRMan, kUFlag, kUExp, kUMan, kDone };

struct LaneState {
  int phase, t, brs, val, rank, rh, uh, prb, pub;
};

__device__ __forceinline__ LaneState fresh_state(int phase) {
  LaneState s;
  s.phase = phase;
  s.t = s.brs = s.val = s.rank = s.rh = s.uh = s.prb = s.pub = 0;
  return s;
}

__device__ __forceinline__ int bucket3(int b) {
  return b <= 1 ? 0 : (b <= 3 ? 1 : 2);
}

// mantissa tree offset per rank bit-length (RM_OFF of the format)
__device__ __forceinline__ int rank_man_off(int brs) {
  switch (brs) {
    case 3: return 1;
    case 4: return 4;
    case 5: return 11;
    case 6: return 26;
    case 7: return 41;
    case 8: return 56;
    default: return 0;
  }
}

__device__ __forceinline__ int sm_ctx(const LaneState& s) {
  switch (s.phase) {
    case kRFlag: return s.rh;
    case kRExp: return 16 + 7 * s.prb + 21 * (s.rh & 1) + s.t - 1;
    case kRMan: return 58 + rank_man_off(s.brs) + min(s.val - 1, 14);
    case kUFlag:
      return 129 + 3 * s.uh + (s.rank == 0 ? 0 : (s.rank <= 2 ? 1 : 2));
    case kUExp: return 177 + 24 * s.pub + s.t - 1;
    default: return 249 + 16 * (s.brs > 3 ? 1 : 0) + min(s.val, 15);
  }
}

// Applies one coded bit.  Returns the run length when the bit completes a
// run (the lane's rank is then s.rank and its phase is back at kRFlag),
// else 0.
__device__ __forceinline__ int sm_next(LaneState& s, int bit) {
  switch (s.phase) {
    case kRFlag:
      s.rh = ((s.rh << 1) | bit) & 0xF;
      if (bit) {
        s.phase = kRExp; s.t = 1; s.brs = 1;
      } else {
        s.phase = kUFlag; s.rank = 0; s.prb = 0;
      }
      return 0;
    case kRExp:
      if (bit) {
        if (s.brs + 1 == kRankExpCap) {
          s.phase = kRMan; s.val = 1; s.t = 0; s.prb = bucket3(s.brs + 1);
        } else {
          s.t += 1;
        }
        s.brs += 1;
      } else {
        s.prb = bucket3(s.brs);
        if (s.brs == 1) {
          s.phase = kUFlag; s.rank = 1;
        } else {
          s.phase = kRMan; s.val = 1; s.t = 0;
        }
      }
      return 0;
    case kRMan: {
      const int v = (s.val << 1) | bit;
      s.val = v;
      if (s.t + 1 == s.brs - 1) {
        s.phase = kUFlag; s.rank = v;
      } else {
        s.t += 1;
      }
      return 0;
    }
    case kUFlag:
      s.uh = ((s.uh << 1) | bit) & 0xF;
      if (bit) {
        s.phase = kUExp; s.t = 1; s.brs = 1;
        return 0;
      }
      s.pub = 0; s.phase = kRFlag;
      return 1;
    case kUExp:
      if (bit) {
        if (s.brs + 1 == kRunExpCap) {
          s.phase = kUMan; s.val = 1; s.t = 0; s.pub = bucket3(s.brs + 1);
        } else {
          s.t += 1;
        }
        s.brs += 1;
      } else {
        s.pub = bucket3(s.brs); s.phase = kUMan; s.val = 1; s.t = 0;
      }
      return 0;
    default: {  // kUMan
      const int v = (s.val << 1) | bit;
      s.val = v;
      if (s.t + 1 == s.brs - 1) {
        s.phase = kRFlag;
        return v;
      }
      s.t += 1;
      return 0;
    }
  }
}

// 12-bit probability of a zero bit, shift-5 adaptation
__device__ __forceinline__ uint32_t adapt(uint32_t p, int bit) {
  return bit ? p - (p >> 5) : p + ((4096u - p) >> 5);
}

}  // namespace wide
