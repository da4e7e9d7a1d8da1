// The CODER_QLFC_WIDE lane state machine in table form, for the decoder
// (wide_decode.cu) and, in the form at the end, the encoders (wide_model.cu,
// wide_rc_encode.cu).  Beside the switch form of wide_sm.cuh, with the same
// transitions: a lane's control state (phase, t, brs) is one position id,
// and what a coded bit does at a position is one table entry, so the
// lanes of a warp run the same instructions whatever their phase.
//
// The table is built on the host from the format's rules, one uint4 per
// position: the words (A, B) for bit 0, then for bit 1 (the layout is
// documented at ops/wide_kernels.py sm_table, whose test enumerates it
// against the switch form).  A position's context is base + key, the key
// picked by its kind.
#pragma once

#include <cstdint>

namespace wide {

constexpr int kSmPositions = 363;        // len(sm_positions())
constexpr int kSmDone = kSmPositions - 1;
constexpr int kSink = 281;               // context row of a finished lane

enum KeyKind { kKeyRh, kKeyRExp, kKeyRMan, kKeyUFlag, kKeyUExp, kKeyUMan,
               kKeyDone };

struct TableLane {
  int pos, base, kind, rh, uh, prb, pub, val, rank;
};

__device__ __forceinline__ TableLane table_lane(bool live) {
  TableLane s;
  s.pos = live ? 0 : kSmDone;
  s.base = live ? 0 : kSink;
  s.kind = live ? kKeyRh : kKeyDone;
  s.rh = s.uh = s.prb = s.pub = s.val = s.rank = 0;
  return s;
}

__device__ __forceinline__ int table_ctx(const TableLane& s) {
  const int rankb = s.rank == 0 ? 0 : (s.rank <= 2 ? 1 : 2);
  int key = s.rh;
  key = s.kind == kKeyRExp ? 7 * s.prb + 21 * (s.rh & 1) : key;
  // unsigned, so that a val that a corrupt stream shifts past 31 bits
  // still keeps the context inside the model
  key = s.kind == kKeyRMan ? (int)min((unsigned)s.val - 1u, 14u) : key;
  key = s.kind == kKeyUFlag ? 3 * s.uh + rankb : key;
  key = s.kind == kKeyUExp ? 24 * s.pub : key;
  key = s.kind == kKeyUMan ? (int)min((unsigned)s.val, 15u) : key;
  key = s.kind == kKeyDone ? 0 : key;
  return s.base + key;
}

// Applies entry e (both bits' words of the lane's position) for one coded
// bit.  Returns the run the bit completes (the rank is then s.rank), or 0.
__device__ __forceinline__ int table_next(TableLane& s, uint4 e, int bit) {
  const uint32_t a = bit ? e.z : e.x;
  const uint32_t b = bit ? e.w : e.y;
  const int hist = (a >> 21) & 3, vmode = (a >> 23) & 3;
  const int rmode = (a >> 25) & 3, runmode = (a >> 27) & 3;
  const int shifted = (s.val << 1) | bit;
  s.rh = hist == 1 ? ((s.rh << 1) | bit) & 0xF : s.rh;
  s.uh = hist == 2 ? ((s.uh << 1) | bit) & 0xF : s.uh;
  s.val = vmode == 1 ? shifted : (vmode == 2 ? 1 : s.val);
  s.rank = rmode == 0 ? s.rank
         : (rmode == 1 ? 0 : (rmode == 2 ? 1 : shifted));
  s.prb = (b & 3) == 3 ? s.prb : (int)(b & 3);
  s.pub = ((b >> 2) & 3) == 3 ? s.pub : (int)((b >> 2) & 3);
  s.pos = a & 511;
  s.base = (a >> 9) & 511;
  s.kind = (a >> 18) & 7;
  return runmode == 0 ? 0 : (runmode == 1 ? 1 : shifted);
}

// The encoders' form of the table (K1 and K5, wide_encode_step.cuh;
// ops/wide_kernels.py sm_enc_table, one uint2 (A, B) per position and
// bit).  An encoder needs each step's context, never the run or the rank:
// its lane keeps the position's context base and key word, rh, uh, prb,
// pub, the rank's bucket rb and vc = min(val, 15), and the context is the
// base plus k1 * field1 + k2 * field2 of the histories packed into one word,
// every update a select.
constexpr uint32_t kEncKeyRh = 15u << 5 | 1u << 9;  // the rank flag's key

struct EncLane {
  uint32_t base, kw, rh, uh, prb, pub, rb, vc;
};

__device__ __forceinline__ EncLane enc_lane() {
  EncLane s;
  s.base = 0;
  s.kw = kEncKeyRh;
  s.rh = s.uh = s.prb = s.pub = s.rb = s.vc = 0;
  return s;
}

__device__ __forceinline__ uint32_t enc_ctx(const EncLane& s) {
  const uint32_t h = s.rh | s.uh << 4 | s.prb << 8 | s.pub << 10 |
                     s.rb << 12 | s.vc << 14;
  const uint32_t kw = s.kw;
  return s.base +
         ((h >> (kw & 31)) & ((kw >> 5) & 15)) * ((kw >> 9) & 31) +
         ((h >> ((kw >> 14) & 31)) & ((kw >> 19) & 3)) * ((kw >> 21) & 31);
}

// Applies one coded bit with ab, the (A, B) half entry of the lane's
// position for that bit.  The next position is ab.x & 511.
__device__ __forceinline__ void enc_next(EncLane& s, uint2 ab, uint32_t bit) {
  const uint32_t a = ab.x;
  const uint32_t hist = (a >> 18) & 3, vmode = (a >> 20) & 3;
  const uint32_t rmode = (a >> 22) & 3;
  const uint32_t vs = min((s.vc << 1) | bit, 15u);  // the shifted val
  s.rh = hist == 1 ? ((s.rh << 1) | bit) & 15 : s.rh;
  s.uh = hist == 2 ? ((s.uh << 1) | bit) & 15 : s.uh;
  s.vc = vmode == 1 ? vs : s.vc;
  s.vc = vmode == 2 ? 1 : s.vc;
  s.rb = rmode == 1 ? 0 : s.rb;
  s.rb = rmode == 2 ? 1 : s.rb;
  s.rb = rmode == 3 ? (vs <= 2 ? 1 : 2) : s.rb;
  s.prb = ((a >> 24) & 3) == 3 ? s.prb : (a >> 24) & 3;
  s.pub = ((a >> 26) & 3) == 3 ? s.pub : (a >> 26) & 3;
  s.base = (a >> 9) & 511;
  s.kw = ab.y;
}

}  // namespace wide
