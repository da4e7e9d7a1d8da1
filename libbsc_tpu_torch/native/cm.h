// Context-modeling primitives for the QLFC entropy coders: fixed-point
// probability counters, a 3-input logistic mixer with an interpolated APM,
// and the shared format-constant tables (stretch/squash logit tables and
// the opaque context->state maps).
//
// Semantics must be bit-identical to the reference predictor update rules
// (coder/common/predictor.h:40-213) — the bitstream depends on them.
#pragma once

#include <cstdint>

namespace tbsc {

// Format-constant tables, provided at init time by the host (extracted once
// from the format definition; see libbsc_tpu/coder/tables/).
struct FormatTables {
  const int16_t* stretch;      // [4097]
  const int16_t* squash;       // [4097], indexed by 2048 + s
  const uint8_t* rank_state;   // [32768]
  const uint8_t* run_state;    // [8192]
};

extern FormatTables g_tables;

inline int stretch_p(int p) { return g_tables.stretch[p]; }
inline int squash_p(int s) { return g_tables.squash[2048 + s]; }

inline int rank_state_of(int ctx_rank4, int ctx_run, int rank_hist) {
  return g_tables.rank_state[(ctx_run << 11) | (ctx_rank4 << 3) | rank_hist];
}

inline int run_state_of(int ctx_rank0, int ctx_run, int rank, int run_hist) {
  int r = rank < 7 ? rank : 7;
  int h = run_hist < 7 ? run_hist : 7;
  return g_tables.run_state[(ctx_rank0 << 10) | (ctx_run << 6) | (r << 3) | h];
}

// --- probability counters (12-bit fixed point) ---

inline void upd0(int16_t& p, int th, int ar) {
  p = (int16_t)(p + (((4096 - th - p) * ar) >> 12));
}

inline void upd1(int16_t& p, int th, int ar) {
  p = (int16_t)(p - (((p - th) * ar) >> 12));
}

inline void upd(uint32_t bit, int16_t& p, int th0, int ar0, int th1, int ar1) {
  int d0 = p * ar0 - ((4096 - th0) * ar0 - 4095);
  int d1 = p * ar1 - th1 * ar1;
  p = (int16_t)(p - ((bit ? d1 : d0) >> 12));
}

// shift-based counters (fast coder)
template <int R>
inline void upd_shift(int16_t& p, int th) {
  p = (int16_t)(p - ((p - th) >> R));
}

template <int R>
inline void upd_shift(uint32_t bit, int16_t& p, int th0, int th1) {
  p = (int16_t)(p - ((p - (bit ? th1 : th0)) >> R));
}

// --- 3-input logistic mixer with 17-bin APM (adaptive coder only) ---

struct Mixer {
  int16_t s0, s1, s2;     // stretched inputs of the last mixup (decode path)
  int32_t mixed;          // last mixed probability (decode path)
  int32_t idx;            // APM bin of the last mixup (decode path)
  int16_t apm[17];
  int32_t w0, w1, w2;

  void init() {
    w0 = w1 = 2048 << 5;
    w2 = 0;
    for (int p = 0; p < 17; ++p) apm[p] = (int16_t)squash_p((p - 8) * 256);
  }

  // Combine three probabilities; cache intermediates for a later update.
  inline int mix(int p0, int p1, int p2) {
    s0 = (int16_t)stretch_p(p0);
    s1 = (int16_t)stretch_p(p1);
    s2 = (int16_t)stretch_p(p2);
    int16_t st = (int16_t)((s0 * w0 + s1 * w1 + s2 * w2) >> 17);
    if (st < -2047) st = -2047;
    if (st > 2047) st = 2047;
    idx = (st + 2048) >> 8;
    const int frac = st & 255;
    const int direct = squash_p(st);
    const int mapped = apm[idx] + (((apm[idx + 1] - apm[idx]) * frac) >> 8);
    return mixed = (3 * direct + mapped) >> 2;
  }

  // Learn from the coded bit; lr*/th/ar are per-callsite model constants.
  inline void learn(uint32_t bit, int lr0, int lr1, int lr2, int th, int ar) {
    if (bit) {
      upd1(apm[idx], th, ar);
      upd1(apm[idx + 1], th, ar);
    } else {
      upd0(apm[idx], th, ar);
      upd0(apm[idx + 1], th, ar);
    }
    const int eps = mixed - (bit ? 1 : 4095);
    w0 -= (lr0 * eps * s0) >> 16;
    w1 -= (lr1 * eps * s1) >> 16;
    w2 -= (lr2 * eps * s2) >> 16;
  }

  inline int mix_learn(uint32_t bit, int p0, int p1, int p2,
                       int lr0, int lr1, int lr2, int th, int ar) {
    int m = mix(p0, p1, p2);
    learn(bit, lr0, lr1, lr2, th, ar);
    return m;
  }

  // Branchless variant for data-dependent bits (mantissa/escape/flags):
  // the fused upd() selects between the two counter updates with masks,
  // arithmetically identical to the one-sided upd0/upd1 pair.
  inline void learn_sel(uint32_t bit, int lr0, int lr1, int lr2,
                        int th0, int ar0, int th1, int ar1) {
    upd(bit, apm[idx], th0, ar0, th1, ar1);
    upd(bit, apm[idx + 1], th0, ar0, th1, ar1);
    const int eps = mixed - (bit ? 1 : 4095);
    w0 -= (lr0 * eps * s0) >> 16;
    w1 -= (lr1 * eps * s1) >> 16;
    w2 -= (lr2 * eps * s2) >> 16;
  }
};

inline int bsr(uint32_t x) { return 31 - __builtin_clz(x); }
inline int bsf(uint32_t x) { return __builtin_ctz(x); }
inline int bsf64(uint64_t x) { return __builtin_ctzll(x); }

}  // namespace tbsc
