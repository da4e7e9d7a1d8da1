// QLFC entropy coders: rank/run-length modeling over an MTF-style transform,
// coded with a binary range coder.  Three flavors, matching the reference
// stream formats bit-for-bit (coder/qlfc/qlfc.cpp):
//   - "cm static":   3-model linear mix with fixed >>5 weights
//   - "cm adaptive": 3-model logistic mixer + APM, online weight learning
//   - "fast":        per-char exponent/mantissa predictors, shift updates
//
// The engine here is an original implementation organized around a single
// templated codec parameterized by a constant family (adaptive/static) and
// direction, rather than the reference's six hand-specialized functions.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <ctime>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

#include "rc.h"
#include "cm.h"

namespace tbsc {

using u8 = uint8_t;
using u32 = uint32_t;

constexpr int TBSC_NOT_COMPRESSIBLE = -3;

// Advance past a run of byte c starting at `in` (exclusive of the first
// byte, already consumed): 8-byte XOR probes, byte-exact landing.
static inline const u8* skip_run(const u8* in, const u8* in_end, u8 c) {
#if defined(__AVX2__)
  const __m256i pat32 = _mm256_set1_epi8((char)c);
  while (in + 32 <= in_end) {
    __m256i v = _mm256_loadu_si256((const __m256i*)in);
    u32 m = (u32)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, pat32));
    if (m != 0xffffffffu) return in + __builtin_ctz(~m);
    in += 32;
  }
#endif
  const uint64_t pat = 0x0101010101010101ull * c;
  while (in + 8 <= in_end) {
    uint64_t x;
    std::memcpy(&x, in, 8);
    x ^= pat;
    if (x) return in + (__builtin_ctzll(x) >> 3);
    in += 8;
  }
  while (in < in_end && *in == c) ++in;
  return in;
}


// ---------------------------------------------------------------------------
// Model parameter families.  CP = counter params (threshold/rate pairs for
// bit0 and bit1), GP = one bit-group (state/char/static counters + mixer APM
// params + mixer learning rates or fixed linear weights).
// Values are format constants (qlfc_model.h:38-176).
// ---------------------------------------------------------------------------

struct CP { int th0, ar0, th1, ar1; };
struct GP {
  CP s, c, p;   // state / char / static counter params
  CP mx;        // adaptive: mixer APM threshold/rate (th0/ar0, th1/ar1)
  int lr0, lr1, lr2;
};
struct Fam {
  GP rank_t, rank_e, rank_m, rank_p;  // flag, exponent, mantissa, escape
  GP run_t, run_e, run_m;
};

static const Fam kAdaptive = {
    /*rank_t*/ {{1, 57, -111, 31}, {291, 250, 154, 528}, {375, 163, 313, 639}, {-41, 96, 53, 49}, 20, 47, 27},
    /*rank_e*/ {{-137, 17, 482, 40}, {61, 192, 200, 133}, {54, 1342, 578, 1067}, {-11, 318, 144, 848}, 49, 41, 40},
    /*rank_m*/ {{-145, 18, 114, 24}, {-43, 69, -36, 78}, {-2, 1119, 11, 1181}, {-203, 20, -271, 15}, 263, 175, 17},
    /*rank_p*/ {{-99, 32, 318, 42}, {17, 101, 1116, 246}, {22, 964, -2, 1110}, {-194, 21, -129, 20}, 480, 202, 17},
    /*run_t*/ {{-93, 34, -4, 51}, {139, 423, 244, 162}, {275, 450, -6, 579}, {-68, 25, 1, 64}, 15, 50, 78},
    /*run_e*/ {{-116, 31, 43, 45}, {165, 222, 30, 324}, {315, 857, 109, 867}, {-14, 215, 61, 73}, 35, 37, 42},
    /*run_m*/ {{-176, 14, -141, 21}, {84, 172, 37, 263}, {2, 15, -197, 20}, {-27, 142, -146, 27}, 51, 44, 80},
};

static const Fam kStatic = {
    /*rank_t*/ {{-116, 33, -78, 34}, {-2, 282, 12, 274}, {4, 697, 55, 1185}, {}, 17, 14, 1},
    /*rank_e*/ {{-177, 23, -370, 11}, {-14, 271, 3, 308}, {-3, 788, 135, 1364}, {}, 22, 6, 4},
    /*rank_m*/ {{-254, 16, -177, 20}, {-55, 73, -54, 74}, {-6, 575, 1670, 1173}, {}, 15, 10, 7},
    /*rank_p*/ {{-126, 32, -126, 32}, {-33, 120, -25, 157}, {-6, 585, 150, 275}, {}, 16, 11, 5},
    /*run_t*/ {{-68, 38, -112, 36}, {-4, 221, -13, 231}, {0, 0, 0, 0}, {}, 14, 18, 0},
    /*run_e*/ {{-90, 45, -92, 44}, {-3, 325, -11, 341}, {24, 887, -4, 765}, {}, 14, 15, 3},
    /*run_m*/ {{-275, 14, -185, 22}, {-18, 191, -15, 241}, {-73, 54, -214, 19}, {}, 7, 15, 10},
};

// ---------------------------------------------------------------------------
// Model state (the "CM" model, reference QlfcStatisticalModel1)
// ---------------------------------------------------------------------------

struct M1 {
  int16_t rank_flag_p;
  int16_t rank_flag_s[256];
  int16_t rank_flag_c[256];
  int16_t rank_exp_p[8];
  int16_t rank_exp_s[256][8];
  int16_t rank_exp_c[256][8];
  int16_t rank_man_p[8][256];
  int16_t rank_man_s[8][256][256];
  int16_t rank_man_c[8][256][256];
  int16_t rank_esc_p[256];
  int16_t rank_esc_s[256][256];
  int16_t rank_esc_c[256][256];
  int16_t run_flag_p;
  int16_t run_flag_s[256];
  int16_t run_flag_c[256];
  int16_t run_exp_p[32];
  int16_t run_exp_s[256][32];
  int16_t run_exp_c[256][32];
  int16_t run_man_p[32][32];
  int16_t run_man_s[32][256][32];
  int16_t run_man_c[32][256][32];

  Mixer mix_rank[256];
  Mixer mix_rank_exp[8][8];
  Mixer mix_rank_man[8];
  Mixer mix_rank_esc[256];
  Mixer mix_run[256];
  Mixer mix_run_exp[32][32];
  Mixer mix_run_man[32];

  void init() {
    int16_t* probs = &rank_flag_p;
    size_t n_probs = ((int16_t*)&run_man_c[31][255][31] + 1) - probs;
    for (size_t i = 0; i < n_probs; ++i) probs[i] = 2048;
    for (int i = 0; i < 256; ++i) { mix_rank[i].init(); mix_rank_esc[i].init(); mix_run[i].init(); }
    for (int b = 0; b < 8; ++b) {
      mix_rank_man[b].init();
      for (int c = 0; c < 8; ++c) mix_rank_exp[c][b].init();
    }
    for (int b = 0; b < 32; ++b) {
      mix_run_man[b].init();
      for (int c = 0; c < 32; ++c) mix_run_exp[c][b].init();
    }
  }
};

// Fast model (reference QlfcStatisticalModel2): per-char predictors only.
struct M2 {
  int16_t rank_exp[256][8];
  int16_t rank_man[256][8][256];
  int16_t run_exp[256][32];
  int16_t run_man[256][32][32];

  void init() {
    int16_t* r = &rank_exp[0][0];
    size_t nr = (&rank_man[255][7][255] + 1) - r;
    for (size_t i = 0; i < nr; ++i) r[i] = 4096;
    int16_t* u = &run_exp[0][0];
    size_t nu = (&run_man[255][31][31] + 1) - u;
    for (size_t i = 0; i < nu; ++i) u[i] = 1024;
  }
};

// Pristine per-block snapshots, built once (model reset is part of the
// format: every sub-block starts from this canonical state).
static M1* g_m1_pristine = nullptr;
static M2* g_m2_pristine = nullptr;

int qlfc_init() {
  if (!g_m1_pristine) {
    g_m1_pristine = (M1*)malloc(sizeof(M1));
    g_m2_pristine = (M2*)malloc(sizeof(M2));
    if (!g_m1_pristine || !g_m2_pristine) return -2;
    g_m1_pristine->init();
    g_m2_pristine->init();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// QLFC rank transform: backward run scan emitting MTF ranks (first occurrence
// emits the appearance index instead), plus the final MTF alphabet table.
// Scalar semantics per qlfc.cpp:398-455; all reference SIMD variants produce
// the same output.
// ---------------------------------------------------------------------------

// `rl` (same indexing as the rank bytes in `buffer`) receives each run's
// length saturated to 255; the coding loops re-derive >=255 runs with one
// skip_run probe.  Recording lengths here removes the per-run byte re-scan
// (and its data-dependent exit branch) from the serial coding loops.
static int rank_transform(const u8* input, u8* buffer, int n, u8* mtf, u8* rl) {
  u8 seen[256];
  std::memset(seen, 0, sizeof seen);
  for (int i = 0; i < 256; ++i) mtf[i] = (u8)i;
  if (input[n - 1] == 0) { mtf[0] = 1; mtf[1] = 0; }

  int idx = n, n_sym = 0;

#if defined(__AVX2__)
  // Rank-vector formulation (the VPU-shaped form of the MTF update, same
  // idea as the reference's SIMD rank update qlfc.cpp:220-227): keep
  // rank_of[sym] and, per run, increment every rank below the emitted one
  // with a masked compare-subtract over eight 32-byte lanes.  O(1) per run
  // instead of an O(rank) list walk — the deep-rank (high entropy) regions
  // after a BWT make the walk the dominant cost.
  alignas(32) u8 rank_of[256];
  for (int i = 0; i < 256; ++i) rank_of[i] = (u8)i;
  if (input[n - 1] == 0) { rank_of[0] = 1; rank_of[1] = 0; }
  // Current rank-0 holder.  Consecutive runs differ in symbol, so every
  // emitted rank is >= 1; for the (dominant) rank==1 case the masked
  // 256-lane increment below touches exactly one entry — this one.
  u8 sym0 = input[n - 1] == 0 ? 1 : 0;
  const __m256i bias = _mm256_set1_epi8((char)0x80);
  auto emit_run = [&](u8 c, int len) {
    int rank = rank_of[c];
    if (rank == 1) {
      rank_of[sym0] = 1;
    } else {
      const __m256i rv = _mm256_set1_epi8((char)(rank ^ 0x80));
      for (int g = 0; g < 256; g += 32) {
        __m256i v = _mm256_load_si256((const __m256i*)(rank_of + g));
        __m256i lt = _mm256_cmpgt_epi8(rv, _mm256_xor_si256(v, bias));
        _mm256_store_si256((__m256i*)(rank_of + g), _mm256_sub_epi8(v, lt));
      }
    }
    rank_of[c] = 0;
    sym0 = c;
    if (!seen[c]) { seen[c] = 1; rank = n_sym++; }
    buffer[--idx] = (u8)rank;
    rl[idx] = len < 255 ? (u8)len : (u8)255;
  };
#else
  // move-to-front walk for one run's symbol; emits the rank (appearance
  // index on first occurrence)
  auto emit_run = [&](u8 c, int len) {
    u8 prev = mtf[0];
    int rank = 1;
    mtf[0] = c;
    for (;;) {
      u8 t = mtf[rank];
      mtf[rank] = prev;
      if (t == c) break;
      prev = t;
      ++rank;
    }
    if (!seen[c]) { seen[c] = 1; rank = n_sym++; }
    buffer[--idx] = (u8)rank;
    rl[idx] = len < 255 ? (u8)len : (u8)255;
  };
#endif

  // Backward run iteration in chunks: run heads inside each chunk are found
  // with a wide equality scan (input[i] != input[i+1] marks a head at i+1),
  // collected forward, then consumed in reverse — this replaces the
  // byte-at-a-time backward scan with ~n/32 vector steps.
  enum { CHUNK = 1 << 14 };
  int heads[CHUNK + 1];
  int i = n - 1;        // last unprocessed position
  while (i >= 0) {
    const int lo = (i + 1 >= CHUNK) ? i + 1 - CHUNK : 0;
    // collect run-head positions h in (lo, i]: input[h] != input[h-1]
    int nh = 0;
#if defined(__AVX2__)
    {
      int h = lo + 1;
      for (; h + 32 <= i + 1; h += 32) {
        __m256i a = _mm256_loadu_si256((const __m256i*)(input + h));
        __m256i b = _mm256_loadu_si256((const __m256i*)(input + h - 1));
        u32 eq = (u32)_mm256_movemask_epi8(_mm256_cmpeq_epi8(a, b));
        u32 ne = ~eq;
        while (ne) {
          int b0 = __builtin_ctz(ne);
          heads[nh++] = h + b0;
          ne &= ne - 1;
        }
      }
      for (; h <= i; ++h)
        if (input[h] != input[h - 1]) heads[nh++] = h;
    }
#else
    for (int h = lo + 1; h <= i; ++h)
      if (input[h] != input[h - 1]) heads[nh++] = h;
#endif
    heads[nh] = i + 1;  // sentinel: end of the chunk's last run

    // consume runs of this chunk back-to-front; the run starting at lo may
    // continue into the previous chunk — defer it unless lo == 0
    for (int r = nh - 1; r >= 0; --r) {
      emit_run(input[heads[r]], heads[r + 1] - heads[r]);
    }
    int first_head = nh > 0 ? heads[0] : i + 1;
    if (lo == 0) {
      // head of the whole buffer: the run starting at 0
      emit_run(input[0], first_head);
      break;
    }
    // continue with the tail of the run crossing the chunk boundary
    i = first_head - 1;
    u8 c = input[i];
    while (i >= 0 && input[i] == c) --i;
    // i now sits on the last position of the previous run (or -1); the
    // crossing run [i+1, first_head) is one run with symbol c
    emit_run(c, first_head - (i + 1));
  }
  buffer[n - 1] = 1;

#if defined(__AVX2__)
  // materialize the final MTF table from the rank permutation
  for (int s = 0; s < 256; ++s) mtf[rank_of[s]] = (u8)s;
#endif

  // Mark the end of the used alphabet with a duplicate entry.
  for (int r = 1; r < 256; ++r) {
    if (!seen[mtf[r]]) { mtf[r] = mtf[r - 1]; break; }
  }
  return idx;
}

// ---------------------------------------------------------------------------
// Alphabet codec: per-bit binary-tree coding of the MTF table where only
// ambiguous bits (both subtrees non-empty among still-eligible chars) are
// coded.  P/prob select the raw-bit flavor (12/2048 for cm, 1/1 for fast).
// ---------------------------------------------------------------------------

template <int P, int PROB>
static int encode_alphabet(RcEncoder& rc, const u8* mtf, bool track_max_rank) {
  u8 used[256];
  std::memset(used, 0, sizeof used);
  int max_rank = 7, prev = -1;
  for (int r = 0; r < 256; ++r) {
    int cur = mtf[r];
    for (int bit = 7; bit >= 0; --bit) {
      bool b0 = false, b1 = false;
      for (int c = 0; c < 256; ++c) {
        if (c == prev || !used[c]) {
          if ((cur >> (bit + 1)) == (c >> (bit + 1))) {
            if ((c >> bit) & 1) b1 = true; else b0 = true;
            if (b0 && b1) break;
          }
        }
      }
      if (b0 && b1) rc.encode<P>((cur >> bit) & 1, PROB);
    }
    if (cur == prev) {
      if (track_max_rank) max_rank = r > 1 ? bsr((u32)(r - 1)) : 0;
      break;
    }
    prev = cur;
    used[cur] = 1;
  }
  return max_rank;
}

template <int P, int PROB>
static int decode_alphabet(RcDecoder& rc, u8* mtf, bool track_max_rank) {
  u8 used[256];
  std::memset(used, 0, sizeof used);
  int max_rank = 7, prev = -1;
  for (int r = 0; r < 256; ++r) {
    int cur = 0;
    for (int bit = 7; bit >= 0; --bit) {
      bool b0 = false, b1 = false;
      for (int c = 0; c < 256; ++c) {
        if (c == prev || !used[c]) {
          if (cur == (c >> (bit + 1))) {
            if ((c >> bit) & 1) b1 = true; else b0 = true;
            if (b0 && b1) break;
          }
        }
      }
      if (b0 && b1) cur += cur + rc.decode<P>(PROB);
      else cur += cur + (b1 ? 1 : 0);
    }
    mtf[r] = (u8)cur;
    if (cur == prev) {
      if (track_max_rank) max_rank = r > 1 ? bsr((u32)(r - 1)) : 0;
      break;
    }
    prev = cur;
    used[cur] = 1;
  }
  return max_rank;
}

// ---------------------------------------------------------------------------
// CM engine (static + adaptive).  One bit through one group:
//   adaptive: probability = mixer(char, state, static) with online learning
//   static:   probability = (char*lr0 + state*lr1 + static*lr2) >> 5
// Counter updates: flag/exponent groups use one-sided upd0/upd1;
// mantissa/escape groups use the fused delta-form upd() in the static
// family only (the adaptive family branches) — matching the reference.
// ---------------------------------------------------------------------------

template <bool ADAPTIVE>
static inline int group_p(const GP& g, Mixer* mx, int pc, int ps, int pp) {
  if (ADAPTIVE) return mx->mix(pc, ps, pp);
  return (pc * g.lr0 + ps * g.lr1 + pp * g.lr2) >> 5;
}

template <bool ADAPTIVE>
static inline void group_learn(const GP& g, Mixer* mx, u32 bit,
                               int16_t& s, int16_t& c, int16_t& p) {
  if (bit) {
    upd1(s, g.s.th1, g.s.ar1);
    upd1(c, g.c.th1, g.c.ar1);
    upd1(p, g.p.th1, g.p.ar1);
  } else {
    upd0(s, g.s.th0, g.s.ar0);
    upd0(c, g.c.th0, g.c.ar0);
    upd0(p, g.p.th0, g.p.ar0);
  }
  if (ADAPTIVE) {
    if (bit) mx->learn(1, g.lr0, g.lr1, g.lr2, g.mx.th1, g.mx.ar1);
    else     mx->learn(0, g.lr0, g.lr1, g.lr2, g.mx.th0, g.mx.ar0);
  }
}

// Two-sided fused update used by the static family in mantissa/escape paths.
static inline void group_learn_fused(const GP& g, u32 bit,
                                     int16_t& s, int16_t& c, int16_t& p) {
  upd(bit, s, g.s.th0, g.s.ar0, g.s.th1, g.s.ar1);
  upd(bit, c, g.c.th0, g.c.ar0, g.c.th1, g.c.ar1);
  upd(bit, p, g.p.th0, g.p.ar0, g.p.th1, g.p.ar1);
}

// Branchless learn for DATA-DEPENDENT bits (flags/mantissa/escape): those
// bits are near-random, so the bit-dispatching branch in group_learn
// mispredicts heavily.  The fused upd() + learn_sel path is mask-selected
// and arithmetically identical to the one-sided pair (the reference
// branches here; beating it means not copying that choice).
template <bool ADAPTIVE>
static inline void group_learn_data(const GP& g, Mixer* mx, u32 bit,
                                    int16_t& s, int16_t& c, int16_t& p) {
  upd(bit, s, g.s.th0, g.s.ar0, g.s.th1, g.s.ar1);
  upd(bit, c, g.c.th0, g.c.ar0, g.c.th1, g.c.ar1);
  upd(bit, p, g.p.th0, g.p.ar0, g.p.th1, g.p.ar1);
  if (ADAPTIVE)
    mx->learn_sel(bit, g.lr0, g.lr1, g.lr2,
                  g.mx.th0, g.mx.ar0, g.mx.th1, g.mx.ar1);
}

template <bool ADAPTIVE>
static int cm_encode(const u8* input, u8* output, u8* buffer, int isize, int osize, M1* m) {
  const Fam& F = ADAPTIVE ? kAdaptive : kStatic;
  u8 mtf[256];
#ifdef TBSC_QLFC_PROF
  struct timespec ts0, tsA, ts1, ts2;
  clock_gettime(CLOCK_MONOTONIC, &ts0);
#endif
  std::memcpy(m, g_m1_pristine, sizeof(M1));
#ifdef TBSC_QLFC_PROF
  clock_gettime(CLOCK_MONOTONIC, &tsA);
#endif

  int ctx_rank0 = 0, ctx_rank4 = 0, ctx_run = 0, avg_rank = 0;
  u8 rank_hist[256], run_hist[256];
  std::memset(rank_hist, 0, sizeof rank_hist);
  std::memset(run_hist, 0, sizeof run_hist);

  u8* rl = buffer + isize;  // run lengths (saturated), same indexing as ranks
  int rank_off = rank_transform(input, buffer, isize, mtf, rl);
#ifdef TBSC_QLFC_PROF
  clock_gettime(CLOCK_MONOTONIC, &ts1);
#endif

  RcEncoder rc;
  rc.init(output, osize);
  rc.encode_word((u32)isize);
  int max_rank = encode_alphabet<12, 2048>(rc, mtf, true);
#ifdef TBSC_QLFC_PROF
  struct timespec tsB;
  clock_gettime(CLOCK_MONOTONIC, &tsB);
#endif

  const u8* in = input;
  const u8* in_end = input + isize;
  const u8* rk = buffer + rank_off;
  const u8* rk_end = buffer + isize;
  const u8* rlq = rl + rank_off;

  while (rk < rk_end) {
    if (rc.overflow()) return TBSC_NOT_COMPRESSIBLE;

    int c = *in;
    int run = *rlq++;
    if (__builtin_expect(run == 255, 0))
      run = (int)(skip_run(in + 255, in_end, (u8)c) - in);
    in += run;

    int rank = *rk++;
    int hist = rank_hist[c];
    int st = rank_state_of(ctx_rank4, ctx_run, hist);

    if (avg_rank < 32) {
      // flag bit: rank==1?
      {
        const GP& g = F.rank_t;
        int p = group_p<ADAPTIVE>(g, &m->mix_rank[c], m->rank_flag_c[c], m->rank_flag_s[st], m->rank_flag_p);
        u32 bit = rank != 1;
        group_learn<ADAPTIVE>(g, &m->mix_rank[c], bit, m->rank_flag_s[st], m->rank_flag_c[c], m->rank_flag_p);
        rc.encode(bit, p);
      }
      if (rank == 1) {
        rank_hist[c] = 0;
      } else {
        int brs = bsr((u32)rank);
        rank_hist[c] = (u8)brs;
        // exponent: unary over bit-length
        {
          const GP& g = F.rank_e;
          Mixer* mx = &m->mix_rank_exp[hist < 1 ? 1 : hist][1];
          int bit;
          for (bit = 1; bit < brs; ++bit) {
            int p = group_p<ADAPTIVE>(g, mx, m->rank_exp_c[c][bit - 1], m->rank_exp_s[st][bit - 1], m->rank_exp_p[bit - 1]);
            group_learn<ADAPTIVE>(g, mx, 1, m->rank_exp_s[st][bit - 1], m->rank_exp_c[c][bit - 1], m->rank_exp_p[bit - 1]);
            rc.encode1(p);
            mx = &m->mix_rank_exp[hist <= bit ? bit + 1 : hist][bit + 1];
          }
          if (brs < max_rank) {
            int p = group_p<ADAPTIVE>(g, mx, m->rank_exp_c[c][bit - 1], m->rank_exp_s[st][bit - 1], m->rank_exp_p[bit - 1]);
            group_learn<ADAPTIVE>(g, mx, 0, m->rank_exp_s[st][bit - 1], m->rank_exp_c[c][bit - 1], m->rank_exp_p[bit - 1]);
            rc.encode0(p);
          }
        }
        // mantissa
        {
          const GP& g = F.rank_m;
          Mixer* mx = &m->mix_rank_man[brs];
          for (int ctx = 1, bit = brs - 1; bit >= 0; --bit) {
            u32 b = (rank >> bit) & 1;
            int p = group_p<ADAPTIVE>(g, mx, m->rank_man_c[brs][c][ctx], m->rank_man_s[brs][st][ctx], m->rank_man_p[brs][ctx]);
            group_learn_data<ADAPTIVE>(g, mx, b, m->rank_man_s[brs][st][ctx], m->rank_man_c[brs][c][ctx], m->rank_man_p[brs][ctx]);
            rc.encode(b, p);
            ctx += ctx + b;
          }
        }
      }
    } else {
      // escape: plain (max_rank+1)-bit binary coding of the rank
      rank_hist[c] = (u8)bsr((u32)rank);
      const GP& g = F.rank_p;
      for (int ctx = 1, bit = max_rank; bit >= 0; --bit) {
        Mixer* mx = &m->mix_rank_esc[ctx];
        u32 b = (rank >> bit) & 1;
        int p = group_p<ADAPTIVE>(g, mx, m->rank_esc_c[c][ctx], m->rank_esc_s[st][ctx], m->rank_esc_p[ctx]);
        group_learn_data<ADAPTIVE>(g, mx, b, m->rank_esc_s[st][ctx], m->rank_esc_c[c][ctx], m->rank_esc_p[ctx]);
        rc.encode(b, p);
        ctx += ctx + b;
      }
    }

    avg_rank = (avg_rank * 124 + rank * 4) >> 7;
    rank -= 1;
    hist = run_hist[c];
    st = run_state_of(ctx_rank0, ctx_run, rank, hist);

    // run length
    {
      const GP& g = F.run_t;
      int p = group_p<ADAPTIVE>(g, &m->mix_run[c], m->run_flag_c[c], m->run_flag_s[st], m->run_flag_p);
      u32 bit = run != 1;
      group_learn<ADAPTIVE>(g, &m->mix_run[c], bit, m->run_flag_s[st], m->run_flag_c[c], m->run_flag_p);
      rc.encode(bit, p);
    }
    if (run == 1) {
      run_hist[c] = (u8)((run_hist[c] + 2) >> 2);
    } else {
      int brs = bsr((u32)run);
      run_hist[c] = (u8)((run_hist[c] + 3 * brs + 3) >> 2);
      {
        const GP& g = F.run_e;
        Mixer* mx = &m->mix_run_exp[hist < 1 ? 1 : hist][1];
        int bit;
        for (bit = 1; bit < brs; ++bit) {
          int p = group_p<ADAPTIVE>(g, mx, m->run_exp_c[c][bit - 1], m->run_exp_s[st][bit - 1], m->run_exp_p[bit - 1]);
          group_learn<ADAPTIVE>(g, mx, 1, m->run_exp_s[st][bit - 1], m->run_exp_c[c][bit - 1], m->run_exp_p[bit - 1]);
          rc.encode1(p);
          mx = &m->mix_run_exp[hist <= bit ? bit + 1 : hist][bit + 1];
        }
        {
          int p = group_p<ADAPTIVE>(g, mx, m->run_exp_c[c][bit - 1], m->run_exp_s[st][bit - 1], m->run_exp_p[bit - 1]);
          group_learn<ADAPTIVE>(g, mx, 0, m->run_exp_s[st][bit - 1], m->run_exp_c[c][bit - 1], m->run_exp_p[bit - 1]);
          rc.encode0(p);
        }
      }
      {
        const GP& g = F.run_m;
        Mixer* mx = &m->mix_run_man[brs];
        for (int ctx = 1, bit = brs - 1; bit >= 0; --bit) {
          u32 b = (run >> bit) & 1;
          int p = group_p<ADAPTIVE>(g, mx, m->run_man_c[brs][c][ctx], m->run_man_s[brs][st][ctx], m->run_man_p[brs][ctx]);
          group_learn_data<ADAPTIVE>(g, mx, b, m->run_man_s[brs][st][ctx], m->run_man_c[brs][c][ctx], m->run_man_p[brs][ctx]);
          rc.encode(b, p);
          if (brs <= 5) ctx += ctx + b; else ctx += 1;
        }
      }
    }

    ctx_rank0 = ((ctx_rank0 << 1) | (rank == 0 ? 1 : 0)) & 0x7;
    ctx_rank4 = ((ctx_rank4 << 2) | (rank < 3 ? rank : 3)) & 0xff;
    ctx_run = ((ctx_run << 1) | (run < 3 ? 1 : 0)) & 0xf;
  }

#ifdef TBSC_QLFC_PROF
  clock_gettime(CLOCK_MONOTONIC, &ts2);
  fprintf(stderr, "[cmenc] reset %.4f  transform %.4f  alpha %.4f  loop %.4f\n",
          (tsA.tv_sec - ts0.tv_sec) + 1e-9 * (tsA.tv_nsec - ts0.tv_nsec),
          (ts1.tv_sec - tsA.tv_sec) + 1e-9 * (ts1.tv_nsec - tsA.tv_nsec),
          (tsB.tv_sec - ts1.tv_sec) + 1e-9 * (tsB.tv_nsec - ts1.tv_nsec),
          (ts2.tv_sec - tsB.tv_sec) + 1e-9 * (ts2.tv_nsec - tsB.tv_nsec));
#endif
  return rc.finish();
}

template <bool ADAPTIVE>
static int cm_decode(const u8* input, u8* output, M1* m) {
  const Fam& F = ADAPTIVE ? kAdaptive : kStatic;
  u8 mtf[256];
  std::memcpy(m, g_m1_pristine, sizeof(M1));

  int ctx_rank0 = 0, ctx_rank4 = 0, ctx_run = 0, avg_rank = 0;
  u8 rank_hist[256], run_hist[256];
  std::memset(rank_hist, 0, sizeof rank_hist);
  std::memset(run_hist, 0, sizeof run_hist);

  RcDecoder rc;
  rc.init(input);
  int n = (int)rc.decode_word();
  int max_rank = decode_alphabet<12, 2048>(rc, mtf, true);

  for (int i = 0; i < n;) {
    int c = mtf[0];
    int hist = rank_hist[c];
    int st = rank_state_of(ctx_rank4, ctx_run, hist);

    int rank = 1;
    if (avg_rank < 32) {
      const GP& gt = F.rank_t;
      int p = group_p<ADAPTIVE>(gt, &m->mix_rank[c], m->rank_flag_c[c], m->rank_flag_s[st], m->rank_flag_p);
      u32 bit = (u32)rc.decode(p);
      group_learn<ADAPTIVE>(gt, &m->mix_rank[c], bit, m->rank_flag_s[st], m->rank_flag_c[c], m->rank_flag_p);
      if (bit) {
        // exponent
        const GP& ge = F.rank_e;
        Mixer* mx = &m->mix_rank_exp[hist < 1 ? 1 : hist][1];
        int brs = 1;
        while (brs != max_rank) {
          int pe = group_p<ADAPTIVE>(ge, mx, m->rank_exp_c[c][brs - 1], m->rank_exp_s[st][brs - 1], m->rank_exp_p[brs - 1]);
          u32 be = (u32)rc.decode(pe);
          group_learn<ADAPTIVE>(ge, mx, be, m->rank_exp_s[st][brs - 1], m->rank_exp_c[c][brs - 1], m->rank_exp_p[brs - 1]);
          if (!be) break;
          ++brs;
          mx = &m->mix_rank_exp[hist < brs ? brs : hist][brs];
        }
        rank_hist[c] = (u8)brs;
        // mantissa: context doubles along the decoded value itself
        const GP& gm = F.rank_m;
        Mixer* mmx = &m->mix_rank_man[brs];
        for (int bit_i = brs - 1; bit_i >= 0; --bit_i) {
          int pm = group_p<ADAPTIVE>(gm, mmx, m->rank_man_c[brs][c][rank], m->rank_man_s[brs][st][rank], m->rank_man_p[brs][rank]);
          u32 bm = (u32)rc.decode(pm);
          group_learn_data<ADAPTIVE>(gm, mmx, bm, m->rank_man_s[brs][st][rank], m->rank_man_c[brs][c][rank], m->rank_man_p[brs][rank]);
          rank += rank + bm;
        }
      } else {
        rank_hist[c] = 0;
      }
    } else {
      const GP& g = F.rank_p;
      rank = 0;
      for (int ctx = 1, bit_i = max_rank; bit_i >= 0; --bit_i) {
        Mixer* mx = &m->mix_rank_esc[ctx];
        int p = group_p<ADAPTIVE>(g, mx, m->rank_esc_c[c][ctx], m->rank_esc_s[st][ctx], m->rank_esc_p[ctx]);
        u32 b = (u32)rc.decode(p);
        group_learn_data<ADAPTIVE>(g, mx, b, m->rank_esc_s[st][ctx], m->rank_esc_c[c][ctx], m->rank_esc_p[ctx]);
        ctx += ctx + b;
        rank += rank + b;
      }
      rank_hist[c] = (u8)bsr((u32)(rank | 1));
    }

    // MTF table shift: entries 1..rank move up, current char sinks to `rank`.
    std::memmove(mtf, mtf + 1, (size_t)rank);
    mtf[rank] = (u8)c;

    avg_rank = (avg_rank * 124 + rank * 4) >> 7;
    rank -= 1;
    hist = run_hist[c];
    st = run_state_of(ctx_rank0, ctx_run, rank, hist);

    int run = 1;
    {
      const GP& gt = F.run_t;
      int p = group_p<ADAPTIVE>(gt, &m->mix_run[c], m->run_flag_c[c], m->run_flag_s[st], m->run_flag_p);
      u32 bit = (u32)rc.decode(p);
      group_learn<ADAPTIVE>(gt, &m->mix_run[c], bit, m->run_flag_s[st], m->run_flag_c[c], m->run_flag_p);
      if (bit) {
        const GP& ge = F.run_e;
        Mixer* mx = &m->mix_run_exp[hist < 1 ? 1 : hist][1];
        int brs = 1;
        for (;;) {
          int pe = group_p<ADAPTIVE>(ge, mx, m->run_exp_c[c][brs - 1], m->run_exp_s[st][brs - 1], m->run_exp_p[brs - 1]);
          u32 be = (u32)rc.decode(pe);
          group_learn<ADAPTIVE>(ge, mx, be, m->run_exp_s[st][brs - 1], m->run_exp_c[c][brs - 1], m->run_exp_p[brs - 1]);
          if (!be) break;
          ++brs;
          mx = &m->mix_run_exp[hist < brs ? brs : hist][brs];
        }
        run_hist[c] = (u8)((run_hist[c] + 3 * brs + 3) >> 2);
        const GP& gm = F.run_m;
        Mixer* mmx = &m->mix_run_man[brs];
        for (int ctx = 1, bit_i = brs - 1; bit_i >= 0; --bit_i) {
          int pm = group_p<ADAPTIVE>(gm, mmx, m->run_man_c[brs][c][ctx], m->run_man_s[brs][st][ctx], m->run_man_p[brs][ctx]);
          u32 bm = (u32)rc.decode(pm);
          group_learn_data<ADAPTIVE>(gm, mmx, bm, m->run_man_s[brs][st][ctx], m->run_man_c[brs][c][ctx], m->run_man_p[brs][ctx]);
          run += run + bm;
          if (brs <= 5) ctx += ctx + bm; else ctx += 1;
        }
      } else {
        run_hist[c] = (u8)((run_hist[c] + 2) >> 2);
      }
    }

    ctx_rank0 = ((ctx_rank0 << 1) | (rank == 0 ? 1 : 0)) & 0x7;
    ctx_rank4 = ((ctx_rank4 << 2) | (rank < 3 ? rank : 3)) & 0xff;
    ctx_run = ((ctx_run << 1) | (run < 3 ? 1 : 0)) & 0xf;

    std::memset(output + i, c, (size_t)run);
    i += run;
  }

  return n;
}

// ---------------------------------------------------------------------------
// Fast engine (Model2)
// ---------------------------------------------------------------------------

static int fast_encode(const u8* input, u8* output, u8* buffer, int isize, int osize, M2* m) {
  u8 mtf[256];
#ifdef TBSC_QLFC_PROF
  struct timespec ts0, ts1, ts2;
  clock_gettime(CLOCK_MONOTONIC, &ts0);
#endif
  std::memcpy(m, g_m2_pristine, sizeof(M2));

  u8* rl = buffer + isize;  // run lengths (saturated), same indexing as ranks
  int rank_off = rank_transform(input, buffer, isize, mtf, rl);
#ifdef TBSC_QLFC_PROF
  clock_gettime(CLOCK_MONOTONIC, &ts1);
#endif

  RcEncoder rc;
  rc.init(output, osize);
  rc.encode_word((u32)isize);
  encode_alphabet<1, 1>(rc, mtf, false);

  const u8* in = input;
  const u8* in_end = input + isize;
  const u8* rk = buffer + rank_off;
  const u8* rk_end = buffer + isize;
  const u8* rlq = rl + rank_off;

  while (rk < rk_end) {
    if (rc.overflow()) return TBSC_NOT_COMPRESSIBLE;

    u32 rank = *rk++;
    u32 c = *in;
    u32 run = *rlq++;
    if (__builtin_expect(run == 255, 0))
      run = (u32)(skip_run(in + 255, in_end, (u8)c) - in);
    in += run;

    {
      int16_t* pr = m->rank_exp[c];
      if (rank == 1) {
        int p = pr[0];
        upd_shift<4>(pr[0], 8016);
        rc.encode0<13>(p);
      } else {
        int p = pr[0];
        upd_shift<4>(pr[0], 83);
        rc.encode1<13>(p);
        int brs = bsr(rank);
        for (int bit = 1; bit < brs; ++bit) {
          p = pr[bit];
          upd_shift<4>(pr[bit], 122);
          rc.encode1<13>(p);
        }
        if (brs < 7) {
          p = pr[brs];
          upd_shift<4>(pr[brs], 8114);
          rc.encode0<13>(p);
        }
        int16_t* pm = m->rank_man[c][brs];
        for (u32 ctx = 1, bit = brs - 1; (int)bit >= 0; --bit) {
          u32 b = (rank >> bit) & 1;
          p = pm[ctx];
          upd_shift<7>(b, pm[ctx], 7999, 235);
          rc.encode<13>(b, p);
          ctx += ctx + b;
        }
      }
    }
    {
      int16_t* pr = m->run_exp[c];
      if (run == 1) {
        int p = pr[0];
        upd_shift<5>(pr[0], 2025);
        rc.encode0<11>(p);
      } else {
        int p = pr[0];
        upd_shift<5>(pr[0], 42);
        rc.encode1<11>(p);
        int brs = bsr(run);
        for (int bit = 1; bit < brs; ++bit) {
          p = pr[bit];
          upd_shift<4>(pr[bit], 142);
          rc.encode1<11>(p);
        }
        {
          p = pr[brs];
          upd_shift<4>(pr[brs], 1962);
          rc.encode0<11>(p);
        }
        int16_t* pm = m->run_man[c][brs];
        if (brs <= 5) {
          for (u32 ctx = 1, bit = brs - 1; (int)bit >= 0; --bit) {
            u32 b = (run >> bit) & 1;
            p = pm[ctx];
            upd_shift<6>(b, pm[ctx], 1951, 147);
            rc.encode<11>(b, p);
            ctx += ctx + b;
          }
        } else {
          for (u32 ctx = 1, bit = brs - 1; (int)bit >= 0; --bit) {
            u32 b = (run >> bit) & 1;
            p = pm[ctx];
            upd_shift<5>(b, pm[ctx], 1987, 46);
            rc.encode<11>(b, p);
            ctx += 1;
          }
        }
      }
    }
  }

#ifdef TBSC_QLFC_PROF
  clock_gettime(CLOCK_MONOTONIC, &ts2);
  fprintf(stderr, "[fastenc] transform %.4f  loop %.4f\n",
          (ts1.tv_sec - ts0.tv_sec) + 1e-9 * (ts1.tv_nsec - ts0.tv_nsec),
          (ts2.tv_sec - ts1.tv_sec) + 1e-9 * (ts2.tv_nsec - ts1.tv_nsec));
#endif
  return rc.finish();
}

static int fast_decode(const u8* input, u8* output, M2* m) {
  u8 mtf[256];
  std::memcpy(m, g_m2_pristine, sizeof(M2));

  RcDecoder rc;
  rc.init(input);
  int n = (int)rc.decode_word();
  decode_alphabet<1, 1>(rc, mtf, false);

  u8* out = output;
  const u8* out_end = output + n;

  while (out < out_end) {
    u32 c = mtf[0];
    {
      int16_t* pr = m->rank_exp[c];
      int p = pr[0];
      if (rc.decode<13>(p)) {
        upd_shift<4>(pr[0], 83);
        int brs = 1;
        while (brs < 7) {
          p = pr[brs];
          if (rc.decode<13>(p)) {
            upd_shift<4>(pr[brs], 122);
            ++brs;
          } else {
            upd_shift<4>(pr[brs], 8114);
            break;
          }
        }
        int16_t* pm = m->rank_man[c][brs];
        u32 rank = 1;
        while (--brs >= 0) {
          u32 b = (u32)rc.decode<13>(pm[rank]);
          upd_shift<7>(b, pm[rank], 7999, 235);
          rank += rank + b;
        }
        std::memmove(mtf, mtf + 1, (size_t)rank);
        mtf[rank] = (u8)c;
      } else {
        mtf[0] = mtf[1];
        mtf[1] = (u8)c;
        upd_shift<4>(pr[0], 8016);
      }
    }
    {
      int16_t* pr = m->run_exp[c];
      int p = pr[0];
      if (rc.decode<11>(p)) {
        upd_shift<5>(pr[0], 42);
        int brs = 1;
        for (;;) {
          p = pr[brs];
          if (rc.decode<11>(p)) {
            upd_shift<4>(pr[brs], 142);
            ++brs;
          } else {
            upd_shift<4>(pr[brs], 1962);
            break;
          }
        }
        int16_t* pm = m->run_man[c][brs];
        u32 run = 1;
        if (brs <= 5) {
          while (--brs >= 0) {
            u32 b = (u32)rc.decode<11>(pm[run]);
            upd_shift<6>(b, pm[run], 1951, 147);
            run += run + b;
          }
        } else {
          for (int ctx = 1; ctx <= brs; ++ctx) {
            u32 b = (u32)rc.decode<11>(pm[ctx]);
            upd_shift<5>(b, pm[ctx], 1987, 46);
            run += run + b;
          }
        }
        std::memset(out, (int)c, (size_t)run);
        out += run;
      } else {
        *out++ = (u8)c;
        upd_shift<5>(pr[0], 2025);
      }
    }
  }

  return n;
}

// ---------------------------------------------------------------------------
// Block entry points.  Scratch (rank+runlen buffer, model) is cached per
// thread: the sub-block farm calls these entry points hundreds of times per
// block, and a fresh malloc of a multi-MB model each call re-pays page
// faults that the memcpy-from-pristine reset then touches anyway.
// ---------------------------------------------------------------------------

namespace {
struct Scratch {
  u8* buf = nullptr;
  size_t cap = 0;
  M1* m1 = nullptr;
  M2* m2 = nullptr;
  ~Scratch() { free(buf); free(m1); free(m2); }
  u8* buffer(size_t bytes) {
    if (cap < bytes) {
      free(buf);
      buf = (u8*)malloc(bytes);
      cap = buf ? bytes : 0;
    }
    return buf;
  }
};
thread_local Scratch g_scratch;
}  // namespace

// Release the calling thread's cached scratch (rank buffer + multi-MB model
// snapshots).  Long-lived pool workers that are done with coder work can call
// this to return the memory; the next encode/decode call re-allocates.
void qlfc_release_scratch() {
  Scratch& s = g_scratch;
  free(s.buf);
  s.buf = nullptr;
  s.cap = 0;
  free(s.m1);
  s.m1 = nullptr;
  free(s.m2);
  s.m2 = nullptr;
}

int qlfc_encode_block(const u8* input, u8* output, int isize, int osize, int kind) {
  if (qlfc_init() != 0) return -2;
  Scratch& s = g_scratch;
  u8* buffer = s.buffer(2 * (size_t)isize);  // ranks + run lengths
  if (!buffer) return -2;
  if (kind == 3) {
    if (!s.m2) s.m2 = (M2*)malloc(sizeof(M2));
    if (!s.m2) return -2;
    return fast_encode(input, output, buffer, isize, osize, s.m2);
  }
  if (!s.m1) s.m1 = (M1*)malloc(sizeof(M1));
  if (!s.m1) return -2;
  return (kind == 2) ? cm_encode<true>(input, output, buffer, isize, osize, s.m1)
                     : cm_encode<false>(input, output, buffer, isize, osize, s.m1);
}

int qlfc_decode_block(const u8* input, u8* output, int kind) {
  if (qlfc_init() != 0) return -2;
  Scratch& s = g_scratch;
  if (kind == 3) {
    if (!s.m2) s.m2 = (M2*)malloc(sizeof(M2));
    if (!s.m2) return -2;
    return fast_decode(input, output, s.m2);
  }
  if (!s.m1) s.m1 = (M1*)malloc(sizeof(M1));
  if (!s.m1) return -2;
  return (kind == 2) ? cm_decode<true>(input, output, s.m1)
                     : cm_decode<false>(input, output, s.m1);
}

}  // namespace tbsc
