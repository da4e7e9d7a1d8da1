// CODER_QLFC_WIDE host codec (format: libbsc_tpu/ops/wide.py).
//
// A lockstep simulation over lane-state arrays — the same iteration
// structure as the TPU kernels, executed serially: every iteration codes at
// most one bit per live lane; renormalization units are appended to the
// lane's group stream in (iteration, lane) order with the +2 unit delay
// realized by per-lane position queues.  This is the fast host fallback for
// the wide profile (the numpy reference in ops/wide.py is the format spec).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace tbsc {

namespace wide {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using i64 = int64_t;

// model v2 (ops/wide.py is the spec): value-tree mantissa contexts,
// rank-history-widened exponents, rank-conditioned run flags, tuned
// priors, max-side boundary clamp.
constexpr int NCTX = 281;
constexpr int CTX_RANK_FLAG = 0;   // + rhist4
constexpr int CTX_RANK_EXP = 16;   // + (t-1) + 7*prev_rb + 21*rhist1
constexpr int CTX_RANK_MAN = 58;   // + RM_OFF[brs] + min(partial-1, 14)
constexpr int CTX_RUN_FLAG = 129;  // + 3*uhist4 + rank bucket
constexpr int CTX_RUN_EXP = 177;   // + (t-1) + 24*prev_ub
constexpr int CTX_RUN_MAN = 249;   // + 16*(brs > 3) + min(partial, 15)
constexpr int RM_OFF[9] = {0, 0, 0, 1, 4, 11, 26, 41, 56};
constexpr int RANK_EXP_CAP = 8;
constexpr int RUN_EXP_CAP = 25;
constexpr int GROUP = 128;
constexpr int DEFAULT_LANES = 1024;

static inline int bucket3(int brs) {
  if (brs <= 1) return 0;
  if (brs <= 3) return 1;
  return 2;
}



static inline int rank_bucket(int rank) {
  if (rank == 0) return 0;
  return rank <= 2 ? 1 : 2;
}

// tuned per-context priors (format constants, installed from Python)
extern int16_t g_priors[NCTX];
extern bool g_priors_set;

static inline int pick_lanes(i64 isize) {
  i64 lanes = DEFAULT_LANES;
  while (lanes > 1 && isize / lanes < 4096) lanes /= 2;
  while ((isize + lanes - 1) / lanes >= (1 << RUN_EXP_CAP)) lanes *= 2;
  return (int)(lanes < 65535 ? lanes : 65535);
}

static inline int upd(int p, int bit) {
  return bit ? p - (p >> 5) : p + ((4096 - p) >> 5);
}

// -------------------------------------------------------------------------
// per-lane state
// -------------------------------------------------------------------------

enum Phase : u8 { PH_RFLAG, PH_REXP, PH_RMAN, PH_UFLAG, PH_UEXP, PH_UMAN,
                  PH_DONE };

struct Lane {
  // coder
  u32 low = 0, rng = 0xFFFFFFFFu, code = 0;
  // model
  u16 probs[NCTX];
  u8 mtf[256];
  // schedule state
  u8 phase = PH_RFLAG;
  u8 rhist = 0, uhist = 0, prev_rb = 0, prev_ub = 0;
  int rank = 0, brs = 0, t = 0, val = 0;
  // encode-side iterators
  const u8* in = nullptr;
  const u8* in_end = nullptr;
  int cur_rank = 0, cur_run = 0;
  // decode-side output
  u8* out = nullptr;
  i64 left = 0;

  void init_model() {
    for (int i = 0; i < NCTX; ++i) probs[i] = (u16)g_priors[i];
    for (int i = 0; i < 256; ++i) mtf[i] = (u8)i;
  }
};

// context of the lane's next bit (shared by encode and decode)
static inline int ctx_of(const Lane& L) {
  switch (L.phase) {
    case PH_RFLAG: return CTX_RANK_FLAG + L.rhist;
    case PH_REXP:  return CTX_RANK_EXP + 7 * L.prev_rb
                        + 21 * (L.rhist & 1) + L.t - 1;
    case PH_RMAN:  return CTX_RANK_MAN + RM_OFF[L.brs]
                        + (L.val - 1 < 14 ? L.val - 1 : 14);
    case PH_UFLAG: return CTX_RUN_FLAG + 3 * L.uhist + rank_bucket(L.rank);
    case PH_UEXP:  return CTX_RUN_EXP + 24 * L.prev_ub + L.t - 1;
    default:       return CTX_RUN_MAN + 16 * (L.brs > 3 ? 1 : 0)
                        + (L.val < 15 ? L.val : 15);
  }
}

static inline int mtf_rank(Lane& L, u8 c) {
  int r = 0;
  u8 prev = L.mtf[0];
  if (prev == c) { return 0; }
  L.mtf[0] = c;
  for (r = 1;; ++r) {
    u8 t = L.mtf[r];
    L.mtf[r] = prev;
    if (t == c) break;
    prev = t;
  }
  return r;
}

static inline u8 mtf_pick(Lane& L, int rank) {
  u8 c = L.mtf[rank];
  std::memmove(L.mtf + 1, L.mtf, (size_t)rank);
  L.mtf[0] = c;
  return c;
}

// encode: fetch the next run and set up the schedule state; returns false
// when the lane's input is exhausted
static bool next_run_encode(Lane& L) {
  if (L.in >= L.in_end) { L.phase = PH_DONE; return false; }
  u8 c = *L.in;
  const u8* p = L.in + 1;
  while (p < L.in_end && *p == c) ++p;
  L.cur_run = (int)(p - L.in);
  L.in = p;
  L.cur_rank = mtf_rank(L, c);
  L.phase = PH_RFLAG;
  return true;
}

// the encoder's next bit given the schedule state (mirrors ops/wide.py
// _lane_bits); advances the state machine
static inline int next_bit_encode(Lane& L) {
  switch (L.phase) {
    case PH_RFLAG: {
      int bit = L.cur_rank != 0;
      L.rhist = (u8)(((L.rhist << 1) | bit) & 0xF);
      if (bit) { L.phase = PH_REXP; L.t = 1; L.brs = 1; }
      else { L.rank = 0; L.prev_rb = 0; L.phase = PH_UFLAG; }
      return bit;
    }
    case PH_REXP: {
      int brs_true = 32 - __builtin_clz((u32)L.cur_rank);
      int bit = L.brs < brs_true;
      if (bit) {
        ++L.brs; ++L.t;
        if (L.brs == RANK_EXP_CAP) { L.phase = PH_RMAN; L.t = 0; L.val = 1; }
      } else {
        L.prev_rb = (u8)bucket3(L.brs);
        if (L.brs == 1) { L.rank = 1; L.phase = PH_UFLAG; }
        else { L.phase = PH_RMAN; L.t = 0; L.val = 1; }
      }
      if (L.phase == PH_RMAN && L.brs == RANK_EXP_CAP)
        L.prev_rb = (u8)bucket3(L.brs);
      return bit;
    }
    case PH_RMAN: {
      int brs_true = 32 - __builtin_clz((u32)L.cur_rank);
      int bit = (L.cur_rank >> (brs_true - 2 - L.t)) & 1;
      L.val = (L.val << 1) | bit;
      ++L.t;
      if (L.t == brs_true - 1) { L.rank = L.cur_rank; L.phase = PH_UFLAG; }
      return bit;
    }
    case PH_UFLAG: {
      int bit = L.cur_run != 1;
      L.uhist = (u8)(((L.uhist << 1) | bit) & 0xF);
      if (bit) { L.phase = PH_UEXP; L.t = 1; L.brs = 1; }
      else { L.prev_ub = 0; next_run_encode(L); }
      return bit;
    }
    case PH_UEXP: {
      int brs_true = 32 - __builtin_clz((u32)L.cur_run);
      int bit = L.brs < brs_true;
      if (bit) {
        ++L.brs; ++L.t;
        if (L.brs == RUN_EXP_CAP) { L.phase = PH_UMAN; L.t = 0; L.val = 1;
                                    L.prev_ub = (u8)bucket3(L.brs); }
      } else {
        L.prev_ub = (u8)bucket3(L.brs);
        L.phase = PH_UMAN; L.t = 0; L.val = 1;
      }
      return bit;
    }
    default: {  // PH_UMAN
      int brs_true = 32 - __builtin_clz((u32)L.cur_run);
      int bit = (L.cur_run >> (brs_true - 2 - L.t)) & 1;
      L.val = (L.val << 1) | bit;
      ++L.t;
      if (L.t == brs_true - 1) next_run_encode(L);
      return bit;
    }
  }
}

}  // namespace wide

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using i64 = int64_t;

// -------------------------------------------------------------------------
// encode
// -------------------------------------------------------------------------

static int wide_encode_rans(const u8* input, i64 n, u8* output, i64 out_cap,
                            int n_lanes, const int32_t* sizes);

int wide_encode(const u8* input, i64 n, u8* output, i64 out_cap,
                int n_lanes, const int32_t* sizes, int rans) {
  using namespace wide;
  if (rans) return wide_encode_rans(input, n, output, out_cap, n_lanes, sizes);
  if (!g_priors_set) return -9;
  if (n <= 0) return -3;
  const int L = n_lanes > 0 ? n_lanes : pick_lanes(n);
  const i64 chunk = (n + L - 1) / L;
  const int NG = (L + GROUP - 1) / GROUP;

  std::vector<Lane> lanes(L);
  std::vector<std::vector<u16>> q(L);        // per-lane unit queues
  std::vector<std::vector<int>> events(NG);  // per-group lane-of-event list
  std::vector<i64> lsz(L);

  i64 off = 0;
  int live = 0;
  for (int k = 0; k < L; ++k) {
    Lane& ln = lanes[k];
    ln.init_model();
    i64 s = sizes ? (i64)sizes[k]
                  : (chunk < n - off ? chunk : n - off);
    lsz[k] = s;
    ln.in = input + off;
    ln.in_end = input + off + s;
    off += s;
    if (s > 0 && next_run_encode(ln)) ++live;
    else ln.phase = PH_DONE;
  }
  if (off != n) return -8;  // sizes must cover the input exactly

  i64 iters = 0;
  while (live > 0) {
    ++iters;
    for (int k = 0; k < L; ++k) {
      Lane& ln = lanes[k];
      if (ln.phase == PH_DONE) continue;
      int ctx = ctx_of(ln);
      int bit = next_bit_encode(ln);
      int p = ln.probs[ctx];
      ln.probs[ctx] = (u16)upd(p, bit);
      u32 r = (ln.rng >> 12) * (u32)p;
      if (bit) { ln.low += r; ln.rng -= r; }
      else ln.rng = r;
      if (ln.rng < (1u << 16)) {
        if (((ln.low ^ (ln.low + ln.rng - 1)) >> 16) != 0) {
          u32 lo_part = 0x10000u - (ln.low & 0xFFFFu);
          u32 hi_part = ln.rng - lo_part;
          if (hi_part > lo_part) { ln.low += lo_part; ln.rng = hi_part; }
          else ln.rng = lo_part;
        }
        q[k].push_back((u16)(ln.low >> 16));
        events[k / GROUP].push_back(k);
        ln.low <<= 16;
        ln.rng <<= 16;
      }
      if (ln.phase == PH_DONE) --live;
    }
  }
  // flush every non-empty lane (two terminating units)
  for (int k = 0; k < L; ++k) {
    if (lsz[k] == 0) continue;
    Lane& ln = lanes[k];
    for (int f = 0; f < 2; ++f) {
      q[k].push_back((u16)(ln.low >> 16));
      ln.low <<= 16;
    }
  }

  // assemble: per group, warm-up (2/lane) then q[r+2] per event; flags
  // bit 0 records an explicit lane-size table (balanced split)
  i64 total_units = 0;
  for (int k = 0; k < L; ++k) total_units += (i64)q[k].size();
  i64 need = 12 + 4 * (i64)NG + (sizes ? 4 * (i64)L : 0) + 2 * total_units;
  if (need >= n || need > out_cap) return -3;

  u8* w = output;
  auto put32 = [&](u32 v) { std::memcpy(w, &v, 4); w += 4; };
  auto put16 = [&](u16 v) { std::memcpy(w, &v, 2); w += 2; };
  put32((u32)n);
  put16((u16)L);
  put16((u16)((sizes ? 1 : 0) | 2));  // bit 1 = model v2
  put32((u32)iters);
  if (sizes)
    for (int k = 0; k < L; ++k) put32((u32)lsz[k]);
  std::vector<u32> gu(NG);
  for (int g = 0; g < NG; ++g) {
    i64 units = 0;
    int k0 = g * GROUP, k1 = (g + 1) * GROUP < L ? (g + 1) * GROUP : L;
    for (int k = k0; k < k1; ++k) units += (i64)q[k].size();
    gu[g] = (u32)units;
    put32(gu[g]);
  }
  std::vector<int> next(L, 0);
  for (int g = 0; g < NG; ++g) {
    int k0 = g * GROUP, k1 = (g + 1) * GROUP < L ? (g + 1) * GROUP : L;
    for (int k = k0; k < k1; ++k)
      if (!q[k].empty()) { put16(q[k][0]); put16(q[k][1]); next[k] = 2; }
    for (int k : events[g]) put16(q[k][next[k]++]);
    for (int k = k0; k < k1; ++k)
      if ((size_t)next[k] != q[k].size()) return -9;  // internal error
  }
  return (int)(w - output);
}

// -------------------------------------------------------------------------
// v3 encode (flags bit 2): binary rANS lanes.  Forward pass per lane
// records (prob, bit) for every scheduled bit; a reverse pass runs the
// rANS arithmetic (state in [2^16, 2^32), one u16 emitted per renorm, no
// interval clamping — the v2 coder's ~2.5% overhead); the final state is
// the decoder's two warm-up units, replacing the flush.  The decoder's
// refill at (iteration, lane) mirrors the encoder's emission at the same
// (iteration, lane), so the stream assembles in the same consumption
// order as v2 via a counting sort over refill iterations.
// -------------------------------------------------------------------------

static int wide_encode_rans(const u8* input, i64 n, u8* output, i64 out_cap,
                            int n_lanes, const int32_t* sizes) {
  using namespace wide;
  if (!g_priors_set) return -9;
  if (n <= 0) return -3;
  const int L = n_lanes > 0 ? n_lanes : pick_lanes(n);
  const i64 chunk = (n + L - 1) / L;
  const int NG = (L + GROUP - 1) / GROUP;

  std::vector<std::vector<u16>> q(L);    // per-lane units, consumption order
  std::vector<std::vector<u32>> qit(L);  // matching refill iterations (asc)
  std::vector<u32> warm(L, 0);
  std::vector<i64> lsz(L);
  std::vector<u16> pb;  // (prob << 1) | bit scratch, one lane at a time

  i64 off = 0, iters = 0;
  for (int k = 0; k < L; ++k) {
    Lane ln;
    ln.init_model();
    i64 s = sizes ? (i64)sizes[k] : (chunk < n - off ? chunk : n - off);
    lsz[k] = s;
    ln.in = input + off;
    ln.in_end = input + off + s;
    off += s;
    pb.clear();
    if (s > 0 && next_run_encode(ln)) {
      while (ln.phase != PH_DONE) {
        int ctx = ctx_of(ln);
        int bit = next_bit_encode(ln);
        int p = ln.probs[ctx];
        ln.probs[ctx] = (u16)upd(p, bit);
        pb.push_back((u16)((p << 1) | bit));
      }
    }
    const i64 nb = (i64)pb.size();
    if (nb > iters) iters = nb;
    if (nb == 0) continue;
    // reverse rANS pass; emissions collected in reverse order
    u32 x = 1u << 16;
    std::vector<u16>& units = q[k];
    std::vector<u32>& its = qit[k];
    for (i64 i = nb - 1; i >= 0; --i) {
      u32 p = pb[i] >> 1;
      u32 f = (pb[i] & 1) ? 4096u - p : p;
      u32 base = (pb[i] & 1) ? p : 0;
      if (x >= (f << 20)) {
        units.push_back((u16)(x & 0xFFFFu));
        its.push_back((u32)i);
        x >>= 16;
      }
      x = ((x / f) << 12) + (x % f) + base;
    }
    warm[k] = x;
    // consumption order is ascending iteration = reverse of emission
    std::reverse(units.begin(), units.end());
    std::reverse(its.begin(), its.end());
  }
  if (off != n) return -8;

  i64 total_units = 0;
  for (int k = 0; k < L; ++k) total_units += (i64)q[k].size() + (lsz[k] ? 2 : 0);
  i64 need = 12 + 4 * (i64)NG + (sizes ? 4 * (i64)L : 0) + 2 * total_units;
  if (need >= n || need > out_cap) return -3;

  u8* w = output;
  auto put32 = [&](u32 v) { std::memcpy(w, &v, 4); w += 4; };
  auto put16 = [&](u16 v) { std::memcpy(w, &v, 2); w += 2; };
  put32((u32)n);
  put16((u16)L);
  put16((u16)((sizes ? 1 : 0) | 2 | 4));  // bit 1 = model v2, bit 2 = rANS
  put32((u32)iters);
  if (sizes)
    for (int k = 0; k < L; ++k) put32((u32)lsz[k]);
  for (int g = 0; g < NG; ++g) {
    i64 units = 0;
    int k0 = g * GROUP, k1 = (g + 1) * GROUP < L ? (g + 1) * GROUP : L;
    for (int k = k0; k < k1; ++k) units += (i64)q[k].size() + (lsz[k] ? 2 : 0);
    put32((u32)units);
  }
  std::vector<u32> cnt;
  for (int g = 0; g < NG; ++g) {
    int k0 = g * GROUP, k1 = (g + 1) * GROUP < L ? (g + 1) * GROUP : L;
    for (int k = k0; k < k1; ++k)
      if (lsz[k]) { put16((u16)(warm[k] >> 16)); put16((u16)warm[k]); }
    // counting sort of the group's units by refill iteration (stable in k)
    cnt.assign((size_t)iters + 1, 0);
    for (int k = k0; k < k1; ++k)
      for (u32 it : qit[k]) ++cnt[it];
    u32 pos = 0;
    for (i64 i = 0; i <= iters; ++i) { u32 c = cnt[i]; cnt[i] = pos; pos += c; }
    u16* base16 = (u16*)w;
    for (int k = k0; k < k1; ++k) {
      const std::vector<u16>& units = q[k];
      const std::vector<u32>& its = qit[k];
      for (size_t j = 0; j < units.size(); ++j) {
        u16 v = units[j];
        std::memcpy(base16 + cnt[its[j]], &v, 2);
        ++cnt[its[j]];
      }
    }
    w += 2 * (i64)pos;
  }
  return (int)(w - output);
}

// -------------------------------------------------------------------------
// balanced lane sizes: split at run boundaries so each lane carries about
// the same number of runs (the reference's rank-change balancing,
// coder.cpp:70-109, scaled to wide lanes).  Returns 0.
// -------------------------------------------------------------------------

int wide_balanced_sizes(const u8* input, i64 n, int n_lanes,
                        int32_t* sizes_out) {
  using namespace wide;
  const int L = n_lanes;
  // lanes only need run lengths < 2^RUN_EXP_CAP, so the byte cap can be
  // generous: sparse (runny) regions legitimately want big lanes
  i64 cap = ((n + L - 1) / L) * 16;
  if (cap >= (i64)1 << RUN_EXP_CAP) cap = ((i64)1 << RUN_EXP_CAP) - 1;
  if (n <= 0) return -1;

  // Estimated coded bits per run under a GLOBAL MTF walk (lane resets make
  // the true value split-dependent; the proxy only drives balancing).
  auto run_bits = [](int rank, i64 len) -> i64 {
    i64 b = 1;  // rank flag
    if (rank) {
      int brs = 32 - __builtin_clz((u32)rank);
      b += (brs - 1) + (brs < RANK_EXP_CAP ? 1 : 0);  // unary exponent
      b += brs - 1;                                   // mantissa
    }
    b += 1;  // run flag
    if (len != 1) {
      int brs = 64 - __builtin_clzll((unsigned long long)len);
      b += (brs - 1) + (brs < RUN_EXP_CAP ? 1 : 0);
      b += brs - 1;
    }
    return b;
  };

  Lane gl;
  gl.init_model();
  // prefix bits at each run START position
  std::vector<i64> rstart;
  std::vector<i64> rbits;
  rstart.reserve(1 << 16);
  rbits.reserve(1 << 16);
  i64 total_bits = 0;
  {
    i64 i = 0;
    while (i < n) {
      u8 c = input[i];
      i64 j = i + 1;
      while (j < n && input[j] == c) ++j;
      int rank = mtf_rank(gl, c);
      rstart.push_back(i);
      rbits.push_back(total_bits);
      total_bits += run_bits(rank, j - i);
      i = j;
    }
  }
  const i64 R = (i64)rstart.size();

  i64 pos = 0, ri = 0;
  i64 bits_done = 0;
  for (int k = 0; k < L; ++k) {
    i64 lanes_left = L - k;
    if (pos >= n) { sizes_out[k] = 0; continue; }
    if (lanes_left == 1) {
      if (n - pos >= cap) return -1;
      sizes_out[k] = (int32_t)(n - pos);
      pos = n;
      continue;
    }
    i64 target = (total_bits - bits_done) / lanes_left;
    i64 start = pos;
    // advance whole runs until the bit target or the byte cap
    while (ri < R) {
      i64 rend = (ri + 1 < R) ? rstart[ri + 1] : n;
      i64 taken_bits = ((ri + 1 < R) ? rbits[ri + 1] : total_bits) - bits_done;
      if (rend - start >= cap) break;
      ++ri;
      pos = rend;
      if (taken_bits >= target) break;
    }
    if (pos == start) {  // a single run exceeds the cap: split it mid-run
      pos = start + cap - 1;
      if (pos > n) pos = n;
      // skip runs fully consumed
      while (ri < R && ((ri + 1 < R) ? rstart[ri + 1] : n) <= pos) ++ri;
    }
    // feasibility for the tail
    i64 need = (n - pos) - (lanes_left - 1) * (cap - 1);
    if (need > 0) {
      i64 grow = need < (cap - 1) - (pos - start)
                     ? need : (cap - 1) - (pos - start);
      if (grow > 0) pos += grow;
      if (pos > n) pos = n;
      while (ri < R && ((ri + 1 < R) ? rstart[ri + 1] : n) <= pos) ++ri;
    }
    bits_done = (ri < R) ? rbits[ri] : total_bits;
    sizes_out[k] = (int32_t)(pos - start);
  }
  return pos == n ? 0 : -1;
}

// -------------------------------------------------------------------------
// runs + MTF ranks prep (device-coder front half): per lane, extract runs
// and their MTF ranks into [L, cap] row-major arrays padded with -1.
// Returns the maximum run count over lanes (or -1 if cap is too small).
// -------------------------------------------------------------------------

int wide_ranks(const u8* input, i64 n, int n_lanes, int cap,
               int32_t* ranks_out, int32_t* lens_out, int32_t* nruns_out) {
  using namespace wide;
  const int L = n_lanes > 0 ? n_lanes : pick_lanes(n);
  const i64 chunk = (n + L - 1) / L;
  int maxr = 0;
  for (int k = 0; k < L; ++k) {
    i64 start = (i64)k * chunk;
    i64 s = start < n ? ((n - start) < chunk ? (n - start) : chunk) : 0;
    const u8* in = input + start;
    const u8* end = in + s;
    u8 mtf[256];
    for (int i = 0; i < 256; ++i) mtf[i] = (u8)i;
    int nr = 0;
    int32_t* rk = ranks_out + (i64)k * cap;
    int32_t* rl = lens_out + (i64)k * cap;
    while (in < end) {
      u8 c = *in;
      const u8* p = in + 1;
      while (p < end && *p == c) ++p;
      if (nr >= cap) return -1;
      // inline MTF rank
      int r = 0;
      if (mtf[0] != c) {
        u8 prev = mtf[0];
        mtf[0] = c;
        for (r = 1;; ++r) {
          u8 t = mtf[r];
          mtf[r] = prev;
          if (t == c) break;
          prev = t;
        }
      }
      rk[nr] = r;
      rl[nr] = (int32_t)(p - in);
      ++nr;
      in = p;
    }
    for (int i = nr; i < cap; ++i) { rk[i] = -1; rl[i] = -1; }
    nruns_out[k] = nr;
    if (nr > maxr) maxr = nr;
  }
  return maxr;
}

// -------------------------------------------------------------------------
// bit-schedule planes (device-coder prep): for each lane, the (ctx, bit)
// sequence written lane-major ([L, cap] u8 rows, 255-padded).  Returns the
// maximum bit count over lanes, or -1 if cap is too small.
// -------------------------------------------------------------------------

// Packed variant: per lane, emit ONLY the bit stream as 2-bit fields
// (bit, active=1), 4 iterations per byte — the device kernel derives the
// contexts itself.  cap4 = bytes per lane (covers cap4*4 iterations).
// On overflow, lanes past cap4*4 bits keep walking WITHOUT writing so the
// true maximum is still counted, and the return is -(maxbits) - 1: one
// retry can then size the buffer exactly instead of doubling blind.
int wide_schedule_packed(const u8* input, i64 n, int n_lanes, int cap4,
                         u8* packed_out, const int32_t* sizes) {
  using namespace wide;
  const int L = n_lanes > 0 ? n_lanes : pick_lanes(n);
  const i64 chunk = (n + L - 1) / L;
  const i64 capbits = (i64)cap4 * 4;
  i64 maxbits = 0;
  bool overflow = false;
  i64 run_start = 0;
  for (int k = 0; k < L; ++k) {
    i64 start, s;
    if (sizes) { start = run_start; s = sizes[k]; run_start += s; }
    else {
      start = (i64)k * chunk;
      s = start < n ? ((n - start) < chunk ? (n - start) : chunk) : 0;
    }
    Lane ln;
    ln.init_model();
    ln.in = input + start;
    ln.in_end = input + start + s;
    u8* po = packed_out + (i64)k * cap4;
    std::memset(po, 0, (size_t)cap4);
    i64 nb = 0;
    if (s > 0 && next_run_encode(ln)) {
      while (ln.phase != PH_DONE) {
        int fld = next_bit_encode(ln) | 2;  // bit | active
        if (nb < capbits)
          po[nb >> 2] = (u8)(po[nb >> 2] | (fld << ((nb & 3) * 2)));
        else
          overflow = true;
        ++nb;
      }
    }
    if (nb > maxbits) maxbits = nb;
  }
  return overflow ? (int)(-maxbits - 1) : (int)maxbits;
}

int wide_schedule(const u8* input, i64 n, int n_lanes, int cap,
                  u8* ctx_out, u8* bit_out, const int32_t* sizes) {
  using namespace wide;
  const int L = n_lanes > 0 ? n_lanes : pick_lanes(n);
  const i64 chunk = (n + L - 1) / L;
  i64 maxbits = 0;
  i64 run_start = 0;
  for (int k = 0; k < L; ++k) {
    i64 start, s;
    if (sizes) { start = run_start; s = sizes[k]; run_start += s; }
    else {
      start = (i64)k * chunk;
      s = start < n ? ((n - start) < chunk ? (n - start) : chunk) : 0;
    }
    Lane ln;
    ln.init_model();
    ln.in = input + start;
    ln.in_end = input + start + s;
    u8* co = ctx_out + (i64)k * cap;
    u8* bo = bit_out + (i64)k * cap;
    i64 nb = 0;
    if (s > 0 && next_run_encode(ln)) {
      while (ln.phase != PH_DONE) {
        if (nb >= cap) return -1;
        // split encoding (NCTX > 255): ctx low byte in the ctx plane, the
        // ctx high bit in bit-plane bit 1; bit-plane bit 7 marks inactive
        int c = ctx_of(ln);
        co[nb] = (u8)(c & 0xFF);
        bo[nb] = (u8)(next_bit_encode(ln) | ((c >> 8) << 1));
        ++nb;
      }
    }
    std::memset(co + nb, 255, (size_t)(cap - nb));
    std::memset(bo + nb, 128, (size_t)(cap - nb));
    if (nb > maxbits) maxbits = nb;
  }
  return (int)maxbits;
}

// -------------------------------------------------------------------------
// decode
// -------------------------------------------------------------------------

int wide_decode(const u8* payload, i64 psize, u8* output, i64 out_cap) {
  using namespace wide;
  if (!g_priors_set) return -9;
  if (psize < 12) return -5;
  u32 isize;
  u16 L16, flags;
  std::memcpy(&isize, payload, 4);
  std::memcpy(&L16, payload + 4, 2);
  std::memcpy(&flags, payload + 6, 2);
  // payload + 8: u32 max_bits (used by lockstep decoders; ignored here)
  const int L = L16;
  if (!(flags & 2)) return -6;  // pre-v2 payloads are not decodable
  const bool rans = (flags & 4) != 0;  // v3: binary rANS lanes
  if (L == 0 || (i64)isize > out_cap) return -5;
  const i64 n = (i64)isize;
  const i64 chunk = (n + L - 1) / L;
  const int NG = (L + GROUP - 1) / GROUP;
  i64 hdr = 12 + ((flags & 1) ? 4 * (i64)L : 0);
  if (psize < hdr + 4 * (i64)NG) return -5;
  std::vector<i64> lsz(L);
  if (flags & 1) {
    i64 sum = 0;
    for (int k = 0; k < L; ++k) {
      u32 v;
      std::memcpy(&v, payload + 12 + 4 * (i64)k, 4);
      lsz[k] = v;
      sum += v;
    }
    if (sum != n) return -5;
  } else {
    i64 left = n;
    for (int k = 0; k < L; ++k) {
      lsz[k] = left < chunk ? left : chunk;
      left -= lsz[k];
    }
  }

  std::vector<const u8*> gp(NG);   // group read cursors
  std::vector<const u8*> gend(NG);  // group stream ends (corruption guard)
  {
    const u8* s = payload + hdr + 4 * (i64)NG;
    for (int g = 0; g < NG; ++g) {
      u32 units;
      std::memcpy(&units, payload + hdr + 4 * (i64)g, 4);
      gp[g] = s;
      s += 2 * (i64)units;
      if (s > payload + psize) return -5;
      gend[g] = s;
    }
  }
  bool overrun = false;
  auto get16 = [&](int g) -> u32 {
    if (gp[g] + 2 > gend[g]) { overrun = true; return 0; }
    u16 v;
    std::memcpy(&v, gp[g], 2);
    gp[g] += 2;
    return v;
  };

  std::vector<Lane> lanes(L);
  int live = 0;
  {
    i64 start = 0;
    for (int k = 0; k < L; ++k) {
      Lane& ln = lanes[k];
      ln.init_model();
      ln.left = lsz[k];
      ln.out = output + start;
      start += lsz[k];
      if (ln.left > 0) { ln.phase = PH_RFLAG; ++live; }
      else ln.phase = PH_DONE;
    }
  }
  for (int k = 0; k < L; ++k) {
    if (lanes[k].phase == PH_DONE) continue;
    int g = k / GROUP;
    u32 w0 = get16(g);  // sequenced: operand order of | is unspecified and
    u32 w1 = get16(g);  // both calls advance the group cursor
    lanes[k].code = (w0 << 16) | w1;
  }

  std::vector<int> refills;
  refills.reserve(L);
  while (live > 0) {
    refills.clear();
    for (int k = 0; k < L; ++k) {
      Lane& ln = lanes[k];
      if (ln.phase == PH_DONE) continue;
      int ctx = ctx_of(ln);
      int p = ln.probs[ctx];
      int bit;
      if (rans) {
        u32 x = ln.code;
        u32 slot = x & 0xFFFu;
        u32 hi = x >> 12;
        if (slot < (u32)p) { bit = 0; x = (u32)p * hi + slot; }
        else { bit = 1; x = (4096u - (u32)p) * hi + slot - (u32)p; }
        ln.code = x;
        ln.probs[ctx] = (u16)upd(p, bit);
        if (x < (1u << 16)) refills.push_back(k);
      } else {
        u32 r = (ln.rng >> 12) * (u32)p;
        bit = (u32)(ln.code - ln.low) >= r;
        if (bit) { ln.low += r; ln.rng -= r; }
        else ln.rng = r;
        ln.probs[ctx] = (u16)upd(p, bit);
        if (ln.rng < (1u << 16)) {
          if (((ln.low ^ (ln.low + ln.rng - 1)) >> 16) != 0) {
            u32 lo_part = 0x10000u - (ln.low & 0xFFFFu);
            u32 hi_part = ln.rng - lo_part;
            if (hi_part > lo_part) { ln.low += lo_part; ln.rng = hi_part; }
            else ln.rng = lo_part;
          }
          ln.low <<= 16;
          ln.rng <<= 16;
          refills.push_back(k);
        }
      }

      // state machine (mirror of the encoder's schedule)
      switch (ln.phase) {
        case PH_RFLAG:
          ln.rhist = (u8)(((ln.rhist << 1) | bit) & 0xF);
          if (bit) { ln.phase = PH_REXP; ln.t = 1; ln.brs = 1; }
          else { ln.rank = 0; ln.prev_rb = 0; ln.phase = PH_UFLAG; }
          break;
        case PH_REXP:
          if (bit) {
            ++ln.brs; ++ln.t;
            if (ln.brs == RANK_EXP_CAP) {
              ln.prev_rb = (u8)bucket3(ln.brs);
              ln.phase = PH_RMAN; ln.val = 1; ln.t = 0;
            }
          } else {
            ln.prev_rb = (u8)bucket3(ln.brs);
            if (ln.brs == 1) { ln.rank = 1; ln.phase = PH_UFLAG; }
            else { ln.phase = PH_RMAN; ln.val = 1; ln.t = 0; }
          }
          break;
        case PH_RMAN:
          ln.val = (ln.val << 1) | bit;
          ++ln.t;
          if (ln.t == ln.brs - 1) { ln.rank = ln.val; ln.phase = PH_UFLAG; }
          break;
        case PH_UFLAG:
          ln.uhist = (u8)(((ln.uhist << 1) | bit) & 0xF);
          if (bit) { ln.phase = PH_UEXP; ln.t = 1; ln.brs = 1; }
          else {
            ln.prev_ub = 0;
            u8 c = mtf_pick(ln, ln.rank);
            *ln.out++ = c;
            if (--ln.left <= 0) { ln.phase = PH_DONE; --live; }
            else ln.phase = PH_RFLAG;
          }
          break;
        case PH_UEXP:
          if (bit) {
            ++ln.brs; ++ln.t;
            if (ln.brs == RUN_EXP_CAP) {
              ln.prev_ub = (u8)bucket3(ln.brs);
              ln.phase = PH_UMAN; ln.val = 1; ln.t = 0;
            }
          } else {
            ln.prev_ub = (u8)bucket3(ln.brs);
            ln.phase = PH_UMAN; ln.val = 1; ln.t = 0;
          }
          break;
        default: {  // PH_UMAN
          ln.val = (ln.val << 1) | bit;
          ++ln.t;
          if (ln.t == ln.brs - 1) {
            u8 c = mtf_pick(ln, ln.rank);
            int run = ln.val;
            if (run > ln.left) return -5;
            std::memset(ln.out, c, (size_t)run);
            ln.out += run;
            ln.left -= run;
            if (ln.left <= 0) { ln.phase = PH_DONE; --live; }
            else ln.phase = PH_RFLAG;
          }
          break;
        }
      }
    }
    for (int k : refills) {
      Lane& ln = lanes[k];
      ln.code = (ln.code << 16) | get16(k / GROUP);
    }
    if (overrun) return -5;
  }
  return (int)n;
}

namespace wide {
int16_t g_priors[NCTX];
bool g_priors_set = false;
}  // namespace wide

int wide_set_priors(const int16_t* p) {
  for (int i = 0; i < wide::NCTX; ++i) wide::g_priors[i] = p[i];
  wide::g_priors_set = true;
  return 0;
}

}  // namespace tbsc
