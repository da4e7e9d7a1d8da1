/* The static QLFC encoder of the benchmark's reference (qlfc.py's
 * encode_spec) as the same loops in plain C, for the reference's speed.
 *
 * Departures from the Python, none of them in the arithmetic:
 * - the range coder's low and range are int64_t where Python's ints are
 *   unbounded; they stay below 2^33 in magnitude, so every value is the
 *   same.  A shift right of a negative number is arithmetic here (gcc,
 *   clang), which is Python's floor; shifts left go through uint64_t.
 * - units go to a caller's buffer of `cap` units; passing it returns -2
 *   (the Python list grows).  The budget check is the Python's.
 * - the model's counters are int32_t arrays, the Python's np.int32.
 *
 * Build: cc -O2 -shared -fPIC -o qlfc_static.so qlfc_static.c
 */

#include <stdint.h>
#include <stdlib.h>

typedef struct {
  uint16_t *out;
  int64_t n, cap, max_units;
  int64_t low, range, cache, pending;
  int err;
} Rc;

static void rc_put(Rc *rc, int64_t unit) {
  if (rc->n >= rc->cap) {
    rc->err = 1;
    return;
  }
  rc->out[rc->n++] = (uint16_t)(unit & 0xFFFF);
}

static void rc_shift(Rc *rc) {
  int64_t lo32 = rc->low & 0xFFFFFFFFLL;
  int64_t carry = rc->low >> 32;
  if (lo32 < 0xFFFF0000LL || carry) {
    rc_put(rc, rc->cache + carry);
    while (rc->pending) {
      rc_put(rc, carry - 1);
      rc->pending -= 1;
    }
    rc->cache = lo32 >> 16;
  } else {
    rc->pending += 1;
  }
  rc->low = (int64_t)(((uint64_t)lo32 << 16) & 0xFFFFFFFFULL);
  rc->range = (int64_t)(((uint64_t)rc->range << 16) & 0xFFFFFFFFULL);
}

static void rc_encode0(Rc *rc, int64_t p) {
  if (rc->range < 0x10000) rc_shift(rc);
  rc->range = (rc->range >> 12) * p;
}

static void rc_encode1(Rc *rc, int64_t p) {
  if (rc->range < 0x10000) rc_shift(rc);
  int64_t r = (rc->range >> 12) * p;
  rc->low += r;
  rc->range -= r;
}

static void rc_encode(Rc *rc, int bit, int64_t p) {
  if (bit)
    rc_encode1(rc, p);
  else
    rc_encode0(rc, p);
}

static void rc_finish(Rc *rc) {
  if (rc->range < 0x10000) rc_shift(rc);
  rc_shift(rc);
  rc_shift(rc);
  rc_shift(rc);
}

static int i16(int x) { return ((x + 0x8000) & 0xFFFF) - 0x8000; }

static int bsr(int64_t x) {
  int b = -1;
  while (x > 0) {
    x >>= 1;
    b += 1;
  }
  return b;
}

static int upd0(int p, int th, int ar) {
  return i16(p + (((4096 - th - p) * ar) >> 12));
}

static int upd1(int p, int th, int ar) {
  return i16(p - (((p - th) * ar) >> 12));
}

static int upd(int bit, int p, int th0, int ar0, int th1, int ar1) {
  int d0 = p * ar0 - ((4096 - th0) * ar0 - 4095);
  int d1 = p * ar1 - th1 * ar1;
  return i16(p - ((bit ? d1 : d0) >> 12));
}

/* a group: s (th0, ar0, th1, ar1), c (...), p (...), weights of c, s, p */
typedef struct {
  int s[4], c[4], p[4], w[3];
} Group;

static const Group RANK_T = {{-116, 33, -78, 34}, {-2, 282, 12, 274}, {4, 697, 55, 1185}, {17, 14, 1}};
static const Group RANK_E = {{-177, 23, -370, 11}, {-14, 271, 3, 308}, {-3, 788, 135, 1364}, {22, 6, 4}};
static const Group RANK_M = {{-254, 16, -177, 20}, {-55, 73, -54, 74}, {-6, 575, 1670, 1173}, {15, 10, 7}};
static const Group RANK_P = {{-126, 32, -126, 32}, {-33, 120, -25, 157}, {-6, 585, 150, 275}, {16, 11, 5}};
static const Group RUN_T = {{-68, 38, -112, 36}, {-4, 221, -13, 231}, {0, 0, 0, 0}, {14, 18, 0}};
static const Group RUN_E = {{-90, 45, -92, 44}, {-3, 325, -11, 341}, {24, 887, -4, 765}, {14, 15, 3}};
static const Group RUN_M = {{-275, 14, -185, 22}, {-18, 191, -15, 241}, {-73, 54, -214, 19}, {7, 15, 10}};

static int prob(const Group *g, int pc, int ps, int pp) {
  return (pc * g->w[0] + ps * g->w[1] + pp * g->w[2]) >> 5;
}

static void learn(const Group *g, int bit, int32_t *s, int32_t *c,
                  int32_t *p) {
  if (bit) {
    *s = upd1(*s, g->s[2], g->s[3]);
    *c = upd1(*c, g->c[2], g->c[3]);
    *p = upd1(*p, g->p[2], g->p[3]);
  } else {
    *s = upd0(*s, g->s[0], g->s[1]);
    *c = upd0(*c, g->c[0], g->c[1]);
    *p = upd0(*p, g->p[0], g->p[1]);
  }
}

static void learn_fused(const Group *g, int bit, int32_t *s, int32_t *c,
                        int32_t *p) {
  *s = upd(bit, *s, g->s[0], g->s[1], g->s[2], g->s[3]);
  *c = upd(bit, *c, g->c[0], g->c[1], g->c[2], g->c[3]);
  *p = upd(bit, *p, g->p[0], g->p[1], g->p[2], g->p[3]);
}

/* the model's counters, in one allocation */
#define N_RANK_FLAG_S 256
#define N_RANK_FLAG_C 256
#define N_RANK_EXP_P 8
#define N_RANK_EXP_S (256 * 8)
#define N_RANK_EXP_C (256 * 8)
#define N_RANK_MAN_P (8 * 256)
#define N_RANK_MAN_S (8 * 256 * 256)
#define N_RANK_MAN_C (8 * 256 * 256)
#define N_RANK_ESC_P 256
#define N_RANK_ESC_S (256 * 256)
#define N_RANK_ESC_C (256 * 256)
#define N_RUN_FLAG_S 256
#define N_RUN_FLAG_C 256
#define N_RUN_EXP_P 32
#define N_RUN_EXP_S (256 * 32)
#define N_RUN_EXP_C (256 * 32)
#define N_RUN_MAN_P (32 * 32)
#define N_RUN_MAN_S (32 * 256 * 32)
#define N_RUN_MAN_C (32 * 256 * 32)
#define N_MODEL                                                            \
  (2 + N_RANK_FLAG_S + N_RANK_FLAG_C + N_RANK_EXP_P + N_RANK_EXP_S +      \
   N_RANK_EXP_C + N_RANK_MAN_P + N_RANK_MAN_S + N_RANK_MAN_C +            \
   N_RANK_ESC_P + N_RANK_ESC_S + N_RANK_ESC_C + N_RUN_FLAG_S +            \
   N_RUN_FLAG_C + N_RUN_EXP_P + N_RUN_EXP_S + N_RUN_EXP_C + N_RUN_MAN_P + \
   N_RUN_MAN_S + N_RUN_MAN_C)

/* ranks[k] of each run k (the caller's n ints), mtf the final table;
 * returns the run count */
static int64_t rank_transform(const uint8_t *data, int64_t n, int *ranks,
                              int mtf[256]) {
  int seen[256] = {0};
  int64_t k = 0;
  for (int r = 0; r < 256; ++r) mtf[r] = r;
  if (data[n - 1] == 0) {
    mtf[0] = 1;
    mtf[1] = 0;
  }
  int n_sym = 0;
  int64_t i = n - 1;
  while (i >= 0) {
    int c = data[i];
    i -= 1;
    while (i >= 0 && data[i] == c) i -= 1;
    int prev = mtf[0];
    int rank = 1;
    mtf[0] = c;
    for (;;) {
      int t = mtf[rank];
      mtf[rank] = prev;
      if (t == c) break;
      prev = t;
      rank += 1;
    }
    if (!seen[c]) {
      seen[c] = 1;
      rank = n_sym;
      n_sym += 1;
    }
    ranks[k++] = rank;
  }
  for (int64_t a = 0, b = k - 1; a < b; ++a, --b) {
    int t = ranks[a];
    ranks[a] = ranks[b];
    ranks[b] = t;
  }
  ranks[k - 1] = 1; /* buffer[n-1] = 1 sentinel; never consumed as a rank */
  for (int r = 1; r < 256; ++r) {
    if (!seen[mtf[r]]) {
      mtf[r] = mtf[r - 1];
      break;
    }
  }
  return k;
}

static int encode_alphabet(Rc *rc, const int mtf[256]) {
  int used[256] = {0};
  int max_rank = 7, prev = -1;
  for (int r = 0; r < 256; ++r) {
    int cur = mtf[r];
    for (int bit = 7; bit >= 0; --bit) {
      int b0 = 0, b1 = 0;
      for (int c = 0; c < 256; ++c) {
        if (c == prev || !used[c]) {
          if ((cur >> (bit + 1)) == (c >> (bit + 1))) {
            if ((c >> bit) & 1)
              b1 = 1;
            else
              b0 = 1;
            if (b0 && b1) break;
          }
        }
      }
      if (b0 && b1) rc_encode(rc, (cur >> bit) & 1, 2048);
    }
    if (cur == prev) {
      max_rank = r > 1 ? bsr(r - 1) : 0;
      break;
    }
    prev = cur;
    used[cur] = 1;
  }
  return max_rank;
}

/* Units of data[0, isize) into out[0, cap): their count, -1 when they
 * pass osize's budget (the Python's None), -2 past cap, -3 out of
 * memory.  rank_state[32768] and run_state[8192] are the format's. */
int64_t qlfc_static_encode(const uint8_t *data, int64_t isize, int64_t osize,
                           uint16_t *out, int64_t cap,
                           const uint8_t *rank_state,
                           const uint8_t *run_state) {
  if (isize < 1) return -2;
  int32_t *model = (int32_t *)malloc(sizeof(int32_t) * N_MODEL);
  int *ranks = (int *)malloc(sizeof(int) * (size_t)isize);
  if (!model || !ranks) {
    free(model);
    free(ranks);
    return -3;
  }
  for (int64_t i = 0; i < N_MODEL; ++i) model[i] = 2048;
  int32_t *q = model;
  int32_t *rank_flag_p = q++;
  int32_t *run_flag_p = q++;
  int32_t *rank_flag_s = q; q += N_RANK_FLAG_S;
  int32_t *rank_flag_c = q; q += N_RANK_FLAG_C;
  int32_t *rank_exp_p = q; q += N_RANK_EXP_P;
  int32_t *rank_exp_s = q; q += N_RANK_EXP_S;
  int32_t *rank_exp_c = q; q += N_RANK_EXP_C;
  int32_t *rank_man_p = q; q += N_RANK_MAN_P;
  int32_t *rank_man_s = q; q += N_RANK_MAN_S;
  int32_t *rank_man_c = q; q += N_RANK_MAN_C;
  int32_t *rank_esc_p = q; q += N_RANK_ESC_P;
  int32_t *rank_esc_s = q; q += N_RANK_ESC_S;
  int32_t *rank_esc_c = q; q += N_RANK_ESC_C;
  int32_t *run_flag_s = q; q += N_RUN_FLAG_S;
  int32_t *run_flag_c = q; q += N_RUN_FLAG_C;
  int32_t *run_exp_p = q; q += N_RUN_EXP_P;
  int32_t *run_exp_s = q; q += N_RUN_EXP_S;
  int32_t *run_exp_c = q; q += N_RUN_EXP_C;
  int32_t *run_man_p = q; q += N_RUN_MAN_P;
  int32_t *run_man_s = q; q += N_RUN_MAN_S;
  int32_t *run_man_c = q; q += N_RUN_MAN_C;

  int ctx_rank0 = 0, ctx_rank4 = 0, ctx_run = 0, avg_rank = 0;
  int rank_hist[256] = {0}, run_hist[256] = {0};
  int mtf[256];
  int64_t n_runs = rank_transform(data, isize, ranks, mtf);

  Rc rc = {out, 0, cap, osize >= 16 ? (osize - 16) / 2 : 0,
           0, 0xFFFFFFFFLL, 0, 0, 0};
  for (int b = 31; b >= 0; --b) rc_encode(&rc, (int)((isize >> b) & 1), 2048);
  int max_rank = encode_alphabet(&rc, mtf);

  int64_t pos = 0;
  int64_t result = -1;
  for (int64_t ri = 0; ri < n_runs; ++ri) {
    if (rc.n >= rc.max_units) goto done;
    if (rc.err) break;

    int c = data[pos];
    int64_t run_start = pos;
    pos += 1;
    while (pos < isize && data[pos] == c) pos += 1;
    int64_t run = pos - run_start;

    int rank = ranks[ri];
    int hist = rank_hist[c];
    int st = rank_state[(ctx_run << 11) | (ctx_rank4 << 3) | hist];
    const Group *g;
    int p;

    if (avg_rank < 32) {
      g = &RANK_T;
      p = prob(g, rank_flag_c[c], rank_flag_s[st], *rank_flag_p);
      int bit = rank != 1;
      learn(g, bit, &rank_flag_s[st], &rank_flag_c[c], rank_flag_p);
      rc_encode(&rc, bit, p);
      if (rank == 1) {
        rank_hist[c] = 0;
      } else {
        int brs = bsr(rank);
        rank_hist[c] = brs;
        g = &RANK_E;
        int bit_i = 1;
        while (bit_i < brs) {
          int j = bit_i - 1;
          p = prob(g, rank_exp_c[c * 8 + j], rank_exp_s[st * 8 + j], rank_exp_p[j]);
          learn(g, 1, &rank_exp_s[st * 8 + j], &rank_exp_c[c * 8 + j], &rank_exp_p[j]);
          rc_encode1(&rc, p);
          bit_i += 1;
        }
        if (brs < max_rank) {
          int j = bit_i - 1;
          p = prob(g, rank_exp_c[c * 8 + j], rank_exp_s[st * 8 + j], rank_exp_p[j]);
          learn(g, 0, &rank_exp_s[st * 8 + j], &rank_exp_c[c * 8 + j], &rank_exp_p[j]);
          rc_encode0(&rc, p);
        }
        g = &RANK_M;
        int ctx = 1;
        for (bit_i = brs - 1; bit_i >= 0; --bit_i) {
          int b = (rank >> bit_i) & 1;
          int32_t *ms = &rank_man_s[(brs * 256 + st) * 256 + ctx];
          int32_t *mc = &rank_man_c[(brs * 256 + c) * 256 + ctx];
          int32_t *mp = &rank_man_p[brs * 256 + ctx];
          p = prob(g, *mc, *ms, *mp);
          learn_fused(g, b, ms, mc, mp);
          rc_encode(&rc, b, p);
          ctx += ctx + b;
        }
      }
    } else {
      rank_hist[c] = bsr(rank);
      g = &RANK_P;
      int ctx = 1;
      for (int bit_i = max_rank; bit_i >= 0; --bit_i) {
        int b = (rank >> bit_i) & 1;
        int32_t *es = &rank_esc_s[st * 256 + ctx];
        int32_t *ec = &rank_esc_c[c * 256 + ctx];
        int32_t *ep = &rank_esc_p[ctx];
        p = prob(g, *ec, *es, *ep);
        learn_fused(g, b, es, ec, ep);
        rc_encode(&rc, b, p);
        ctx += ctx + b;
      }
    }

    avg_rank = (avg_rank * 124 + rank * 4) >> 7;
    rank -= 1;
    hist = run_hist[c];
    {
      int r = rank < 7 ? rank : 7;
      int h = hist < 7 ? hist : 7;
      st = run_state[(ctx_rank0 << 10) | (ctx_run << 6) | (r << 3) | h];
    }

    g = &RUN_T;
    p = prob(g, run_flag_c[c], run_flag_s[st], *run_flag_p);
    int bit = run != 1;
    learn(g, bit, &run_flag_s[st], &run_flag_c[c], run_flag_p);
    rc_encode(&rc, bit, p);
    if (run == 1) {
      run_hist[c] = (run_hist[c] + 2) >> 2;
    } else {
      int brs = bsr(run);
      run_hist[c] = (run_hist[c] + 3 * brs + 3) >> 2;
      g = &RUN_E;
      int bit_i = 1;
      while (bit_i < brs) {
        int j = bit_i - 1;
        p = prob(g, run_exp_c[c * 32 + j], run_exp_s[st * 32 + j], run_exp_p[j]);
        learn(g, 1, &run_exp_s[st * 32 + j], &run_exp_c[c * 32 + j], &run_exp_p[j]);
        rc_encode1(&rc, p);
        bit_i += 1;
      }
      {
        int j = bit_i - 1;
        p = prob(g, run_exp_c[c * 32 + j], run_exp_s[st * 32 + j], run_exp_p[j]);
        learn(g, 0, &run_exp_s[st * 32 + j], &run_exp_c[c * 32 + j], &run_exp_p[j]);
        rc_encode0(&rc, p);
      }
      g = &RUN_M;
      int ctx = 1;
      for (bit_i = brs - 1; bit_i >= 0; --bit_i) {
        int b = (int)((run >> bit_i) & 1);
        int32_t *ms = &run_man_s[(brs * 256 + st) * 32 + ctx];
        int32_t *mc = &run_man_c[(brs * 256 + c) * 32 + ctx];
        int32_t *mp = &run_man_p[brs * 32 + ctx];
        p = prob(g, *mc, *ms, *mp);
        learn_fused(g, b, ms, mc, mp);
        rc_encode(&rc, b, p);
        if (brs <= 5)
          ctx += ctx + b;
        else
          ctx += 1;
      }
    }

    ctx_rank0 = ((ctx_rank0 << 1) | (rank == 0 ? 1 : 0)) & 0x7;
    ctx_rank4 = ((ctx_rank4 << 2) | (rank < 3 ? rank : 3)) & 0xFF;
    ctx_run = ((ctx_run << 1) | (run < 3 ? 1 : 0)) & 0xF;
  }
  rc_finish(&rc);
  result = rc.err ? -2 : rc.n;
done:
  free(model);
  free(ranks);
  return result;
}
