// Burrows-Wheeler transform, host-native path.
//
// Forward: suffix-array construction by SA-IS with dense partial induced
// sorting and in-scan LMS substring naming (the induced-sort design proven
// out by libsais, reference libsais.c:1555-2039, 3826-3868 — reimplemented
// from the algorithm, see tbsc_fast_sais below), then BWT extraction in the
// reference's stream convention (verified against libsais behavior):
//   U[0] = T[n-1]; U[1..] = T[SA[j]-1] for SA ranks j skipping suffix 0;
//   primary index = rank(suffix 0) + 1;
//   aux indexes (sampling rate r): indexes[t] = rank(suffix (t+1)*r),
//   with r = 2^floor(log2(n/8)) via the bit-smear in bwt.cpp:192-197 and
//   num_indexes = (n-1)/r.
//
// Inverse: counting + LF-mapping walk over the virtual-sentinel BWT matrix;
// with aux indexes the walk splits into num_indexes+1 independent chains,
// all interleaved in one loop for memory-level parallelism.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <new>

#include "halloc.h"

#ifdef _OPENMP
#include <omp.h>
#endif

namespace tbsc {

using u8 = uint8_t;
using i32 = int32_t;
using u32 = uint32_t;

namespace tbsc_fast_sais {

using u8 = uint8_t;
using i32 = int32_t;
constexpr i32 IMIN = INT32_MIN;
constexpr i32 IMAX = INT32_MAX;

enum { cSS = 0, cSL = 1, cLS = 2, cLL = 3 };  // (own, pred); cSL = LMS

// Shared scratch across all levels.
//   lms_stack: bump arena holding each live level's text-order LMS list
//              (sum over levels <= n ints)
//   scratch:   n/2+2 ints, reused per level (names by position / staging)
struct Scratch {
  i32* lms_stack;
  size_t lms_used;
  i32* scratch;
  bool oom;
  bool bwt_mode;  // top level only: final induce leaves the BWT chars in SA
  // inline aux sampling (BWT mode): record the slot of suffix q when
  // (q & aux_mask) == 0 && 0 < q <= aux_hi; aux_hi = -1 disables
  i32 aux_mask;
  i32 aux_hi;
  i32 aux_shift;
  i32* aux_out;
  i32 primary;  // out: final slot of suffix 0
};

// Final induce: sign bit = "predecessor has the other type".
//
// In BWT mode (u8 top level) the structure follows libsais's final BWT
// scans (libsais.c:4541-4583, 5160-5186), re-derived here: the BWT byte of
// slot i is T[SA[i]-1], which is exactly the char c the scan computes when
// it reaches slot i — so the byte is stored INTO SA[i] sequentially (c|IMIN
// in L2R, plain c in R2L) instead of through a second random write stream.
// An R2L-written entry whose own predecessor is L-typed would never be
// induced again, so its position is replaced by its answer (the stash
// c0|IMIN); every slot therefore ends holding its BWT char.  Primary and
// sampled aux ranks are recorded inline since positions vanish from SA.
template <typename CharT, bool BWT>
static void final_induce(const CharT* T, i32* SA, i32 n, i32 k,
                         const i32* bstart, const i32* total, i32* tmpk,
                         Scratch* sc) {
  if (BWT) {
    const i32 mask = sc->aux_mask, hi = sc->aux_hi, shift = sc->aux_shift;
    i32* aux = sc->aux_out;
    i32 prim = -1;
    {  // L2R: induce L suffixes; leave each induced slot's char as c|IMIN
      i32* lhead = tmpk;
      std::memcpy(lhead, bstart, sizeof(i32) * (size_t)k);
      {
        i32 q = n - 1;
        i32 s = lhead[T[q]]++;
        SA[s] = q | ((T[q - 1] < T[q]) ? IMIN : 0);
        if ((q & mask) == 0 && q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
      }
      constexpr i32 PF = 32;
      i32 i = 0;
      for (i32 j = n - 2 * PF - 1; i < j; i += 2) {
        __builtin_prefetch(&SA[i + 3 * PF], 1);
        {
          i32 s0 = SA[i + 2 * PF + 0];
          if (s0 > 0) { __builtin_prefetch(&T[s0 - 1]); }
          i32 s1 = SA[i + 2 * PF + 1];
          if (s1 > 0) { __builtin_prefetch(&T[s1 - 1]); }
        }
        i32 p0 = SA[i + 0];
        SA[i + 0] = p0 & IMAX;
        if (p0 > 0) {
          i32 q = p0 - 1;
          i32 c = (i32)T[q];
          SA[i + 0] = c | IMIN;
          i32 s = lhead[c]++;
          SA[s] = q | ((T[q - (q > 0)] < (CharT)c) ? IMIN : 0);
          if ((q & mask) == 0) {
            if (q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
          }
        }
        i32 p1 = SA[i + 1];
        SA[i + 1] = p1 & IMAX;
        if (p1 > 0) {
          i32 q = p1 - 1;
          i32 c = (i32)T[q];
          SA[i + 1] = c | IMIN;
          i32 s = lhead[c]++;
          SA[s] = q | ((T[q - (q > 0)] < (CharT)c) ? IMIN : 0);
          if ((q & mask) == 0) {
            if (q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
          }
        }
      }
      for (; i < n; ++i) {
        i32 p = SA[i];
        SA[i] = p & IMAX;
        if (p > 0) {
          i32 q = p - 1;
          i32 c = (i32)T[q];
          SA[i] = c | IMIN;
          i32 s = lhead[c]++;
          SA[s] = q | ((T[q - (q > 0)] < (CharT)c) ? IMIN : 0);
          if ((q & mask) == 0) {
            if (q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
          }
        }
      }
    }
    {  // R2L: induce S suffixes; pred-L entries arrive pre-answered
      i32* rtail = tmpk;
      for (i32 c = 0; c < k; ++c) rtail[c] = bstart[c] + total[c];
      constexpr i32 PF = 32;
      i32 i = n - 1;
      for (i32 j = 2 * PF + 1; i >= j; i -= 2) {
        __builtin_prefetch(&SA[i - 3 * PF], 1);
        {
          i32 s0 = SA[i - 2 * PF - 0];
          if (s0 > 0) { __builtin_prefetch(&T[s0 - 1]); }
          i32 s1 = SA[i - 2 * PF - 1];
          if (s1 > 0) { __builtin_prefetch(&T[s1 - 1]); }
        }
        i32 p0 = SA[i - 0];
        if (p0 == 0) prim = i - 0;
        SA[i - 0] = p0 & IMAX;
        if (p0 > 0) {
          i32 q = p0 - 1;
          CharT c1 = T[q];
          CharT c0 = T[q - (q > 0)];
          SA[i - 0] = (i32)c1;
          i32 s = --rtail[c1];
          SA[s] = (c0 <= c1) ? q : ((i32)c0 | IMIN);
          if ((q & mask) == 0) {
            if (q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
          }
        }
        i32 p1 = SA[i - 1];
        if (p1 == 0) prim = i - 1;
        SA[i - 1] = p1 & IMAX;
        if (p1 > 0) {
          i32 q = p1 - 1;
          CharT c1 = T[q];
          CharT c0 = T[q - (q > 0)];
          SA[i - 1] = (i32)c1;
          i32 s = --rtail[c1];
          SA[s] = (c0 <= c1) ? q : ((i32)c0 | IMIN);
          if ((q & mask) == 0) {
            if (q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
          }
        }
      }
      for (; i >= 0; --i) {
        i32 p = SA[i];
        if (p == 0) prim = i;
        SA[i] = p & IMAX;
        if (p > 0) {
          i32 q = p - 1;
          CharT c1 = T[q];
          CharT c0 = T[q - (q > 0)];
          SA[i] = (i32)c1;
          i32 s = --rtail[c1];
          SA[s] = (c0 <= c1) ? q : ((i32)c0 | IMIN);
          if ((q & mask) == 0) {
            if (q != 0 && q <= hi) aux[(q >> shift) - 1] = s;
          }
        }
      }
    }
    sc->primary = prim;
    return;
  }
  {  // L2R: L suffixes; written sign = predecessor-is-S
    i32* lhead = tmpk;
    std::memcpy(lhead, bstart, sizeof(i32) * (size_t)k);
    {
      i32 q = n - 1;
      i32 s = lhead[T[q]]++;
      SA[s] = q | ((T[q - 1] < T[q]) ? IMIN : 0);
    }
    constexpr i32 PF = 32;
    i32 i = 0;
    for (i32 j = n - 2 * PF - 1; i < j; i += 2) {
      __builtin_prefetch(&SA[i + 3 * PF], 1);
      {
        i32 s0 = SA[i + 2 * PF + 0];
        if (s0 > 0) { __builtin_prefetch(&T[s0 - 1]); }
        i32 s1 = SA[i + 2 * PF + 1];
        if (s1 > 0) { __builtin_prefetch(&T[s1 - 1]); }
      }
      if (sizeof(CharT) > 1) {
        // big-alphabet levels: the bucket array itself misses — prefetch
        // the head entries one tier behind the text prefetch
        i32 s2 = SA[i + PF + 0];
        if (s2 > 0) { __builtin_prefetch(&lhead[T[s2 - 1]], 1); }
        i32 s3 = SA[i + PF + 1];
        if (s3 > 0) { __builtin_prefetch(&lhead[T[s3 - 1]], 1); }
      }
      i32 p0 = SA[i + 0];
      SA[i + 0] = p0 ^ IMIN;
      if (p0 > 0) {
        --p0;
        i32 s = lhead[T[p0]]++;
        SA[s] = p0 | ((T[p0 - (p0 > 0)] < T[p0]) ? IMIN : 0);
      }
      i32 p1 = SA[i + 1];
      SA[i + 1] = p1 ^ IMIN;
      if (p1 > 0) {
        --p1;
        i32 s = lhead[T[p1]]++;
        SA[s] = p1 | ((T[p1 - (p1 > 0)] < T[p1]) ? IMIN : 0);
      }
    }
    for (; i < n; ++i) {
      i32 p = SA[i];
      SA[i] = p ^ IMIN;
      if (p > 0) {
        --p;
        i32 s = lhead[T[p]]++;
        SA[s] = p | ((T[p - (p > 0)] < T[p]) ? IMIN : 0);
      }
    }
  }
  {  // R2L: S suffixes; written sign = predecessor-is-L
    i32* rtail = tmpk;
    for (i32 c = 0; c < k; ++c) rtail[c] = bstart[c] + total[c];
    constexpr i32 PF = 32;
    i32 i = n - 1;
    for (i32 j = 2 * PF + 1; i >= j; i -= 2) {
      __builtin_prefetch(&SA[i - 3 * PF], 1);
      {
        i32 s0 = SA[i - 2 * PF - 0];
        if (s0 > 0) { __builtin_prefetch(&T[s0 - 1]); }
        i32 s1 = SA[i - 2 * PF - 1];
        if (s1 > 0) { __builtin_prefetch(&T[s1 - 1]); }
      }
      if (sizeof(CharT) > 1) {
        i32 s2 = SA[i - PF - 0];
        if (s2 > 0) { __builtin_prefetch(&rtail[T[s2 - 1]], 1); }
        i32 s3 = SA[i - PF - 1];
        if (s3 > 0) { __builtin_prefetch(&rtail[T[s3 - 1]], 1); }
      }
      i32 p0 = SA[i - 0];
      SA[i - 0] = p0 & IMAX;
      if (p0 > 0) {
        --p0;
        i32 s = --rtail[T[p0]];
        SA[s] = p0 | ((T[p0 - (p0 > 0)] > T[p0]) ? IMIN : 0);
      }
      i32 p1 = SA[i - 1];
      SA[i - 1] = p1 & IMAX;
      if (p1 > 0) {
        --p1;
        i32 s = --rtail[T[p1]];
        SA[s] = p1 | ((T[p1 - (p1 > 0)] > T[p1]) ? IMIN : 0);
      }
    }
    for (; i >= 0; --i) {
      i32 p = SA[i];
      SA[i] = p & IMAX;
      if (p > 0) {
        --p;
        i32 s = --rtail[T[p]];
        SA[s] = p | ((T[p - (p > 0)] > T[p]) ? IMIN : 0);
      }
    }
  }
}

template <typename CharT>
static void sais_dense(const CharT* T, i32* SA, i32 n, i32 k, Scratch* sc) {
  if (n == 1) { SA[0] = 0; return; }

  // transient per-level tables: hist4(4k) head(2k) tail(2k) lmsh(k)
  // lsstart(k) dist(2k) total(k) bstart(k) = 14k
  i32* tbl = new (std::nothrow) i32[(size_t)14 * k];
  if (!tbl) { sc->oom = true; return; }
  i32* hist4 = tbl;
  i32* head = tbl + 4 * (size_t)k;
  i32* tail = head + 2 * (size_t)k;
  i32* lmsh = tail + 2 * (size_t)k;
  i32* lsstart = lmsh + k;
  i32* dist = lsstart + k;
  i32* total = dist + 2 * (size_t)k;
  i32* bstart = total + k;
  std::memset(hist4, 0, sizeof(i32) * (size_t)4 * k);

  i32* lms_text = sc->lms_stack + sc->lms_used;

  // Backward pass: class histogram + LMS gather (branchless, ends ascending
  // after the reversal).  Totals are derived from the histogram.
  i32 m = 0;
  {
    // branchless type chain: t(i) = L iff T[i] > T[i+1], inherit on equal
    u8 tnext = 1;  // t(n-1) = L under the virtual sentinel
    i32 mt = 0;
    i32 i = n - 2;
    for (; i >= 1; i -= 2) {
      if (i >= 256) __builtin_prefetch(&T[i - 256]);
      {
        CharT a = T[i], b = T[i + 1];
        u8 ti = (u8)((a > b) | ((a == b) & tnext));
        u8 cls = (u8)((tnext << 1) | ti);
        hist4[4 * (size_t)b + cls]++;
        lms_text[mt] = i + 1;
        mt += (cls == cSL);
        tnext = ti;
      }
      {
        CharT a = T[i - 1], b = T[i];
        u8 ti = (u8)((a > b) | ((a == b) & tnext));
        u8 cls = (u8)((tnext << 1) | ti);
        hist4[4 * (size_t)b + cls]++;
        lms_text[mt] = i;
        mt += (cls == cSL);
        tnext = ti;
      }
    }
    for (; i >= 0; --i) {
      CharT a = T[i], b = T[i + 1];
      u8 ti = (u8)((a > b) | ((a == b) & tnext));
      u8 cls = (u8)((tnext << 1) | ti);
      hist4[4 * (size_t)b + cls]++;
      lms_text[mt] = i + 1;
      mt += (cls == cSL);
      tnext = ti;
    }
    hist4[4 * (size_t)T[0] + 2 * tnext + 0]++;  // position 0, pred classed S
    m = mt;
    for (i32 a = 0, b = m - 1; a < b; ++a, --b) {
      i32 t0 = lms_text[a]; lms_text[a] = lms_text[b]; lms_text[b] = t0;
    }
  }
  sc->lms_used += (size_t)m;

  {
    i32 sum = 0;
    for (i32 c = 0; c < k; ++c) {
      total[c] = hist4[4 * c + 0] + hist4[4 * c + 1] + hist4[4 * c + 2] +
                 hist4[4 * c + 3];
      bstart[c] = sum;
      sum += total[c];
    }
  }

  // per-char LMS counts for the interval placement before the final induce;
  // points into hist4 (stride 4) while tbl lives, or a saved copy when the
  // recursion frees tbl
  const i32* lmscnt = hist4 + cSL;
  i32 lmscnt_stride = 4;
  i32* lmscnt_saved = nullptr;

  if (m > 1) {
    const i32 f = lms_text[0];

    // drop positions [0, f) from the partial-phase histogram
    {
      u8 tnext = 1;  // t(f-1) = L
      for (i32 i = f - 2; i >= 0; --i) {
        u8 ti = (T[i] > T[i + 1]) ? 1 : (T[i] < T[i + 1]) ? 0 : tnext;
        hist4[4 * (size_t)T[i + 1] + 2 * tnext + ti]--;
        tnext = ti;
      }
      hist4[4 * (size_t)T[0] + 2 * tnext + 0]--;
    }

    i32 left_total;
    {
      i32 off = 0;
      for (i32 c = 0; c < k; ++c) {
        head[2 * c + 1] = off; off += hist4[4 * c + cLL];
        lmsh[c] = off;         off += hist4[4 * c + cSL];
      }
      left_total = off;
      i32 msum = 0;
      for (i32 c = 0; c < k; ++c) {
        lsstart[c] = off;
        head[2 * c + 0] = off;
        off += hist4[4 * c + cLS] + hist4[4 * c + cSS];
        tail[2 * c + 0] = off;
        msum += hist4[4 * c + cSL];
        tail[2 * c + 1] = msum;
      }
    }

    for (i32 j = 0; j < m; ++j) {
      i32 p = lms_text[j];
      SA[lmsh[T[p]]++] = p;
    }

    std::memset(dist, 0, sizeof(i32) * (size_t)2 * k);
    i32 d = 0;

    {  // seed: n-1 is always L-type; marked, d -> 1
      i32 q = n - 1;
      i32 v = 2 * (i32)T[q] + (T[q - 1] >= T[q] ? 1 : 0);
      SA[head[v]++] = q | IMIN;
      dist[v] = ++d;
    }

    {  // L2R over the left region
      constexpr i32 PF = 32;
      i32 i = 0;
      for (i32 jend = left_total - PF - 1; i < jend; i += 2) {
        __builtin_prefetch(&SA[i + 2 * PF]);
        {
          i32 a = SA[i + PF + 0] & IMAX;
          __builtin_prefetch(&T[a - 1]);
          i32 b = SA[i + PF + 1] & IMAX;
          __builtin_prefetch(&T[b - 1]);
        }
        i32 praw0 = SA[i + 0];
        d += (praw0 < 0);
        i32 p0 = praw0 & IMAX;
        if (p0 != f) {  // the first LMS has no in-region predecessor
          i32 q = p0 - 1;
          i32 v = 2 * (i32)T[q] + (T[q - 1] >= T[q] ? 1 : 0);
          i32 mark = (dist[v] != d) ? IMIN : 0;
          dist[v] = d;
          SA[head[v]++] = q | mark;
        }
        i32 praw1 = SA[i + 1];
        d += (praw1 < 0);
        i32 p1 = praw1 & IMAX;
        if (p1 != f) {
          i32 q = p1 - 1;
          i32 v = 2 * (i32)T[q] + (T[q - 1] >= T[q] ? 1 : 0);
          i32 mark = (dist[v] != d) ? IMIN : 0;
          dist[v] = d;
          SA[head[v]++] = q | mark;
        }
      }
      for (; i < left_total; ++i) {
        i32 praw = SA[i];
        d += (praw < 0);
        i32 p = praw & IMAX;
        if (p == f) continue;
        i32 q = p - 1;
        i32 v = 2 * (i32)T[q] + (T[q - 1] >= T[q] ? 1 : 0);
        i32 mark = (dist[v] != d) ? IMIN : 0;
        dist[v] = d;
        SA[head[v]++] = q | mark;
      }
    }

    // shift marks one slot down inside each filled LS block; tops marked
    for (i32 c = k - 1; c >= 0; --c) {
      i32 lo = lsstart[c], hi = head[2 * c + 0];
      i32 s = IMIN;
      for (i32 i = hi - 1; i >= lo; --i) {
        i32 p = SA[i], q = (p & IMIN) ^ s;
        s ^= q;
        SA[i] = p ^ q;
      }
    }

    {  // R2L over the right region; LMS results compact into SA[0..m)
      constexpr i32 PF = 32;
      const i32 rlo = left_total;
      const i32 rhi = tail[2 * (k - 1) + 0];  // == n - f
      i32 i = rhi - 1;
      for (i32 jend = rlo + PF + 1; i >= jend; i -= 2) {
        __builtin_prefetch(&SA[i - 2 * PF]);
        {
          i32 a = SA[i - PF - 0] & IMAX;
          __builtin_prefetch(&T[a - 2]);
          i32 b = SA[i - PF - 1] & IMAX;
          __builtin_prefetch(&T[b - 2]);
        }
        i32 praw0 = SA[i - 0];
        d += (praw0 < 0);
        i32 p0 = praw0 & IMAX;
        {
          i32 q = p0 - 1;
          i32 v = 2 * (i32)T[q] + (T[q - 1] > T[q] ? 1 : 0);
          i32 mark = (dist[v] != d) ? IMIN : 0;
          dist[v] = d;
          SA[--tail[v]] = q | mark;
        }
        i32 praw1 = SA[i - 1];
        d += (praw1 < 0);
        i32 p1 = praw1 & IMAX;
        {
          i32 q = p1 - 1;
          i32 v = 2 * (i32)T[q] + (T[q - 1] > T[q] ? 1 : 0);
          i32 mark = (dist[v] != d) ? IMIN : 0;
          dist[v] = d;
          SA[--tail[v]] = q | mark;
        }
      }
      for (; i >= rlo; --i) {
        i32 praw = SA[i];
        d += (praw < 0);
        i32 p = praw & IMAX;
        i32 q = p - 1;
        i32 v = 2 * (i32)T[q] + (T[q - 1] > T[q] ? 1 : 0);
        i32 mark = (dist[v] != d) ? IMIN : 0;
        dist[v] = d;
        SA[--tail[v]] = q | mark;
      }
    }

    // Renumber.  [0, m) was filled descending, so a mark on slot j means
    // "differs from slot j+1"; names ascend, boundary read from slot j-1.
    // Fused singleton detection: entry j is a singleton group (its LMS
    // substring is globally unique) iff it starts a group (carry-in) AND the
    // next entry starts one too (its own mark; the last entry's group ends
    // at m, so only carry-in matters there).  Unique entries get the sign
    // bit on their name — consumed by the compaction below, masked off
    // everywhere else.
    i32* name_by_pos = sc->scratch;
    i32 names = 1;
    {
      i32 carry = 0;  // mark(j-1); entry 0 implicitly starts a group
      for (i32 j = 0; j < m; ++j) {
        if (j + 32 < m) __builtin_prefetch(
            &name_by_pos[(SA[j + 32] & IMAX) >> 1], 1);
        i32 praw = SA[j];
        i32 p = praw & IMAX;
        SA[j] = p;
        names += carry;
        i32 in_j = carry | (j == 0);          // j starts a group
        i32 in_next = (praw < 0) | (j == m - 1);  // j+1 starts one (or end)
        name_by_pos[p >> 1] =
            names | (i32)((u32)(in_j & in_next) << 31);
        carry = (praw < 0);
      }
    }

    if (names < m) {
      // keep the tables across the recursion when they're small relative to
      // the level (skips the post-recursion recount); otherwise free them
      // so peak memory stays bounded and recount afterwards
      const bool keep_tbl = (size_t)14 * (size_t)k <= (size_t)n;
      if (!keep_tbl) {
        // the interval placement after the recursion needs the per-char LMS
        // counts, which live in hist4 — save them before tbl goes away
        lmscnt_saved = new (std::nothrow) i32[(size_t)k];
        if (!lmscnt_saved) {
          delete[] tbl; sc->oom = true; sc->lms_used -= (size_t)m; return;
        }
        for (i32 c = 0; c < k; ++c)
          lmscnt_saved[c] = hist4[4 * (size_t)c + cSL];
        lmscnt = lmscnt_saved;
        lmscnt_stride = 1;
        delete[] tbl; tbl = nullptr;
      }
      // --- unique-LMS compaction (independently derived; same end effect
      // as libsais's compact_lms path, libsais.c:5876-6140).  A suffix
      // comparison between two LMS suffixes with equal names proceeds over
      // equal (hence non-unique) names and stops at the first difference;
      // an element whose TEXT-predecessor is unique can therefore never be
      // reached at offset >= 1, and if its own substring is also unique its
      // final rank is simply its substring rank.  Such elements are dropped
      // from the recursion string (their ranks recorded), the kept names are
      // densely renamed, and the child result is merged back by rank. ---
      i32 f = 0;
      // few names => heavy duplication => few unique pairs; skip the
      // candidate scan entirely (signs are masked everywhere downstream)
      if ((size_t)4 * (size_t)names >= (size_t)m) {
        // downgrade uniqueness marks to removability marks; text order
        i32 prev_uniq = 0;
        const i32 mlast = m - 1;
        for (i32 j = 0; j < m; ++j) {
          i32 idx = lms_text[j] >> 1;
          i32 v = name_by_pos[idx];
          i32 uniq = (i32)((u32)v >> 31);
          i32 rem = uniq & prev_uniq & (i32)(j < mlast);
          f += rem;
          if (uniq & ~rem) name_by_pos[idx] = v & IMAX;
          prev_uniq = uniq;
        }
      }
      const bool compact = f >= (m >> 4) && f > 64;
      i32 mstar = m, knew = names;
      i32* pairs = nullptr;  // (rank, text pos) of removed, rank-ascending
      if (compact) {
        pairs = new (std::nothrow) i32[2 * (size_t)f];
        if (!pairs) {
          delete[] tbl; delete[] lmscnt_saved;
          sc->oom = true; sc->lms_used -= (size_t)m; return;
        }
        // sorted pass: collect removed (rank, pos); densely rename kept
        i32 nn = 0, prev_nm = 0, w = 0;
        for (i32 j = 0; j < m; ++j) {
          i32 p = SA[j];
          i32 v = name_by_pos[p >> 1];
          i32 nm = v & IMAX;
          if (v < 0) {
            pairs[w++] = j;
            pairs[w++] = p;
          } else {
            nn += (nm != prev_nm);
            name_by_pos[p >> 1] = nn;
          }
          prev_nm = nm;
        }
        mstar = m - f;
        knew = nn;
      }
      i32* s1 = SA + n - mstar;
      if (compact) {
        // text pass: compact lms_text in place; build the reduced string
        i32 kk = 0;
        for (i32 j = 0; j < m; ++j) {
          i32 p = lms_text[j];
          i32 v = name_by_pos[p >> 1];
          if (v >= 0) {
            lms_text[kk] = p;
            s1[kk] = v - 1;
            ++kk;
          }
        }
      } else {
        for (i32 j = 0; j < m; ++j)
          s1[j] = (name_by_pos[lms_text[j] >> 1] & IMAX) - 1;
      }
      sais_dense<i32>(s1, SA, mstar, knew, sc);
      if (sc->oom) {
        delete[] tbl; delete[] lmscnt_saved; delete[] pairs;
        sc->lms_used -= (size_t)m; return;
      }
      for (i32 j = 0; j < mstar; ++j) {
        if (j + 32 < mstar) __builtin_prefetch(&lms_text[SA[j + 32]]);
        SA[j] = lms_text[SA[j]];
      }
      if (compact) {
        // merge removed back at their substring ranks, backward in place
        i32 a = f - 1, b = mstar;
        for (i32 s = m - 1; s >= 0; --s) {
          if (a >= 0 && pairs[2 * a] == s) {
            SA[s] = pairs[2 * a + 1];
            --a;
          } else {
            SA[s] = SA[--b];
          }
        }
        delete[] pairs;
      }
      if (!keep_tbl) {
        tbl = new (std::nothrow) i32[(size_t)4 * k];
        if (!tbl) {
          delete[] lmscnt_saved;
          sc->oom = true; sc->lms_used -= (size_t)m; return;
        }
        total = tbl; bstart = tbl + k;
        std::memset(total, 0, sizeof(i32) * (size_t)k);
        for (i32 i = 0; i < n; ++i) total[T[i]]++;
        i32 sum = 0;
        for (i32 c = 0; c < k; ++c) { bstart[c] = sum; sum += total[c]; }
      }
    }
  } else if (m == 1) {
    SA[0] = lms_text[0];
  }
  sc->lms_used -= (size_t)m;

  // ---- final induce ----
  {
    // Interval placement (the libsais place_lms_suffixes_interval trick,
    // libsais.c:4369-4391, re-derived): SA[0..m) holds the sorted LMS,
    // already grouped by first char ascending, so each char's block moves
    // right-to-left to its bucket tail with one memmove and the gaps are
    // zeroed — a single sequential pass over SA instead of the old
    // copy-out + full memset + random scatter.
    i32 mm = m;
    i32 j = n;
    for (i32 c = k - 1; c >= 0; --c) {
      i32 l = lmscnt[(size_t)lmscnt_stride * c];
      if (l > 0) {
        i32 bt = bstart[c] + total[c];
        if (j > bt)
          std::memset(SA + bt, 0, sizeof(i32) * (size_t)(j - bt));
        mm -= l;
        std::memmove(SA + bt - l, SA + mm, sizeof(i32) * (size_t)l);
        j = bt - l;
      }
    }
    std::memset(SA, 0, sizeof(i32) * (size_t)j);
    delete[] lmscnt_saved;
    i32* tmpk = tbl + 2 * (size_t)k;  // free space in both tbl layouts
    if (sizeof(CharT) == 1 && sc->bwt_mode)
      final_induce<CharT, true>(T, SA, n, k, bstart, total, tmpk, sc);
    else
      final_induce<CharT, false>(T, SA, n, k, bstart, total, tmpk, sc);
  }
  delete[] tbl;
}

// Entry point: suffix array of T[0..n) into SA[0..n).  In bwt_mode, SA
// instead ends holding the BWT chars (primary slot garbage), *primary the
// slot of suffix 0, and aux_out the sampled ranks — see final_induce.
// Returns 0, or -2 on allocation failure.
static int suffix_array_fast(const u8* T, i32* SA, i32 n,
                             bool bwt_mode = false, i32 aux_mask = IMAX,
                             i32 aux_hi = -1, i32 aux_shift = 0,
                             i32* aux_out = nullptr, i32* primary = nullptr) {
  if (n <= 0) return -1;
  if (n == 1) { SA[0] = 0; if (primary) *primary = 0; return 0; }
  i32* lms_stack = new (std::nothrow) i32[(size_t)n + 4];
  i32* scratch = new (std::nothrow) i32[(size_t)(n >> 1) + 4];
  if (!lms_stack || !scratch) {
    delete[] lms_stack; delete[] scratch;
    return -2;
  }
  Scratch sc{lms_stack, 0, scratch, false, bwt_mode,
             aux_mask, aux_hi, aux_shift, aux_out, -1};
  sais_dense<u8>(T, SA, n, 256, &sc);
  delete[] lms_stack;
  delete[] scratch;
  if (primary) *primary = sc.primary;
  return sc.oom ? -2 : 0;
}

}  // namespace tbsc_fast_sais

// Computes the suffix array of T (length n) into SA.
int suffix_array(const u8* T, i32* SA, i32 n) {
  if (n <= 0) return -1;
  return tbsc_fast_sais::suffix_array_fast(T, SA, n) == 0 ? 0 : -2;
}

// Aux-index sampling rate (bwt.cpp:192-197).
static int aux_rate(int n) {
  int mod = n / 8;
  mod |= mod >> 1; mod |= mod >> 2; mod |= mod >> 4;
  mod |= mod >> 8; mod |= mod >> 16;
  mod >>= 1;
  return mod + 1;
}

// In-place BWT with an EXPLICIT aux sampling rate r (power of two);
// writes (n-1)/r sampled ranks.  The wide-aux profile uses r ~ n/4096 to
// expose thousands of parallel inverse chains (SURVEY §5's scaled
// aux-index design); the bsc-compatible path wraps this with the
// reference's rate.
int bwt_encode_rate(u8* T, int n, int r, i32* indexes) {
  if (n <= 1) return n;
  if (r < 2 || (r & (r - 1)) != 0) return -1;
  i32* SA = (i32*)halloc((size_t)n * sizeof(i32));
  if (!SA) return -2;
  const u8 last = T[n - 1];
  int n_aux = (n - 1) / r;
  i32 prim_slot = -1;
  if (tbsc_fast_sais::suffix_array_fast(
          T, SA, n, true, (i32)r - 1, indexes ? (i32)n_aux * r : -1,
          __builtin_ctz((unsigned)r), indexes, &prim_slot) != 0) {
    hfree(SA);
    return -2;
  }
  int primary = (int)prim_slot + 1;
  for (int j = 0; j < primary - 1; ++j) T[j + 1] = (u8)SA[j];
  for (int j = primary; j < n; ++j) T[j] = (u8)SA[j];
  T[0] = last;
  hfree(SA);
  return primary;
}

// In-place BWT of T[0..n); returns primary index (>0) or error (<0).
// When indexes != null, writes num_indexes = (n-1)/r sampled ranks.
int bwt_encode(u8* T, int n, u8* num_indexes, i32* indexes, int /*num_threads*/) {
  if (n <= 1) { if (num_indexes) *num_indexes = 0; return n; }
  i32* SA = (i32*)halloc((size_t)n * sizeof(i32));
  if (!SA) return -2;
  const u8 last = T[n - 1];
  int r = aux_rate(n);
  int n_aux = (n - 1) / r;
  i32 prim_slot = -1;
  // BWT chars, primary and aux ranks all fall out of the final induce —
  // no separate extraction pass or SA sweep (r is a power of two, so the
  // sampling modulo is a mask).
  if (tbsc_fast_sais::suffix_array_fast(
          T, SA, n, true, (i32)r - 1, indexes ? (i32)n_aux * r : -1,
          __builtin_ctz((unsigned)r), indexes, &prim_slot) != 0) {
    hfree(SA);
    return -2;
  }
  int primary = (int)prim_slot + 1;
  if (indexes && num_indexes) {
    *num_indexes = (u8)n_aux;
  } else if (num_indexes) {
    *num_indexes = 0;
  }
  // assemble the reference stream convention: row 0 shows T[n-1]; the
  // primary (sentinel) row is skipped (SA holds the chars, widened)
  for (int j = 0; j < primary - 1; ++j) T[j + 1] = (u8)SA[j];
  for (int j = primary; j < n; ++j) T[j] = (u8)SA[j];
  T[0] = last;
  hfree(SA);
  return primary;
}

// ---------------------------------------------------------------------------
// Bigram-PSI inverse BWT.
//
// Forward PSI walk over the suffix-row space [0, n]: row 0 is the virtual
// sentinel, rows 1..n the sorted suffixes, PSI[j] = row of the suffix one
// text position later.  The chase uses the SQUARED map P2[j] = PSI[PSI[j]]
// so each dependent random access emits TWO text bytes — the same halving
// libsais's biPSI decode gets (libsais.c:7086-7543), reformulated here
// over suffix rows.  P2 is built directly by a two-pass bigram-bucket
// scatter (no intermediate PSI array).  The two bytes of a step are
// the bigram of the current row, recovered from the row number by a
// fastbits LUT over the cumulative bigram bucket boundaries (rows are
// grouped by 2-byte prefix since they are suffix-sorted).  The aux indexes
// give num_indexes+1 independent forward chains, advanced together in one
// wavefront loop for memory-level parallelism.
// ---------------------------------------------------------------------------

static int unbwt_bigram(u8* T, int n, int index, int num_indexes,
                        const i32* indexes, int r) {
  const i32 nrows = n + 1;
  i32* P2 = (i32*)halloc((size_t)nrows * sizeof(i32));
  u32* bend = new (std::nothrow) u32[65536];
  u32* cur2 = new (std::nothrow) u32[65536];
  constexpr int FASTBITS = 17;
  uint16_t* fastbits = new (std::nothrow) uint16_t[(size_t)1 << FASTBITS];
  if (!P2 || !bend || !cur2 || !fastbits) {
    hfree(P2); delete[] bend; delete[] cur2; delete[] fastbits;
    return -2;
  }

  auto nowsec = []() -> double {
    struct timespec ts; clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  };
  const bool prof = getenv("TBSC_UNBWT_PROF") != nullptr;
  double tp0 = prof ? nowsec() : 0.0;
  i32 cnt[256];
  {
    // 4-bank byte histogram: BWT output is run-heavy, and a single count
    // array stalls on store-to-load forwarding for every repeated char
    u32 h0[256], h1[256], h2[256], h3[256];
    std::memset(h0, 0, sizeof h0); std::memset(h1, 0, sizeof h1);
    std::memset(h2, 0, sizeof h2); std::memset(h3, 0, sizeof h3);
    int u = 0;
    for (; u + 4 <= n; u += 4) {
      h0[T[u]]++; h1[T[u + 1]]++; h2[T[u + 2]]++; h3[T[u + 3]]++;
    }
    for (; u < n; ++u) h0[T[u]]++;
    for (int c = 0; c < 256; ++c)
      cnt[c] = (i32)(h0[c] + h1[c] + h2[c] + h3[c]);
  }
  if (prof) { fprintf(stderr, "[unbwt] histo %.3f\n", nowsec() - tp0); tp0 = nowsec(); }
  i32 rowlo[257];  // first row of each char bucket (rows 1..n)
  {
    i32 sum = 1;
    for (int c = 0; c < 256; ++c) { rowlo[c] = sum; sum += cnt[c]; }
    rowlo[256] = sum;
  }

  // Direct P2 (squared-PSI) construction, no intermediate PSI array — the
  // two-pass bigram-bucket scheme libsais uses for its biPSI
  // (libsais.c:7086-7121), re-derived for this row convention.  For BWT
  // position u: q = LF-row of row(u) consumed in ascending order per char
  // (front cursor), and the TEXT-predecessor char of q is read straight
  // from the BWT at q's own BWT position u2 = q - (q > index) — a byte
  // gather over 256 ascending streams, 4x denser than re-reading an i32
  // PSI array.  Rows grouped by their leading bigram (c0,c1) are exactly
  // the contiguous row ranges of the cumulative bigram histogram, so the
  // scatter writes P2[q2] for ascending q2 within each bucket.
  // Special rows: q == index => q2 is the sentinel row 0 (P2[0]);
  // the length-1 suffix row R1 is never a q2 (it is LF(sentinel)) and
  // gets P2[R1] = index (its PSI is the sentinel, whose PSI is primary).
  {
    // Counting pass, gather-free: the pairs to count are exactly
    // (T[v], first-char-of-row(v + (v >= index))) over v in [1, n) — the
    // first char is constant across each char bucket's row range, so the
    // bigram histogram decomposes into 256 slice histograms of T (the same
    // shape as libsais_unbwt_compute_histogram over bucket slices,
    // libsais.c:7040-7062), each 4-banked against run stalls.
    std::memset(bend, 0, 65536 * sizeof(u32));
    u32 h0[256], h1[256], h2[256], h3[256];
    for (int b = 0; b < 256; ++b) {
      const i32 rlo = rowlo[b], rhi = rowlo[b + 1];
      i32 vlo = rlo - (rlo > index), vhi = rhi - (rhi > index);
      if (vlo < 1) vlo = 1;
      if (vhi <= vlo) continue;
      std::memset(h0, 0, sizeof h0); std::memset(h1, 0, sizeof h1);
      std::memset(h2, 0, sizeof h2); std::memset(h3, 0, sizeof h3);
      i32 v = vlo;
      for (; v + 4 <= vhi; v += 4) {
        h0[T[v]]++; h1[T[v + 1]]++; h2[T[v + 2]]++; h3[T[v + 3]]++;
      }
      for (; v < vhi; ++v) h0[T[v]]++;
      for (int a = 0; a < 256; ++a) {
        const u32 sme = h0[a] + h1[a] + h2[a] + h3[a];
        if (sme) bend[((u32)a << 8) | (u32)b] += sme;
      }
    }
  }
  if (prof) { fprintf(stderr, "[unbwt] count %.3f\n", nowsec() - tp0); tp0 = nowsec(); }
  i32 R1;  // row of the length-1 suffix (pseudo slot)
  {
    // cumulative bucket ENDS over row space: row 0 (sentinel) first, the
    // length-1 suffix as a pseudo slot at the head of its char bucket
    const int pseudo_c1 = T[0];  // U[0] = last text char = that suffix's char
    u32 sum = 1;                 // sentinel row
    R1 = 1;
    for (int w = 0; w < 65536; ++w) {
      if ((w >> 8) == pseudo_c1 && (w & 255) == 0) { R1 = (i32)sum; sum += 1; }
      cur2[w] = sum;  // bucket START (post sentinel/pseudo adjustments)
      sum += bend[w];
      bend[w] = sum;
    }
  }
  {
    i32 front[256];
    std::memcpy(front, rowlo, sizeof front);
    constexpr int PF = 48;
    for (int u = 0; u < n; ++u) {
      if (u + PF < n) {
        i32 fq = front[T[u + PF]];
        __builtin_prefetch(&T[fq - (fq > index)]);
      }
      const u8 c1 = T[u];
      const i32 q = front[c1]++;
      const i32 rowu = u + (u >= index ? 1 : 0);
      if (q == index) { P2[0] = rowu; continue; }
      const i32 u2 = q - (q > index);
      P2[cur2[((u32)T[u2] << 8) | c1]++] = rowu;
    }
    P2[R1] = index;
  }
  if (prof) { fprintf(stderr, "[unbwt] build %.3f\n", nowsec() - tp0); tp0 = nowsec(); }

  // fastbits: high bits of a row number -> first bucket that can contain it
  int shift = 0;
  while (((nrows - 1) >> shift) >= (1 << FASTBITS)) ++shift;
  {
    u32 w = 0;
    for (i32 v = 0; v < (i32)((size_t)1 << FASTBITS); ++v) {
      i32 row = (i32)v << shift;
      while (w < 65535 && (i32)bend[w] <= row) ++w;
      fastbits[v] = (uint16_t)w;
    }
  }

  // forward chains: chain 0 from the primary row covers [0, r); chain t
  // from aux row t covers [t*r, (t+1)*r).  The first num_indexes+0 chains
  // all have length exactly r, so the wavefront loop runs them with no
  // per-step bounds checks (write position = t*r + 2*i); only the last
  // (shorter) chain carries a cheap, perfectly-predicted cutoff.
  const int K = num_indexes;     // chains of length exactly r
  const int l = n - K * r;       // last chain length, 1..r
  i32 ck_fixed[256];
  i32* ck = ck_fixed;
  i32* ck_heap = nullptr;
  if (K + 1 > 256) {
    ck_heap = new (std::nothrow) i32[(size_t)K + 1];
    if (!ck_heap) {
      hfree(P2); delete[] bend; delete[] cur2; delete[] fastbits;
      return -2;
    }
    ck = ck_heap;
  }
  ck[0] = index;
  for (int t = 1; t <= K; ++t) ck[t] = indexes[t - 1] + 1;

  auto bigram_of = [&](i32 k) -> u32 {
    u32 w = fastbits[(u32)k >> shift];
    while ((i32)bend[w] <= k) ++w;
    return w;
  };

  double t_chase0 = prof ? nowsec() : 0.0;
  if (prof) fprintf(stderr, "[unbwt] fastbits+mid %.3f\n", t_chase0 - tp0);
  // T is dead once P2 is built (the chase reads only P2/bend/fastbits), so
  // the chains decode straight into T — no separate output buffer, no final
  // copy pass.  Only T[0] (= U[n-1], the odd-tail byte) must be saved.
  const u8 lastc = T[0];
  const i32 half = r >> 1;       // r is a power of two >= 256 here
  const i32 lhalf = l >> 1;
  for (i32 i = 0; i < half; ++i) {
    u8* op = T + 2 * (size_t)i;
    for (int t = 0; t < K; ++t, op += r) {
      i32 k = ck[t];
      u32 w = bigram_of(k);
      op[0] = (u8)(w >> 8);
      op[1] = (u8)(w & 255);
      k = P2[k];
      ck[t] = k;
      __builtin_prefetch(&P2[k]);
    }
    if (i < lhalf) {
      i32 k = ck[K];
      u32 w = bigram_of(k);
      op[0] = (u8)(w >> 8);
      op[1] = (u8)(w & 255);
      k = P2[k];
      ck[K] = k;
      __builtin_prefetch(&P2[k]);
    }
  }
  // odd last-chain length: the final byte is text position n-1 = U[0]
  if (l & 1) T[n - 1] = lastc;

  if (prof) fprintf(stderr, "[unbwt] chase %.3f\n", nowsec() - t_chase0);
  delete[] ck_heap;
  hfree(P2);
  delete[] bend;
  delete[] cur2;
  delete[] fastbits;
  return 0;
}

// Inverse BWT with an explicit aux rate (wide-aux profile host path).
int bwt_decode_rate(u8* T, int n, int index, int r, int num_indexes,
                    const i32* indexes) {
  if (n <= 1) return 0;
  if (index <= 0 || index > n) return -1;
  if (r < 256 || (r & (r - 1)) != 0 || !indexes) return -1;
  if (num_indexes != (n - 1) / r) return -1;
  for (int t = 0; t < num_indexes; ++t)  // every chain starts in [0, n)
    if (indexes[t] < 0 || indexes[t] >= n) return -1;
  return unbwt_bigram(T, n, index, num_indexes, indexes, r);
}

// Inverse BWT.  index/aux semantics per the encode above.
int bwt_decode(u8* T, int n, int index, int num_indexes, const i32* indexes,
               int num_threads) {
  (void)num_threads;  // the interleaved chase saturates one core's MLP
  if (n <= 1) return 0;
  if (index <= 0 || index > n) return -1;

  {
    int r = aux_rate(n);
    if (indexes && num_indexes == (n - 1) / r && num_indexes > 0 && n >= 4096)
      return unbwt_bigram(T, n, index, num_indexes, indexes, r);
  }

  // LF over the virtual-sentinel matrix:
  //   row k (k != index) shows U[u], u = k - (k > index);
  //   LF(k) = 1 + base0[U[u]] + occ(U[u], u).
  // Precompute next[u] = LF(row of u) directly in u-coordinates.
  i32* lf = new (std::nothrow) i32[(size_t)n];
  if (!lf) return -2;
  i32 cnt[256];
  std::memset(cnt, 0, sizeof cnt);
  for (int u = 0; u < n; ++u) {
    lf[u] = cnt[T[u]]++;
  }
  i32 base[256];
  {
    i32 sum = 1;  // sentinel occupies row 0
    for (int c = 0; c < 256; ++c) { base[c] = sum; sum += cnt[c]; }
  }
  for (int u = 0; u < n; ++u) lf[u] += base[T[u]];

  u8* out = new (std::nothrow) u8[(size_t)n];
  if (!out) { delete[] lf; return -2; }

  int r = aux_rate(n);
  bool use_aux = indexes && num_indexes == (n - 1) / r;

  if (!use_aux) {
    // single chain from the sentinel row (k=0 => u=0)
    i32 k = 0;
    for (int pos = n - 1; pos >= 0; --pos) {
      i32 u = k - (k > index ? 1 : 0);
      out[pos] = T[u];
      k = lf[u];
    }
  } else {
    // chain t starts at the row of suffix t*r and writes positions
    // [t*r - 1 .. (t-1)*r] going backward; chain 0 starts at the sentinel
    // row (k=0, whose preceding char is T[n-1]) and writes the tail
    // [n-1 .. num_indexes*r].  All chains advance together in one loop:
    // each LF step is a dependent cache miss, so interleaving keeps
    // n_chains misses in flight instead of one (memory-level parallelism —
    // the single-core analog of the reference's parallel chain decode).
    int n_chains = num_indexes + 1;
    i32 kk[256];
    int hi[256], lo[256];
    for (int t = 0; t < n_chains; ++t) {
      kk[t] = (t == 0) ? 0 : indexes[t - 1] + 1;
      hi[t] = (t == 0) ? n - 1 : t * r - 1;
      lo[t] = (t == 0) ? num_indexes * r : (t - 1) * r;
    }
    int active = n_chains;
    while (active > 0) {
      active = 0;
      for (int t = 0; t < n_chains; ++t) {
        if (hi[t] < lo[t]) continue;
        ++active;
        i32 k = kk[t];
        i32 u = k - (k > index ? 1 : 0);
        out[hi[t]--] = T[u];
        k = lf[u];
        kk[t] = k;
        i32 un = k - (k > index ? 1 : 0);
        __builtin_prefetch(&lf[un]);
        __builtin_prefetch(&T[un]);
      }
    }
  }

  std::memcpy(T, out, (size_t)n);
  delete[] out;
  delete[] lf;
  return 0;
}

}  // namespace tbsc
