// Sort Transform of order k (ST3..ST8): a BWT restricted to k-byte contexts.
//
// Forward semantics (matches reference st.cpp / st.cu): stably sort all
// positions i by the k following bytes T[i..i+k-1] (wrapping), ties broken
// by position; output the preceding byte T[(i-1) mod n]; return the rank of
// position 0.  Implemented here as an LSD radix sort over packed 64-bit keys
// (one array for k <= 7 with the payload byte in the low bits, key+payload
// pairs for k == 8).
//
// Inverse: group-refinement + LF-mapping (the algorithm of st.cpp:1014-1527):
// 1) recover order-2 context group sizes from the output histogram and an
//    in-bucket sub-histogram transpose; 2) refine group boundaries k-3 times
//    via LF-order marking; 3) walk the text backward, consuming slots of
//    each identical-context tie range from the back (ties are position-
//    ordered, and the backward walk visits the largest positions first).
// Three reconstruction layouts depending on n and per-char counts (packed
// char+link, relative link, or link-only with char recovered by search).

#include <cstdint>
#include <cstring>
#include <new>

#include "halloc.h"

namespace tbsc {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i32 = int32_t;

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

static void radix_pass16(const u64* src, u64* dst, int n, int shift) {
  static_assert(sizeof(size_t) >= 8, "");
  i32* cnt = new i32[65536]();
  for (int i = 0; i < n; ++i) ++cnt[(src[i] >> shift) & 0xffff];
  i32 sum = 0;
  for (int d = 0; d < 65536; ++d) { i32 t = cnt[d]; cnt[d] = sum; sum += t; }
  for (int i = 0; i < n; ++i) dst[cnt[(src[i] >> shift) & 0xffff]++] = src[i];
  delete[] cnt;
}

static void radix_pass16_pair(const u64* src, const u8* sval, u64* dst, u8* dval,
                              int n, int shift) {
  i32* cnt = new i32[65536]();
  for (int i = 0; i < n; ++i) ++cnt[(src[i] >> shift) & 0xffff];
  i32 sum = 0;
  for (int d = 0; d < 65536; ++d) { i32 t = cnt[d]; cnt[d] = sum; sum += t; }
  for (int i = 0; i < n; ++i) {
    i32 p = cnt[(src[i] >> shift) & 0xffff]++;
    dst[p] = src[i];
    dval[p] = sval[i];
  }
  delete[] cnt;
}

// ST3..ST6 forward: two-pass LSD split exactly at a byte/nibble boundary
// (the scheme of st.cpp:56-236): one scatter keyed on the TRAILING context
// bytes, storing (leading bytes | preceding byte) packed in 16/32 bits,
// then one counting pass on the LEADING bytes that emits the payload bytes
// directly.  The phase-1 bucket array is reused as phase-2 ends when both
// keys are cyclic shifts of the same multiset (ST4/ST6).  Rank of position
// 0 falls out of the scan when it crosses its slot — no search.
//
// Unlike the reference we take no writable padding beyond T[n]; a padded
// source copy provides wrap-around reads (and phase 2 then writes into T
// with no aliasing).

static inline u8* padded_src(const u8* T, int n, int pad) {
  u8* Tp = new (std::nothrow) u8[(size_t)n + pad];
  if (!Tp) return nullptr;
  std::memcpy(Tp, T, (size_t)n);
  for (int j = 0; j < pad; ++j) Tp[n + j] = T[j % n];
  return Tp;
}

static int st3_fwd(u8* T, int n) {
  u8* Tp = padded_src(T, n, 8);
  u16* P = new (std::nothrow) u16[(size_t)n];
  i32* bucket = new (std::nothrow) i32[65536]();
  if (!Tp || !P || !bucket) { delete[] Tp; delete[] P; delete[] bucket; return -2; }
  i32 cnt[256] = {0};

  for (int i = 0; i < n; ++i) {
    bucket[((i32)Tp[i] << 8) | Tp[i + 1]]++;
    cnt[Tp[i]]++;
  }
  for (i32 sum = 0, d = 0; d < 65536; ++d) { i32 t = bucket[d]; bucket[d] = sum; sum += t; }
  for (i32 sum = 0, d = 0; d < 256; ++d) { i32 t = cnt[d]; cnt[d] = sum; sum += t; }

  const int pos = bucket[((i32)Tp[1] << 8) | Tp[2]];

  {  // scatter by (b1,b2); value = (prev << 8) | b0
    u8 prev = Tp[n - 1];
    for (int i = 0; i < n; ++i) {
      P[bucket[((i32)Tp[i + 1] << 8) | Tp[i + 2]]++] = (u16)(((i32)prev << 8) | Tp[i]);
      prev = Tp[i];
    }
  }
  int i = 0;
  for (; i < pos; ++i) T[cnt[P[i] & 0xff]++] = (u8)(P[i] >> 8);
  const int index = cnt[P[pos] & 0xff];
  for (; i < n; ++i) T[cnt[P[i] & 0xff]++] = (u8)(P[i] >> 8);
  delete[] Tp; delete[] P; delete[] bucket;
  return index;
}

static int st4_fwd(u8* T, int n) {
  u8* Tp = padded_src(T, n, 8);
  u32* P = new (std::nothrow) u32[(size_t)n];
  i32* bucket = new (std::nothrow) i32[65536]();
  if (!Tp || !P || !bucket) { delete[] Tp; delete[] P; delete[] bucket; return -2; }

  for (int i = 0; i < n; ++i) bucket[((i32)Tp[i] << 8) | Tp[i + 1]]++;
  for (i32 sum = 0, d = 0; d < 65536; ++d) { i32 t = bucket[d]; bucket[d] = sum; sum += t; }

  const int pos = bucket[((i32)Tp[2] << 8) | Tp[3]];

  {  // scatter by (b2,b3); value = (b0 << 24) | (b1 << 16) | prev
    u8 prev = Tp[n - 1];
    for (int i = 0; i < n; ++i) {
      P[bucket[((i32)Tp[i + 2] << 8) | Tp[i + 3]]++] =
          ((u32)Tp[i] << 24) | ((u32)Tp[i + 1] << 16) | prev;
      prev = Tp[i];
    }
  }
  // bucket now holds the END of each 2-gram run — the same multiset as
  // (b0,b1), so phase 2 reuses it descending
  int i = n - 1;
  for (; i >= pos; --i) T[--bucket[P[i] >> 16]] = (u8)(P[i] & 0xff);
  const int index = bucket[P[pos] >> 16];
  for (; i >= 0; --i) T[--bucket[P[i] >> 16]] = (u8)(P[i] & 0xff);
  delete[] Tp; delete[] P; delete[] bucket;
  return index;
}

static int st5_fwd(u8* T, int n) {
  u8* Tp = padded_src(T, n, 8);
  u32* P = new (std::nothrow) u32[(size_t)n];
  i32* bucket = new (std::nothrow) i32[1 << 20]();
  i32* bucket2 = new (std::nothrow) i32[1 << 20]();
  if (!Tp || !P || !bucket || !bucket2) {
    delete[] Tp; delete[] P; delete[] bucket; delete[] bucket2;
    return -2;
  }

  // one rolling scan feeds both phase keys: phase 1 (b2 low nibble, b3, b4)
  // and phase 2 (b0, b1, b2 high nibble) — the same 5-byte window multiset
  {
    u32 W = ((u32)Tp[0] << 16) | ((u32)Tp[1] << 8) | Tp[2];
    for (int i = 0; i < n; ++i) {
      bucket[W & 0x0fffff]++;
      bucket2[W >> 4]++;
      W = ((W << 8) & 0xffffff) | Tp[i + 3];
    }
  }
  for (i32 sum = 0, d = 0; d < (1 << 20); ++d) { i32 t = bucket[d]; bucket[d] = sum; sum += t; }

  const int pos =
      bucket[((i32)(Tp[2] & 0xf) << 16) | ((i32)Tp[3] << 8) | Tp[4]];

  {  // value = (b0 << 24) | (b1 << 16) | (b2 high nibble << 12) | prev
    u8 prev = Tp[n - 1];
    u64 W = ((u64)Tp[0] << 32) | ((u64)Tp[1] << 24) | ((u64)Tp[2] << 16) |
            ((u64)Tp[3] << 8) | Tp[4];
    for (int i = 0; i < n; ++i) {
      P[bucket[(u32)W & 0x0fffff]++] = (((u32)(W >> 8)) & 0xfffff000) | prev;
      prev = (u8)(W >> 32);
      W = ((W << 8) & 0xffffffffffull) | Tp[i + 5];
    }
  }
  for (i32 sum = 0, d = 0; d < (1 << 20); ++d) { sum += bucket2[d]; bucket2[d] = sum; }

  int i = n - 1;
  for (; i >= pos; --i) T[--bucket2[P[i] >> 12]] = (u8)(P[i] & 0xff);
  const int index = bucket2[P[pos] >> 12];
  for (; i >= 0; --i) T[--bucket2[P[i] >> 12]] = (u8)(P[i] & 0xff);
  delete[] Tp; delete[] P; delete[] bucket; delete[] bucket2;
  return index;
}

static int st6_fwd(u8* T, int n) {
  u8* Tp = padded_src(T, n, 8);
  u32* P = new (std::nothrow) u32[(size_t)n];
  i32* bucket = new (std::nothrow) i32[1 << 24]();
  if (!Tp || !P || !bucket) { delete[] Tp; delete[] P; delete[] bucket; return -2; }

  {
    u32 W = ((u32)Tp[0] << 16) | ((u32)Tp[1] << 8) | Tp[2];
    for (int i = 0; i < n; ++i) {
      bucket[W]++;
      W = ((W << 8) & 0xffffff) | Tp[i + 3];
    }
  }
  for (i32 sum = 0, d = 0; d < (1 << 24); ++d) { i32 t = bucket[d]; bucket[d] = sum; sum += t; }

  const int pos = bucket[((i32)Tp[3] << 16) | ((i32)Tp[4] << 8) | Tp[5]];

  {  // scatter by (b3,b4,b5); value = (b0 << 24) | (b1 << 16) | (b2 << 8) | prev
    u8 prev = Tp[n - 1];
    u64 W = ((u64)Tp[0] << 40) | ((u64)Tp[1] << 32) | ((u64)Tp[2] << 24) |
            ((u64)Tp[3] << 16) | ((u64)Tp[4] << 8) | Tp[5];
    for (int i = 0; i < n; ++i) {
      P[bucket[(u32)W & 0xffffff]++] = (((u32)(W >> 16)) & 0xffffff00) | prev;
      prev = (u8)(W >> 40);
      W = ((W << 8) & 0xffffffffffffull) | Tp[i + 6];
    }
  }
  // 3-gram ends reused descending for the (b0,b1,b2) pass
  int i = n - 1;
  for (; i >= pos; --i) T[--bucket[P[i] >> 8]] = (u8)(P[i] & 0xff);
  const int index = bucket[P[pos] >> 8];
  for (; i >= 0; --i) T[--bucket[P[i] >> 8]] = (u8)(P[i] & 0xff);
  delete[] Tp; delete[] P; delete[] bucket;
  return index;
}

int st_encode(u8* T, int n, int k, int /*num_threads*/) {
  if (n <= 1) return 0;
  if (k < 3 || k > 8) return -1;

  if (k == 3) return st3_fwd(T, n);
  if (k == 4) return st4_fwd(T, n);
  if (k == 5) return st5_fwd(T, n);
  if (k == 6) return st6_fwd(T, n);

  if (k <= 7) {
    u64* a = new (std::nothrow) u64[(size_t)n];
    u64* b = new (std::nothrow) u64[(size_t)n];
    if (!a || !b) { delete[] a; delete[] b; return -2; }

    // key = ctx bytes (big-endian, byte j at bits 8*(k-j)) | prev byte
    u64 key = 0;
    for (int j = 0; j < k; ++j) key = (key << 8) | T[j % n];
    key <<= 8;
    u64 ctx_mask = ((~0ull) >> (64 - 8 * k)) << 8;
    for (int i = 0; i < n; ++i) {
      u64 prev = T[(i + n - 1) % n];
      a[i] = (key & ctx_mask) | prev;
      key = (key << 8) | ((u64)T[(i + k) % n] << 8);
    }
    u64 key0 = a[0] & ctx_mask;

    int passes = (k + 1) / 2;
    u64 *src = a, *dst = b;
    for (int p = 0; p < passes; ++p) {
      radix_pass16(src, dst, n, 8 + 16 * p);
      u64* t = src; src = dst; dst = t;
    }

    // rank of position 0 = first entry whose context equals ctx(0)
    int lo = 0, hi = n;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if ((src[mid] & ctx_mask) < key0) lo = mid + 1; else hi = mid;
    }
    int index = lo;

    for (int i = 0; i < n; ++i) T[i] = (u8)src[i];
    delete[] a;
    delete[] b;
    return index;
  }

  // k == 8: full 64-bit context key + separate payload byte
  u64* a = new (std::nothrow) u64[(size_t)n];
  u64* b = new (std::nothrow) u64[(size_t)n];
  u8* av = new (std::nothrow) u8[(size_t)n];
  u8* bv = new (std::nothrow) u8[(size_t)n];
  if (!a || !b || !av || !bv) { delete[] a; delete[] b; delete[] av; delete[] bv; return -2; }

  u64 key = 0;
  for (int j = 0; j < 8; ++j) key = (key << 8) | T[j % n];
  for (int i = 0; i < n; ++i) {
    a[i] = key;
    av[i] = T[(i + n - 1) % n];
    key = (key << 8) | T[(i + 8) % n];
  }
  u64 key0 = a[0];

  u64 *src = a, *dst = b;
  u8 *sval = av, *dval = bv;
  for (int p = 0; p < 4; ++p) {
    radix_pass16_pair(src, sval, dst, dval, n, 16 * p);
    u64* t = src; src = dst; dst = t;
    u8* tv = sval; sval = dval; dval = tv;
  }

  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (src[mid] < key0) lo = mid + 1; else hi = mid;
  }
  int index = lo;

  std::memcpy(T, sval, (size_t)n);
  delete[] a;
  delete[] b;
  delete[] av;
  delete[] bv;
  return index;
}

// ---------------------------------------------------------------------------
// Inverse
// ---------------------------------------------------------------------------

// Mark order-(k-1) context-group starts in M (any nonzero bit = start).
// M is a dedicated byte array: each refinement round reads one sequential
// byte stream and scatter-ORs one byte, a third of the traffic of marking
// inside the 4-byte link array (and P needs no zero-fill pass at all).
// Returns failBack = some char count >= 2^23 (packed-link layouts overflow).
static bool unst_mark_groups(const u8* T, u8* M, u32* count, int n, int k) {
  u32* bucket = new u32[65536]();
  u32 index[256];
  i32 group[256];

  bool fail_back = false;
  u32 cnt[256];
  std::memset(cnt, 0, sizeof cnt);
  for (int i = 0; i < n; ++i) ++cnt[T[i]];
  {
    u32 sum = 0;
    for (int c = 0; c < 256; ++c) {
      if (cnt[c] >= 0x800000) fail_back = true;
      count[c] = sum;
      u32 end = sum + cnt[c];
      // sub-histogram: output bytes within first-context-byte bucket c
      for (u32 i = sum; i < end; ++i) ++bucket[(c << 8) | T[i]];
      sum = end;
    }
  }
  // transpose: bucket[(c1<<8)|c2] = count of order-2 context (c1,c2)
  for (int c = 0; c < 256; ++c)
    for (int d = 0; d < c; ++d) {
      u32 t = bucket[(d << 8) | c];
      bucket[(d << 8) | c] = bucket[(c << 8) | d];
      bucket[(c << 8) | d] = t;
    }

  if (k == 3) {
    u32 sum = 0;
    for (int w = 0; w < 65536; ++w) {
      if (bucket[w] > 0) { M[sum] = 1; sum += bucket[w]; }
    }
    delete[] bucket;
    return fail_back;
  }

  // order-3 starts: LF-scan over order-2 groups
  std::memcpy(index, count, sizeof index);
  std::memset(group, 0xff, sizeof group);
  {
    u32 sum = 0;
    for (int w = 0; w < 65536; ++w) {
      u32 end = sum + bucket[w];
      for (u32 i = sum; i < end; ++i) {
        u8 c = T[i];
        if (group[c] != w) { group[c] = w; M[index[c]] = 1; }
        ++index[c];
      }
      sum = end;
    }
  }

  // refine to order-(k-1); every round re-marks all coarser starts (starts
  // are monotone under refinement), so round r only tests round r-1's bit
  // and the final round's bit alone identifies every order-(k-1) start.
  // branchless rounds: group starts are dense at orders 4+ (both the
  // "new group" and "first occurrence in group" tests flip constantly on
  // real data), so conditional moves + an unconditional scatter-OR beat
  // the branchy form.
  u8 mask0 = 1, mask1 = 2;
  for (int round = 4; round < k; ++round, mask0 <<= 1, mask1 <<= 1) {
    std::memcpy(index, count, sizeof index);
    std::memset(group, 0xff, sizeof group);
    for (i32 g = 0, i = 0; i < n; ++i) {
      g = (M[i] & mask0) ? i : g;
      u8 c = T[i];
      u8 fresh = (group[c] != g) ? mask1 : 0;
      group[c] = g;
      M[index[c]++] |= fresh;
    }
  }

  delete[] bucket;
  return fail_back;
}

// Annotation: convert group marks into per-position walk records.  Three
// layouts by n / per-char counts:
//   A (n < 2^23):      P[i] = (char << 24) | leader-flag | absolute link
//   B (counts < 2^23): P[i] = (char << 24) | leader-flag | bucket-relative link
//   C (fail-back):     P[i] = link only; char recovered by fastbits search
// Duplicate (char, group) members point at their leader; the leader's link
// field counts down as the walk consumes the tie range.

// Layout A' (n < 2^23): singleton (char, group) entries carry their
// destination directly (no live state, so the walk neither re-reads nor
// writes them); tie ranges get a dense group id and their countdown
// counter lives in a COMPACT side array rather than in the leader's P slot.
// Ties are a small fraction of n, so the counters stay cache-resident and
// a tie costs one near access instead of a second far P read + dirty line.
// This replaces the reference's leader-countdown-in-place walk
// (st.cpp:1100-1130) with a different data layout; outputs are identical.
static i32 unst_annotate_dense(const u8* T, const u8* M, u32* P,
                               const u32* count, int n, u32* cnt) {
  u32 index[256];
  i32 group[256];
  std::memcpy(index, count, sizeof index);
  std::memset(group, 0xff, sizeof group);

  i32 ngid = 0;
  for (i32 g = 0, i = 0; i < n; ++i) {
    if (M[i]) g = i;
    u8 c = T[i];
    if (group[c] < g) {
      group[c] = i;
      P[i] = ((u32)c << 24) | index[c];
    } else {
      u32 lu = P[group[c]];
      u32 gid;
      if (lu & 0x800000u) {
        gid = lu & 0x7fffffu;
      } else {
        gid = (u32)ngid++;
        cnt[gid] = lu & 0x7fffffu;
        P[group[c]] = ((u32)c << 24) | 0x800000u | gid;
      }
      P[i] = ((u32)c << 24) | 0x800000u | gid;
      ++cnt[gid];
    }
    ++index[c];
  }
  return ngid;
}

static void unst_annotate_relative(const u8* T, const u8* M, u32* P, int n) {
  u32 index[256];
  i32 group[256];
  std::memset(index, 0, sizeof index);
  std::memset(group, 0xff, sizeof group);

  for (i32 g = 0, i = 0; i < n; ++i) {
    if (M[i]) g = i;
    u8 c = T[i];
    if (group[c] < g) {
      group[c] = i;
      P[i] = ((u32)c << 24) | index[c];
    } else {
      P[i] = ((u32)c << 24) | 0x800000u | (u32)(i - group[c]);
      ++P[group[c]];
    }
    ++index[c];
  }
}

static void unst_annotate_search(const u8* T, const u8* M, u32* P,
                                 const u32* count, int n) {
  u32 index[256];
  i32 group[256];
  std::memcpy(index, count, sizeof index);
  std::memset(group, 0xff, sizeof group);

  for (i32 g = 0, i = 0; i < n; ++i) {
    if (M[i]) g = i;
    u8 c = T[i];
    if (group[c] < g) {
      group[c] = i;
      P[i] = index[c];
    } else {
      P[i] = 0x80000000u | (u32)group[c];
      ++P[group[c]];
    }
    ++index[c];
  }
}

constexpr int kFastBits = 10;

// Per-block walk state for the interleaved batch walk.
struct UnstWalk {
  u8* T;
  u32* P;
  u32* cnt;  // layout 0: dense tie countdown counters
  u32 count[256];
  int n;
  int p;       // current position in sorted space
  int i;       // next output index (walk goes backward)
  int layout;  // 0 = packed, 1 = relative, 2 = search
  // layout 2 only:
  u32 ends[256];
  u8 fastbits[1 << kFastBits];
  int shift;
};

static inline u8 unst_char_of(const UnstWalk& w, int p) {
  int c = w.fastbits[p >> w.shift];
  while (w.ends[c] <= (u32)p) ++c;
  return (u8)c;
}

// One backward step of a walk; returns false when the block is done.
static inline bool unst_step(UnstWalk& w) {
  int p = w.p;
  switch (w.layout) {
    case 0: {
      u32 u = w.P[p];
      w.T[w.i] = (u8)(u >> 24);
      if (u & 0x800000u) p = (int)(w.cnt[u & 0x7fffffu]--);
      else p = (int)(u & 0x7fffffu);
      break;
    }
    case 1: {
      u32 u = w.P[p];
      if (u & 0x800000u) { p = p - (int)(u & 0x7fffffu); u = w.P[p]; }
      u8 c = (u8)(u >> 24);
      w.T[w.i] = c;
      --w.P[p];
      p = (int)(u & 0x7fffffu) + (int)w.count[c];
      break;
    }
    default: {
      u32 u = w.P[p];
      if (u & 0x80000000u) { p = (int)(u & 0x7fffffffu); u = w.P[p]; }
      w.T[w.i] = unst_char_of(w, p);
      --w.P[p];
      p = (int)u;
      break;
    }
  }
  __builtin_prefetch(&w.P[p]);
  w.p = p;
  return --w.i >= (w.layout == 2 ? 1 : 0);
}

// Prepare one block: group marking + annotation + walk-state init.
// Returns 0 or a negative error.
static int unst_prepare(UnstWalk& w, u8* T, int n, int k, int index) {
  w.T = T;
  w.n = n;
  w.P = (u32*)halloc((size_t)n * sizeof(u32));
  u8* M = (u8*)halloc((size_t)n);
  if (!w.P || !M) { hfree(M); return -2; }
  std::memset(M, 0, (size_t)n);
  bool fail_back = unst_mark_groups(T, M, w.count, n, k);
  if (n < 0x800000) {
    w.layout = 0;
    w.cnt = (u32*)halloc(((size_t)n / 2 + 1) * sizeof(u32));
    if (!w.cnt) { hfree(M); return -2; }
    unst_annotate_dense(T, M, w.P, w.count, n, w.cnt);
  } else if (!fail_back) {
    w.layout = 1;
    unst_annotate_relative(T, M, w.P, n);
  } else {
    w.layout = 2;
    unst_annotate_search(T, M, w.P, w.count, n);
    w.shift = 0;
    while (((n - 1) >> w.shift) >= (1 << kFastBits)) ++w.shift;
    int v = 0;
    for (int c = 0; c < 256; ++c) {
      w.ends[c] = (c + 1 < 256) ? w.count[c + 1] : (u32)n;
      if (w.count[c] != w.ends[c])
        for (; v <= (int)((w.ends[c] - 1) >> w.shift); ++v)
          w.fastbits[v] = (u8)c;
    }
  }
  hfree(M);
  // first step: the search layout peels the T[0] output specially
  if (w.layout == 2) {
    int p = index;
    if (w.P[p] & 0x80000000u) p = (int)(w.P[p] & 0x7fffffffu);
    T[0] = unst_char_of(w, p);
    --w.P[p];
    w.p = (int)w.P[p] + 1;
    w.i = n - 1;
  } else {
    w.p = index;
    w.i = n - 1;
  }
  return 0;
}

// Batch inverse: interleave the backward walks of independent blocks.  One
// block's walk is a serial pointer chase — one dependent cache miss per
// output byte — but across blocks the chases are independent, so stepping
// B blocks per loop iteration keeps B misses in flight (the same
// memory-level-parallelism trick as the aux-chain unbwt in bwt.cc, applied
// across blocks because the ST stream format carries no mid-block entry
// points).  Setup passes run per block; only the walks interleave.
int st_decode_batch(u8** Ts, const i32* ns, int k, const i32* indexes,
                    int nblocks) {
  if (nblocks <= 0 || k < 3 || k > 8) return -1;
  for (int b = 0; b < nblocks; ++b) {
    if (ns[b] < 0) return -1;
    if (ns[b] > 1 && (indexes[b] < 0 || indexes[b] >= ns[b])) return -1;
  }

  UnstWalk* ws = new (std::nothrow) UnstWalk[(size_t)nblocks]();
  if (!ws) return -2;
  int live = 0;
  int rc = 0;
  for (int b = 0; b < nblocks && rc == 0; ++b) {
    if (ns[b] <= 1) continue;
    rc = unst_prepare(ws[live], Ts[b], ns[b], k, indexes[b]);
    if (rc == 0) ++live;
  }
  if (rc == 0) {
    while (live > 0) {
      for (int b = 0; b < live;) {
        if (unst_step(ws[b])) {
          ++b;
        } else {
          // finished: swap the last live walk into this slot
          hfree(ws[b].P);
          hfree(ws[b].cnt);
          ws[b].P = nullptr;
          ws[b].cnt = nullptr;
          ws[b] = ws[--live];
          ws[live].P = nullptr;
          ws[live].cnt = nullptr;
        }
      }
    }
  }
  for (int b = 0; b < nblocks; ++b) { hfree(ws[b].P); hfree(ws[b].cnt); }
  delete[] ws;
  return rc;
}

int st_decode(u8* T, int n, int k, int index, int /*num_threads*/) {
  if (n <= 1 && n >= 0 && k >= 3 && k <= 8) return 0;
  i32 ns = n, idx = index;
  return st_decode_batch(&T, &ns, k, &idx, 1);
}

}  // namespace tbsc
