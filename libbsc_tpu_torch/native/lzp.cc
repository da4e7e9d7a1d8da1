// LZP (Lempel-Ziv prediction) preprocessing stage.
//
// Stream format (matches reference lzp.cpp): the first 4 bytes pass through
// verbatim; afterwards, at each position whose order-4 context hash hits a
// table entry pointing at a previous position, either
//   - a confirmed match of >= minLen bytes is replaced by the flag byte 0xf2
//     followed by (len - minLen) in base-254 continuation bytes, or
//   - a literal 0xf2 under a hash hit is escaped as 0xf2 0xff.
// A literal 0xf2 with no hash hit is NOT escaped.  Hash updates on the
// decoder mirror the encoder exactly, including inside copied matches.
//
// The encoder keeps the reference's match POLICY (same probes, extension
// arithmetic, and failed-region heuristic, so streams land within noise of
// the reference's sizes) but is organized around hash WINDOWS instead of a
// byte-serial context chain: context hashes for a span of upcoming
// positions are precomputed straight from the input bytes (they do not
// depend on coding decisions while no match fires), which removes the
// serial context register, lets the hash computation pipeline, and allows
// prefetching the hash-table lines a full window ahead.  A fired match
// invalidates the rest of the window (positions inside a match must not
// touch the table — the decoder mirrors updates only at decision points).
// Sub-block splitting (1/2/4/8 chunks with an in-stream directory,
// lzp.cpp:676-715) is applied above.

#include <cstdint>
#include <cstring>
#include <new>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace tbsc {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;

static const int kFlag = 0xf2;

static inline u32 ld32(const u8* p) { u32 v; std::memcpy(&v, p, 4); return v; }
static inline uint64_t ld64(const u8* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

// context of position p = previous 4 bytes, oldest in the high byte
static inline u32 ctx_at(const u8* p) { return __builtin_bswap32(ld32(p - 4)); }

static inline u32 ctx_hash(u32 c, u32 mask) {
  return ((c >> 15) ^ c ^ (c >> 3)) & mask;
}

int lzp_encode_block(const u8* input, const u8* input_end, u8* output, u8* output_end,
                     int hash_size, int min_len) {
  const int n = (int)(input_end - input);
  if (n - min_len < 32) return -3;

  const u32 mask = (1u << hash_size) - 1;
  int* tab = new (std::nothrow) int[(size_t)1 << hash_size]();
  if (!tab) return -2;

  const u8* const base = input;
  u8* const out_base = output;
  u8* const out_eob = output_end - 8;
  const int main_end = n - min_len - 32;  // last position eligible for a match
  int heur = 0;  // failed-region frontier (position index)

  output[0] = input[0]; output[1] = input[1];
  output[2] = input[2]; output[3] = input[3];
  output += 4;

  enum { W = 128, HPF = 16 };
  u32 hbuf[W];

  int pos = 4;
  while (pos < main_end && output < out_eob - 2 * W - 8) {
    const int wlen = (main_end - pos) < W ? (main_end - pos) : W;
    // hashes for the whole window straight from the bytes — no serial chain
    for (int w = 0; w < wlen; ++w)
      hbuf[w] = ctx_hash(ctx_at(base + pos + w), mask);

    // Pass A: probe/update the whole window WITHOUT emitting; stop at the
    // first real match.  Pass B then emits the literal run in bulk (memcpy
    // when the run holds no flag byte — the dominant case on incompressible
    // data, where the old byte-at-a-time interleave was ~25% slower than
    // the reference's scan).  Stream bytes are identical.
    bool jumped = false;
    int match_at = -1, match_len = 0;
    u8 hadcand[W];  // flag-byte literals are escaped ONLY at positions
                    // that had a table candidate (stream rule)
    int w = 0;
    for (; w < wlen; ++w) {
      if (w + HPF < wlen) __builtin_prefetch(&tab[hbuf[w + HPF]], 1);
      const int at = pos + w;
      const int cand = tab[hbuf[w]];
      tab[hbuf[w]] = at;
      hadcand[w] = cand > 0;
      if (cand <= 0) continue;
      const u8* cur = base + at;
      const u8* ref = base + cand;
      // selective probes first (tail of the minimal match, then head);
      // both are implied by any true >= min_len match.  (The exact match
      // CHOICES differ from the reference's — its heuristic gate is
      // quantized to its 4-way unrolled group base — so LZP streams are
      // mutually decodable rather than byte-identical, as in rounds 1-2.)
      if (ld32(cur + min_len - 4) == ld32(ref + min_len - 4) &&
          ld32(cur) == ld32(ref)) {
        if (heur > at && ld32(base + heur) != ld32(ref + (heur - at))) {
          // inside a region that already failed to extend: do not rescan
        } else {
          int len = 4;
          while (at + len < main_end && ld32(cur + len) == ld32(ref + len))
            len += 4;
          if (len >= min_len) {
            len += 2 * (cur[len] == ref[len] && cur[len + 1] == ref[len + 1]);
            len += (cur[len] == ref[len]);
            match_at = at;
            match_len = len;
            break;
          }
          if (heur < at + len) heur = at + len;
        }
      }
    }
    {  // pass B: literals [pos, pos + w)
      const u8* src = base + pos;
      int lits = w;
      if (std::memchr(src, kFlag, (size_t)lits) == nullptr) {
        std::memcpy(output, src, (size_t)lits);
        output += lits;
      } else {
        for (int j = 0; j < lits; ++j) {
          u8 lit = src[j];
          *output++ = lit;
          if (lit == kFlag && hadcand[j]) *output++ = 255;
        }
      }
    }
    if (match_at >= 0) {
      *output++ = kFlag;
      for (int rem = match_len - min_len; ; rem -= 254) {
        if (rem < 254) { *output++ = (u8)rem; break; }
        *output++ = 254;
        if (output >= out_eob) break;
      }
      // window positions past the match are intra-match: no table updates
      pos = match_at + match_len;
      jumped = true;
    }
    if (!jumped) pos += wlen;
  }

  // Remainder of the match-eligible span plus the tail, byte-serial with the
  // exact per-byte overflow checks (this path also runs when the output is
  // nearly full, preserving the reference's incompressible cutoff).
  while (pos < main_end && output < out_eob) {
    const u32 h = ctx_hash(ctx_at(base + pos), mask);
    const int cand = tab[h];
    tab[h] = pos;
    const u8 lit = base[pos];
    if (cand > 0) {
      const u8* cur = base + pos;
      const u8* ref = base + cand;
      int mlen = 0;
      if (ld32(cur + min_len - 4) == ld32(ref + min_len - 4) &&
          ld32(cur) == ld32(ref)) {
        if (heur > pos && ld32(base + heur) != ld32(ref + (heur - pos))) {
          // failed region
        } else {
          int len = 4;
          while (pos + len < main_end && ld32(cur + len) == ld32(ref + len))
            len += 4;
          if (len >= min_len) {
            len += 2 * (cur[len] == ref[len] && cur[len + 1] == ref[len + 1]);
            len += (cur[len] == ref[len]);
            mlen = len;
          } else if (heur < pos + len) {
            heur = pos + len;
          }
        }
      }
      if (mlen > 0) {
        *output++ = kFlag;
        for (int rem = mlen - min_len; ; rem -= 254) {
          if (rem < 254) { *output++ = (u8)rem; break; }
          *output++ = 254;
          if (output >= out_eob) break;
        }
        pos += mlen;
        continue;
      }
      *output++ = lit;
      ++pos;
      if (lit == kFlag) *output++ = 255;
    } else {
      *output++ = lit;
      ++pos;
    }
  }

  // Tail: literals only, with flag escaping under hash hits.
  while (pos < n && output < out_eob) {
    const u32 h = ctx_hash(ctx_at(base + pos), mask);
    const int cand = tab[h];
    tab[h] = pos;
    const u8 lit = base[pos++];
    *output++ = lit;
    if (lit == kFlag && cand > 0) *output++ = 255;
  }

  delete[] tab;
  return output >= out_eob ? -3 : (int)(output - out_base);
}

int lzp_decode_block(const u8* input, const u8* input_end, u8* output,
                     int hash_size, int min_len) {
  if (input_end - input < 4) return -5;

  const u32 mask = (1u << hash_size) - 1;
  int* lookup = new (std::nothrow) int[(size_t)1 << hash_size]();
  if (!lookup) return -2;

  const u8* out_start = output;
  for (int i = 0; i < 4; ++i) *output++ = *input++;

  u32 context = ctx_at(output);
  while (input < input_end) {
    u32 idx = ctx_hash(context, mask);
    int value = lookup[idx];
    lookup[idx] = (int)(output - out_start);
    if (*input == kFlag && value > 0) {
      ++input;
      if (*input != 255) {
        int len = min_len;
        for (;;) {
          len += *input;
          if (*input++ != 254) break;
        }
        const u8* ref = out_start + value;
        u8* out_end = output + len;
        while (output < out_end) *output++ = *ref++;
        context = ctx_at(output);
      } else {
        ++input;
        context = (context << 8) | (*output++ = kFlag);
      }
    } else {
      context = (context << 8) | (*output++ = *input++);
    }
  }

  delete[] lookup;
  return (int)(output - out_start);
}

static int lzp_num_blocks(int n) {
  if (n < 256 * 1024) return 1;
  if (n < 4 * 1024 * 1024) return 2;
  if (n < 16 * 1024 * 1024) return 4;
  return 8;
}

static void put_i32(u8* p, int v) { std::memcpy(p, &v, 4); }
static int get_i32(const u8* p) { int v; std::memcpy(&v, p, 4); return v; }

int lzp_compress(const u8* input, u8* output, int n, int hash_size, int min_len,
                 int num_threads) {
  int n_blocks = lzp_num_blocks(n);
  if (n_blocks == 1) {
    int r = lzp_encode_block(input, input + n, output + 1, output + n - 1, hash_size, min_len);
    if (r >= 0) { output[0] = 1; return r + 1; }
    return r;
  }

  int chunk = n / n_blocks;
  int packed[8], sizes[8];
  for (int b = 0; b < n_blocks; ++b)
    sizes[b] = b != n_blocks - 1 ? chunk : n - b * chunk;
  output[0] = (u8)n_blocks;

#ifdef _OPENMP
  if (num_threads > 1) {
    u8* scratch = new (std::nothrow) u8[(size_t)n];
    if (scratch) {
      #pragma omp parallel for schedule(dynamic) num_threads(num_threads)
      for (int b = 0; b < n_blocks; ++b) {
        int start = b * chunk;
        int r = lzp_encode_block(input + start, input + start + sizes[b],
                                 scratch + start, scratch + start + sizes[b],
                                 hash_size, min_len);
        packed[b] = r < 0 ? sizes[b] : r;
      }
      long long total = 1 + 8 * n_blocks;
      for (int b = 0; b < n_blocks; ++b) total += packed[b];
      if (total >= n) { delete[] scratch; return -3; }
      int out_ptr = 1 + 8 * n_blocks;
      for (int b = 0; b < n_blocks; ++b) {
        put_i32(output + 1 + 8 * b, sizes[b]);
        put_i32(output + 1 + 8 * b + 4, packed[b]);
        const u8* src = packed[b] != sizes[b] ? scratch + b * chunk : input + b * chunk;
        std::memcpy(output + out_ptr, src, (size_t)packed[b]);
        out_ptr += packed[b];
      }
      delete[] scratch;
      return out_ptr;
    }
  }
#endif
  (void)num_threads;

  int out_ptr = 1 + 8 * n_blocks;
  for (int b = 0; b < n_blocks; ++b) {
    int start = b * chunk;
    int budget = sizes[b];
    if (budget > n - out_ptr) budget = n - out_ptr;
    int r = lzp_encode_block(input + start, input + start + sizes[b],
                             output + out_ptr, output + out_ptr + budget,
                             hash_size, min_len);
    if (r < 0) {
      if (out_ptr + sizes[b] >= n) return -3;
      r = sizes[b];
      std::memcpy(output + out_ptr, input + start, (size_t)sizes[b]);
    }
    put_i32(output + 1 + 8 * b, sizes[b]);
    put_i32(output + 1 + 8 * b + 4, r);
    out_ptr += r;
  }
  return out_ptr;
}

int lzp_decompress(const u8* input, u8* output, int n, int hash_size, int min_len,
                   int num_threads) {
  int n_blocks = input[0];
  if (n_blocks == 1)
    return lzp_decode_block(input + 1, input + n, output, hash_size, min_len);

  int results[256], in_ptr[256], out_ptr[256], in_size[256], out_size[256];
  {
    int ip = 1 + 8 * n_blocks, op = 0;
    for (int b = 0; b < n_blocks; ++b) {
      out_size[b] = get_i32(input + 1 + 8 * b);
      in_size[b] = get_i32(input + 1 + 8 * b + 4);
      in_ptr[b] = ip;
      out_ptr[b] = op;
      ip += in_size[b];
      op += out_size[b];
    }
  }

#ifdef _OPENMP
  #pragma omp parallel for schedule(dynamic) num_threads(num_threads > 0 ? num_threads : 1) if (num_threads > 1)
#endif
  for (int b = 0; b < n_blocks; ++b) {
    if (in_size[b] != out_size[b]) {
      results[b] = lzp_decode_block(input + in_ptr[b], input + in_ptr[b] + in_size[b],
                                    output + out_ptr[b], hash_size, min_len);
    } else {
      results[b] = in_size[b];
      std::memcpy(output + out_ptr[b], input + in_ptr[b], (size_t)in_size[b]);
    }
  }

  int total = 0;
  for (int b = 0; b < n_blocks; ++b) {
    if (results[b] < 0) return results[b];
    total += results[b];
  }
  return total;
}

}  // namespace tbsc
