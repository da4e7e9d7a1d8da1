// Entropy-coder block dispatcher: splits a post-BWT block into 1/2/4/8
// sub-blocks at rank-change-balanced boundaries, codes each independently
// (QLFC static/adaptive/fast), and serializes the sub-block directory.
// Stream layout matches the reference (coder.cpp:52-155): count byte, then
// for >1 sub-blocks a directory of (rawSize, packedSize) int32 pairs, then
// payloads; an incompressible sub-block is stored raw.

#include <cstdint>
#include <cstring>
#include <new>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace tbsc {

using u8 = uint8_t;

int qlfc_encode_block(const u8* input, u8* output, int isize, int osize, int kind);
int qlfc_decode_block(const u8* input, u8* output, int kind);

static int coder_num_blocks(int n) {
  if (n < 256 * 1024) return 1;
  if (n < 4 * 1024 * 1024) return 2;
  if (n < 16 * 1024 * 1024) return 4;
  return 8;
}

// Split at sampled rank-change boundaries so each sub-block carries a similar
// amount of post-MTF work (coder.cpp:70-109).
static void split_blocks(const u8* input, int n, int n_blocks, int* start, int* size) {
  int rank_size = 0;
  for (int i = 1; i < n; i += 32)
    if (input[i] != input[i - 1]) ++rank_size;

  if (rank_size > n_blocks) {
    int per_block = rank_size / n_blocks;
    start[0] = 0;
    rank_size = 0;
    int id = 0;
    for (int i = 1; i < n; i += 32) {
      if (input[i] != input[i - 1]) {
        if (++rank_size == per_block) {
          rank_size = 0;
          size[id] = i - start[id];
          ++id;
          start[id] = i;
          if (id == n_blocks - 1) break;
        }
      }
    }
    size[n_blocks - 1] = n - start[n_blocks - 1];
  } else {
    for (int p = 0; p < n_blocks; ++p) {
      start[p] = (n / n_blocks) * p;
      size[p] = (p != n_blocks - 1) ? n / n_blocks : n - (n / n_blocks) * (n_blocks - 1);
    }
  }
}

static void put_i32(u8* p, int v) { std::memcpy(p, &v, 4); }
static int get_i32(const u8* p) { int v; std::memcpy(&v, p, 4); return v; }

int coder_compress(const u8* input, u8* output, int n, int kind, int num_threads) {
  int n_blocks = coder_num_blocks(n);
  if (n_blocks == 1) {
    int r = qlfc_encode_block(input, output + 1, n, n - 1, kind);
    if (r >= 0) { output[0] = 1; return r + 1; }
    return r;
  }

  int start[8], size[8], packed[8];
  split_blocks(input, n, n_blocks, start, size);
  output[0] = (u8)n_blocks;

#ifdef _OPENMP
  if (num_threads > 1) {
    // Parallel: code into per-sub-block scratch, then compact.
    u8* scratch = new (std::nothrow) u8[(size_t)n];
    if (scratch) {
      #pragma omp parallel for schedule(dynamic) num_threads(num_threads)
      for (int b = 0; b < n_blocks; ++b) {
        int r = qlfc_encode_block(input + start[b], scratch + start[b], size[b], size[b], kind);
        packed[b] = r < 0 ? size[b] : r;
      }
      int out_ptr = 1 + 8 * n_blocks;
      long long total = out_ptr;
      for (int b = 0; b < n_blocks; ++b) total += packed[b];
      if (total >= n) { delete[] scratch; return -3; }
      for (int b = 0; b < n_blocks; ++b) {
        put_i32(output + 1 + 8 * b, size[b]);
        put_i32(output + 1 + 8 * b + 4, packed[b]);
        const u8* src = packed[b] != size[b] ? scratch + start[b] : input + start[b];
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
    int budget = size[b];
    if (budget > n - out_ptr) budget = n - out_ptr;
    int r = qlfc_encode_block(input + start[b], output + out_ptr, size[b], budget, kind);
    if (r < 0) {
      if (out_ptr + size[b] >= n) return -3;
      r = size[b];
      std::memcpy(output + out_ptr, input + start[b], (size_t)size[b]);
    }
    put_i32(output + 1 + 8 * b, size[b]);
    put_i32(output + 1 + 8 * b + 4, r);
    out_ptr += r;
  }
  return out_ptr;
}

int coder_decompress(const u8* input, u8* output, int kind, int num_threads) {
  int n_blocks = input[0];
  if (n_blocks == 1) return qlfc_decode_block(input + 1, output, kind);

  int results[256];
  int in_ptr[256], out_ptr[256], in_size[256], out_size[256];
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
      results[b] = qlfc_decode_block(input + in_ptr[b], output + out_ptr[b], kind);
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
