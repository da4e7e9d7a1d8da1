// C ABI for the tbsc native host runtime (loaded from Python via ctypes).

#include <cstdint>

#include "cm.h"

namespace tbsc {
FormatTables g_tables = {nullptr, nullptr, nullptr, nullptr};

int qlfc_init();
int qlfc_encode_block(const uint8_t*, uint8_t*, int, int, int);
int qlfc_decode_block(const uint8_t*, uint8_t*, int);
void qlfc_release_scratch();
int coder_compress(const uint8_t*, uint8_t*, int, int, int);
int coder_decompress(const uint8_t*, uint8_t*, int, int);
int lzp_encode_block(const uint8_t*, const uint8_t*, uint8_t*, uint8_t*, int, int);
int lzp_decode_block(const uint8_t*, const uint8_t*, uint8_t*, int, int);
int lzp_compress(const uint8_t*, uint8_t*, int, int, int, int);
int lzp_decompress(const uint8_t*, uint8_t*, int, int, int, int);
int bwt_encode(uint8_t*, int, uint8_t*, int32_t*, int);
int bwt_encode_rate(uint8_t*, int, int, int32_t*);
int bwt_decode_rate(uint8_t*, int, int, int, int, const int32_t*);
int bwt_decode(uint8_t*, int, int, int, const int32_t*, int);
int st_encode(uint8_t*, int, int, int);
uint32_t adler32(const uint8_t*, int64_t, uint32_t);
int st_decode(uint8_t*, int, int, int, int);
int st_decode_batch(uint8_t**, const int32_t*, int, const int32_t*, int);
int wide_encode(const uint8_t*, int64_t, uint8_t*, int64_t, int, const int32_t*, int);
int wide_set_priors(const int16_t*);
int wide_balanced_sizes(const uint8_t*, int64_t, int, int32_t*);
int wide_decode(const uint8_t*, int64_t, uint8_t*, int64_t);
int wide_ranks(const uint8_t*, int64_t, int, int, int32_t*, int32_t*, int32_t*);
int wide_schedule(const uint8_t*, int64_t, int, int, uint8_t*, uint8_t*, const int32_t*);
int wide_schedule_packed(const uint8_t*, int64_t, int, int, uint8_t*, const int32_t*);
}  // namespace tbsc

extern "C" {

// Install the format-constant tables (int16[4097] stretch, int16[4097]
// squash, uint8[32768] rank-state, uint8[8192] run-state).  The caller owns
// the memory and must keep it alive for the process lifetime.
int tbsc_set_tables(const int16_t* stretch, const int16_t* squash,
                    const uint8_t* rank_state, const uint8_t* run_state) {
  tbsc::g_tables.stretch = stretch;
  tbsc::g_tables.squash = squash;
  tbsc::g_tables.rank_state = rank_state;
  tbsc::g_tables.run_state = run_state;
  return tbsc::qlfc_init();
}

int tbsc_qlfc_encode_block(const uint8_t* in, uint8_t* out, int isize, int osize, int kind) {
  return tbsc::qlfc_encode_block(in, out, isize, osize, kind);
}

int tbsc_qlfc_decode_block(const uint8_t* in, uint8_t* out, int kind) {
  return tbsc::qlfc_decode_block(in, out, kind);
}

// Free the calling thread's cached QLFC scratch (buffer + model snapshots):
// a release hook for long-lived thread pools (see native/qlfc.cc Scratch).
void tbsc_qlfc_release_scratch() { tbsc::qlfc_release_scratch(); }

int tbsc_coder_compress(const uint8_t* in, uint8_t* out, int n, int kind, int num_threads) {
  return tbsc::coder_compress(in, out, n, kind, num_threads);
}

int tbsc_coder_decompress(const uint8_t* in, uint8_t* out, int kind, int num_threads) {
  return tbsc::coder_decompress(in, out, kind, num_threads);
}

int tbsc_lzp_compress(const uint8_t* in, uint8_t* out, int n, int hash_size, int min_len,
                      int num_threads) {
  return tbsc::lzp_compress(in, out, n, hash_size, min_len, num_threads);
}

int tbsc_lzp_decompress(const uint8_t* in, uint8_t* out, int n, int hash_size, int min_len,
                        int num_threads) {
  return tbsc::lzp_decompress(in, out, n, hash_size, min_len, num_threads);
}

int tbsc_bwt_encode(uint8_t* T, int n, uint8_t* num_indexes, int32_t* indexes, int num_threads) {
  int ni = 0;
  int r = tbsc::bwt_encode(T, n, (uint8_t*)&ni, indexes, num_threads);
  if (num_indexes) *num_indexes = (uint8_t)ni;
  return r;
}

int tbsc_bwt_decode(uint8_t* T, int n, int index, int num_indexes, const int32_t* indexes,
                    int num_threads) {
  return tbsc::bwt_decode(T, n, index, num_indexes, indexes, num_threads);
}

int tbsc_bwt_encode_rate(uint8_t* T, int n, int r, int32_t* indexes) {
  return tbsc::bwt_encode_rate(T, n, r, indexes);
}

int tbsc_bwt_decode_rate(uint8_t* T, int n, int index, int r,
                         int num_indexes, const int32_t* indexes) {
  return tbsc::bwt_decode_rate(T, n, index, r, num_indexes, indexes);
}

int tbsc_st_encode(uint8_t* T, int n, int k, int num_threads) {
  return tbsc::st_encode(T, n, k, num_threads);
}

int tbsc_wide_set_priors(const int16_t* p) {
  return tbsc::wide_set_priors(p);
}

int tbsc_wide_encode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t out_cap, int n_lanes, const int32_t* sizes,
                     int rans) {
  return tbsc::wide_encode(in, n, out, out_cap, n_lanes, sizes, rans);
}

int tbsc_wide_balanced_sizes(const uint8_t* in, int64_t n, int n_lanes,
                             int32_t* sizes) {
  return tbsc::wide_balanced_sizes(in, n, n_lanes, sizes);
}

int tbsc_wide_decode(const uint8_t* in, int64_t n, uint8_t* out,
                     int64_t out_cap) {
  return tbsc::wide_decode(in, n, out, out_cap);
}

int tbsc_wide_ranks(const uint8_t* in, int64_t n, int n_lanes, int cap,
                    int32_t* ranks, int32_t* lens, int32_t* nruns) {
  return tbsc::wide_ranks(in, n, n_lanes, cap, ranks, lens, nruns);
}

int tbsc_wide_schedule(const uint8_t* in, int64_t n, int n_lanes, int cap,
                       uint8_t* ctx, uint8_t* bit, const int32_t* sizes) {
  return tbsc::wide_schedule(in, n, n_lanes, cap, ctx, bit, sizes);
}

int tbsc_wide_schedule_packed(const uint8_t* in, int64_t n, int n_lanes,
                              int cap4, uint8_t* packed,
                              const int32_t* sizes) {
  return tbsc::wide_schedule_packed(in, n, n_lanes, cap4, packed, sizes);
}

uint32_t tbsc_adler32(const uint8_t* p, int64_t n, uint32_t adler) {
  return tbsc::adler32(p, n, adler);
}

int tbsc_st_decode_batch(uint8_t** Ts, const int32_t* ns, int k,
                         const int32_t* indexes, int nblocks) {
  return tbsc::st_decode_batch(Ts, ns, k, indexes, nblocks);
}

int tbsc_st_decode(uint8_t* T, int n, int k, int index, int num_threads) {
  return tbsc::st_decode(T, n, k, index, num_threads);
}

}  // extern "C"
