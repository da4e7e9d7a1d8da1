// Binary range coder with 16-bit carry-counting renormalization.
//
// Stream format (must match reference coder/common/rangecoder.h:38-271):
//  - encoder state: 32-bit low + carry, 32-bit range, 16-bit output units
//  - a pending-0xffff counter resolves carries lazily
//  - probabilities are P-bit (default 12); split = (range >> P) * p
//  - decoder warms up by reading three 16-bit units (the first is the
//    encoder's initial zero cache and carries no information)
//
// This is an independent implementation of the classic Subbotin-style carry
// counting range coder; only the stream format is shared with the reference.
#pragma once

#include <cstdint>
#include <cstring>

namespace tbsc {

class RcEncoder {
 public:
  void init(uint8_t* out, int out_size) {
    out_ = start_ = reinterpret_cast<uint16_t*>(out);
    eob_ = reinterpret_cast<uint16_t*>(out + out_size - 16);
    low_ = 0;
    range_ = 0xffffffffu;
    cache_ = 0;
    pending_ = 0;
  }

  bool overflow() const { return out_ >= eob_; }

  template <int P = 12>
  inline void encode0(int p) {
    if (range_ < 0x10000u) shift();
    range_ = (range_ >> P) * (uint32_t)p;
  }

  template <int P = 12>
  inline void encode1(int p) {
    if (range_ < 0x10000u) shift();
    uint32_t r = (range_ >> P) * (uint32_t)p;
    low_ += r;
    range_ -= r;
  }

  // Branchless: the mantissa bits this is called with are near-random
  // (that is the point of entropy coding), so a branch on `bit` would
  // mispredict ~50% of the time.  XOR-select between the two interval
  // updates instead.
  template <int P = 12>
  inline void encode(uint32_t bit, int p) {
    if (range_ < 0x10000u) shift();
    uint32_t r0 = (range_ >> P) * (uint32_t)p;
    uint32_t m = (uint32_t)0 - (bit != 0);
    low_ += (uint64_t)(r0 & m);
    range_ = r0 ^ ((r0 ^ (range_ - r0)) & m);
  }

  inline void encode_direct(uint32_t bit) { encode<12>(bit, 2048); }

  inline void encode_word(uint32_t w) {
    for (int b = 31; b >= 0; --b) encode_direct((w >> b) & 1);
  }

  int finish() {
    if (range_ < 0x10000u) shift();
    shift(); shift(); shift();
    return (int)((out_ - start_) * sizeof(uint16_t));
  }

 private:
  // Out-of-line: runs once per 16 output bits; keeping its body (carry
  // resolution + pending-unit flush) out of the per-bit loop saves uop
  // cache and lets the encode fast path stay branch-light.
  __attribute__((noinline)) void shift() {
    uint32_t lo32 = (uint32_t)low_;
    uint32_t carry = (uint32_t)(low_ >> 32);
    if (lo32 < 0xffff0000u || carry) {
      put((uint16_t)(cache_ + carry));
      while (pending_) { put((uint16_t)(carry - 1)); --pending_; }
      cache_ = lo32 >> 16;
    } else {
      ++pending_;
    }
    low_ = (uint64_t)(uint32_t)(lo32 << 16);
    range_ <<= 16;
  }

  inline void put(uint16_t v) { std::memcpy(out_++, &v, sizeof v); }

  uint64_t low_;
  uint32_t range_, cache_, pending_;
  uint16_t *out_, *start_, *eob_;
};

class RcDecoder {
 public:
  void init(const uint8_t* in) {
    in_ = reinterpret_cast<const uint16_t*>(in);
    range_ = 0xffffffffu;
    code_ = 0;
    code_ = (code_ << 16) | get();
    code_ = (code_ << 16) | get();
    code_ = (code_ << 16) | get();
  }

  template <int P = 12>
  inline int decode(int p) {
    if (range_ < 0x10000u) { range_ <<= 16; code_ = (code_ << 16) | get(); }
    uint32_t r = (range_ >> P) * (uint32_t)p;
    int bit = code_ >= r;
    range_ = bit ? range_ - r : r;
    code_ = bit ? code_ - r : code_;
    return bit;
  }

  inline uint32_t decode_direct() { return (uint32_t)decode<12>(2048); }

  inline uint32_t decode_word() {
    uint32_t w = 0;
    for (int b = 31; b >= 0; --b) w += w + decode_direct();
    return w;
  }

 private:
  inline uint16_t get() {
    uint16_t v;
    std::memcpy(&v, in_++, sizeof v);
    return v;
  }

  const uint16_t* in_;
  uint32_t code_, range_;
};

}  // namespace tbsc
