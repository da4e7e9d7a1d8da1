// 2 MB-aligned allocation with transparent-huge-page advice.
//
// The pointer-chasing stages (inverse ST walk, inverse-BWT chains, SA-IS
// induce) make random accesses over arrays of 4n bytes; with 4 KiB pages
// every access is also a TLB miss.  THP on this machine is madvise-only,
// so the big arrays opt in explicitly.  hfree() pairs with halloc().

#pragma once

#include <cstdlib>
#include <mutex>
#include <unordered_map>

#if defined(__linux__)
#include <sys/mman.h>
#endif

namespace tbsc {
namespace halloc_detail {
inline std::mutex mu;
inline void* slot = nullptr;
inline size_t slot_sz = 0;
inline std::unordered_map<void*, size_t>& sizes() {
  static std::unordered_map<void*, size_t> m;
  return m;
}
}  // namespace halloc_detail

// Huge-page-advised allocation with a one-slot reuse cache.  Whether THP
// actually materializes depends on host fragmentation at fault time, which
// made fresh per-call allocations bimodally ~25% slower for the
// pointer-chase stages; caching the biggest freed arena keeps its page
// state (and page tables) stable across calls — the same storage-reuse
// pattern as the reference's cached CUDA arena (bwt.cpp:91-115).
inline void* halloc(size_t bytes) {
  using namespace halloc_detail;
  const size_t kHuge = (size_t)2 << 20;
  size_t aligned = (bytes + kHuge - 1) & ~(kHuge - 1);
  {
    std::lock_guard<std::mutex> g(mu);
    if (slot && slot_sz >= aligned && slot_sz <= 4 * aligned) {
      void* p = slot;
      slot = nullptr;
      sizes()[p] = slot_sz;
      return p;
    }
  }
  void* p = aligned_alloc(kHuge, aligned);
  if (!p) return malloc(bytes);  // plain pages as a fallback
#if defined(__linux__)
  // THP advice is opt-in: on hosts with heavy memory fragmentation the
  // fault-time compaction plus khugepaged background collapsing can stall
  // a single-core process for seconds (observed here), outweighing the
  // ~25% TLB win of 2 MB pages on the pointer-chase walks.
  if (getenv("TBSC_THP")) madvise(p, aligned, MADV_HUGEPAGE);
#endif
  {
    std::lock_guard<std::mutex> g(mu);
    sizes()[p] = aligned;
  }
  return p;
}

inline void hfree(void* p) {
  using namespace halloc_detail;
  if (!p) return;
  size_t sz = 0;
  {
    std::lock_guard<std::mutex> g(mu);
    auto it = sizes().find(p);
    if (it != sizes().end()) {
      sz = it->second;
      sizes().erase(it);
    }
    if (sz >= slot_sz && sz > 0) {
      void* old = slot;
      slot = p;
      size_t old_sz = slot_sz;
      slot_sz = sz;
      p = old;
      sz = old_sz;
    }
  }
  free(p);  // p may be null (we kept the new block) — free(nullptr) is ok
}

}  // namespace tbsc
