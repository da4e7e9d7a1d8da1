// 2 MB-aligned allocation with transparent-huge-page advice.
//
// The pointer-chasing stages (inverse ST walk, SA-IS induce) make random
// accesses over arrays of 4n bytes; with 4 KiB pages every access is also
// a TLB miss.  THP on this machine is madvise-only, so the big arrays opt
// in explicitly.  hfree() pairs with halloc().  The inverse BWT's and the
// inverse ST's tables take hfresh() instead (below).

#pragma once

#include <cstdlib>
#include <cstring>
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

// A fresh allocation with every page faulted in before it returns, for a
// table that a pointer chase walks once per call.  How fast such a chase
// runs depends on the physical backing of its pages, and the backing is
// drawn at fault time: on the H100 host a 104 MB table chased by 13
// interleaved chains ran 115-135 ms or 215-235 ms, and kept its speed for
// the life of the process.  A table cached across calls (halloc's slot)
// fixes one draw for the whole process; a fresh table makes each call its
// own draw, so a process's mean stays put.  Faulting it in at once, not
// page by page in the order of the scatter that fills it, keeps the draw
// cheap.  The inverse ST's 4n-byte table showed the same on that host:
// with halloc's table one process's calls on a 25 MiB block ran 2.7 s or
// 4.1-4.5 s, with a fresh one 2.35-3.18 s over 24 calls in four
// processes.
// hfresh_free() pairs with hfresh().
inline void* hfresh(size_t bytes) {
#if defined(__linux__)
  void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
  return p == MAP_FAILED ? nullptr : p;
#else
  void* p = malloc(bytes);
  if (p) memset(p, 0, bytes);
  return p;
#endif
}

inline void hfresh_free(void* p, size_t bytes) {
  if (!p) return;
#if defined(__linux__)
  munmap(p, bytes);
#else
  (void)bytes;
  free(p);
#endif
}

}  // namespace tbsc
