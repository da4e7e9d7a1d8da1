"""Per-thread reusable scratch buffers for the block pipeline.

A fresh multi-MB mapping takes page faults on every call and is never
promoted to huge pages; the reference amortizes these buffers through
glibc's malloc chunk cache inside bsc_compress, and the native runtime
through its huge-page arena (halloc.h).  The Python pipeline gets the
same treatment here: one grow-only buffer per (thread, slot), 2 MiB-aligned
and madvised MADV_HUGEPAGE, so every compress/decompress call after the
first works in warm huge pages.

``pinned=True`` is the form for a buffer that feeds a host<->device copy
on CUDA: its storage is page-locked (``torch.empty(..., pin_memory=True)``,
cudaHostAlloc through torch's host allocator), so the copy runs at the
link's rate and can be asynchronous, as the reference stages its copies
through one pinned buffer (libcubwt).  A page-locked buffer is resident
and cannot be migrated, so it is neither realigned nor madvised.  A slot
asked for once pinned and once not is two buffers.  Where pinning fails
(no CUDA), :func:`get` raises: there is no pageable stand-in.

A slot's buffer is valid until the same thread asks for the same slot
again: callers keep at most one live view per slot (the pipeline uses
distinct slot names per overlapping lifetime), and nothing a caller of
the API keeps may be a view of one.  A thread's slots are freed when the
thread ends (a page-locked one goes back to torch's host allocator).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_MADV_HUGEPAGE = 14
_HUGE = 2 << 20

_tls = threading.local()

try:
    _libc = ctypes.CDLL(None, use_errno=True)
except OSError:  # pragma: no cover - non-POSIX
    _libc = None


def _alloc(cap: int):
    raw = np.empty(cap + _HUGE, dtype=np.uint8)
    addr = raw.ctypes.data
    off = (-addr) % _HUGE
    view = raw[off:off + cap]
    if _libc is not None:
        try:
            _libc.madvise(ctypes.c_void_p(addr + off),
                          ctypes.c_size_t(cap), _MADV_HUGEPAGE)
        except AttributeError:  # no madvise: the buffer works as it is
            pass
    return raw, view


def _alloc_pinned(cap: int):
    import torch

    owner = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
    return owner, owner.numpy()


def slots() -> dict:
    """This thread's buffers: (slot, pinned) -> the whole uint8 buffer."""
    return {k: v[1] for k, v in getattr(_tls, "slots", {}).items()}


def get(slot: str, nbytes: int, pinned: bool = False) -> np.ndarray:
    """uint8[nbytes] scratch for `slot`, reused across calls on this thread.

    Grow-only with 1.25x headroom so a stream of similar block sizes maps
    to one stable allocation.  ``pinned``: page-locked storage (CUDA)."""
    d = getattr(_tls, "slots", None)
    if d is None:
        d = _tls.slots = {}
    key = (slot, pinned)
    ent = d.get(key)
    if ent is None or ent[1].shape[0] < nbytes:
        cap = max(1 << 20, nbytes + (nbytes >> 2))
        ent = d[key] = (_alloc_pinned if pinned else _alloc)(cap)
    return ent[1][:nbytes]
