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
Each allocation is a ``bufpool.alloc`` span (``utils/trace``) of the
buffer's bytes, tagged ``pinned`` or ``pageable``.

A :class:`Ring` is the form for buffers that pass between threads: a
fixed number of grow-only buffers that one thread takes, fills and hands
on, and another gives back when done with it (the CLI reads its blocks
into one).  :func:`lent` tells the API whether an array lies in a
page-locked buffer that a ring has lent out, which the API may upload
from as it is but must not write into.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np

from .trace import span

_MADV_HUGEPAGE = 14
_HUGE = 2 << 20

_tls = threading.local()
_rings: "weakref.WeakSet[Ring]" = weakref.WeakSet()

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


def _capacity(nbytes: int) -> int:
    """A new buffer's bytes for ``nbytes``: 1.25x headroom, 1 MiB at
    least, so that a stream of similar sizes maps to one allocation."""
    return max(1 << 20, nbytes + (nbytes >> 2))


def _alloc_traced(cap: int, pinned: bool):
    with span("bufpool.alloc", cap, tag="pinned" if pinned else "pageable"):
        return (_alloc_pinned if pinned else _alloc)(cap)


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
        ent = d[key] = _alloc_traced(_capacity(nbytes), pinned)
    return ent[1][:nbytes]


class Ring:
    """``count`` buffers shared by the threads of a process, page-locked
    with ``pinned``.  :meth:`take` lends one out, waiting while all
    ``count`` are; :meth:`give` takes it back, from any thread.  A buffer
    is made at the first take that finds none free and grows, as a slot
    does, when a take asks for more than it holds; the ring keeps its
    buffers for as long as it lives."""

    def __init__(self, count: int, pinned: bool):
        self.count, self.pinned = count, pinned
        self._cond = threading.Condition()
        self._free: list = []  # (owner, whole buffer), not lent out
        self._out: dict = {}  # a lent buffer's address -> (owner, whole)
        _rings.add(self)

    def take(self, nbytes: int) -> np.ndarray:
        """uint8[nbytes] of a buffer no one else holds until it is given
        back."""
        with self._cond:
            while not self._free and len(self._out) >= self.count:
                self._cond.wait()
            ent = self._free.pop() if self._free else None
            if ent is None or ent[1].shape[0] < nbytes:
                ent = _alloc_traced(_capacity(nbytes), self.pinned)
            self._out[ent[1].ctypes.data] = ent
            return ent[1][:nbytes]

    def give(self, arr: np.ndarray) -> None:
        """Take back the buffer that ``arr`` (a view of what :meth:`take`
        returned) lies in."""
        with self._cond:
            self._free.append(self._out.pop(self._holder(arr)))
            self._cond.notify()

    def lends(self, arr: np.ndarray) -> bool:
        """True when ``arr`` lies in a buffer lent out."""
        with self._cond:
            return self._holder(arr) is not None

    def _holder(self, arr: np.ndarray):
        lo = arr.ctypes.data
        for addr, (_, whole) in self._out.items():
            if addr <= lo and lo + arr.nbytes <= addr + whole.nbytes:
                return addr
        return None


def lent(arr: np.ndarray) -> bool:
    """True when ``arr`` lies in a page-locked buffer that a :class:`Ring`
    has lent out: its holder's, to be read and never written."""
    return any(r.pinned and r.lends(arr) for r in list(_rings))
