"""Spans of the port: one in-memory record, per-stage lines and the
operator's Chrome trace.

A span (:func:`span`, :func:`stage`) is one :class:`Span` record: its
name, the thread it ran on, its start and end from ``time.time_ns()``
(the profiler's clock: an exported event's ``ts`` is Unix microseconds
less the trace's ``baseTimeNanoseconds``), its parent, the CLI call it
belongs to (the id of the root of its chain), the block's offset, and
its bytes in and, where a stage can reject its output, out.  Counts are
fields of the spans: an ``lzp_compress`` span with ``out`` 0 is an
attempt whose output was thrown away; a ``bufpool.alloc`` span is one
pool allocation of ``nbytes``, ``tag`` ``pinned`` or ``pageable``.

Spans are collected only while a torch profiler is active in the
process (``torch.autograd.profiler._is_profiler_enabled``, a module
global that every thread reads), from any thread.  The record holds the
spans of the current profiling session and keeps them after the
profiler stops, until the next session starts (this module chains onto
torch's ``_run_on_profiler_start`` hook to see it start): :func:`spans`
returns them.  Under a profiler each span also opens
``record_function("tbsc::<name>")``, so that on a profiled thread it
appears in the exported trace beside the kernels.  With no profiler a
span costs one check of a module global and an empty context manager.

A span's parent is the innermost span open on its thread, or the span
passed as ``parent`` where work moves to another thread (the CLI's farm
and decode pool hand :func:`current` of the file call to their workers).

Set ``TBSC_TRACE=1`` to print one stderr line per pipeline stage, in the
JAX package's format (``[tbsc] name: NB Xs Y MB/s``), under its stage
names.  A traced stage on a CUDA device synchronises the device before
it reads the clock at its start and at its end, so its line counts the
device work the stage queued; untraced calls do not synchronise.  Other
spans print nothing.

Set ``TBSC_PROFILE=<dir>`` to run ``torch.profiler`` (CPU and, where
present, CUDA activities, every thread where the torch records them):
the CLI starts it and writes its Chrome trace into the directory at
exit; an API caller's first stage starts it and :func:`stop_profiler`
writes the trace and returns its path.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE = os.environ.get("TBSC_TRACE", "") not in ("", "0")
_PROFILE_DIR = os.environ.get("TBSC_PROFILE", "")
_profiler = None

_ids = itertools.count(1)
_record: list = []
_stale = True  # a profiler started: the next span starts a record
_lock = threading.Lock()
_tls = threading.local()


def _profiler_started(_chained=_autograd_profiler._run_on_profiler_start):
    global _stale
    _chained()
    _stale = True


_autograd_profiler._run_on_profiler_start = _profiler_started


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class Span:
    """One span: the record's fields, and the context manager that
    stamps them.  ``start`` and ``end`` are ``time.time_ns()``;
    ``parent`` and ``call`` are span ids (``call`` the root's, the
    root's own id on a root); ``out`` is None unless the stage sets
    it."""

    __slots__ = ("id", "name", "thread", "start", "end", "parent", "call",
                 "offset", "nbytes", "out", "tag", "_up", "_keep",
                 "_device", "_echo", "_range")

    def __init__(self, name: str, nbytes: int = 0, offset=None,
                 tag: str = "", parent=None, keep: bool = True,
                 device=None, echo: bool = False):
        self.name = name
        self.nbytes = nbytes
        self.offset = offset
        self.tag = tag
        self.out = None
        self.end = None
        self._up = parent
        self._keep = keep
        self._device = device
        self._echo = echo
        self._range = None

    def __enter__(self) -> "Span":
        global _record, _stale
        _sync(self._device)
        if self._keep:
            if _stale:
                with _lock:
                    if _stale:
                        _record, _stale = [], False
            stack = _stack()
            up = self._up if self._up is not None else (
                stack[-1] if stack else None)
            self.id = next(_ids)
            self.thread = threading.get_native_id()
            if up is None:
                self.parent, self.call = None, self.id
            else:
                self.parent, self.call = up.id, up.call
                if self.offset is None:
                    self.offset = up.offset
            stack.append(self)
            self._range = _autograd_profiler.record_function(
                "tbsc::" + self.name)
            self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        _sync(self._device)
        self.end = time.time_ns()
        if self._keep:
            self._range.__exit__(*exc)
            self._range = None
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            _record.append(self)
        if self._echo:
            dt = (self.end - self.start) / 1e9
            n = self.nbytes
            rate = f" {n / 1e6 / dt:.1f} MB/s" if n and dt > 0 else ""
            print(f"[tbsc] {self.name}: {n}B {dt:.4f}s{rate}",
                  file=sys.stderr)
        return False


class _Off:
    """The span of an untraced call: enters, exits and takes any field
    without recording it."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setattr__(self, name, value) -> None:
        pass


_OFF = _Off()


def span(name: str, nbytes: int = 0, offset=None, tag: str = "",
         parent=None):
    """A span ``name`` of ``nbytes`` in (block ``offset``, a ``tag``
    naming its route), under ``parent`` (a :class:`Span` of another
    thread) or else the innermost span open on this thread; recorded
    only while a torch profiler is active."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, nbytes, offset, tag, parent)


def stage(name: str, nbytes: int = 0, device=None):
    """A pipeline stage: a span that also prints its line under
    TBSC_TRACE.  ``device`` is the API's device (synchronised at the
    stage's ends under TBSC_TRACE when it is CUDA).  Under TBSC_PROFILE
    the first stage starts the profiler when none runs."""
    if _PROFILE_DIR and _profiler is None:
        start_profiler()
    on = _autograd_profiler._is_profiler_enabled
    if not on and not TRACE:
        return _OFF
    return Span(name, nbytes, keep=on, device=device if TRACE else None,
                echo=TRACE)


def current():
    """The innermost span open on this thread, or None (always None
    with no profiler)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def spans() -> list:
    """The ended spans of the current profiling session, or of the last
    one after it stopped, in the order they ended."""
    return list(_record)


def start_profiler() -> bool:
    """Start the TBSC_PROFILE profiler, recording every thread where the
    torch can; True when one runs."""
    global _profiler
    if not _PROFILE_DIR:
        return False
    if _profiler is not None:
        return True
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):  # an older torch: this thread only
        config = None
    _profiler = torch.profiler.profile(activities=activities,
                                       experimental_config=config)
    _profiler.start()
    return True


def stop_profiler():
    """Stop the profiler started by TBSC_PROFILE and write its Chrome
    trace into the directory.  Returns the trace's path, or None when no
    profiler ran."""
    global _profiler
    if _profiler is None:
        return None
    prof, _profiler = _profiler, None
    prof.stop()
    os.makedirs(_PROFILE_DIR, exist_ok=True)
    path = os.path.join(_PROFILE_DIR, f"tbsc.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    return path
