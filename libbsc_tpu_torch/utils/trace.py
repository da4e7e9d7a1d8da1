"""Per-stage tracing and profiling of the API.

Set ``TBSC_TRACE=1`` to print one stderr line per pipeline stage, in the
JAX package's format (``[tbsc] name: NB Xs Y MB/s``), under its stage
names.  A traced stage on a CUDA device synchronises the device before
it reads the clock at its start and at its end, so its line counts the
device work the stage queued; untraced calls do not synchronise.

Set ``TBSC_PROFILE=<dir>`` to start ``torch.profiler`` (CPU and, where
present, CUDA activities) at the first stage, each stage a
``tbsc::<name>`` range; :func:`stop_profiler` writes a Chrome trace into
the directory and returns its path.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

TRACE = os.environ.get("TBSC_TRACE", "") not in ("", "0")
_PROFILE_DIR = os.environ.get("TBSC_PROFILE", "")
_profiler = None


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _start_profiler() -> None:
    global _profiler
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(activities=activities)
    _profiler.start()


@contextlib.contextmanager
def stage(name: str, nbytes: int = 0, device=None):
    """Time one pipeline stage; prints to stderr when TBSC_TRACE is set.
    ``device`` is the API's device (synchronised when it is CUDA).  Under
    TBSC_PROFILE the stage is also a ``tbsc::<name>`` range of the
    trace."""
    if _PROFILE_DIR:
        if _profiler is None:
            _start_profiler()
        import torch

        with torch.profiler.record_function(f"tbsc::{name}"):
            with _timed(name, nbytes, device):
                yield
        return
    with _timed(name, nbytes, device):
        yield


@contextlib.contextmanager
def _timed(name: str, nbytes: int, device):
    if not TRACE:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        dt = time.perf_counter() - t0
        rate = f" {nbytes / 1e6 / dt:.1f} MB/s" if nbytes and dt > 0 else ""
        print(f"[tbsc] {name}: {nbytes}B {dt:.4f}s{rate}", file=sys.stderr)


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
