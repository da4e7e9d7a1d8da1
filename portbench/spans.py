"""The program's own spans (``libbsc_tpu_torch.utils.trace.spans()``),
read after the traced window, for the per-layer metrics of the CLI, the
host stages and the device stage.

Each span carries its name, thread, start and end (``time.time_ns()``,
the profiler's clock), parent, the CLI call it belongs to (``call``, the
file call span's id), the block's offset and its bytes in and out.  A
program that keeps no record (no ``spans`` in its tracer, or none in the
window) gives None, and so does every metric read from it.
"""

from __future__ import annotations

import statistics

FILE_CALL = {"encode": "cli.compress_file", "decode": "cli.decompress_file"}
API = {"encode": "api.compress", "decode": "api.decompress"}
DEVICE_STAGE = {"encode": "compress_block_device",
                "decode": "decompress_block_device"}
TRACE_PREFIX = "tbsc::"


def record():
    """The program's ended spans of the window, or None."""
    try:
        from libbsc_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = getattr(trace, "spans", None)
    if spans is None:
        return None
    return [s for s in spans() if s.end is not None] or None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def covered_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) inside the union of ``intervals``."""
    total, end = 0, lo
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, hi)
        if t > s:
            total += t - s
            end = t
    return total


def cli_ms(phase: str):
    """Mean, over the phase's file calls, of each call's time during which
    no API span of that call is open on any thread, in ms."""
    spans = record()
    calls = named(spans, FILE_CALL[phase]) if spans else []
    if not calls:
        return None
    api: dict = {}
    for s in named(spans, API[phase]):
        api.setdefault(s.call, []).append((s.start, s.end))
    return statistics.fmean(
        (c.end - c.start) - covered_ns(api.get(c.id, []), c.start, c.end)
        for c in calls) / 1e6


def host_stage_ms(phase: str):
    """Mean over the phase's API spans (one a block) of the span's time
    less its device-stage child's, in ms."""
    spans = record()
    api = named(spans, API[phase]) if spans else []
    if not api:
        return None
    device: dict = {}
    for s in named(spans, DEVICE_STAGE[phase]):
        device[s.parent] = device.get(s.parent, 0) + s.end - s.start
    return statistics.fmean(a.end - a.start - device.get(a.id, 0)
                            for a in api) / 1e6


def device_stage_ms(phase: str):
    """Mean over the phase's API spans of their device-stage child's wall
    time (0 where the block took another route), in ms."""
    spans = record()
    api = named(spans, API[phase]) if spans else []
    if not api:
        return None
    ids = {a.id for a in api}
    return sum(s.end - s.start for s in named(spans, DEVICE_STAGE[phase])
               if s.parent in ids) / len(api) / 1e6


def lzp_wasted_ms():
    """Time of the LZP attempts whose output was thrown away (``out`` 0),
    over the encode phase's blocks, in ms a block."""
    spans = record()
    api = named(spans, API["encode"]) if spans else []
    if not api:
        return None
    return sum(s.end - s.start for s in named(spans, "lzp_compress")
               if s.out == 0) / len(api) / 1e6


def trace_offset_us(spans, trace):
    """Microseconds to add to a span's stamp (ns / 1000) to place it on
    ``trace``'s time axis: the median, over the file calls, of the
    difference between each call's event in the trace (the profiled
    thread's ``tbsc::`` range) and its span, paired in order; None where
    the two do not pair."""
    diffs = []
    for name in FILE_CALL.values():
        events = sorted(h[0] for h in trace.host
                        if h[2] == TRACE_PREFIX + name)
        calls = sorted(s.start for s in named(spans, name))
        if len(events) != len(calls):
            return None
        diffs += [e - c / 1e3 for e, c in zip(events, calls)]
    return statistics.median(diffs) if diffs else None


def device_stage_idle_pct(phase: str, trace):
    """Share of the device-stage spans' time during which no kernel, copy
    or set ran on the card, in %."""
    spans = record()
    stage = named(spans, DEVICE_STAGE[phase]) if spans and trace else []
    if not stage:
        return None
    off = trace_offset_us(spans, trace)
    if off is None:
        return None
    busy = sum(trace.busy(s.start / 1e3 + off, s.end / 1e3 + off)
               for s in stage)
    wall = sum(s.end - s.start for s in stage) / 1e3
    return 100.0 * (1.0 - busy / wall)
