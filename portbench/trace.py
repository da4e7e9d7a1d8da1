"""Reading a torch.profiler Chrome trace: device intervals, the
benchmark's own spans, kernels by name, idle gaps."""

from __future__ import annotations

import bisect
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench::"


class Trace:
    """The complete ("X") events of one trace, times in microseconds."""

    def __init__(self, events: list):
        ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"], e["cat"]) for e in ev
                     if e.get("cat") in DEVICE_CATS)
        self.device = [(s, t, n) for s, t, n, _ in dev]
        self.kernels = [(s, t, n) for s, t, n, c in dev if c == "kernel"]
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in ev if e.get("cat") in ("cpu_op", "user_annotation",
                                            "cuda_runtime"))
        self.spans = [h for h in self.host if h[2].startswith(SPAN_PREFIX)]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def span(self, name: str):
        """(start, end) of the benchmark's span ``portbench::<name>``, or
        None."""
        for s, t, n in self.spans:
            if n == SPAN_PREFIX + name:
                return s, t
        return None

    def busy(self, lo: float, hi: float) -> float:
        """Microseconds in [lo, hi) in which some device operation ran."""
        busy, end = 0.0, lo
        for s, t, _ in self.device:
            if t <= end or s >= hi:
                if s >= hi:
                    break
                continue
            busy += min(t, hi) - max(s, end)
            end = min(t, hi)
        return busy

    def gaps(self, lo: float, hi: float):
        """(start, end) of each stretch of [lo, hi) with no device
        operation running."""
        out, end = [], lo
        for s, t, _ in self.device:
            if s >= hi:
                break
            if s > end:
                out.append((end, s))
            end = max(end, t)
        if end < hi:
            out.append((end, hi))
        return out

    def kernel_us(self, lo: float, hi: float, pattern: str):
        """(summed microseconds, launches) of the kernels whose name
        matches ``pattern`` (a regular expression) and that start in
        [lo, hi)."""
        rx = re.compile(pattern)
        total, count = 0.0, 0
        for s, t, n in self.kernels:
            if lo <= s < hi and rx.search(n):
                total += t - s
                count += 1
        return total, count

    def host_at(self, when: float) -> str:
        """The innermost host operation running at ``when`` (the latest
        started: a torch op, a runtime call, or else the benchmark's own
        span), or ""."""
        i = bisect.bisect_right(self.host, (when, float("inf"), ""))
        best, best_start = "", float("-inf")
        for s, t, n in self.host[max(0, i - 4096):i]:
            if s <= when < t and s >= best_start:
                best, best_start = n, s
        return best

    def top_kernels(self, lo: float, hi: float, k: int = 10):
        """The ``k`` device operations that took most time in [lo, hi),
        summed by name: [[name, seconds]]."""
        tot: dict = {}
        for s, t, n in self.device:
            if lo <= s < hi:
                tot[n] = tot.get(n, 0.0) + (t - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us / 1e6] for n, us in top]
