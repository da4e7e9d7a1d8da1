#!/usr/bin/env python3
"""Where a traced benchmark run's time goes, by the program's spans.

    python3 tools/span_split.py --workload m9e4.text.1blk --seed <n> \\
        [--seconds 40] [--out chiprun_out/span_split.json] \\
        [--root DIR --device cpu]

Runs the cell through ``portbench/run.py``'s own entry (``harness.main``
with ``--trace 1``, CUDA), which prints the result line, then reads the
program's spans (``libbsc_tpu_torch.utils.trace.spans()``) beside the
run's device trace:

- ``clock``: for each file call, the span's start and end against its
  ``tbsc::`` event on the profiled thread (``ts`` plus the trace's
  ``baseTimeNanoseconds`` / 1000), microseconds: the record's clock is
  the profiler's;
- ``coverage``: for each phase, the card's idle time in the phase's span,
  and the share of it during which no span below the file call is open
  on any thread (``any``), and none but the waits (``farm.wait``,
  ``cli.farm_join``, ``cli.pool_join``) either (``work``);
- ``split``: for each phase, ms a call: the mean call (the harness's
  clock), the file call's span, the CLI (``cli_ms``), the host stages
  (``host_stage_ms``), the device stage's wall and the kernels, copies
  and sets that ran inside it (busy), and each span name's total over
  the phase's calls, a call, and the card's busy time inside the
  spans of ``BUSY_IN`` (the default and ST formats' stages and the
  screen);
- ``workers``: the blocks each farm route (``farm.block`` tag) took.

The JSON goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WAITS = {"farm.wait", "cli.farm_join", "cli.pool_join"}
# stages whose device busy time the split reports (the card's kernels,
# copies and sets inside their spans)
BUSY_IN = {"lzp_screen", "bwt_encode", "bwt.upload", "bwt.download",
           "coder_compress", "coder_decompress", "bwt_decode",
           "st.upload", "st.download",
           *(f"st{k}_{d}" for k in range(3, 9) for d in ("encode", "decode"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="m9e4.text.1blk")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default="chiprun_out/span_split.json")
    ap.add_argument("--root", default=str(ROOT),
                    help="with --device: a folder with BENCHMARK.json and "
                    "portbench/")
    ap.add_argument("--device", default=None,
                    help='"cpu": run_cell on the plain versions (a '
                    'rehearsal)')
    args = ap.parse_args(argv)

    from portbench import harness
    from portbench import spans as sp

    seen: dict = {}

    def load(cls, path):
        with open(path) as f:
            raw = json.load(f)
        seen["base_us"] = raw.get("baseTimeNanoseconds", 0) / 1e3
        seen["trace"] = cls(raw["traceEvents"])
        return seen["trace"]

    def judge(run, expected):
        seen["run"] = run
        return judge_of(run, expected)

    judge_of = harness.judge
    harness.Trace.load = classmethod(load)
    harness.judge = judge
    if args.device is None:
        rc = harness.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"])
        if rc:
            return rc
    else:
        print(json.dumps(harness.run_cell(
            Path(args.root), args.workload, args.seed, args.seconds, True,
            device=args.device)))
    sys.stdout.flush()
    trace, run, rec = seen["trace"], seen["run"], sp.record()
    off = sp.trace_offset_us(rec, trace)
    out = {"seed": args.seed, "offset_us": off,
           "clock": clock(rec, trace, seen["base_us"]),
           "coverage": {}, "split": {}, "workers": {}}
    for phase, ph in (("encode", run.encode), ("decode", run.decode)):
        out["coverage"][phase] = coverage(rec, trace, off, phase)
        out["split"][phase] = split(rec, trace, off, phase, ph)
    for s in sp.named(rec, "farm.block"):
        out["workers"][s.tag] = out["workers"].get(s.tag, 0) + 1
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print("span split: " + json.dumps(
        {k: out[k] for k in ("offset_us", "clock", "coverage", "workers")}))
    for phase in ("encode", "decode"):
        print(f"span split {phase}: " + json.dumps(out["split"][phase]))
    return 0


def clock(rec, trace, base_us: float) -> dict:
    """Median and largest |record - trace| of the file calls' starts and
    ends, us."""
    from portbench import spans as sp

    diffs: dict = {"start": [], "end": []}
    for name in sp.FILE_CALL.values():
        events = sorted((h[0], h[1]) for h in trace.host
                        if h[2] == sp.TRACE_PREFIX + name)
        calls = sorted((s.start, s.end) for s in sp.named(rec, name))
        for (ts, te), (s, e) in zip(events, calls):
            diffs["start"].append(abs(ts + base_us - s / 1e3))
            diffs["end"].append(abs(te + base_us - e / 1e3))
    out = {"pairs": len(diffs["start"])}
    for k, v in diffs.items():
        out[f"{k}_median"] = statistics.median(v) if v else None
        out[f"{k}_max"] = max(v, default=None)
    return out


def coverage(rec, trace, off: float, phase: str) -> dict:
    """The card's idle time in the phase's span, and its share outside
    every span below the file call (``any``), or every such span but the
    waits (``work``), on any thread."""
    from portbench import spans as sp

    lo, hi = trace.span(phase)
    gaps = trace.gaps(lo, hi)
    idle = sum(t - s for s, t in gaps)
    roots = {s.id for s in sp.named(rec, sp.FILE_CALL[phase])}
    below = [s for s in rec if s.call in roots and s.id not in roots]
    out = {"idle_ms": idle / 1e3}
    for kind, keep in (("any", lambda s: True),
                       ("work", lambda s: s.name not in WAITS)):
        iv = sorted((s.start / 1e3 + off, s.end / 1e3 + off)
                    for s in below if keep(s))
        inside = sum(sp.covered_ns(iv, s, t) for s, t in gaps)
        out[f"outside_{kind}_pct"] = 100.0 * (1 - inside / idle) if idle \
            else 0.0
    return out


def split(rec, trace, off: float, phase: str, ph) -> dict:
    """ms a call of the phase: its parts, and every span name's total."""
    from portbench import spans as sp

    roots = sp.named(rec, sp.FILE_CALL[phase])
    ids = {s.id for s in roots}
    n = len(roots)
    stage = sp.named(rec, sp.DEVICE_STAGE[phase])
    busy = sum(trace.busy(s.start / 1e3 + off, s.end / 1e3 + off)
               for s in stage) / 1e3
    names: dict = {}
    busy_in: dict = {}
    for s in rec:
        if s.call in ids and s.id not in ids:
            names[s.name] = names.get(s.name, 0) + (s.end - s.start) / 1e6
            if s.name in BUSY_IN:
                busy_in[s.name] = busy_in.get(s.name, 0) + trace.busy(
                    s.start / 1e3 + off, s.end / 1e3 + off) / 1e3
    return {
        "calls": n,
        "mean_call_ms": 1e3 * statistics.fmean(c.seconds for c in ph.calls),
        "file_call_ms": statistics.fmean((s.end - s.start) / 1e6
                                         for s in roots),
        "cli_ms": sp.cli_ms(phase),
        "host_stage_ms": sp.host_stage_ms(phase),
        "device_stage_ms": sp.device_stage_ms(phase),
        "device_stage_busy_ms": busy / max(n, 1),
        "lzp_wasted_ms": sp.lzp_wasted_ms() if phase == "encode" else None,
        "by_name_ms": {k: v / n for k, v in sorted(names.items())},
        "busy_by_name_ms": {k: v / n for k, v in sorted(busy_in.items())},
    }


if __name__ == "__main__":
    sys.exit(main())
