"""One run of one cell: set-up, the measured window, the judge, the
result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration (its file
holds the CLI switches) and a traffic mix (``traffic/<name>.json``: a
generator under ``gen/``, its parameters, the file size and the pool's
file count).  Every metric is a reader under ``metrics/<name>.py`` with
``read(run)``; the cell's end-to-end metrics are read in an untraced
run, its per-layer metrics in a traced one.  Nothing here is particular
to a cell: a new cell, mix or metric is new files and entries.

The window is a closed loop of one client through the port's CLI entry
(``libbsc_tpu_torch.cli.compress_file`` / ``decompress_file``): the
encode phase, the first half, cycles through the pool; the decode phase,
the second half, restores the encode phase's archives in turn.  Inputs,
archives and restored files are anonymous memory files.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench.judge import LIMITS, correct, judge
from portbench.memfile import MemFile
from portbench.trace import SPAN_PREFIX, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "libbsc_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``root/BENCHMARK.json`` with its configuration,
    traffic and metrics; data files under ``root/portbench``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload named {name!r}")
        self.name = name
        self.workload = found[0]
        entry = [c for c in bench["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.traffic = json.loads(
            (self.dir / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def metrics(self, traced: bool) -> list:
        return self.per_layer if traced else self.end_to_end

    def reader(self, name: str):
        return load_file(self.dir / "metrics" / f"{name}.py",
                         f"portbench_metric_{name.replace('.', '_')}")

    def generator(self):
        kind = self.traffic["generator"]
        return load_file(self.dir / "gen" / f"{kind}.py",
                         f"portbench_gen_{kind}")

    def reference(self):
        return importlib.import_module(
            f"portbench.ref.{self.config['reference']}")


@dataclass
class Call:
    start: float
    end: float
    index: int          # the pool file
    out: MemFile | None   # None: not kept for the judge
    error: str | None
    in_bytes: int
    origin: "Call | None" = None  # a decode's archive: its encode call
    out_bytes: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Phase:
    name: str
    start: float = 0.0
    end: float = 0.0
    calls: list = field(default_factory=list)
    blocks: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def ok(self) -> list:
        return [c for c in self.calls if not c.error]


@dataclass
class Run:
    """What the metric readers see."""
    cell: Cell
    pool: list            # each file's bytes, u8 ndarray
    block_size: int
    setup_s: float = 0.0
    encode: Phase = field(default_factory=lambda: Phase("encode"))
    decode: Phase = field(default_factory=lambda: Phase("decode"))
    trace: Trace | None = None


def _span(traced: bool, name: str):
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def _loop(phase: Phase, seconds: float, fn, sources, traced,
          keep=lambda i: True):
    """Calls ``fn(src path, out path)`` on ``sources`` in turn, the next
    after the last has returned, until ``seconds`` have passed; the
    phase ends with the last call.  Call i's output is kept for the
    judge when ``keep(i)``; the others share one scratch file."""
    phase.start = time.perf_counter()
    deadline = phase.start + seconds
    scratch = MemFile(f"{phase.name}_scratch")
    i = 0
    with _span(traced, phase.name):
        while True:
            index, src, size, origin = sources(i)
            out = MemFile(f"{phase.name}{i}") if keep(i) else scratch
            t0 = time.perf_counter()
            err = None
            try:
                with _span(traced, fn.__name__):
                    fn(src, out.path)
            except (Exception, SystemExit) as e:  # counted, run goes on
                err = f"{type(e).__name__}: {e}"
            t1 = time.perf_counter()
            call = Call(t0, t1, index, out if out is not scratch else None,
                        err, size, origin)
            call.out_bytes = 0 if err else out.size()
            phase.calls.append(call)
            i += 1
            if t1 >= deadline:
                break
    phase.end = phase.calls[-1].end
    scratch.close()


def host_counters() -> dict:
    """This process's context switches and CPU seconds, and the cgroup's
    CPU throttling, where the host exposes them."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("voluntary_ctxt", "nonvoluntary_ctxt")):
                k, v = line.split(":")
                out[k] = int(v)
    t = os.times()
    out["cpu_ms"] = int((t.user + t.system) * 1e3)
    try:
        with open("/sys/fs/cgroup/cpu.stat") as f:
            for line in f:
                k, v = line.split()
                if k in ("nr_throttled", "throttled_usec"):
                    out[k] = int(v)
    except OSError:
        pass
    return out


def machine_lines(device) -> list:
    """Where the run ran: the card, its power limit, the host's cores,
    the native runtime's OpenMP."""
    import torch

    quota = ""
    with contextlib.suppress(OSError):
        quota = Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    lines = [f"host cores {os.cpu_count()} (this process may use "
             f"{len(os.sched_getaffinity(0))}; cgroup cpu.max {quota or '-'}"
             f"), load {os.getloadavg()[0]:.2f}, torch {torch.__version__},"
             f" cuda {torch.version.cuda}"]
    if device is None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        lines.append(f"card {smi.stdout.strip() or smi.stderr.strip()}")
    with open("/proc/self/maps") as f:
        omp = "libgomp" in f.read()
    lines.append(f"native runtime with OpenMP: {omp}")
    return lines


def run_cell(root, name: str, seed: int, seconds: float, traced: bool,
             device=None, say=print, compress=None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``device`` None is CUDA (the benchmark); "cpu" runs the kernels'
    plain versions (tests only: such a run's numbers are not device
    numbers).  ``compress(src path, archive path)``, where given, writes
    the archives in the program's place (the control)."""
    cell = Cell(root, name)
    # the configuration is the CLI's switches alone: no knob of the
    # program's environment (TBSC_*) changes what it does
    for var in [v for v in os.environ if v.startswith("TBSC_")]:
        del os.environ[var]
    import torch

    from libbsc_tpu_torch import cli

    dev = torch.device("cuda" if device is None else device)
    tr = cell.traffic
    gen = cell.generator()
    pool, files = [], []
    for i in range(tr["pool_files"]):
        data = gen.make(tr["params"], seed, i, tr["file_bytes"], dev)
        pool.append(data.cpu().numpy())
        files.append(MemFile(f"in{i}", pool[-1]))
        del data
    sw = cell.config["switches"]
    enc = cli.parse_args(["bsc", "e", "in", "out", *sw])
    dec = cli.parse_args(["bsc", "d", "in", "out",
                          *cell.config["decode_switches"]])
    run = Run(cell, pool, enc.block_size)

    def compress_file(src, out):
        if compress is not None:
            return compress(src, out)
        cli.compress_file(src, out, enc, quiet=True, device=device)

    def decompress_file(src, out):
        cli.decompress_file(src, out, dec, quiet=True, device=device)

    # warm-up: one encode and one decode of the cell's file shape
    warm_a, warm_r = MemFile("warm_a"), MemFile("warm_r")
    warm_failed = 0
    for fn, src, out in ((compress_file, files[0], warm_a),
                         (decompress_file, warm_a, warm_r)):
        try:
            fn(src.path, out.path)
        except (Exception, SystemExit) as e:  # a failed call: not correct
            warm_failed += 1
            say(f"warm-up {fn.__name__}: {type(e).__name__}: {e}",
                file=sys.stderr)
    warm_a.close()
    warm_r.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for line in machine_lines(device):
        say(line, file=sys.stderr)

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    host_before = host_counters()
    run.setup_s = process_age_s()
    n_pool = len(pool)
    _loop(run.encode, seconds / 2, compress_file,
          lambda i: (i % n_pool, files[i % n_pool].path,
                     len(pool[i % n_pool]), None), traced)
    made = run.encode.ok() or run.encode.calls
    kept = np.random.default_rng([seed, 0x6B]).random(1 << 20) \
        < tr["restored_kept"]
    _loop(run.decode, seconds / 2, decompress_file,
          lambda i: (made[i % len(made)].index, made[i % len(made)].out.path,
                     made[i % len(made)].out.size(), made[i % len(made)]),
          traced, keep=lambda i: i == 0 or bool(kept[i % len(kept)]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if prof is not None:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    host_after = host_counters()
    say("host over the window: " + ", ".join(
        f"{k} {host_after[k] - host_before.get(k, 0)}"
        for k in sorted(host_after)), file=sys.stderr)
    for ph in (run.encode, run.decode):
        ph.blocks = sum(-(-len(pool[c.index]) // run.block_size)
                        for c in ph.calls)
        q = np.percentile([c.seconds * 1e3 for c in ph.calls],
                          [5, 25, 50, 75, 95])
        say(f"{ph.name}: {len(ph.calls)} calls, {ph.blocks} blocks, "
            f"{ph.seconds:.6f} s; call ms p5 p25 p50 p75 p95 "
            + " ".join(f"{x:.3f}" for x in q), file=sys.stderr)
    result_device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell.workload.get("chips", 1)),
        "memory_peak_bytes": int(peak)}
    breakdown = None
    if prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            run.trace = Trace.load(path)
        finally:
            os.unlink(path)
        lo = run.trace.span("encode")[0]
        hi = run.trace.span("decode")[1]
        result_device["busy_s"] = run.trace.busy(lo, hi) / 1e6
        result_device["window_s"] = (hi - lo) / 1e6
        breakdown = breakdown_of(run.trace, lo, hi)

    metrics = {}
    for m in cell.metrics(traced):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.trace = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference()
    t_judge = time.perf_counter()
    numbers = judge(run, lambda items: ref.expected_many(
        items, cell.config, dev))
    numbers["calls_failed"] += warm_failed
    for f in files:
        f.close()
    for c in run.encode.calls + run.decode.calls:
        if c.out is not None:
            c.out.close()
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in LIMITS.items()}
    say(f"blocks judged by the reference: {numbers['blocks_judged']}; "
        f"restored files judged: {numbers['restored_judged']}; the judge "
        f"took {time.perf_counter() - t_judge:.1f} s, the run "
        f"{process_age_s():.1f} s", file=sys.stderr)
    for k, v in checks.items():
        say(f"check {k}: {v['value']} (limit {v['limit']})",
            file=sys.stderr)
    wrong = numbers["restored_wrong"] + numbers["container_faults"]
    result = {"correct": correct(numbers),
              "attempted": len(run.encode.calls) + len(run.decode.calls),
              "failed": numbers["calls_failed"] + wrong
              + numbers["blocks_wrong"],
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def breakdown_of(trace: Trace, lo: float, hi: float) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the benchmark's span and the host operation
    running at its middle."""
    gaps = sorted(trace.gaps(lo, hi), key=lambda g: g[0] - g[1])[:10]
    idle = []
    for s, t in gaps:
        mid = (s + t) / 2
        phase = ("encode" if mid < trace.span("encode")[1] else "decode")
        idle.append([f"{phase}: {trace.host_at(mid) or 'no host op'}",
                     (t - s) / 1e6])
    return {"device_ops": trace.top_kernels(lo, hi), "idle_gaps": idle}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cell = Cell(root, args.workload)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}; the port must not",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
