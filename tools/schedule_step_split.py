#!/usr/bin/env python3
"""Where K9's time goes (``sched_events_kernel``, csrc/wide_schedule.cu),
on the card.

For each given ``csrc`` directory, takes its ``wide_schedule.cu``, adds
``clock64()`` counters to a copy, builds the plain and the counted copy
with nvcc and runs both on one 25 MiB block's own schedule inputs (the
corpus's first block through the port's device wide-aux BWT and device
lane table, as ``chip_smoke.py`` phase 2 times K9).  Lane 0 of every warp
(a warp is a lane of the coder) sums, over its runs, the cycles of each
part, read where the warp is converged (``__syncwarp`` before each
``clock64()``, as tools/decode_step_split.py does); the tool prints the
cycles a run of each part (the mean over the warps, and the longest lane's
warp), the kernel's time with and without the counters (CUDA events, the
mean of five launches after a warm-up), the longest lane's warp
launched alone (the lane of the most bytes, and the lane of the most
runs), and the same csrc's K10 on K9's outputs (held against
``schedule_planes_plain``), so that two designs given together are timed
in one process on one card.

The serial design (up to commit 4f7f1b7: the warp reads its lane 2 KiB a
step and ranks one run at a time against last-use times) splits a run
into

    scan      the lane's bytes: the next step's loads, the run starts of
              each 512 bytes and their ballot
    hand      handing a thread's run starts to the warp (five shuffles)
    rank      the run's rank: the char's last-use time, eight compares
              and the warp reduction, the table write
    close     closing the previous run: its bits and the store slot

(the cycles of a 512-byte span with no run start land in scan).  The batch
design (a batch of 32 runs a warp step, from the run starts lane_runs
found) splits a batch, per run, into

    load      the next batches' run starts and chars, and each run's
              length
    rank      the batch's ranks: the match, the prefix of later uses and
              the eight ballots of the new chars' positions
    update    the table's partition: the batch's chars to the front
    store     the bit counts, their prefix (each run's first bit) and the
              four stores

Every variant's output is held against ``schedule_events_plain``.

    git archive 4f7f1b7 libbsc_tpu_torch/csrc | tar -x -C _archive/parent
    python3 tools/schedule_step_split.py _archive/parent/libbsc_tpu_torch/csrc \\
        libbsc_tpu_torch/csrc

With no argument it splits the checkout's own csrc; a design whose source
the anchors do not fit is timed only.  Needs a CUDA card and nvcc; writes
its builds and a JSON of the splits into
libbsc_tpu_torch/_build/schedule_step_split/ and prints the JSON last.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.decode_step_split import nvcc  # noqa: E402

MAX_WARPS = 4096
PARTS = {"serial": ("scan", "hand", "rank", "close"),
         "batch": ("load", "rank", "update", "store")}

PRELUDE = """
__device__ unsigned long long g_clk[4096][8];
#define SPLIT_MARK(k)                \\
  do {                               \\
    __syncwarp();                    \\
    const long long t1_ = clock64(); \\
    acc_[k] += t1_ - t0_;            \\
    t0_ = t1_;                       \\
  } while (0)
#define SPLIT_BEGIN                                \\
  unsigned long long acc_[4] = {0, 0, 0, 0};       \\
  long long t0_ = clock64()
#define SPLIT_END(runs)                                           \\
  if ((threadIdx.x & 31) == 0 && k < 4096) {                      \\
    for (int k_ = 0; k_ < 4; ++k_) g_clk[k][k_] = acc_[k_];       \\
    g_clk[k][7] = (runs);                                         \\
  }
"""

TAIL = """
extern "C" int clk_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));
}
"""

# (anchor, replacement) pairs; each anchor must occur exactly once
PATCHES = {
    "serial": [
        ("  int prev = -1;  // the byte before this 512-byte span (none at "
         "lo)\n",
         "  int prev = -1;  // the byte before this 512-byte span (none at "
         "lo)\n  SPLIT_BEGIN;\n"),
        ("      unsigned act = __ballot_sync(kFull, m != 0);\n",
         "      unsigned act = __ballot_sync(kFull, m != 0);\n"
         "      SPLIT_MARK(0);\n"),
        ("        const long long pt = (w0 + t) * 16;\n",
         "        const long long pt = (w0 + t) * 16;\n"
         "        SPLIT_MARK(1);\n"),
        ("          ++clock;\n", "          ++clock;\n          SPLIT_MARK(2);\n"),
        ("          pstart = pt + i;\n",
         "          pstart = pt + i;\n          SPLIT_MARK(3);\n"),
        ("  if (lane == 0) total_out[k] = total;\n",
         "  SPLIT_END(q);\n  if (lane == 0) total_out[k] = total;\n"),
    ],
    "batch": [
        ("  long long carry = 0;  // the lane's bits so far\n",
         "  long long carry = 0;  // the lane's bits so far\n  SPLIT_BEGIN;\n"),
        ("    const int len = (int)(pe - p);\n",
         "    const int len = (int)(pe - p);\n    SPLIT_MARK(0);\n"),
        ("    const int rank = last >= 0\n",
         "    SPLIT_MARK(1);\n    const int rank = last >= 0\n"),
        ("    __syncwarp();  // the table holds the batch\n",
         "    __syncwarp();  // the table holds the batch\n    SPLIT_MARK(2);\n"),
        ("    c = cn;\n", "    c = cn;\n    SPLIT_MARK(3);\n"),
        ("  if (lane == 0) total_out[k] = carry;\n",
         "  SPLIT_END(nr);\n  if (lane == 0) total_out[k] = carry;\n"),
    ],
}


def design(src: str) -> str:
    return "serial" if "close_run" in src else "batch"


def instrument(src: str) -> str:
    for old, new in PATCHES[design(src)]:
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found exactly once: {old!r}")
        src = src.replace(old, new)
    anchor = "namespace {\n"
    return src.replace(anchor, PRELUDE + "\n" + anchor, 1) + TAIL


def build(dirs: list, out_dir: Path) -> dict:
    """(dir index, variant) -> CDLL; one nvcc per copy, all started
    together."""
    jobs = {}
    for d, csrc in enumerate(dirs):
        src = (csrc / "wide_schedule.cu").read_text()
        variants = [("plain", src)]
        try:
            variants.append(("clock", instrument(src)))
        except SystemExit as e:  # timed only
            print(f"{csrc}: no counters ({e})")
        for variant, text in variants:
            vdir = out_dir / f"{d}_{variant}"
            vdir.mkdir(parents=True, exist_ok=True)
            path = vdir / "wide_schedule.cu"
            path.write_text(text)
            jobs[(d, variant)] = (path, csrc, vdir / "libwide_schedule.so")
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(lambda j: nvcc(*j), jobs.values()))
    return {k: ctypes.CDLL(str(j[2])) for k, j in jobs.items()}


def split(clk, kind: str, lanes: dict) -> dict:
    """Cycles a run of each part: the mean over the warps with runs, and
    each named lane's warp."""
    import numpy as np

    parts = PARTS[kind]
    n = clk[:, 7].astype(np.float64)
    sel = n > 0
    per = clk[sel, :len(parts)].astype(np.float64) / n[sel, None]
    mean = per.mean(axis=0)
    out = {"cycles_per_run": dict(zip(parts, mean.tolist())),
           "total": float(mean.sum()), "warps": int(sel.sum())}
    for name, k in lanes.items():
        if n[k]:
            own = clk[k, :len(parts)].astype(np.float64) / n[k]
            out[name] = {"lane": int(k), "runs": int(n[k]),
                         "cycles_per_run": dict(zip(parts, own.tolist())),
                         "cycles": int(clk[k, :len(parts)].sum())}
    return out


def planes_ms(lib, kind: str, ev: tuple, frid_ext, IT: int, want,
              handle) -> float:
    """K10 of one build on K9's plain outputs ``ev``: its mean ms (CUDA
    events, five launches after a warm-up), its planes held against
    ``want``.  The serial design's K10 scans the bit counts into a
    scratch of its own; the batch design's reads K9's first bits."""
    import ctypes as ct

    import torch

    import chip_smoke as CS

    rank, ln, bits, total, S = ev
    L = int(total.shape[0])
    out = torch.empty((L, IT // 4), dtype=torch.uint8, device=rank.device)
    VP, I, LL = ct.c_void_p, ct.c_int, ct.c_int64
    fn = lib.sched_planes_launch
    fn.restype = I
    if kind == "serial":
        scratch = torch.empty_like(rank)
        args = [rank.data_ptr(), ln.data_ptr(), bits.data_ptr(),
                total.data_ptr(), frid_ext.data_ptr(), L, IT // 16,
                scratch.data_ptr(), out.data_ptr(), handle]
    else:
        args = [rank.data_ptr(), ln.data_ptr(), S.data_ptr(),
                total.data_ptr(), frid_ext.data_ptr(), L, IT // 16,
                out.data_ptr(), handle]
    fn.argtypes = [VP] * 5 + [I, LL] + [VP] * (len(args) - 7)

    def call():
        rc = fn(*args)
        if rc:
            raise SystemExit(f"sched_planes launch failed: cudaError_t {rc}")

    ms = CS.cuda_ms(call, 5)
    if CS.max_err((out,), (want,)):
        raise SystemExit(f"{kind} K10 differs from its plain version")
    return ms


def run(dirs: list, u_d, sizes, clock_mhz: float, out_dir: Path) -> dict:
    """Split and time K9 of each csrc in ``dirs`` on the block ``u_d`` (u8
    on the card) with the lane table ``sizes``.  Prints a line a csrc and
    returns {csrc: row}."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from libbsc_tpu_torch.ops import wide_kernels as WK
    from libbsc_tpu_torch.ops import wide_schedule as WS

    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(dirs, out_dir)
    dev = u_d.device
    sizes_d = torch.as_tensor(np.asarray(sizes)).to(device=dev,
                                                    dtype=torch.int64)
    starts, frid_ext, R, rs = WS.lane_runs(u_d, sizes_d)[:4]
    L = int(starts.shape[0])
    ref = WS.schedule_events_plain(u_d, starts, sizes_d, frid_ext)
    IT = WK._it_bucket(max(int(ref[3].max()), WK.TI))
    planes = WS.schedule_planes_plain(*ref, frid_ext, IT)
    nruns = (frid_ext[1:] - frid_ext[:-1]).cpu().numpy()
    lanes = {"longest_lane": int(np.argmax(np.asarray(sizes))),
             "most_runs": int(np.argmax(nruns))}
    handle = torch.cuda.current_stream(dev).cuda_stream
    VP, I = ctypes.c_void_p, ctypes.c_int
    result = {}
    for d, csrc in enumerate(dirs):
        kind = design((csrc / "wide_schedule.cu").read_text())
        row = {"design": kind, "runs": R, "lanes": L,
               "lane_bytes": {k: int(np.asarray(sizes)[v])
                              for k, v in lanes.items()},
               "lane_runs": {k: int(nruns[v]) for k, v in lanes.items()}}
        for variant in ("plain", "clock"):
            lib = libs.get((d, variant))
            if lib is None:
                continue
            outs = [torch.empty(R, dtype=torch.int32, device=dev)
                    for _ in range(3 if kind == "serial" else 4)]
            total = torch.empty(L, dtype=torch.int64, device=dev)
            fn = lib.sched_events_launch
            fn.restype = I

            def args(k0, nl):  # lanes k0 .. k0 + nl - 1
                lane = [starts.data_ptr() + 8 * k0,
                        sizes_d.data_ptr() + 8 * k0,
                        frid_ext.data_ptr() + 8 * k0]
                head = [u_d.data_ptr()] + \
                    ([] if kind == "serial" else [rs.data_ptr()])
                return [*head, *lane, nl, *(t.data_ptr() for t in outs),
                        total.data_ptr() + 8 * k0, handle]

            fn.argtypes = [VP] * (4 if kind == "serial" else 5) + [I] + \
                [VP] * (len(outs) + 2)

            def call(a):
                rc = fn(*a)
                if rc:
                    raise SystemExit(f"sched_events launch failed: "
                                     f"cudaError_t {rc}")

            whole = args(0, L)
            row[f"{variant}_ms"] = CS.cuda_ms(lambda: call(whole), 5)
            got = (*outs[:3], total, *outs[3:])  # S last, as the wrapper
            if CS.max_err(got, ref[:len(got)]):
                raise SystemExit(f"{csrc} {variant}: K9 differs from its "
                                 "plain version")
            if variant == "plain":
                for name, k in lanes.items():
                    one = args(k, 1)
                    row[f"{name}_ms"] = CS.cuda_ms(lambda: call(one), 5)
                row["k10_ms"] = planes_ms(lib, kind, ref, frid_ext, IT,
                                          planes, handle)
        row["cycles_per_run_from_ms"] = \
            row["plain_ms"] * clock_mhz * 1e3 / (R / L)
        line = (f"{csrc} K9 ({kind}): {row['plain_ms']:.4f} ms, "
                f"{R / L:.0f} runs a lane, "
                f"{row['cycles_per_run_from_ms']:.0f} cycles a run at "
                f"{clock_mhz:.0f} MHz; alone: longest lane "
                f"({row['lane_bytes']['longest_lane']} bytes, "
                f"{row['lane_runs']['longest_lane']} runs) "
                f"{row['longest_lane_ms']:.4f} ms, most runs "
                f"({row['lane_runs']['most_runs']}) "
                f"{row['most_runs_ms']:.4f} ms; K10 {row['k10_ms']:.4f} ms")
        if (d, "clock") in libs:
            clk = np.zeros((MAX_WARPS, 8), dtype=np.uint64)
            rc = libs[(d, "clock")].clk_read(
                clk.ctypes.data_as(ctypes.c_void_p))
            if rc:
                raise SystemExit(f"clk_read failed: {rc}")
            row["split"] = sp = split(clk[:L], kind, lanes)
            line += (f" ({row['clock_ms']:.4f} ms with counters); counted "
                     f"{sp['total']:.0f} cycles a run: " +
                     ", ".join(f"{k} {v:.0f}"
                               for k, v in sp["cycles_per_run"].items()))
            if "longest_lane" in sp:
                own = sp["longest_lane"]
                line += (f"; longest lane's warp {own['cycles']} cycles: " +
                         ", ".join(f"{k} {v:.0f}" for k, v in
                                   own["cycles_per_run"].items()) +
                         " a run")
        result[str(csrc)] = row
        print(line, flush=True)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dirs = [Path(a).resolve() for a in sys.argv[1:]] or \
        [ROOT / "libbsc_tpu_torch" / "csrc"]
    out_dir = ROOT / "libbsc_tpu_torch" / "_build" / "schedule_step_split"

    import chip_smoke as CS
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import native

    native.load()
    dev = torch.device("cuda", 0)
    card = CS.smi()
    clock_mhz = float(CS.smi("clocks.max.sm").split()[0])
    features = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING | C.FEATURE_CUDA
    st = CS.stages(CS.make_corpus(CS.BLOCK), features, dev)
    u_d = torch.from_numpy(st["U"]).to(dev)
    result = {"card": card, "max_sm_clock_mhz": clock_mhz,
              "dirs": [str(d) for d in dirs],
              "splits": run(dirs, u_d, st["sizes"], clock_mhz, out_dir)}
    (out_dir / "split.json").write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
