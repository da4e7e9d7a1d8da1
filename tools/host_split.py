#!/usr/bin/env python3
"""Where a 25 MiB block's time goes outside the device stages (CUDA).

    python3 tools/host_split.py                  # this checkout
    python3 tools/host_split.py TREE [TREE ...]  # each tree, in turns
    python3 tools/host_split.py TREE@pageable TREE@untuned  # variants

A tree is a directory that holds ``libbsc_tpu_torch`` (an unpacked
``git archive`` of some commit, say).  Each tree runs in a fresh process
of its own on cuda:0, in the order given (parent, change, change, parent
compares two commits), on the first 25 MiB block of the bench corpus
(``chip_smoke.make_corpus``) with features FASTMODE | MULTITHREADING |
CUDA, and prints ``host split <tree>:`` with a summary (:func:`summary`)
and, on the next line, the JSON it summarizes:

- ``walls``: ``api.compress`` and ``api.decompress`` under ``-m9 -e4 -G``,
  the first call in the process and three warm calls, each traced
  (``TBSC_TRACE``): the call's wall ms beside the sum of its stage lines
  (``stages``, ``outside`` = wall - stages); then three untraced warm calls
  (``untraced``), the main path's warm MB/s;
- ``steps``: each host step outside the stages alone, ms, three times
  ``[cold, warm]``: cold on a fresh buffer, warm on one used once.  The
  Adler-32 of the input and of the result, ``np.empty`` plus a write
  against a write into a reused buffer, ``buf.copy()`` against
  ``np.copyto``, ``bytes(payload) + tail``, the decode's slice of the
  payload off the archive, ``tobytes()`` of the block,
  the native LZP into a fresh output and into a reused one, the block's
  H2D and D2H between device memory and pageable memory, and the same
  with page-locked memory;
- ``pinned``: ``torch.empty(cap, pin_memory=True)`` of a pool slot's
  capacity, first and again after a free; the same from a new thread each
  time (as a farm's worker threads get their slots) and the thread's join;
- ``files``: the CLI on ``chip_smoke.py`` phase 8's file (two blocks and
  a tail), ``-m9 -e4 -G``: ``cli.compress_file`` and
  ``cli.decompress_file`` with the farm, and the decode with ``-t``,
  three times each, ms.

A variant, ``TREE@pageable`` or ``TREE@untuned``, runs a tree that has
the host buffer pool with no slot page-locked (``bufpool.get`` called with
``pinned=False``) or without ``engine._tune_allocator``'s ``mallopt``, to
tell the two apart.

Every tree's archive and round trip are checked; a failure exits 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 25 << 20
REPEATS = 3


def _ms(t0: float) -> float:
    return round((time.perf_counter() - t0) * 1e3, 4)


def split(tree: str, variant: str = "") -> dict:
    """The split of one tree, in this process (the tree is imported),
    under ``variant`` (see the module docstring)."""
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import libbsc_tpu_torch as P
    from chip_smoke import make_corpus
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine, native
    from libbsc_tpu_torch.ops import _cuda
    from libbsc_tpu_torch.utils import trace
    from libbsc_tpu_torch.utils.adler32 import adler32

    dev = torch.device("cuda", 0)
    _cuda.build_all()
    native.load()
    data = make_corpus(BLOCK)
    features = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING \
        | C.FEATURE_CUDA
    if variant == "untuned":  # engine.init then leaves glibc as it is
        engine._mallopt_done = True
    elif variant == "pageable":  # no slot is page-locked
        from libbsc_tpu_torch.utils import bufpool

        get = bufpool.get
        bufpool.get = lambda slot, nbytes, pinned=False: get(slot, nbytes)
    elif variant:
        raise SystemExit(f"unknown variant {variant}")
    P.init(features, device=dev)
    kw = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
              coder=C.CODER_QLFC_WIDE)

    def call(fn, traced: bool):
        err = io.StringIO()
        trace.TRACE = traced
        with contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = _ms(t0)
        trace.TRACE = False
        stages = {}
        for ln in err.getvalue().splitlines():
            if ln.startswith("[tbsc] "):
                f = ln.split()
                stages[f[1][:-1]] = round(float(f[3][:-1]) * 1e3, 4)
        return out, {"wall": wall, "stages": stages,
                     "outside": round(wall - sum(stages.values()), 4)}

    walls = {"compress": [], "decompress": []}
    archive = None
    for _ in range(1 + REPEATS):
        arc, w = call(lambda: P.compress(data, **kw), True)
        walls["compress"].append(w)
        back, w = call(lambda: P.decompress(arc), True)
        walls["decompress"].append(w)
        if archive is None:
            archive = arc
        if arc != archive or back != data:
            raise SystemExit(f"{tree}: the archive changed or the block "
                             "did not come back")
    untraced = {"compress": [], "decompress": []}
    for _ in range(REPEATS):
        untraced["compress"].append(
            call(lambda: P.compress(data, **kw), False)[1]["wall"])
        untraced["decompress"].append(
            call(lambda: P.decompress(archive), False)[1]["wall"])
    mb = len(data) / 1e6
    rates = {"first": {k: round(mb / v[0]["wall"] * 1e3, 2)
                       for k, v in walls.items()},
             "warm": {k: round(mb / min(v) * 1e3, 2)
                      for k, v in untraced.items()}}

    # each host step alone: [cold, warm] REPEATS times
    n = len(data)
    src = np.frombuffer(data, np.uint8)
    steps: dict = {}

    def pair(name, cold, warm):
        t0 = time.perf_counter()
        cold()
        c = _ms(t0)
        t0 = time.perf_counter()
        warm()
        steps.setdefault(name, []).append([c, _ms(t0)])

    lib = native.load()
    threads = engine.num_threads(features)
    tail_len = 5 + 4 * int.from_bytes(archive[-5:-1], "little")
    payload = archive[C.HEADER_SIZE:-tail_len]
    tail = archive[-tail_len:]
    host_t = torch.empty(n, dtype=torch.uint8)
    pin = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pin.numpy()[:] = src
    host_t.numpy()[:] = src
    on_dev = torch.empty(n, dtype=torch.uint8, device=dev)
    on_dev.copy_(pin)
    torch.cuda.synchronize()

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    for _ in range(REPEATS):
        fresh = src.copy()
        pair("adler_input", lambda: adler32(fresh), lambda: adler32(fresh))
        result = bytes(fresh)
        pair("adler_result", lambda: adler32(result),
             lambda: adler32(result))
        del fresh, result
        reuse = np.empty(n, np.uint8)
        np.copyto(reuse, src)
        pair("empty_write", lambda: np.copyto(np.empty(n, np.uint8), src),
             lambda: np.copyto(reuse, src))
        pair("copy", lambda: src.copy(), lambda: np.copyto(reuse, src))
        pair("concat", lambda: bytes(payload) + tail,
             lambda: bytes(payload) + tail)
        pair("slice", lambda: bytes(archive[C.HEADER_SIZE:]),
             lambda: bytes(archive[C.HEADER_SIZE:]))
        pair("tobytes", lambda: reuse.tobytes(), lambda: reuse.tobytes())
        out = np.empty(n + 1024, np.uint8)
        lzp = (lambda o: lib.tbsc_lzp_compress(
            native.u8p(src), native.u8p(o), n, C.DEFAULT_LZPHASHSIZE,
            C.DEFAULT_LZPMINLEN, threads))
        lzp(out)
        pair("lzp", lambda: lzp(np.empty(n + 1024, np.uint8)),
             lambda: lzp(out))
        fresh = src.copy()
        pair("h2d_pageable",
             synced(lambda: on_dev.copy_(torch.from_numpy(fresh))),
             synced(lambda: on_dev.copy_(torch.from_numpy(fresh))))
        del fresh
        pair("d2h_pageable", synced(lambda: on_dev.cpu()),
             synced(lambda: host_t.copy_(on_dev)))
        pair("h2d_pinned",
             synced(lambda: on_dev.copy_(pin, non_blocking=True)),
             synced(lambda: on_dev.copy_(pin, non_blocking=True)))
        pair("d2h_pinned",
             synced(lambda: pin.copy_(on_dev, non_blocking=True)),
             synced(lambda: pin.copy_(on_dev, non_blocking=True)))
        del reuse, out
    if not np.array_equal(pin.numpy(), src):
        raise SystemExit(f"{tree}: the copies did not keep the block")

    # pinned slots: a pool slot's capacity (engine's LZP output, 1.25x)
    cap = (n + 1024) + (n + 1024) // 4
    pinned: dict = {"cap": cap, "alloc": [], "thread": []}
    for _ in range(2):
        t0 = time.perf_counter()
        slot = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        pinned["alloc"].append(_ms(t0))
        del slot
    for _ in range(2):
        got = {}

        def worker():
            t0 = time.perf_counter()
            got["slot"] = torch.empty(cap, dtype=torch.uint8,
                                      pin_memory=True)
            got["alloc"] = _ms(t0)
            del got["slot"]

        th = threading.Thread(target=worker)
        t0 = time.perf_counter()
        th.start()
        th.join(timeout=60)
        if th.is_alive():
            raise SystemExit(f"{tree}: a pinning thread did not end")
        pinned["thread"].append([got["alloc"], _ms(t0)])
    # the CLI on chip_smoke.py phase 8's file: -m9 -e4 -G, encoded and
    # decoded with the farm (its worker threads new each call), and
    # decoded with -t
    from chip_smoke import CLI_TAIL, MANY_BLOCKS
    from libbsc_tpu_torch import cli

    fdata = make_corpus(MANY_BLOCKS * BLOCK)[:2 * BLOCK + CLI_TAIL]
    files: dict = {"bytes": len(fdata), "encode": [], "decode": [],
                   "decode_t": []}
    with tempfile.TemporaryDirectory() as tmp:
        inp, arch, back = (os.path.join(tmp, x) for x in ("in", "a", "r"))
        with open(inp, "wb") as f:
            f.write(fdata)
        for _ in range(REPEATS):
            for key, src_, dst, sw in (("encode", inp, arch, "-m9e4G"),
                                       ("decode", arch, back, "-m9e4G"),
                                       ("decode_t", arch, back, "-m9e4Gt")):
                p = cli.parse_args(["cli", "e", inp, arch, sw])
                run = cli.compress_file if key == "encode" \
                    else cli.decompress_file
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(src_, dst, p, quiet=True)
                torch.cuda.synchronize()
                files[key].append(_ms(t0))
                if key != "encode":
                    with open(back, "rb") as f:
                        if f.read() != fdata:
                            raise SystemExit(f"{tree}: cli {sw} did not "
                                             "restore the file")
    return {"tree": tree, "variant": variant, "walls": walls,
            "untraced": untraced, "mb_s": rates, "steps": steps,
            "pinned": pinned, "files": files,
            "archive_bytes": len(archive)}


def summary(d: dict) -> str:
    """One line of a tree's split: walls beside their stages, each step's
    best cold and warm ms, the pinning times."""
    parts = []
    for call in ("compress", "decompress"):
        first, *warm = d["walls"][call]
        w = "/".join(f"{x['wall']:.1f}" for x in warm)
        s = "/".join(f"{sum(x['stages'].values()):.1f}" for x in warm)
        o = "/".join(f"{x['outside']:.1f}" for x in warm)
        parts.append(
            f"{call} first {first['wall']:.1f} ms (stages "
            f"{sum(first['stages'].values()):.1f}, outside "
            f"{first['outside']:.1f}), warm {w} (stages {s}, outside {o}), "
            f"untraced {'/'.join(f'{x:.1f}' for x in d['untraced'][call])}"
            f" ms: {d['mb_s']['first'][call]:.2f} MB/s first, "
            f"{d['mb_s']['warm'][call]:.2f} warm")
    steps = ", ".join(
        f"{k} {min(c for c, _ in v):.2f}/{min(w for _, w in v):.2f}"
        for k, v in d["steps"].items())
    pin = d["pinned"]
    threads = ", ".join(f"{a:.2f} (join {j:.2f})" for a, j in pin["thread"])
    fl = d["files"]
    files = ", ".join(
        f"{k} {'/'.join(f'{x:.1f}' for x in fl[k])} ms "
        f"({fl['bytes'] / min(fl[k]) / 1e3:.2f} MB/s best)"
        for k in ("encode", "decode", "decode_t"))
    return ("; ".join(parts) + f"; steps, cold/warm ms (best of "
            f"{len(next(iter(d['steps'].values())))}): {steps}; pinned "
            f"{pin['cap']} B: {pin['alloc'][0]:.2f} ms first, "
            f"{pin['alloc'][1]:.2f} again, in a new thread {threads}; "
            f"cli file of {fl['bytes']} B: {files}")


def main(argv: list) -> int:
    if argv[:1] == ["--tree"]:
        print("HOSTSPLIT " + json.dumps(split(os.path.abspath(argv[1]),
                                              *argv[2:3])), flush=True)
        return 0
    code = 0
    for tree in argv or [ROOT]:
        path, _, variant = tree.partition("@")
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", path,
             variant], capture_output=True, text=True, timeout=900)
        lines = [ln[10:] for ln in out.stdout.splitlines()
                 if ln.startswith("HOSTSPLIT ")]
        if out.returncode != 0 or not lines:
            print(f"host split {tree}: FAILED (exit {out.returncode})\n"
                  f"{out.stdout[-2000:]}{out.stderr[-4000:]}",
                  file=sys.stderr)
            code = 1
            continue
        print(f"host split {tree}: {summary(json.loads(lines[0]))}\n"
              f"  {lines[0]}", flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
