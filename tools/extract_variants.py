#!/usr/bin/env python3
"""K14's pass 1 (``bwt_extract_bin_kernel``) at other block shapes, on the
card: the checkout's ``csrc/bwt_sort.cu`` copied with its block's threads,
its suffixes a thread and its blocks an SM (``__launch_bounds__``) set
otherwise, each built by its own nvcc (all started together).

    python3 tools/extract_variants.py

On the 25 MiB corpus block's final ranks (the first block of
``chip_smoke.make_corpus``, seed 0xB5C, at its wide-aux rate), with CUDA
events, the best of ``REPS`` launches after a warm-up: each shape's pass 1
(the cursors zeroed inside the timing, as the wrapper does) and pass 2,
with U, the primary and the aux indexes held to ``extract_plain``; the
package's own ``extract`` beside them.  Prints one line a shape, then
the JSON (also written to ``_build/extract_variants/`` in the package).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.heads_variants import best_ms, smi  # noqa: E402

BLOCK = 25 << 20
REPS = 5
BUILD = ROOT / "libbsc_tpu_torch" / "_build" / "extract_variants"
# name -> (threads a block, suffixes a thread, blocks an SM or 0: none set)
SHAPES = {"t512i16": (512, 16, 0), "t512i16m2": (512, 16, 2),
          "t512i8m2": (512, 8, 2), "t256i32": (256, 32, 0),
          "t256i16m3": (256, 16, 3), "t1024i8": (1024, 8, 0)}


def variant_source(src: str, threads: int, items: int, blocks: int) -> str:
    """bwt_sort.cu with pass 1's block shape replaced."""
    out, n = re.subn(r"constexpr int kBinThreads = \d+;",
                     f"constexpr int kBinThreads = {threads};", src)
    out, m = re.subn(r"constexpr int kBinItems = \d+;",
                     f"constexpr int kBinItems = {items};", out)
    bound = f"({threads}, {blocks})" if blocks else "(kBinThreads)"
    out, k = re.subn(r"__launch_bounds__\(kBinThreads(, \d+)?\)",
                     f"__launch_bounds__{bound}", out)
    if (n, m, k) != (1, 1, 1):
        raise SystemExit("bwt_sort.cu: pass 1's shape not found")
    return out


def build(out_dir: Path) -> dict:
    """One library a shape, all nvcc started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "libbsc_tpu_torch" / "csrc" / "bwt_sort.cu").read_text()
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists(
        "/usr/local/cuda/bin/nvcc") else "nvcc"
    procs = {}
    for name, shape in SHAPES.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, *shape))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    VP, L = ctypes.c_void_p, ctypes.c_int64
    for name, proc in procs.items():
        log, _ = proc.communicate()
        regs = re.findall(r"bwt_extract_bin_kernel.*?\n.*?\n.*?Used (\d+) "
                          r"registers", log, re.S)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.bwt_extract_bins_launch.argtypes = [VP, VP, L, L, L] + [VP] * 5
        lib.bwt_extract_place_launch.argtypes = [VP, L, VP, VP]
        libs[name] = (lib, regs[0] if regs else "?")
    return libs


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import make_corpus
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = build(BUILD)
    stream = torch.cuda.current_stream(dev).cuda_stream
    d = torch.from_numpy(np.frombuffer(make_corpus(BLOCK), np.uint8)
                         .copy()).to(dev)
    n = int(d.shape[0])
    r = engine.wideaux_rate(n)
    final = bwt.suffix_ranks(d)
    want = bwt.extract_plain(d, final, r)
    n_aux = (n - 1) // r
    cursor = torch.zeros(-(-n // (1 << 16)), dtype=torch.int32, device=dev)
    stage = torch.empty(n, dtype=torch.int32, device=dev)
    primary = torch.empty((), dtype=torch.int64, device=dev)
    aux = torch.empty(n_aux, dtype=torch.int32, device=dev)
    U = torch.empty(n, dtype=torch.uint8, device=dev)
    res = {"n": n, "card": smi(), "package_extract": best_ms(
        lambda: bwt.extract(d, final, r))}
    for name, (lib, regs) in libs.items():
        def bins(lib=lib):
            cursor.zero_()
            rc = lib.bwt_extract_bins_launch(
                d.data_ptr(), final.data_ptr(), n, r, n_aux,
                cursor.data_ptr(), stage.data_ptr(), primary.data_ptr(),
                aux.data_ptr(), stream)
            if rc:
                raise SystemExit(f"{name}: pass 1 cudaError_t {rc}")

        def place(lib=lib):
            rc = lib.bwt_extract_place_launch(stage.data_ptr(), n,
                                              U.data_ptr(), stream)
            if rc:
                raise SystemExit(f"{name}: pass 2 cudaError_t {rc}")

        bins_ms, place_ms = best_ms(bins, REPS), best_ms(place, REPS)
        if not (torch.equal(U, want[0]) and int(primary) == int(want[1])
                and torch.equal(aux, want[2])):
            raise SystemExit(f"{name}: K14 differs from extract_plain")
        res[name] = {"shape": SHAPES[name], "registers": regs,
                     "bins_ms": bins_ms, "place_ms": place_ms}
        print(f"K14 {name} {SHAPES[name]}: {regs} registers, pass 1 "
              f"{bins_ms:.4f} ms, pass 2 {place_ms:.4f} ms", flush=True)
    print(f"K14 the package's extract {res['package_extract']:.4f} ms; "
          f"{n} rows; {res['card']}", flush=True)
    (BUILD / "extract_variants.json").write_text(json.dumps(res))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
