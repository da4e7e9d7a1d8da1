"""The benchmark's control for the cells of bsc's Sort Transform formats
(``"reference": "block_st"``): a run of the cell in which the reference
writes the archives in the program's place, each block sorted at order
k-1 under order k's mode word (the shortcut a faster sort could take:
one context byte fewer), judged as every run is.  Its result line has to
read ``"correct": false``.

    python3 portbench/control_st.py --workload m5.text.1blk --seeds 3 \
        --seconds 20

runs it on the CUDA card, one run a seed, at the cell's own file size;
each run prints its checks on standard error and its result line on
standard output.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.control import block_bytes  # noqa: E402
from portbench.harness import Cell, forbidden_modules, run_cell  # noqa: E402
from portbench.ref import block_st, container  # noqa: E402


def compressor(cell: Cell, device):
    """``compress(src path, archive path)``: the control's archive of a
    file, a ``bsc1`` container of blocks sorted one order below the mode
    word's."""
    size = block_bytes(cell.config["switches"])
    order = block_st.order_of(cell.config) - 1

    def compress(src: str, out: str) -> None:
        with open(src, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        offsets = range(0, len(data), size)
        parts = [container.MAGIC, struct.pack("<i", len(offsets))]
        for lo in offsets:
            parts.append(container.ENTRY.pack(lo, 1, 1))
            parts.append(block_st.encode(data[lo:lo + size], cell.config,
                                         device, order=order))
        with open(out, "wb") as f:
            f.write(b"".join(parts))

    return compress


def control_run(root, name: str, seed: int, seconds: float, device=None,
                say=print) -> dict:
    """One run of cell ``name`` with the control in the program's place;
    returns its result line's object."""
    cell = Cell(root, name)
    return run_cell(root, name, seed, seconds, False, device=device,
                    say=say, compress=compressor(cell, device or "cuda"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_200_000_001)
    ap.add_argument("--seconds", type=float, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent.parent
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        res = control_run(root, args.workload, seed, args.seconds)
        checks = res["checks"]
        print(f"control {args.workload} seed {seed}: correct "
              f"{res['correct']}; " + ", ".join(
                  f"{k} {v['value']} (limit {v['limit']})"
                  for k, v in checks.items()), file=sys.stderr, flush=True)
        print(json.dumps(res), flush=True)
    if forbidden_modules():
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
