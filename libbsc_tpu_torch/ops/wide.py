"""CODER_QLFC_WIDE: format constants, the lane policy and the native codec.

The payload layout, the model and the coder are specified in the JAX
package's ``ops/wide.py``; this module keeps what the port's main path
needs: the context count, the exponent caps, the lane-count policy and
the native ``wide_encode``/``wide_decode`` wrappers (the host route for
blocks the kernels do not take).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import tables
from ..errors import corrupt

NCTX = tables.NCTX
RANK_EXP_CAP = 8      # bit_length(rank) in [1, 8]
RUN_EXP_CAP = 25      # bit_length(run) in [2, 25] -> lane chunk < 2^25

MAX_LANES = 65535
DEFAULT_LANES = 1024
GROUP = 128  # lanes per group (each group owns one stream segment)


def priors() -> np.ndarray:
    """Per-context initial probabilities (the installed format table)."""
    return tables.priors()


def lane_sizes(isize: int, n_lanes: int) -> list[int]:
    chunk = -(-isize // n_lanes)  # ceil
    sizes = []
    left = isize
    for _ in range(n_lanes):
        s = min(chunk, left)
        sizes.append(s)
        left -= s
    return sizes


def pick_lanes(isize: int) -> int:
    """DEFAULT_LANES, reduced for small blocks so each lane has at least
    ~4 KiB to amortize its model warm-up."""
    lanes = DEFAULT_LANES
    while lanes > 1 and isize // lanes < 4096:
        lanes //= 2
    while -(-isize // lanes) >= (1 << RUN_EXP_CAP):
        lanes *= 2
    return min(lanes, MAX_LANES)


def pick_lanes_policy(isize: int) -> int:
    """Lane count of a block: TBSC_WIDE_LANES when set (clamped to a power
    of two in [2, MAX_LANES] and to the run-length cap), else pick_lanes.
    Only the 1024-lane point runs on the kernels."""
    try:
        lanes = int(os.environ.get("TBSC_WIDE_LANES", "0"))
    except ValueError:
        lanes = 0
    if lanes <= 0:
        return pick_lanes(isize)
    lanes = max(2, min(1 << (lanes.bit_length() - 1), MAX_LANES))
    while -(-isize // lanes) >= (1 << RUN_EXP_CAP):
        lanes *= 2
    return min(lanes, MAX_LANES)


def wide_encode(data, n_lanes=None, balanced=True, rans=True, sizes=None):
    """Native wide encode.  ``balanced`` uses the native run-count lane
    balancer; ``sizes`` (int32[n_lanes]) passes an explicit lane table
    instead.  Returns the payload, or None when it is not smaller than the
    input."""
    from .. import native

    lib = native.load()
    buf = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8))
    out = np.empty(len(buf) + 65536, dtype=np.uint8)
    L = n_lanes or pick_lanes(len(buf))
    sizes_p = None
    if sizes is not None:
        sizes = np.ascontiguousarray(sizes, dtype=np.int32)
        if sizes.shape != (L,):
            raise ValueError("sizes must have one entry per lane")
        sizes_p = native.i32p(sizes)
    elif balanced and len(buf) >= L:
        sizes = np.zeros(L, dtype=np.int32)
        if lib.tbsc_wide_balanced_sizes(native.u8p(buf), len(buf), L,
                                        native.i32p(sizes)) == 0:
            sizes_p = native.i32p(sizes)
    rc = lib.tbsc_wide_encode(native.u8p(buf), len(buf), native.u8p(out),
                              len(out), L, sizes_p, 1 if rans else 0)
    if rc == -3:
        return None
    if rc < 0:
        raise RuntimeError(f"wide_encode native error {rc}")
    return out[:rc].tobytes()


def wide_decode(payload) -> bytes:
    """Native wide decode.  A payload the native decoder refuses (its
    counts or lane sizes do not fit) raises BscError(DATA_CORRUPT)."""
    from .. import native

    lib = native.load()
    buf = np.ascontiguousarray(np.frombuffer(bytes(payload), dtype=np.uint8))
    if len(buf) < 12:
        raise corrupt("wide payload header")
    (isize,) = struct.unpack_from("<I", buf, 0)
    out = np.empty(int(isize), dtype=np.uint8)
    rc = lib.tbsc_wide_decode(native.u8p(buf), len(buf), native.u8p(out),
                              len(out))
    if rc < 0:
        raise corrupt(f"wide payload (native error {rc})")
    return out[:rc].tobytes()
