"""The lane tables the format's encoders choose for a block, worked out
from the BWT output alone.

A v3 wide payload may cut its block into any partition of lanes, so the
bytes depend on the table: the judge holds a block's table to the one
its route must choose, never to the block's own.

- ``lane_count``: 1,024 lanes, halved while a lane would hold under
  4 KiB, doubled while a lane could reach the run-length cap.
- ``device_table``: the device encoder's split, lane k starting at run
  floor(k R / L) of the block's R runs (1,024 lanes only).
- ``host_table``: the host encoder's split, lanes cut at run boundaries
  so each carries about the same estimated bits under one move-to-front
  walk over the whole block, within a byte cap; None when no such split
  fits, and the host encoder then takes equal lanes.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_LANES = 1024
MAX_LANES = 65535
RANK_CAP, RUN_CAP = 8, 25


def lane_count(n: int) -> int:
    lanes = DEFAULT_LANES
    while lanes > 1 and n // lanes < 4096:
        lanes //= 2
    while -(-n // lanes) >= (1 << RUN_CAP):
        lanes *= 2
    return min(lanes, MAX_LANES)


def run_starts(U: torch.Tensor) -> torch.Tensor:
    """Positions where a run of equal bytes starts (int64, ascending)."""
    first = torch.ones(U.shape[0], dtype=torch.bool, device=U.device)
    first[1:] = U[1:] != U[:-1]
    return torch.nonzero(first).squeeze(1)


def device_table(U: torch.Tensor, lanes: int) -> np.ndarray:
    """Lane sizes (int64 [lanes]) of the run-count quantile split."""
    n = U.shape[0]
    rs = run_starts(U)
    R = rs.shape[0]
    k = torch.arange(1, lanes, device=U.device)
    cuts = rs[(k * R) // lanes].cpu().numpy()
    bounds = np.concatenate([[0], cuts, [n]])
    return np.diff(bounds).astype(np.int64)


def _bitlen(x: np.ndarray) -> np.ndarray:
    return np.frexp(x.astype(np.float64))[1].astype(np.int64)


def mtf_ranks(chars: torch.Tensor) -> torch.Tensor:
    """Move-to-front rank of each run's char (runs in order, one list
    from the identity for the whole block): the distinct chars used
    since the char's last run, or, at its first run, the char plus the
    chars above it used so far."""
    R = chars.shape[0]
    dev = chars.device
    idx = torch.arange(R, device=dev)
    order = torch.sort(chars.long() * R + idx).indices
    c_sorted = chars[order].long()
    prev = torch.full((R,), -1, dtype=torch.int64, device=dev)
    same = c_sorted[1:] == c_sorted[:-1]
    prev[order[1:][same]] = order[:-1][same]
    first = prev < 0
    counts = torch.bincount(c_sorted, minlength=256).tolist()
    starts = np.cumsum([0] + counts)
    rank = torch.where(first, chars.long(), 0)
    for d in range(256):
        if not counts[d]:
            continue
        P = order[starts[d]:starts[d + 1]].contiguous()  # runs of char d
        seen = (torch.searchsorted(P, idx)
                > torch.searchsorted(P, prev, right=True))
        rank += (seen & (~first | (chars.long() < d))).long()
    return rank


def run_bits(rank: np.ndarray, length: np.ndarray) -> np.ndarray:
    """The host balancer's estimate of a run's coded bits."""
    brs = _bitlen(rank)
    b = 2 + np.where(rank > 0, 2 * (brs - 1) + (brs < RANK_CAP), 0)
    brl = _bitlen(length)
    return b + np.where(length != 1, 2 * (brl - 1) + (brl < RUN_CAP), 0)


def host_table(U: torch.Tensor, lanes: int):
    """Lane sizes (int64 [lanes]) of the host encoder's bit-balanced
    split, or None when it does not fit its byte cap."""
    n = int(U.shape[0])
    if n <= 0:
        return None
    cap = -(-n // lanes) * 16
    cap = min(cap, (1 << RUN_CAP) - 1)
    rs_d = run_starts(U)
    rank = mtf_ranks(U[rs_d]).cpu().numpy()
    rs = rs_d.cpu().numpy()
    R = len(rs)
    rend = np.append(rs[1:], n)
    bits = run_bits(rank, rend - rs)
    cb_end = np.cumsum(bits)             # bits through each run's end
    rbits = cb_end - bits                # bits before each run
    total = int(cb_end[-1])
    sizes = np.zeros(lanes, dtype=np.int64)
    pos = ri = done = 0

    def covering(p):  # the first run that ends past p
        return int(np.searchsorted(rend, p, side="right"))

    for k in range(lanes):
        left = lanes - k
        if pos >= n:
            continue
        if left == 1:
            if n - pos >= cap:
                return None
            sizes[k] = n - pos
            pos = n
            continue
        target = (total - done) // left
        start = pos
        # whole runs from run ri: stop before the first that would pass
        # the cap, or after the first that reaches the target
        b = max(int(np.searchsorted(rend, start + cap, side="left")), ri)
        a = max(int(np.searchsorted(cb_end, done + target, side="left")),
                ri)
        if a < b and a < R:
            ri, pos = a + 1, int(rend[a])
        elif b > ri:
            ri, pos = b, int(rend[b - 1])
        if pos == start:  # one run passes the cap: cut inside it
            pos = min(start + cap - 1, n)
            ri = max(ri, covering(pos))
        need = (n - pos) - (left - 1) * (cap - 1)
        if need > 0:
            grow = min(need, (cap - 1) - (pos - start))
            if grow > 0:
                pos = min(pos + grow, n)
            ri = max(ri, covering(pos))
        done = int(rbits[ri]) if ri < R else total
        sizes[k] = pos - start
    return sizes if pos == n else None
