"""Content detectors: segmentation, context order, record size.

Vectorized reimplementations of the reference heuristics
(filters/detectors.cpp:70-581).  These choose per-block parameters recorded
in the container; they are heuristics, not stream-format definitions, but
they are implemented to match the reference's decisions exactly:

- The order-1 context hash ctx' = ((ctx << 5) ^ sym) & 0xff has the closed
  form ctx_i = (((s[i-2] & 7) << 5) ^ s[i-1]) & 0xff, which makes the
  context sequence computable without a sequential scan.
- The segmentation entropy sweep telescopes into per-occurrence deltas
  (each (context, symbol) occurrence k of m contributes
  delta(m-k) - delta(k-1) when it crosses the split point), so the whole
  sweep is a grouped-rank computation plus a cumulative sum.
"""

from __future__ import annotations

import numpy as np

from . import tables
from ..constants import CONTEXTS_FOLLOWING, CONTEXTS_PRECEDING

DETECTORS_MAX_RECORD_SIZE = 4
DETECTORS_NUM_BLOCKS = 48
DETECTORS_BLOCK_SIZE = 24576


def _o1_contexts(data: np.ndarray) -> np.ndarray:
    """Context sequence of the ((ctx<<5)^sym)&0xff chain, closed form."""
    n = len(data)
    ctx = np.zeros(n, dtype=np.int64)
    if n > 1:
        ctx[1] = data[0]
    if n > 2:
        ctx[2:] = (((data[:-2].astype(np.int64) & 7) << 5) ^ data[1:-1]) & 0xFF
    return ctx


def _rank_within_group(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For each element: its 1-based occurrence rank within its key group and
    the group's total count."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    boundaries = np.empty(len(keys), dtype=bool)
    if len(keys):
        boundaries[0] = True
        boundaries[1:] = sorted_keys[1:] != sorted_keys[:-1]
    group_ids = np.cumsum(boundaries) - 1
    group_start = np.flatnonzero(boundaries)
    counts_per_group = np.diff(np.append(group_start, len(keys)))
    rank_sorted = np.arange(len(keys)) - group_start[group_ids] + 1
    count_sorted = counts_per_group[group_ids]
    rank = np.empty(len(keys), dtype=np.int64)
    count = np.empty(len(keys), dtype=np.int64)
    rank[order] = rank_sorted
    count[order] = count_sorted
    return rank, count


def _segment_split_exact(data: np.ndarray) -> int:
    """Exact reference semantics: the returned blockSize is the index of the
    first position achieving the global minimum of the local entropy, if it
    beats entropy - entropy/32 - 12KiB*2^16; otherwise n."""
    n = len(data)
    if n == 0:
        return 0
    ctx = _o1_contexts(data)
    sym = data.astype(np.int64)
    pair_key = (ctx << 8) | sym
    k_pair, m_pair = _rank_within_group(pair_key)
    k_ctx, m_ctx = _rank_within_group(ctx)
    pair_counts = np.bincount(pair_key, minlength=1 << 16)
    ctx_counts = np.bincount(ctx, minlength=256)
    entropy = int(tables.entropy(ctx_counts).sum() - tables.entropy(pair_counts).sum())
    step = (
        tables.delta(m_pair - k_pair)
        - tables.delta(k_pair - 1)
        - tables.delta(m_ctx - k_ctx)
        + tables.delta(k_ctx - 1)
    )
    local = entropy + np.concatenate([[0], np.cumsum(step)[:-1]])
    threshold = entropy - (entropy >> 5) - (65536 * 12 * 1024)
    mn = local.min()
    if mn >= threshold:
        return n
    return int(np.argmin(local))


def detect_segments(data: np.ndarray, max_segments: int = 256) -> list[int]:
    """Recursive top-down segmentation (detectors.cpp:251-312).

    Returns the list of segment sizes (sums to len(data)).
    """
    n = len(data)
    if n < DETECTORS_BLOCK_SIZE or max_segments == 1:
        return [n]
    split = _segment_split_exact(data)
    if split == n:
        return [n]
    left = detect_segments(data[:split], max_segments - 1)
    right = detect_segments(data[split:], max_segments - len(left))
    return left + right


def _estimate_contextsorder(buf: np.ndarray) -> int:
    """3-symbol rank model entropy (bsc_estimate_contextsorder, :314-358).

    The MTF0/MTF1 chase has closed forms: after step i, mtf0 is always
    buf[i], and mtf1 is the previous symbol DISTINCT from its neighbour
    (carried across equal runs), so the whole classification vectorizes.
    """
    n = len(buf)
    if n == 0:
        return 0
    c = buf.astype(np.int64)
    prev = np.empty(n, dtype=np.int64)  # mtf0 before step i
    prev[0] = 0
    prev[1:] = c[:-1]
    # mtf1 before step i: at steps where c != prev, mtf1 becomes prev; the
    # initial value is 1
    upd = c != prev
    idx = np.where(upd, np.arange(n), -1)
    last = np.maximum.accumulate(idx)
    mtf1_after = np.where(last >= 0, prev[np.maximum(last, 0)], 1)
    mtf1_before = np.empty(n, dtype=np.int64)
    mtf1_before[0] = 1
    mtf1_before[1:] = mtf1_after[:-1]
    cls = np.where(c == prev, 0, np.where(c == mtf1_before, 1, 2))
    # context = previous four classes packed two bits each (newest lowest)
    clspad = np.concatenate([np.zeros(4, dtype=np.int64), cls])
    mtfc = (clspad[3:-1] | (clspad[2:-2] << 2) | (clspad[1:-3] << 4)
            | (clspad[0:-4] << 6))
    freq = np.bincount(mtfc * 3 + cls, minlength=768).reshape(256, 3)
    counts = freq.sum(axis=1)
    return int(tables.entropy(counts).sum() - tables.entropy(freq).sum())


def detect_contextsorder(data: np.ndarray, fast: bool = True) -> int:
    """Pick following vs preceding contexts (detectors.cpp:360-440)."""
    n = len(data)
    if fast and n > DETECTORS_NUM_BLOCKS * DETECTORS_BLOCK_SIZE:
        stride = ((n - DETECTORS_NUM_BLOCKS * DETECTORS_BLOCK_SIZE) // DETECTORS_NUM_BLOCKS // 48) * 48
        blocks = [
            data[b * (DETECTORS_BLOCK_SIZE + stride) : b * (DETECTORS_BLOCK_SIZE + stride) + DETECTORS_BLOCK_SIZE]
            for b in range(DETECTORS_NUM_BLOCKS)
        ]
        data = np.concatenate(blocks)
        n = len(data)

    d = data.astype(np.int64)
    # Following contexts: positions j sorted stably by (T[j+1], T[j+2]),
    # emitting T[j].  The reference iterates j = n-2, n-1, 0, 1, ..., n-3
    # (detectors.cpp:398-404), which fixes the tie order of the two
    # wrapped positions.
    seq_f = np.r_[n - 2, n - 1, 0 : n - 2]
    keyf = ((np.roll(d, -1) << 8) | np.roll(d, -2))[seq_f]
    orderf = np.argsort(keyf, kind="stable")
    following = _estimate_contextsorder(data[seq_f][orderf])

    # Preceding contexts: positions i iterated descending from n-1 with the
    # two wrapped successors first, sorted stably by (T[i+1], T[i]),
    # emitting T[i+2] (detectors.cpp:412-420).
    seq_p = np.arange(n - 1, -1, -1)
    keyp = ((np.roll(d, -1) << 8) | d)[seq_p]
    orderp = np.argsort(keyp, kind="stable")
    emit_p = np.roll(d, -2)[seq_p]
    preceding = _estimate_contextsorder(emit_p[orderp].astype(np.uint8))

    return CONTEXTS_PRECEDING if preceding < following else CONTEXTS_FOLLOWING


def detect_recordsize(data: np.ndarray, fast: bool = True) -> int:
    """Detect interleaved record size 1..4 (detectors.cpp:461-581)."""
    n = len(data)
    if fast and n > DETECTORS_NUM_BLOCKS * DETECTORS_BLOCK_SIZE:
        stride = ((n - DETECTORS_NUM_BLOCKS * DETECTORS_BLOCK_SIZE) // DETECTORS_NUM_BLOCKS // 48) * 48
        blocks = [
            data[b * (DETECTORS_BLOCK_SIZE + stride) : b * (DETECTORS_BLOCK_SIZE + stride) + DETECTORS_BLOCK_SIZE]
            for b in range(DETECTORS_NUM_BLOCKS)
        ]
        data = np.concatenate(blocks)
        n = len(data)

    n -= n % 48
    data = data[:n]
    d = data.astype(np.int64)

    ent = np.zeros(DETECTORS_MAX_RECORD_SIZE, dtype=np.int64)
    for rs in range(1, DETECTORS_MAX_RECORD_SIZE + 1):
        total = 0
        for record in range(rs):
            stream = d[record::rs]
            ctx = np.concatenate([[0], stream[:-1]])
            key = (np.int64(record) << 16) | (ctx << 8) | stream
            pair_counts = np.bincount(key, minlength=rs << 16)
            ctx_counts = np.bincount((np.int64(record) << 8) | ctx, minlength=rs << 8)
            total += int(tables.entropy(ctx_counts).sum())
            total -= int(tables.entropy(pair_counts).sum())
            total += int((65536 * 8 * np.minimum(ctx_counts, 256)).sum())
        ent[rs - 1] = total

    best = ent[0] - (ent[0] >> 4) - (65536 * 8 * 1024)
    result = 1
    for rs in range(1, DETECTORS_MAX_RECORD_SIZE + 1):
        if best > ent[rs - 1]:
            best = ent[rs - 1]
            result = rs
    return result
