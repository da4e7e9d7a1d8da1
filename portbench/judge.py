"""Whether what the window produced is correct: each number compared, with
its limit.

- ``calls_failed``: calls of either phase that raised.
- ``container_faults``: archives that do not parse as ``bsc1``, or whose
  blocks do not cover their file once, in order of offset, each at its
  size, with record size 1 and following contexts.
- ``blocks_wrong``: archive blocks that differ from the block the
  reference encodes from their input: every block of every archive of
  the encode phase, each distinct (file, offset, bytes) encoded once.
- ``restored_wrong``: restored files of the decode phase that differ
  from their input in any byte, among the calls whose output the run
  kept (a share of them drawn from the seed).

Each limit is 0: the format and the codec are exact.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .ref import container

LIMITS = {"calls_failed": 0, "container_faults": 0, "blocks_wrong": 0,
          "restored_wrong": 0}


def _blocks_of(archive: bytes, size: int, block_size: int):
    """{offset: block bytes}, or None when the container is at fault."""
    try:
        entries = container.parse_archive(archive)
    except ValueError:
        return None
    want = list(range(0, size, block_size)) or [0]
    got = {}
    for offset, rs, ctx, blk in entries:
        if rs != 1 or ctx != 1 or offset in got:
            return None
        n = container.HEADER.unpack_from(blk)[1]
        if n != min(block_size, size - offset):
            return None
        got[offset] = blk
    return got if sorted(got) == want else None


def judge(run, reference) -> dict:
    """The compared numbers of ``run`` (a harness.Run after its window),
    with ``reference([(data, the program's block)]) -> [the block the
    format requires, or None]``."""
    enc, dec = run.encode.calls, run.decode.calls
    out = dict.fromkeys(LIMITS, 0)
    out["calls_failed"] = sum(1 for c in enc + dec if c.error)
    # archives: parse each, and group the blocks by (file, offset)
    occurrences: dict = {}
    for c in enc:
        if c.error:
            continue
        size = len(run.pool[c.index])
        blocks = _blocks_of(c.out.read(), size, run.block_size)
        if blocks is None:
            out["container_faults"] += 1
            continue
        for offset, blk in blocks.items():
            occurrences.setdefault((c.index, offset), []).append(blk)
    items, counts = [], []
    for index, offset in sorted(occurrences):
        data = run.pool[index][offset:offset + run.block_size]
        variants: dict = {}
        for blk in occurrences[index, offset]:
            variants.setdefault(hashlib.sha256(blk).digest(), []).append(
                blk)
        for group in variants.values():
            items.append((data, group[0]))
            counts.append(len(group))
    judged = sum(counts)
    for (_, got), want, count in zip(items, reference(items), counts):
        if want != got:
            out["blocks_wrong"] += count
    out["blocks_judged"] = judged
    out["restored_judged"] = sum(1 for c in dec if c.out is not None)
    for c in dec:
        if c.error or c.out is None:
            continue
        want = run.pool[c.index]
        got = np.frombuffer(c.out.read(), dtype=np.uint8)
        if got.shape != want.shape or not np.array_equal(got, want):
            out["restored_wrong"] += 1
    return out


def correct(numbers: dict) -> bool:
    return numbers.get("blocks_judged", 0) > 0 \
        and numbers.get("restored_judged", 0) > 0 and all(
        numbers[k] <= v for k, v in LIMITS.items())
