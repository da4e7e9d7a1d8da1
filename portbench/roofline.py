"""The least bytes the wide coder's kernels move for a block, read from
the archive's own headers (the layouts of the ``bsc1`` container, the
block header and the wide payload, as the reference has them).

The counts are those the repository's kernel smoke test used for K1, K2
and K3: the bit planes (a byte holds four lanes' fields of one bit
index) and 12-bit probabilities stored as 4 bytes for every bit index of
every lane up to the longest lane, the 281 context priors, the units
written or read, and K3's per-lane state (16 bytes a lane), its state
table (16 bytes for each of 363 positions) and the block written.
Operations (at most one coded bit for every bit index of every lane)
over 67 TFLOP/s take under 2% of the bytes' time, so bytes bound all
three kernels.
"""

from __future__ import annotations

import struct

from .ref import container

NCTX = 281
SM_POSITIONS = 363  # K3's state-machine positions (its table's rows)
GROUP = 128
WIDE_MODE = 2 | 4 << 5  # -m9 -e4: BWT_WIDEAUX | QLFC_WIDE << 5


def wide_blocks(archive: bytes):
    """(n, lanes, max_bits, live lanes, units) of each -m9 -e4 block of
    an archive whose payload holds a wide header; other blocks are
    skipped."""
    try:
        blocks = container.parse_archive(archive)
    except ValueError:
        return
    for _, _, _, blk in blocks:
        mode = container.HEADER.unpack_from(blk)[2]
        body = blk[container.HEADER_SIZE:]
        if mode & 0xFF != WIDE_MODE or len(body) < 12:
            continue
        n, L, flags, max_bits = struct.unpack_from("<IHHI", body, 0)
        off = 12
        if flags & 1:
            sizes = struct.unpack_from(f"<{L}I", body, off)
            off += 4 * L
            live = sum(1 for s in sizes if s)
        else:
            live = min(L, n)
        groups = -(-L // GROUP)
        units = sum(struct.unpack_from(f"<{groups}I", body, off))
        yield n, L, max_bits, live, units


def encode_bytes(L: int, max_bits: int, live: int, units: int) -> int:
    """K1 + K2's bytes for one block (K2 writes the units less the two
    warm-up units of each live lane)."""
    planes = -(-max_bits // 4) * L
    probs = 4 * max_bits * L
    k1 = planes + probs + 4 * NCTX
    k2 = planes + probs + 4 * (units - 2 * live) + 4 * 8 + 4 * L
    return k1 + k2


def decode_bytes(n: int, L: int, units: int) -> int:
    """K3's bytes for one block."""
    return 2 * units + 16 * L + 4 * NCTX + 16 * SM_POSITIONS + n
