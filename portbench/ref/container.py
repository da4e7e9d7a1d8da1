"""The ``bsc1`` container and the 28-byte block header, and Adler-32."""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"bsc1"
ENTRY = struct.Struct("<qbb")   # block offset, record size, contexts
HEADER = struct.Struct("<iiiiIII")
HEADER_SIZE = 28
_MOD = 65521


def adler32(data) -> int:
    """zlib's Adler-32 of a byte buffer, in numpy blocks of 1 MiB."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    a, b = 1, 0
    for lo in range(0, len(buf), 1 << 20):
        blk = buf[lo:lo + (1 << 20)].astype(np.int64)
        m = len(blk)
        # b gains a once per byte, plus each byte weighted by the bytes
        # from it to the block's end
        b = (b + m * a + int((blk * np.arange(m, 0, -1)).sum())) % _MOD
        a = (a + int(blk.sum())) % _MOD
    return (b << 16) | a


def parse_archive(archive: bytes):
    """[(offset, record size, contexts, block bytes)] in archive order.
    Raises ValueError when the container does not parse."""
    if archive[:4] != MAGIC or len(archive) < 8:
        raise ValueError("no bsc1 magic")
    (n_blocks,) = struct.unpack_from("<i", archive, 4)
    pos, out = 8, []
    while pos < len(archive):
        if pos + ENTRY.size + HEADER_SIZE > len(archive):
            raise ValueError("truncated block entry")
        offset, rs, ctx = ENTRY.unpack_from(archive, pos)
        pos += ENTRY.size
        block_size = HEADER.unpack_from(archive, pos)[0]
        if block_size < HEADER_SIZE or pos + block_size > len(archive):
            raise ValueError("block size out of range")
        out.append((offset, rs, ctx, archive[pos:pos + block_size]))
        pos += block_size
    if len(out) != n_blocks:
        raise ValueError(f"{len(out)} blocks, the header says {n_blocks}")
    return out


def block_header(block_size, data_size, mode, index, adler_data,
                 adler_payload) -> bytes:
    head = struct.pack("<iiiiII", block_size, data_size, mode, index,
                       adler_data, adler_payload)
    return head + struct.pack("<I", adler32(head))
