"""Sub-block directory shared by the LZP and coder stages.

Both stages split a block into 1/2/4/8 sub-blocks by size and serialize:

    byte 0: nBlocks
    then, when nBlocks > 1, a directory of nBlocks records
        int32 rawSize, int32 packedSize   (little-endian)
    then the concatenated per-sub-block payloads; a sub-block whose
    packedSize == rawSize is stored raw (incompressible fallback).

(lzp.cpp:676-715, coder.cpp:111-155.)  When nBlocks == 1 there is no
directory: the payload follows the count byte directly.
"""

from __future__ import annotations

import struct


def num_sub_blocks(n: int) -> int:
    """Size-based sub-block count (lzp.cpp:44-51, coder.cpp:52-59)."""
    if n < 256 * 1024:
        return 1
    if n < 4 * 1024 * 1024:
        return 2
    if n < 16 * 1024 * 1024:
        return 4
    return 8


def write_directory(raw_sizes, packed_sizes) -> bytes:
    out = bytearray([len(raw_sizes)])
    if len(raw_sizes) > 1:
        for r, p in zip(raw_sizes, packed_sizes):
            out += struct.pack("<ii", r, p)
    return bytes(out)


def read_directory(buf: bytes):
    """Parse the directory; returns (n_blocks, [(raw, packed)...], payload_off)."""
    n_blocks = buf[0]
    if n_blocks == 1:
        return 1, None, 1
    entries = []
    for i in range(n_blocks):
        r, p = struct.unpack_from("<ii", buf, 1 + 8 * i)
        entries.append((r, p))
    return n_blocks, entries, 1 + 8 * n_blocks
