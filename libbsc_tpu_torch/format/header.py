"""Block header and mode-word packing, bit-compatible with the reference.

Layout of the 28-byte block header (libbsc.cpp:327-333):

    offset 0   int32  blockSize        (compressed payload + header)
    offset 4   int32  dataSize         (raw size)
    offset 8   int32  mode             (0 for stored blocks)
    offset 12  int32  index            (BWT/ST primary index; 0 for stored)
    offset 16  uint32 adler32(data)
    offset 20  uint32 adler32(payload)
    offset 24  uint32 adler32(header[0:24])

Mode word (libbsc.cpp:225-258):

    mode = blockSorter | (coder << 5) | (lzpMinLen << 8) | (lzpHashSize << 16)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..constants import (
    HEADER_SIZE,
    NO_ERROR,
    BAD_PARAMETER,
    DATA_CORRUPT,
    UNEXPECTED_EOB,
    BLOCKSORTER_BWT,
    BLOCKSORTER_BWT_WIDEAUX,
    BLOCKSORTER_ST3,
    BLOCKSORTER_ST8,
    CODER_QLFC_STATIC,
    CODER_QLFC_ADAPTIVE,
    CODER_QLFC_FAST,
    CODER_QLFC_WIDE,
)
from ..utils.adler32 import adler32

_VALID_SORTERS = ({BLOCKSORTER_BWT, BLOCKSORTER_BWT_WIDEAUX}
                  | set(range(BLOCKSORTER_ST3, BLOCKSORTER_ST8 + 1)))
_VALID_CODERS = {CODER_QLFC_STATIC, CODER_QLFC_ADAPTIVE, CODER_QLFC_FAST,
                 CODER_QLFC_WIDE}


@dataclass(frozen=True)
class Mode:
    block_sorter: int
    coder: int
    lzp_hash_size: int = 0
    lzp_min_len: int = 0

    @property
    def lzp_enabled(self) -> bool:
        return self.lzp_hash_size != 0 or self.lzp_min_len != 0


def pack_mode(block_sorter: int, coder: int, lzp_hash_size: int, lzp_min_len: int) -> int:
    """Pack pipeline configuration into the int32 mode word.

    Returns BAD_PARAMETER (negative) on invalid configuration, mirroring
    bsc_compress's validation (libbsc.cpp:225-258).
    """
    if block_sorter not in _VALID_SORTERS:
        return BAD_PARAMETER
    if coder not in _VALID_CODERS:
        return BAD_PARAMETER
    mode = block_sorter | (coder << 5)
    if lzp_min_len != 0 or lzp_hash_size != 0:
        if not (4 <= lzp_min_len <= 255):
            return BAD_PARAMETER
        if not (10 <= lzp_hash_size <= 28):
            return BAD_PARAMETER
        mode |= (lzp_min_len << 8) | (lzp_hash_size << 16)
    return mode


def unpack_mode(mode: int) -> Mode:
    """Split a mode word into fields (libbsc.cpp:357-360)."""
    return Mode(
        block_sorter=mode & 0x1F,
        coder=(mode >> 5) & 0x7,
        lzp_min_len=(mode >> 8) & 0xFF,
        lzp_hash_size=(mode >> 16) & 0xFF,
    )


@dataclass(frozen=True)
class BlockHeader:
    block_size: int
    data_size: int
    mode: int
    index: int
    adler32_data: int
    adler32_payload: int
    adler32_header: int


def pack_block_header(
    block_size: int,
    data_size: int,
    mode: int,
    index: int,
    adler32_data: int,
    adler32_payload: int,
) -> bytes:
    head24 = struct.pack(
        "<iiii II",
        block_size,
        data_size,
        mode,
        index,
        adler32_data & 0xFFFFFFFF,
        adler32_payload & 0xFFFFFFFF,
    )
    return head24 + struct.pack("<I", adler32(head24))


def parse_block_header(block_header: bytes):
    """Validate and parse a 28-byte header (bsc_block_info, libbsc.cpp:340-418).

    Returns a BlockHeader, or a negative error code.
    """
    if len(block_header) < HEADER_SIZE:
        return UNEXPECTED_EOB
    head = bytes(block_header[:HEADER_SIZE])
    (block_size, data_size, mode, index, a_data, a_payload, a_header) = struct.unpack(
        "<iiiiIII", head
    )
    if a_header != adler32(head[:24]):
        return DATA_CORRUPT

    lzp_hash_size = (mode >> 16) & 0xFF
    lzp_min_len = (mode >> 8) & 0xFF
    coder = (mode >> 5) & 0x7
    block_sorter = mode & 0x1F

    # Mode round-trip validation (libbsc.cpp:362-402).
    test_mode = 0
    if block_sorter in _VALID_SORTERS:
        test_mode = block_sorter
    elif block_sorter > 0:
        return DATA_CORRUPT
    if coder in _VALID_CODERS:
        test_mode |= coder << 5
    elif coder > 0:
        return DATA_CORRUPT
    if lzp_min_len != 0 or lzp_hash_size != 0:
        if not (4 <= lzp_min_len <= 255):
            return DATA_CORRUPT
        if not (10 <= lzp_hash_size <= 28):
            return DATA_CORRUPT
        test_mode |= (lzp_min_len << 8) | (lzp_hash_size << 16)
    if test_mode != mode:
        return DATA_CORRUPT

    if block_size < HEADER_SIZE or block_size > HEADER_SIZE + data_size:
        return DATA_CORRUPT
    if index < 0 or index > data_size:
        return DATA_CORRUPT

    return BlockHeader(block_size, data_size, mode, index, a_data, a_payload, a_header)


def make_stored_block(data: bytes) -> bytes:
    """bsc_store: wrap raw bytes in a stored (mode=0) block (libbsc.cpp:68-81)."""
    a = adler32(data)
    return pack_block_header(len(data) + HEADER_SIZE, len(data), 0, 0, a, a) + bytes(data)
