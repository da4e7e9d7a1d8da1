"""Corrupt blocks through the port's api.decompress: a decoder never
trusts a payload field.  Every corrupt block ends in BscError or decodes
to the exact input, on the host route and on the device route
(FEATURE_CUDA with device="cpu", which runs the kernels' plain versions);
any other exception fails the test.

The tests of ``tests/test_fuzz.py``, run on both routes: bit flips on the
default, ST5, wide-aux and wide-coder formats; truncation; the mode word;
random garbage.

Crafted blocks:

Each block is a valid -m9 -e4 archive (BLOCKSORTER_BWT_WIDEAUX +
CODER_QLFC_WIDE, no LZP, written by the host route) with one field
changed and the payload Adler-32 recomputed, so that only the field
checks can catch it.  Every case must raise BscError(DATA_CORRUPT) on the
host route and on the device route (FEATURE_CUDA with device="cpu", which
runs the kernels' plain versions), never IndexError, ValueError or a
crash:

- a wide-aux index out of [0, n) (0x7FFFFF00 and -7), on a block of about
  1 MB: the device chase gathers at every index, and the native inverse
  reads out of bounds;
- an aux count that does not fit n and the rate;
- a group unit count of 0xFFFFFF, lane sizes that do not sum to the
  block size, and a block size that is not the header's, on a 4 MiB
  1024-lane block (flag bit 0 set: the lane table travels).
"""

import struct

import numpy as np
import pytest

import libbsc_tpu_torch as P
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.format.header import (pack_block_header,
                                            parse_block_header)
from libbsc_tpu_torch.ops import wide_kernels as WK
from libbsc_tpu_torch.utils.adler32 import adler32
from tests.conftest import make_corpus

ARGS = dict(lzp_hash_size=0, lzp_min_len=0,
            block_sorter=C.BLOCKSORTER_BWT_WIDEAUX, coder=C.CODER_QLFC_WIDE)
HOST = C.FEATURE_FASTMODE
DEVICE = C.FEATURE_FASTMODE | C.FEATURE_CUDA


@pytest.fixture(scope="module")
def blocks():
    """name -> (input, archive): about 1 MB, and 4 MiB (1024 lanes)."""
    P.init(HOST, device="cpu")
    g = np.random.default_rng(0xF1F2)
    out = {}
    for name, n in (("small", (1 << 20) + 4321), ("lanes", (4 << 20) + 77)):
        data = make_corpus(g, n, "text")
        out[name] = (data, P.compress(data, **ARGS))
    return out


def _reframe(block: bytes, payload: bytes) -> bytes:
    """The block with a new payload and that payload's Adler-32."""
    h = parse_block_header(block)
    return pack_block_header(len(payload) + C.HEADER_SIZE, h.data_size,
                             h.mode, h.index, h.adler32_data,
                             adler32(payload)) + payload


def _aux(block: bytes, value=None, extra: bool = False) -> bytes:
    """Set the first wide-aux index to ``value``, or append one index."""
    p = bytearray(block[C.HEADER_SIZE:])
    assert p[-1] == 0xFF
    (k,) = struct.unpack_from("<I", p, len(p) - 5)
    assert k > 0
    if extra:
        p[-5:] = struct.pack("<iI", 0, k + 1) + b"\xff"
    else:
        struct.pack_into("<i", p, len(p) - 5 - 4 * k, value)
    return _reframe(block, bytes(p))


def _wide(block: bytes, edit) -> bytes:
    """Apply ``edit(payload, lane_table_offset, group_counts_offset)`` to
    the wide payload at the head of the block's payload."""
    p = bytearray(block[C.HEADER_SIZE:])
    _, lanes, flags, _ = struct.unpack_from("<IHHI", p, 0)
    assert lanes == WK.LANES and flags & 1
    edit(p, 12, 12 + 4 * lanes)
    return _reframe(block, bytes(p))


def _bump(p, off, delta):
    (v,) = struct.unpack_from("<I", p, off)
    struct.pack_into("<I", p, off, v + delta)


CASES = {
    "aux_high": ("small", lambda b: _aux(b, 0x7FFFFF00)),
    "aux_negative": ("small", lambda b: _aux(b, -7)),
    "aux_count": ("small", lambda b: _aux(b, extra=True)),
    "group_count": ("lanes", lambda b: _wide(
        b, lambda p, lt, gc: struct.pack_into("<I", p, gc, 0xFFFFFF))),
    "lane_sizes": ("lanes", lambda b: _wide(
        b, lambda p, lt, gc: _bump(p, lt + 4 * 5, 1))),
    "block_size": ("lanes", lambda b: _wide(
        b, lambda p, lt, gc: _bump(p, 0, 1))),
}


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_crafted_block_is_data_corrupt(blocks, case, route):
    name, craft = CASES[case]
    _, block = blocks[name]
    bad = craft(block)
    assert bad != block
    P.init(HOST if route == "host" else DEVICE, device="cpu")
    with pytest.raises(P.BscError) as e:
        P.decompress(bad)
    assert e.value.code == C.DATA_CORRUPT


@pytest.mark.parametrize("name", ["small", "lanes"])
def test_uncrafted_blocks_decode_on_the_host_route(blocks, name):
    data, block = blocks[name]
    P.init(HOST, device="cpu")
    assert P.decompress(block) == data


def test_dec_parse_checks_every_count(blocks):
    """_dec_parse itself: the device route's parse of the crafted wide
    payloads, and of a payload cut short at each field."""
    _, block = blocks["lanes"]
    payload = block[C.HEADER_SIZE:]
    (k,) = struct.unpack_from("<I", payload, len(payload) - 5)
    wide = payload[:-5 - 4 * k]
    isize = struct.unpack_from("<I", wide, 0)[0]
    assert WK._dec_parse(wide)["isize"] == isize
    for cut in (0, 11, 12 + 4 * WK.LANES - 1, 12 + 4 * WK.LANES + 31,
                len(wide) - 1):
        with pytest.raises(P.BscError) as e:
            WK._dec_parse(wide[:cut])
        assert e.value.code == C.DATA_CORRUPT
    for case in ("group_count", "lane_sizes"):
        bad = CASES[case][1](block)[C.HEADER_SIZE:-5 - 4 * k]
        with pytest.raises(P.BscError) as e:
            WK._dec_parse(bad)
        assert e.value.code == C.DATA_CORRUPT


# --- the tests of tests/test_fuzz.py, on both routes -------------------------

ROUTES = {"host": HOST, "device": DEVICE}


def _flips_are_caught(block: bytes, data: bytes, flips) -> None:
    """Each single-bit flip raises BscError or restores ``data``."""
    for f in np.unique(flips):
        corrupted = bytearray(block)
        corrupted[f // 8] ^= 1 << (f % 8)
        try:
            out = P.decompress(bytes(corrupted))
        except P.BscError:
            continue  # clean rejection
        assert out == data, f"silent corruption at bit {f}"


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bitflips_all_detected(route):
    g = np.random.default_rng(0xF0)
    data = make_corpus(g, 200000, "text")
    P.init(ROUTES[route], device="cpu")
    block = P.compress(data)
    _flips_are_caught(block, data, g.integers(0, len(block) * 8, size=200))


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kwargs", [
    {"block_sorter": C.BLOCKSORTER_ST5},
    {"block_sorter": C.BLOCKSORTER_BWT_WIDEAUX},
    {"coder": C.CODER_QLFC_WIDE},
], ids=["st5", "wideaux", "widecoder"])
def test_bitflips_detected_extension_formats(kwargs, route):
    g = np.random.default_rng(0xF1)
    data = make_corpus(g, 150000, "text")
    P.init(ROUTES[route], device="cpu")
    block = P.compress(data, **kwargs)
    _flips_are_caught(block, data, g.integers(0, len(block) * 8, size=80))
    # truncation, including cuts inside the wide-aux tail
    for cut in [27, 28, len(block) // 2, len(block) - 2, len(block) - 1]:
        with pytest.raises(P.BscError):
            P.decompress(bytes(block[:cut]))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_truncation_detected(route):
    data = make_corpus(np.random.default_rng(0xF2), 100000, "text")
    P.init(ROUTES[route], device="cpu")
    block = P.compress(data)
    for cut in [1, 7, 27, 28, 29, len(block) // 2, len(block) - 1]:
        with pytest.raises(P.BscError):
            P.decompress(bytes(block[:cut]))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mode_word_validation(route):
    data = make_corpus(np.random.default_rng(0xF3), 100000, "text")
    P.init(ROUTES[route], device="cpu")
    block = bytearray(P.compress(data))
    block[8:12] = (0xFFFFFFFF).to_bytes(4, "little")
    with pytest.raises(P.BscError):
        P.decompress(bytes(block))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_random_garbage_rejected(route):
    g = np.random.default_rng(0xF4)
    P.init(ROUTES[route], device="cpu")
    for n in [0, 1, 27, 28, 100, 5000]:
        garbage = bytes(g.integers(0, 256, n, dtype=np.uint8))
        with pytest.raises(P.BscError):
            P.decompress(garbage)
