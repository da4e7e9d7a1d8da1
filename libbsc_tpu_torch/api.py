"""Public compression API (bsc_init / init_full / compress /
compress_inplace / store / block_info / decompress / decompress_batch /
decompress_inplace) for every block sorter (BWT, BWT_WIDEAUX, ST3-ST8)
and coder (QLFC static, adaptive, fast, wide).

Routing follows the JAX package's api.py (encode :180-229, decode
:309-368 and :395-415), so both packages write the same archive for the
same input.  With ``FEATURE_CUDA`` (``-G``):
- ``BLOCKSORTER_BWT_WIDEAUX`` + ``CODER_QLFC_WIDE``, a block of 1 MiB or
  more that gets 1024 lanes, takes the fused device route (device wide-aux
  BWT, schedule and coder kernels); otherwise the wide coder runs K1/K2
  on the device for 1024-lane blocks and the native codec for others;
- ST3-ST8 blocks of 1 MiB or more sort on the device
  (``engine.st_encode``); smaller ones sort on the host;
- BWT blocks of 1 MiB or more sort on the device when
  ``TBSC_BWT_DEVICE=1`` opts in (``engine.bwt_encode``; the CLI's -G
  farm sets it for the default config), on the host otherwise.
The QLFC static, adaptive and fast coders, the host BWT and the inverse
ST run on the port's native runtime.

``TBSC_LZP_PROBE=1`` makes blocks of 4 MiB or more skip LZP when three
512 KiB sample windows gain nothing from it, as in the JAX package; the
mode word records whether LZP ran.

``init(features, device=None)`` chooses the device: ``None`` means
``cuda``, which must be present; ``device="cpu"`` runs every kernel's
plain PyTorch version instead.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from . import constants as C
from . import engine
from .format.header import (
    make_stored_block,
    pack_block_header,
    pack_mode,
    parse_block_header,
)
from .errors import BscError, corrupt
from .ops import wide
from .utils.adler32 import adler32

_ERROR_NAMES = {
    C.BAD_PARAMETER: "bad parameter",
    C.NOT_ENOUGH_MEMORY: "not enough memory",
    C.NOT_COMPRESSIBLE: "not compressible",
    C.NOT_SUPPORTED: "not supported",
    C.UNEXPECTED_EOB: "unexpected end of block",
    C.DATA_CORRUPT: "data corrupt",
}

_state: dict = {"features": None, "device": None}


def _raise(code: int):
    raise BscError(code, _ERROR_NAMES.get(code, str(code)))


def init(features: int = C.DEFAULT_FEATURES, device=None) -> int:
    """Initialize the library (bsc_init) on ``device`` (default ``cuda``).
    Raises when CUDA is absent and the caller did not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BscError(C.GPU_NOT_SUPPORTED,
                       "CUDA is not available; pass device='cpu' to run "
                       "the kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise BscError(C.BAD_PARAMETER, f"unsupported device {dev}")
    from . import native

    native.load()
    _state["features"] = features
    _state["device"] = dev
    return C.NO_ERROR


def init_full(features: int = C.DEFAULT_FEATURES, malloc=None,
              zero_malloc=None, free=None, device=None) -> int:
    """bsc_init_full: :func:`init` with the reference's allocator hooks,
    which are accepted and ignored (host buffers are numpy's, device
    buffers torch's caching allocator's)."""
    del malloc, zero_malloc, free
    return init(features, device)


def _ensure_init():
    if _state["device"] is None:
        init()


def _device_route(features: int):
    """The device for the FEATURE_CUDA route, or None for host stages."""
    return _state["device"] if features & C.FEATURE_CUDA else None


def store(data: bytes) -> bytes:
    """bsc_store: wrap data in a stored block."""
    return make_stored_block(data)


def block_info(block_header: bytes):
    """bsc_block_info: validate a 28-byte header.  Returns (block_size,
    data_size) or raises BscError."""
    h = parse_block_header(block_header)
    if isinstance(h, int):
        _raise(h)
    return h.block_size, h.data_size


def compress(data: bytes, lzp_hash_size: int = C.DEFAULT_LZPHASHSIZE,
             lzp_min_len: int = C.DEFAULT_LZPMINLEN,
             block_sorter: int = C.DEFAULT_BLOCKSORTER,
             coder: int = C.DEFAULT_CODER,
             features: int | None = None) -> bytes:
    """bsc_compress: one block (header + payload); a stored block when the
    data is incompressible."""
    _ensure_init()
    mode = pack_mode(block_sorter, coder, lzp_hash_size, lzp_min_len)
    if mode < 0:
        raise BscError(C.BAD_PARAMETER, "invalid mode configuration")
    n = len(data)
    if n > C.MAX_COMPRESS_SIZE:
        raise BscError(C.BAD_PARAMETER, "input too large")
    if n <= C.HEADER_SIZE:
        return store(data)
    features = _state["features"] if features is None else features
    device = _device_route(features)
    adler_data = adler32(data)
    buf = np.frombuffer(data, dtype=np.uint8)

    lz = None
    if mode != (mode & 0xFF) and not _lzp_probe_pays(
            buf, lzp_hash_size, lzp_min_len, features):
        mode &= 0xFF
    if mode != (mode & 0xFF):
        lz = engine.lzp_compress(buf, lzp_hash_size, lzp_min_len,
                                 features)
        if lz is None:
            mode &= 0xFF
    if lz is None:
        lz = buf.copy()
    if len(lz) <= C.HEADER_SIZE:
        block_sorter = C.BLOCKSORTER_BWT
        mode = (mode & ~0x1F) | C.BLOCKSORTER_BWT

    payload = None
    wideaux_r = None
    if (block_sorter == C.BLOCKSORTER_BWT_WIDEAUX
            and coder == C.CODER_QLFC_WIDE and device is not None
            and wide.pick_lanes_policy(len(lz)) == wide.DEFAULT_LANES):
        fused = engine.compress_block_device(lz, device)
        if fused is not None:
            index, num_indexes, indexes, wideaux_r, payload = fused

    if payload is None:  # per-stage route: the sorter, then the coder
        if block_sorter == C.BLOCKSORTER_BWT:
            index, num_indexes, indexes = engine.bwt_encode(lz, features,
                                                            device)
        elif block_sorter == C.BLOCKSORTER_BWT_WIDEAUX:
            index, num_indexes, indexes, wideaux_r = \
                engine.bwt_encode_wideaux(lz)
        elif C.BLOCKSORTER_ST3 <= block_sorter <= C.BLOCKSORTER_ST8:
            index = engine.st_encode(lz, block_sorter, features, device)
            num_indexes, indexes = 0, None
        else:
            _raise(C.BAD_PARAMETER)
        if index < 0:
            _raise(index)
        if n < 64 * 1024 and wideaux_r is None:
            num_indexes = 0
        if coder == C.CODER_QLFC_WIDE:
            lanes = wide.pick_lanes_policy(len(lz))
            if lanes == wide.DEFAULT_LANES and device is not None:
                from .ops import wide_kernels

                payload = wide_kernels.device_encode(lz.tobytes(), device)
            if payload is None:
                payload = wide.wide_encode(lz.tobytes(), n_lanes=lanes)
        else:
            payload = engine.coder_compress(lz, coder, features)

    tail_len = (5 if wideaux_r is not None else 1) + 4 * num_indexes
    if payload is None or len(payload) + tail_len >= n:
        return store(data)
    if wideaux_r is not None:
        # wide-aux tail: [i32 aux x K][u32 K][u8 255]
        tail = np.asarray(indexes[:num_indexes], dtype="<i4").tobytes()
        tail += struct.pack("<I", num_indexes) + b"\xff"
    else:
        tail = b""
        if num_indexes > 0:
            tail = np.asarray(indexes[:num_indexes], dtype="<i4").tobytes()
        tail += bytes([num_indexes])
    payload = bytes(payload) + tail
    header = pack_block_header(len(payload) + C.HEADER_SIZE, n, mode, index,
                               adler_data, adler32(payload))
    return header + payload


def _lzp_probe_pays(buf: np.ndarray, hash_size: int, min_len: int,
                    features: int) -> bool:
    """False when ``TBSC_LZP_PROBE=1``, the block is 4 MiB or more and LZP
    shortens none of three 512 KiB windows (start, middle, end); True
    otherwise.  Windows can miss long-range matches, so this is opt-in."""
    n = len(buf)
    if os.environ.get("TBSC_LZP_PROBE") != "1" or n < 4 * 1024 * 1024:
        return True
    win = 512 * 1024
    saved = 0
    for off in (0, (n - win) // 2, n - win):
        lz = engine.lzp_compress(buf[off:off + win], hash_size, min_len,
                                 features)
        if lz is not None:
            saved += win - len(lz)
    return saved > 0


def _check_wideaux(index: int, indexes, n: int, r: int) -> None:
    """The wide-aux tail against the length ``n`` the sorter inverts at
    rate ``r``: the primary in [1, n], (n - 1) // r indexes (what the
    native bwt_decode_rate checks), each in [0, n).  The chase gathers at
    every index, so none may reach it unchecked."""
    if n <= 1:
        return
    k = 0 if indexes is None else len(indexes)
    if not 0 < index <= n or k != (n - 1) // r:
        raise corrupt("wide-aux primary or index count")
    if k and (int(indexes.min()) < 0 or int(indexes.max()) >= n):
        raise corrupt("wide-aux index out of range")


def _check_wide_size(payload: bytes, h) -> int:
    """The wide payload's size field against the block header: the
    block's size when the mode word records no LZP, else at most that
    (LZP output is shorter than its input).  Returns the size."""
    if len(payload) < 12:
        raise corrupt("wide payload header")
    (isize,) = struct.unpack_from("<I", payload, 0)
    lzp = (h.mode >> 8) & 0xFFFF
    if isize > h.data_size or (not lzp and isize != h.data_size):
        raise corrupt("wide payload size")
    return isize


def _decode_to_sorter(block: bytes, expected_size: int | None):
    """Header and Adler checks, then the entropy decode; stops before the
    sorter.  Returns the stored bytes or the state for the sorter."""
    h = parse_block_header(block)
    if isinstance(h, int):
        _raise(h)
    if len(block) < h.block_size:
        _raise(C.UNEXPECTED_EOB)
    if expected_size is not None and expected_size < h.data_size:
        _raise(C.UNEXPECTED_EOB)
    payload = bytes(block[C.HEADER_SIZE: h.block_size])
    if h.adler32_payload != adler32(payload):
        _raise(C.DATA_CORRUPT)
    if h.mode == 0:
        return payload

    coder = (h.mode >> 5) & 0x7
    block_sorter = h.mode & 0x1F
    device = _device_route(_state["features"])

    if block_sorter == C.BLOCKSORTER_BWT_WIDEAUX:
        if len(payload) < 5 or payload[-1] != 0xFF:
            _raise(C.DATA_CORRUPT)
        (num_indexes,) = struct.unpack_from("<I", payload, len(payload) - 5)
        if len(payload) < 5 + 4 * num_indexes:
            _raise(C.DATA_CORRUPT)
        indexes = np.frombuffer(payload[-5 - 4 * num_indexes: -5],
                                dtype="<i4").astype(np.int32)
        payload = payload[: -5 - 4 * num_indexes]
    else:
        num_indexes = payload[-1]
        indexes = None
        if num_indexes > 0:
            indexes = np.frombuffer(payload[-1 - 4 * num_indexes: -1],
                                    dtype="<i4").astype(np.int32)

    lz = None
    sorted_done = False
    if coder == C.CODER_QLFC_WIDE:
        tsize = _check_wide_size(payload, h)
        if block_sorter == C.BLOCKSORTER_BWT_WIDEAUX and device is not None:
            r = engine.wideaux_rate(tsize)
            _check_wideaux(h.index, indexes, tsize, r)
            out = engine.decompress_block_device(
                payload, h.index, indexes, r, tsize, device)
            if out is not None:
                lz, sorted_done = out, True
        if lz is None and device is not None:
            from .ops import wide_kernels

            out = wide_kernels.device_decode(payload, device)
            if out is not None:
                lz = np.frombuffer(out, dtype=np.uint8).copy()
        if lz is None:
            lz = np.frombuffer(wide.wide_decode(payload),
                               dtype=np.uint8).copy()
    else:
        lz = engine.coder_decompress(np.frombuffer(payload, dtype=np.uint8),
                                     coder, _state["features"],
                                     capacity=h.data_size + 4096)
        if isinstance(lz, int):
            _raise(lz)
    if not (block_sorter in (C.BLOCKSORTER_BWT, C.BLOCKSORTER_BWT_WIDEAUX)
            or C.BLOCKSORTER_ST3 <= block_sorter <= C.BLOCKSORTER_ST8):
        _raise(C.DATA_CORRUPT)
    return {"h": h, "lz": lz, "sorter": block_sorter, "sorted": sorted_done,
            "num_indexes": num_indexes, "indexes": indexes,
            "lzp_hash_size": (h.mode >> 16) & 0xFF,
            "lzp_min_len": (h.mode >> 8) & 0xFF, "device": device}


def _run_sorter(st) -> None:
    if st["sorted"]:
        return
    h, lz = st["h"], st["lz"]
    if st["sorter"] == C.BLOCKSORTER_BWT:
        rc = engine.bwt_decode(lz, h.index, st["num_indexes"], st["indexes"],
                               _state["features"])
    elif st["sorter"] == C.BLOCKSORTER_BWT_WIDEAUX:
        r = engine.wideaux_rate(len(lz))
        _check_wideaux(h.index, st["indexes"], len(lz), r)
        rc = engine.bwt_decode_wideaux(
            lz, h.index, st["num_indexes"], st["indexes"], r, st["device"])
    else:
        rc = engine.st_decode(lz, st["sorter"], h.index, _state["features"])
    if rc < 0:
        _raise(rc)


def _finish_decode(st) -> bytes:
    h, lz = st["h"], st["lz"]
    if st["lzp_hash_size"] or st["lzp_min_len"]:
        out = engine.lzp_decompress(lz, st["lzp_hash_size"],
                                    st["lzp_min_len"], _state["features"],
                                    capacity=h.data_size + 4096)
        if isinstance(out, int):
            _raise(out)
    else:
        out = lz
    result = out.tobytes()
    if len(result) != h.data_size or h.adler32_data != adler32(result):
        _raise(C.DATA_CORRUPT)
    return result


def decompress(block: bytes, expected_size: int | None = None) -> bytes:
    """bsc_decompress: one block (header + payload)."""
    _ensure_init()
    st = _decode_to_sorter(block, expected_size)
    if isinstance(st, bytes):
        return st
    _run_sorter(st)
    return _finish_decode(st)


def decompress_batch(blocks: list) -> list:
    """Decompress several independent blocks, results in input order, as
    mapping :func:`decompress` would.  ST blocks of one order invert
    together in one native loop (``engine.st_decode_batch``); every other
    block runs its own sorter."""
    _ensure_init()
    states = [_decode_to_sorter(b, None) for b in blocks]
    st_groups: dict = {}
    for st in states:
        if isinstance(st, bytes):
            continue
        if C.BLOCKSORTER_ST3 <= st["sorter"] <= C.BLOCKSORTER_ST8:
            st_groups.setdefault(st["sorter"], []).append(st)
        else:
            _run_sorter(st)
    for k, group in st_groups.items():
        rc = engine.st_decode_batch([s["lz"] for s in group], k,
                                    [s["h"].index for s in group])
        if rc < 0:
            _raise(rc)
    return [st if isinstance(st, bytes) else _finish_decode(st)
            for st in states]


def compress_inplace(buf: bytearray, **kwargs) -> int:
    """bsc_compress_inplace: compress ``buf`` into its own prefix.  Returns
    the block's size; raises NOT_COMPRESSIBLE when the block would not
    fit in ``buf``."""
    blob = compress(bytes(buf), **kwargs)
    if len(blob) > len(buf):
        raise BscError(C.NOT_COMPRESSIBLE, "output larger than buffer")
    buf[: len(blob)] = blob
    return len(blob)


def decompress_inplace(buf: bytearray, block_size: int,
                       data_size: int) -> int:
    """bsc_decompress_inplace: decode the block at the head of ``buf``
    into ``buf``, growing it if needed.  Returns the decoded size."""
    data = decompress(bytes(buf[:block_size]), expected_size=data_size)
    if len(data) > len(buf):
        buf.extend(b"\0" * (len(data) - len(buf)))
    buf[: len(data)] = data
    return len(data)
