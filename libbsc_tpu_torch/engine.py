"""Stage functions: host LZP, BWT, ST and QLFC coders on the native
runtime, the device BWT and ST routes, and the fused device stages of the
main path.

The fused encode (:func:`compress_block_device`) copies the LZP'd block to
the device once and runs the wide-aux BWT, the lane balancer, the bit
schedule and kernels K1 and K2 (or K5, the v2 coder, when
``wide_kernels.RANS`` is False) there; only the payload comes back.  The
fused decode runs K3 (or K4 for a v2 payload) and the wide-aux inverse
BWT on the device; only the final bytes come back.  Neither catches
errors: a kernel that fails to build or launch raises.  They return None
only where the block's data sends it to the per-stage route, under the
JAX package's conditions.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import native

# Blocks below this size take the per-stage route (the JAX package's
# device minimum, kept so both packages route blocks the same way).
_DEVICE_MIN_BLOCK = 1 << 20

# Calls that took a device route with no kernel of its own to count them.
DEVICE_ROUTES = {"bwt_encode": 0, "bwt_encode_dc3": 0}


def num_threads(features: int) -> int:
    from . import constants as C

    return (os.cpu_count() or 1) if features & C.FEATURE_MULTITHREADING \
        else 1


def _as_c(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.uint8)


def lzp_compress(data: np.ndarray, hash_size: int, min_len: int,
                 features: int):
    """The LZP stream as ndarray, or None if not compressible."""
    lib = native.load()
    inp = _as_c(data)
    out = np.empty(len(inp) + 1024, dtype=np.uint8)
    rc = lib.tbsc_lzp_compress(native.u8p(inp), native.u8p(out), len(inp),
                               hash_size, min_len, num_threads(features))
    return None if rc < 0 else out[:rc]


def lzp_decompress(data: np.ndarray, hash_size: int, min_len: int,
                   features: int, capacity: int):
    """The decoded bytes as ndarray, or a negative error code."""
    lib = native.load()
    inp = _as_c(data)
    out = np.empty(int(capacity), dtype=np.uint8)
    rc = lib.tbsc_lzp_decompress(native.u8p(inp), native.u8p(out), len(inp),
                                 hash_size, min_len, num_threads(features))
    return rc if rc < 0 else out[:rc]


def bwt_encode(data: np.ndarray, features: int, device=None):
    """BWT in place.  Returns (index, num_indexes, indexes).

    With ``device`` (the FEATURE_CUDA route), ``TBSC_BWT_DEVICE=1`` (read
    at each call, the JAX package's opt-in; the CLI's -G farm sets it) and
    a block of 1 MiB or more, the block sorts there at its own length, with
    the format's aux rate: by ``ops/bwt.bwt_encode_dc3`` when ``TBSC_BWT``
    is ``dc3`` (read at each call, as in the JAX package), else by
    ``ops/bwt.bwt_encode``; ``DEVICE_ROUTES`` counts the call under the
    function's name.  The JAX package pads the block to a size bucket
    (unless ``TBSC_BWT_PAD=0``) because XLA compiles a program per shape;
    torch compiles nothing per shape, so the exact shape is the only form
    here and ``TBSC_BWT_PAD`` has nothing to switch.  A device failure
    raises: there is no silent host fallback.  Every other block sorts on
    the native runtime."""
    n = len(data)
    if (device is not None and n >= _DEVICE_MIN_BLOCK
            and os.environ.get("TBSC_BWT_DEVICE") == "1"):
        from .ops import bwt as opsbwt

        route = ("bwt_encode_dc3"
                 if os.environ.get("TBSC_BWT", "").lower() == "dc3"
                 else "bwt_encode")
        U, primary, aux = getattr(opsbwt, route)(
            torch.from_numpy(_as_c(data)).to(device))
        aux = aux.cpu().numpy()
        data[:] = U.cpu().numpy()
        DEVICE_ROUTES[route] += 1
        return int(primary), int(aux.shape[0]), aux
    lib = native.load()
    ni = np.zeros(1, dtype=np.uint8)
    idx = np.zeros(256, dtype=np.int32)
    rc = lib.tbsc_bwt_encode(native.u8p(data), len(data), native.u8p(ni),
                             native.i32p(idx), num_threads(features))
    if rc < 0:
        return rc, 0, None
    return rc, int(ni[0]), idx


def bwt_decode(data: np.ndarray, index: int, num_indexes: int, indexes,
               features: int) -> int:
    lib = native.load()
    idx = (np.ascontiguousarray(indexes, dtype=np.int32)
           if indexes is not None else np.zeros(1, dtype=np.int32))
    return lib.tbsc_bwt_decode(native.u8p(data), len(data), index,
                               num_indexes, native.i32p(idx),
                               num_threads(features))


def st_encode(data: np.ndarray, k: int, features: int, device=None) -> int:
    """Forward ST-k in place.  Returns the index or a negative error code.

    With ``device`` (the FEATURE_CUDA route) a block of 1 MiB or more is
    sorted there by ``ops/st.st_encode`` at its own length; others take
    the native runtime.  The JAX package pads the block to a size bucket
    and serialises the first call of each (bucket, k), because XLA
    compiles a program per shape; torch compiles nothing per shape, so
    there is neither here.  A device failure raises: there is no silent
    host fallback."""
    n = len(data)
    if device is not None and n >= _DEVICE_MIN_BLOCK:
        from .ops import st as opsst

        out, index = opsst.st_encode(
            torch.from_numpy(_as_c(data)).to(device), k)
        data[:] = out.cpu().numpy()
        return int(index)
    lib = native.load()
    buf = _as_c(data)
    rc = lib.tbsc_st_encode(native.u8p(buf), n, k, num_threads(features))
    if rc >= 0 and buf is not data:
        data[:] = buf
    return rc


def st_decode(data: np.ndarray, k: int, index: int, features: int) -> int:
    """Inverse ST-k in place on the native runtime (a serial chase: no
    device route, as in the JAX package).  Returns 0 or an error code."""
    lib = native.load()
    buf = _as_c(data)
    rc = lib.tbsc_st_decode(native.u8p(buf), len(data), k, index,
                            num_threads(features))
    if rc == 0 and buf is not data:
        data[:] = buf
    return rc


def st_decode_batch(arrays: list, k: int, indexes: list) -> int:
    """Inverse ST-k of several blocks in place, their backward walks
    interleaved in one native loop (a serial chase per block, memory-level
    parallelism across blocks).  Returns 0 or a negative error code."""
    lib = native.load()
    bufs = [_as_c(a) for a in arrays]
    ptrs = (ctypes.c_void_p * len(bufs))(*[b.ctypes.data for b in bufs])
    ns = np.array([len(b) for b in bufs], dtype=np.int32)
    idxs = np.array(indexes, dtype=np.int32)
    rc = lib.tbsc_st_decode_batch(ptrs, native.i32p(ns), k,
                                  native.i32p(idxs), len(bufs))
    if rc == 0:
        for a, b in zip(arrays, bufs):
            if b is not a:
                a[:] = b
    return rc


def coder_compress(data: np.ndarray, coder: int, features: int):
    """QLFC static, adaptive or fast encode on the native runtime.  The
    payload as ndarray, or None if not compressible."""
    lib = native.load()
    inp = _as_c(data)
    out = np.empty(len(inp) + 4096, dtype=np.uint8)
    rc = lib.tbsc_coder_compress(native.u8p(inp), native.u8p(out), len(inp),
                                 coder, num_threads(features))
    return None if rc < 0 else out[:rc]


def coder_decompress(data: np.ndarray, coder: int, features: int,
                     capacity: int):
    """QLFC decode on the native runtime.  The decoded bytes as ndarray,
    or a negative error code."""
    lib = native.load()
    inp = _as_c(data)
    out = np.empty(int(capacity), dtype=np.uint8)
    rc = lib.tbsc_coder_decompress(native.u8p(inp), native.u8p(out), coder,
                                   num_threads(features))
    return rc if rc < 0 else out[:rc]


def wideaux_rate(n: int) -> int:
    """Aux sampling rate of the wide-aux profile: the power of two giving
    ~4096+ inverse chains (min 256)."""
    r = 256
    while r * 2 * 8192 <= n:
        r *= 2
    return r


def bwt_encode_wideaux(data: np.ndarray):
    """Host wide-aux BWT in place.  Returns (index, num_indexes, indexes,
    r)."""
    n = len(data)
    r = wideaux_rate(n)
    k = (n - 1) // r
    lib = native.load()
    indexes = np.zeros(max(k, 1), dtype=np.int32)
    rc = lib.tbsc_bwt_encode_rate(native.u8p(data), n, r,
                                  native.i32p(indexes))
    return rc, k, indexes[:k], r


def bwt_decode_wideaux(data: np.ndarray, index: int, num_indexes: int,
                       indexes, r: int, device) -> int:
    """Inverse wide-aux BWT in place: the device chase for blocks of
    1 MiB or more when ``device`` is given, the native wavefront
    otherwise."""
    n = len(data)
    if device is not None and n >= _DEVICE_MIN_BLOCK:
        from .ops import bwt as opsbwt

        out = opsbwt.unbwt_wideaux(
            torch.from_numpy(data).to(device), index,
            torch.from_numpy(np.ascontiguousarray(indexes, dtype=np.int32))
            .to(device), r, n)
        data[:] = out.cpu().numpy()
        return 0
    lib = native.load()
    idx = np.ascontiguousarray(np.asarray(indexes, dtype=np.int32))
    return lib.tbsc_bwt_decode_rate(native.u8p(data), n, index, r,
                                    num_indexes, native.i32p(idx))


def compress_block_device(lz: np.ndarray, device):
    """Fused device encode of BLOCKSORTER_BWT_WIDEAUX + CODER_QLFC_WIDE.
    Returns (index, num_indexes, indexes, r, payload), or None when the
    block takes the per-stage route (under 1 MiB, a schedule the device
    walker does not take, or a payload that is not smaller)."""
    n = len(lz)
    if n < _DEVICE_MIN_BLOCK:
        return None
    from .ops import bwt as opsbwt
    from .ops import wide_kernels

    r = wideaux_rate(n)
    U, primary, aux = opsbwt.bwt_encode_wideaux_device(
        torch.from_numpy(_as_c(lz)).to(device), r)
    payload = wide_kernels.device_encode_resident(U)
    if payload is None:
        return None
    aux_np = aux.cpu().numpy().astype(np.int32)
    return int(primary), int(aux_np.shape[0]), aux_np, r, payload


def decompress_block_device(payload: bytes, index: int, indexes, r: int,
                            n: int, device):
    """Fused device decode: K3's or K4's block stays on the device and
    feeds the wide-aux chase.  Returns the (pre-LZP) bytes as ndarray, or None when
    the block takes the per-stage route."""
    if n < _DEVICE_MIN_BLOCK:
        return None
    from .ops import bwt as opsbwt
    from .ops import wide_kernels

    U = wide_kernels.device_decode_resident(payload, device)
    if U is None:
        return None
    aux = torch.from_numpy(np.ascontiguousarray(indexes, dtype=np.int32))
    out = opsbwt.unbwt_wideaux(U, index, aux.to(device), r, n)
    return out.cpu().numpy()
