"""Host Adler-32 (zlib-compatible), through the native runtime when built.

The reference (adler32/adler32.cpp:85) computes the standard zlib Adler-32;
:func:`zlib.adler32` gives the same value where the native runtime is
missing.  The route for a block already on the card is
``ops/stats_kernels.adler32_device`` (K7).
"""

from __future__ import annotations

import ctypes
import zlib

import numpy as np

_U8P = ctypes.POINTER(ctypes.c_uint8)
_native_fn = None  # None = untried, False = unavailable


def _native():
    global _native_fn
    if _native_fn is None:
        from .. import native as native_mod

        _native_fn = native_mod.load().tbsc_adler32 \
            if native_mod.available() else False
    return _native_fn


def adler32(data, value: int = 1) -> int:
    """Host Adler-32 of ``bytes``/buffer, zlib-compatible."""
    fn = _native()
    if fn:
        if isinstance(data, bytes):
            ptr = ctypes.cast(ctypes.c_char_p(data), _U8P)
            return fn(ptr, len(data), value & 0xFFFFFFFF)
        if isinstance(data, np.ndarray) and data.dtype == np.uint8 \
                and data.flags["C_CONTIGUOUS"]:
            return fn(data.ctypes.data_as(_U8P), data.nbytes,
                      value & 0xFFFFFFFF)
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    return zlib.adler32(data, value) & 0xFFFFFFFF
