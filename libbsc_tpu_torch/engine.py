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

``TBSC_ENGINE`` (read at import into ``_force``, the JAX package's name,
so tests monkeypatch it the same way) selects the engine:

- unset or ``native``: the native runtime; the device routes only with
  FEATURE_CUDA (:func:`device_route`), among them the default format's
  BWT and its inverse of a block of 1 MiB or more on a CUDA device
  (:func:`bwt_route`);
- ``ops``: every device route on the API's device, whatever FEATURE_CUDA
  says: the ST sorts there, and so do the default format's BWT and its
  inverse (K16, ``ops/unbwt_rulers.py``) of a block of 1 MiB or more; on
  ``device="cpu"`` these are the plain versions;
- ``tpu``: ``ops`` when the API's device is CUDA, else every stage on
  the host (the JAX package's ``tpu`` needs a device that is no CPU);
- ``numpy``: the native runtime is never loaded.  LZP, the QLFC coders
  and the inverse ST run in ``fallback/``; the BWT forward and inverse and
  the forward ST run through the torch ops on the API's device, at any
  size; ``BLOCKSORTER_BWT_WIDEAUX`` returns -10 (its host sorter is
  native only); the wide coder runs its Python reference.

No route retries on the host after a device failure: the error is raised.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import constants as C
from . import native
from .utils.trace import span

# Blocks below this size take the per-stage route (the JAX package's
# device minimum, kept so both packages route blocks the same way).
_DEVICE_MIN_BLOCK = 1 << 20

# Calls that took a device route with no kernel of its own to count them.
DEVICE_ROUTES = {"bwt_encode": 0, "bwt_encode_dc3": 0, "bwt_decode": 0}

_force = os.environ.get("TBSC_ENGINE", "").lower() or None
_device = None  # the API's device (init), where the numpy engine's ops run

# The native runtime's code for a sorter it alone implements.
_NATIVE_ONLY = -10

_mallopt_done = False


def _tune_allocator() -> None:
    """Keep large buffers on the reusable heap (glibc mallopt).

    The per-block working buffers are tens of MB; glibc's default mmap
    threshold maps and unmaps them every call (torch's CPU tensors and the
    ``bytes`` the API returns among them), and a fresh multi-MB first
    touch pays a page fault a page.  Routing big allocations through brk
    and disabling trim keeps them cached across calls: the allocator-hook
    counterpart of the reference's bsc_malloc customization point
    (platform.cpp:126-190).  Once per process; where libc cannot be
    loaded, nothing changes.
    """
    global _mallopt_done
    if _mallopt_done:
        return
    _mallopt_done = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-4, 0)           # M_MMAP_MAX = 0
        libc.mallopt(-1, 2**31 - 1)   # M_TRIM_THRESHOLD: never trim
    except (OSError, AttributeError):  # no glibc: nothing to tune
        pass


def init(device) -> None:
    """Record the API's device, tune the allocator (once a process) and
    load the native runtime unless the engine is ``numpy``."""
    global _device
    _tune_allocator()
    _device = torch.device(device)
    if _force != "numpy":
        native.load()


def device_route(features: int, device):
    """The device the device routes run on under the engine and
    ``features``, or None for host stages (see the module docstring)."""
    if _force == "numpy":
        return None
    if _force == "tpu":
        return device if device.type == "cuda" else None
    if _force == "ops":
        return device
    return device if features & C.FEATURE_CUDA else None


def _forced(device) -> bool:
    """True when TBSC_ENGINE sends every device route to ``device``."""
    return device is not None and _force in ("tpu", "ops")


def _numpy_device():
    if _device is None:
        raise RuntimeError("TBSC_ENGINE=numpy needs engine.init(device) "
                           "(api.init calls it)")
    return _device


def num_threads(features: int) -> int:
    return (os.cpu_count() or 1) if features & C.FEATURE_MULTITHREADING \
        else 1


def _as_c(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.uint8)


def _out(out, nbytes: int) -> np.ndarray:
    """``out`` when it holds ``nbytes``, else a fresh buffer: a caller's
    buffer is never overrun."""
    if out is None or len(out) < nbytes:
        return np.empty(nbytes, dtype=np.uint8)
    return out


def lzp_compress(data: np.ndarray, hash_size: int, min_len: int,
                 features: int, out: np.ndarray | None = None):
    """The LZP stream as ndarray, or None if not compressible.  ``out``
    (n + 1024 bytes or more; a pool slot) is written instead of a fresh
    buffer; the numpy engine ignores it."""
    if _force == "numpy":
        from .fallback import lzp

        return lzp.lzp_compress(_as_c(data), hash_size, min_len)
    lib = native.load()
    inp = _as_c(data)
    out = _out(out, len(inp) + 1024)
    rc = lib.tbsc_lzp_compress(native.u8p(inp), native.u8p(out), len(inp),
                               hash_size, min_len, num_threads(features))
    return None if rc < 0 else out[:rc]


def lzp_screen(block: np.ndarray, min_len: int, device):
    """The block copied to ``device``, and a flag for each of its LZP
    parts, 1 where a match may occur (``ops/lzp_screen``, K15 on CUDA):
    all 0 proves that :func:`lzp_compress` returns None for the block,
    whatever the hash size.  From the API's page-locked ``"compress_lz"``
    slot the copy runs asynchronously; reading the flags waits for it, so
    the slot may be written when this returns."""
    from .ops import lzp_screen as screen

    block_d = torch.from_numpy(_as_c(block)).to(device, non_blocking=True)
    return block_d, screen.screen(block_d, min_len).tolist()


def lzp_decompress(data: np.ndarray, hash_size: int, min_len: int,
                   features: int, capacity: int,
                   out: np.ndarray | None = None):
    """The decoded bytes as ndarray, or a negative error code.  ``out``
    (``capacity`` bytes or more) is written instead of a fresh buffer; the
    numpy engine ignores it."""
    if _force == "numpy":
        from .fallback import lzp

        return _checked(lambda: lzp.lzp_decompress(_as_c(data), hash_size,
                                                   min_len), capacity)
    lib = native.load()
    inp = _as_c(data)
    out = _out(out, int(capacity))
    rc = lib.tbsc_lzp_decompress(native.u8p(inp), native.u8p(out), len(inp),
                                 hash_size, min_len, num_threads(features))
    return rc if rc < 0 else out[:rc]


def _checked(decode, capacity: int | None = None):
    """A numpy-engine decoder's output, or DATA_CORRUPT where a payload
    field it trusted was out of range (or the output passes
    ``capacity``)."""
    try:
        out = decode()
    except (IndexError, ValueError, KeyError):
        return C.DATA_CORRUPT
    if capacity is not None and len(out) > capacity:
        return C.DATA_CORRUPT
    return out


def bwt_route(n: int, device) -> str:
    """Where the default format's BWT and its inverse of an ``n``-byte
    block run: ``numpy`` (``TBSC_ENGINE=numpy``: the torch ops on the
    API's device), ``device`` (``ops/`` on ``device``) or ``host`` (the
    native runtime).  A block under 1 MiB, or with no ``device``, stays on
    the host; ``TBSC_ENGINE=ops|tpu`` sends the rest to ``device``;
    otherwise a CUDA ``device`` takes them, and on a CPU device the native
    runtime, the faster sort and inverse there, keeps them.  ``device``
    is :func:`device_route`'s: None, outside ``ops``, for a call without
    FEATURE_CUDA (the -G farm's host worker)."""
    if _force == "numpy":
        return "numpy"
    if device is None or n < _DEVICE_MIN_BLOCK:
        return "host"
    return "device" if _forced(device) or device.type == "cuda" else "host"


def bwt_encode(data: np.ndarray, features: int, device=None, data_d=None):
    """BWT in place.  Returns (index, num_indexes, indexes).

    Where :func:`bwt_route` says ``device``, the block sorts there at its
    own length, with the format's aux rate: by ``ops/bwt.bwt_encode_dc3``
    when ``TBSC_BWT`` is ``dc3`` (read at each call, as in the JAX
    package), else by ``ops/bwt.bwt_encode``; ``DEVICE_ROUTES`` counts the
    call under the function's name.  The JAX package pads the block to a
    size bucket (unless ``TBSC_BWT_PAD=0``) because XLA compiles a program
    per shape; torch compiles nothing per shape, so the exact shape is the
    only form here and ``TBSC_BWT_PAD`` has nothing to switch.
    ``data_d``, where given, is the block already on ``device``
    (:func:`lzp_screen`'s copy), used in place of a copy of ``data``;
    spans ``bwt.upload`` (the copy, where there is one) and
    ``bwt.download`` (U and the aux indexes back, which waits for the
    sort) time the route's copies.  Under ``numpy`` every block sorts
    through ``ops/bwt.bwt_encode`` on the API's device, uncounted.  A
    device failure raises: there is no silent host fallback.  Every other
    block sorts on the native runtime."""
    n = len(data)
    where = bwt_route(n, device)
    if where == "numpy":
        from .fallback import bwt

        return bwt.bwt_encode(data, _numpy_device())
    if where == "device":
        from .ops import bwt as opsbwt

        route = ("bwt_encode_dc3"
                 if os.environ.get("TBSC_BWT", "").lower() == "dc3"
                 else "bwt_encode")
        if data_d is None:
            with span("bwt.upload", n):
                data_d = torch.from_numpy(_as_c(data)).to(device)
        U, primary, aux = getattr(opsbwt, route)(data_d)
        with span("bwt.download", n):
            aux = aux.cpu().numpy()
            torch.from_numpy(data).copy_(U)
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
               features: int, device=None) -> int:
    """Inverse BWT of the default format in place.  Returns 0 or a
    negative error code.

    Where :func:`bwt_route` says ``device``, the block inverts there by
    K16 (``ops/unbwt_rulers.unbwt``: its kernels on CUDA, their plain
    versions on the CPU), the primary and, where the block has the
    format's count of them, the aux indexes as its start rows; spans
    ``bwt.upload`` and ``bwt.download`` time the block's two copies (the
    kernels are waited for between them).  A start that can be no BWT's
    (a primary outside [1, n], an aux index outside [0, n), two starts on
    one row) returns DATA_CORRUPT before any launch, and so does a block
    K16 finds to be no BWT of them; the route counts in
    ``DEVICE_ROUTES``, and a device failure raises.
    Under ``numpy`` every block takes the list ranking
    (``fallback/bwt.bwt_decode``) on the API's device.  Other blocks take
    the native runtime."""
    n = len(data)
    where = bwt_route(n, device)
    if where == "numpy":
        from .fallback import bwt

        return bwt.bwt_decode(data, index, num_indexes, indexes,
                              _numpy_device())
    if where == "device":
        return _unbwt_device(data, index, num_indexes, indexes, device)
    lib = native.load()
    idx = (np.ascontiguousarray(indexes, dtype=np.int32)
           if indexes is not None else np.zeros(1, dtype=np.int32))
    return lib.tbsc_bwt_decode(native.u8p(data), len(data), index,
                               num_indexes, native.i32p(idx),
                               num_threads(features))


def _unbwt_device(data: np.ndarray, index: int, num_indexes: int, indexes,
                  device) -> int:
    """:func:`bwt_decode`'s device route: K16 on ``data`` in place."""
    from .ops import bwt as opsbwt
    from .ops import unbwt_rulers

    n = len(data)
    aux = None
    if indexes is not None and num_indexes == (n - 1) // opsbwt.aux_rate(n):
        aux = np.asarray(indexes[:num_indexes])
    try:
        unbwt_rulers.start_rows(n, index, aux)
    except ValueError:
        return C.DATA_CORRUPT
    with span("bwt.upload", n):
        data_d = torch.from_numpy(_as_c(data)).to(device)
    out, status = unbwt_rulers.unbwt(data_d, index, aux)
    DEVICE_ROUTES["bwt_decode"] += 1
    if int(status):  # waits for the kernels
        return C.DATA_CORRUPT
    with span("bwt.download", n):
        torch.from_numpy(data).copy_(out)
    return 0


def st_encode(data: np.ndarray, k: int, features: int, device=None) -> int:
    """Forward ST-k in place.  Returns the index or a negative error code.

    With ``device`` (the FEATURE_CUDA route) a block of 1 MiB or more is
    sorted there by ``ops/st.st_encode`` at its own length; others take
    the native runtime.  The JAX package pads the block to a size bucket
    and serialises the first call of each (bucket, k), because XLA
    compiles a program per shape; torch compiles nothing per shape, so
    there is neither here.  Under ``TBSC_ENGINE=numpy`` every block sorts
    there on the API's device.  A device failure raises: there is no
    silent host fallback."""
    n = len(data)
    if _force == "numpy":
        from .fallback import st

        return st.st_encode(data, k, _numpy_device())
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
    """Inverse ST-k in place on the native runtime, or in numpy under
    ``TBSC_ENGINE=numpy`` (a serial chase: no device route, as in the JAX
    package).  Returns 0 or an error code."""
    if _force == "numpy":
        from .fallback import st

        return _checked(lambda: st.st_decode(data, k, index))
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
    parallelism across blocks; one :func:`st_decode` each under
    ``TBSC_ENGINE=numpy``).  Returns 0 or a negative error code."""
    if _force == "numpy":
        for a, idx in zip(arrays, indexes):
            rc = st_decode(a, k, idx, 0)
            if rc < 0:
                return rc
        return 0
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


def coder_segments(n: int) -> int:
    """How many segments the QLFC coders cut an ``n``-byte block into,
    each coded on a thread of its own (native/coder.cc)."""
    if n < 256 * 1024:
        return 1
    if n < 4 * 1024 * 1024:
        return 2
    if n < 16 * 1024 * 1024:
        return 4
    return 8


def coder_compress(data: np.ndarray, coder: int, features: int,
                   out: np.ndarray | None = None):
    """QLFC static, adaptive or fast encode on the native runtime (in
    Python under ``TBSC_ENGINE=numpy``, which ignores ``out``).  The
    payload as ndarray, or None if not compressible; ``out`` (n + 4096
    bytes or more) is written instead of a fresh buffer."""
    if _force == "numpy":
        from .fallback import qlfc

        return qlfc.coder_compress(_as_c(data), coder)
    lib = native.load()
    inp = _as_c(data)
    out = _out(out, len(inp) + 4096)
    rc = lib.tbsc_coder_compress(native.u8p(inp), native.u8p(out), len(inp),
                                 coder, num_threads(features))
    return None if rc < 0 else out[:rc]


def coder_decompress(data: np.ndarray, coder: int, features: int,
                     capacity: int, out: np.ndarray | None = None):
    """QLFC decode on the native runtime (in Python under
    ``TBSC_ENGINE=numpy``, which ignores ``out``).  The decoded bytes as
    ndarray, or a negative error code; ``out`` (``capacity`` bytes or
    more) is written instead of a fresh buffer."""
    if _force == "numpy":
        from .fallback import qlfc

        return _checked(lambda: qlfc.coder_decompress(_as_c(data), coder),
                        capacity)
    lib = native.load()
    inp = _as_c(data)
    out = _out(out, int(capacity))
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
    r); the index is -10 under ``TBSC_ENGINE=numpy`` (the host sorter is
    native only, as in the JAX package)."""
    n = len(data)
    r = wideaux_rate(n)
    k = (n - 1) // r
    if _force == "numpy":
        return _NATIVE_ONLY, 0, None, r
    lib = native.load()
    indexes = np.zeros(max(k, 1), dtype=np.int32)
    rc = lib.tbsc_bwt_encode_rate(native.u8p(data), n, r,
                                  native.i32p(indexes))
    return rc, k, indexes[:k], r


def bwt_decode_wideaux(data: np.ndarray, index: int, num_indexes: int,
                       indexes, r: int, device) -> int:
    """Inverse wide-aux BWT in place: the device chase for blocks of
    1 MiB or more when ``device`` is given, the native wavefront
    otherwise (-10 under ``TBSC_ENGINE=numpy``, as in the JAX package)."""
    n = len(data)
    if device is not None and n >= _DEVICE_MIN_BLOCK:
        from .ops import bwt as opsbwt

        out = opsbwt.unbwt_wideaux(
            torch.from_numpy(data).to(device), index,
            torch.from_numpy(np.ascontiguousarray(indexes, dtype=np.int32))
            .to(device), r, n)
        data[:] = out.cpu().numpy()
        return 0
    if _force == "numpy":
        return _NATIVE_ONLY
    lib = native.load()
    idx = np.ascontiguousarray(np.asarray(indexes, dtype=np.int32))
    return lib.tbsc_bwt_decode_rate(native.u8p(data), n, index, r,
                                    num_indexes, native.i32p(idx))


def _copied(device):
    """An event recorded after the copies queued so far on ``device``'s
    stream (None off CUDA), to wait on before their host buffer is
    reused."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def compress_block_device(lz, device):
    """Fused device encode of BLOCKSORTER_BWT_WIDEAUX + CODER_QLFC_WIDE.
    Returns (index, num_indexes, indexes, r, payload), or None when the
    block takes the per-stage route (under 1 MiB, a schedule the device
    walker does not take, or a payload that is not smaller).

    ``lz`` is the block as ndarray, or as a u8 tensor already on
    ``device`` (:func:`lzp_screen`'s copy), which is used as it is.  An
    ndarray is copied to the card with ``non_blocking=True``: from the
    API's page-locked ``"compress_lz"`` slot the copy runs asynchronously,
    so an event recorded after it is waited on before returning, and the
    next call on this thread cannot overwrite the slot while the copy
    still reads it."""
    n = len(lz)
    if n < _DEVICE_MIN_BLOCK:
        return None
    from .ops import bwt as opsbwt
    from .ops import wide_kernels

    r = wideaux_rate(n)
    if isinstance(lz, torch.Tensor):
        lz_d, copied = lz, None
    else:
        lz_d = torch.from_numpy(_as_c(lz)).to(device, non_blocking=True)
        copied = _copied(device)
    U, primary, aux = opsbwt.bwt_encode_wideaux_device(lz_d, r)
    payload = wide_kernels.device_encode_resident(U)
    if copied is not None:
        copied.synchronize()
    if payload is None:
        return None
    aux_np = aux.cpu().numpy().astype(np.int32)
    return int(primary), int(aux_np.shape[0]), aux_np, r, payload


def decompress_block_device(payload: bytes, index: int, indexes, r: int,
                            n: int, device, out: np.ndarray | None = None):
    """Fused device decode: K3's or K4's block stays on the device and
    feeds the wide-aux chase.  Returns the (pre-LZP) bytes as ndarray, or
    None when the block takes the per-stage route.  With ``out`` (``n``
    bytes or more: the API's ``"decompress_lz"`` slot, page-locked on
    CUDA) the block is copied there with ``non_blocking=True`` and the
    copy waited for, and a view of ``out`` is returned; without it, a
    fresh host tensor."""
    if n < _DEVICE_MIN_BLOCK:
        return None
    from .ops import bwt as opsbwt
    from .ops import wide_kernels

    U = wide_kernels.device_decode_resident(payload, device)
    if U is None:
        return None
    aux = torch.from_numpy(np.ascontiguousarray(indexes, dtype=np.int32))
    block = opsbwt.unbwt_wideaux(U, index, aux.to(device), r, n)
    if out is None or len(out) < n:
        return block.cpu().numpy()
    torch.from_numpy(out[:n]).copy_(block, non_blocking=True)
    copied = _copied(device)
    if copied is not None:
        copied.synchronize()
    return out[:n]
