"""ctypes loader for the native host runtime (``libtbsc.so``).

The C++ sources in this directory are the same as the JAX package's, so the
host stages (LZP, the wide-aux BWT, the wide codec, its lane balancer and
schedule walker, the ST and QLFC coders) give the same bytes by
construction.  The library is built
on first use with ``make`` into ``libbsc_tpu_torch/_build/`` and the format
tables are installed into it (see :func:`libbsc_tpu_torch.load_tables`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..build import BUILD_DIR, build

_DIR = Path(__file__).resolve().parent
_LIB_PATH = BUILD_DIR / "libtbsc.so"
_lock = threading.Lock()
_lib = None

# Table arrays the library points into; kept alive for the process lifetime.
_tables_keepalive: list = []


def _sources():
    return sorted(_DIR.glob("*.cc")) + sorted(_DIR.glob("*.h")) \
        + [_DIR / "Makefile"]


# The Makefile's CXXFLAGS less -fopenmp.  Every OpenMP use in the sources
# sits under #ifdef _OPENMP and splits work the same way at any thread
# count, so such a build writes the same bytes, on one thread.
_SERIAL_CXXFLAGS = ("-O3 -fPIC -std=c++17 -Wall -Wextra -fomit-frame-pointer "
                    "-fstrict-aliasing -march=native -DNDEBUG")


def _make_vars() -> list[str]:
    """make variables for this host: the first C++ compiler ($CXX, then
    g++) that builds with -fopenmp, else the serial flags (a toolchain
    without libgomp)."""
    probe = BUILD_DIR / "openmp_probe.cc"
    probe.write_text("int main() { return 0; }\n")
    for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"), "g++") if c):
        try:
            ok = subprocess.run(
                [cxx, "-fopenmp", str(probe), "-o",
                 str(BUILD_DIR / "openmp_probe")],
                capture_output=True).returncode == 0
        except OSError:
            ok = False
        if ok:
            return [f"CXX={cxx}"]
    return [f"CXXFLAGS={_SERIAL_CXXFLAGS}"]


def _make(todo: dict) -> None:
    proc = subprocess.run(["make", "-s", "-B", "-C", str(_DIR),
                           f"TARGET={todo[_LIB_PATH]}", *_make_vars()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise OSError(f"building the native runtime failed:\n"
                      f"{proc.stdout}{proc.stderr}")


def _sig(fn, restype, argtypes):
    fn.restype = restype
    fn.argtypes = argtypes


def load():
    """Load (building if necessary) the native library and install the
    format tables.  Raises OSError when it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build({_LIB_PATH: _sources()}, _make)
        lib = ctypes.CDLL(str(_LIB_PATH))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        i32p = ctypes.POINTER(ctypes.c_int32)
        c_int, i64 = ctypes.c_int, ctypes.c_int64
        _sig(lib.tbsc_set_tables, c_int, [i16p, i16p, u8p, u8p])
        _sig(lib.tbsc_wide_set_priors, c_int, [i16p])
        _sig(lib.tbsc_lzp_compress, c_int,
             [u8p, u8p, c_int, c_int, c_int, c_int])
        _sig(lib.tbsc_lzp_decompress, c_int,
             [u8p, u8p, c_int, c_int, c_int, c_int])
        _sig(lib.tbsc_bwt_encode, c_int, [u8p, c_int, u8p, i32p, c_int])
        _sig(lib.tbsc_bwt_decode, c_int,
             [u8p, c_int, c_int, c_int, i32p, c_int])
        _sig(lib.tbsc_bwt_encode_rate, c_int, [u8p, c_int, c_int, i32p])
        _sig(lib.tbsc_bwt_decode_rate, c_int,
             [u8p, c_int, c_int, c_int, c_int, i32p])
        _sig(lib.tbsc_wide_encode, c_int,
             [u8p, i64, u8p, i64, c_int, i32p, c_int])
        _sig(lib.tbsc_wide_balanced_sizes, c_int, [u8p, i64, c_int, i32p])
        _sig(lib.tbsc_wide_decode, c_int, [u8p, i64, u8p, i64])
        _sig(lib.tbsc_wide_schedule_packed, c_int,
             [u8p, i64, c_int, c_int, u8p, i32p])
        _sig(lib.tbsc_adler32, ctypes.c_uint32, [u8p, i64, ctypes.c_uint32])
        _sig(lib.tbsc_coder_compress, c_int, [u8p, u8p, c_int, c_int, c_int])
        _sig(lib.tbsc_coder_decompress, c_int, [u8p, u8p, c_int, c_int])
        _sig(lib.tbsc_st_encode, c_int, [u8p, c_int, c_int, c_int])
        _sig(lib.tbsc_st_decode, c_int, [u8p, c_int, c_int, c_int, c_int])
        _sig(lib.tbsc_st_decode_batch, c_int,
             [ctypes.POINTER(ctypes.c_void_p), i32p, c_int, i32p, c_int])
        from .. import tables

        _install(lib, tables.current())
        _lib = lib
        return _lib


def install_tables(arrays: dict) -> None:
    """Hand the format tables to the native codec (tbsc_set_tables,
    tbsc_wide_set_priors).  The library keeps pointers into the arrays."""
    lib = load()
    with _lock:
        _install(lib, arrays)


def _install(lib, arrays: dict) -> None:
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    stretch = np.ascontiguousarray(arrays["stretch"], dtype=np.int16)
    squash = np.ascontiguousarray(arrays["squash"], dtype=np.int16)
    rank_state = np.ascontiguousarray(arrays["rank_state"], dtype=np.uint8)
    run_state = np.ascontiguousarray(arrays["run_state"], dtype=np.uint8)
    priors = np.ascontiguousarray(arrays["wide_priors_v2"], dtype=np.int16)
    _tables_keepalive[:] = [stretch, squash, rank_state, run_state, priors]
    lib.tbsc_wide_set_priors(priors.ctypes.data_as(i16p))
    rc = lib.tbsc_set_tables(stretch.ctypes.data_as(i16p),
                             squash.ctypes.data_as(i16p),
                             rank_state.ctypes.data_as(u8p),
                             run_state.ctypes.data_as(u8p))
    if rc != 0:
        raise OSError(f"tbsc_set_tables failed: {rc}")


def available() -> bool:
    """True when the native library builds and loads here."""
    try:
        load()
    except OSError:
        return False
    return True


def u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
