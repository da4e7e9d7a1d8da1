"""Build and load the hand-written CUDA kernels in ``libbsc_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, one ``nvcc`` per source and all of them started together, into
``libbsc_tpu_torch/_build/lib<name>.so``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

The libraries are loaded with ctypes; a wrapper passes ``data_ptr()``
pointers and ``torch.cuda.current_stream().cuda_stream``.  Nothing here
runs at import time, and a failed build raises: there is no host fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..build import BUILD_DIR, build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: dict = {}  # stem -> CDLL
_fns: dict = {}   # launch name -> its C function


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}.so"


def _nvcc_all(todo: dict, srcs: dict) -> None:
    """One nvcc per stale target (built from ``srcs[target]``), all started
    together."""
    nvcc = _nvcc()
    procs = []
    for target, tmp in todo.items():
        src = srcs[target]
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))


def build_all() -> float:
    """Compile every stale kernel source in parallel.  Returns the seconds
    taken; raises RuntimeError with nvcc's output when a build fails."""
    t0 = time.perf_counter()
    srcs = {_target(s.stem): s for s in sources()}
    headers = sorted(CSRC.glob("*.cuh"))
    build({t: [s, *headers] for t, s in srcs.items()},
          lambda todo: _nvcc_all(todo, srcs))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers / shared memory) of the last build."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


_VP, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_DECODE_ARGS = [_VP] * 5 + [_I, _I] + [_VP] * 6
# launch name -> (csrc/<stem>.cu, C symbol, argtypes)
_SIGNATURES = {
    "wide_model": ("wide_model", "wide_model_launch",
                   [_VP, _I, _VP, _VP, _VP, _VP]),
    "wide_rans": ("wide_rans", "wide_rans_launch",
                  [_VP, _VP, _I, _I] + [_VP] * 6),
    "wide_decode": ("wide_decode", "wide_decode_launch", _DECODE_ARGS),
    "wide_decode_v2": ("wide_decode", "wide_decode_v2_launch", _DECODE_ARGS),
    "wide_rc_encode": ("wide_rc_encode", "wide_rc_encode_launch",
                       [_VP, _I, _I, _VP, _VP, _VP, _VP, _VP]),
    "byte_hist": ("byte_hist", "byte_hist_launch", [_VP, _L, _VP, _VP]),
    "adler_partials": ("adler_partials", "adler_partials_launch",
                       [_VP, _L, _VP, _VP]),
}


def launcher(name: str):
    """The C launch function ``name`` with its argtypes set, building the
    kernels first if needed.  It returns a cudaError_t."""
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            stem, sym, argtypes = _SIGNATURES[name]
            lib = _libs.get(stem)
            if lib is None:
                build_all()
                lib = _libs[stem] = ctypes.CDLL(str(_target(stem)))
            fn = getattr(lib, sym)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            _fns[name] = fn
        return fn


def check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
