"""libbsc-tpu on PyTorch and CUDA: the port of ``libbsc_tpu`` to one
NVIDIA H100.

This package imports torch and numpy, never JAX, and nothing of
``libbsc_tpu``.  It writes the same archives, for every block sorter (BWT,
BWT_WIDEAUX, ST3-ST8) and coder (QLFC static, adaptive, fast, wide).  On
the card run the main path, ``BLOCKSORTER_BWT_WIDEAUX`` +
``CODER_QLFC_WIDE`` with ``FEATURE_CUDA`` (CLI ``-m9 -e4 -G``: the device
wide-aux BWT, lane balancer and bit schedule, and the wide-coder kernels
K1-K5 in ``csrc/``), the device ST and BWT of ``-G`` (``ops/st.py``,
``ops/bwt.py``), and the sharded transform step (``parallel/``) with the
statistics kernels K6 and K7 (``ops/stats_kernels.py``).  The CLI is
``python -m
libbsc_tpu_torch.cli e|d input output [switches]`` (``cli.py``, with the
host filters in ``filters/``).

Entry points run on the card unless the caller passes ``device="cpu"`` to
:func:`init`; then each kernel's plain PyTorch version runs instead.
``TBSC_ENGINE=ops|tpu|numpy`` selects the JAX package's other engines
(``engine``).

Tracing (``utils/trace``): under any torch profiler the port records
spans on every thread that runs a block (the CLI call, the farm and the
decode pool, the API calls and their stages), and
``utils.trace.spans()`` returns them; ``TBSC_PROFILE=<dir>`` writes a
Chrome trace of every thread there (the CLI at exit);
``TBSC_TRACE=1`` prints one line a stage.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    LIBBSC_VERSION_STRING,
    NO_ERROR,
    BAD_PARAMETER,
    NOT_ENOUGH_MEMORY,
    NOT_COMPRESSIBLE,
    NOT_SUPPORTED,
    UNEXPECTED_EOB,
    DATA_CORRUPT,
    GPU_ERROR,
    GPU_NOT_SUPPORTED,
    GPU_NOT_ENOUGH_MEMORY,
    BLOCKSORTER_NONE,
    BLOCKSORTER_BWT,
    BLOCKSORTER_BWT_WIDEAUX,
    BLOCKSORTER_ST3,
    BLOCKSORTER_ST4,
    BLOCKSORTER_ST5,
    BLOCKSORTER_ST6,
    BLOCKSORTER_ST7,
    BLOCKSORTER_ST8,
    CODER_NONE,
    CODER_QLFC_STATIC,
    CODER_QLFC_ADAPTIVE,
    CODER_QLFC_FAST,
    CODER_QLFC_WIDE,
    FEATURE_NONE,
    FEATURE_FASTMODE,
    FEATURE_MULTITHREADING,
    FEATURE_LARGEPAGES,
    FEATURE_CUDA,
    DEFAULT_LZPHASHSIZE,
    DEFAULT_LZPMINLEN,
    DEFAULT_BLOCKSORTER,
    DEFAULT_CODER,
    DEFAULT_FEATURES,
    HEADER_SIZE,
)
from .api import (
    init,
    init_full,
    compress,
    compress_inplace,
    store,
    block_info,
    decompress,
    decompress_batch,
    decompress_inplace,
    BscError,
)
from . import tables as _tables

__version__ = LIBBSC_VERSION_STRING


def load_tables(arrays: dict[str, np.ndarray] | None = None) -> None:
    """Install the format tables (``wide_priors_v2``, ``stretch``,
    ``squash``, ``rank_state``, ``run_state``) into the port: the kernels'
    priors and the native codec's copy.  ``None`` reloads this package's
    own ``coder/tables/*.npy``.  Under ``TBSC_ENGINE=numpy`` the native
    runtime is not loaded, and only the kernels' and the reference
    codec's priors change."""
    from . import engine, native

    current = _tables.set_current(_tables.defaults() if arrays is None
                                  else arrays)
    if engine._force != "numpy":
        native.install_tables(current)


__all__ = [
    "init",
    "init_full",
    "compress",
    "compress_inplace",
    "store",
    "block_info",
    "decompress",
    "decompress_batch",
    "decompress_inplace",
    "load_tables",
    "BscError",
    "__version__",
]
