"""libbsc-tpu on PyTorch and CUDA: the port of ``libbsc_tpu`` to one
NVIDIA H100.

This package imports torch and numpy, never JAX, and nothing of
``libbsc_tpu``.  It writes the same archives, for every block sorter (BWT,
BWT_WIDEAUX, ST3-ST8) and coder (QLFC static, adaptive, fast, wide).  On
the card run the main path, ``BLOCKSORTER_BWT_WIDEAUX`` +
``CODER_QLFC_WIDE`` with ``FEATURE_CUDA`` (CLI ``-m9 -e4 -G``: the device
wide-aux BWT, lane balancer and bit schedule, and the wide-coder kernels
K1-K5 in ``csrc/``), the device ST of ``-G`` (``ops/st.py``), and the
sharded transform step (``parallel/``) with the statistics kernels K6 and
K7 (``ops/stats_kernels.py``).

Entry points run on the card unless the caller passes ``device="cpu"`` to
:func:`init`; then each kernel's plain PyTorch version runs instead.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    LIBBSC_VERSION_STRING,
    NO_ERROR,
    BAD_PARAMETER,
    NOT_SUPPORTED,
    DATA_CORRUPT,
    BLOCKSORTER_BWT_WIDEAUX,
    CODER_QLFC_WIDE,
    FEATURE_NONE,
    FEATURE_FASTMODE,
    FEATURE_MULTITHREADING,
    FEATURE_CUDA,
    DEFAULT_LZPHASHSIZE,
    DEFAULT_LZPMINLEN,
    DEFAULT_FEATURES,
    HEADER_SIZE,
)
from .api import init, compress, store, block_info, decompress, BscError
from . import tables as _tables

__version__ = LIBBSC_VERSION_STRING


def load_tables(arrays: dict[str, np.ndarray] | None = None) -> None:
    """Install the format tables (``wide_priors_v2``, ``stretch``,
    ``squash``, ``rank_state``, ``run_state``) into the port: the kernels'
    priors and the native codec's copy.  ``None`` reloads this package's
    own ``coder/tables/*.npy``."""
    from . import native

    native.install_tables(
        _tables.set_current(_tables.defaults() if arrays is None else arrays))


__all__ = [
    "init",
    "compress",
    "store",
    "block_info",
    "decompress",
    "load_tables",
    "BscError",
    "__version__",
]
