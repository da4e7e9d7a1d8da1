"""The format tables both codecs share: the 281 wide-coder priors that the
kernels and the native codec start every lane's model from, and the
stretch/squash and rank/run state tables of the native QLFC codec.

``current()`` holds the installed set; :func:`libbsc_tpu_torch.load_tables`
replaces it.  The defaults are this package's own ``coder/tables/*.npy``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

NAMES = ("wide_priors_v2", "stretch", "squash", "rank_state", "run_state")
NCTX = 281
TABLE_DIR = Path(__file__).resolve().parent / "coder" / "tables"

_current: dict | None = None


def defaults() -> dict:
    return {name: np.load(TABLE_DIR / f"{name}.npy") for name in NAMES}


def current() -> dict:
    global _current
    if _current is None:
        _current = defaults()
    return _current


def set_current(arrays: dict) -> dict:
    global _current
    missing = [name for name in NAMES if name not in arrays]
    if missing:
        raise ValueError(f"missing format tables: {missing}")
    priors = np.asarray(arrays["wide_priors_v2"])
    if priors.shape != (NCTX,) or priors.min() < 1 or priors.max() > 4095:
        raise ValueError("wide_priors_v2 must be 281 probabilities in "
                         "[1, 4095]")
    _current = {name: np.array(arrays[name]) for name in NAMES}
    return _current


def priors() -> np.ndarray:
    """The installed wide-coder priors as int32[281]."""
    return current()["wide_priors_v2"].astype(np.int32)
