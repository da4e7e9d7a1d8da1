"""Reversibility filters: block reversal and record (AoS->SoA) reordering.

Pure array transforms (filters/preprocessing.cpp:41-176); the tail beyond
the last full record stays in place.
"""

from __future__ import annotations

import numpy as np


def reverse_block(arr: np.ndarray) -> None:
    arr[:] = arr[::-1]


def reorder_forward(arr: np.ndarray, record_size: int) -> None:
    """De-interleave records: T[j*chunk + i] = S[i*recordSize + j]."""
    if record_size <= 1:
        return
    n = len(arr)
    chunk = n // record_size
    body = arr[: chunk * record_size].reshape(chunk, record_size)
    arr[: chunk * record_size] = body.T.reshape(-1)


def reorder_reverse(arr: np.ndarray, record_size: int) -> None:
    """Re-interleave records (inverse of reorder_forward)."""
    if record_size <= 1:
        return
    n = len(arr)
    chunk = n // record_size
    body = arr[: chunk * record_size].reshape(record_size, chunk)
    arr[: chunk * record_size] = body.T.reshape(-1)
