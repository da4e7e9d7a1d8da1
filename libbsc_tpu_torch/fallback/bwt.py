"""BWT of the no-native engine: the torch ops on the caller's device.

Engine contract (see engine.bwt_encode / bwt_decode): the numpy buffer is
transformed in place; index and aux indexes follow the libsais stream
convention (native/bwt.cc).
"""

from __future__ import annotations

import numpy as np
import torch


def bwt_encode(data: np.ndarray, device):
    """Forward BWT in place.  Returns (index, num_indexes, indexes)."""
    from ..ops.bwt import bwt_encode as _enc

    n = len(data)
    if n <= 1:
        return n, 0, None
    U, primary, aux = _enc(torch.from_numpy(np.ascontiguousarray(data))
                           .to(device))
    aux = aux.cpu().numpy().astype(np.int32)
    data[:] = U.cpu().numpy()
    return int(primary), int(aux.shape[0]), aux


def bwt_decode(data: np.ndarray, index: int, num_indexes: int, indexes,
               device) -> int:
    """Inverse BWT in place by list ranking.  Returns 0, or -1 for a
    primary outside [1, n]."""
    from ..ops.bwt import bwt_decode as _dec

    del num_indexes, indexes  # list ranking needs the primary only
    n = len(data)
    if n <= 1:
        return 0
    if index <= 0 or index > n:
        return -1
    out = _dec(torch.from_numpy(np.ascontiguousarray(data)).to(device), index)
    data[:] = out.cpu().numpy()
    return 0
