"""Fixed-point entropy tables used by the detectors.

Derived (verified exactly equal to the reference tables,
filters/tables.h:38-744):

    code[n]  = floor(log2(n) * 65536)            for n in [2, 4096)
    entropy(n) = n * code-ish(n)  with range-dependent offsets
    delta[n] = entropy(n+1) - entropy(n)
"""

from __future__ import annotations

import numpy as np

_N = 4096

code_table = np.zeros(_N, dtype=np.int64)
_n = np.arange(2, _N, dtype=np.float64)
code_table[2:] = np.floor(np.log2(_n) * 65536.0).astype(np.int64)


def entropy_scalar(n: int) -> int:
    if n < 0x1000:
        return n * int(code_table[n])
    if n < 0x100000:
        return n * (8 * 65536 + int(code_table[n >> 8]))
    if n < 0x10000000:
        return n * (16 * 65536 + int(code_table[n >> 16]))
    return n * (20 * 65536 + int(code_table[n >> 20]))


def entropy(n: np.ndarray) -> np.ndarray:
    """Vectorized bsc_entropy over int64 counts."""
    n = np.asarray(n, dtype=np.int64)
    out = np.empty_like(n)
    m0 = n < 0x1000
    m1 = (~m0) & (n < 0x100000)
    m2 = (~m0) & (~m1) & (n < 0x10000000)
    m3 = ~(m0 | m1 | m2)
    out[m0] = n[m0] * code_table[n[m0]]
    out[m1] = n[m1] * (8 * 65536 + code_table[n[m1] >> 8])
    out[m2] = n[m2] * (16 * 65536 + code_table[n[m2] >> 16])
    out[m3] = n[m3] * (20 * 65536 + code_table[n[m3] >> 20])
    return out


delta_table = np.zeros(_N, dtype=np.int64)
for _i in range(_N - 1):
    delta_table[_i] = entropy_scalar(_i + 1) - entropy_scalar(_i)
delta_table[_N - 1] = entropy_scalar(_N) - entropy_scalar(_N - 1)


def delta(n: np.ndarray) -> np.ndarray:
    """Vectorized bsc_delta: entropy(n+1) - entropy(n)."""
    n = np.asarray(n, dtype=np.int64)
    out = np.empty_like(n)
    small = n < 0x1000
    out[small] = delta_table[n[small]]
    big = ~small
    if big.any():
        nb = n[big]
        res = np.empty_like(nb)
        exact = (nb & 0xFF) == 0xFF
        m1 = nb < 0x100000
        m2 = (~m1) & (nb < 0x10000000)
        m3 = ~(m1 | m2)
        res[m1] = code_table[nb[m1] >> 8] + 8 * 65536
        res[m2] = code_table[nb[m2] >> 16] + 16 * 65536
        res[m3] = code_table[nb[m3] >> 20] + 20 * 65536
        if exact.any():
            ne = nb[exact]
            res[exact] = entropy(ne + 1) - entropy(ne)
        out[big] = res
    return out
