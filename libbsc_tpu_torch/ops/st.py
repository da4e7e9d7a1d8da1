"""Sort Transform (ST3..ST8) forward on the device, in torch ops.

Counterpart of the JAX package's ``ops/st.py``.  Stably sort every
position i by the k bytes that follow it, T[i..i+k-1] (wrapping), ties
broken by position; output the preceding byte T[(i-1) mod n].  The
transform index is the rank of position 0.

torch has no multi-key sort, so the k context bytes are packed big-endian
into one int64 and its sign bit is flipped: the signed order of the key
is then the unsigned order of the context.  One stable sort orders the
positions; stability is the position tie-break, so no position payload is
sorted.  The index is the number of keys strictly below position 0's key
(position 0 sorts first among its equals).

The inverse transform is a serial chase and stays on the host runtime
(``engine.st_decode``), as in the JAX package and the reference.
"""

from __future__ import annotations

import torch

_SIGN = -(1 << 63)  # int64 with only the sign bit set


def _check_k(k: int) -> None:
    if not 3 <= k <= 8:
        raise ValueError(f"ST order must be in [3, 8], got {k}")


def _context_keys(data: torch.Tensor, k: int) -> torch.Tensor:
    """int64 keys of every position of u8[n] whose signed order is the
    unsigned order of its k wrapping context bytes."""
    d = data.long()
    key = torch.zeros_like(d)
    for j in range(k):
        key |= torch.roll(d, -j) << (56 - 8 * j)
    return key ^ _SIGN


def st_encode(data: torch.Tensor, k: int):
    """Forward ST-k of u8[n].  Returns (transformed u8[n], index int32
    0-dim), the index being what the native ``tbsc_st_decode`` needs."""
    _check_k(k)
    if data.shape[0] <= 1:
        return data, torch.tensor(0, dtype=torch.int32, device=data.device)
    key = _context_keys(data, k)
    order = torch.sort(key, stable=True).indices
    index = (key < key[0]).sum().to(torch.int32)
    return torch.roll(data, 1)[order], index
