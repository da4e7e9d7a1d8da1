"""The wide-aux BWT, from suffix ranks by plain prefix doubling in torch."""

from __future__ import annotations

import torch


def suffix_ranks(text: torch.Tensor, limit: int | None = None):
    """Rank of each suffix of u8[n] among all suffixes (int64 [n], a
    permutation), a suffix that is a prefix of another sorting first.
    ``limit`` stops the doubling once the compared prefixes reach that
    many bytes and breaks the remaining ties by position: not a suffix
    order, kept for the benchmark's control."""
    n = text.shape[0]
    rank = text.long()
    mul = max(n, 256) + 1
    k = 1
    while True:
        nxt = torch.full_like(rank, -1)
        if k < n:
            nxt[:n - k] = rank[k:]
        key = rank * mul + nxt + 1
        if limit is not None and 2 * k >= limit:
            key = key * n + torch.arange(n, device=text.device)
        order = torch.sort(key).indices
        skey = key[order]
        dense = torch.zeros(n, dtype=torch.int64, device=text.device)
        dense[1:] = torch.cumsum((skey[1:] != skey[:-1]).long(), 0)
        rank = torch.empty_like(dense)
        rank[order] = dense
        del key, skey, order, nxt
        if int(dense[-1]) == n - 1:
            return rank
        k *= 2


def wideaux_rate(n: int) -> int:
    """Aux sampling rate of the wide-aux sorter: the power of two, at
    least 256, giving 8,192 chains or more."""
    r = 256
    while r * 2 * 8192 <= n:
        r *= 2
    return r


def bwt_wideaux(text: torch.Tensor, r: int, limit: int | None = None):
    """(U u8[n], primary, aux int64[(n - 1) // r]) of u8[n], n >= 2: U
    lists T[SA[j] - 1] (T[n - 1] for suffix 0) with suffix 0's row moved
    to the front; primary is suffix 0's rank + 1; aux[t] is the rank of
    suffix (t + 1) r."""
    n = text.shape[0]
    rank = suffix_ranks(text, limit)
    sa = torch.empty_like(rank)
    sa[rank] = torch.arange(n, device=text.device)
    A = torch.roll(text, 1)[sa]
    del sa
    r0 = int(rank[0])
    U = torch.empty_like(A)
    U[0] = A[r0]
    U[1:r0 + 1] = A[:r0]
    U[r0 + 1:] = A[r0 + 1:]
    aux = rank[(torch.arange((n - 1) // r, device=text.device) + 1) * r]
    return U, r0 + 1, aux
