"""The Sort Transform of order k (ST3-ST8) forward, from its definition,
in plain torch on any device.

Position i of a block T of n bytes has the context T[(i + j) mod n],
j = 0 .. k-1: the k bytes that follow it, wrapping at the end.  The
positions are ordered by their contexts, compared byte by byte, and
positions with equal contexts by their position.  The output lists, in
that order, the byte before each position, T[(i - 1) mod n]; the index
is where position 0 lands in the order (upstream libbsc st/st.cpp:990,
st/st.cu:99-211; SURVEY.md 3.4).

Each context byte is gathered by its index; the contexts are ranked one
byte at a time, last byte first, into dense ranks; the position is an
explicit second key beside the rank, so that no two keys are equal and
the order owes nothing to a sort's stability.
"""

from __future__ import annotations

import torch


def dense_rank(key: torch.Tensor) -> torch.Tensor:
    """The rank of each of ``key``'s values among its distinct values
    (int64, 0 for the least)."""
    skey, order = torch.sort(key)
    rank_sorted = torch.zeros_like(skey)
    rank_sorted[1:] = torch.cumsum((skey[1:] != skey[:-1]).long(), 0)
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def context_ranks(text: torch.Tensor, k: int) -> torch.Tensor:
    """The rank of each position's k-byte context among all contexts of
    u8[n] ``text``: equal contexts rank equal, a smaller one lower."""
    n = text.shape[0]
    pos = torch.arange(n, device=text.device)
    rank = torch.zeros(n, dtype=torch.int64, device=text.device)
    for j in reversed(range(k)):
        byte = text[(pos + j) % n].long()
        # byte j decides first, the ranks of bytes j+1 .. k-1 break ties;
        # rank < n, so the pair fits one int64 key
        rank = dense_rank(byte * n + rank)
    return rank


def st_encode(text: torch.Tensor, k: int):
    """(output u8[n], index) of the forward ST-k of u8[n] ``text``."""
    if not 3 <= k <= 8:
        raise ValueError(f"ST order must be in [3, 8], got {k}")
    n = text.shape[0]
    pos = torch.arange(n, device=text.device)
    key = context_ranks(text, k) * n + pos  # unique: position second
    order = torch.sort(key).indices
    index = int(torch.nonzero(order == 0)[0, 0])
    return text[(order - 1) % n], index
