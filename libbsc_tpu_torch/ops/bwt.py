"""Burrows-Wheeler transform on the device, in torch ops: the exact-shape
forward transform at the format's aux rate and the wide-aux profile.

Forward: suffix ranks by prefix quadrupling.  A depth-15 bootstrap sorts
the first 15 bytes (plus the remaining length, so a suffix that is a
prefix of another sorts first); each round then sorts by the 4-tuple
(r(i), r(i+k), r(i+2k), r(i+3k)) and extends the resolved depth 4x.
Ranks use the group-start convention (a group's rank is the sorted
position of its first member), so a round can re-rank one unresolved
group in place as ``group start + offset``; once the unresolved count is
under n/4, rounds run over the unresolved positions only.  torch has no
multi-key sort: two stable sorts of packed int64 keys (low pair first)
give the lexicographic order.

Stream convention (the reference's bwt/bwt.cpp:178-230, the native
runtime's tbsc_bwt_encode_rate):
  U[0] = T[n-1]; U[1..] = T[SA[j]-1] for ranks j skipping suffix 0;
  primary index = rank(suffix 0) + 1;
  aux indexes at rate r: indexes[t] = rank(suffix (t+1) r).

Inverse: the wide-aux tail gives (n-1)//r + 1 independent forward chains
(the primary and each aux index); they are chased together, one gather of
the packed (first char, PSI) table per step, for r steps.
"""

from __future__ import annotations

import torch

_BOOT_DEPTH = 15
_TWO32 = 1 << 32


def aux_rate(n: int) -> int:
    """Aux-index sampling rate, bit-smear formula of bwt.cpp:192-197."""
    mod = n // 8
    mod |= mod >> 1
    mod |= mod >> 2
    mod |= mod >> 4
    mod |= mod >> 8
    mod |= mod >> 16
    mod >>= 1
    return mod + 1


def _shifted(x: torch.Tensor, off: int, fill: int) -> torch.Tensor:
    """x[i + off] where i + off < n, else ``fill``."""
    n = x.shape[0]
    out = torch.full_like(x, fill)
    if off < n:
        out[: n - off] = x[off:]
    return out


def _pair_key(hi: torch.Tensor, lo: torch.Tensor, hi_bias: int = 0):
    """int64 key whose signed order is the lexicographic order of the
    pair (hi + hi_bias, lo) for lo in [0, 2^32)."""
    return (hi + hi_bias) * _TWO32 + lo


def _lex_order(key_hi: torch.Tensor, key_lo: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting by (key_hi, key_lo)."""
    o1 = torch.sort(key_lo, stable=True).indices
    o2 = torch.sort(key_hi[o1], stable=True).indices
    return o1[o2]


def _heads(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """Group heads of sorted rows: the first row, and every row whose key
    differs from the previous row's."""
    n = sorted_keys[0].shape[0]
    heads = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    heads[0] = True
    for k in sorted_keys:
        heads[1:] |= k[1:] != k[:-1]
    return heads


def _bootstrap(data: torch.Tensor):
    """Depth-15 bootstrap: sort on bytes 0..14 and the remaining length.
    Returns (rank, unresolved mask) in position order."""
    n = data.shape[0]
    idx = torch.arange(n, device=data.device)
    d = data.long()

    def pbyte(j: int) -> torch.Tensor:
        return _shifted(d, j, 0)

    words = []
    for w in range(3):
        acc = torch.zeros(n, dtype=torch.int64, device=data.device)
        for j in range(4):
            acc = (acc << 8) | pbyte(4 * w + j)
        words.append(acc)
    rem = torch.clamp(n - idx, 1, _BOOT_DEPTH)
    w3 = (((pbyte(12) << 8 | pbyte(13)) << 8 | pbyte(14)) << 8) | rem
    k_hi = _pair_key(words[0], words[1], -(1 << 31))
    k_lo = _pair_key(words[2], w3, -(1 << 31))
    pos_s = _lex_order(k_hi, k_lo)
    heads = _heads(k_hi[pos_s], k_lo[pos_s])
    return _rank_mask_to_position_order(heads, pos_s, n)


def _rank_mask_to_position_order(heads, pos_s, n: int):
    """Sorted-order group heads + the sorted->position permutation ->
    position-ordered (group-start ranks, unresolved mask)."""
    pos = torch.arange(n, device=heads.device)
    gstart = torch.cummax(torch.where(heads, pos, -1), 0).values
    nxt_head = torch.ones_like(heads)
    nxt_head[:-1] = heads[1:]
    rank = torch.empty(n, dtype=torch.int64, device=heads.device)
    rank[pos_s] = gstart
    mask = torch.empty(n, dtype=torch.bool, device=heads.device)
    mask[pos_s] = ~(heads & nxt_head)
    return rank, mask


def _round_keys(r1, r2, r3, r4):
    # ranks are in [0, 2^31); continuations past the end rank -1
    return _pair_key(r1, r2 + 1), _pair_key(r3 + 1, r4 + 1)


def _full_round4(rank: torch.Tensor, k: int, n: int):
    """One quadrupling round over all n suffixes."""
    key_a, key_b = _round_keys(rank, _shifted(rank, k, -1),
                               _shifted(rank, 2 * k, -1),
                               _shifted(rank, 3 * k, -1))
    pos_s = _lex_order(key_a, key_b)
    heads = _heads(key_a[pos_s], key_b[pos_s])
    rank, mask = _rank_mask_to_position_order(heads, pos_s, n)
    return rank, mask, int(mask.sum())


def _bucket_round_compact4(rank: torch.Tensor, uidx: torch.Tensor, k: int,
                           n: int):
    """One quadrupling round over the unresolved positions ``uidx`` only.
    Sound because every member of an unresolved group is unresolved, so
    the group's subgroup offsets are complete.  Updates ``rank`` in place;
    returns the positions still unresolved."""
    r1 = rank[uidx]

    def cont(off):
        j = uidx + off
        return torch.where(j < n, rank[j.clamp(max=n - 1)], -1)

    key_a, key_b = _round_keys(r1, cont(k), cont(2 * k), cont(3 * k))
    perm = _lex_order(key_a, key_b)
    m = uidx.shape[0]
    pos = torch.arange(m, device=uidx.device)
    r1s = r1[perm]
    h1 = _heads(r1s)
    hall = _heads(key_a[perm], key_b[perm])
    s1 = torch.cummax(torch.where(h1, pos, -1), 0).values
    sall = torch.cummax(torch.where(hall, pos, -1), 0).values
    uidx_s = uidx[perm]
    rank[uidx_s] = r1s + (sall - s1)
    nxt = torch.ones_like(hall)
    nxt[:-1] = hall[1:]
    return uidx_s[~(hall & nxt)]


def suffix_array(data: torch.Tensor):
    """Suffix array and ranks (ISA) of u8[n] by prefix quadrupling: full
    rounds while more than n/4 suffixes are unresolved, then rounds over
    the unresolved positions only."""
    n = data.shape[0]
    rank, mask = _bootstrap(data)
    cnt = int(mask.sum())
    m1 = min(n, max(4096, n // 4))
    k = _BOOT_DEPTH
    while cnt > m1 and k < 2 * n:
        rank, mask, cnt = _full_round4(rank, k, n)
        k *= 4
    uidx = torch.nonzero(mask)[:, 0]
    while uidx.numel() > 0 and k < 2 * n:
        uidx = _bucket_round_compact4(rank, uidx, k, n)
        k *= 4
    sa = torch.empty_like(rank)
    sa[rank] = torch.arange(n, device=data.device)
    return sa, rank


def _extract_bwt_impl(data: torch.Tensor, rank: torch.Tensor, r: int):
    """U + primary + aux from position-ordered ranks; ``r`` is the aux
    sampling rate."""
    n = data.shape[0]
    sa = torch.empty_like(rank)
    sa[rank] = torch.arange(n, device=data.device)
    A = torch.roll(data, 1)[sa]  # T[SA[j]-1]; T[n-1] for suffix 0
    r0 = rank[0]
    w = torch.arange(n, device=data.device)
    U = torch.where(w <= r0, torch.roll(A, 1), A)
    U[0] = A[r0]
    n_aux = (n - 1) // r
    aux = rank[(torch.arange(n_aux, device=data.device) + 1) * r]
    return U, r0 + 1, aux.to(torch.int32)


def bwt_encode(data: torch.Tensor):
    """Forward BWT of u8[n] at the format's aux rate ``aux_rate(n)``.
    Returns (U u8[n], primary (0-dim tensor), aux i32[(n-1)//aux_rate(n)])
    in the convention of the native tbsc_bwt_encode."""
    n = data.shape[0]
    if n <= 1:
        return (data, torch.tensor(n, device=data.device),
                torch.zeros(0, dtype=torch.int32, device=data.device))
    _, rank = suffix_array(data)
    return _extract_bwt_impl(data, rank, aux_rate(n))


def bwt_encode_wideaux_device(data: torch.Tensor, r: int):
    """Forward BWT of u8[n] at aux rate ``r`` on data's device.  Returns
    (U u8[n], primary (0-dim tensor), aux i32[(n-1)//r]) in the
    convention of the native tbsc_bwt_encode_rate."""
    n = data.shape[0]
    if n <= 1:
        return data, torch.tensor(n), torch.zeros(0, dtype=torch.int32)
    _, rank = suffix_array(data)
    return _extract_bwt_impl(data, rank, r)


def unbwt_wideaux(T: torch.Tensor, index: int, aux: torch.Tensor, r: int,
                  n: int) -> torch.Tensor:
    """Inverse BWT for the wide-aux profile: chain t starts at row
    aux[t-1] + 1 (chain 0 at the primary) and emits positions
    [t r, (t+1) r).  PSI comes from one stable sort of the BWT chars;
    each step gathers (first char << 32 | PSI) for every chain."""
    dev = T.device
    d = T.long()
    u_sorted = torch.sort(d, stable=True).indices
    psi_tail = u_sorted + (u_sorted >= index).long()
    psi = torch.cat([torch.tensor([index], device=dev), psi_tail])
    cnt = torch.bincount(d, minlength=256)
    row_char = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.repeat_interleave(
                              torch.arange(256, device=dev), cnt)])
    packed = (row_char << 32) | psi
    k = torch.cat([torch.tensor([index], device=dev), aux.long() + 1])
    out = torch.empty((r, k.shape[0]), dtype=torch.uint8, device=dev)
    for step in range(r):
        w = packed[k]
        out[step] = (w >> 32).to(torch.uint8)
        k = w & 0xFFFFFFFF
    return out.t().reshape(-1)[:n]
