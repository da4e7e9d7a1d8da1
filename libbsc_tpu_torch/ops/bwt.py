"""Burrows-Wheeler transform on the device, in torch ops: the exact-shape
forward transform at the format's aux rate and the wide-aux profile.

Forward: suffix ranks by prefix quadrupling (:func:`bwt_encode`), or by
the difference-cover sample sort DC3 (:func:`bwt_encode_dc3`, described
above :func:`_dc3_sample_rank`).  A depth-15 bootstrap sorts the first
15 bytes (plus the remaining length, so a suffix that is a prefix of
another sorts first); each round then sorts by the 4-tuple
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


def _refine(rank: torch.Tensor, mask: torch.Tensor, k: int, n: int):
    """Quadrupling rounds from ranks resolved to step ``k``: full rounds
    while more than n/4 of the n positions are unresolved, then rounds
    over the unresolved positions only.  Returns the final ranks."""
    cnt = int(mask.sum())
    m1 = min(n, max(4096, n // 4))
    while cnt > m1 and k < 2 * n:
        rank, mask, cnt = _full_round4(rank, k, n)
        k *= 4
    uidx = torch.nonzero(mask)[:, 0]
    while uidx.numel() > 0 and k < 2 * n:
        uidx = _bucket_round_compact4(rank, uidx, k, n)
        k *= 4
    return rank


def _sa_of(rank: torch.Tensor) -> torch.Tensor:
    sa = torch.empty_like(rank)
    sa[rank] = torch.arange(rank.shape[0], device=rank.device)
    return sa


def suffix_array(data: torch.Tensor):
    """Suffix array and ranks (ISA) of u8[n] by prefix quadrupling."""
    rank, mask = _bootstrap(data)
    rank = _refine(rank, mask, _BOOT_DEPTH, data.shape[0])
    return _sa_of(rank), rank


# ---------------------------------------------------------------------------
# Difference-cover (DC3) suffix sort: quadrupling over the 2n/3 sample
# ---------------------------------------------------------------------------
#
# The JAX package's ops/bwt.py:526-751, libcubwt's algorithm family
# (libcubwt.cu:644-738 builds the reduced arrays, :1875-2030 merges the
# classes back):
#
# - sample = text positions p with p % 3 != 0, interleaved: reduced slot
#   j = 2t+b  <->  text p = 3t+b+1 (b in {0,1}).  An even reduced step k
#   advances 1.5k text bytes for every slot, so the prefix rounds apply
#   with n -> m: the bootstrap resolves 15 text bytes, which is 10
#   reduced slots, and each round quadruples the step.  Slots [0, m) are
#   exactly the sample positions below n.
# - merge: with rank_S total on the sample, (T[p], rank_S(p+1)) is an exact
#   suffix comparator on C u S1 and (T[p]T[p+1], rank_S(p+2)) on C u S2
#   (C = the p%3==0 class; every lookup lands in the sample).  One stable
#   sort of each side and exclusive counts of C give every suffix its rank:
#     rank(c in C)  = idx1(c) + (idx2(c) - C_before2(c))
#     rank(s in S1) = rank_S(s) + C_before1(s)
#     rank(s in S2) = rank_S(s) + C_before2(s)
# - positions past the end rank n-1-p (strictly decreasing negatives), so a
#   suffix that is a prefix of a longer one sorts first.


def _dc3_sample_rank(data: torch.Tensor, n3: int, m: int) -> torch.Tensor:
    """All-distinct group-start ranks of the m sample suffixes, in slot
    order."""
    n = data.shape[0]
    L = 3 * n3
    d = torch.zeros(L, dtype=torch.int64, device=data.device)
    d[:n] = data  # bytes past the end read 0

    def pbyte(j: int) -> torch.Tensor:
        return _shifted(d, j, 0)

    def red(a: torch.Tensor) -> torch.Tensor:
        return a.view(n3, 3)[:, 1:].reshape(2 * n3)[:m]

    words = []
    for w in range(3):
        acc = torch.zeros(L, dtype=torch.int64, device=data.device)
        for j in range(4):
            acc = (acc << 8) | pbyte(4 * w + j)
        words.append(red(acc))
    rem = torch.clamp(n - torch.arange(L, device=data.device), 1,
                      _BOOT_DEPTH)
    words.append(red((((pbyte(12) << 8 | pbyte(13)) << 8 | pbyte(14)) << 8)
                     | rem))
    k_hi = _pair_key(words[0], words[1], -(1 << 31))
    k_lo = _pair_key(words[2], words[3], -(1 << 31))
    pos_s = _lex_order(k_hi, k_lo)
    rank, mask = _rank_mask_to_position_order(
        _heads(k_hi[pos_s], k_lo[pos_s]), pos_s, m)
    return _refine(rank, mask, 10, m)


def _merge_class_sort(k_char, k_rank, pay, own):
    """One merge side: stably sort C u S_b by (k_char, k_rank).  Returns
    the sorted text positions, their sorted index, the C-class mask, the
    exclusive count of C elements before each slot, and the sample ranks
    carried through the sort.  |k_rank| < 2^31, so k_char * 2^32 + k_rank
    orders the pair."""
    order = torch.sort(_pair_key(k_char, k_rank), stable=True).indices
    pay_s = pay[order]
    is_c = (pay_s % 3) == 0
    c_exc = torch.cumsum(is_c, 0) - is_c.long()
    return (pay_s, torch.arange(pay.shape[0], device=pay.device), is_c,
            c_exc, own[order])


def _by_position(pay_s: torch.Tensor, v: torch.Tensor, n3: int):
    """[n3, 2] grid of one merge side's values in text order: row t holds
    the value of position 3t and of its sample partner (0 where absent)."""
    grid = torch.zeros(2 * n3, dtype=v.dtype, device=v.device)
    grid[2 * (pay_s // 3) + (pay_s % 3 != 0).long()] = v
    return grid.view(n3, 2)


def _dc3_rank(data: torch.Tensor) -> torch.Tensor:
    """Position-ordered all-distinct suffix ranks of u8[n], n >= 64, by
    DC3."""
    n = data.shape[0]
    dev = data.device
    n3 = (n + 2) // 3
    m = n - n3
    L = 3 * n3

    rank_red = _dc3_sample_rank(data, n3, m)

    # sample ranks in text coordinates, past-the-end positions ranking
    # n-1-p
    cols = torch.zeros(2 * n3, dtype=torch.int64, device=dev)
    cols[:m] = rank_red
    cols = cols.view(n3, 2)
    posL = torch.arange(L + 2, device=dev)
    rs_full = n - 1 - posL
    rs_full[:n] = torch.stack([torch.zeros_like(cols[:, 0]), cols[:, 0],
                               cols[:, 1]], 1).reshape(L)[:n]

    dpadL = torch.zeros(L + 2, dtype=torch.int64, device=dev)
    dpadL[:n] = data
    dmat = dpadL[:L].view(n3, 3)
    rsmat = rs_full[:L].view(n3, 3)

    m_s1 = (n + 1) // 3           # positions 3t+1 < n
    m_s2 = m - m_s1               # positions 3t+2 < n
    three = 3 * torch.arange(n3, device=dev)
    zeros = torch.zeros(n3, dtype=torch.int64, device=dev)

    # sort 1: C u S1 by (T[p], rank_S(p+1))
    pay_s, i1, is_c1, c_exc1, own_s1 = _merge_class_sort(
        torch.cat([dmat[:, 0], dmat[:m_s1, 1]]),
        torch.cat([rsmat[:, 1], rsmat[:m_s1, 2]]),
        torch.cat([three, three[:m_s1] + 1]),
        torch.cat([zeros, rsmat[:m_s1, 1]]))
    grid1 = _by_position(pay_s, torch.where(is_c1, i1, own_s1 + c_exc1), n3)

    # sort 2: C u S2 by (T[p]T[p+1], rank_S(p+2))
    t_next = dpadL[3::3][:n3]                       # T[3(t+1)]
    rs_next1 = rs_full[4::3][:n3]                   # rank_S(3t+4)
    pay_s2, i2, is_c2, c_exc2, own_s2 = _merge_class_sort(
        torch.cat([(dmat[:, 0] << 8) | dmat[:, 1],
                   (dmat[:m_s2, 2] << 8) | t_next[:m_s2]]),
        torch.cat([rsmat[:, 2], rs_next1[:m_s2]]),
        torch.cat([three, three[:m_s2] + 2]),
        torch.cat([zeros, rsmat[:m_s2, 2]]))
    grid2 = _by_position(pay_s2, torch.where(is_c2, i2 - c_exc2,
                                             own_s2 + c_exc2), n3)

    # C ranks add the two sides' contributions; S ranks are final
    return torch.stack([grid1[:, 0] + grid2[:, 0], grid1[:, 1], grid2[:, 1]],
                       1).reshape(L)[:n]


def suffix_array_dc3(data: torch.Tensor):
    """Suffix array and ranks of u8[n] by DC3 (blocks under 64 bytes by
    :func:`suffix_array`)."""
    if data.shape[0] < 64:
        return suffix_array(data)
    rank = _dc3_rank(data)
    return _sa_of(rank), rank


def _extract_bwt_impl(data: torch.Tensor, rank: torch.Tensor, r: int):
    """U + primary + aux from position-ordered ranks; ``r`` is the aux
    sampling rate."""
    n = data.shape[0]
    A = torch.roll(data, 1)[_sa_of(rank)]  # T[SA[j]-1]; T[n-1] for suffix 0
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


def bwt_encode_dc3(data: torch.Tensor):
    """Forward BWT of u8[n] by the DC3 suffix sort, at the format's aux
    rate; the same result as :func:`bwt_encode` (blocks under 64 bytes
    go there)."""
    n = data.shape[0]
    if n < 64:
        return bwt_encode(data)
    return _extract_bwt_impl(data, _dc3_rank(data), aux_rate(n))


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
