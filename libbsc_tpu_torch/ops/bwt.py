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

Inverse of the default format (:func:`bwt_decode`, the ``TBSC_ENGINE=ops``
route): the LF permutation is list-ranked by pointer doubling, a fixed
ceil(log2 n) rounds of two gathers each, with no host sync.  Inverse of the
wide-aux profile: the tail gives (n-1)//r + 1 independent forward chains
(the primary and each aux index), chased by K8 (``csrc/unbwt_chase.cu``):
one stable sort of the chars, then a kernel that writes a two-step table
(row k: PSI[PSI[k]] and the char of row PSI[k]), then one thread a chain,
two steps a load.  The rows are sorted by their first char, so the chase
finds a row's own char among the 256 bucket ends.  The plain versions
(:func:`pair_table_plain`, :func:`chase_plain`) step every chain at once,
r / 2 gathers.
"""

from __future__ import annotations

import torch

from . import _cuda

_BOOT_DEPTH = 15
_TWO32 = 1 << 32

LAUNCHES = {"unbwt_table": 0, "unbwt_chase": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def suffix_array_fast(data: torch.Tensor) -> torch.Tensor:
    """Position-ordered suffix ranks of u8[n].

    The JAX package keeps a second, host-driven sort beside its traceable
    one because XLA wants static shapes: it syncs a count each round and
    re-sorts the unresolved positions in padded buckets.  The port's
    :func:`suffix_array` is already host-driven (a count sync each round,
    rounds over the unresolved positions only once they number under
    n/4), so this returns its ranks."""
    return suffix_array(data)[1]


def bwt_encode_fast(data: torch.Tensor):
    """Forward BWT of u8[n] from :func:`suffix_array_fast`, at the format's
    aux rate: the same result as :func:`bwt_encode`."""
    n = data.shape[0]
    if n <= 1:
        return (data, torch.tensor(n, device=data.device),
                torch.zeros(0, dtype=torch.int32, device=data.device))
    return _extract_bwt_impl(data, suffix_array_fast(data), aux_rate(n))


def _log2_ceil(n: int) -> int:
    return max(1, (n - 1).bit_length())


def bwt_decode(data: torch.Tensor, index: int) -> torch.Tensor:
    """Inverse BWT of u8[n] (the default format) given the primary index
    in [1, n], by list ranking on data's device.

    LF maps the BWT slot u to its row in [1, n] (row 0 is the sentinel);
    one stable sort of the bytes gives it: the j-th slot in sorted order
    goes to row j + 1.  Back in slot coordinates, the chain runs from the
    slot whose row is the primary (its outgoing edge is never taken) to
    slot 0.  Pointer doubling ranks every slot's distance to slot 0 in
    ceil(log2 n) rounds; slot u emits output position n - 1 - dist(u).

    A primary outside [1, n] raises ValueError before any launch.  Bytes
    that are no BWT give an LF permutation of several cycles, whose
    distances pass n - 1; those writes are dropped (the output is garbage,
    and the caller's Adler-32 check rejects it), so no index leaves
    [0, n)."""
    n = data.shape[0]
    if n <= 1:
        return data
    if not 0 < index <= n:
        raise ValueError(f"BWT primary {index} outside [1, {n}]")
    dev = data.device
    idx = torch.arange(n, device=dev)
    pos_s = torch.sort(data, stable=True).indices
    lf = torch.empty(n, dtype=torch.int64, device=dev)
    lf[pos_s] = idx + 1
    nxt = lf - (lf > index).long()
    keep = lf != index  # the terminal slot's edge is dropped
    pred = torch.zeros(n, dtype=torch.int64, device=dev)
    pred[nxt[keep]] = idx[keep]
    pred[0] = 0
    dist = (idx != 0).long()
    for _ in range(_log2_ceil(n)):
        dist = dist + dist[pred]
        pred = pred[pred]
    ok = dist < n
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    out[(n - 1 - dist)[ok]] = data[ok]
    return out


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


def chase_inputs(T: torch.Tensor, index: int, aux: torch.Tensor):
    """K8's table and start rows, from one stable sort of the BWT chars:
    the sorted chars are the rows' first chars (row 0, the sentinel, has
    char 0), and the positions they came from give PSI[1..]; PSI[0] is
    the primary.  Returns (the two-step table i64 [n + 1] from
    :func:`pair_table`, the bucket ends i32 [256] from
    :func:`bucket_ends`, the start rows i32 [chains]: the primary, then
    each aux index + 1)."""
    chars, u_sorted = torch.sort(T, stable=True)
    ends = bucket_ends(chars)
    del chars
    head = torch.tensor([index], dtype=torch.int32, device=T.device)
    return (pair_table(u_sorted, index, ends), ends,
            torch.cat([head, aux.to(torch.int32) + 1]))


def bucket_ends(chars: torch.Tensor) -> torch.Tensor:
    """i32 [256]: ends[c] = 1 + #(chars <= c) for the sorted u8 ``chars``,
    the row after bucket c in the table (row 0 is the sentinel).  The
    first char of row k is the number of ends at or below k."""
    probe = torch.arange(256, dtype=torch.uint8, device=chars.device)
    return (torch.searchsorted(chars, probe, right=True) + 1).to(torch.int32)


def row_chars(ends: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The first char of each of ``rows``, u8: the number of bucket ends
    at or below it."""
    return torch.searchsorted(ends, rows.to(torch.int32),
                              right=True).to(torch.uint8)


def psi_rows(u_sorted: torch.Tensor, index: int) -> torch.Tensor:
    """PSI i64 [n + 1] from the stable sort's indices ``u_sorted`` [n]:
    row 0 is the primary ``index``, row k >= 1 is u + (u >= index) with
    u = u_sorted[k - 1]."""
    head = torch.tensor([index], device=u_sorted.device)
    return torch.cat([head, u_sorted + (u_sorted >= index).long()])


def pair_table(u_sorted: torch.Tensor, index: int,
               ends: torch.Tensor) -> torch.Tensor:
    """K8's table kernel.  i64 [n + 1], two steps a row: row k holds
    PSI[PSI[k]] in the low 32 bits and the first char of row PSI[k]
    above them (:func:`psi_rows`, :func:`row_chars`)."""
    if u_sorted.dtype != torch.int64 or u_sorted.dim() != 1 or \
            not u_sorted.is_contiguous():
        raise ValueError("pair_table: u_sorted must be a contiguous 1-D "
                         "int64 tensor")
    dev = u_sorted.device
    if ends.dtype != torch.int32 or ends.shape != (256,) or \
            ends.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError("pair_table: 256 int32 bucket ends on the sort's "
                         "CPU or CUDA device")
    if dev.type == "cpu":
        return pair_table_plain(u_sorted, index, ends)
    n = int(u_sorted.shape[0])
    pairs = torch.empty(n + 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.launcher("unbwt_table")(
            u_sorted.data_ptr(), n, index, ends.data_ptr(),
            pairs.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check("unbwt_table", rc)
    LAUNCHES["unbwt_table"] += 1
    return pairs


def pair_table_plain(u_sorted: torch.Tensor, index: int,
                     ends: torch.Tensor) -> torch.Tensor:
    """K8's table kernel's plain version."""
    psi = psi_rows(u_sorted, index)
    return row_chars(ends, psi).long() << 32 | psi[psi]


def unbwt_wideaux(T: torch.Tensor, index: int, aux: torch.Tensor, r: int,
                  n: int) -> torch.Tensor:
    """Inverse BWT for the wide-aux profile: chain t starts at row
    aux[t-1] + 1 (chain 0 at the primary) and emits positions
    [t r, (t+1) r); :func:`chase_inputs`, then K8 (:func:`chase`)."""
    return chase(*chase_inputs(T, index, aux), r, n)


def chase(pairs: torch.Tensor, ends: torch.Tensor, starts: torch.Tensor,
          r: int, n: int) -> torch.Tensor:
    """K8's chase.  u8 [min(n, chains * r)]: chain t walks r steps from
    row ``starts[t]``, two a load of :func:`chase_inputs`' ``pairs``,
    emitting at position t r + step the first char of each row it leaves:
    a row's own char from the bucket ``ends``, the next row's from the
    table.  The rows must lie in [0, len(pairs)): the API checks the
    wide-aux tail first."""
    if pairs.dtype != torch.int64 or ends.dtype != torch.int32 or \
            starts.dtype != torch.int32 or \
            not all(t.dim() == 1 and t.is_contiguous()
                    for t in (pairs, ends, starts)):
        raise ValueError("chase: pairs (int64), ends and starts (int32) "
                         "must be contiguous 1-D tensors")
    dev = pairs.device
    if ends.shape[0] != 256 or {ends.device, starts.device} != {dev} or \
            dev.type not in ("cpu", "cuda") or r < 1:
        raise ValueError("chase: 256 bucket ends, all inputs on one CPU or "
                         f"CUDA device, and a rate of at least 1 (got {r})")
    if dev.type == "cpu":
        return chase_plain(pairs, ends, starts, r, n)
    chains = int(starts.shape[0])
    out = torch.empty(min(n, chains * r), dtype=torch.uint8, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            rc = _cuda.launcher("unbwt_chase")(
                pairs.data_ptr(), ends.data_ptr(), starts.data_ptr(),
                chains, r, n, out.data_ptr(), _cuda.stream_handle(dev))
        _cuda.check("unbwt_chase", rc)
        LAUNCHES["unbwt_chase"] += 1
    return out


def chase_plain(pairs: torch.Tensor, ends: torch.Tensor,
                starts: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """K8's chase's plain version: every chain steps at once, two steps a
    gather of the table (for an odd r, a last single step and no
    gather)."""
    k = starts.long()
    out = torch.empty((r, k.shape[0]), dtype=torch.uint8,
                      device=pairs.device)
    for step in range(0, r, 2):
        out[step] = row_chars(ends, k)
        if step + 1 < r:
            w = pairs[k]
            out[step + 1] = (w >> 32).to(torch.uint8)
            k = w & 0xFFFFFFFF
    return out.t().reshape(-1)[:n]
