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
give the lexicographic order.  On CUDA the steps around the sorts are
hand kernels (``csrc/bwt_sort.cu``): K11 builds the bootstrap's keys, K12
a round's, K13 finds the group heads and their starts by a one-pass scan
with decoupled look-back (its pre-pass between the two sorts packs each
row's low-key run and position into one word, so the main pass gathers
one word a row) and writes the ranks and the still-unresolved list, and
K14 extracts U, the primary and the aux indexes from the final ranks in
two passes through 64 KiB buckets of U; on the CPU each runs its plain
torch version (``*_plain``).

Stream convention (the reference's bwt/bwt.cpp:178-230, the native
runtime's tbsc_bwt_encode_rate):
  U[0] = T[n-1]; U[1..] = T[SA[j]-1] for ranks j skipping suffix 0;
  primary index = rank(suffix 0) + 1;
  aux indexes at rate r: indexes[t] = rank(suffix (t+1) r).

Inverse of the default format (:func:`bwt_decode`, the ``TBSC_ENGINE=numpy``
route; the device route runs K16, ``ops/unbwt_rulers.py``): the LF
permutation is list-ranked by pointer doubling, a fixed
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

_MAX_N = 1 << 31     # the int64 keys hold a rank in 32 bits
_HEADS_TILE = 1024   # K13's rows a tile (kTile in csrc/bwt_sort.cu)

LAUNCHES = {"bwt_boot_keys": 0, "bwt_round_keys": 0, "bwt_heads_pay": 0,
            "bwt_heads": 0, "bwt_extract_bins": 0, "bwt_extract": 0,
            "unbwt_table": 0, "unbwt_chase": 0}


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
    """Stable permutation sorting by (key_hi, key_lo): two stable sorts,
    low key first."""
    o1 = torch.sort(key_lo, stable=True).indices
    return o1[torch.sort(key_hi[o1], stable=True).indices]


def _heads(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """Group heads of sorted rows: the first row, and every row whose key
    differs from the previous row's."""
    n = sorted_keys[0].shape[0]
    heads = torch.zeros(n, dtype=torch.bool, device=sorted_keys[0].device)
    heads[:1] = True
    for k in sorted_keys:
        heads[1:] |= k[1:] != k[:-1]
    return heads


def _round_keys(r1, r2, r3, r4):
    # ranks are in [0, 2^31); continuations past the end rank -1
    return _pair_key(r1, r2 + 1), _pair_key(r3 + 1, r4 + 1)


# ---------------------------------------------------------------------------
# The sort's kernels (csrc/bwt_sort.cu), each with its plain version
# ---------------------------------------------------------------------------
#
# A round: K11 (the bootstrap) or K12 builds two int64 keys a row, two
# stable torch.sort calls with K13's pre-pass between them order the rows
# (_sort_rows), and K13 turns the sorted rows into group-start ranks and
# the still-unresolved positions: over all n positions (heads_full) or
# over the unresolved ones (heads_compact).  K14 extracts the BWT from the
# final ranks in two passes.  Each wrapper runs its plain version for a
# CPU tensor and launches its kernel for a CUDA one (a failed build or
# launch raises).


def _vec(name: str, t: torch.Tensor, dtype) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() or \
            t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: a contiguous 1-D {dtype} tensor on a CPU "
                         "or CUDA device")


def _same_device(name: str, *ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: every input on one device")


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        rc = _cuda.launcher(name)(*args, _cuda.stream_handle(dev))
    _cuda.check(name, rc)
    LAUNCHES[name] += 1


def boot_keys(data: torch.Tensor, sample: bool = False):
    """K11: the depth-15 bootstrap's two int64 keys a row of u8[n] (bytes
    0-11 of the suffix, then bytes 12-14 and the remaining length clamped
    to [1, 15]; bytes past the end read 0), over every position, or with
    ``sample`` over DC3's sample (row j is position 3 (j // 2) + j % 2 +
    1).  Raises for n >= 2^31, past the int64 key layout."""
    data = data.contiguous()
    _vec("boot_keys", data, torch.uint8)
    n = int(data.shape[0])
    if n >= _MAX_N:
        raise ValueError(f"a block of {n} bytes: the suffix sort takes "
                         "fewer than 2^31")
    if data.device.type == "cpu":
        return boot_keys_plain(data, sample)
    rows = n - (n + 2) // 3 if sample else n  # DC3's sample: p % 3 != 0
    k_hi = torch.empty(rows, dtype=torch.int64, device=data.device)
    k_lo = torch.empty_like(k_hi)
    if rows:
        _launch("bwt_boot_keys", data.device, data.data_ptr(), n, rows,
                int(sample), k_hi.data_ptr(), k_lo.data_ptr())
    return k_hi, k_lo


def boot_keys_plain(data: torch.Tensor, sample: bool = False):
    """K11's plain version."""
    n = data.shape[0]
    n3 = (n + 2) // 3
    L = 3 * n3 if sample else n
    d = torch.zeros(L, dtype=torch.int64, device=data.device)
    d[:n] = data  # bytes past the end read 0

    def pbyte(j: int) -> torch.Tensor:
        return _shifted(d, j, 0)

    def rows(a: torch.Tensor) -> torch.Tensor:
        if not sample:
            return a
        return a.view(n3, 3)[:, 1:].reshape(2 * n3)[:n - n3]

    words = []
    for w in range(3):
        acc = torch.zeros(L, dtype=torch.int64, device=data.device)
        for j in range(4):
            acc = (acc << 8) | pbyte(4 * w + j)
        words.append(rows(acc))
    rem = torch.clamp(n - torch.arange(L, device=data.device), 1,
                      _BOOT_DEPTH)
    words.append(rows((((pbyte(12) << 8 | pbyte(13)) << 8 | pbyte(14)) << 8)
                      | rem))
    return (_pair_key(words[0], words[1], -(1 << 31)),
            _pair_key(words[2], words[3], -(1 << 31)))


def round_keys(rank: torch.Tensor, k: int, uidx: torch.Tensor | None = None):
    """K12: a round's two int64 keys from the position-order ``rank`` at
    i, i + k, i + 2k, i + 3k (-1 past the end), for every position i or
    for i in ``uidx``: (r(i) 2^32 + r(i+k) + 1, (r(i+2k) + 1) 2^32 +
    r(i+3k) + 1)."""
    _vec("round_keys", rank, torch.int64)
    if uidx is not None:
        _vec("round_keys", uidx, torch.int64)
        _same_device("round_keys", rank, uidx)
    if rank.device.type == "cpu":
        return round_keys_plain(rank, k, uidx)
    rows = int(rank.shape[0] if uidx is None else uidx.shape[0])
    key_a = torch.empty(rows, dtype=torch.int64, device=rank.device)
    key_b = torch.empty_like(key_a)
    if rows:
        _launch("bwt_round_keys", rank.device, rank.data_ptr(),
                int(rank.shape[0]), k,
                None if uidx is None else uidx.data_ptr(), rows,
                key_a.data_ptr(), key_b.data_ptr())
    return key_a, key_b


def round_keys_plain(rank: torch.Tensor, k: int,
                     uidx: torch.Tensor | None = None):
    """K12's plain version."""
    if uidx is None:
        return _round_keys(rank, _shifted(rank, k, -1),
                           _shifted(rank, 2 * k, -1),
                           _shifted(rank, 3 * k, -1))
    n = rank.shape[0]

    def cont(off):
        j = uidx + off
        return torch.where(j < n, rank[j.clamp(max=n - 1)], -1)

    return _round_keys(rank[uidx], cont(k), cont(2 * k), cont(3 * k))


def _int64s(name: str, *ts: torch.Tensor) -> int:
    """The rows of ``ts``: contiguous 1-D int64 tensors of one length on
    one device."""
    for t in ts:
        _vec(name, t, torch.int64)
    _same_device(name, *ts)
    m = int(ts[0].shape[0])
    if any(t.shape[0] != m for t in ts):
        raise ValueError(f"{name}: the sorted keys and both sorts' indices "
                         "must have one length")
    return m


def _heads_scratch(m: int, arrays: int, dev) -> torch.Tensor:
    """K13's zeroed scratch: ``arrays`` status words a tile, the tile
    counter, and the count (the last element)."""
    return torch.zeros(arrays * (-(-m // _HEADS_TILE)) + 2,
                       dtype=torch.int64, device=dev)


def heads_pay(lo_s, o1, key_hi, uidx=None):
    """K13's pre-pass, between the two sorts: from the first sort's values
    ``lo_s`` (the low keys sorted) and indices ``o1``, (hi1, pay) with
    hi1[s] = key_hi[o1[s]], the second sort's input, and pay[s] = g(s) <<
    32 | pos(s): g(s) the first row of s's run of equal ``lo_s``, pos(s) =
    o1[s], or ``uidx[o1[s]]`` over a compact round's rows.  Two rows have
    equal low keys exactly when their g are equal."""
    more = () if uidx is None else (uidx,)
    m = _int64s("heads_pay", lo_s, o1, key_hi, *more)
    if m >= _MAX_N:
        raise ValueError(f"heads_pay: {m} rows, fewer than 2^31")
    if lo_s.device.type == "cpu":
        return heads_pay_plain(lo_s, o1, key_hi, uidx)
    dev = lo_s.device
    hi1 = torch.empty_like(lo_s)
    pay = torch.empty_like(lo_s)
    if m:
        # held until the launch is queued: freed earlier, its memory could
        # go to another thread's tensor on this stream before the kernel
        scratch = _heads_scratch(m, 1, dev)
        _launch("bwt_heads_pay", dev, lo_s.data_ptr(), o1.data_ptr(),
                key_hi.data_ptr(), None if uidx is None else uidx.data_ptr(),
                m, hi1.data_ptr(), pay.data_ptr(), scratch.data_ptr())
    return hi1, pay


def heads_pay_plain(lo_s, o1, key_hi, uidx=None):
    """K13's pre-pass's plain version."""
    m = lo_s.shape[0]
    g = torch.cummax(torch.where(_heads(lo_s),
                                 torch.arange(m, device=lo_s.device), -1),
                     0).values
    pos = o1 if uidx is None else uidx[o1]
    return key_hi[o1], g << 32 | pos


def _sort_rows(key_hi: torch.Tensor, key_lo: torch.Tensor, uidx=None):
    """The rows sorted by (key_hi, key_lo) for K13: the first stable sort
    (low key), K13's pre-pass, the second (high key).  Returns (key_hi
    sorted, pay (:func:`heads_pay`), the second sort's indices o2)."""
    lo_s, o1 = torch.sort(key_lo, stable=True)
    hi1, pay = heads_pay(lo_s, o1, key_hi, uidx)
    del lo_s, o1
    hi_s, o2 = torch.sort(hi1, stable=True)
    return hi_s, pay, o2


def heads_full(hi_s, pay, o2):
    """K13 over all n positions: from the second sort's values ``hi_s``
    (the high keys sorted) and indices ``o2`` and the pre-pass's ``pay``
    (:func:`_sort_rows`), the position-order group-start ranks, the
    unresolved positions (each not a group of its own) in sorted order,
    and their count (a 0-dim int64 tensor on the device): the first
    ``count`` elements of the list are valid."""
    m = _int64s("heads_full", hi_s, pay, o2)
    if hi_s.device.type == "cpu":
        return heads_full_plain(hi_s, pay, o2)
    dev = hi_s.device
    rank = torch.empty_like(hi_s)
    still = torch.empty_like(hi_s)
    scratch = _heads_scratch(m, 2, dev)
    _launch("bwt_heads", dev, 0, hi_s.data_ptr(), o2.data_ptr(),
            pay.data_ptr(), m, rank.data_ptr(), still.data_ptr(),
            scratch.data_ptr())
    return rank, still, scratch[-1]


def _pay_sorted(hi_s, pay, o2):
    """(the rows' positions, their group heads) in sorted order."""
    pay_s = pay[o2]
    return pay_s & 0xFFFFFFFF, _heads(hi_s, pay_s >> 32)


def _unresolved(heads: torch.Tensor) -> torch.Tensor:
    nxt = torch.ones_like(heads)
    nxt[:-1] = heads[1:]
    return ~(heads & nxt)


def heads_full_plain(hi_s, pay, o2):
    """K13's full form's plain version."""
    pos_s, heads = _pay_sorted(hi_s, pay, o2)
    m = hi_s.shape[0]
    rank = torch.empty(m, dtype=torch.int64, device=hi_s.device)
    rank[pos_s] = torch.cummax(
        torch.where(heads, torch.arange(m, device=hi_s.device), -1),
        0).values
    still = pos_s[torch.nonzero(_unresolved(heads))[:, 0]]
    return rank, still, torch.tensor(still.shape[0], device=hi_s.device)


def heads_compact(hi_s, pay, o2, rank):
    """K13 over the unresolved positions of a compact round (the rows of
    :func:`round_keys` with ``uidx``, whose positions :func:`heads_pay`
    put in ``pay``): updates ``rank`` in place, each row to its old rank
    (``hi_s >> 32``) plus its offset in its old group, and returns (the
    still-unresolved positions in sorted order, their count as a 0-dim
    int64 tensor): the first ``count`` elements of the list are valid.
    Sound because every member of an unresolved group is unresolved, so
    the group's subgroup offsets are complete."""
    m = _int64s("heads_compact", hi_s, pay, o2)
    _vec("heads_compact", rank, torch.int64)
    _same_device("heads_compact", hi_s, rank)
    if m >= _MAX_N - 1:
        raise ValueError(f"heads_compact: {m} rows, fewer than 2^31 - 1")
    if hi_s.device.type == "cpu":
        return heads_compact_plain(hi_s, pay, o2, rank)
    dev = hi_s.device
    still = torch.empty_like(hi_s)
    scratch = _heads_scratch(m, 2, dev)
    _launch("bwt_heads", dev, 1, hi_s.data_ptr(), o2.data_ptr(),
            pay.data_ptr(), m, rank.data_ptr(), still.data_ptr(),
            scratch.data_ptr())
    return still, scratch[-1]


def heads_compact_plain(hi_s, pay, o2, rank):
    """K13's compact form's plain version."""
    pos_s, hall = _pay_sorted(hi_s, pay, o2)
    m = hi_s.shape[0]
    pos = torch.arange(m, device=hi_s.device)
    r1s = hi_s >> 32
    s1 = torch.cummax(torch.where(_heads(r1s), pos, -1), 0).values
    sall = torch.cummax(torch.where(hall, pos, -1), 0).values
    rank[pos_s] = r1s + (sall - s1)
    still = pos_s[_unresolved(hall)]
    return still, torch.tensor(still.shape[0], device=hi_s.device)


def _rank_pairs(key_hi, key_lo):
    """Sort the rows by (key_hi, key_lo) and rank them (K13's full form):
    (rank, the unresolved positions, their count)."""
    return heads_full(*_sort_rows(key_hi, key_lo))


def _refine(rank: torch.Tensor, still: torch.Tensor, cnt, k: int, n: int,
            left: list | None = None):
    """Quadrupling rounds from ranks resolved to step ``k`` (``cnt``
    positions unresolved, the first ``cnt`` of ``still`` in any order):
    full rounds while more than n/4 of the n positions are unresolved,
    then rounds over the unresolved positions only.  Returns the final
    ranks; each round's unresolved count is appended to ``left`` when
    given."""
    cnt = int(cnt)
    m1 = min(n, max(4096, n // 4))
    while cnt > m1 and k < 2 * n:
        keys = round_keys(rank, k)
        del rank, still
        rank, still, cnt = _rank_pairs(*keys)
        del keys
        cnt = int(cnt)
        if left is not None:
            left.append(cnt)
        k *= 4
    uidx = still[:cnt]
    del still
    while uidx.numel() > 0 and k < 2 * n:
        key_a, key_b = round_keys(rank, k, uidx)
        still, cnt = heads_compact(*_sort_rows(key_a, key_b, uidx), rank)
        uidx = still[:int(cnt)]
        if left is not None:
            left.append(uidx.numel())
        k *= 4
    return rank


def _sa_of(rank: torch.Tensor) -> torch.Tensor:
    sa = torch.empty_like(rank)
    sa[rank] = torch.arange(rank.shape[0], device=rank.device)
    return sa


def suffix_ranks(data: torch.Tensor) -> torch.Tensor:
    """Position-ordered suffix ranks (ISA) of u8[n], n >= 1, by prefix
    quadrupling."""
    return _refine(*_rank_pairs(*boot_keys(data)), _BOOT_DEPTH,
                   data.shape[0])


def suffix_array(data: torch.Tensor):
    """Suffix array and ranks (ISA) of u8[n] by prefix quadrupling."""
    rank = suffix_ranks(data)
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


def _dc3_sample_rank(data: torch.Tensor, m: int) -> torch.Tensor:
    """All-distinct group-start ranks of the m sample suffixes, in slot
    order."""
    return _refine(*_rank_pairs(*boot_keys(data, sample=True)), 10, m)


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

    rank_red = _dc3_sample_rank(data, m)

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


_BUCKET = 1 << 16  # K14's slots of U a bucket (kBucket in csrc/bwt_sort.cu)


def _extract_inputs(data: torch.Tensor, rank: torch.Tensor, r: int):
    data = data.contiguous()
    _vec("extract", data, torch.uint8)
    _vec("extract", rank, torch.int64)
    _same_device("extract", data, rank)
    n = int(data.shape[0])
    if rank.shape[0] != n or n < 2 or r < 1:
        raise ValueError("extract: a rank a byte, at least 2 bytes, and a "
                         f"rate of at least 1 (got {r})")
    return data, n


def extract(data: torch.Tensor, rank: torch.Tensor, r: int):
    """K14: U + primary + aux from the all-distinct position-order ranks of
    u8[n], n >= 2, with no suffix array; ``r`` is the aux sampling rate.
    Suffix i != 0 of rank j writes T[i - 1] to U[j + (j < r0)] (r0 =
    rank[0]), suffix 0 writes T[n - 1] to U[0]; primary = r0 + 1 (a 0-dim
    int64 tensor); aux[t] = rank[(t + 1) r] as int32.  On CUDA two
    passes: :func:`extract_bins`, then :func:`extract_place`."""
    data, _ = _extract_inputs(data, rank, r)
    if data.device.type == "cpu":
        return extract_plain(data, rank, r)
    stage, primary, aux = extract_bins(data, rank, r)
    return extract_place(stage), primary, aux


def extract_plain(data: torch.Tensor, rank: torch.Tensor, r: int):
    """K14's plain version."""
    n = data.shape[0]
    A = torch.roll(data, 1)[_sa_of(rank)]  # T[SA[j]-1]; T[n-1] for suffix 0
    r0 = rank[0]
    w = torch.arange(n, device=data.device)
    U = torch.where(w <= r0, torch.roll(A, 1), A)
    U[0] = A[r0]
    n_aux = (n - 1) // r
    aux = rank[(torch.arange(n_aux, device=data.device) + 1) * r]
    return U, r0 + 1, aux.to(torch.int32)


def extract_bins(data: torch.Tensor, rank: torch.Tensor, r: int):
    """K14's pass 1: (stage int32 [n], primary, aux).  Each suffix's byte
    goes to U's slot d (suffix 0: d = 0, T[n - 1]; suffix i != 0 of rank
    j: d = j + (j < r0), T[i - 1]) as the entry (d & 0xFFFF) << 8 | byte,
    in the region of its bucket d >> 16: stage[b 2^16 + k] for k below
    the bucket's min(2^16, n - b 2^16) slots, every slot of U one entry.
    The kernel's order within a bucket is whatever its blocks' atomics
    gave; the plain version's is by slot."""
    data, n = _extract_inputs(data, rank, r)
    if data.device.type == "cpu":
        return extract_bins_plain(data, rank, r)
    dev = data.device
    n_aux = (n - 1) // r
    cursor = torch.zeros(-(-n // _BUCKET), dtype=torch.int32, device=dev)
    stage = torch.empty(n, dtype=torch.int32, device=dev)
    primary = torch.empty((), dtype=torch.int64, device=dev)
    aux = torch.empty(n_aux, dtype=torch.int32, device=dev)
    _launch("bwt_extract_bins", dev, data.data_ptr(), rank.data_ptr(), n, r,
            n_aux, cursor.data_ptr(), stage.data_ptr(), primary.data_ptr(),
            aux.data_ptr())
    return stage, primary, aux


def extract_bins_plain(data: torch.Tensor, rank: torch.Tensor, r: int):
    """K14's pass 1's plain version."""
    n = data.shape[0]
    r0 = rank[0]
    d = rank + (rank < r0).long()
    d[0] = 0
    stage = torch.empty(n, dtype=torch.int32, device=data.device)
    stage[d] = ((d & (_BUCKET - 1)) << 8 | torch.roll(data, 1).long()).to(
        torch.int32)
    n_aux = (n - 1) // r
    aux = rank[(torch.arange(n_aux, device=data.device) + 1) * r]
    return stage, r0 + 1, aux.to(torch.int32)


def extract_place(stage: torch.Tensor) -> torch.Tensor:
    """K14's pass 2: U u8 [n] from :func:`extract_bins`' stage, each
    bucket's bytes placed at their slots."""
    _vec("extract_place", stage, torch.int32)
    if stage.device.type == "cpu":
        return extract_place_plain(stage)
    n = int(stage.shape[0])
    U = torch.empty(n, dtype=torch.uint8, device=stage.device)
    if n:
        _launch("bwt_extract", stage.device, stage.data_ptr(), n,
                U.data_ptr())
    return U


def extract_place_plain(stage: torch.Tensor) -> torch.Tensor:
    """K14's pass 2's plain version."""
    n = stage.shape[0]
    lo = torch.arange(n, device=stage.device) & ~(_BUCKET - 1)
    U = torch.empty(n, dtype=torch.uint8, device=stage.device)
    U[lo + (stage.long() >> 8)] = (stage & 0xFF).to(torch.uint8)
    return U


def bwt_encode(data: torch.Tensor):
    """Forward BWT of u8[n] at the format's aux rate ``aux_rate(n)``.
    Returns (U u8[n], primary (0-dim tensor), aux i32[(n-1)//aux_rate(n)])
    in the convention of the native tbsc_bwt_encode."""
    n = data.shape[0]
    if n <= 1:
        return (data, torch.tensor(n, device=data.device),
                torch.zeros(0, dtype=torch.int32, device=data.device))
    return extract(data, suffix_ranks(data), aux_rate(n))


def suffix_array_fast(data: torch.Tensor) -> torch.Tensor:
    """Position-ordered suffix ranks of u8[n].

    The JAX package keeps a second, host-driven sort beside its traceable
    one because XLA wants static shapes: it syncs a count each round and
    re-sorts the unresolved positions in padded buckets.  The port's
    :func:`suffix_ranks` is already host-driven (a count sync each round,
    rounds over the unresolved positions only once they number under
    n/4), so this returns its ranks."""
    return suffix_ranks(data)


def bwt_encode_fast(data: torch.Tensor):
    """Forward BWT of u8[n] from :func:`suffix_array_fast`, at the format's
    aux rate: the same result as :func:`bwt_encode`."""
    n = data.shape[0]
    if n <= 1:
        return (data, torch.tensor(n, device=data.device),
                torch.zeros(0, dtype=torch.int32, device=data.device))
    return extract(data, suffix_array_fast(data), aux_rate(n))


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
    return extract(data, _dc3_rank(data), aux_rate(n))


def bwt_encode_wideaux_device(data: torch.Tensor, r: int):
    """Forward BWT of u8[n] at aux rate ``r`` on data's device.  Returns
    (U u8[n], primary (0-dim tensor), aux i32[(n-1)//r]) in the
    convention of the native tbsc_bwt_encode_rate."""
    n = data.shape[0]
    if n <= 1:
        return data, torch.tensor(n), torch.zeros(0, dtype=torch.int32)
    return extract(data, suffix_ranks(data), r)


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
