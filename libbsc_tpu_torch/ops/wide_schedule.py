"""Device lane balancing and bit schedule for CODER_QLFC_WIDE, in torch ops.

From the transformed block (on the device) and the lane table, build the
per-lane packed 2-bit (bit | active) iteration planes that K1 and K2
consume — the same planes as the native walker (tbsc_wide_schedule_packed),
without a sequential per-byte walk:

1. run boundaries on the flat block; the run starts, in order, are the
   events, laid on an [L, E] grid (E = bucketed most runs in a lane);
2. MTF ranks without an MTF table: with the identity-initialized table the
   rank of an event with char c is the number of distinct chars seen since
   c's previous occurrence, or, for a first occurrence, S + c - #{seen
   d < c} (S = distinct chars seen so far) — one running-max pass per
   char present in the block;
3. per-event bit counts, then the expansion to the flat bit sequence
   (flag / unary exponent / mantissa, rank then run): one packed word per
   event scattered at its bit offset and forward-filled with cummax, so
   every iteration finds its owning event without a gather.

:func:`device_schedule_v2` refuses blocks the JAX package's v2 sends to
the host walker; :func:`device_schedule` (the JAX package's v1, for an
explicit lane table, under ``TBSC_WIDE_DEV_SCHED``) takes every block.
:func:`device_balanced_sizes` is the device lane balancer (run-count
quantiles).  Its table differs from the native balancer's, so the fused
route's archive is not the per-stage route's: both packages hold the fused
route to this one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import wide as W

_S_SHIFT = 14   # low bits of the event word: rank << 6 | run bit-length
_IT_CAP = 1 << 19  # the JAX package's v2 packing cap (32 - its 13-bit
# shift), kept so both packages send the same blocks to the host walker
_LANE_CHUNK = 128  # lanes expanded at a time (bounds the [lanes, IT] temps)


def _bucket(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of positive integers (frexp is exact)."""
    return torch.frexp(x.clamp(min=1).double()).exponent.long()


def device_balanced_sizes(data: torch.Tensor, L: int) -> torch.Tensor:
    """Run-count-quantile lane sizes on data's device: lanes split at run
    boundaries with ~equal run counts.  Returns int32[L] summing to n."""
    n = data.shape[0]
    nr = torch.ones(n, dtype=torch.bool, device=data.device)
    nr[1:] = data[1:] != data[:-1]
    cum = nr.cumsum(0)
    R = cum[-1]
    k = torch.arange(1, L, device=data.device)
    # floor(k * R / L), written as the JAX package writes it (its int32-safe
    # form); the lane table decides the archive bytes
    targets = k * (R // L) + (k * (R % L)) // L
    splits = torch.searchsorted(cum, targets, right=True)
    zero = torch.zeros(1, dtype=splits.dtype, device=data.device)
    bounds = torch.cat([zero, splits, zero + n])
    return (bounds[1:] - bounds[:-1]).to(torch.int32)


def _stats(data: torch.Tensor, starts: torch.Tensor):
    """(runs R, most runs in a lane, longest run) and the run-boundary
    mask / running run count the event pass reuses."""
    n = data.shape[0]
    pos = torch.arange(n, device=data.device)
    nr = torch.zeros(n, dtype=torch.bool, device=data.device)
    nr[starts[starts < n]] = True  # lane starts force a boundary
    nr[0] = True
    nr[1:] |= data[1:] != data[:-1]
    cum = nr.cumsum(0)
    R = cum[-1]
    frid = torch.where(starts >= n, R, cum[starts.clamp(0, n - 1)] - 1)
    frid_ext = torch.cat([frid, R[None]])
    maxpl = (frid_ext[1:] - frid_ext[:-1]).max()
    lastb = torch.cummax(torch.where(nr, pos, -1), 0).values
    maxrun = (pos - lastb).max() + 1
    return torch.stack([R, maxpl, maxrun]), nr, cum, frid


def _events2(data, starts, sizes, nr, cum, frid, E: int):
    """Per-event (rank, run length, bit count) on the [L, E] grid and the
    per-lane bit totals."""
    n = data.shape[0]
    L = starts.shape[0]
    dev = data.device
    ev_start_g = torch.nonzero(nr)[:, 0]
    RC = ev_start_g.shape[0]
    ev_char_g = data[ev_start_g].long()
    frid_ext = torch.cat([frid, cum[-1:]])
    nruns = frid_ext[1:] - frid_ext[:-1]

    ecol = torch.arange(E, device=dev)[None, :]
    rc = (frid[:, None] + ecol).clamp(0, RC - 1)
    evalid = ecol < nruns[:, None]
    ev_start = torch.where(evalid, ev_start_g[rc], 0)
    ev_char = torch.where(evalid, ev_char_g[rc], -1)
    lane_end = (starts + sizes)[:, None]
    nxt = torch.zeros_like(ev_start)
    nxt[:, :-1] = ev_start[:, 1:]
    last_ev = ecol == (nruns[:, None] - 1)
    ev_len = torch.where(last_ev, lane_end - ev_start, nxt - ev_start)
    ev_len = torch.where(evalid, ev_len, 1)

    # previous occurrence of each event's own char: sort by (char, event)
    okey = torch.where(evalid, ev_char * E + ecol, torch.iinfo(torch.int64).max)
    co = torch.sort(okey, dim=1, stable=True).indices
    ch_s = ev_char.gather(1, co)
    prev_s = torch.full_like(co, -1)
    prev_s[:, 1:] = co[:, :-1]
    same = torch.zeros_like(evalid)
    same[:, 1:] = ch_s[:, 1:] == ch_s[:, :-1]
    prev_own = torch.empty_like(co)
    prev_own.scatter_(1, co, torch.where(same, prev_s, -1))

    rank = torch.zeros_like(ev_char)
    s_all = torch.zeros_like(ev_char)
    s_lt = torch.zeros_like(ev_char)
    lastd = torch.full_like(ev_char, -1)
    present = torch.nonzero(torch.bincount(data.long(), minlength=256))[:, 0]
    for d in present.tolist():  # absent chars contribute nothing
        occ = torch.where(ev_char == d, ecol, -1)
        lastd[:, 1:] = torch.cummax(occ, 1).values[:, :-1]
        rank += lastd > prev_own
        seen = lastd >= 0
        s_all += seen
        s_lt += seen & (d < ev_char)
    rank = torch.where(prev_own < 0, s_all + ev_char - s_lt, rank)
    rank = torch.where(evalid, rank, 0)

    brs = torch.where(rank > 0, _bitlen(rank), 0)
    has_u = ev_len != 1
    ubrs = torch.where(has_u, _bitlen(ev_len), 0)
    rlen = torch.where(rank > 0, (brs - 1) + (brs < W.RANK_EXP_CAP).long(), 0)
    rmlen = torch.where(rank > 0, brs - 1, 0)
    ulen = torch.where(has_u, (ubrs - 1) + (ubrs < W.RUN_EXP_CAP).long(), 0)
    umlen = torch.where(has_u, ubrs - 1, 0)
    B = torch.where(evalid, 1 + rlen + rmlen + 1 + ulen + umlen, 0)
    total = B.sum(1)
    return rank, ev_len, B, total


def _expand2(rank, ev_len, B, total, IT: int) -> torch.Tensor:
    """Packed planes u8 [L, IT/4] from the per-event values."""
    L = rank.shape[0]
    dev = rank.device
    out = torch.empty((L, IT // 4), dtype=torch.uint8, device=dev)
    it = torch.arange(IT, device=dev)[None, :]
    for lo in range(0, L, _LANE_CHUNK):
        sl = slice(lo, lo + _LANE_CHUNK)
        rk, ln, b, tot = rank[sl], ev_len[sl], B[sl], total[sl]
        S = b.cumsum(1) - b
        ubrs = torch.where(ln != 1, _bitlen(ln), 0)
        cols = torch.where(b > 0, S, IT)  # empty events land in a dropped column

        def fill(word):
            z = torch.zeros((rk.shape[0], IT + 1), dtype=torch.int64,
                            device=dev)
            z.scatter_(1, cols, word)
            return torch.cummax(z[:, :IT], 1).values

        A = fill((S << _S_SHIFT) | (rk << 6) | ubrs)
        Bw = fill((S << 32) | ln)
        j = it - (A >> _S_SHIFT)
        rk_g = (A >> 6) & 0xFF
        ubrs_g = A & 0x3F
        rn_g = Bw & 0xFFFFFFFF

        brs_g = torch.where(rk_g > 0, _bitlen(rk_g), 0)
        rlen_g = torch.where(rk_g > 0,
                             (brs_g - 1) + (brs_g < W.RANK_EXP_CAP).long(), 0)
        rmlen_g = torch.where(rk_g > 0, brs_g - 1, 0)
        ulen_g = torch.where(rn_g != 1,
                             (ubrs_g - 1) + (ubrs_g < W.RUN_EXP_CAP).long(), 0)
        uoff_g = 1 + rlen_g + rmlen_g
        in_re = (j >= 1) & (j < 1 + rlen_g)
        in_rm = (j >= 1 + rlen_g) & (j < uoff_g)
        in_ue = (j >= uoff_g + 1) & (j < uoff_g + 1 + ulen_g)
        in_um = j >= uoff_g + 1 + ulen_g
        t_rm = j - (1 + rlen_g)
        t_um = j - (uoff_g + 1 + ulen_g)
        bit = torch.where(j == 0, (rk_g > 0).long(), 0)
        bit = torch.where(in_re, ((j - 1) < (brs_g - 1)).long(), bit)
        bit = torch.where(in_rm, (rk_g >> (brs_g - 2 - t_rm).clamp(min=0)) & 1,
                          bit)
        bit = torch.where(j == uoff_g, (rn_g != 1).long(), bit)
        bit = torch.where(in_ue, ((j - uoff_g - 1) < (ubrs_g - 1)).long(),
                          bit)
        bit = torch.where(in_um, (rn_g >> (ubrs_g - 2 - t_um).clamp(min=0)) & 1,
                          bit)
        fld = torch.where(it < tot[:, None], bit | 2, 0)
        f4 = fld.view(-1, IT // 4, 4)
        out[sl] = (f4[..., 0] | (f4[..., 1] << 2) | (f4[..., 2] << 4)
                   | (f4[..., 3] << 6)).to(torch.uint8)
    return out


def device_schedule_v2(data: torch.Tensor, sizes, L: int, it_bucket=None):
    """Packed per-lane iteration planes u8 [L, IT/4] (on data's device)
    and max_bits.  ``sizes`` is the lane table (host array or tensor).
    Returns (None, -1) when the block takes the host walker instead: a run
    of 2^RUN_EXP_CAP bytes or more, an [L, E] event grid past 2^27, or an
    iteration count at or past the packing cap."""
    n = data.shape[0]
    sizes_d = torch.as_tensor(sizes).to(device=data.device,
                                        dtype=torch.int64)
    starts = sizes_d.cumsum(0) - sizes_d
    stats, nr, cum, frid = _stats(data, starts)
    _R, maxpl, maxrun = stats.tolist()
    if maxrun >= (1 << W.RUN_EXP_CAP):
        return None, -1
    E = _bucket(max(maxpl, 256), 256)
    if L * E > (1 << 27):
        return None, -1
    rank, ev_len, B, total = _events2(data, starts, sizes_d, nr, cum, frid,
                                      E)
    max_bits = int(total.max())
    IT = it_bucket(max_bits) if it_bucket else _bucket(max(max_bits, 256),
                                                       256)
    if IT >= _IT_CAP:
        return None, -1
    return _expand2(rank, ev_len, B, total, IT), max_bits


def device_schedule(data: torch.Tensor, sizes, L: int, it_bucket=None):
    """Packed per-lane iteration planes u8 [L, IT/4] (on data's device)
    and max_bits for the lane table ``sizes`` (int32[L], summing to at
    most n; bytes past the table are not coded), the planes of the JAX
    package's v1 ``device_schedule`` and of the native walker.

    The JAX v1 pads [L, C] planes to the largest lane and runs 256
    running-max passes over them; this builds the same planes from the v2
    pieces (:func:`_events2`, :func:`_expand2`) on the [L, E] event grid.
    Unlike :func:`device_schedule_v2` it refuses no block: v1 has no
    packing cap, and the int64 event words here need none.
    ``it_bucket(max_bits) -> IT`` picks the plane length (default: a power
    of two from 256)."""
    sizes_np = np.asarray(sizes, dtype=np.int64)
    n = int(sizes_np.sum())
    if sizes_np.shape != (L,) or n > data.shape[0]:
        raise ValueError("sizes must hold one entry per lane and sum to at "
                         "most the block's length")
    data = data[:n]
    sizes_d = torch.from_numpy(sizes_np).to(data.device)
    starts = sizes_d.cumsum(0) - sizes_d
    stats, nr, cum, frid = _stats(data, starts)
    E = _bucket(max(int(stats[1]), 256), 256)
    rank, ev_len, B, total = _events2(data, starts, sizes_d, nr, cum, frid,
                                      E)
    max_bits = int(total.max())
    IT = it_bucket(max_bits) if it_bucket else _bucket(max(max_bits, 256),
                                                       256)
    return _expand2(rank, ev_len, B, total, IT), max_bits
