"""Device lane balancing and bit schedule for CODER_QLFC_WIDE.

From the transformed block (on the device) and the lane table, build the
per-lane packed 2-bit (bit | active) iteration planes that K1 and K2
consume, the same planes as the native walker (tbsc_wide_schedule_packed):

1. run boundaries on the flat block (lane starts force one): the run
   starts, the run count, the most runs in a lane and the longest run
   (:func:`lane_runs`, torch), which decide the refusals below;
2. K9 (:func:`schedule_events`, ``csrc/wide_schedule.cu``): from the run
   starts, for every run, in global run order, its move-to-front rank,
   its length, its bit count and its first bit in its lane, and each
   lane's bit total;
3. K10 (:func:`schedule_planes`, the same source): the packed planes
   u8 [L, IT/4] from those, fields past a lane's total 0.

The kernels launch for CUDA tensors and count their launches in
``LAUNCHES``; for CPU tensors the wrappers run their plain versions, the
JAX package's XLA formulation ported op for op: the runs on an [L, E]
grid, MTF ranks without a table (one running-max pass per char present),
and an expansion that forward-fills one packed word per event with cummax
(:func:`_events2`, :func:`_expand2`).

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

from . import _cuda
from . import wide as W

_S_SHIFT = 14   # low bits of the event word: rank << 6 | run bit-length
_IT_CAP = 1 << 19  # the JAX package's v2 packing cap (32 - its 13-bit
# shift), kept so both packages send the same blocks to the host walker
_GRID_CAP = 1 << 27  # the most [L, E] event-grid cells v2 takes (the JAX
# package's limit; the kernels build no grid, but the refusal stays)
_LANE_CHUNK = 128  # lanes expanded at a time (bounds the [lanes, IT] temps)

LAUNCHES = {"sched_events": 0, "sched_planes": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _run_starts(data: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Run-start mask of the block: a byte that differs from the one
    before it, or a lane start."""
    n = data.shape[0]
    nr = torch.zeros(n, dtype=torch.bool, device=data.device)
    nr[starts[starts < n]] = True
    nr[0] = True
    nr[1:] |= data[1:] != data[:-1]
    return nr


def lane_runs(data: torch.Tensor, sizes: torch.Tensor):
    """The runs of the lane table ``sizes`` (int64 [L] on data's device;
    the lanes tile the block): (lane starts int64 [L], frid_ext int64
    [L + 1]: each lane's first global run id, then the run count R; R;
    the run starts int64 [R], K9's input; the most runs in a lane; the
    longest run).  From the run starts' positions, with two host syncs,
    not from running maxima: torch's cummax over a 1-D tensor on CUDA
    runs in one block and took 79 ms at 25 MiB."""
    n = data.shape[0]
    starts = sizes.cumsum(0) - sizes
    rs = torch.nonzero(_run_starts(data, starts))[:, 0]
    R = int(rs.shape[0])
    frid_ext = torch.cat([torch.searchsorted(rs, starts),  # a lane start
                          torch.full_like(rs[:1], R)])    # is a run start
    ends = torch.cat([rs[1:], torch.full_like(rs[:1], n)])
    maxpl, maxrun = torch.stack([(frid_ext[1:] - frid_ext[:-1]).max(),
                                 (ends - rs).max()]).tolist()
    return starts, frid_ext, R, rs, maxpl, maxrun


def _grid_width(maxpl: int) -> int:
    """E, the [L, E] event grid's width for a lane of ``maxpl`` runs."""
    return _bucket(max(maxpl, 256), 256)


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


def _check_i64(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous 1-D int64 "
                             "tensors")


def _device(name: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts) or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: inputs on different or unsupported "
                         "devices")
    return dev


def schedule_events(data: torch.Tensor, rs: torch.Tensor,
                    starts: torch.Tensor, sizes: torch.Tensor,
                    frid_ext: torch.Tensor):
    """K9.  For the lanes [starts[k], starts[k] + sizes[k]) of ``data``
    (the lanes tile the block), whose runs have the global ids
    ``frid_ext[k] .. frid_ext[k+1] - 1`` and start at ``rs`` (see
    :func:`lane_runs`): each run's move-to-front rank, length and bit
    count, int32 [R] each, each lane's bit total, int64 [L], and each
    run's first bit in its lane, int32 [R] (K10's input)."""
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError("schedule_events: data must be contiguous u8[n]")
    _check_i64("schedule_events", rs, starts, sizes, frid_ext)
    dev = _device("schedule_events", data, rs, starts, sizes, frid_ext)
    if dev.type == "cpu":
        return schedule_events_plain(data, starts, sizes, frid_ext)
    R, L = int(rs.shape[0]), int(starts.shape[0])
    rank, ev_len, B, S = (torch.empty(R, dtype=torch.int32, device=dev)
                          for _ in range(4))
    total = torch.empty(L, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.launcher("sched_events")(
            data.data_ptr(), rs.data_ptr(), starts.data_ptr(),
            sizes.data_ptr(), frid_ext.data_ptr(), L, rank.data_ptr(),
            ev_len.data_ptr(), B.data_ptr(), S.data_ptr(), total.data_ptr(),
            _cuda.stream_handle(dev))
    _cuda.check("sched_events", rc)
    LAUNCHES["sched_events"] += 1
    return rank, ev_len, B, total, S


def schedule_events_plain(data, starts, sizes, frid_ext):
    """K9's plain version: :func:`_events2` on the [L, E] grid, its valid
    cells read out in global run order, and each run's first bit (the
    exclusive sum of its lane's bit counts before it)."""
    nr = _run_starts(data, starts)
    nruns = frid_ext[1:] - frid_ext[:-1]
    E = _grid_width(int(nruns.max()))
    rank, ev_len, B, total = _events2(data, starts, sizes, nr,
                                      nr.cumsum(0), frid_ext[:-1], E)
    valid = torch.arange(E, device=data.device)[None, :] < nruns[:, None]
    S = B.cumsum(1) - B
    return (rank[valid].to(torch.int32), ev_len[valid].to(torch.int32),
            B[valid].to(torch.int32), total, S[valid].to(torch.int32))


def schedule_planes(rank: torch.Tensor, ev_len: torch.Tensor,
                    B: torch.Tensor, total: torch.Tensor, S: torch.Tensor,
                    frid_ext: torch.Tensor, IT: int) -> torch.Tensor:
    """K10.  Packed planes u8 [L, IT/4] from K9's per-run values (``S``:
    each run's first bit in its lane): each lane's events laid end to
    end from bit 0 in _expand2's bit order, fields at or past the lane's
    total 0.  IT is a multiple of 16 below 2^31; a lane's fields past IT
    are dropped."""
    for t in (rank, ev_len, B, S):
        if t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError("schedule_planes: per-run values must be "
                             "contiguous int32[R]")
    _check_i64("schedule_planes", total, frid_ext)
    if IT % 16 or IT >= 1 << 31:
        raise ValueError(f"schedule_planes: IT {IT} is not a multiple of "
                         "16 below 2^31")
    dev = _device("schedule_planes", rank, ev_len, B, total, S, frid_ext)
    if dev.type == "cpu":
        return schedule_planes_plain(rank, ev_len, B, total, S, frid_ext,
                                     IT)
    L = int(total.shape[0])
    out = torch.empty((L, IT // 4), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.launcher("sched_planes")(
            rank.data_ptr(), ev_len.data_ptr(), S.data_ptr(),
            total.data_ptr(), frid_ext.data_ptr(), L, IT // 16,
            out.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check("sched_planes", rc)
    LAUNCHES["sched_planes"] += 1
    return out


def schedule_planes_plain(rank, ev_len, B, total, S, frid_ext,
                          IT: int) -> torch.Tensor:
    """K10's plain version: the per-run values back on the [L, E] grid,
    then :func:`_expand2`, which sums each run's first bit from ``B`` as
    the JAX program does (``S`` is not read)."""
    dev = rank.device
    nruns = frid_ext[1:] - frid_ext[:-1]
    E = _grid_width(int(nruns.max()))
    col = torch.arange(E, device=dev)[None, :]
    valid = col < nruns[:, None]
    idx = (frid_ext[:-1, None] + col).clamp(max=rank.shape[0] - 1)

    def grid(v, fill):
        return torch.where(valid, v.long()[idx], fill)

    return _expand2(grid(rank, 0), grid(ev_len, 1), grid(B, 0), total, IT)


def _plane_length(max_bits: int, it_bucket) -> int:
    return it_bucket(max_bits) if it_bucket else _bucket(max(max_bits, 256),
                                                         256)


def device_schedule_v2(data: torch.Tensor, sizes, L: int, it_bucket=None):
    """Packed per-lane iteration planes u8 [L, IT/4] (on data's device)
    and max_bits.  ``sizes`` is the lane table (host array or tensor,
    summing to n).  Returns (None, -1) when the block takes the host
    walker instead: a run of 2^RUN_EXP_CAP bytes or more, an [L, E] event
    grid past 2^27 cells (E: the most runs in a lane, bucketed), or an
    iteration count at or past the packing cap."""
    sizes_d = torch.as_tensor(sizes).to(device=data.device,
                                        dtype=torch.int64)
    starts, frid_ext, _, rs, maxpl, maxrun = lane_runs(data, sizes_d)
    if maxrun >= (1 << W.RUN_EXP_CAP):
        return None, -1
    if L * _grid_width(maxpl) > _GRID_CAP:
        return None, -1
    ev = schedule_events(data, rs, starts, sizes_d, frid_ext)
    max_bits = int(ev[3].max())
    IT = _plane_length(max_bits, it_bucket)
    if IT >= _IT_CAP:
        return None, -1
    return schedule_planes(*ev, frid_ext, IT), max_bits


def device_schedule(data: torch.Tensor, sizes, L: int, it_bucket=None):
    """Packed per-lane iteration planes u8 [L, IT/4] (on data's device)
    and max_bits for the lane table ``sizes`` (int32[L], summing to at
    most n; bytes past the table are not coded), the planes of the JAX
    package's v1 ``device_schedule`` and of the native walker.

    The JAX v1 pads [L, C] planes to the largest lane and runs 256
    running-max passes over them; this runs the v2 pieces (K9, K10).
    Unlike :func:`device_schedule_v2` it refuses no block: v1 has no
    packing cap, and K10 takes any plane length.
    ``it_bucket(max_bits) -> IT`` picks the plane length (default: a power
    of two from 256)."""
    sizes_np = np.asarray(sizes, dtype=np.int64)
    n = int(sizes_np.sum())
    if sizes_np.shape != (L,) or n > data.shape[0]:
        raise ValueError("sizes must hold one entry per lane and sum to at "
                         "most the block's length")
    data = data[:n]
    sizes_d = torch.from_numpy(sizes_np).to(data.device)
    starts, frid_ext, _, rs, _, _ = lane_runs(data, sizes_d)
    ev = schedule_events(data, rs, starts, sizes_d, frid_ext)
    max_bits = int(ev[3].max())
    IT = _plane_length(max_bits, it_bucket)
    return schedule_planes(*ev, frid_ext, IT), max_bits
