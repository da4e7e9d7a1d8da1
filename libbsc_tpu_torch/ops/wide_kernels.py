"""The wide coder on the card: kernels K1 (model), K2 (rANS encode) and K3
(decode), their plain PyTorch versions, and the host stages around them.

Encode: the lane table and the per-lane bit schedule (packed 2-bit
``bit | active`` fields, planes ``u8 [IT/4, 1024]``, lane = group * 128 +
lane-in-group) come from the native host walker (:func:`device_encode`)
or from the device schedule (:func:`device_encode_resident`).  K1 runs
each lane's model forward and writes the probability plane; K2 walks the
planes backward doing binary rANS and leaves each group's units, in the
decoder's consumption order, at the end of the group's buffer;
:func:`_assemble_rans` builds the payload (``ops/wide.py`` of the JAX
package specifies it).

Decode: :func:`_dec_parse` reads the payload, :func:`_prep` cuts the unit
stream into per-group segments and warm-up words, and K3 decodes every
lane straight into its span of the output block.

Each kernel wrapper launches its CUDA kernel for CUDA tensors (and counts
the launch in ``LAUNCHES``) and runs its plain version for CPU tensors.
u32 coder state is carried in int32 tensors (bit pattern) between stages
and in int64 inside the plain versions, because torch's CPU backend has no
uint32 shifts or compares.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .. import tables
from . import _cuda
from . import wide as W

GROUPS = 8
LANES = GROUPS * W.GROUP  # the kernels' lane count
TI = 256                  # iteration-bucket granule

LAUNCHES = {"wide_model": 0, "wide_rans": 0, "wide_decode": 0}

_PH_RFLAG, _PH_REXP, _PH_RMAN, _PH_UFLAG, _PH_UEXP, _PH_UMAN, _PH_DONE = \
    range(7)
_RM_OFF = (0, 0, 0, 1, 4, 11, 26, 41, 56)
_SINK = 511  # context of an inactive lane; never adapted


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_priors_cache: dict = {}


def priors_tensor(device) -> torch.Tensor:
    """The installed priors as int32[281] on ``device``."""
    device = torch.device(device)
    arrays = tables.current()
    hit = _priors_cache.get(str(device))
    if hit is None or hit[0] is not arrays:
        hit = (arrays, torch.from_numpy(tables.priors()).to(device))
        _priors_cache[str(device)] = hit
    return hit[1]


def u32_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def i32_to_u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def _check(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _same_device(name: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# the lane state machine, vectorized over lanes (plain versions)
# ---------------------------------------------------------------------------

def _fresh_state(phase: torch.Tensor):
    z = torch.zeros_like(phase)
    return [phase.clone()] + [z.clone() for _ in range(8)]


def _sm_ctx(st, active):
    phase, t, brs, val, rank, rh, uh, prb, pub = st
    rmoff = torch.tensor(_RM_OFF, device=phase.device)[brs.clamp(0, 8)]
    rankb = torch.where(rank == 0, 0, torch.where(rank <= 2, 1, 2))
    ctx = torch.where(
        phase == _PH_RFLAG, rh,
        torch.where(phase == _PH_REXP, 16 + 7 * prb + 21 * (rh & 1) + t - 1,
        torch.where(phase == _PH_RMAN,
                    58 + rmoff + torch.clamp(val - 1, max=14),
        torch.where(phase == _PH_UFLAG, 129 + 3 * uh + rankb,
        torch.where(phase == _PH_UEXP, 177 + 24 * pub + t - 1,
                    249 + 16 * (brs > 3).long()
                    + torch.clamp(val, max=15))))))
    return torch.where(active, ctx, _SINK)


def _b3(x):
    return torch.where(x <= 1, 0, torch.where(x <= 3, 1, 2))


def _sm_next(st, bit, active):
    """One transition given the coded bit (a lane freezes while inactive).
    Returns (next state, run-completed mask, run length)."""
    phase, t, brs, val, rank, rh, uh, prb, pub = st
    w = torch.where
    is_rf = active & (phase == _PH_RFLAG)
    is_re = active & (phase == _PH_REXP)
    is_rm = active & (phase == _PH_RMAN)
    is_uf = active & (phase == _PH_UFLAG)
    is_ue = active & (phase == _PH_UEXP)
    is_um = active & (phase == _PH_UMAN)
    one, zero = bit == 1, bit == 0

    nrh = w(is_rf, ((rh << 1) | bit) & 0xF, rh)
    nuh = w(is_uf, ((uh << 1) | bit) & 0xF, uh)
    b3 = _b3(brs)
    shifted = (val << 1) | bit
    um_done = is_um & (t + 1 == brs - 1)
    comp1 = is_uf & zero
    comp = comp1 | um_done
    runlen = w(comp1, 1, shifted)

    np_, nt, nbrs, nval, nrank, nprb, npub = phase, t, brs, val, rank, prb, pub
    np_ = w(is_rf & one, _PH_REXP, np_)
    nt = w(is_rf & one, 1, nt)
    nbrs = w(is_rf & one, 1, nbrs)
    np_ = w(is_rf & zero, _PH_UFLAG, np_)
    nrank = w(is_rf & zero, 0, nrank)
    nprb = w(is_rf & zero, 0, nprb)

    re_cont = is_re & one
    hit_cap = re_cont & (brs + 1 == W.RANK_EXP_CAP)
    np_ = w(hit_cap, _PH_RMAN, np_)
    nval = w(hit_cap, 1, nval)
    nprb = w(hit_cap, _b3(brs + 1), nprb)
    nbrs = w(re_cont, brs + 1, nbrs)
    nt = w(re_cont & ~hit_cap, t + 1, nt)
    nt = w(hit_cap, 0, nt)
    re_stop = is_re & zero
    nprb = w(re_stop, b3, nprb)
    one_rank = re_stop & (brs == 1)
    np_ = w(one_rank, _PH_UFLAG, np_)
    nrank = w(one_rank, 1, nrank)
    rm_multi = re_stop & (brs != 1)
    np_ = w(rm_multi, _PH_RMAN, np_)
    nval = w(rm_multi, 1, nval)
    nt = w(rm_multi, 0, nt)

    rm_done = is_rm & (t + 1 == brs - 1)
    nval = w(is_rm, shifted, nval)
    nt = w(is_rm & ~rm_done, t + 1, nt)
    np_ = w(rm_done, _PH_UFLAG, np_)
    nrank = w(rm_done, shifted, nrank)

    np_ = w(is_uf & one, _PH_UEXP, np_)
    nt = w(is_uf & one, 1, nt)
    nbrs = w(is_uf & one, 1, nbrs)
    npub = w(comp1, 0, npub)

    ue_cont = is_ue & one
    ue_cap = ue_cont & (brs + 1 == W.RUN_EXP_CAP)
    nbrs = w(ue_cont, brs + 1, nbrs)
    nt = w(ue_cont & ~ue_cap, t + 1, nt)
    npub = w(ue_cap, _b3(brs + 1), npub)
    np_ = w(ue_cap, _PH_UMAN, np_)
    nval = w(ue_cap, 1, nval)
    nt = w(ue_cap, 0, nt)
    ue_stop = is_ue & zero
    npub = w(ue_stop, b3, npub)
    np_ = w(ue_stop, _PH_UMAN, np_)
    nval = w(ue_stop, 1, nval)
    nt = w(ue_stop, 0, nt)

    nval = w(is_um, shifted, nval)
    nt = w(is_um & ~um_done, t + 1, nt)
    np_ = w(comp, _PH_RFLAG, np_)
    return [np_, nt, nbrs, nval, nrank, nrh, nuh, nprb, npub], comp, runlen


def _adapt(p, bit):
    return torch.where(bit == 1, p - (p >> 5), p + ((4096 - p) >> 5))


def _fields(planes: torch.Tensor, i: int) -> torch.Tensor:
    return (planes[i >> 2].long() >> ((i & 3) * 2)) & 3


# ---------------------------------------------------------------------------
# K1: model pass
# ---------------------------------------------------------------------------

def model_probs(planes: torch.Tensor, max_bits: int) -> torch.Tensor:
    """K1.  planes: u8 [IT/4, 1024] with 4 * IT/4 >= max_bits.  Returns the
    probability plane i32 [IT, 1024]: the 12-bit probability each active
    lane coded its bit with, 0 where a lane is inactive."""
    rows = planes.shape[0]
    _check(planes, torch.uint8, (rows, LANES), "planes")
    if not 0 <= max_bits <= 4 * rows:
        raise ValueError("max_bits exceeds the planes")
    dev = _same_device("model_probs", planes)
    if dev.type == "cpu":
        return model_probs_plain(planes, max_bits)
    probs = torch.empty((4 * rows, LANES), dtype=torch.int32, device=dev)
    probs[max_bits:] = 0
    pri = priors_tensor(dev)
    fn = _cuda.launcher("wide_model")
    rc = fn(planes.data_ptr(), max_bits, pri.data_ptr(), probs.data_ptr(),
            _cuda.stream_handle(dev))
    _cuda.check("wide_model", rc)
    LAUNCHES["wide_model"] += 1
    return probs


def model_probs_plain(planes: torch.Tensor, max_bits: int) -> torch.Tensor:
    dev = planes.device
    probs = torch.zeros((4 * planes.shape[0], LANES), dtype=torch.int32,
                        device=dev)
    model = torch.zeros((LANES, 512), dtype=torch.int64, device=dev)
    model[:, :W.NCTX] = priors_tensor(dev).long()
    st = _fresh_state(torch.full((LANES,), _PH_RFLAG, dtype=torch.int64,
                                 device=dev))
    for i in range(max_bits):
        fld = _fields(planes, i)
        bit, active = fld & 1, (fld & 2) != 0
        ctx = _sm_ctx(st, active)[:, None]
        p = model.gather(1, ctx)[:, 0]
        probs[i] = p.to(torch.int32)
        model.scatter_(1, ctx, torch.where(active, _adapt(p, bit), p)[:, None])
        st, _, _ = _sm_next(st, bit, active)
    return probs


# ---------------------------------------------------------------------------
# K2: rANS encode
# ---------------------------------------------------------------------------

def rans_encode(planes: torch.Tensor, probs: torch.Tensor, max_bits: int):
    """K2.  Returns (units i32 [8, cap], counts i32 [8], fx i32 [1024]):
    group g's stream units, in consumption order, are
    units[g, cap - counts[g]:]; fx holds every lane's final state (u32 bit
    pattern), the warm-up words of the live lanes."""
    rows = planes.shape[0]
    _check(planes, torch.uint8, (rows, LANES), "planes")
    _check(probs, torch.int32, (4 * rows, LANES), "probs")
    if not 0 <= max_bits <= 4 * rows:
        raise ValueError("max_bits exceeds the planes")
    dev = _same_device("rans_encode", planes, probs)
    cap = W.GROUP * max(max_bits, 1)  # at most one unit per lane-iteration
    if dev.type == "cpu":
        return rans_encode_plain(planes, probs, max_bits, cap)
    units = torch.empty((GROUPS, cap), dtype=torch.int32, device=dev)
    counts = torch.empty(GROUPS, dtype=torch.int32, device=dev)
    fx = torch.empty(LANES, dtype=torch.int32, device=dev)
    fn = _cuda.launcher("wide_rans")
    rc = fn(planes.data_ptr(), probs.data_ptr(), max_bits, cap,
            units.data_ptr(), counts.data_ptr(), fx.data_ptr(),
            _cuda.stream_handle(dev))
    _cuda.check("wide_rans", rc)
    LAUNCHES["wide_rans"] += 1
    return units, counts, fx


def rans_encode_plain(planes, probs, max_bits: int, cap: int):
    dev = planes.device
    units = torch.zeros((GROUPS, cap), dtype=torch.int32, device=dev)
    cursor = torch.full((GROUPS,), cap, dtype=torch.int64, device=dev)
    x = torch.full((LANES,), 1 << 16, dtype=torch.int64, device=dev)
    rows = torch.arange(GROUPS, device=dev)[:, None].expand(GROUPS, W.GROUP)
    for i in range(max_bits - 1, -1, -1):
        fld = _fields(planes, i)
        bit, active = fld & 1, (fld & 2) != 0
        p = probs[i].long()
        f = torch.where(active, torch.where(bit == 1, 4096 - p, p), 1)
        ren = active & (x >= (f << 20))
        unit = x & 0xFFFF
        x2 = torch.where(ren, x >> 16, x)
        x3 = ((x2 // f) << 12) + x2 % f + torch.where(bit == 1, p, 0)
        x = torch.where(active, x3, x)
        ren2 = ren.view(GROUPS, W.GROUP)
        m = ren2.sum(1)
        slot = cursor[:, None] - m[:, None] + (ren2.cumsum(1) - ren2.long())
        units[rows[ren2], slot[ren2]] = unit.view(GROUPS, W.GROUP)[ren2] \
            .to(torch.int32)
        cursor -= m
    counts = (cap - cursor).to(torch.int32)
    return units, counts, u32_to_i32(x)


# ---------------------------------------------------------------------------
# K3: decode
# ---------------------------------------------------------------------------

def decode_lanes(warm, goff, lane_sz, lstart, stream, max_bits: int,
                 n: int) -> torch.Tensor:
    """K3.  warm: i32 [1024] initial states (u32 bit pattern); goff,
    lane_sz, lstart: i32 [1024] (first unit after the warm-up pairs, lane
    sizes, absolute lane starts); stream: i32 [8, S] per-group unit
    segments.  Returns the decoded block u8 [n]."""
    for t, name in ((warm, "warm"), (goff, "goff"), (lane_sz, "lane_sz"),
                    (lstart, "lstart")):
        _check(t, torch.int32, (LANES,), name)
    _check(stream, torch.int32, (GROUPS, stream.shape[1]), "stream")
    dev = _same_device("decode_lanes", warm, goff, lane_sz, lstart, stream)
    if dev.type == "cpu":
        return decode_lanes_plain(warm, goff, lane_sz, lstart, stream,
                                  max_bits, n)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    pri = priors_tensor(dev)
    fn = _cuda.launcher("wide_decode")
    rc = fn(warm.data_ptr(), goff.data_ptr(), lane_sz.data_ptr(),
            lstart.data_ptr(), stream.data_ptr(), int(stream.shape[1]),
            max_bits, pri.data_ptr(), out.data_ptr(),
            _cuda.stream_handle(dev))
    _cuda.check("wide_decode", rc)
    LAUNCHES["wide_decode"] += 1
    return out


def decode_lanes_plain(warm, goff, lane_sz, lstart, stream, max_bits: int,
                       n: int) -> torch.Tensor:
    dev = warm.device
    S = int(stream.shape[1])
    left = lane_sz.long()
    st = _fresh_state(torch.where(left > 0, _PH_RFLAG, _PH_DONE))
    x = i32_to_u32(warm)
    cursor = goff.long().view(GROUPS, W.GROUP)[:, 0].clone()
    pos = lstart.long().clone()
    model = torch.zeros((LANES, 512), dtype=torch.int64, device=dev)
    model[:, :W.NCTX] = priors_tensor(dev).long()
    mtf = torch.arange(256, device=dev).repeat(LANES, 1)
    col = torch.arange(256, device=dev)[None, :]
    srcs, syms, lens = [], [], []
    for _ in range(max_bits):
        active = st[0] != _PH_DONE
        if not bool(active.any()):
            break
        ctx = _sm_ctx(st, active)[:, None]
        p = model.gather(1, ctx)[:, 0]
        slot, hi = x & 0xFFF, x >> 12
        bit = ((slot >= p) & active).long()
        x1 = torch.where(bit == 1, (4096 - p) * hi + slot - p, p * hi + slot)
        x1 = torch.where(active, x1, x)
        ren = active & (x1 < (1 << 16))
        model.scatter_(1, ctx, torch.where(active, _adapt(p, bit), p)[:, None])

        ren2 = ren.view(GROUPS, W.GROUP)
        at = cursor[:, None] + ren2.cumsum(1) - ren2.long()
        unit = torch.where(at < S, stream.gather(1, at.clamp(max=S - 1)), 0)
        x = torch.where(ren, (x1 << 16) | (unit.view(-1).long() & 0xFFFF), x1)
        cursor += ren2.sum(1)

        st, comp, runlen = _sm_next(st, bit, active)
        if bool(comp.any()):
            rank = st[4]
            sym = mtf.gather(1, rank.clamp(0, 255)[:, None])[:, 0]
            shift = comp[:, None] & (col >= 1) & (col <= rank[:, None])
            mtf = torch.where(shift, mtf.roll(1, dims=1), mtf)
            mtf[:, 0] = torch.where(comp, sym, mtf[:, 0])
            run = torch.minimum(runlen, left)
            srcs.append(pos[comp])
            syms.append(sym[comp])
            lens.append(run[comp])
            pos = torch.where(comp, pos + run, pos)
            left = torch.where(comp, left - run, left)
            st[0] = torch.where(comp & (left <= 0), _PH_DONE, st[0])
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    if srcs:
        start, sym, run = torch.cat(srcs), torch.cat(syms), torch.cat(lens)
        first = torch.repeat_interleave(start - (run.cumsum(0) - run), run)
        idx = first + torch.arange(int(run.sum()), device=dev)
        out[idx] = torch.repeat_interleave(sym, run).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# encode: host and device stages around K1 and K2
# ---------------------------------------------------------------------------

def _it_bucket(max_bits: int, ti: int = TI) -> int:
    """Iteration-count bucket: ~1.25x geometric steps rounded up to a TI
    multiple (the JAX package's program-shape ladder, kept for its plane
    shapes)."""
    it = ti
    while it < max_bits:
        it = -(-(it * 5 // 4) // ti) * ti
    return it


def host_schedule_packed(buf: np.ndarray, n: int, sizes_p, chunk: int):
    """Native host walker with adaptive per-lane capacity: starts at 4 bits
    per byte of the average lane; on overflow the walker returns
    -(needed_bits)-1 and one retry sizes the buffer exactly.

    Returns (pk [LANES, cap4] u8, max_bits); max_bits < 0 = not encodable.
    """
    from .. import native

    lib = native.load()
    cap4 = max(1024, chunk)
    hard = 17 * (16 * chunk) // 4 + 64
    while True:
        pk = np.zeros((LANES, cap4), dtype=np.uint8)
        max_bits = lib.tbsc_wide_schedule_packed(native.u8p(buf), n, LANES,
                                                 cap4, native.u8p(pk),
                                                 sizes_p)
        if max_bits >= 0 or cap4 >= hard:
            return pk, max_bits
        needed4 = (-max_bits - 1 + 3) // 4 + 16
        cap4 = min(max(needed4, cap4 + 1), hard)


def _host_prep(data: bytes):
    """Host stage of the per-stage encode: native lane balancing and
    schedule walk.  Returns (planes u8 [IT/4, 1024] ndarray, sizes or None,
    max_bits, IT), or None when the block does not take the kernels."""
    from .. import native

    n = len(data)
    if n < LANES:
        return None
    lib = native.load()
    chunk = -(-n // LANES)
    if chunk >= (1 << W.RUN_EXP_CAP):
        return None
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    sizes = np.zeros(LANES, dtype=np.int32)
    sizes_p = None
    if lib.tbsc_wide_balanced_sizes(native.u8p(buf), n, LANES,
                                    native.i32p(sizes)) == 0:
        sizes_p = native.i32p(sizes)
    else:
        sizes = None
    pk, max_bits = host_schedule_packed(buf, n, sizes_p, chunk)
    if max_bits < 0:
        return None
    IT = _it_bucket(max(max_bits, TI))
    if pk.shape[1] < IT // 4:
        pk = np.pad(pk, ((0, 0), (0, IT // 4 - pk.shape[1])))
    planes = np.ascontiguousarray(pk[:, : IT // 4].T)
    return planes, sizes, max_bits, IT


def _submit(prep, device):
    """K1 + K2 on the prepared planes (asynchronous on the card)."""
    planes, sizes, max_bits, _IT = prep
    planes_d = torch.as_tensor(planes).to(device)
    probs = model_probs(planes_d, max_bits)
    units, counts, fx = rans_encode(planes_d, probs, max_bits)
    return units, counts, fx, sizes, max_bits


def _collect(n: int, inflight):
    units, counts, fx, sizes, max_bits = inflight
    return _assemble_rans(n, units, counts, fx, sizes, max_bits)


def device_encode(data: bytes, device="cuda"):
    """Wide encode with the coder on ``device``: native lane table and
    schedule, then K1 and K2.  Returns the payload (the native codec's
    bytes for the same lane table), or None when the block does not take
    the kernels or is not compressible."""
    prep = _host_prep(data)
    if prep is None:
        return None
    return _collect(len(data), _submit(prep, device))


def _assemble_rans(n: int, units: torch.Tensor, counts: torch.Tensor,
                   fx: torch.Tensor, lane_sz=None, max_bits: int = 0):
    """Payload from K2's output: per group, the warm-up pair (final state
    hi, lo) of each live lane in lane order, then the group's units.  The
    streams are joined on the device and cross to the host once."""
    sizes = (np.asarray(lane_sz, dtype=np.int64) if lane_sz is not None
             else np.asarray(W.lane_sizes(n, LANES), dtype=np.int64))
    cap = int(units.shape[1])
    cnt = counts.cpu().tolist()
    live = sizes > 0
    x = i32_to_u32(fx)
    warm = torch.stack([x >> 16, x & 0xFFFF], dim=1)
    live_d = torch.from_numpy(live).to(fx.device)
    parts, gunits = [], []
    for g in range(GROUPS):
        lo, hi = g * W.GROUP, (g + 1) * W.GROUP
        parts.append(warm[lo:hi][live_d[lo:hi]].reshape(-1))
        parts.append(units[g, cap - cnt[g]:].long())
        gunits.append(2 * int(live[lo:hi].sum()) + cnt[g])
    stream = torch.cat(parts).cpu().numpy().astype("<u2")
    payload = struct.pack("<IHHI", n, LANES,
                          (1 if lane_sz is not None else 0) | 2 | 4,
                          max_bits)
    if lane_sz is not None:
        payload += sizes.astype("<u4").tobytes()
    payload += np.asarray(gunits, dtype="<u4").tobytes()
    payload += stream.tobytes()
    if len(payload) >= n:
        return None
    return payload


def resident_prep(u_dev: torch.Tensor):
    """Device stage of the fused encode: device lane balancer and device
    bit schedule.  Returns (planes u8 [IT/4, 1024] on the device, sizes
    int32[1024] ndarray, max_bits, IT), or None when the block does not
    take this route (too small, a run too long, a schedule the event grid
    cannot hold)."""
    from . import wide_schedule

    n = int(u_dev.shape[0])
    if n < LANES:
        return None
    if -(-n // LANES) >= (1 << W.RUN_EXP_CAP):
        return None
    sizes_d = wide_schedule.device_balanced_sizes(u_dev, LANES)
    packed, max_bits = wide_schedule.device_schedule_v2(
        u_dev, sizes_d, LANES, it_bucket=lambda mb: _it_bucket(max(mb, TI)))
    if packed is None or max_bits < 0:
        return None
    IT = _it_bucket(max(max_bits, TI))
    planes = packed[:, : IT // 4].t().contiguous()
    return planes, sizes_d.cpu().numpy().astype(np.int32), max_bits, IT


def submit_resident(u_dev: torch.Tensor):
    """Wide encode of a transformed block already on the device:
    :func:`resident_prep`, then K1 and K2.  Returns the in-flight state for
    :func:`collect_resident`, or None when the block does not take this
    route."""
    prep = resident_prep(u_dev)
    if prep is None:
        return None
    return int(u_dev.shape[0]), _submit(prep, u_dev.device)


def collect_resident(inflight):
    if inflight is None:
        return None
    n, sub = inflight
    return _collect(n, sub)


def device_encode_resident(u_dev: torch.Tensor):
    """submit_resident + collect_resident in one call."""
    return collect_resident(submit_resident(u_dev))


# ---------------------------------------------------------------------------
# decode: parse and prologue around K3
# ---------------------------------------------------------------------------

def _prep(units: torch.Tensor, gunits: torch.Tensor, lane_sz: torch.Tensor,
          UT: int, SROWS: int):
    """Cut the flat unit stream into the decoder's per-group segments and
    extract the warm-up words: units i32 [UT] (u16 values, zero tail),
    gunits i32 [8], lane_sz i32 [8, 128].  Returns (warm i64 [8, 128]
    (u32 values, 0 for dead lanes), goff i32 [8, 128] (first unit after the
    warm-up pairs), stream i32 [8, SROWS, 128])."""
    u = units.long()
    g = gunits.long()
    goffs = g.cumsum(0) - g
    local = torch.arange(SROWS * W.GROUP, device=u.device)[None, :]
    idx = (goffs[:, None] + local).clamp(0, UT - 1)
    stream = torch.where(local < g[:, None], u[idx], 0)
    live = (lane_sz > 0).long()
    pos = 2 * (live.cumsum(1) - live)
    w0 = u[(goffs[:, None] + pos).clamp(0, UT - 1)]
    w1 = u[(goffs[:, None] + pos + 1).clamp(0, UT - 1)]
    warm = torch.where(live == 1, (w0 << 16) | w1, 0)
    goff = (2 * live.sum(1))[:, None].expand(GROUPS, W.GROUP)
    return (warm, goff.to(torch.int32).contiguous(),
            stream.to(torch.int32).reshape(GROUPS, SROWS, W.GROUP))


def needs_v2_decode(payload: bytes) -> bool:
    """True for a payload of the kernel route without the rANS flag: the
    v2 range-coded format, whose decode kernel (K4) is not ported yet."""
    if len(payload) < 12:
        return False
    _, L, flags, max_bits = struct.unpack_from("<IHHI", payload, 0)
    return L == LANES and max_bits != 0 and not flags & 4


def _dec_parse(payload: bytes):
    """Header and stream parse for the kernel decode.  Returns a dict, or
    None when the payload takes the native codec (not 1024 lanes, no bits,
    or a group of 2^23 bytes or more — the JAX decoder's record bound,
    kept so both packages route the same payloads the same way)."""
    isize, L, flags, max_bits = struct.unpack_from("<IHHI", payload, 0)
    if L != LANES or max_bits == 0:
        return None
    if needs_v2_decode(payload):
        raise NotImplementedError(
            "v2 wide payloads (no rANS flag) need the K4 decode kernel, "
            "which is not ported yet")
    off = 12
    if flags & 1:
        lane_sz = np.frombuffer(payload, dtype="<u4", count=L,
                                offset=off).astype(np.int64)
        off += 4 * L
    else:
        lane_sz = np.asarray(W.lane_sizes(isize, L), dtype=np.int64)
    if int(lane_sz.reshape(GROUPS, W.GROUP).sum(axis=1).max()) >= (1 << 23):
        return None
    gunits = np.frombuffer(payload, dtype="<u4", count=GROUPS,
                           offset=off).astype(np.int32)
    off += 4 * GROUPS
    total = int(gunits.sum())
    units = np.frombuffer(payload, dtype="<u2", count=total, offset=off)
    # the longest group's units, in whole rows of 128
    SROWS = max(1, -(-int(gunits.max()) // W.GROUP))
    upad = np.zeros(max(total, 1), dtype=np.uint16)
    upad[:total] = units
    return {"isize": isize, "lane_sz": lane_sz, "gunits": gunits,
            "upad": upad, "max_bits": max_bits, "SROWS": SROWS,
            "UT": len(upad)}


def _dec_args(p: dict, device) -> tuple:
    """_prep for a parsed payload: the arguments of :func:`decode_lanes`
    on ``device``."""
    upad = torch.from_numpy(p["upad"].view(np.int16)).to(device)
    units = upad.to(torch.int32) & 0xFFFF
    lane = p["lane_sz"].reshape(GROUPS, W.GROUP).astype(np.int32)
    lane_d = torch.from_numpy(lane).to(device)
    warm, goff, stream = _prep(units, torch.from_numpy(p["gunits"])
                               .to(device), lane_d, p["UT"], p["SROWS"])
    flat = lane.reshape(-1).astype(np.int64)
    lstart = torch.from_numpy((np.cumsum(flat) - flat).astype(np.int32))
    return (u32_to_i32(warm.reshape(-1)), goff.reshape(-1),
            lane_d.reshape(-1), lstart.to(device),
            stream.reshape(GROUPS, -1), p["max_bits"], int(flat.sum()))


def _dec_submit(p: dict, device) -> torch.Tensor:
    """_prep + K3 for a parsed payload; returns the block u8 [n] on
    ``device`` (asynchronous on the card)."""
    return decode_lanes(*_dec_args(p, device))


def device_decode_resident(payload: bytes, device="cuda"):
    """Wide decode that leaves the block on ``device`` (or None when the
    payload takes the native codec)."""
    parsed = _dec_parse(payload)
    if parsed is None:
        return None
    return _dec_submit(parsed, device)


def device_decode(payload: bytes, device="cuda"):
    """Wide decode on ``device``; returns the bytes, or None when the
    payload takes the native codec."""
    out = device_decode_resident(payload, device)
    return None if out is None else out.cpu().numpy().tobytes()
