"""The wide coder on the card: kernels K1 (model), K2 (rANS encode), K5
(v2 range encode), K3 and K4 (v3 and v2 decode), their plain PyTorch
versions, and the host stages around them.

Encode: the lane table and the per-lane bit schedule (packed 2-bit
``bit | active`` fields, planes ``u8 [IT/4, 1024]``, lane = group * 128 +
lane-in-group) come from the native host walker (:func:`device_encode`)
or from the device schedule (:func:`device_encode_resident`).  With
``RANS`` (the default, as in the JAX package) K1 runs each lane's model
forward and writes the probability plane, K2 walks the planes backward
doing binary rANS and leaves each group's units, in the decoder's
consumption order, at the end of the group's buffer, and
:func:`_assemble_rans` builds the v3 payload.  With ``RANS = False`` K5
runs the model and the v2 carry-less range coder in one forward pass and
leaves each group's stream at the head of its buffer, and
:func:`_assemble` builds the v2 payload (``ops/wide.py`` of the JAX
package specifies both formats).

Decode: :func:`_dec_parse` reads the payload, :func:`_prep` cuts the unit
stream into per-group u16 segments and warm-up words, and K3 (v3, flag
bit 2 set) or K4 (v2) decodes every lane: a chain kernel runs the bits
and writes one record per run, an expand kernel turns each lane's records
into its span of the output block.

:func:`device_encode_many` and :func:`device_decode_many` pipeline
several blocks: the host walker of the next block, or the copy of the
previous block to the host, runs while a block's kernels run.

Each kernel wrapper launches its CUDA kernel for CUDA tensors (and counts
the launch in ``LAUNCHES``) and runs its plain version for CPU tensors.
u32 coder state is carried in int32 tensors (bit pattern) between stages
and in int64 inside the plain versions, because torch's CPU backend has no
uint32 shifts or compares.
"""

from __future__ import annotations

import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import tables
from ..errors import corrupt
from . import _cuda
from . import wide as W

GROUPS = 8
LANES = GROUPS * W.GROUP  # the kernels' lane count
TI = 256                  # iteration-bucket granule
RANS = True  # encode coder: True = v3 rANS (K1 + K2), False = v2 range (K5)

LAUNCHES = {"wide_model": 0, "wide_rans": 0, "wide_rc_encode": 0,
            "wide_decode": 0, "wide_decode_v2": 0}

_PH_RFLAG, _PH_REXP, _PH_RMAN, _PH_UFLAG, _PH_UEXP, _PH_UMAN, _PH_DONE = \
    range(7)
_RM_OFF = (0, 0, 0, 1, 4, 11, 26, 41, 56)
_SINK = 511  # context of an inactive lane; never adapted
_M32 = 0xFFFFFFFF


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The device copies of the tables below are filled on first use, under
# this lock: the CLI's -G farm encodes on several threads at once.
_cache_lock = threading.Lock()
_priors_cache: dict = {}


def priors_tensor(device) -> torch.Tensor:
    """The installed priors as int32[281] on ``device``."""
    device = torch.device(device)
    arrays = tables.current()
    with _cache_lock:
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
# the lane state machine as a table (K1, K3, K4, K5 and the plain versions
# of K3 and K4)
# ---------------------------------------------------------------------------
#
# The control part of a lane's state is its position inside the code of
# one (rank, run) pair: (phase, t, brs).  Every reachable position gets an
# id; the histories (rh, uh, prb, pub), the mantissa accumulator val and
# the rank stay per-lane values.  A position's context is base + key, the
# key a small function of the histories picked by the position's kind.
# Entry [pos, 2 * bit : 2 * bit + 2] of the table says what one coded bit
# does there, as two int32 words:
#   A: [0:9) next position, [9:18) its context base, [18:21) its key kind,
#      [21:23) history update (0 none, 1 rh, 2 uh), [23:25) val (0 keep,
#      1 shift the bit in, 2 reset to 1), [25:27) rank (0 keep, 1 zero,
#      2 one, 3 the shifted val), [27:29) run completed (0 none, 1 a run
#      of 1, 2 a run of the shifted val);
#   B: [0:2) prb, [2:4) pub (3 keep, else the value set).
# csrc/wide_sm_table.cuh applies it; the test enumerates it against
# _sm_ctx / _sm_next.

(KEY_RH, KEY_REXP, KEY_RMAN, KEY_UFLAG, KEY_UEXP, KEY_UMAN, KEY_DONE) = \
    range(7)
SM_SINK = W.NCTX  # context row of a finished lane (never read by a live one)


def sm_positions() -> list:
    """Every position (phase, t, brs) of the table, in id order.  UMan
    with brs = 1 (a run exponent stop at its first bit, which no encoder
    writes) never completes; it is one absorbing position, t ignored."""
    rexp, uexp = W.RANK_EXP_CAP, W.RUN_EXP_CAP
    return ([(_PH_RFLAG, 0, 0)]
            + [(_PH_REXP, t, t) for t in range(1, rexp)]
            + [(_PH_RMAN, t, b) for b in range(2, rexp + 1)
               for t in range(b - 1)]
            + [(_PH_UFLAG, 0, 0)]
            + [(_PH_UEXP, t, t) for t in range(1, uexp)]
            + [(_PH_UMAN, 0, 1)]
            + [(_PH_UMAN, t, b) for b in range(2, uexp + 1)
               for t in range(b - 1)]
            + [(_PH_DONE, 0, 0)])


def _b3i(b: int) -> int:
    return 0 if b <= 1 else (1 if b <= 3 else 2)


def _sm_base_kind(pos) -> tuple:
    ph, t, brs = pos
    if ph == _PH_RFLAG:
        return 0, KEY_RH
    if ph == _PH_REXP:
        return 16 + t - 1, KEY_REXP
    if ph == _PH_RMAN:
        return 58 + _RM_OFF[brs], KEY_RMAN
    if ph == _PH_UFLAG:
        return 129, KEY_UFLAG
    if ph == _PH_UEXP:
        return 177 + t - 1, KEY_UEXP
    if ph == _PH_UMAN:
        return 249 + 16 * (brs > 3), KEY_UMAN
    return SM_SINK, KEY_DONE


def _sm_step(pos, bit: int) -> tuple:
    """The format's rule for one bit at a position: (next position,
    history, val, rank, run, prb, pub) in the table's codes."""
    ph, t, brs = pos
    hist = val = rank = run = 0
    prb = pub = 3
    if ph == _PH_RFLAG:
        hist = 1
        if bit:
            nxt = (_PH_REXP, 1, 1)
        else:
            nxt, rank, prb = (_PH_UFLAG, 0, 0), 1, 0
    elif ph == _PH_REXP:
        if bit and brs + 1 == W.RANK_EXP_CAP:
            nxt, val, prb = (_PH_RMAN, 0, brs + 1), 2, _b3i(brs + 1)
        elif bit:
            nxt = (_PH_REXP, t + 1, brs + 1)
        elif brs == 1:
            nxt, rank, prb = (_PH_UFLAG, 0, 0), 2, _b3i(brs)
        else:
            nxt, val, prb = (_PH_RMAN, 0, brs), 2, _b3i(brs)
    elif ph == _PH_RMAN:
        val = 1
        if t + 1 == brs - 1:
            nxt, rank = (_PH_UFLAG, 0, 0), 3
        else:
            nxt = (_PH_RMAN, t + 1, brs)
    elif ph == _PH_UFLAG:
        hist = 2
        if bit:
            nxt = (_PH_UEXP, 1, 1)
        else:
            nxt, run, pub = (_PH_RFLAG, 0, 0), 1, 0
    elif ph == _PH_UEXP:
        val = 2
        if bit and brs + 1 == W.RUN_EXP_CAP:
            nxt, pub = (_PH_UMAN, 0, brs + 1), _b3i(brs + 1)
        elif bit:
            nxt, val = (_PH_UEXP, t + 1, brs + 1), 0
        else:
            nxt, pub = (_PH_UMAN, 0, brs), _b3i(brs)
    elif ph == _PH_UMAN:
        val = 1
        if brs == 1:
            nxt = pos
        elif t + 1 == brs - 1:
            nxt, run = (_PH_RFLAG, 0, 0), 2
        else:
            nxt = (_PH_UMAN, t + 1, brs)
    else:
        nxt = pos
    return nxt, hist, val, rank, run, prb, pub


def sm_table() -> np.ndarray:
    """The table, int32 [positions, 4]: (A, B) for bit 0, then for bit 1."""
    positions = sm_positions()
    ids = {p: i for i, p in enumerate(positions)}
    tab = np.zeros((len(positions), 4), dtype=np.int64)
    for i, pos in enumerate(positions):
        for bit in (0, 1):
            nxt, hist, val, rank, run, prb, pub = _sm_step(pos, bit)
            base, kind = _sm_base_kind(nxt)
            tab[i, 2 * bit] = (ids[nxt] | base << 9 | kind << 18 | hist << 21
                               | val << 23 | rank << 25 | run << 27)
            tab[i, 2 * bit + 1] = prb | pub << 2
    return tab.astype(np.int32)


SM_NPOS = len(sm_positions())
SM_DONE = SM_NPOS - 1
SM_RFLAG = 0
_table_cache: dict = {}


def sm_table_tensor(device, encoder: bool = False) -> torch.Tensor:
    """:func:`sm_table` (or, with ``encoder``, :func:`sm_enc_table`) as
    int32 [SM_NPOS, 4] on ``device``."""
    device = torch.device(device)
    with _cache_lock:
        hit = _table_cache.get((str(device), encoder))
        if hit is None:
            hit = _table_cache[(str(device), encoder)] = torch.from_numpy(
                sm_enc_table() if encoder else sm_table()).to(device)
    return hit


# The encoders' form of the table (K1, K5; csrc/wide_encode_step.cuh).  An
# encoder needs each step's context, never the run or the rank itself, so
# its lane keeps rh, uh, prb, pub, the rank's bucket rankb (0 for rank 0, 1
# for 1-2, 2 above) and vc = min(val, 15) (the mantissa keys read no more),
# and a position's key is k1 * field1 + k2 * field2 of the packed word
#   H = rh | uh << 4 | prb << 8 | pub << 10 | rankb << 12 | vc << 14,
# a field being (H >> s) & m.  Entry [pos, 2 * bit : 2 * bit + 2]:
#   A: [0:9) next position, [9:18) its context base (less 1 at a rank
#      mantissa, whose key min(val - 1, 14) is vc - 1), [18:20) history
#      (0 none, 1 rh, 2 uh), [20:22) val (0 keep, 1 shift the bit in, 2
#      reset to 1), [22:24) rank (0 keep, 1 zero, 2 one, 3 the shifted
#      val), [24:26) prb, [26:28) pub (3 keep, else the value set);
#   B: the next position's key: [0:5) s1, [5:9) m1, [9:14) k1, [14:19) s2,
#      [19:21) m2, [21:26) k2.
ENC_KEY = {KEY_RH: (0, 15, 1, 0, 0, 0), KEY_REXP: (8, 3, 7, 0, 1, 21),
           KEY_RMAN: (14, 15, 1, 0, 0, 0), KEY_UFLAG: (4, 15, 3, 12, 3, 1),
           KEY_UEXP: (10, 3, 24, 0, 0, 0), KEY_UMAN: (14, 15, 1, 0, 0, 0),
           KEY_DONE: (0, 0, 0, 0, 0, 0)}


def enc_key_word(kind: int) -> int:
    """The B word of a position of key kind ``kind``."""
    s1, m1, k1, s2, m2, k2 = ENC_KEY[kind]
    return s1 | m1 << 5 | k1 << 9 | s2 << 14 | m2 << 19 | k2 << 21


def sm_enc_table() -> np.ndarray:
    """The encoders' table, int32 [positions, 4]: (A, B) for bit 0, then
    for bit 1 (the layout above), derived from :func:`sm_table`."""
    tab = sm_table().astype(np.int64)
    out = np.zeros_like(tab)
    for bit in (0, 1):
        a, b = tab[:, 2 * bit], tab[:, 2 * bit + 1]
        kind = (a >> 18) & 7
        base = ((a >> 9) & 511) - (kind == KEY_RMAN)
        out[:, 2 * bit] = ((a & 511) | base << 9 | ((a >> 21) & 63) << 18
                           | (b & 15) << 24)
        out[:, 2 * bit + 1] = [enc_key_word(int(k)) for k in kind]
    return out.astype(np.int32)


def _sm_key(kind, rh, uh, prb, pub, val, rank):
    """The context key of each lane's position kind (vectorized)."""
    w = torch.where
    rankb = w(rank == 0, 0, w(rank <= 2, 1, 2))
    key = w(kind == KEY_REXP, 7 * prb + 21 * (rh & 1), rh)
    key = w(kind == KEY_RMAN, torch.clamp(val - 1, max=14), key)
    key = w(kind == KEY_UFLAG, 3 * uh + rankb, key)
    key = w(kind == KEY_UEXP, 24 * pub, key)
    key = w(kind == KEY_UMAN, torch.clamp(val, max=15), key)
    return w(kind == KEY_DONE, 0, key)


def _sm_apply(tab, pos, bit, rh, uh, prb, pub, val, rank):
    """One table step for every lane.  Returns (pos, base, kind, rh, uh,
    prb, pub, val, rank, run); run is 0 where no run completed."""
    w = torch.where
    e = tab[pos]
    a = w(bit == 1, e[:, 2], e[:, 0]).long()
    b = w(bit == 1, e[:, 3], e[:, 1]).long()
    hist, vmode = (a >> 21) & 3, (a >> 23) & 3
    rmode, runmode = (a >> 25) & 3, (a >> 27) & 3
    shifted = (val << 1) | bit
    rh = w(hist == 1, ((rh << 1) | bit) & 0xF, rh)
    uh = w(hist == 2, ((uh << 1) | bit) & 0xF, uh)
    val = w(vmode == 1, shifted, w(vmode == 2, 1, val))
    rank = w(rmode == 1, 0, w(rmode == 2, 1, w(rmode == 3, shifted, rank)))
    run = w(runmode == 1, 1, w(runmode == 2, shifted, 0))
    prb = w((b & 3) == 3, prb, b & 3)
    pub = w(((b >> 2) & 3) == 3, pub, (b >> 2) & 3)
    return (a & 511, (a >> 9) & 511, (a >> 18) & 7, rh, uh, prb, pub, val,
            rank, run)


# ---------------------------------------------------------------------------
# K1: model pass
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """K1, K2 and K5 stage rows by 16-byte asynchronous copies: a copy of
    ``t`` when its data does not start on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    planes = _aligned(planes)
    pri, tab = priors_tensor(dev), sm_table_tensor(dev, encoder=True)
    fn = _cuda.launcher("wide_model")
    rc = fn(planes.data_ptr(), max_bits, pri.data_ptr(), tab.data_ptr(),
            probs.data_ptr(), _cuda.stream_handle(dev))
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

RANS_STEPS = 32  # K2's chunk: steps a ballot word covers


def rans_table() -> np.ndarray:
    """K2's quotient table, u32 [4097]: m_f = floor((2^32 - 1) / f) for f
    in [1, 4096] (m_0 unused).  For a u32 x, q' = (x * m_f) >> 32 is
    floor(x / f) or one less, and q' + (x - q' f >= f) is floor(x / f)
    (the argument is in csrc/wide_rans.cu)."""
    f = np.arange(4097, dtype=np.uint64)
    f[0] = 1
    m = np.uint64(0xFFFFFFFF) // f
    m[0] = 0
    return m.astype(np.uint32)


_rans_table_cache: dict = {}


def rans_table_tensor(device) -> torch.Tensor:
    """:func:`rans_table` as int32 [4097] (bit patterns) on ``device``."""
    device = torch.device(device)
    with _cache_lock:
        hit = _rans_table_cache.get(str(device))
        if hit is None:
            hit = torch.from_numpy(rans_table().view(np.int32)).to(device)
            _rans_table_cache[str(device)] = hit
    return hit


def rans_scratch_bytes(max_bits: int) -> int:
    """K2's scratch between its chain and placement kernels: the dense
    units u16 [npad, 1024], the ballots u32 [32, npad] and the chunk
    counts i32 [32, npad / 32], npad = 32 ceil(max_bits / 32)."""
    chunks = -(-max_bits // RANS_STEPS)
    npad = RANS_STEPS * chunks
    return 2 * LANES * npad + 4 * 32 * npad + 4 * 32 * chunks


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
    scratch = torch.empty(rans_scratch_bytes(max_bits), dtype=torch.uint8,
                          device=dev)
    planes, probs = _aligned(planes), _aligned(probs)
    fn = _cuda.launcher("wide_rans")
    rc = fn(planes.data_ptr(), probs.data_ptr(), max_bits, cap,
            rans_table_tensor(dev).data_ptr(), scratch.data_ptr(),
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
# K5: v2 range encode (model and coder in one forward pass)
# ---------------------------------------------------------------------------

def _rc_split(low, rng, p, bit, active):
    """The v2 coder's interval split for one bit (u32 values in int64):
    a one keeps [low + r, rng - r), a zero [low, r), r = (rng >> 12) * p.
    Inactive lanes keep their interval."""
    r = (rng >> 12) * p
    one = active & (bit == 1)
    return (torch.where(one, (low + r) & _M32, low),
            torch.where(active, torch.where(one, rng - r, r), rng))


def _rc_renorm(low, rng, ren):
    """The v2 coder's renormalisation of the lanes in ``ren``: an interval
    straddling a 2^16 boundary is clamped to its larger side (the upper
    one only when strictly larger), then low and rng shift up 16.
    Returns (low, rng, the unit a renormalising lane emits)."""
    straddle = ((low ^ ((low + rng - 1) & _M32)) >> 16) != 0
    lo_part = 0x10000 - (low & 0xFFFF)
    hi_part = (rng - lo_part) & _M32
    clamp = ren & straddle
    take_hi = clamp & (hi_part > lo_part)
    low = torch.where(take_hi, (low + lo_part) & _M32, low)
    rng = torch.where(clamp, torch.where(take_hi, hi_part, lo_part), rng)
    return (torch.where(ren, (low << 16) & _M32, low),
            torch.where(ren, (rng << 16) & _M32, rng), low >> 16)


def rc_encode(planes: torch.Tensor, max_bits: int):
    """K5.  Returns (units i32 [8, cap], counts i32 [8]): group g's stream,
    in the decoder's consumption order (the warm-up pairs of the live
    lanes, then one delayed unit per renormalisation event), is
    units[g, :counts[g]]."""
    rows = planes.shape[0]
    _check(planes, torch.uint8, (rows, LANES), "planes")
    if not 0 <= max_bits <= 4 * rows:
        raise ValueError("max_bits exceeds the planes")
    dev = _same_device("rc_encode", planes)
    cap = W.GROUP * (max_bits + 2)  # one unit per lane-iteration + flush
    if dev.type == "cpu":
        return rc_encode_plain(planes, max_bits, cap)
    units = torch.empty((GROUPS, cap), dtype=torch.int32, device=dev)
    counts = torch.empty(GROUPS, dtype=torch.int32, device=dev)
    planes = _aligned(planes)
    pri, tab = priors_tensor(dev), sm_table_tensor(dev, encoder=True)
    fn = _cuda.launcher("wide_rc_encode")
    rc = fn(planes.data_ptr(), max_bits, cap, pri.data_ptr(), tab.data_ptr(),
            units.data_ptr(), counts.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check("wide_rc_encode", rc)
    LAUNCHES["wide_rc_encode"] += 1
    return units, counts


def rc_encode_plain(planes, max_bits: int, cap: int):
    """K5's plain version.  A lane's r-th unit (its emissions, then its two
    flush units) goes to warm-up slot r when r < 2, else to the slot of
    its event r - 2; slot_a and slot_b hold the slots of its last two
    events."""
    dev = planes.device
    units = torch.zeros((GROUPS, cap), dtype=torch.int32, device=dev)
    model = torch.zeros((LANES, 512), dtype=torch.int64, device=dev)
    model[:, :W.NCTX] = priors_tensor(dev).long()
    st = _fresh_state(torch.full((LANES,), _PH_RFLAG, dtype=torch.int64,
                                 device=dev))
    low = torch.zeros(LANES, dtype=torch.int64, device=dev)
    rng = torch.full((LANES,), _M32, dtype=torch.int64, device=dev)
    live = (_fields(planes, 0) & 2 != 0) if max_bits else \
        torch.zeros(LANES, dtype=torch.bool, device=dev)
    live2 = live.view(GROUPS, W.GROUP).long()
    warm = (2 * (live2.cumsum(1) - live2)).view(-1)
    cursor = 2 * live2.sum(1)
    group = torch.arange(LANES, device=dev) // W.GROUP
    emitted = torch.zeros(LANES, dtype=torch.int64, device=dev)
    slot_a = torch.zeros_like(emitted)
    slot_b = torch.zeros_like(emitted)
    for i in range(max_bits + 2):
        if i < max_bits:
            fld = _fields(planes, i)
            bit, active = fld & 1, (fld & 2) != 0
            ctx = _sm_ctx(st, active)[:, None]
            p = model.gather(1, ctx)[:, 0]
            model.scatter_(1, ctx,
                           torch.where(active, _adapt(p, bit), p)[:, None])
            st, _, _ = _sm_next(st, bit, active)
            low, rng = _rc_split(low, rng, p, bit, active)
            put = active & (rng < (1 << 16))
            low, rng, unit = _rc_renorm(low, rng, put)
            ren2 = put.view(GROUPS, W.GROUP).long()
            slot = (cursor[:, None] + ren2.cumsum(1) - ren2).view(-1)
            cursor = cursor + ren2.sum(1)
        else:  # the flush: low's high half, then its low half
            put, unit, slot = live, low >> 16, slot_b
            low = (low << 16) & _M32
        at = torch.where(emitted < 2, warm + emitted, slot_a)
        units[group[put], at[put]] = unit[put].to(torch.int32)
        slot_a = torch.where(put, slot_b, slot_a)
        slot_b = torch.where(put, slot, slot_b)
        emitted = emitted + put.long()
    return units, cursor.to(torch.int32)


# ---------------------------------------------------------------------------
# K3 (v3) and K4 (v2): decode
# ---------------------------------------------------------------------------

CHUNK = 1024  # units one ring refill of K3/K4 copies; stream rows are
              # padded to a multiple of it


def decode_lanes(warm, goff, lane_sz, lstart, stream, max_bits: int,
                 n: int, rans: bool = True) -> torch.Tensor:
    """K3 (``rans``) or K4.  warm: i32 [1024] initial states or code words
    (u32 bit pattern); goff, lane_sz, lstart: i32 [1024] (first unit after
    the warm-up pairs, lane sizes, absolute lane starts); stream: i16
    [8, S] per-group unit segments (u16 bit patterns, zero past a group's
    units, S a multiple of CHUNK).  Returns the decoded block u8 [n].

    On the card one call runs the two kernels of csrc/wide_decode.cu: the
    chain kernel decodes every lane's bits and writes one record
    ``run << 8 | rank`` per completed run into the lane's region of a
    record buffer, and the expand kernel replays each lane's records
    through its move-to-front table into the block."""
    for t, name in ((warm, "warm"), (goff, "goff"), (lane_sz, "lane_sz"),
                    (lstart, "lstart")):
        _check(t, torch.int32, (LANES,), name)
    _check(stream, torch.int16, (GROUPS, stream.shape[1]), "stream")
    if stream.shape[1] % CHUNK:
        raise ValueError(f"stream: rows must be a multiple of {CHUNK} units")
    dev = _same_device("decode_lanes", warm, goff, lane_sz, lstart, stream)
    if dev.type == "cpu":
        return decode_lanes_plain(warm, goff, lane_sz, lstart, stream,
                                  max_bits, n, rans)
    name = "wide_decode" if rans else "wide_decode_v2"
    rec = torch.empty(n, dtype=torch.int32, device=dev)
    nrec = torch.empty(LANES, dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    pri = priors_tensor(dev)
    tab = sm_table_tensor(dev)
    fn = _cuda.launcher(name)
    rc = fn(warm.data_ptr(), goff.data_ptr(), lane_sz.data_ptr(),
            lstart.data_ptr(), stream.data_ptr(), int(stream.shape[1]),
            max_bits, pri.data_ptr(), tab.data_ptr(), rec.data_ptr(),
            nrec.data_ptr(), out.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check(name, rc)
    LAUNCHES[name] += 1
    return out


def decode_lanes_plain(warm, goff, lane_sz, lstart, stream, max_bits: int,
                       n: int, rans: bool = True) -> torch.Tensor:
    """K3/K4's plain version: :func:`decode_records_plain`, then
    :func:`expand_records_plain`."""
    rec, nrec = decode_records_plain(warm, goff, lane_sz, lstart, stream,
                                     max_bits, n, rans)
    return expand_records_plain(rec, nrec, lstart, n)


def decode_records_plain(warm, goff, lane_sz, lstart, stream, max_bits: int,
                         n: int, rans: bool = True):
    """The chain kernel's plain version: every lane's bits through the
    table form of the state machine.  Returns (rec i32 [n], nrec i32
    [1024]): lane l's records ``run << 8 | rank`` (the run clipped to what
    is left of the lane) are rec[lstart[l] : lstart[l] + nrec[l]]."""
    dev = warm.device
    S = int(stream.shape[1])
    units = stream.long() & 0xFFFF
    tab = sm_table_tensor(dev).long()
    left = lane_sz.long()
    live = left > 0
    pos = torch.where(live, SM_RFLAG, SM_DONE)
    base = torch.where(live, 0, SM_SINK)
    kind = torch.where(live, KEY_RH, KEY_DONE)
    rh, uh, prb, pub, val, rank = (torch.zeros_like(left) for _ in range(6))
    x = i32_to_u32(warm)  # v3: the rANS state; v2: the code word
    low = torch.zeros_like(x)
    rng = torch.full_like(x, _M32)
    cursor = goff.long().view(GROUPS, W.GROUP)[:, 0].clone()
    start = lstart.long()
    nrec = torch.zeros_like(left)
    rec = torch.zeros(n, dtype=torch.int32, device=dev)
    model = torch.zeros((LANES, 512), dtype=torch.int64, device=dev)
    model[:, :W.NCTX] = priors_tensor(dev).long()
    for _ in range(max_bits):
        active = pos != SM_DONE
        if not bool(active.any()):
            break
        ctx = (base + _sm_key(kind, rh, uh, prb, pub, val, rank))[:, None]
        p = model.gather(1, ctx)[:, 0]
        if rans:
            slot, hi = x & 0xFFF, x >> 12
            bit = ((slot >= p) & active).long()
            x1 = torch.where(bit == 1, (4096 - p) * hi + slot - p,
                             p * hi + slot)
            x1 = torch.where(active, x1, x)
            ren = active & (x1 < (1 << 16))
        else:
            bit = ((((x - low) & _M32) >= (rng >> 12) * p) & active).long()
            low, rng = _rc_split(low, rng, p, bit, active)
            ren = active & (rng < (1 << 16))
            low, rng, _ = _rc_renorm(low, rng, ren)
            x1 = x
        model.scatter_(1, ctx, torch.where(active, _adapt(p, bit), p)[:, None])

        ren2 = ren.view(GROUPS, W.GROUP)
        at = cursor[:, None] + ren2.cumsum(1) - ren2.long()
        unit = torch.where(at < S, units.gather(1, at.clamp(max=S - 1)), 0)
        x = torch.where(ren, (x1 << 16) | unit.view(-1), x1)
        cursor += ren2.sum(1)

        pos, base, kind, rh, uh, prb, pub, val, rank, run = _sm_apply(
            tab, pos, bit, rh, uh, prb, pub, val, rank)
        comp = run > 0
        if bool(comp.any()):
            run = torch.minimum(run, left)
            rec[(start + nrec)[comp]] = ((run << 8) | rank)[comp].int()
            nrec += comp.long()
            left = torch.where(comp, left - run, left)
            fin = comp & (left <= 0)
            pos = torch.where(fin, SM_DONE, pos)
            base = torch.where(fin, SM_SINK, base)
            kind = torch.where(fin, KEY_DONE, kind)
    return rec, nrec.to(torch.int32)


def expand_records_plain(rec, nrec, lstart, n: int) -> torch.Tensor:
    """The expand kernel's plain version: each lane's records, in order,
    through the lane's move-to-front table (the symbol at the record's
    rank moves to the front) into runs at the lane's span of the block,
    u8 [n]."""
    dev = rec.device
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    cnt, start = nrec.long(), lstart.long()
    if n == 0 or not bool((cnt > 0).any()):
        return out
    mtf = torch.arange(256, device=dev).repeat(LANES, 1)
    col = torch.arange(256, device=dev)[None, :]
    pos = start.clone()
    srcs, syms, lens = [], [], []
    for k in range(int(cnt.max())):
        has = k < cnt
        e = torch.where(has, rec[(start + k).clamp(max=n - 1)].long(), 0)
        rank, run = e & 255, e >> 8
        sym = mtf.gather(1, rank[:, None])[:, 0]
        shift = has[:, None] & (col >= 1) & (col <= rank[:, None])
        mtf = torch.where(shift, mtf.roll(1, dims=1), mtf)
        mtf[:, 0] = torch.where(has, sym, mtf[:, 0])
        srcs.append(pos[has])
        syms.append(sym[has])
        lens.append(run[has])
        pos = pos + run
    start, sym, run = torch.cat(srcs), torch.cat(syms), torch.cat(lens)
    first = torch.repeat_interleave(start - (run.cumsum(0) - run), run)
    idx = first + torch.arange(int(run.sum()), device=dev)
    out[idx] = torch.repeat_interleave(sym, run).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# encode: host and device stages around K1 and K2 (v3) or K5 (v2)
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
    """K1 + K2 (``RANS``) or K5 on the prepared planes (asynchronous on the
    card).  Returns the in-flight state for :func:`_collect`."""
    planes, sizes, max_bits, _IT = prep
    planes_d = torch.as_tensor(planes).to(device)
    if RANS:
        probs = model_probs(planes_d, max_bits)
        return True, rans_encode(planes_d, probs, max_bits), sizes, max_bits
    return False, rc_encode(planes_d, max_bits), sizes, max_bits


def _collect(n: int, inflight):
    """The payload of a submitted block (copies it to the host)."""
    rans, out, sizes, max_bits = inflight
    if rans:
        return _assemble_rans(n, *out, sizes, max_bits)
    return _assemble(n, *out, sizes, max_bits)


def device_encode(data: bytes, device="cuda"):
    """Wide encode with the coder on ``device``: native lane table and
    schedule, then K1 and K2 (or K5 when ``RANS`` is False).  Returns the
    payload (the native codec's bytes for the same lane table), or None
    when the block does not take the kernels or is not compressible."""
    prep = _host_prep(data)
    if prep is None:
        return None
    return _collect(len(data), _submit(prep, device))


def device_encode_many(datas, device="cuda"):
    """Pipelined :func:`device_encode` of several blocks: a prep thread
    runs the native host walker (:func:`_host_prep`) of block i+1 while
    block i's kernels run, and block i-1's payload is collected before
    block i is submitted (a copy queued behind block i's kernels would wait
    for them).  Returns the payloads in input order, None where a block
    does not take the kernels.  An exception in the prep thread is raised
    here."""
    results: list = [None] * len(datas)
    pending = None  # (index, in-flight state)
    with ThreadPoolExecutor(max_workers=1) as prep_thread:
        nxt = prep_thread.submit(_host_prep, datas[0]) if datas else None
        for i in range(len(datas)):
            prep = nxt.result()
            if i + 1 < len(datas):
                nxt = prep_thread.submit(_host_prep, datas[i + 1])
            if pending is not None:
                results[pending[0]] = _collect(len(datas[pending[0]]),
                                               pending[1])
                pending = None
            if prep is not None:
                pending = (i, _submit(prep, device))
    if pending is not None:
        results[pending[0]] = _collect(len(datas[pending[0]]), pending[1])
    return results


def _payload(n: int, parts, gunits, lane_sz, max_bits: int, rans: bool):
    """The wide payload: header, lane table (when given), group unit
    counts, then the group streams ``parts`` (device tensors of u16
    values), joined on the device and copied to the host once.  None when
    it is not smaller than the block."""
    stream = torch.cat(parts).cpu().numpy().astype("<u2")
    flags = (1 if lane_sz is not None else 0) | 2 | (4 if rans else 0)
    payload = struct.pack("<IHHI", n, LANES, flags, max_bits)
    if lane_sz is not None:
        payload += np.asarray(lane_sz).astype("<u4").tobytes()
    payload += np.asarray(gunits, dtype="<u4").tobytes()
    payload += stream.tobytes()
    if len(payload) >= n:
        return None
    return payload


def _assemble_rans(n: int, units: torch.Tensor, counts: torch.Tensor,
                   fx: torch.Tensor, lane_sz=None, max_bits: int = 0):
    """v3 payload from K2's output: per group, the warm-up pair (final
    state hi, lo) of each live lane in lane order, then the group's
    units."""
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
    return _payload(n, parts, gunits, lane_sz, max_bits, rans=True)


def _assemble(n: int, units: torch.Tensor, counts: torch.Tensor,
              lane_sz=None, max_bits: int = 0):
    """v2 payload from K5's output: K5 already wrote each group's stream,
    delays and warm-up included, at the head of the group's buffer."""
    cnt = counts.cpu().tolist()
    parts = [units[g, :cnt[g]] for g in range(GROUPS)]
    return _payload(n, parts, cnt, lane_sz, max_bits, rans=False)


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
    :func:`resident_prep`, then the kernels of :func:`_submit`.  Returns
    the in-flight state for :func:`collect_resident`, or None when the
    block does not take this route."""
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
# decode: parse and prologue around K3 and K4
# ---------------------------------------------------------------------------

def _prep(units: torch.Tensor, gunits: torch.Tensor, lane_sz: torch.Tensor,
          UT: int, SROWS: int):
    """Cut the flat unit stream into the decoder's per-group segments and
    extract the warm-up words: units [UT] (u16 values or their int16 bit
    patterns, zero tail), gunits i32 [8] (best on the host: its values
    size the copies), lane_sz i32 [8, 128].  Returns (warm i64 [8, 128]
    (u32 values, 0 for dead lanes), goff i32 [8, 128] (first unit after the
    warm-up pairs), stream i16 [8, SROWS, 128] (u16 bit patterns, zero
    past each group's units))."""
    dev = units.device
    counts = gunits.tolist()
    g = gunits.to(dev).long()
    goffs = g.cumsum(0) - g
    stream = torch.zeros((GROUPS, SROWS * W.GROUP), dtype=torch.int16,
                         device=dev)
    at = 0
    for row, c in zip(stream, counts):
        k = max(0, min(c, SROWS * W.GROUP, UT - at))
        row[:k] = units[at:at + k].to(torch.int16)
        at += c
    live = (lane_sz > 0).long()
    pos = 2 * (live.cumsum(1) - live)
    w0 = units[(goffs[:, None] + pos).clamp(0, UT - 1)].long() & 0xFFFF
    w1 = units[(goffs[:, None] + pos + 1).clamp(0, UT - 1)].long() & 0xFFFF
    warm = torch.where(live == 1, (w0 << 16) | w1, 0)
    goff = (2 * live.sum(1))[:, None].expand(GROUPS, W.GROUP)
    return (warm, goff.to(torch.int32).contiguous(),
            stream.reshape(GROUPS, SROWS, W.GROUP))


def _dec_parse(payload: bytes):
    """Header and stream parse for the kernel decode.  Returns a dict, or
    None when the payload takes the native codec (not 1024 lanes, no bits,
    or a group of 2^23 bytes or more — the JAX decoder's record bound,
    kept so both packages route the same payloads the same way).

    No field is trusted: BscError(DATA_CORRUPT) when the header, the lane
    sizes (flag bit 0) or the group counts do not fit the payload, or when
    the lane sizes do not sum to the block size.  The block size itself is
    held against the block header by api._check_wide_size, before either
    decode route."""
    if len(payload) < 12:
        raise corrupt("wide payload header")
    isize, L, flags, max_bits = struct.unpack_from("<IHHI", payload, 0)
    if L != LANES or max_bits == 0:
        return None
    off = 12
    if flags & 1:
        if len(payload) < off + 4 * L:
            raise corrupt("wide lane sizes")
        lane_sz = np.frombuffer(payload, dtype="<u4", count=L,
                                offset=off).astype(np.int64)
        off += 4 * L
        if int(lane_sz.sum()) != isize:
            raise corrupt("wide lane sizes")
    else:
        lane_sz = np.asarray(W.lane_sizes(isize, L), dtype=np.int64)
    if int(lane_sz.reshape(GROUPS, W.GROUP).sum(axis=1).max()) >= (1 << 23):
        return None
    if len(payload) < off + 4 * GROUPS:
        raise corrupt("wide group counts")
    gunits = np.frombuffer(payload, dtype="<u4", count=GROUPS,
                           offset=off).astype(np.int64)
    off += 4 * GROUPS
    total = int(gunits.sum())
    if len(payload) < off + 2 * total:
        raise corrupt("wide group counts")
    gunits = gunits.astype(np.int32)
    units = np.frombuffer(payload, dtype="<u2", count=total, offset=off)
    # the longest group's units, in whole rows of 128
    SROWS = max(1, -(-int(gunits.max()) // W.GROUP))
    upad = np.zeros(max(total, 1), dtype=np.uint16)
    upad[:total] = units
    return {"rans": bool(flags & 4), "isize": isize, "lane_sz": lane_sz,
            "gunits": gunits,
            "upad": upad, "max_bits": max_bits, "SROWS": SROWS,
            "UT": len(upad)}


def _dec_args(p: dict, device) -> tuple:
    """_prep for a parsed payload: the arguments of :func:`decode_lanes`
    on ``device``."""
    upad = torch.from_numpy(p["upad"].view(np.int16)).to(device)
    lane = p["lane_sz"].reshape(GROUPS, W.GROUP).astype(np.int32)
    lane_d = torch.from_numpy(lane).to(device)
    rows = -(-p["SROWS"] * W.GROUP // CHUNK) * CHUNK // W.GROUP
    warm, goff, stream = _prep(upad, torch.from_numpy(p["gunits"]), lane_d,
                               p["UT"], rows)
    flat = lane.reshape(-1).astype(np.int64)
    lstart = torch.from_numpy((np.cumsum(flat) - flat).astype(np.int32))
    return (u32_to_i32(warm.reshape(-1)), goff.reshape(-1),
            lane_d.reshape(-1), lstart.to(device),
            stream.reshape(GROUPS, -1), p["max_bits"], int(flat.sum()))


def _dec_submit(p: dict, device) -> torch.Tensor:
    """_prep + K3 (v3 payload) or K4 (v2) for a parsed payload; returns the
    block u8 [n] on ``device`` (asynchronous on the card)."""
    return decode_lanes(*_dec_args(p, device), rans=p["rans"])


def _ready(out):
    """An event recorded after the kernels that write ``out`` when it lies
    on the card, else None."""
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(out.device))
    return ev


def _dec_fetch(out, ready) -> bytes:
    """The decoded block's bytes.  On the card the copy runs on a side
    stream into pinned memory once ``ready`` has fired, so it overlaps the
    kernels queued after ``ready``."""
    if ready is None:
        return out.cpu().numpy().tobytes()
    side = torch.cuda.Stream(out.device)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    with torch.cuda.stream(side):
        side.wait_event(ready)
        host.copy_(out, non_blocking=True)
    side.synchronize()
    return host.numpy().tobytes()


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


def device_decode_many(payloads, device="cuda"):
    """Pipelined :func:`device_decode` of several payloads: payload i is
    parsed and its kernel submitted before payload i-1's block is copied
    to the host (:func:`_dec_fetch`), so that copy overlaps block i's
    kernel and at most two blocks are in flight.  Returns the blocks in
    input order, None where a payload takes the native codec."""
    results: list = [None] * len(payloads)
    pending = None  # (index, block, its ready event)
    for i, payload in enumerate(payloads):
        parsed = _dec_parse(payload)
        if parsed is None:
            continue
        out = _dec_submit(parsed, device)
        ready = _ready(out)
        if pending is not None:
            results[pending[0]] = _dec_fetch(*pending[1:])
        pending = (i, out, ready)
    if pending is not None:
        results[pending[0]] = _dec_fetch(*pending[1:])
    return results
