"""CODER_QLFC_WIDE: format constants, the lane policy, the native codec
and the Python reference codec.

The payload layout, the model and the coder are specified in the JAX
package's ``ops/wide.py``; this module keeps the context count and
layout, the exponent caps, the lane-count policy, the native
``wide_encode``/``wide_decode`` wrappers (the host route for blocks the
kernels do not take) and the format's Python reference,
:func:`wide_encode_ref` / :func:`wide_decode_ref` (v2: the carry-less
range coder; v3: binary rANS lanes), lockstep over lanes like the
kernels.  ``TBSC_ENGINE=numpy`` encodes and decodes with the reference:
its lanes are equal-sized (no balanced lane table), so its archive differs
from the native codec's, as in the JAX package.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .. import tables
from ..errors import corrupt

NCTX = tables.NCTX
_CTX_RANK_FLAG = 0    # + rhist4 (last four rank flags): 0..15
_CTX_RANK_EXP = 16    # + (t-1) + 7*prev_rb(0..2) + 21*rhist1: 16..57
_CTX_RANK_MAN = 58    # + RM_OFF[brs] + min(partial-1, 14): 58..128
_CTX_RUN_FLAG = 129   # + 3*uhist4 + rank bucket(0..2): 129..176
_CTX_RUN_EXP = 177    # + (t-1) + 24*prev_ub(0..2): 177..248
_CTX_RUN_MAN = 249    # + 16*(brs > 3) + min(partial, 15): 249..280

# mantissa tree offsets per rank bit-length, indexed by brs in [2, 8]
RM_OFF = (0, 0, 0, 1, 4, 11, 26, 41, 56)

_FLAG_MODEL_V2 = 2
_FLAG_RANS = 4  # v3 coder: binary rANS lanes (no clamp loss, no flush units)

RANK_EXP_CAP = 8      # bit_length(rank) in [1, 8]
RUN_EXP_CAP = 25      # bit_length(run) in [2, 25] -> lane chunk < 2^25

P_BITS = 12
ADAPT_SHIFT = 5

MAX_LANES = 65535
DEFAULT_LANES = 1024
GROUP = 128  # lanes per group (each group owns one stream segment)


def priors() -> np.ndarray:
    """Per-context initial probabilities (the installed format table)."""
    return tables.priors()


def _bucket3(brs: int) -> int:
    if brs <= 1:
        return 0
    if brs <= 3:
        return 1
    return 2


def _bucket2(brs: int) -> int:
    return 0 if brs <= 3 else 1


def _rank_bucket(rank: int) -> int:
    if rank == 0:
        return 0
    return 1 if rank <= 2 else 2


def lane_sizes(isize: int, n_lanes: int) -> list[int]:
    chunk = -(-isize // n_lanes)  # ceil
    sizes = []
    left = isize
    for _ in range(n_lanes):
        s = min(chunk, left)
        sizes.append(s)
        left -= s
    return sizes


def pick_lanes(isize: int) -> int:
    """DEFAULT_LANES, reduced for small blocks so each lane has at least
    ~4 KiB to amortize its model warm-up."""
    lanes = DEFAULT_LANES
    while lanes > 1 and isize // lanes < 4096:
        lanes //= 2
    while -(-isize // lanes) >= (1 << RUN_EXP_CAP):
        lanes *= 2
    return min(lanes, MAX_LANES)


def pick_lanes_policy(isize: int) -> int:
    """Lane count of a block: TBSC_WIDE_LANES when set (clamped to a power
    of two in [2, MAX_LANES] and to the run-length cap), else pick_lanes.
    Only the 1024-lane point runs on the kernels."""
    try:
        lanes = int(os.environ.get("TBSC_WIDE_LANES", "0"))
    except ValueError:
        lanes = 0
    if lanes <= 0:
        return pick_lanes(isize)
    lanes = max(2, min(1 << (lanes.bit_length() - 1), MAX_LANES))
    while -(-isize // lanes) >= (1 << RUN_EXP_CAP):
        lanes *= 2
    return min(lanes, MAX_LANES)


def _numpy_engine() -> bool:
    from .. import engine

    return engine._force == "numpy"


def wide_encode(data, n_lanes=None, balanced=True, rans=True, sizes=None):
    """Native wide encode.  ``balanced`` uses the native run-count lane
    balancer; ``sizes`` (int32[n_lanes]) passes an explicit lane table
    instead.  Under ``TBSC_ENGINE=numpy`` the reference encodes, with
    equal lanes (``balanced`` is ignored, as in the JAX package).  Returns
    the payload, or None when it is not smaller than the input."""
    from .. import native

    if _numpy_engine():
        if sizes is not None:
            raise ValueError("the reference codec takes equal lanes only")
        return wide_encode_ref(data, n_lanes, rans=rans)

    lib = native.load()
    buf = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8))
    out = np.empty(len(buf) + 65536, dtype=np.uint8)
    L = n_lanes or pick_lanes(len(buf))
    sizes_p = None
    if sizes is not None:
        sizes = np.ascontiguousarray(sizes, dtype=np.int32)
        if sizes.shape != (L,):
            raise ValueError("sizes must have one entry per lane")
        sizes_p = native.i32p(sizes)
    elif balanced and len(buf) >= L:
        sizes = np.zeros(L, dtype=np.int32)
        if lib.tbsc_wide_balanced_sizes(native.u8p(buf), len(buf), L,
                                        native.i32p(sizes)) == 0:
            sizes_p = native.i32p(sizes)
    rc = lib.tbsc_wide_encode(native.u8p(buf), len(buf), native.u8p(out),
                              len(out), L, sizes_p, 1 if rans else 0)
    if rc == -3:
        return None
    if rc < 0:
        raise RuntimeError(f"wide_encode native error {rc}")
    return out[:rc].tobytes()


def wide_decode(payload) -> bytes:
    """Native wide decode (the reference under ``TBSC_ENGINE=numpy``).  A
    payload the decoder refuses (its counts or lane sizes do not fit)
    raises BscError(DATA_CORRUPT)."""
    from .. import native

    buf = np.ascontiguousarray(np.frombuffer(bytes(payload), dtype=np.uint8))
    if len(buf) < 12:
        raise corrupt("wide payload header")
    if _numpy_engine():
        try:
            return wide_decode_ref(bytes(payload))
        except (IndexError, ValueError, KeyError, struct.error) as e:
            raise corrupt(f"wide payload ({e})") from None
    lib = native.load()
    (isize,) = struct.unpack_from("<I", buf, 0)
    out = np.empty(int(isize), dtype=np.uint8)
    rc = lib.tbsc_wide_decode(native.u8p(buf), len(buf), native.u8p(out),
                              len(out))
    if rc < 0:
        raise corrupt(f"wide payload (native error {rc})")
    return out[:rc].tobytes()


# ---------------------------------------------------------------------------
# reference implementation (numpy, lane-lockstep like the device kernels)
# ---------------------------------------------------------------------------

class _RcEnc:
    """Carry-less range coder, one u16 per renormalization."""

    __slots__ = ("low", "rng", "out")

    def __init__(self):
        self.low = 0
        self.rng = 0xFFFFFFFF
        self.out = []  # units in emission order, filled by the encode loop

    def encode(self, bit: int, p: int) -> bool:
        """Returns True when a unit was emitted (renormalization)."""
        r = (self.rng >> P_BITS) * p
        if bit:
            self.low = (self.low + r) & 0xFFFFFFFF
            self.rng -= r
        else:
            self.rng = r
        if self.rng < (1 << 16):
            if ((self.low ^ (self.low + self.rng - 1)) >> 16) != 0:
                # straddling a unit boundary: keep the larger side (the
                # decoder mirrors the same deterministic choice)
                lo_part = 0x10000 - (self.low & 0xFFFF)
                hi_part = self.rng - lo_part
                if hi_part > lo_part:
                    self.low = (self.low + lo_part) & 0xFFFFFFFF
                    self.rng = hi_part
                else:
                    self.rng = lo_part
            self.out.append((self.low >> 16) & 0xFFFF)
            self.low = (self.low << 16) & 0xFFFFFFFF
            self.rng = (self.rng << 16) & 0xFFFFFFFF
            return True
        return False

    def flush(self):
        for _ in range(2):
            self.out.append((self.low >> 16) & 0xFFFF)
            self.low = (self.low << 16) & 0xFFFFFFFF


class _RcDec:
    __slots__ = ("low", "rng", "code")

    def __init__(self, u0: int, u1: int):
        self.low = 0
        self.rng = 0xFFFFFFFF
        self.code = (u0 << 16) | u1

    def decode(self, p: int) -> tuple[int, bool]:
        """Returns (bit, needs_refill); on needs_refill the caller must call
        refill(unit) before the next decode."""
        r = (self.rng >> P_BITS) * p
        if ((self.code - self.low) & 0xFFFFFFFF) < r:
            bit = 0
            self.rng = r
        else:
            bit = 1
            self.low = (self.low + r) & 0xFFFFFFFF
            self.rng -= r
        if self.rng < (1 << 16):
            if ((self.low ^ (self.low + self.rng - 1)) >> 16) != 0:
                lo_part = 0x10000 - (self.low & 0xFFFF)
                hi_part = self.rng - lo_part
                if hi_part > lo_part:
                    self.low = (self.low + lo_part) & 0xFFFFFFFF
                    self.rng = hi_part
                else:
                    self.rng = lo_part
            self.low = (self.low << 16) & 0xFFFFFFFF
            self.rng = (self.rng << 16) & 0xFFFFFFFF
            return bit, True
        return bit, False

    def refill(self, unit: int):
        self.code = ((self.code << 16) | unit) & 0xFFFFFFFF


class _RansEnc:
    """Binary rANS lane (v3 coder).  Encoding runs in REVERSE bit order;
    `emits` collects units in emission order (= reverse of the decoder's
    consumption order for this lane).  State x is kept normalized in
    [2^16, 2^32); exactly 0 or 1 unit is emitted per bit, and the final
    state is the decoder's two warm-up units — no flush units and no
    interval clamping, which is the v2 coder's ~2.5% ratio overhead."""

    __slots__ = ("x", "emits")

    def __init__(self):
        self.x = 1 << 16
        self.emits = []

    def encode(self, bit: int, p: int) -> bool:
        """p = P(bit=0) in 1..4095 (12-bit).  Returns True on emission."""
        if bit:
            f, base = (1 << P_BITS) - p, p
        else:
            f, base = p, 0
        emitted = False
        if self.x >= (f << 20):
            self.emits.append(self.x & 0xFFFF)
            self.x >>= 16
            emitted = True
        self.x = ((self.x // f) << P_BITS) + (self.x % f) + base
        return emitted

    def warm(self) -> tuple[int, int]:
        """Final state as the decoder's two warm-up units (hi, lo)."""
        return (self.x >> 16) & 0xFFFF, self.x & 0xFFFF


class _RansDec:
    """Binary rANS decoder lane; mirrors _RansEnc exactly (same refill
    cadence as the encoder's emissions, in reverse)."""

    __slots__ = ("x",)

    def __init__(self, u0: int, u1: int):
        self.x = (u0 << 16) | u1

    def decode(self, p: int) -> tuple[int, bool]:
        slot = self.x & ((1 << P_BITS) - 1)
        hi = self.x >> P_BITS
        if slot < p:
            bit = 0
            self.x = p * hi + slot
        else:
            bit = 1
            self.x = ((1 << P_BITS) - p) * hi + slot - p
        return bit, self.x < (1 << 16)

    def refill(self, unit: int):
        self.x = ((self.x << 16) | unit) & 0xFFFFFFFF


def _upd(p: int, bit: int) -> int:
    if bit:
        return p - (p >> ADAPT_SHIFT)
    return p + ((4096 - p) >> ADAPT_SHIFT)


def _lane_bits(chunk: np.ndarray):
    """(ctx, bit) sequence for one lane (the executable bit schedule)."""
    mtf = list(range(256))
    out = []
    i = 0
    n = len(chunk)
    rhist = 0   # last four rank flags
    uhist = 0   # last four run flags
    prev_rb = 0  # previous rank's bit-length bucket
    prev_ub = 0  # previous run's bit-length bucket
    while i < n:
        c = int(chunk[i])
        j = i + 1
        while j < n and int(chunk[j]) == c:
            j += 1
        run = j - i
        i = j
        rank = mtf.index(c)
        mtf.pop(rank)
        mtf.insert(0, c)
        rf = 1 if rank != 0 else 0
        out.append((_CTX_RANK_FLAG + rhist, rf))
        rhist = ((rhist << 1) | rf) & 0xF
        if rank:
            brs = rank.bit_length()
            base = _CTX_RANK_EXP + 7 * prev_rb + 21 * (rhist & 1)
            for t in range(1, min(brs, RANK_EXP_CAP)):
                out.append((base + t - 1, 1))
            if brs < RANK_EXP_CAP:
                out.append((base + brs - 1, 0))
            v = 1
            for t in range(brs - 2, -1, -1):
                out.append((_CTX_RANK_MAN + RM_OFF[brs] + min(v - 1, 14),
                            (rank >> t) & 1))
                v = (v << 1) | ((rank >> t) & 1)
            prev_rb = _bucket3(brs)
        else:
            prev_rb = 0
        uf = 1 if run != 1 else 0
        out.append((_CTX_RUN_FLAG + 3 * uhist + _rank_bucket(rank), uf))
        uhist = ((uhist << 1) | uf) & 0xF
        if run != 1:
            brs = run.bit_length()
            base = _CTX_RUN_EXP + 24 * prev_ub
            for t in range(1, min(brs, RUN_EXP_CAP)):
                out.append((base + t - 1, 1))
            if brs < RUN_EXP_CAP:
                out.append((base + brs - 1, 0))
            v = 1
            bb = _bucket2(brs)
            for t in range(brs - 2, -1, -1):
                out.append((_CTX_RUN_MAN + 16 * bb + min(v, 15),
                            (run >> t) & 1))
                v = (v << 1) | ((run >> t) & 1)
            prev_ub = _bucket3(brs)
        else:
            prev_ub = 0
    return out


def wide_encode_ref(data: bytes | np.ndarray, n_lanes: int | None = None,
                    rans: bool = True):
    """Reference encoder.  Returns the payload bytes, or None when the
    result would not be smaller than the input.  rans=True emits the v3
    coder (flags bit 2): binary rANS lanes, zero clamp loss, the final
    coder state doubling as the warm-up units."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    isize = len(buf)
    if isize == 0:
        return None
    L = n_lanes or pick_lanes(isize)
    sizes = lane_sizes(isize, L)

    # per-lane bit schedules
    schedules = []
    off = 0
    for s in sizes:
        schedules.append(_lane_bits(buf[off:off + s]) if s else [])
        off += s

    if rans:
        return _encode_rans(isize, L, sizes, schedules,
                            struct.pack("<IHHI", isize, L,
                                        _FLAG_MODEL_V2 | _FLAG_RANS,
                                        max((len(s) for s in schedules),
                                            default=0)))

    # lockstep simulation: iteration i codes bit i of every live lane.
    # Per-lane unit queues + the renorm event list let us assemble the
    # stream in decoder consumption order afterwards.
    lanes = [_RcEnc() for _ in range(L)]
    pri = priors().tolist()
    probs = [list(pri) for _ in range(L)]
    events: list[int] = []  # lane of each renorm, in (iteration, lane) order
    max_bits = max((len(s) for s in schedules), default=0)
    # (max_bits is also recorded in the header for lockstep decoders)
    for it in range(max_bits):
        for k in range(L):
            sched = schedules[k]
            if it < len(sched):
                ctx, bit = sched[it]
                p = probs[k][ctx]
                if lanes[k].encode(bit, p):
                    events.append(k)
                probs[k][ctx] = _upd(p, bit)
    for k in range(L):
        if schedules[k]:
            lanes[k].flush()

    # assemble per 128-lane group in decoder consumption order: warm-up
    # (2 units per non-empty lane, lane order), then queue[r+2] at each
    # lane's r-th renorm event
    n_groups = -(-L // GROUP)
    gstreams: list[list[int]] = [[] for _ in range(n_groups)]
    next_unit = [0] * L
    for k in range(L):
        if schedules[k]:
            gstreams[k // GROUP].extend(lanes[k].out[0:2])
            next_unit[k] = 2
    for k in events:
        gstreams[k // GROUP].append(lanes[k].out[next_unit[k]])
        next_unit[k] += 1
    for k in range(L):
        assert next_unit[k] == len(lanes[k].out), (k, next_unit[k],
                                                   len(lanes[k].out))

    payload = struct.pack("<IHHI", isize, L, _FLAG_MODEL_V2, max_bits)
    payload += np.asarray([len(g) for g in gstreams], dtype="<u4").tobytes()
    for g in gstreams:
        payload += np.asarray(g, dtype="<u2").tobytes()
    if len(payload) >= isize:
        return None
    return payload


def _encode_rans(isize, L, sizes, schedules, header: bytes):
    """v3 coder core: forward model pass (per-bit probabilities), then a
    reverse lockstep rANS pass.  The decoder's refill at (iteration, lane)
    mirrors the encoder's emission at the same (iteration, lane) — the
    standard interleaved-rANS identity — so the stream is assembled in the
    same consumption order as v2: two warm units per live lane (lane
    order), then one unit per refill event in (iteration, lane) order."""
    pri = priors().tolist()
    pseqs = []
    for sched in schedules:
        probs = list(pri)
        ps = []
        for ctx, bit in sched:
            p = probs[ctx]
            ps.append(p)
            probs[ctx] = _upd(p, bit)
        pseqs.append(ps)

    lanes = [_RansEnc() for _ in range(L)]
    max_bits = max((len(s) for s in schedules), default=0)
    events = []  # (iteration, lane) of each emission
    for it in range(max_bits - 1, -1, -1):
        for k in range(L):
            sched = schedules[k]
            if it < len(sched):
                ctx, bit = sched[it]
                if lanes[k].encode(bit, pseqs[k][it]):
                    events.append((it, k))
    events.sort()

    n_groups = -(-L // GROUP)
    gstreams: list[list[int]] = [[] for _ in range(n_groups)]
    # lane k's consumption queue = reversed emissions
    queues = [lane.emits[::-1] for lane in lanes]
    next_unit = [0] * L
    for k in range(L):
        if schedules[k]:
            gstreams[k // GROUP].extend(lanes[k].warm())
    for _it, k in events:
        gstreams[k // GROUP].append(queues[k][next_unit[k]])
        next_unit[k] += 1
    for k in range(L):
        assert next_unit[k] == len(queues[k])

    payload = header
    payload += np.asarray([len(g) for g in gstreams], dtype="<u4").tobytes()
    for g in gstreams:
        payload += np.asarray(g, dtype="<u2").tobytes()
    if len(payload) >= isize:
        return None
    return payload


def wide_decode_ref(payload: bytes) -> bytes:
    isize, L, flags, _max_bits = struct.unpack_from("<IHHI", payload, 0)
    if not flags & _FLAG_MODEL_V2:
        raise ValueError("unsupported wide-profile model version")
    n_groups = -(-L // GROUP)
    off = 12
    explicit_sizes = None
    if flags & 1:
        explicit_sizes = np.frombuffer(payload, dtype="<u4", count=L,
                                       offset=off).astype(np.int64)
        off += 4 * L
    gunits = np.frombuffer(payload, dtype="<u4", count=n_groups, offset=off)
    off += 4 * n_groups
    gstreams = []
    for g in range(n_groups):
        gstreams.append(np.frombuffer(payload, dtype="<u2",
                                      count=int(gunits[g]), offset=off))
        off += 2 * int(gunits[g])
    if explicit_sizes is not None:
        sizes = [int(x) for x in explicit_sizes]
    else:
        sizes = lane_sizes(isize, L)
    return _decode_lockstep(isize, L, sizes, gstreams,
                            rans=bool(flags & _FLAG_RANS))


def _decode_lockstep(isize, L, sizes, gstreams, rans: bool = False) -> bytes:
    # Each group's stream is in consumption order: warm-up (2 per non-empty
    # lane), then one unit per renormalization in (iteration, lane) order.
    out = np.zeros(isize, dtype=np.uint8)
    offs = np.cumsum([0] + sizes[:-1])

    decs: list[_RcDec | None] = [None] * L
    pri = priors().tolist()
    probs = [list(pri) for _ in range(L)]
    mtfs = [list(range(256)) for _ in range(L)]
    # decode state machine per lane
    PH_RFLAG, PH_REXP, PH_RMAN, PH_UFLAG, PH_UEXP, PH_UMAN, PH_DONE = range(7)
    phase = [PH_RFLAG if sizes[k] else PH_DONE for k in range(L)]
    written = [0] * L
    rank = [0] * L
    brs = [0] * L
    t = [0] * L
    val = [0] * L
    rhist = [0] * L
    uhist = [0] * L
    prev_rb = [0] * L
    prev_ub = [0] * L

    gpos = [0] * len(gstreams)

    # warm-up: every live lane needs two units before its first decode
    for k in range(L):
        if phase[k] != PH_DONE:
            g = k // GROUP
            u0 = gstreams[g][gpos[g]]
            u1 = gstreams[g][gpos[g] + 1]
            gpos[g] += 2
            decs[k] = (_RansDec if rans else _RcDec)(int(u0), int(u1))

    live = sum(1 for k in range(L) if phase[k] != PH_DONE)
    while live > 0:
        refills = []
        for k in range(L):
            if phase[k] == PH_DONE:
                continue
            d = decs[k]
            # one bit for lane k
            if phase[k] == PH_RFLAG:
                ctx = _CTX_RANK_FLAG + rhist[k]
            elif phase[k] == PH_REXP:
                ctx = (_CTX_RANK_EXP + 7 * prev_rb[k] + 21 * (rhist[k] & 1)
                       + t[k] - 1)
            elif phase[k] == PH_RMAN:
                ctx = _CTX_RANK_MAN + RM_OFF[brs[k]] + min(val[k] - 1, 14)
            elif phase[k] == PH_UFLAG:
                ctx = (_CTX_RUN_FLAG + 3 * uhist[k]
                       + _rank_bucket(rank[k]))
            elif phase[k] == PH_UEXP:
                ctx = _CTX_RUN_EXP + 24 * prev_ub[k] + t[k] - 1
            else:
                ctx = (_CTX_RUN_MAN + 16 * _bucket2(brs[k])
                       + min(val[k], 15))
            p = probs[k][ctx]
            bit, need = d.decode(p)
            probs[k][ctx] = _upd(p, bit)
            if need:
                refills.append(k)

            # state transition
            if phase[k] == PH_RFLAG:
                rhist[k] = ((rhist[k] << 1) | bit) & 0xF
                if bit:
                    phase[k] = PH_REXP
                    t[k] = 1
                    brs[k] = 1
                else:
                    rank[k] = 0
                    prev_rb[k] = 0
                    phase[k] = PH_UFLAG
            elif phase[k] == PH_REXP:
                if bit:
                    brs[k] += 1
                    t[k] += 1
                    if brs[k] == RANK_EXP_CAP:
                        phase[k] = PH_RMAN
                        val[k] = 1
                        t[k] = 0
                        prev_rb[k] = _bucket3(brs[k])
                else:
                    prev_rb[k] = _bucket3(brs[k])
                    if brs[k] == 1:
                        rank[k] = 1
                        phase[k] = PH_UFLAG
                    else:
                        phase[k] = PH_RMAN
                        val[k] = 1
                        t[k] = 0
            elif phase[k] == PH_RMAN:
                val[k] = (val[k] << 1) | bit
                t[k] += 1
                if t[k] == brs[k] - 1:
                    rank[k] = val[k]
                    phase[k] = PH_UFLAG
            elif phase[k] == PH_UFLAG:
                uhist[k] = ((uhist[k] << 1) | bit) & 0xF
                if bit:
                    phase[k] = PH_UEXP
                    t[k] = 1
                    brs[k] = 1
                else:
                    prev_ub[k] = 0
                    _emit_run(out, offs, k, mtfs, rank, 1, written, sizes,
                              phase, PH_RFLAG, PH_DONE)
            elif phase[k] == PH_UEXP:
                if bit:
                    brs[k] += 1
                    t[k] += 1
                    if brs[k] == RUN_EXP_CAP:
                        phase[k] = PH_UMAN
                        val[k] = 1
                        t[k] = 0
                        prev_ub[k] = _bucket3(brs[k])
                else:
                    prev_ub[k] = _bucket3(brs[k])
                    phase[k] = PH_UMAN
                    val[k] = 1
                    t[k] = 0
            else:  # PH_UMAN
                val[k] = (val[k] << 1) | bit
                t[k] += 1
                if t[k] == brs[k] - 1:
                    _emit_run(out, offs, k, mtfs, rank, val[k], written,
                              sizes, phase, PH_RFLAG, PH_DONE)
        # refills in lane order within the iteration (a lane that finished
        # on this very bit still consumes its unit — the encoder emitted it)
        for k in refills:
            g = k // GROUP
            decs[k].refill(int(gstreams[g][gpos[g]]))
            gpos[g] += 1
        live = sum(1 for k in range(L) if phase[k] != PH_DONE)
    return out.tobytes()


def _emit_run(out, offs, k, mtfs, rank, run, written, sizes, phase,
              ph_next, ph_done):
    mtf = mtfs[k]
    c = mtf.pop(rank[k])
    mtf.insert(0, c)
    o = offs[k] + written[k]
    out[o:o + run] = c
    written[k] += run
    phase[k] = ph_done if written[k] >= sizes[k] else ph_next
