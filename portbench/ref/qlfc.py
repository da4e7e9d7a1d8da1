"""The static QLFC coder (``CODER_QLFC_STATIC``, bsc's ``-e1``) as a plain
encoder: the spec in Python, and the same loops in plain C for speed.

:func:`encode_spec` is a frozen copy of the static half of the pure-Python
coder the program ships for machines without its native runtime (the
reference may not import the program): the QLFC rank transform (ranks
of the runs, read from the block's end, with the alphabet's order left
in the move-to-front table), the 32-bit word of the size, the alphabet,
then per run its rank and its length, each as binary decisions whose
probability is a fixed blend of three counters (the symbol's, the
state's, the position's), coded by a carryless range coder into u16
units.  A segment whose units reach ``(osize - 16) // 2`` at the start
of a run is not compressible (None).  6-40 s a MiB on one core (text
to random bytes).

:func:`encode` runs ``qlfc_static.c``: the same loops, built with the
system's C compiler at first use into a folder under the temporary
directory, called through ctypes (which releases the GIL, so segments
encode in parallel on threads).  The state tables are a copy of the
format's (``qlfc_tables.json``).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_tables = json.loads((_HERE / "qlfc_tables.json").read_text())
RANK_STATE = np.frombuffer(bytes.fromhex(_tables["rank_state"]),
                           dtype=np.uint8)
RUN_STATE = np.frombuffer(bytes.fromhex(_tables["run_state"]),
                          dtype=np.uint8)
del _tables

# Each group: ((s.th0, s.ar0, s.th1, s.ar1), (c...), (p...), (unused),
# weight of c, of s, of p) -- the static model's format constants.
STATIC = {
    "rank_t": ((-116, 33, -78, 34), (-2, 282, 12, 274), (4, 697, 55, 1185), (0, 0, 0, 0), 17, 14, 1),
    "rank_e": ((-177, 23, -370, 11), (-14, 271, 3, 308), (-3, 788, 135, 1364), (0, 0, 0, 0), 22, 6, 4),
    "rank_m": ((-254, 16, -177, 20), (-55, 73, -54, 74), (-6, 575, 1670, 1173), (0, 0, 0, 0), 15, 10, 7),
    "rank_p": ((-126, 32, -126, 32), (-33, 120, -25, 157), (-6, 585, 150, 275), (0, 0, 0, 0), 16, 11, 5),
    "run_t": ((-68, 38, -112, 36), (-4, 221, -13, 231), (0, 0, 0, 0), (0, 0, 0, 0), 14, 18, 0),
    "run_e": ((-90, 45, -92, 44), (-3, 325, -11, 341), (24, 887, -4, 765), (0, 0, 0, 0), 14, 15, 3),
    "run_m": ((-275, 14, -185, 22), (-18, 191, -15, 241), (-73, 54, -214, 19), (0, 0, 0, 0), 7, 15, 10),
}


def _i16(x: int) -> int:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def bsr(x: int) -> int:
    return x.bit_length() - 1


def _rank_state_of(ctx_rank4, ctx_run, hist):
    return int(RANK_STATE[(ctx_run << 11) | (ctx_rank4 << 3) | hist])


def _run_state_of(ctx_rank0, ctx_run, rank, hist):
    r = rank if rank < 7 else 7
    h = hist if hist < 7 else 7
    return int(RUN_STATE[(ctx_rank0 << 10) | (ctx_run << 6) | (r << 3) | h])


class RcEncoder:
    def __init__(self, osize: int):
        self.out = []
        self.max_units = max(0, (osize - 16) // 2)
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.pending = 0

    def overflow(self) -> bool:
        return len(self.out) >= self.max_units

    def _shift(self):
        lo32 = self.low & 0xFFFFFFFF
        carry = self.low >> 32
        if lo32 < 0xFFFF0000 or carry:
            self.out.append((self.cache + carry) & 0xFFFF)
            while self.pending:
                self.out.append((carry - 1) & 0xFFFF)
                self.pending -= 1
            self.cache = lo32 >> 16
        else:
            self.pending += 1
        self.low = (lo32 << 16) & 0xFFFFFFFF
        self.range = (self.range << 16) & 0xFFFFFFFF

    def encode0(self, p: int, P: int = 12):
        if self.range < 0x10000:
            self._shift()
        self.range = (self.range >> P) * p

    def encode1(self, p: int, P: int = 12):
        if self.range < 0x10000:
            self._shift()
        r = (self.range >> P) * p
        self.low += r
        self.range -= r

    def encode(self, bit: int, p: int, P: int = 12):
        if bit:
            self.encode1(p, P)
        else:
            self.encode0(p, P)

    def encode_word(self, w: int):
        for b in range(31, -1, -1):
            self.encode((w >> b) & 1, 2048, 12)

    def finish(self) -> bytes:
        if self.range < 0x10000:
            self._shift()
        self._shift()
        self._shift()
        self._shift()
        return np.asarray(self.out, dtype="<u2").tobytes()


def _upd0(p: int, th: int, ar: int) -> int:
    return _i16(p + (((4096 - th - p) * ar) >> 12))


def _upd1(p: int, th: int, ar: int) -> int:
    return _i16(p - (((p - th) * ar) >> 12))


def _upd(bit: int, p: int, th0: int, ar0: int, th1: int, ar1: int) -> int:
    d0 = p * ar0 - ((4096 - th0) * ar0 - 4095)
    d1 = p * ar1 - th1 * ar1
    return _i16(p - ((d1 if bit else d0) >> 12))


class _Model:
    """The static model's counters; each probability starts at 2048."""

    def __init__(self):
        z = lambda *shape: np.full(shape, 2048, dtype=np.int32)
        self.rank_flag_p = 2048
        self.rank_flag_s = z(256)
        self.rank_flag_c = z(256)
        self.rank_exp_p = z(8)
        self.rank_exp_s = z(256, 8)
        self.rank_exp_c = z(256, 8)
        self.rank_man_p = z(8, 256)
        self.rank_man_s = z(8, 256, 256)
        self.rank_man_c = z(8, 256, 256)
        self.rank_esc_p = z(256)
        self.rank_esc_s = z(256, 256)
        self.rank_esc_c = z(256, 256)
        self.run_flag_p = 2048
        self.run_flag_s = z(256)
        self.run_flag_c = z(256)
        self.run_exp_p = z(32)
        self.run_exp_s = z(256, 32)
        self.run_exp_c = z(256, 32)
        self.run_man_p = z(32, 32)
        self.run_man_s = z(32, 256, 32)
        self.run_man_c = z(32, 256, 32)


def rank_transform(data: bytes):
    """(the rank of each run, the final move-to-front table)."""
    n = len(data)
    mtf = list(range(256))
    seen = [False] * 256
    if data[n - 1] == 0:
        mtf[0], mtf[1] = 1, 0
    ranks = []
    n_sym = 0
    i = n - 1
    while i >= 0:
        c = data[i]
        i -= 1
        while i >= 0 and data[i] == c:
            i -= 1
        prev = mtf[0]
        rank = 1
        mtf[0] = c
        while True:
            t = mtf[rank]
            mtf[rank] = prev
            if t == c:
                break
            prev = t
            rank += 1
        if not seen[c]:
            seen[c] = True
            rank = n_sym
            n_sym += 1
        ranks.append(rank)
    ranks.reverse()
    ranks[-1] = 1  # buffer[n-1] = 1 sentinel; never consumed as a rank
    for r in range(1, 256):
        if not seen[mtf[r]]:
            mtf[r] = mtf[r - 1]
            break
    return ranks, mtf


def _encode_alphabet(rc: RcEncoder, mtf):
    used = [False] * 256
    max_rank, prev = 7, -1
    for r in range(256):
        cur = mtf[r]
        for bit in range(7, -1, -1):
            b0 = b1 = False
            for c in range(256):
                if c == prev or not used[c]:
                    if (cur >> (bit + 1)) == (c >> (bit + 1)):
                        if (c >> bit) & 1:
                            b1 = True
                        else:
                            b0 = True
                        if b0 and b1:
                            break
            if b0 and b1:
                rc.encode((cur >> bit) & 1, 2048, 12)
        if cur == prev:
            max_rank = bsr(r - 1) if r > 1 else 0
            break
        prev = cur
        used[cur] = True
    return max_rank


def _p(g, pc, ps, pp):
    return (pc * g[4] + ps * g[5] + pp * g[6]) >> 5


def _learn(g, bit, arr_s, idx_s, arr_c, idx_c, obj, attr_p, idx_p=None):
    gs, gc, gp = g[0], g[1], g[2]
    if bit:
        arr_s[idx_s] = _upd1(int(arr_s[idx_s]), gs[2], gs[3])
        arr_c[idx_c] = _upd1(int(arr_c[idx_c]), gc[2], gc[3])
        if idx_p is None:
            setattr(obj, attr_p, _upd1(getattr(obj, attr_p), gp[2], gp[3]))
        else:
            arr = getattr(obj, attr_p)
            arr[idx_p] = _upd1(int(arr[idx_p]), gp[2], gp[3])
    else:
        arr_s[idx_s] = _upd0(int(arr_s[idx_s]), gs[0], gs[1])
        arr_c[idx_c] = _upd0(int(arr_c[idx_c]), gc[0], gc[1])
        if idx_p is None:
            setattr(obj, attr_p, _upd0(getattr(obj, attr_p), gp[0], gp[1]))
        else:
            arr = getattr(obj, attr_p)
            arr[idx_p] = _upd0(int(arr[idx_p]), gp[0], gp[1])


def _learn_fused(g, bit, arr_s, idx_s, arr_c, idx_c, arr_p, idx_p):
    gs, gc, gp = g[0], g[1], g[2]
    arr_s[idx_s] = _upd(bit, int(arr_s[idx_s]), gs[0], gs[1], gs[2], gs[3])
    arr_c[idx_c] = _upd(bit, int(arr_c[idx_c]), gc[0], gc[1], gc[2], gc[3])
    arr_p[idx_p] = _upd(bit, int(arr_p[idx_p]), gp[0], gp[1], gp[2], gp[3])


def encode_spec(data: bytes, osize: int):
    """Static QLFC units of ``data`` (1 byte or more) as bytes, or None
    when they pass ``osize``'s budget."""
    F = STATIC
    m = _Model()
    isize = len(data)

    ctx_rank0 = ctx_rank4 = ctx_run = avg_rank = 0
    rank_hist = [0] * 256
    run_hist = [0] * 256

    ranks, mtf = rank_transform(data)

    rc = RcEncoder(osize)
    rc.encode_word(isize)
    max_rank = _encode_alphabet(rc, mtf)

    pos = 0
    ri = 0
    while ri < len(ranks):
        if rc.overflow():
            return None

        c = data[pos]
        run_start = pos
        pos += 1
        while pos < isize and data[pos] == c:
            pos += 1
        run = pos - run_start

        rank = ranks[ri]
        ri += 1
        hist = rank_hist[c]
        st = _rank_state_of(ctx_rank4, ctx_run, hist)

        if avg_rank < 32:
            g = F["rank_t"]
            p = _p(g, int(m.rank_flag_c[c]), int(m.rank_flag_s[st]), m.rank_flag_p)
            bit = 1 if rank != 1 else 0
            _learn(g, bit, m.rank_flag_s, st, m.rank_flag_c, c, m, "rank_flag_p")
            rc.encode(bit, p)
            if rank == 1:
                rank_hist[c] = 0
            else:
                brs = bsr(rank)
                rank_hist[c] = brs
                g = F["rank_e"]
                bit_i = 1
                while bit_i < brs:
                    p = _p(g, int(m.rank_exp_c[c][bit_i - 1]), int(m.rank_exp_s[st][bit_i - 1]), int(m.rank_exp_p[bit_i - 1]))
                    _learn(g, 1, m.rank_exp_s[st], bit_i - 1, m.rank_exp_c[c], bit_i - 1, m, "rank_exp_p", bit_i - 1)
                    rc.encode1(p)
                    bit_i += 1
                if brs < max_rank:
                    p = _p(g, int(m.rank_exp_c[c][bit_i - 1]), int(m.rank_exp_s[st][bit_i - 1]), int(m.rank_exp_p[bit_i - 1]))
                    _learn(g, 0, m.rank_exp_s[st], bit_i - 1, m.rank_exp_c[c], bit_i - 1, m, "rank_exp_p", bit_i - 1)
                    rc.encode0(p)
                g = F["rank_m"]
                ctx = 1
                for bit_i in range(brs - 1, -1, -1):
                    b = (rank >> bit_i) & 1
                    p = _p(g, int(m.rank_man_c[brs][c][ctx]), int(m.rank_man_s[brs][st][ctx]), int(m.rank_man_p[brs][ctx]))
                    _learn_fused(g, b, m.rank_man_s[brs][st], ctx, m.rank_man_c[brs][c], ctx, m.rank_man_p[brs], ctx)
                    rc.encode(b, p)
                    ctx += ctx + b
        else:
            rank_hist[c] = bsr(rank)
            g = F["rank_p"]
            ctx = 1
            for bit_i in range(max_rank, -1, -1):
                b = (rank >> bit_i) & 1
                p = _p(g, int(m.rank_esc_c[c][ctx]), int(m.rank_esc_s[st][ctx]), int(m.rank_esc_p[ctx]))
                _learn_fused(g, b, m.rank_esc_s[st], ctx, m.rank_esc_c[c], ctx, m.rank_esc_p, ctx)
                rc.encode(b, p)
                ctx += ctx + b

        avg_rank = (avg_rank * 124 + rank * 4) >> 7
        rank -= 1
        hist = run_hist[c]
        st = _run_state_of(ctx_rank0, ctx_run, rank, hist)

        g = F["run_t"]
        p = _p(g, int(m.run_flag_c[c]), int(m.run_flag_s[st]), m.run_flag_p)
        bit = 1 if run != 1 else 0
        _learn(g, bit, m.run_flag_s, st, m.run_flag_c, c, m, "run_flag_p")
        rc.encode(bit, p)
        if run == 1:
            run_hist[c] = (run_hist[c] + 2) >> 2
        else:
            brs = bsr(run)
            run_hist[c] = (run_hist[c] + 3 * brs + 3) >> 2
            g = F["run_e"]
            bit_i = 1
            while bit_i < brs:
                p = _p(g, int(m.run_exp_c[c][bit_i - 1]), int(m.run_exp_s[st][bit_i - 1]), int(m.run_exp_p[bit_i - 1]))
                _learn(g, 1, m.run_exp_s[st], bit_i - 1, m.run_exp_c[c], bit_i - 1, m, "run_exp_p", bit_i - 1)
                rc.encode1(p)
                bit_i += 1
            p = _p(g, int(m.run_exp_c[c][bit_i - 1]), int(m.run_exp_s[st][bit_i - 1]), int(m.run_exp_p[bit_i - 1]))
            _learn(g, 0, m.run_exp_s[st], bit_i - 1, m.run_exp_c[c], bit_i - 1, m, "run_exp_p", bit_i - 1)
            rc.encode0(p)
            g = F["run_m"]
            ctx = 1
            for bit_i in range(brs - 1, -1, -1):
                b = (run >> bit_i) & 1
                p = _p(g, int(m.run_man_c[brs][c][ctx]), int(m.run_man_s[brs][st][ctx]), int(m.run_man_p[brs][ctx]))
                _learn_fused(g, b, m.run_man_s[brs][st], ctx, m.run_man_c[brs][c], ctx, m.run_man_p[brs], ctx)
                rc.encode(b, p)
                if brs <= 5:
                    ctx += ctx + b
                else:
                    ctx += 1

        ctx_rank0 = ((ctx_rank0 << 1) | (1 if rank == 0 else 0)) & 0x7
        ctx_rank4 = ((ctx_rank4 << 2) | (rank if rank < 3 else 3)) & 0xFF
        ctx_run = ((ctx_run << 1) | (1 if run < 3 else 0)) & 0xF

    return rc.finish()


# ---------------------------------------------------------------------------
# The C loops
# ---------------------------------------------------------------------------

_SOURCE = _HERE / "qlfc_static.c"
_lib = None
_lib_lock = threading.Lock()
# units a segment may write past its budget: the size and the alphabet
# come before the first check, a run's decisions between two checks
_SLACK_UNITS = 1 << 16


def _build() -> Path:
    """The shared library of ``qlfc_static.c``, built once per source
    (its hash names the file) under the temporary directory."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out_dir = Path(tempfile.gettempdir()) / "portbench-ref"
    lib = out_dir / f"qlfc_static-{tag}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib.name}.{os.getpid()}.{threading.get_ident()}"
    errors = []
    compilers = [[c] for c in dict.fromkeys(
        c for c in (os.environ.get("CC"), "cc", "gcc", "clang") if c)]
    for cc in compilers + [["g++", "-x", "c"]]:
        try:
            proc = subprocess.run(
                [*cc, "-O2", "-shared", "-fPIC", "-o", str(tmp),
                 str(_SOURCE)], capture_output=True, text=True)
        except OSError as e:
            errors.append(f"{cc[0]}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: concurrent builders agree
            return lib
        errors.append(f"{cc[0]}: {proc.stderr}")
    raise OSError("building the reference's QLFC coder failed:\n"
                  + "\n".join(errors))


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.qlfc_static_encode.restype = ctypes.c_int64
            lib.qlfc_static_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p]
            _lib = lib
    return _lib


def encode(data, osize: int):
    """:func:`encode_spec` of ``data`` (bytes or u8 ndarray, 1 byte or
    more) by the C loops: the same bytes, or None."""
    lib = _load()
    buf = np.ascontiguousarray(np.frombuffer(memoryview(data),
                                             dtype=np.uint8))
    cap = max(0, (osize - 16) // 2) + _SLACK_UNITS
    out = np.empty(cap, dtype=np.uint16)
    units = lib.qlfc_static_encode(buf.ctypes.data, len(buf), osize,
                                   out.ctypes.data, cap,
                                   RANK_STATE.ctypes.data,
                                   RUN_STATE.ctypes.data)
    if units == -1:
        return None
    if units < 0:
        raise RuntimeError(f"qlfc_static_encode failed ({units})")
    return out[:units].astype("<u2").tobytes()
