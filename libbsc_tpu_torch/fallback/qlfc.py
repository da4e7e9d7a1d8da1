"""QLFC entropy coders of the no-native engine (``TBSC_ENGINE=numpy``): a
pure-Python port of the native runtime (native/qlfc.cc, rc.h, cm.h),
bit-exact with the reference stream formats (coder/qlfc/qlfc.cpp).  Slow;
the tables are this package's own ``coder/tables/*.npy``.
"""

from __future__ import annotations

import numpy as np

from ..engine import coder_segments
from ..tables import TABLE_DIR

NOT_COMPRESSIBLE = -3

_stretch = np.load(TABLE_DIR / "stretch.npy")
_squash = np.load(TABLE_DIR / "squash.npy")
_rank_state = np.load(TABLE_DIR / "rank_state.npy")
_run_state = np.load(TABLE_DIR / "run_state.npy")


def _i16(x: int) -> int:
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def bsr(x: int) -> int:
    return x.bit_length() - 1


def _rank_state_of(ctx_rank4, ctx_run, hist):
    return int(_rank_state[(ctx_run << 11) | (ctx_rank4 << 3) | hist])


def _run_state_of(ctx_rank0, ctx_run, rank, hist):
    r = rank if rank < 7 else 7
    h = hist if hist < 7 else 7
    return int(_run_state[(ctx_rank0 << 10) | (ctx_run << 6) | (r << 3) | h])


# ---------------------------------------------------------------------------
# Range coder (rc.h port)
# ---------------------------------------------------------------------------

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


class RcDecoder:
    def __init__(self, data: bytes):
        self.units = np.frombuffer(
            data[:len(data) & ~1], dtype="<u2")
        self.pos = 0
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(3):
            self.code = ((self.code << 16) | self._get()) & 0xFFFFFFFF

    def _get(self) -> int:
        v = int(self.units[self.pos]) if self.pos < len(self.units) else 0
        self.pos += 1
        return v

    def decode(self, p: int, P: int = 12) -> int:
        if self.range < 0x10000:
            self.range = (self.range << 16) & 0xFFFFFFFF
            self.code = ((self.code << 16) | self._get()) & 0xFFFFFFFF
        r = (self.range >> P) * p
        if self.code >= r:
            self.range -= r
            self.code -= r
            return 1
        self.range = r
        return 0

    def decode_word(self) -> int:
        w = 0
        for _ in range(32):
            w = (w << 1) | self.decode(2048, 12)
        return w


# ---------------------------------------------------------------------------
# Probability counters + mixer (cm.h port)
# ---------------------------------------------------------------------------

def _upd0(p: int, th: int, ar: int) -> int:
    return _i16(p + (((4096 - th - p) * ar) >> 12))


def _upd1(p: int, th: int, ar: int) -> int:
    return _i16(p - (((p - th) * ar) >> 12))


def _upd(bit: int, p: int, th0: int, ar0: int, th1: int, ar1: int) -> int:
    d0 = p * ar0 - ((4096 - th0) * ar0 - 4095)
    d1 = p * ar1 - th1 * ar1
    return _i16(p - ((d1 if bit else d0) >> 12))


class Mixer:
    __slots__ = ("s0", "s1", "s2", "mixed", "idx", "apm", "w0", "w1", "w2")

    def __init__(self):
        self.w0 = self.w1 = 2048 << 5
        self.w2 = 0
        self.apm = [int(_squash[2048 + (p - 8) * 256]) for p in range(17)]
        self.s0 = self.s1 = self.s2 = 0
        self.mixed = 0
        self.idx = 0

    def mix(self, p0: int, p1: int, p2: int) -> int:
        self.s0 = int(_stretch[p0])
        self.s1 = int(_stretch[p1])
        self.s2 = int(_stretch[p2])
        st = _i16((self.s0 * self.w0 + self.s1 * self.w1 + self.s2 * self.w2) >> 17)
        if st < -2047:
            st = -2047
        if st > 2047:
            st = 2047
        self.idx = (st + 2048) >> 8
        frac = st & 255
        direct = int(_squash[2048 + st])
        apm = self.apm
        mapped = apm[self.idx] + (((apm[self.idx + 1] - apm[self.idx]) * frac) >> 8)
        self.mixed = (3 * direct + mapped) >> 2
        return self.mixed

    def learn(self, bit: int, lr0: int, lr1: int, lr2: int, th: int, ar: int):
        apm = self.apm
        if bit:
            apm[self.idx] = _upd1(apm[self.idx], th, ar)
            apm[self.idx + 1] = _upd1(apm[self.idx + 1], th, ar)
        else:
            apm[self.idx] = _upd0(apm[self.idx], th, ar)
            apm[self.idx + 1] = _upd0(apm[self.idx + 1], th, ar)
        eps = self.mixed - (1 if bit else 4095)
        self.w0 -= (lr0 * eps * self.s0) >> 16
        self.w1 -= (lr1 * eps * self.s1) >> 16
        self.w2 -= (lr2 * eps * self.s2) >> 16


# ---------------------------------------------------------------------------
# Model parameter families (format constants, qlfc_model.h:38-176)
# ---------------------------------------------------------------------------

# Each group: ((s.th0,s.ar0,s.th1,s.ar1),(c...),(p...),(mx...),lr0,lr1,lr2)
_ADAPTIVE = {
    "rank_t": ((1, 57, -111, 31), (291, 250, 154, 528), (375, 163, 313, 639), (-41, 96, 53, 49), 20, 47, 27),
    "rank_e": ((-137, 17, 482, 40), (61, 192, 200, 133), (54, 1342, 578, 1067), (-11, 318, 144, 848), 49, 41, 40),
    "rank_m": ((-145, 18, 114, 24), (-43, 69, -36, 78), (-2, 1119, 11, 1181), (-203, 20, -271, 15), 263, 175, 17),
    "rank_p": ((-99, 32, 318, 42), (17, 101, 1116, 246), (22, 964, -2, 1110), (-194, 21, -129, 20), 480, 202, 17),
    "run_t": ((-93, 34, -4, 51), (139, 423, 244, 162), (275, 450, -6, 579), (-68, 25, 1, 64), 15, 50, 78),
    "run_e": ((-116, 31, 43, 45), (165, 222, 30, 324), (315, 857, 109, 867), (-14, 215, 61, 73), 35, 37, 42),
    "run_m": ((-176, 14, -141, 21), (84, 172, 37, 263), (2, 15, -197, 20), (-27, 142, -146, 27), 51, 44, 80),
}
_STATIC = {
    "rank_t": ((-116, 33, -78, 34), (-2, 282, 12, 274), (4, 697, 55, 1185), (0, 0, 0, 0), 17, 14, 1),
    "rank_e": ((-177, 23, -370, 11), (-14, 271, 3, 308), (-3, 788, 135, 1364), (0, 0, 0, 0), 22, 6, 4),
    "rank_m": ((-254, 16, -177, 20), (-55, 73, -54, 74), (-6, 575, 1670, 1173), (0, 0, 0, 0), 15, 10, 7),
    "rank_p": ((-126, 32, -126, 32), (-33, 120, -25, 157), (-6, 585, 150, 275), (0, 0, 0, 0), 16, 11, 5),
    "run_t": ((-68, 38, -112, 36), (-4, 221, -13, 231), (0, 0, 0, 0), (0, 0, 0, 0), 14, 18, 0),
    "run_e": ((-90, 45, -92, 44), (-3, 325, -11, 341), (24, 887, -4, 765), (0, 0, 0, 0), 14, 15, 3),
    "run_m": ((-275, 14, -185, 22), (-18, 191, -15, 241), (-73, 54, -214, 19), (0, 0, 0, 0), 7, 15, 10),
}


class _M1:
    """CM model state (reference QlfcStatisticalModel1); probs init 2048."""

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
        self.mix_rank = [Mixer() for _ in range(256)]
        self.mix_rank_exp = [[Mixer() for _ in range(8)] for _ in range(8)]
        self.mix_rank_man = [Mixer() for _ in range(8)]
        self.mix_rank_esc = [Mixer() for _ in range(256)]
        self.mix_run = [Mixer() for _ in range(256)]
        self.mix_run_exp = [[Mixer() for _ in range(32)] for _ in range(32)]
        self.mix_run_man = [Mixer() for _ in range(32)]


# ---------------------------------------------------------------------------
# QLFC rank transform (native/qlfc.cc:155-186)
# ---------------------------------------------------------------------------

def _rank_transform(data: bytes):
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


# ---------------------------------------------------------------------------
# Alphabet codec (native/qlfc.cc:194-252)
# ---------------------------------------------------------------------------

def _encode_alphabet(rc: RcEncoder, mtf, track_max_rank: bool, P: int, prob: int):
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
                rc.encode((cur >> bit) & 1, prob, P)
        if cur == prev:
            if track_max_rank:
                max_rank = bsr(r - 1) if r > 1 else 0
            break
        prev = cur
        used[cur] = True
    return max_rank


def _decode_alphabet(rc: RcDecoder, track_max_rank: bool, P: int, prob: int):
    used = [False] * 256
    mtf = []
    max_rank, prev = 7, -1
    for r in range(256):
        cur = 0
        for bit in range(7, -1, -1):
            b0 = b1 = False
            for c in range(256):
                if c == prev or not used[c]:
                    if cur == (c >> (bit + 1)):
                        if (c >> bit) & 1:
                            b1 = True
                        else:
                            b0 = True
                        if b0 and b1:
                            break
            if b0 and b1:
                cur += cur + rc.decode(prob, P)
            else:
                cur += cur + (1 if b1 else 0)
        mtf.append(cur)
        if cur == prev:
            if track_max_rank:
                max_rank = bsr(r - 1) if r > 1 else 0
            break
        prev = cur
        used[cur] = True
    mtf += [0] * (256 - len(mtf))
    return mtf, max_rank


# ---------------------------------------------------------------------------
# CM engine (static + adaptive); direct port of native/qlfc.cc:263-566
# ---------------------------------------------------------------------------

def _group_p(adaptive, g, mx, pc, ps, pp):
    if adaptive:
        return mx.mix(pc, ps, pp)
    return (pc * g[4] + ps * g[5] + pp * g[6]) >> 5


def _group_learn(adaptive, g, mx, bit, arr_s, idx_s, arr_c, idx_c, obj, attr_p,
                 idx_p=None):
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
    if adaptive:
        gm = g[3]
        if bit:
            mx.learn(1, g[4], g[5], g[6], gm[2], gm[3])
        else:
            mx.learn(0, g[4], g[5], g[6], gm[0], gm[1])


def _group_learn_fused(g, bit, arr_s, idx_s, arr_c, idx_c, arr_p, idx_p):
    gs, gc, gp = g[0], g[1], g[2]
    arr_s[idx_s] = _upd(bit, int(arr_s[idx_s]), gs[0], gs[1], gs[2], gs[3])
    arr_c[idx_c] = _upd(bit, int(arr_c[idx_c]), gc[0], gc[1], gc[2], gc[3])
    arr_p[idx_p] = _upd(bit, int(arr_p[idx_p]), gp[0], gp[1], gp[2], gp[3])


def _cm_encode(data: bytes, osize: int, adaptive: bool):
    F = _ADAPTIVE if adaptive else _STATIC
    m = _M1()
    isize = len(data)

    ctx_rank0 = ctx_rank4 = ctx_run = avg_rank = 0
    rank_hist = [0] * 256
    run_hist = [0] * 256

    ranks, mtf = _rank_transform(data)

    rc = RcEncoder(osize)
    rc.encode_word(isize)
    max_rank = _encode_alphabet(rc, mtf, True, 12, 2048)

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
            mx = m.mix_rank[c]
            p = _group_p(adaptive, g, mx, int(m.rank_flag_c[c]), int(m.rank_flag_s[st]), m.rank_flag_p)
            bit = 1 if rank != 1 else 0
            _group_learn(adaptive, g, mx, bit, m.rank_flag_s, st, m.rank_flag_c, c, m, "rank_flag_p")
            rc.encode(bit, p)
            if rank == 1:
                rank_hist[c] = 0
            else:
                brs = bsr(rank)
                rank_hist[c] = brs
                g = F["rank_e"]
                mx = m.mix_rank_exp[1 if hist < 1 else hist][1]
                bit_i = 1
                while bit_i < brs:
                    p = _group_p(adaptive, g, mx, int(m.rank_exp_c[c][bit_i - 1]), int(m.rank_exp_s[st][bit_i - 1]), int(m.rank_exp_p[bit_i - 1]))
                    _group_learn(adaptive, g, mx, 1, m.rank_exp_s[st], bit_i - 1, m.rank_exp_c[c], bit_i - 1, m, "rank_exp_p", bit_i - 1)
                    rc.encode1(p)
                    mx = m.mix_rank_exp[bit_i + 1 if hist <= bit_i else hist][bit_i + 1]
                    bit_i += 1
                if brs < max_rank:
                    p = _group_p(adaptive, g, mx, int(m.rank_exp_c[c][bit_i - 1]), int(m.rank_exp_s[st][bit_i - 1]), int(m.rank_exp_p[bit_i - 1]))
                    _group_learn(adaptive, g, mx, 0, m.rank_exp_s[st], bit_i - 1, m.rank_exp_c[c], bit_i - 1, m, "rank_exp_p", bit_i - 1)
                    rc.encode0(p)
                g = F["rank_m"]
                mx = m.mix_rank_man[brs]
                ctx = 1
                for bit_i in range(brs - 1, -1, -1):
                    b = (rank >> bit_i) & 1
                    p = _group_p(adaptive, g, mx, int(m.rank_man_c[brs][c][ctx]), int(m.rank_man_s[brs][st][ctx]), int(m.rank_man_p[brs][ctx]))
                    if adaptive:
                        _group_learn(adaptive, g, mx, b, m.rank_man_s[brs][st], ctx, m.rank_man_c[brs][c], ctx, m, "rank_man_p", (brs, ctx))
                    else:
                        _group_learn_fused(g, b, m.rank_man_s[brs][st], ctx, m.rank_man_c[brs][c], ctx, m.rank_man_p[brs], ctx)
                    rc.encode(b, p)
                    ctx += ctx + b
        else:
            rank_hist[c] = bsr(rank)
            g = F["rank_p"]
            ctx = 1
            for bit_i in range(max_rank, -1, -1):
                mx = m.mix_rank_esc[ctx]
                b = (rank >> bit_i) & 1
                p = _group_p(adaptive, g, mx, int(m.rank_esc_c[c][ctx]), int(m.rank_esc_s[st][ctx]), int(m.rank_esc_p[ctx]))
                if adaptive:
                    _group_learn(adaptive, g, mx, b, m.rank_esc_s[st], ctx, m.rank_esc_c[c], ctx, m, "rank_esc_p", ctx)
                else:
                    _group_learn_fused(g, b, m.rank_esc_s[st], ctx, m.rank_esc_c[c], ctx, m.rank_esc_p, ctx)
                rc.encode(b, p)
                ctx += ctx + b

        avg_rank = (avg_rank * 124 + rank * 4) >> 7
        rank -= 1
        hist = run_hist[c]
        st = _run_state_of(ctx_rank0, ctx_run, rank, hist)

        g = F["run_t"]
        mx = m.mix_run[c]
        p = _group_p(adaptive, g, mx, int(m.run_flag_c[c]), int(m.run_flag_s[st]), m.run_flag_p)
        bit = 1 if run != 1 else 0
        _group_learn(adaptive, g, mx, bit, m.run_flag_s, st, m.run_flag_c, c, m, "run_flag_p")
        rc.encode(bit, p)
        if run == 1:
            run_hist[c] = (run_hist[c] + 2) >> 2
        else:
            brs = bsr(run)
            run_hist[c] = (run_hist[c] + 3 * brs + 3) >> 2
            g = F["run_e"]
            mx = m.mix_run_exp[1 if hist < 1 else hist][1]
            bit_i = 1
            while bit_i < brs:
                p = _group_p(adaptive, g, mx, int(m.run_exp_c[c][bit_i - 1]), int(m.run_exp_s[st][bit_i - 1]), int(m.run_exp_p[bit_i - 1]))
                _group_learn(adaptive, g, mx, 1, m.run_exp_s[st], bit_i - 1, m.run_exp_c[c], bit_i - 1, m, "run_exp_p", bit_i - 1)
                rc.encode1(p)
                mx = m.mix_run_exp[bit_i + 1 if hist <= bit_i else hist][bit_i + 1]
                bit_i += 1
            p = _group_p(adaptive, g, mx, int(m.run_exp_c[c][bit_i - 1]), int(m.run_exp_s[st][bit_i - 1]), int(m.run_exp_p[bit_i - 1]))
            _group_learn(adaptive, g, mx, 0, m.run_exp_s[st], bit_i - 1, m.run_exp_c[c], bit_i - 1, m, "run_exp_p", bit_i - 1)
            rc.encode0(p)
            g = F["run_m"]
            mx = m.mix_run_man[brs]
            ctx = 1
            for bit_i in range(brs - 1, -1, -1):
                b = (run >> bit_i) & 1
                p = _group_p(adaptive, g, mx, int(m.run_man_c[brs][c][ctx]), int(m.run_man_s[brs][st][ctx]), int(m.run_man_p[brs][ctx]))
                if adaptive:
                    _group_learn(adaptive, g, mx, b, m.run_man_s[brs][st], ctx, m.run_man_c[brs][c], ctx, m, "run_man_p", (brs, ctx))
                else:
                    _group_learn_fused(g, b, m.run_man_s[brs][st], ctx, m.run_man_c[brs][c], ctx, m.run_man_p[brs], ctx)
                rc.encode(b, p)
                if brs <= 5:
                    ctx += ctx + b
                else:
                    ctx += 1

        ctx_rank0 = ((ctx_rank0 << 1) | (1 if rank == 0 else 0)) & 0x7
        ctx_rank4 = ((ctx_rank4 << 2) | (rank if rank < 3 else 3)) & 0xFF
        ctx_run = ((ctx_run << 1) | (1 if run < 3 else 0)) & 0xF

    return rc.finish()


def _cm_decode(data: bytes, adaptive: bool) -> bytes:
    F = _ADAPTIVE if adaptive else _STATIC
    m = _M1()

    ctx_rank0 = ctx_rank4 = ctx_run = avg_rank = 0
    rank_hist = [0] * 256
    run_hist = [0] * 256

    rc = RcDecoder(data)
    n = rc.decode_word()
    mtf, max_rank = _decode_alphabet(rc, True, 12, 2048)

    out = bytearray()
    while len(out) < n:
        c = mtf[0]
        hist = rank_hist[c]
        st = _rank_state_of(ctx_rank4, ctx_run, hist)

        rank = 1
        if avg_rank < 32:
            g = F["rank_t"]
            mx = m.mix_rank[c]
            p = _group_p(adaptive, g, mx, int(m.rank_flag_c[c]), int(m.rank_flag_s[st]), m.rank_flag_p)
            bit = rc.decode(p)
            _group_learn(adaptive, g, mx, bit, m.rank_flag_s, st, m.rank_flag_c, c, m, "rank_flag_p")
            if bit:
                g = F["rank_e"]
                mx = m.mix_rank_exp[1 if hist < 1 else hist][1]
                brs = 1
                while brs != max_rank:
                    p = _group_p(adaptive, g, mx, int(m.rank_exp_c[c][brs - 1]), int(m.rank_exp_s[st][brs - 1]), int(m.rank_exp_p[brs - 1]))
                    be = rc.decode(p)
                    _group_learn(adaptive, g, mx, be, m.rank_exp_s[st], brs - 1, m.rank_exp_c[c], brs - 1, m, "rank_exp_p", brs - 1)
                    if not be:
                        break
                    brs += 1
                    mx = m.mix_rank_exp[brs if hist < brs else hist][brs]
                rank_hist[c] = brs
                g = F["rank_m"]
                mx = m.mix_rank_man[brs]
                for _ in range(brs):
                    p = _group_p(adaptive, g, mx, int(m.rank_man_c[brs][c][rank]), int(m.rank_man_s[brs][st][rank]), int(m.rank_man_p[brs][rank]))
                    bm = rc.decode(p)
                    if adaptive:
                        _group_learn(adaptive, g, mx, bm, m.rank_man_s[brs][st], rank, m.rank_man_c[brs][c], rank, m, "rank_man_p", (brs, rank))
                    else:
                        _group_learn_fused(g, bm, m.rank_man_s[brs][st], rank, m.rank_man_c[brs][c], rank, m.rank_man_p[brs], rank)
                    rank += rank + bm
            else:
                rank_hist[c] = 0
        else:
            g = F["rank_p"]
            rank = 0
            ctx = 1
            for _ in range(max_rank + 1):
                mx = m.mix_rank_esc[ctx]
                p = _group_p(adaptive, g, mx, int(m.rank_esc_c[c][ctx]), int(m.rank_esc_s[st][ctx]), int(m.rank_esc_p[ctx]))
                b = rc.decode(p)
                if adaptive:
                    _group_learn(adaptive, g, mx, b, m.rank_esc_s[st], ctx, m.rank_esc_c[c], ctx, m, "rank_esc_p", ctx)
                else:
                    _group_learn_fused(g, b, m.rank_esc_s[st], ctx, m.rank_esc_c[c], ctx, m.rank_esc_p, ctx)
                ctx += ctx + b
                rank += rank + b
            rank_hist[c] = bsr(rank | 1)

        for r in range(rank):
            mtf[r] = mtf[r + 1]
        mtf[rank] = c

        avg_rank = (avg_rank * 124 + rank * 4) >> 7
        rank -= 1
        hist = run_hist[c]
        st = _run_state_of(ctx_rank0, ctx_run, rank, hist)

        run = 1
        g = F["run_t"]
        mx = m.mix_run[c]
        p = _group_p(adaptive, g, mx, int(m.run_flag_c[c]), int(m.run_flag_s[st]), m.run_flag_p)
        bit = rc.decode(p)
        _group_learn(adaptive, g, mx, bit, m.run_flag_s, st, m.run_flag_c, c, m, "run_flag_p")
        if bit:
            g = F["run_e"]
            mx = m.mix_run_exp[1 if hist < 1 else hist][1]
            brs = 1
            while True:
                p = _group_p(adaptive, g, mx, int(m.run_exp_c[c][brs - 1]), int(m.run_exp_s[st][brs - 1]), int(m.run_exp_p[brs - 1]))
                be = rc.decode(p)
                _group_learn(adaptive, g, mx, be, m.run_exp_s[st], brs - 1, m.run_exp_c[c], brs - 1, m, "run_exp_p", brs - 1)
                if not be:
                    break
                brs += 1
                mx = m.mix_run_exp[brs if hist < brs else hist][brs]
            run_hist[c] = (run_hist[c] + 3 * brs + 3) >> 2
            g = F["run_m"]
            mx = m.mix_run_man[brs]
            ctx = 1
            for _ in range(brs):
                p = _group_p(adaptive, g, mx, int(m.run_man_c[brs][c][ctx]), int(m.run_man_s[brs][st][ctx]), int(m.run_man_p[brs][ctx]))
                bm = rc.decode(p)
                if adaptive:
                    _group_learn(adaptive, g, mx, bm, m.run_man_s[brs][st], ctx, m.run_man_c[brs][c], ctx, m, "run_man_p", (brs, ctx))
                else:
                    _group_learn_fused(g, bm, m.run_man_s[brs][st], ctx, m.run_man_c[brs][c], ctx, m.run_man_p[brs], ctx)
                run += run + bm
                if brs <= 5:
                    ctx += ctx + bm
                else:
                    ctx += 1
        else:
            run_hist[c] = (run_hist[c] + 2) >> 2

        ctx_rank0 = ((ctx_rank0 << 1) | (1 if rank == 0 else 0)) & 0x7
        ctx_rank4 = ((ctx_rank4 << 2) | (rank if rank < 3 else 3)) & 0xFF
        ctx_run = ((ctx_run << 1) | (1 if run < 3 else 0)) & 0xF

        out += bytes([c]) * run

    return bytes(out)


# ---------------------------------------------------------------------------
# Fast engine (Model2; native/qlfc.cc:572-759)
# ---------------------------------------------------------------------------

def _shift_upd(p: int, th: int, r: int) -> int:
    return _i16(p - ((p - th) >> r))


def _fast_encode(data: bytes, osize: int):
    isize = len(data)
    rank_exp = np.full((256, 8), 4096, dtype=np.int32)
    rank_man = np.full((256, 8, 256), 4096, dtype=np.int32)
    run_exp = np.full((256, 32), 1024, dtype=np.int32)
    run_man = np.full((256, 32, 32), 1024, dtype=np.int32)

    ranks, mtf = _rank_transform(data)
    rc = RcEncoder(osize)
    rc.encode_word(isize)
    _encode_alphabet(rc, mtf, False, 1, 1)

    pos = 0
    for rank in ranks:
        if rc.overflow():
            return None
        c = data[pos]
        run_start = pos
        pos += 1
        while pos < isize and data[pos] == c:
            pos += 1
        run = pos - run_start

        pr = rank_exp[c]
        if rank == 1:
            p = int(pr[0])
            pr[0] = _shift_upd(p, 8016, 4)
            rc.encode0(p, 13)
        else:
            p = int(pr[0])
            pr[0] = _shift_upd(p, 83, 4)
            rc.encode1(p, 13)
            brs = bsr(rank)
            for bit in range(1, brs):
                p = int(pr[bit])
                pr[bit] = _shift_upd(p, 122, 4)
                rc.encode1(p, 13)
            if brs < 7:
                p = int(pr[brs])
                pr[brs] = _shift_upd(p, 8114, 4)
                rc.encode0(p, 13)
            pm = rank_man[c][brs]
            ctx = 1
            for bit in range(brs - 1, -1, -1):
                b = (rank >> bit) & 1
                p = int(pm[ctx])
                pm[ctx] = _i16(p - ((p - (235 if b else 7999)) >> 7))
                rc.encode(b, p, 13)
                ctx += ctx + b

        pr = run_exp[c]
        if run == 1:
            p = int(pr[0])
            pr[0] = _shift_upd(p, 2025, 5)
            rc.encode0(p, 11)
        else:
            p = int(pr[0])
            pr[0] = _shift_upd(p, 42, 5)
            rc.encode1(p, 11)
            brs = bsr(run)
            for bit in range(1, brs):
                p = int(pr[bit])
                pr[bit] = _shift_upd(p, 142, 4)
                rc.encode1(p, 11)
            p = int(pr[brs])
            pr[brs] = _shift_upd(p, 1962, 4)
            rc.encode0(p, 11)
            pm = run_man[c][brs]
            ctx = 1
            if brs <= 5:
                for bit in range(brs - 1, -1, -1):
                    b = (run >> bit) & 1
                    p = int(pm[ctx])
                    pm[ctx] = _i16(p - ((p - (147 if b else 1951)) >> 6))
                    rc.encode(b, p, 11)
                    ctx += ctx + b
            else:
                for bit in range(brs - 1, -1, -1):
                    b = (run >> bit) & 1
                    p = int(pm[ctx])
                    pm[ctx] = _i16(p - ((p - (46 if b else 1987)) >> 5))
                    rc.encode(b, p, 11)
                    ctx += 1

    return rc.finish()


def _fast_decode(data: bytes) -> bytes:
    rank_exp = np.full((256, 8), 4096, dtype=np.int32)
    rank_man = np.full((256, 8, 256), 4096, dtype=np.int32)
    run_exp = np.full((256, 32), 1024, dtype=np.int32)
    run_man = np.full((256, 32, 32), 1024, dtype=np.int32)

    rc = RcDecoder(data)
    n = rc.decode_word()
    mtf, _ = _decode_alphabet(rc, False, 1, 1)

    out = bytearray()
    while len(out) < n:
        c = mtf[0]
        pr = rank_exp[c]
        p = int(pr[0])
        if rc.decode(p, 13):
            pr[0] = _shift_upd(p, 83, 4)
            brs = 1
            while brs < 7:
                p = int(pr[brs])
                if rc.decode(p, 13):
                    pr[brs] = _shift_upd(p, 122, 4)
                    brs += 1
                else:
                    pr[brs] = _shift_upd(p, 8114, 4)
                    break
            pm = rank_man[c][brs]
            rank = 1
            for _ in range(brs):
                p = int(pm[rank])
                b = rc.decode(p, 13)
                pm[rank] = _i16(p - ((p - (235 if b else 7999)) >> 7))
                rank += rank + b
            for r in range(rank):
                mtf[r] = mtf[r + 1]
            mtf[rank] = c
        else:
            mtf[0] = mtf[1]
            mtf[1] = c
            pr[0] = _shift_upd(p, 8016, 4)

        pr = run_exp[c]
        p = int(pr[0])
        if rc.decode(p, 11):
            pr[0] = _shift_upd(p, 42, 5)
            brs = 1
            while True:
                p = int(pr[brs])
                if rc.decode(p, 11):
                    pr[brs] = _shift_upd(p, 142, 4)
                    brs += 1
                else:
                    pr[brs] = _shift_upd(p, 1962, 4)
                    break
            pm = run_man[c][brs]
            run = 1
            if brs <= 5:
                for _ in range(brs):
                    p = int(pm[run])
                    b = rc.decode(p, 11)
                    pm[run] = _i16(p - ((p - (147 if b else 1951)) >> 6))
                    run += run + b
            else:
                for ctx in range(1, brs + 1):
                    p = int(pm[ctx])
                    b = rc.decode(p, 11)
                    pm[ctx] = _i16(p - ((p - (46 if b else 1987)) >> 5))
                    run += run + b
            out += bytes([c]) * run
        else:
            out.append(c)
            pr[0] = _shift_upd(p, 2025, 5)

    return bytes(out)


# ---------------------------------------------------------------------------
# Block dispatcher (native/coder.cc port)
# ---------------------------------------------------------------------------

def _qlfc_encode_block(data: bytes, osize: int, kind: int):
    if kind == 3:
        return _fast_encode(data, osize)
    return _cm_encode(data, osize, kind == 2)


def _qlfc_decode_block(data: bytes, kind: int) -> bytes:
    if kind == 3:
        return _fast_decode(data)
    return _cm_decode(data, kind == 2)


def _split_blocks(data: bytes, n_blocks: int):
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    samp = np.arange(1, n, 32)
    changes = samp[arr[samp] != arr[samp - 1]]
    rank_size = len(changes)
    starts, sizes = [0], []
    if rank_size > n_blocks:
        per_block = rank_size // n_blocks
        for bid in range(n_blocks - 1):
            i = int(changes[(bid + 1) * per_block - 1])
            sizes.append(i - starts[-1])
            starts.append(i)
        sizes.append(n - starts[-1])
    else:
        starts = [(n // n_blocks) * p for p in range(n_blocks)]
        sizes = [n // n_blocks] * (n_blocks - 1) + [n - (n // n_blocks) * (n_blocks - 1)]
    return starts, sizes


def coder_compress(data: np.ndarray, kind: int):
    raw = data.tobytes()
    n = len(raw)
    n_blocks = coder_segments(n)
    if n_blocks == 1:
        r = _qlfc_encode_block(raw, n - 1, kind)
        if r is None:
            return None
        return np.frombuffer(bytes([1]) + r, dtype=np.uint8).copy()

    starts, sizes = _split_blocks(raw, n_blocks)
    payloads = []
    out_ptr = 1 + 8 * n_blocks
    for b in range(n_blocks):
        budget = min(sizes[b], n - out_ptr)
        r = _qlfc_encode_block(raw[starts[b]:starts[b] + sizes[b]], budget, kind)
        if r is None:
            if out_ptr + sizes[b] >= n:
                return None
            r = raw[starts[b]:starts[b] + sizes[b]]
        payloads.append(r)
        out_ptr += len(r)
    out = bytearray([n_blocks])
    for b in range(n_blocks):
        out += int(sizes[b]).to_bytes(4, "little")
        out += int(len(payloads[b])).to_bytes(4, "little")
    for p in payloads:
        out += p
    return np.frombuffer(bytes(out), dtype=np.uint8).copy()


def coder_decompress(data: np.ndarray, kind: int):
    raw = data.tobytes()
    n_blocks = raw[0]
    if n_blocks == 1:
        return np.frombuffer(_qlfc_decode_block(raw[1:], kind), dtype=np.uint8).copy()
    ip = 1 + 8 * n_blocks
    out = bytearray()
    for b in range(n_blocks):
        out_size = int.from_bytes(raw[1 + 8 * b:5 + 8 * b], "little")
        in_size = int.from_bytes(raw[5 + 8 * b:9 + 8 * b], "little")
        seg = raw[ip:ip + in_size]
        ip += in_size
        if in_size != out_size:
            out += _qlfc_decode_block(seg, kind)
        else:
            out += seg
    return np.frombuffer(bytes(out), dtype=np.uint8).copy()
