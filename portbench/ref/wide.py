"""The v3 wide coder (``CODER_QLFC_WIDE``, flag bit 2: binary rANS lanes)
as a plain encoder: the payload for a block and its lane table.

Format, per block of n bytes cut into L lanes (lane sizes explicit when
flag bit 0 is set, else ceil(n / L) each): each lane codes its runs as
(move-to-front rank, run length) in a bit schedule over 281 adaptive
binary contexts (12-bit probabilities from the format's priors, adapted
by 1/32), and each lane's bits go through a binary rANS coder run in
reverse.  Groups of 128 lanes share a stream of u16 units: the two
warm-up units (the final state) of each live lane in lane order, then
one unit for every emission, in (bit index, lane) order.  The payload
is ``<IHHI`` (n, L, flags, longest lane in bits), the lane sizes
(``<u4``, flag bit 0), the group unit counts (``<u4``), the streams.

The per-run work is vectorised in torch on the block's device; the two
passes that carry state from bit to bit (the model, the rANS coder) run
in lockstep over the lanes, there too.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

GROUP = 128
NCTX = 281
RANK_FLAG, RANK_EXP, RANK_MAN = 0, 16, 58
RUN_FLAG, RUN_EXP, RUN_MAN = 129, 177, 249
RM_OFF = (0, 0, 0, 1, 4, 11, 26, 41, 56)
RANK_CAP, RUN_CAP = 8, 25
FLAG_SIZES, FLAG_MODEL_V2, FLAG_RANS = 1, 2, 4


def priors() -> np.ndarray:
    """The format's 281 context priors (a copy of the format's table)."""
    path = Path(__file__).with_name("wide_priors_v2.json")
    return np.asarray(json.loads(path.read_text()), dtype=np.int64)


def equal_sizes(n: int, lanes: int) -> np.ndarray:
    chunk = -(-n // lanes)
    return np.clip(n - chunk * np.arange(lanes), 0, chunk).astype(np.int64)


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    for j in range(32):
        out += (x >> j) > 0
    return out


def _bucket3(b: torch.Tensor) -> torch.Tensor:
    return (b > 1).long() + (b > 3).long()


def runs(U: torch.Tensor, sizes: np.ndarray):
    """(lane, char, length) of every run, lanes in order; a lane's first
    byte always starts a run."""
    dev = U.device
    n = U.shape[0]
    starts = np.cumsum(sizes) - sizes
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[1:] = U[1:] != U[:-1]
    first[0] = True
    live = starts[sizes > 0]
    first[torch.from_numpy(live).to(dev)] = True
    pos = torch.nonzero(first).squeeze(1)
    length = torch.diff(pos, append=torch.tensor([n], device=dev))
    lane_of = torch.from_numpy(np.repeat(np.arange(len(sizes)),
                                         sizes)).to(dev)
    return lane_of[pos], U[pos].long(), length


def mtf_ranks(lane: torch.Tensor, char: torch.Tensor, lanes: int):
    """Move-to-front rank of each run's char, each lane starting from the
    identity list, in lockstep over the runs' index within their lane."""
    dev = lane.device
    count = torch.bincount(lane, minlength=lanes)
    first = torch.cumsum(count, 0) - count
    j = torch.arange(lane.shape[0], device=dev) - first[lane]
    width = int(count.max())
    grid = torch.zeros((width, lanes), dtype=torch.long, device=dev)
    grid[j, lane] = char
    # char d was last seen at time last[:, d]; the identity list is times
    # -1 (char 0) down to -256
    last = (-1 - torch.arange(256, device=dev)).repeat(lanes, 1)
    ranks = torch.empty((width, lanes), dtype=torch.long, device=dev)
    for t in range(width):
        c = grid[t][:, None]
        ranks[t] = (last > last.gather(1, c)).sum(1)
        last.scatter_(1, c, t)
    return ranks[j, lane]


def _prev(x: torch.Tensor, j: torch.Tensor, back: int, fill: int = 0):
    """x of the run ``back`` runs earlier in the same lane, else fill."""
    out = torch.full_like(x, fill)
    out[back:] = x[:-back] if back else x
    return torch.where(j >= back, out, fill)


def schedule(lane, rank, length, lanes: int):
    """(ctx i16 [L, B], bit u8 [L, B], bits a lane i64 [L]) on the runs'
    device: each lane's bit schedule, B the longest."""
    dev = lane.device
    count = torch.bincount(lane, minlength=lanes)
    j = torch.arange(lane.shape[0], device=dev) - (
        torch.cumsum(count, 0) - count)[lane]
    rf = (rank != 0).long()
    uf = (length != 1).long()
    rhist = sum(_prev(rf, j, b) << (b - 1) for b in range(1, 5))
    uhist = sum(_prev(uf, j, b) << (b - 1) for b in range(1, 5))
    br, bn = _bitlen(rank), _bitlen(length)
    prev_rb = _prev(torch.where(rf > 0, _bucket3(br), 0), j, 1)
    prev_ub = _prev(torch.where(uf > 0, _bucket3(bn), 0), j, 1)
    rexp = torch.where(rf > 0, br.clamp(max=RANK_CAP) - 1
                       + (br < RANK_CAP).long(), 0)
    rman = torch.where(rf > 0, br - 1, 0)
    uexp = torch.where(uf > 0, bn.clamp(max=RUN_CAP) - 1
                       + (bn < RUN_CAP).long(), 0)
    uman = torch.where(uf > 0, bn - 1, 0)
    nb = 2 + rexp + rman + uexp + uman
    run = torch.repeat_interleave(torch.arange(lane.shape[0], device=dev),
                                  nb)
    q = torch.arange(run.shape[0], device=dev) - (torch.cumsum(nb, 0)
                                                 - nb)[run]
    del j
    R, N = rank[run], length[run]
    e1 = 1 + rexp[run]              # end of the rank's exponent
    e2 = e1 + rman[run]             # end of its mantissa (the run flag)
    e3 = e2 + 1 + uexp[run]         # end of the run's exponent
    bR, bN = br[run], bn[run]
    # rank flag
    ctx = RANK_FLAG + rhist[run]
    bit = rf[run].clone()
    # rank exponent: ones, then a zero below the cap
    m = (q >= 1) & (q < e1)
    e = q - 1
    ctx = torch.where(m, RANK_EXP + 7 * prev_rb[run] + 21 + e, ctx)
    bit = torch.where(m, (e < bR.clamp(max=RANK_CAP) - 1).long(), bit)
    # rank mantissa, top bit first below the leading one
    m = (q >= e1) & (q < e2)
    t = (bR - 2 - (q - e1)).clamp(min=0)
    v = R >> (t + 1)
    rm = torch.tensor(RM_OFF, device=dev)[bR.clamp(max=RANK_CAP)]
    ctx = torch.where(m, RANK_MAN + rm + (v - 1).clamp(max=14), ctx)
    bit = torch.where(m, (R >> t) & 1, bit)
    # run flag
    m = q == e2
    rb = (R > 0).long() + (R > 2).long()
    ctx = torch.where(m, RUN_FLAG + 3 * uhist[run] + rb, ctx)
    bit = torch.where(m, uf[run], bit)
    # run exponent
    m = (q > e2) & (q < e3)
    e = q - e2 - 1
    ctx = torch.where(m, RUN_EXP + 24 * prev_ub[run] + e, ctx)
    bit = torch.where(m, (e < bN.clamp(max=RUN_CAP) - 1).long(), bit)
    # run mantissa
    m = q >= e3
    t = (bN - 2 - (q - e3)).clamp(min=0)
    v = N >> (t + 1)
    ctx = torch.where(m, RUN_MAN + 16 * (bN > 3).long() + v.clamp(max=15),
                      ctx)
    bit = torch.where(m, (N >> t) & 1, bit)
    del R, N, e1, e2, e3, bR, bN, t, v, m, e, rm, rb
    per_lane = torch.zeros(lanes, dtype=torch.long, device=dev)
    per_lane.index_add_(0, lane, nb)
    width = int(per_lane.max()) if lanes else 0
    lane_b = lane[run]
    pos = torch.arange(run.shape[0], device=dev) - (
        torch.cumsum(per_lane, 0) - per_lane)[lane_b]
    C = torch.zeros((lanes, width), dtype=torch.int16, device=dev)
    B = torch.zeros((lanes, width), dtype=torch.uint8, device=dev)
    C[lane_b, pos] = ctx.to(torch.int16)
    B[lane_b, pos] = bit.to(torch.uint8)
    return C, B, per_lane


def model(Ct: torch.Tensor, Bt: torch.Tensor) -> torch.Tensor:
    """Each bit's probability of a zero (12 bits) before its context
    adapts; lanes in lockstep.  ``Ct`` i64 [B, L] (bit index major) each
    bit's context plus 281 times its lane, ``Bt`` bool [B, L] the bits.
    Returns i32 [B, L]."""
    width, L = Ct.shape
    prob = torch.from_numpy(priors()).to(Ct.device).repeat(L)
    P = torch.empty((width, L), dtype=torch.int32, device=Ct.device)
    for it in range(width):
        idx = Ct[it]
        p = prob[idx]
        P[it] = p
        prob[idx] = torch.where(Bt[it], p - (p >> 5),
                                p + ((4096 - p) >> 5))
    return P


def rans(P: torch.Tensor, Bt: torch.Tensor, bits: torch.Tensor):
    """Binary rANS over each lane's bits in reverse: (final state [L],
    emitted [B, L] bool, the unit each emission wrote [B, L]).  A bit
    past its lane's end takes frequency 4096 and offset 0, which leaves
    the state as it is and emits nothing."""
    width, L = P.shape
    dev = P.device
    live = torch.arange(width, device=dev)[:, None] < bits[None, :]
    F = torch.where(live, torch.where(Bt, 4096 - P, P), 4096).long()
    A = torch.where(live & Bt, P, 0).long()
    del live
    x = torch.full((L,), 1 << 16, dtype=torch.int64, device=dev)
    emitted = torch.empty((width, L), dtype=torch.bool, device=dev)
    units = torch.empty((width, L), dtype=torch.int32, device=dev)
    for it in range(width - 1, -1, -1):
        f = F[it]
        e = x >= (f << 20)
        emitted[it] = e
        units[it] = x & 0xFFFF
        x = torch.where(e, x >> 16, x)
        x = ((x // f) << 12) + x % f + A[it]
    return x, emitted, units


def encode_many(jobs) -> list:
    """The v3 payload of each (U u8 [n] the BWT output, ``sizes`` the
    lane table, written when flag bit 0 of ``flags`` is set) in
    ``jobs``; the passes that carry state from bit to bit run over the
    lanes of every job at once, on the jobs' device."""
    dev = jobs[0][0].device
    scheds = []
    for U, sizes, flags in jobs:
        L = len(sizes)
        lane, char, length = runs(U, sizes)
        rank = mtf_ranks(lane, char, L)
        scheds.append(schedule(lane, rank, length, L))
        del lane, char, length, rank
    bits = torch.cat([b for _, _, b in scheds])
    width, lanes = int(bits.max()), int(bits.shape[0])
    Ct = torch.zeros((width, lanes), dtype=torch.int64, device=dev)
    Bt = torch.zeros((width, lanes), dtype=torch.bool, device=dev)
    lo = 0
    for C, B, _ in scheds:
        Ct[:C.shape[1], lo:lo + len(C)] = C.t()
        Bt[:B.shape[1], lo:lo + len(B)] = B.t().bool()
        lo += len(C)
    del scheds
    Ct += torch.arange(lanes, device=dev) * NCTX
    P = model(Ct, Bt)
    del Ct
    x, emitted, units = rans(P, Bt, bits)
    del P, Bt
    x, emitted, units, bits = (t.cpu().numpy() for t in
                               (x, emitted, units, bits))
    out, lo = [], 0
    for (U, sizes, flags) in jobs:
        L = len(sizes)
        k = slice(lo, lo + L)
        out.append(_payload(int(U.shape[0]), sizes, flags, bits[k], x[k],
                            emitted[:, k], units[:, k]))
        lo += L
    return out


def encode(U: torch.Tensor, sizes: np.ndarray, flags: int) -> bytes:
    """The v3 payload of one BWT output (see :func:`encode_many`)."""
    return encode_many([(U, sizes, flags)])[0]


def _payload(n, sizes, flags, bits, x, emitted, units) -> bytes:
    L = len(sizes)
    head = struct.pack("<IHHI", n, L, flags, int(bits.max()))
    if flags & FLAG_SIZES:
        head += np.asarray(sizes, dtype="<u4").tobytes()
    gunits, streams = [], []
    for g in range(-(-L // GROUP)):
        k = slice(g * GROUP, min(L, (g + 1) * GROUP))
        live = bits[k] > 0
        warm = np.stack([(x[k] >> 16) & 0xFFFF, x[k] & 0xFFFF], 1)[live]
        body = units[:, k][emitted[:, k]]
        streams.append(warm.reshape(-1).astype("<u2").tobytes()
                       + body.astype("<u2").tobytes())
        gunits.append(2 * int(live.sum()) + len(body))
    return head + np.asarray(gunits, dtype="<u4").tobytes() + b"".join(
        streams)
