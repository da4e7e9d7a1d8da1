"""Wide-lane binary range coder: L carry-counting range coders in lockstep,
in torch ops.

Every lane implements the native stream format exactly (native/rc.h, the
reference's coder/common/rangecoder.h): 32-bit low plus a carry, 32-bit
range, 16-bit output units, lazy carry resolution through a pending
counter, a three-unit decoder warm-up.  One step codes one bit per lane,
masked by a per-(step, lane) opcode, since lanes have different lengths.
The JAX package runs the step under ``lax.scan``; here a Python loop runs
the same step as torch ops over [L] state.  There is no hand kernel: no
Pallas kernel stands behind this module, and the production wide coders
(K4/K5) are the hand-written range coders.

u32 state is held in int64 and masked with ``& 0xFFFFFFFF``, because
torch's CPU backend has no uint32 shifts or compares.  The encoder logs
each step's emission (at most one unit and a run of pending units) and
the host assembles each lane's bytes; the decoder reads per-lane unit
buffers through per-lane cursors (one [L] gather per step).

``fallback/qlfc.RcEncoder`` / ``RcDecoder`` are the serial reference the
tests hold this against, lane by lane.
"""

from __future__ import annotations

import numpy as np
import torch

# per-(step, lane) opcodes
OP_NOOP = 0
OP_BIT = 1      # encode/decode one bit
OP_CSHIFT = 2   # finish: shift only if range < 2^16
OP_FSHIFT = 3   # finish: unconditional shift

_M32 = 0xFFFFFFFF


def _encode_steps(ops, bits, probs, precs):
    """ops/bits/probs/precs: int64 [S, L] step-major tensors.  Returns the
    emission log (emit_cond, emit_val, flush_cnt, flush_val), each [S, L]."""
    S, L = ops.shape
    dev = ops.device
    lo = torch.zeros(L, dtype=torch.int64, device=dev)
    carry = torch.zeros_like(lo)
    rng = torch.full_like(lo, _M32)
    cache = torch.zeros_like(lo)
    pending = torch.zeros_like(lo)
    emit_cond = torch.zeros((S, L), dtype=torch.bool, device=dev)
    emit_val = torch.zeros((S, L), dtype=torch.int64, device=dev)
    flush_cnt = torch.zeros_like(emit_val)
    flush_val = torch.zeros_like(emit_val)
    for s in range(S):
        op, bit, p, prec = ops[s], bits[s], probs[s], precs[s]
        is_bit = op == OP_BIT
        need = rng < 0x10000
        do_shift = (is_bit & need) | (op == OP_FSHIFT) | \
            ((op == OP_CSHIFT) & need)
        # rc.h shift(): emit the cached unit (plus the carry) and the
        # pending run when low cannot carry into it any more
        emit = do_shift & ((lo < 0xFFFF0000) | (carry == 1))
        emit_cond[s] = emit
        emit_val[s] = (cache + carry) & 0xFFFF
        flush_cnt[s] = torch.where(emit, pending, 0)
        flush_val[s] = (carry - 1) & 0xFFFF
        cache = torch.where(emit, lo >> 16, cache)
        pending = torch.where(do_shift, torch.where(emit, 0, pending + 1),
                              pending)
        lo = torch.where(do_shift, (lo << 16) & _M32, lo)
        carry = torch.where(do_shift, 0, carry)
        rng = torch.where(do_shift, (rng << 16) & _M32, rng)

        r = ((rng >> prec) * p) & _M32
        one = is_bit & (bit == 1)
        zero = is_bit & (bit == 0)
        new_lo = lo + r
        lo = torch.where(one, new_lo & _M32, lo)
        carry = torch.where(one, carry + (new_lo >> 32), carry)
        rng = torch.where(one, rng - r, torch.where(zero, r, rng))
    return emit_cond, emit_val, flush_cnt, flush_val


def encode(lanes, device="cuda"):
    """Encode per-lane (bit, prob, precision) sequences on ``device``.

    lanes: list of L sequences, each a list of (bit, prob, prec) tuples.
    Returns a list of L byte strings (each equal to the serial
    ``RcEncoder``'s output for its lane)."""
    L = len(lanes)
    S = max((len(s) for s in lanes), default=0) + 4
    ops = np.zeros((S, L), np.int64)
    bits = np.zeros((S, L), np.int64)
    probs = np.zeros((S, L), np.int64)
    precs = np.full((S, L), 12, np.int64)
    for lane, seq in enumerate(lanes):
        if seq:
            b, p, prec = np.asarray(seq, dtype=np.int64).T
            m = len(seq)
            ops[:m, lane] = OP_BIT
            bits[:m, lane] = b
            probs[:m, lane] = p
            precs[:m, lane] = prec
        ops[len(seq), lane] = OP_CSHIFT
        ops[len(seq) + 1:len(seq) + 4, lane] = OP_FSHIFT

    dev = torch.device(device)
    logs = _encode_steps(*(torch.from_numpy(a).to(dev)
                           for a in (ops, bits, probs, precs)))
    emit_cond, emit_val, flush_cnt, flush_val = (x.cpu().numpy()
                                                 for x in logs)

    out = []
    for lane in range(L):
        steps = np.nonzero(emit_cond[:, lane])[0]
        runs = 1 + flush_cnt[steps, lane]
        units = np.repeat(flush_val[steps, lane], runs)
        units[np.cumsum(runs) - runs] = emit_val[steps, lane]
        out.append(units.astype("<u2").tobytes())
    return out


def _decode_steps(ops, probs, precs, units):
    """units: int64 [L, U] per-lane unit buffers (zero-padded).  Returns the
    decoded bits, bool [S, L]."""
    S, L = ops.shape
    dev = ops.device
    U = units.shape[1]
    lane_idx = torch.arange(L, device=dev)

    def get(pos):
        return units[lane_idx, pos.clamp(max=U - 1)]

    # warm-up: three units per lane (the first is the encoder's zero cache)
    code = torch.zeros(L, dtype=torch.int64, device=dev)
    pos = torch.zeros(L, dtype=torch.int64, device=dev)
    for _ in range(3):
        code = ((code << 16) | get(pos)) & _M32
        pos = pos + 1
    rng = torch.full_like(code, _M32)
    out = torch.zeros((S, L), dtype=torch.bool, device=dev)
    for s in range(S):
        op, p, prec = ops[s], probs[s], precs[s]
        is_bit = op == OP_BIT
        need = is_bit & (rng < 0x10000)
        code = torch.where(need, ((code << 16) | get(pos)) & _M32, code)
        pos = torch.where(need, pos + 1, pos)
        rng = torch.where(need, (rng << 16) & _M32, rng)

        r = ((rng >> prec) * p) & _M32
        bit = (code >= r) & is_bit
        code = torch.where(bit, code - r, code)
        rng = torch.where(is_bit, torch.where(bit, rng - r, r), rng)
        out[s] = bit
    return out


def decode(lanes_probs, lane_streams, device="cuda"):
    """Decode per-lane (prob, precision) sequences from per-lane streams on
    ``device``.

    lanes_probs: list of L sequences of (prob, prec); lane_streams: list of
    L byte strings.  Returns a list of L bit lists."""
    L = len(lanes_probs)
    S = max((len(s) for s in lanes_probs), default=0)
    ops = np.zeros((S, L), np.int64)
    probs = np.zeros((S, L), np.int64)
    precs = np.full((S, L), 12, np.int64)
    for lane, seq in enumerate(lanes_probs):
        if seq:
            p, prec = np.asarray(seq, dtype=np.int64).T
            ops[:len(seq), lane] = OP_BIT
            probs[:len(seq), lane] = p
            precs[:len(seq), lane] = prec
    U = max(max((len(b) // 2 for b in lane_streams), default=1), 1)
    units = np.zeros((L, U), np.int64)
    for lane, b in enumerate(lane_streams):
        u = np.frombuffer(b[:len(b) & ~1], dtype="<u2")
        units[lane, :len(u)] = u

    dev = torch.device(device)
    bits = _decode_steps(*(torch.from_numpy(a).to(dev)
                           for a in (ops, probs, precs, units)))
    bits = bits.cpu().numpy()
    return [bits[:len(lanes_probs[lane]), lane].astype(int).tolist()
            for lane in range(L)]
