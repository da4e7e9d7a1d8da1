"""K3/K4's two halves as plain versions: the record-writing chain (the
lane state machine in table form) and the move-to-front / run expansion.
Their composition against the block and the native decode on a block
with high ranks and long runs (test_torch_wide_decode.py holds the JAX
package's decode kernel against the port's), and the table against the
switch form of the state machine (_sm_ctx / _sm_next) at every reachable
position.  All comparisons are exact: the codec is lossless."""

import numpy as np
import pytest
import torch

from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk


@pytest.fixture(scope="module")
def block():
    """Uniform bytes (ranks up to 255) in 640 lanes of 32 bytes, then
    zeros in 8 lanes of 2,560 bytes (one run each), the other 376 lanes
    dead."""
    g = np.random.default_rng(41)
    data = np.concatenate([g.integers(0, 256, 20480),
                           np.zeros(20480, np.int64)]).astype(np.uint8)
    sizes = np.zeros(1024, np.int32)
    sizes[:640] = 32
    sizes[640::48][:8] = 2560
    return data.tobytes(), sizes


def _halves(payload):
    args = pwk._dec_args(pwk._dec_parse(payload), "cpu")
    warm, goff, lane_sz, lstart, stream, max_bits, n = args
    rans = pwk._dec_parse(payload)["rans"]
    rec, nrec = pwk.decode_records_plain(warm, goff, lane_sz, lstart, stream,
                                         max_bits, n, rans)
    return args, rans, rec, nrec


@pytest.mark.parametrize("rans", [True, False])
def test_halves_compose_to_the_block(block, rans):
    data, sizes = block
    payload = pwide.wide_encode(data, n_lanes=1024, sizes=sizes, rans=rans)
    args, _, rec, nrec = _halves(payload)
    lstart, n = args[3], args[6]
    out = pwk.expand_records_plain(rec, nrec, lstart, n)
    assert out.numpy().tobytes() == data
    assert torch.equal(out, pwk.decode_lanes_plain(*args, rans=rans))
    assert pwide.wide_decode(payload) == data


def test_records_hold_ranks_and_runs(block):
    data, sizes = block
    payload = pwide.wide_encode(data, n_lanes=1024, sizes=sizes, rans=True)
    args, _, rec, nrec = _halves(payload)
    lane_sz, lstart = args[2].long(), args[3].long()
    nrec = nrec.long()
    assert bool((nrec <= lane_sz).all())
    assert bool((nrec[lane_sz == 0] == 0).all())
    runs = torch.zeros(1024, dtype=torch.int64)
    top = 0
    for lane in range(1024):
        r = rec[lstart[lane]:lstart[lane] + nrec[lane]].long()
        runs[lane] = int((r >> 8).sum())
        top = max(top, int((r & 255).max()) if len(r) else 0)
    assert torch.equal(runs, lane_sz)  # runs clipped to their lane
    assert top >= 200  # the uniform lanes reach high ranks
    long_lanes = torch.nonzero(lane_sz == 2560)[:, 0]
    for lane in long_lanes.tolist():  # a zero run at rank 0: one record
        assert int(nrec[lane]) == 1
        assert int(rec[lstart[lane]]) == 2560 << 8


def test_expansion_against_a_list_move_to_front():
    g = np.random.default_rng(9)
    lane_sz = np.zeros(1024, np.int64)
    lane_sz[[0, 1, 130, 700, 1023]] = [50, 300, 7, 1000, 64]
    lstart = np.cumsum(lane_sz) - lane_sz
    n = int(lane_sz.sum())
    rec = np.zeros(n, np.int32)
    nrec = np.zeros(1024, np.int32)
    expect = bytearray(n)
    for lane in np.nonzero(lane_sz)[0]:
        table, at, k = list(range(256)), int(lstart[lane]), 0
        left = int(lane_sz[lane])
        while left:
            run = min(left, int(g.integers(1, 40)))
            rank = int(g.choice([0, 1, 2, int(g.integers(0, 256)), 255]))
            rec[lstart[lane] + k] = run << 8 | rank
            sym = table.pop(rank)
            table.insert(0, sym)
            expect[at:at + run] = bytes([sym]) * run
            at, left, k = at + run, left - run, k + 1
        nrec[lane] = k
    out = pwk.expand_records_plain(torch.from_numpy(rec),
                                   torch.from_numpy(nrec),
                                   torch.from_numpy(lstart.astype(np.int32)),
                                   n)
    assert out.numpy().tobytes() == bytes(expect)


def _switch_states(pos, n, g):
    """n switch-form states at one table position, random histories."""
    ph, t, brs = pos
    stuck = ph == pwk._PH_UMAN and brs == 1
    tt = g.integers(0, 40, n) if stuck else np.full(n, t)
    if ph in (pwk._PH_RMAN, pwk._PH_UMAN) and not stuck:
        val = (1 << t) + g.integers(0, 1 << t, n)  # t mantissa bits so far
    else:
        val = g.integers(0, 1 << 20, n)
    cols = [np.full(n, ph), tt, np.full(n, brs), val,
            g.integers(0, 256, n), g.integers(0, 16, n),
            g.integers(0, 16, n), g.integers(0, 3, n), g.integers(0, 3, n)]
    return [torch.from_numpy(np.asarray(c, np.int64)) for c in cols]


def test_sm_table_equals_the_switch_form():
    g = np.random.default_rng(17)
    positions = pwk.sm_positions()
    tab = pwk.sm_table_tensor("cpu").long()
    n = 64
    for i, pos in enumerate(positions):
        for bit in (0, 1):
            st = _switch_states(pos, n, g)
            phase, t, brs, val, rank, rh, uh, prb, pub = st
            active = phase != pwk._PH_DONE
            base, kind = pwk._sm_base_kind(pos)
            ctx = base + pwk._sm_key(torch.full_like(phase, kind), rh, uh,
                                     prb, pub, val, rank)
            if pos[0] != pwk._PH_DONE:
                assert torch.equal(ctx, pwk._sm_ctx(st, active)), (pos, bit)
            b = torch.full_like(phase, bit if pos[0] != pwk._PH_DONE else 0)
            nst, comp, runlen = pwk._sm_next(st, b, active)
            (npos, nbase, nkind, nrh, nuh, nprb, npub, nval, nrank,
             run) = pwk._sm_apply(tab, torch.full_like(phase, i), b, rh, uh,
                                  prb, pub, val, rank)
            assert torch.equal(run, torch.where(comp, runlen, 0)), (pos, bit)
            for got, want in ((nrh, nst[5]), (nuh, nst[6]), (nprb, nst[7]),
                              (npub, nst[8]), (nval, nst[3]),
                              (nrank, nst[4])):
                assert torch.equal(got, want), (pos, bit)
            nxt = positions[int(npos[0])]
            assert bool((npos == npos[0]).all())
            assert bool((nst[0] == nxt[0]).all()), (pos, bit)
            if nxt[0] in (pwk._PH_REXP, pwk._PH_RMAN, pwk._PH_UEXP) or (
                    nxt[0] == pwk._PH_UMAN and nxt[2] > 1):
                assert bool((nst[1] == nxt[1]).all()), (pos, bit)
                assert bool((nst[2] == nxt[2]).all()), (pos, bit)
            if nxt[0] == pwk._PH_UMAN and nxt[2] == 1:
                assert bool((nst[2] == 1).all()), (pos, bit)
            if nxt[0] != pwk._PH_DONE:
                nctx = nbase + pwk._sm_key(nkind, nrh, nuh, nprb, npub, nval,
                                           nrank)
                assert torch.equal(nctx, pwk._sm_ctx(
                    nst, nst[0] != pwk._PH_DONE)), (pos, bit)


def test_every_table_position_is_reachable():
    tab = pwk.sm_table()
    seen, todo = {pwk.SM_RFLAG}, [pwk.SM_RFLAG]
    while todo:
        i = todo.pop()
        for word in (tab[i, 0], tab[i, 2]):
            j = int(word) & 511
            if j not in seen:
                seen.add(j)
                todo.append(j)
    # the finished position is set by the lane's end, not by a bit
    assert seen == set(range(pwk.SM_NPOS)) - {pwk.SM_DONE}
    assert pwk.SM_NPOS == 363 and pwk.SM_DONE == 362
    assert pwk.sm_positions()[pwk.SM_DONE][0] == pwk._PH_DONE
