"""K2's design for the H100 (csrc/wide_rans.cu), as numpy models.

The chain kernel takes the division off each step with a quotient table
(ops/wide_kernels.py rans_table): q' = (x * m_f) >> 32 with m_f =
floor((2^32 - 1) / f), then one correction, q = q' + (x - q' f >= f).  The
first tests prove that argument: for every f it gives x // f and x % f, and
the state update the kernel computes from it, at the edges of every
quotient and on a seeded sample of x below f << 20; f = 4096 (an inactive
step) leaves x as it is.

The kernel's two passes are then modelled step for step: the chain (one
thread a lane, walking backward in chunks of 32 steps, writing each step's
unit to a dense plane and each warp's ballot word, and the warp's emission
count a chunk) and the placement (per group and tile of 256 iterations,
the slot of each emitting lane from the chunk counts and the four ballot
words).  The model must give rans_encode_plain's units, counts and final
states on a balanced block, a block with dead lanes, and a block whose
max_bits (35) is under one ring of 256 steps and not a multiple of the
chunk; the payload it assembles must equal the JAX package's v3 payload
(interpret mode) and the native codec's.  All comparisons are exact."""

import numpy as np
import pytest
import torch

from chip_smoke import hard_blocks, lane_planes
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk

STEPS = pwk.RANS_STEPS  # the chain's chunk (kSteps)
TILE = 256              # the placement's tile (kTile)
M32 = np.uint64(0xFFFFFFFF)


def _divmod(x: np.ndarray, f: np.ndarray, table: np.ndarray):
    """The kernel's quotient and remainder (uint64 holding u32 values)."""
    q = (x * table[f].astype(np.uint64)) >> np.uint64(32)
    r = x - q * f
    fix = r >= f
    return q + fix, r - f * fix, q


def _update(x, f, base, table):
    """The kernel's new state: x + (q' + (r' >= f)) (4096 - f) + base, mod
    2^32 (x already renormalised)."""
    q = (x * table[f].astype(np.uint64)) >> np.uint64(32)
    c4 = np.uint64(4096) - f
    fix = (x - q * f) >= f
    return (x + q * c4 + base + fix * c4) & M32


@pytest.fixture(scope="module")
def table():
    t = pwk.rans_table()
    assert t.dtype == np.uint32 and t.shape == (4097,)
    return t


@pytest.mark.parametrize("q", [0, 1, 2, 1 << 19, (1 << 20) - 1])
def test_quotient_table_at_the_edges_of_a_quotient(table, q):
    f = np.arange(1, 4096, dtype=np.uint64)
    for x in (q * f - 1, q * f, q * f + f - 1):
        keep = x < (f << np.uint64(20))  # q * f - 1 wraps for q = 0
        xs, fs = x[keep], f[keep]
        q_, r_, raw = _divmod(xs, fs, table)
        assert np.array_equal(q_, xs // fs) and np.array_equal(r_, xs % fs)
        assert ((xs // fs - raw) <= 1).all()  # one correction at most
        for base in (np.zeros_like(fs), np.uint64(4096) - fs):
            assert np.array_equal(_update(xs, fs, base, table),
                                  ((xs // fs) << np.uint64(12))
                                  + xs % fs + base)


def test_quotient_table_on_a_sample(table):
    g = np.random.default_rng(0x2A2)
    f = g.integers(1, 4096, 1 << 20).astype(np.uint64)
    x = (g.random(1 << 20) * (f << np.uint64(20))).astype(np.uint64)
    q_, r_, _ = _divmod(x, f, table)
    assert np.array_equal(q_, x // f) and np.array_equal(r_, x % f)
    base = np.where(g.random(1 << 20) < 0.5, np.uint64(4096) - f, 0)
    assert np.array_equal(_update(x, f, base, table),
                          ((x // f) << np.uint64(12)) + x % f + base)
    # any u32 x, not just the renormalised ones: the bound is 2^32
    xs = g.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
    fs = g.integers(1, 4097, 1 << 16).astype(np.uint64)
    q_, r_, _ = _divmod(xs, fs, table)
    assert np.array_equal(q_, xs // fs) and np.array_equal(r_, xs % fs)


def test_inactive_step_keeps_the_state(table):
    g = np.random.default_rng(0x2A3)
    x = g.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
    f = np.full_like(x, 4096)
    assert np.array_equal(_update(x, f, np.zeros_like(x), table), x)
    # and never renormalises: the threshold (4096 << 20) - 1 wraps to
    # 2^32 - 1 in u32
    assert ((np.uint64(4096) << np.uint64(20)) - np.uint64(1)) & M32 == M32


def chain_model(planes: np.ndarray, probs: np.ndarray, max_bits: int,
                table: np.ndarray):
    """The chain kernel: (dense u16 [npad, 1024], ballots u32 [32, npad],
    chunk counts [32, chunks], fx u32 [1024])."""
    chunks = -(-max_bits // STEPS)
    npad = chunks * STEPS
    dense = np.zeros((npad, pwk.LANES), np.uint16)
    ballots = np.zeros((32, npad), np.uint32)
    cnt = np.zeros((32, chunks), np.int64)
    x = np.full(pwk.LANES, 1 << 16, np.uint64)
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    for c in range(chunks - 1, -1, -1):
        for j in range(STEPS - 1, -1, -1):
            i = c * STEPS + j
            if i < max_bits:
                fld = (planes[i >> 2].astype(np.int64) >> (2 * (i & 3))) & 3
                p = probs[i].astype(np.uint64)
                active = (fld & 2) != 0
            else:  # past the last step: masked, whatever the ring holds
                fld = np.zeros(pwk.LANES, np.int64)
                p = np.full(pwk.LANES, 0xABC, np.uint64)
                active = np.zeros(pwk.LANES, bool)
            one = (fld & 1) != 0
            f = np.where(active, np.where(one, np.uint64(4096) - p, p),
                         np.uint64(4096))
            base = np.where(active & one, p, np.uint64(0))
            ren = x > (((f << np.uint64(20)) - np.uint64(1)) & M32)
            dense[i] = (x & np.uint64(0xFFFF)).astype(np.uint16)
            xr = np.where(ren, x >> np.uint64(16), x)
            x = _update(xr, f, base, table)
            ballots[:, i] = (ren.reshape(32, 32) * weights).sum(1)
        cnt[:, c] = np.bitwise_count(ballots[:, c * STEPS:(c + 1) * STEPS]) \
            .sum(1)
    return dense, ballots, cnt, x.astype(np.uint32)


def place_model(dense, ballots, cnt, max_bits: int, cap: int):
    """The placement kernel: (units i32 [8, cap], counts i32 [8])."""
    units = np.zeros((pwk.GROUPS, cap), np.int64)
    counts = np.zeros(pwk.GROUPS, np.int64)
    lanes = np.arange(pwk.W.GROUP)
    warp, bit = lanes // 32, lanes % 32
    below = (np.uint64(1) << bit.astype(np.uint64)) - np.uint64(1)
    for g in range(pwk.GROUPS):
        total = int(cnt[4 * g:4 * g + 4].sum())
        counts[g] = total
        for i0 in range(0, max_bits, TILE):
            before = int(cnt[4 * g:4 * g + 4, :i0 // STEPS].sum())
            words = ballots[4 * g:4 * g + 4, i0:min(i0 + TILE, max_bits)] \
                .T.astype(np.uint64)  # [iterations, 4]
            pc = np.bitwise_count(words).astype(np.int64)
            run = np.cumsum(pc.sum(1)) - pc.sum(1)
            lower = (np.cumsum(pc, 1) - pc)[:, warp]
            mw = words[:, warp]
            emit = ((mw >> bit.astype(np.uint64)) & np.uint64(1)) == 1
            rank = np.bitwise_count(mw & below).astype(np.int64)
            slot = cap - total + before + run[:, None] + lower + rank
            src = dense[i0:i0 + len(words), g * 128:(g + 1) * 128]
            units[g, slot[emit]] = src[emit]
    return units.astype(np.int32), counts.astype(np.int32)


def _text(n: int, seed: int) -> bytes:
    g = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([g.integers(0, 4)]) * int(g.integers(1, 10))
    return bytes(out[:n])


def _case(name: str):
    """(data, planes, sizes for the native codec or None, max_bits)."""
    if name == "balanced":  # tests/test_torch_wide_encode.py's corpus
        data = _text(1024 * 40, 212)
        planes, sizes, max_bits, _ = pwk._host_prep(data)
        return data, planes, sizes, max_bits
    if name == "dead_lanes":  # the equal split: 1000 live lanes
        data = _text(1024 * 36 + 123, 271)
        sizes = np.asarray(pwide.lane_sizes(len(data), pwk.LANES), np.int32)
        planes, sizes, max_bits = lane_planes(data, sizes)
        return data, planes, sizes, max_bits
    assert name == "short"  # 60 lanes of one zero run each: 35 steps
    data, sizes = hard_blocks(b"")["zeros"]
    planes, sizes, max_bits = lane_planes(data, sizes)
    return data, planes, sizes, max_bits


CASES = ["balanced", "dead_lanes", "short"]


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name in CASES:
        data, planes, sizes, max_bits = _case(name)
        probs = pwk.model_probs_plain(torch.from_numpy(planes), max_bits)
        out[name] = (data, planes, sizes, max_bits, probs)
    return out


def test_short_case_is_under_one_ring(cases):
    max_bits = cases["short"][3]
    assert max_bits < 8 * STEPS and max_bits % STEPS
    assert all(cases[n][3] % STEPS for n in CASES)


@pytest.mark.parametrize("name", CASES)
def test_model_equals_rans_encode_plain(cases, table, name):
    data, planes, sizes, max_bits, probs = cases[name]
    cap = pwk.W.GROUP * max(max_bits, 1)
    dense, ballots, cnt, fx = chain_model(planes, probs.numpy(), max_bits,
                                          table)
    units, counts = place_model(dense, ballots, cnt, max_bits, cap)
    p_units, p_counts, p_fx = pwk.rans_encode_plain(
        torch.from_numpy(planes), probs, max_bits, cap)
    assert np.array_equal(counts, p_counts.numpy())
    assert np.array_equal(fx.view(np.int32), p_fx.numpy())
    for g, c in enumerate(counts.tolist()):
        assert np.array_equal(units[g, cap - c:], p_units[g, cap - c:].numpy())
    payload = pwk._assemble_rans(len(data), torch.from_numpy(units),
                                 torch.from_numpy(counts),
                                 torch.from_numpy(fx.view(np.int32)), sizes,
                                 max_bits)
    assert payload == pwide.wide_encode(data, n_lanes=pwk.LANES, sizes=sizes,
                                        rans=True)
    if name == "balanced":  # the JAX package's v3 payload, once a file
        from libbsc_tpu.ops import wide_kernels as jwk

        assert payload == jwk.device_encode(data, interpret=True)


def test_scratch_holds_the_model(cases):
    """rans_scratch_bytes is the dense plane, the ballots and the counts
    the chain writes."""
    for name in CASES:
        max_bits = cases[name][3]
        chunks = -(-max_bits // STEPS)
        assert pwk.rans_scratch_bytes(max_bits) == \
            chunks * STEPS * (2 * pwk.LANES + 4 * 32) + 4 * 32 * chunks
