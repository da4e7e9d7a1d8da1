"""K9 and K10, the bit schedule's kernels (``ops/wide_schedule
.schedule_events`` and ``schedule_planes``): their plain versions on the
CPU against the JAX package's ``_events2_call`` and ``_expand2_call`` and
the native walker (``tbsc_wide_schedule_packed``), exactly; numpy models
of the CUDA kernels' algorithms (K9: a warp a lane, 32 runs a step from
the run starts, ranks by the batch formula from a position table, the
table's partition, each run's first bit; K10: tiles of 512 runs in
shared memory, each word's first run marked by the runs, its bits by
shifts of the runs' patterns) against the plain versions; and
``device_schedule_v2``'s three refusals at exactly their edges.

Cases: a lane of zero bytes, a lane holding one run, a lane using all 256
byte values, runs crossing lane starts, dead lanes (``edge_block``),
text, random bytes and runs under balanced, equal and skewed tables, and
the kernels' batch and tile edges (``batch_edges``: lanes of 1, 31, 32,
33, 64, 512 and 513 runs, a char recurring three times in a batch, a
batch opening with a char last used in the batch before, all 256 values,
a lane opening with the byte the lane before ends with, empty lanes)."""

from bisect import bisect_right

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import batch_edges, edge_block, lay_lanes
from libbsc_tpu.ops import wide_schedule as jsched
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch import native as pnative
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_schedule as psched
from tests.conftest import make_corpus

L = 16


def _block(kind: str, n: int, table: str):
    g = np.random.default_rng(n + len(kind) + len(table))
    data = np.frombuffer(make_corpus(g, n, kind), np.uint8).copy()
    if table == "equal":
        sizes = np.asarray(pwide.lane_sizes(n, L), np.int32)
    elif table == "balanced":
        sizes = psched.device_balanced_sizes(torch.from_numpy(data),
                                             L).numpy()
    else:  # skewed: dead lanes first and last, one lane with half
        sizes = np.zeros(L, np.int32)
        sizes[2], sizes[L - 3] = n // 2, n // 4
        sizes[L - 2] = n - n // 2 - n // 4
    return data, sizes.astype(np.int32)


def _cases() -> dict:
    data, sizes = edge_block(L, 3000)
    return {"edges": (np.frombuffer(data, np.uint8).copy(), sizes),
            "text_balanced": _block("text", 40_000, "balanced"),
            "random_equal": _block("random", 30_000, "equal"),
            "runs_skewed": _block("runs", 40_000, "skewed")}


CASES = _cases()
EDGES = {name: (np.frombuffer(data, np.uint8).copy(), sizes)
         for name, (data, sizes) in
         ((name, lay_lanes(lanes, L))
          for name, lanes in batch_edges().items())}


def _inputs(data: np.ndarray, sizes: np.ndarray):
    """(data, rs, starts, sizes, frid_ext) as device_schedule_v2 hands
    them to K9, and the grid width E of the JAX programs."""
    d = torch.from_numpy(data)
    sizes_d = torch.from_numpy(sizes.astype(np.int64))
    starts, frid_ext, _, rs, maxpl, _ = psched.lane_runs(d, sizes_d)
    return d, rs, starts, sizes_d, frid_ext, psched._grid_width(maxpl)


@pytest.fixture(scope="module")
def jax_grids():
    """name -> the JAX package's (rank, ev_len, B, total) grids and
    planes, one call of each program a case."""
    out = {}
    for name, (data, sizes) in CASES.items():
        n = len(data)
        d, rs, starts, _, frid_ext, E = _inputs(data, sizes)
        R = int(rs.shape[0])
        s32 = jnp.asarray(sizes)
        rank, ev_len, B, total, mb = jsched._events2_call(
            n, L, psched._bucket(max(R, 1024), 1024), E)(
            jnp.asarray(data), jnp.asarray(starts.numpy(), jnp.int32), s32)
        IT = psched._bucket(max(int(mb), 256), 256)
        planes = jsched._expand2_call(L, E, IT)(rank, ev_len, B, total)
        out[name] = tuple(np.asarray(x) for x in (rank, ev_len, B, total,
                                                  planes))
    return out


def _native_planes(data: np.ndarray, sizes: np.ndarray):
    pengine.init("cpu")
    lib = pnative.load()
    cap4 = -(-(17 * int(max(sizes.max(), 1)) + 64) // 4)
    pk = np.zeros((L, cap4), np.uint8)
    mb = lib.tbsc_wide_schedule_packed(pnative.u8p(data), len(data), L,
                                       cap4, pnative.u8p(pk),
                                       pnative.i32p(sizes))
    assert mb >= 0
    return pk, mb


@pytest.mark.parametrize("name", list(CASES))
def test_events_plain_equals_jax_grid(name, jax_grids):
    data, sizes = CASES[name]
    d, rs, starts, sizes_d, frid_ext, E = _inputs(data, sizes)
    ev = psched.schedule_events(d, rs, starts, sizes_d, frid_ext)
    rank, ev_len, B, total, _ = jax_grids[name]
    nruns = np.diff(frid_ext.numpy())
    valid = np.arange(rank.shape[1])[None, :] < nruns[:, None]
    for ours, theirs in zip(ev[:3], (rank, ev_len, B)):
        assert ours.dtype == torch.int32 and ours.shape == rs.shape
        assert np.array_equal(ours.numpy(), theirs[valid])
    assert np.array_equal(ev[3].numpy(), total)
    S = np.cumsum(B, 1) - B  # each run's first bit in its lane
    assert ev[4].dtype == torch.int32
    assert np.array_equal(ev[4].numpy(), S[valid])


@pytest.mark.parametrize("name", list(CASES))
def test_planes_plain_equals_jax_and_native(name, jax_grids):
    data, sizes = CASES[name]
    d, rs, starts, sizes_d, frid_ext, E = _inputs(data, sizes)
    ev = psched.schedule_events(d, rs, starts, sizes_d, frid_ext)
    max_bits = int(ev[3].max())
    IT = psched._bucket(max(max_bits, 256), 256)
    planes = psched.schedule_planes(*ev, frid_ext, IT).numpy()
    assert np.array_equal(planes, jax_grids[name][4])
    pk, mb = _native_planes(data, sizes)
    assert mb == max_bits
    m = min(planes.shape[1], pk.shape[1])
    assert np.array_equal(planes[:, :m], pk[:, :m])
    assert not planes[:, m:].any() and not pk[:, m:].any()


def test_edge_block_holds_its_edges():
    data, sizes = CASES["edges"]
    assert sizes[0] == 0 and sizes[3] == 0 and sizes[-1] == 0
    assert not data[sizes[0]:sizes[1]].any()  # one run of zeros
    lane2 = data[sizes[1]:sizes[1] + sizes[2]]
    assert len(np.unique(lane2)) == 256
    # the lane after the empty one starts with the byte lane 2 ends with
    assert data[sizes[:4].sum()] == lane2[-1] == 0


# ---------------------------------------------------------------------------
# numpy models of the kernels (csrc/wide_schedule.cu)
# ---------------------------------------------------------------------------

def _bitlen(x: int) -> int:
    return int(x).bit_length()


def _popc(x: int) -> int:
    return (int(x) & 0xFFFFFFFF).bit_count()


def _event_bits(rank: int, ln: int) -> int:
    b = 2
    if rank > 0:
        brs = _bitlen(rank)
        b += 2 * (brs - 1) + (brs < pwide.RANK_EXP_CAP)
    if ln != 1:
        ubrs = _bitlen(ln)
        b += 2 * (ubrs - 1) + (ubrs < pwide.RUN_EXP_CAP)
    return b


def _ballot(pred) -> int:
    return sum(1 << j for j, x in enumerate(pred) if x)


def _batch_ranks(c: list, valid: list, pos: np.ndarray) -> list:
    """K9's ranks of one batch, thread j holding run j with char c[j]
    (256 + j past the lane), from the start-of-batch table ``pos``: the
    match masks (each run's previous and next use of its char), "next
    use >= j" compared bit by bit over six ballots, and the eight ballots
    of the new chars' positions."""
    lanes = range(32)
    below = [(1 << j) - 1 for j in lanes]
    same = [_ballot(c[i] == c[j] for i in lanes) for j in lanes]
    last = [_bitlen(same[j] & below[j]) - 1 for j in lanes]  # -1: not in W
    nxt = []
    for j in lanes:
        after = same[j] & ~((2 << j) - 1) & 0xFFFFFFFF
        nxt.append((after & -after).bit_length() - 1 if after else 32)
    ballots = [_ballot((x >> bt) & 1 for x in nxt) for bt in range(6)]
    fresh = []
    for j in lanes:
        gt, eq = 0, 0xFFFFFFFF
        for bt in range(5, -1, -1):
            ones = ballots[bt]
            if (j >> bt) & 1:
                eq &= ones
            else:
                gt |= eq & ones
                eq &= ~ones
        fresh.append(below[j] & (gt | eq))
    pc = [int(pos[c[j]]) if valid[j] else 0 for j in lanes]
    first = sum(1 << j for j in lanes if valid[j] and last[j] < 0)
    cand = [first & below[j] for j in lanes]
    less = [0] * 32
    for bt in range(7, -1, -1):
        ones = sum(1 << j for j in lanes if (pc[j] >> bt) & 1)
        for j in lanes:
            if (pc[j] >> bt) & 1:
                less[j] += _popc(cand[j] & ~ones)
            cand[j] &= ones if (pc[j] >> bt) & 1 else ~ones
    rank = [_popc(fresh[j] & ~((2 << last[j]) - 1)) if last[j] >= 0
            else _popc(fresh[j]) + pc[j] - less[j] for j in lanes]
    lasts = _ballot(valid[j] and nxt[j] == 32 for j in lanes)
    return rank, lasts, pc


def _partition(c: list, pc: list, lasts: int, pos: np.ndarray,
               order: np.ndarray) -> None:
    """K9's table update after a batch, in place: the batch's chars
    (``lasts``: the runs of their last use) to the front, the last used
    first; thread t's kept entries of order (ranks 8t .. 8t + 7) after
    them in order.  The ranks the batch takes (its chars' positions ``pc``)
    below 8t and among 8t .. 8t + 7 come from comparing 8t bit by bit
    with the ballots of the positions' bits."""
    pcb = [_ballot((x >> bt) & 1 for x in pc) for bt in range(8)]
    old = order.copy()
    for t in range(32):
        lt, hit = 0, lasts
        for bt in range(7, 2, -1):
            if (t >> (bt - 3)) & 1:
                lt |= hit & ~pcb[bt]
                hit &= pcb[bt]
            else:
                hit &= ~pcb[bt]
        gone = 0
        for i in range(8):
            low = 0xFFFFFFFF
            for bt in range(3):
                low &= pcb[bt] if (i >> bt) & 1 else ~pcb[bt]
            gone |= int(hit & low != 0) << i
        to = _popc(lasts) + 8 * t - _popc(lt)
        for i in range(8):
            if not (gone >> i) & 1:
                v = old[8 * t + i]
                order[to], pos[v] = v, to
                to += 1
    for j in range(32):
        if (lasts >> j) & 1:
            r = _popc(lasts & ~((2 << j) - 1))
            order[r], pos[c[j]] = c[j], r


def _events_model(data, rs, starts, sizes, frid_ext):
    """K9: a warp a lane, 32 runs a step from the run starts ``rs``: each
    run's char at its start and its length to the next start (the lane's
    end for its last run), ranks by the batch formula from the
    start-of-batch position table, then the table's partition; each run's
    bits and first bit S (a prefix over the batch, carried across
    batches)."""
    R = int(frid_ext[-1])
    rank, ln, bits, S = (np.zeros(R, np.int64) for _ in range(4))
    total = np.zeros(len(starts), np.int64)
    for k in range(len(starts)):
        g0, nr = int(frid_ext[k]), int(frid_ext[k + 1] - frid_ext[k])
        end = int(starts[k] + sizes[k])
        pos, order = np.arange(256), np.arange(256)
        carry = 0
        for b0 in range(0, nr, 32):
            valid = [b0 + j < nr for j in range(32)]
            p = [int(rs[g0 + b0 + j]) if b0 + j < nr else end
                 for j in range(33)]
            c = [int(data[p[j]]) if valid[j] else 256 + j
                 for j in range(32)]
            rk, lasts, pc = _batch_ranks(c, valid, pos)
            _partition(c, pc, lasts, pos, order)
            b = [_event_bits(rk[j], p[j + 1] - p[j]) if valid[j] else 0
                 for j in range(32)]
            ones = [_ballot((x >> bt) & 1 for x in b) for bt in range(7)]
            for j in range(32):
                if valid[j]:
                    g = g0 + b0 + j
                    rank[g], ln[g], bits[g] = rk[j], p[j + 1] - p[j], b[j]
                    S[g] = carry + sum(_popc(m & ((1 << j) - 1)) << bt
                                       for bt, m in enumerate(ones))
            carry += sum(_popc(m) << bt for bt, m in enumerate(ones))
        total[k] = carry
    return rank, ln, bits, total, S


def _event_bit(rk: int, rn: int, j: int) -> int:
    brs = _bitlen(rk) if rk > 0 else 0
    rlen = brs - 1 + (brs < pwide.RANK_EXP_CAP) if rk > 0 else 0
    uoff = 1 + rlen + (brs - 1 if rk > 0 else 0)
    ubrs = _bitlen(rn) if rn != 1 else 0
    ulen = ubrs - 1 + (ubrs < pwide.RUN_EXP_CAP) if rn != 1 else 0
    if j == 0:
        return int(rk > 0)
    if j < 1 + rlen:
        return int(j - 1 < brs - 1)
    if j < uoff:
        return (rk >> (brs - 2 - (j - 1 - rlen))) & 1
    if j == uoff:
        return int(rn != 1)
    if j < uoff + 1 + ulen:
        return int(j - uoff - 1 < ubrs - 1)
    return (rn >> (ubrs - 2 - (j - uoff - 1 - ulen))) & 1


def _pattern(rk: int, rn: int) -> tuple:
    """K10's stage_run: (lo u64, hi, B), bit j = the event's bit j: the
    rank part (at most 15 bits) below the run part (at most 61)."""
    def rev(x: int, nb: int) -> int:
        return int(f"{x & ((1 << nb) - 1):0{nb}b}"[::-1], 2)

    rp, rl = int(rk > 0), 1
    if rk > 0:
        brs = _bitlen(rk)
        rlen = brs - 1 + (brs < pwide.RANK_EXP_CAP)
        rp |= ((1 << (brs - 1)) - 1) << 1
        if brs > 1:
            rp |= rev(rk, brs - 1) << (1 + rlen)
        rl += rlen + brs - 1
    up, ul = int(rn != 1), 1
    if rn != 1:
        ubrs = _bitlen(rn)
        ulen = ubrs - 1 + (ubrs < pwide.RUN_EXP_CAP)
        up |= ((1 << (ubrs - 1)) - 1) << 1
        if ubrs > 1:
            up |= rev(rn, ubrs - 1) << (1 + ulen)
        ul += ulen + ubrs - 1
    assert rl <= 15 and up < 1 << 61
    lo = (rp | (up << rl)) & (2 ** 64 - 1)
    return lo, up >> (64 - rl), rl + ul


def _pattern_bits(lo: int, hi: int, j: int) -> int:
    """K10's pattern_bits: bits j .. j + 15 of the pattern (and more)."""
    if j >= 64:
        return hi >> (j - 64)
    v = lo >> j
    if j > 48:
        v |= (hi << (64 - j)) & (2 ** 64 - 1)
    return v & 0xFFFFFFFF


def _spread(x: int) -> int:
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _planes_model(rank, ln, S, total, frid_ext, IT: int, tile: int = 512,
                  halo: int = 8):
    """K10: a lane's runs in tiles of ``tile`` (and ``halo`` more staged):
    each run's pattern, S from K9; each of the tile's own runs marks
    itself as the first run of the words whose first field it holds (the
    tile's words end where the next tile's first run starts, or at the
    lane's total); each word takes its 16 bits
    from its first run and the next ones by shifts and masks, spread to
    the fields' low bits with the active bits set; words at or past the
    lane's total 0."""
    words = IT // 16
    out = np.zeros((len(total), words), np.uint32)
    for k in range(len(total)):
        e0, ne = int(frid_ext[k]), int(frid_ext[k + 1] - frid_ext[k])
        tot = int(total[k])
        for a in range(0, ne, tile):
            nt, ns = min(tile, ne - a), min(tile + halo, ne - a)
            st = [_pattern(int(rank[e0 + a + i]), int(ln[e0 + a + i]))
                  for i in range(ns)]
            start = [int(S[e0 + a + i]) for i in range(ns)]
            end = [start[i] + st[i][2] for i in range(ns)]
            w_lo = (start[0] + 15) >> 4
            w_hi = min(words, ((int(S[e0 + a + nt]) if a + nt < ne else tot)
                               + 15) >> 4)
            first = {}
            for i in range(nt):
                w = (start[i] + 15) >> 4
                while w < w_hi and 16 * w < end[i]:
                    first[w - w_lo] = i
                    w += 1
            assert sorted(first) == list(range(w_hi - w_lo))
            for w in range(w_lo, w_hi):
                it0 = 16 * w
                nf = min(16, tot - it0)
                i = first[w - w_lo]
                j, x, f = it0 - start[i], 0, 0
                while f < nf:
                    assert i < ns
                    take = min(end[i] - start[i] - j, nf - f)
                    x |= (_pattern_bits(st[i][0], st[i][1], j)
                          & ((1 << take) - 1)) << f
                    f += take
                    i, j = i + 1, 0
                out[k, w] = _spread(x) | (0xAAAAAAAA & ((1 << 2 * nf) - 1))
    return out.astype("<u4").view(np.uint8).reshape(len(total), IT // 4)


def _check_models(data: np.ndarray, sizes: np.ndarray) -> None:
    """Both models against the plain versions on one block."""
    d, rs, starts, sizes_d, frid_ext, E = _inputs(data, sizes)
    ev = psched.schedule_events(d, rs, starts, sizes_d, frid_ext)
    model = _events_model(data, rs.numpy(), starts.numpy(), sizes_d.numpy(),
                          frid_ext.numpy())
    for ours, theirs in zip(ev, model):
        assert np.array_equal(ours.numpy(), theirs)
    IT = psched._bucket(max(int(ev[3].max()), 256), 256)
    planes = psched.schedule_planes(*ev, frid_ext, IT)
    rank, ln, _, total, S = (x.numpy() for x in ev)
    assert np.array_equal(planes.numpy(), _planes_model(
        rank, ln, S, total, frid_ext.numpy(), IT))


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_models_equal_plain(name):
    _check_models(*CASES[name])


@pytest.mark.parametrize("name", list(EDGES))
def test_batch_edges_models_equal_plain_and_native(name):
    """K9's batch edges and K10's tile edges (chip_smoke.batch_edges) on
    16 lanes: both kernels' models against the plain versions, and the
    plain planes against the native walker's."""
    data, sizes = EDGES[name]
    _check_models(data, sizes)
    d, rs, starts, sizes_d, frid_ext, _ = _inputs(data, sizes)
    ev = psched.schedule_events(d, rs, starts, sizes_d, frid_ext)
    max_bits = int(ev[3].max())
    IT = psched._bucket(max(max_bits, 256), 256)
    planes = psched.schedule_planes(*ev, frid_ext, IT).numpy()
    pk, mb = _native_planes(data, sizes)
    assert mb == max_bits
    m = min(planes.shape[1], pk.shape[1])
    assert np.array_equal(planes[:, :m], pk[:, :m])
    assert not planes[:, m:].any() and not pk[:, m:].any()


def test_batch_edges_hold_their_edges():
    runs = {name: np.diff(_inputs(*EDGES[name])[4].numpy())
            for name in EDGES}
    for n in (1, 31, 32, 33, 64, 512, 513):
        assert runs[f"runs_{n}"][:2].tolist() == [n, n]
    assert runs["empty_lane"][:4].tolist() == [0, 20, 0, 20]
    data, sizes = EDGES["same_byte_at_lane_start"]
    assert data[sizes[0] - 1] == data[sizes[0]]
    assert runs["same_byte_at_lane_start"][1] == 21
    lane = EDGES["all_256"][0][:EDGES["all_256"][1][0]]
    assert len(np.unique(lane)) == 256


@pytest.mark.parametrize("rank", [0, 1, 2, 3, 127, 128, 255])
def test_event_pattern_model_equals_event_bits(rank):
    """K10's pattern (a u64 and a u32, bits past 64 for runs of 2^25 or
    more, which v1 takes) against _expand2's bit order, bit by bit."""
    for ln in (1, 2, 3, 255, 256, (1 << 24) - 1, 1 << 24, (1 << 25) + 7,
               (1 << 31) - 1):
        lo, hi, B = _pattern(rank, ln)
        assert B == _event_bits(rank, ln) <= 76
        for j in range(B):
            assert (_pattern_bits(lo, hi, j) & 1) == _event_bit(rank, ln, j)
        assert _pattern_bits(lo, hi, B - 1) >> 1 == 0


def test_wrappers_check_their_arguments():
    data, sizes = CASES["text_balanced"]
    d, rs, starts, sizes_d, frid_ext, E = _inputs(data, sizes)
    with pytest.raises(ValueError):
        psched.schedule_events(d.long(), rs, starts, sizes_d, frid_ext)
    with pytest.raises(ValueError):  # the run starts as int32
        psched.schedule_events(d, rs.int(), starts, sizes_d, frid_ext)
    ev = psched.schedule_events(d, rs, starts, sizes_d, frid_ext)
    with pytest.raises(ValueError):
        psched.schedule_planes(*ev, frid_ext, 264)  # not a multiple of 16
    with pytest.raises(ValueError):
        psched.schedule_planes(ev[0].long(), *ev[1:], frid_ext, 256 * 64)
    with pytest.raises(ValueError):  # S as int64
        psched.schedule_planes(*ev[:4], ev[4].long(), frid_ext, 256 * 64)
    assert psched.LAUNCHES == {"sched_events": 0, "sched_planes": 0}


# ---------------------------------------------------------------------------
# the refusals of device_schedule_v2, each at its edge
# ---------------------------------------------------------------------------

def _long_run_block(run: int) -> tuple:
    """Text with one run of ``run`` 0xFF bytes inside lane 1 of 4."""
    g = np.random.default_rng(run)
    text = np.frombuffer(make_corpus(g, 40_000, "text"), np.uint8)
    data = np.concatenate([text[:12_000], np.full(run, 255, np.uint8),
                           text[12_000:]])
    sizes = np.asarray(pwide.lane_sizes(len(data), 4), np.int32)
    assert sizes[0] < 12_000 and 12_000 + run < sizes[:2].sum()
    return data, sizes


@pytest.mark.parametrize("run,refused", [(4095, False), (4096, True)])
def test_run_cap_refusal_at_its_edge(run, refused, monkeypatch):
    """A run of 2^RUN_EXP_CAP bytes or more is refused (the cap lowered to
    2^12 so the edge fits a test block); the JAX package refuses the same
    block (it does so before any traced program reads the cap)."""
    monkeypatch.setattr(pwide, "RUN_EXP_CAP", 12)
    data, sizes = _long_run_block(run)
    planes, mb = psched.device_schedule_v2(torch.from_numpy(data), sizes, 4)
    assert (planes is None) == refused and (mb == -1) == refused
    if refused:
        monkeypatch.setattr(jsched.W, "RUN_EXP_CAP", 12)
        assert jsched.device_schedule_v2(data, sizes, 4) == (None, -1)


@pytest.mark.parametrize("slack,refused", [(0, False), (-1, True)])
def test_grid_cap_refusal_at_its_edge(slack, refused, monkeypatch):
    """L * E past the grid cap is refused: the cap set to this block's
    L * E (taken) and one below it (refused)."""
    data, sizes = CASES["text_balanced"]
    _, _, _, _, _, E = _inputs(data, sizes)
    monkeypatch.setattr(psched, "_GRID_CAP", L * E + slack)
    planes, mb = psched.device_schedule_v2(torch.from_numpy(data), sizes, L)
    assert (planes is None) == refused and (mb == -1) == refused


@pytest.mark.parametrize("slack,refused", [(1, False), (0, True)])
def test_it_cap_refusal_at_its_edge(slack, refused, monkeypatch):
    """IT at or past the packing cap is refused, in both packages: the
    cap set to this block's IT (refused) and one above it (taken, the same
    planes)."""
    data, sizes = CASES["runs_skewed"]
    planes, mb = psched.device_schedule_v2(torch.from_numpy(data), sizes, L)
    IT = planes.shape[1] * 4
    monkeypatch.setattr(psched, "_IT_CAP", IT + slack)
    monkeypatch.setattr(jsched, "_IT_CAP", IT + slack)
    ours = psched.device_schedule_v2(torch.from_numpy(data), sizes, L)
    theirs = jsched.device_schedule_v2(data, sizes, L)
    assert (ours[0] is None) == refused == (theirs[0] is None)
    if not refused:
        assert ours[1] == theirs[1] == mb
        assert np.array_equal(ours[0].numpy(), np.asarray(theirs[0]))
