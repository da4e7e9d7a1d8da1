"""K9 and K10, the bit schedule's kernels (``ops/wide_schedule
.schedule_events`` and ``schedule_planes``): their plain versions on the
CPU against the JAX package's ``_events2_call`` and ``_expand2_call`` and
the native walker (``tbsc_wide_schedule_packed``), exactly; numpy models
of the CUDA kernels' algorithms (K9: a warp a lane, 32 bytes a step, the
move-to-front table as last-use times; K10: a scan of the bit counts,
then a word a thread found by binary search) against the plain versions;
and ``device_schedule_v2``'s three refusals at exactly their edges.

Cases: a lane of zero bytes, a lane holding one run, a lane using all 256
byte values, runs crossing lane starts, dead lanes (``edge_block``), and
text, random bytes and runs under balanced, equal and skewed tables."""

from bisect import bisect_right

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import edge_block
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


def _inputs(data: np.ndarray, sizes: np.ndarray):
    """(data, starts, sizes, frid_ext, R) as device_schedule_v2 hands
    them to K9, and the grid width E of the JAX programs."""
    d = torch.from_numpy(data)
    sizes_d = torch.from_numpy(sizes.astype(np.int64))
    starts, frid_ext, R, maxpl, _ = psched.lane_runs(d, sizes_d)
    return d, starts, sizes_d, frid_ext, R, psched._grid_width(maxpl)


@pytest.fixture(scope="module")
def jax_grids():
    """name -> the JAX package's (rank, ev_len, B, total) grids and
    planes, one call of each program a case."""
    out = {}
    for name, (data, sizes) in CASES.items():
        n = len(data)
        d, starts, _, frid_ext, R, E = _inputs(data, sizes)
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
    d, starts, sizes_d, frid_ext, R, E = _inputs(data, sizes)
    ev = psched.schedule_events(d, starts, sizes_d, frid_ext, R)
    rank, ev_len, B, total, _ = jax_grids[name]
    nruns = np.diff(frid_ext.numpy())
    valid = np.arange(rank.shape[1])[None, :] < nruns[:, None]
    for ours, theirs in zip(ev[:3], (rank, ev_len, B)):
        assert ours.dtype == torch.int32 and ours.shape == (R,)
        assert np.array_equal(ours.numpy(), theirs[valid])
    assert np.array_equal(ev[3].numpy(), total)


@pytest.mark.parametrize("name", list(CASES))
def test_planes_plain_equals_jax_and_native(name, jax_grids):
    data, sizes = CASES[name]
    d, starts, sizes_d, frid_ext, R, E = _inputs(data, sizes)
    ev = psched.schedule_events(d, starts, sizes_d, frid_ext, R)
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


def _event_bits(rank: int, ln: int) -> int:
    b = 2
    if rank > 0:
        brs = _bitlen(rank)
        b += 2 * (brs - 1) + (brs < pwide.RANK_EXP_CAP)
    if ln != 1:
        ubrs = _bitlen(ln)
        b += 2 * (ubrs - 1) + (ubrs < pwide.RUN_EXP_CAP)
    return b


def _events_model(data, starts, sizes, frid_ext):
    """K9: a lane's aligned 16-byte words 512 bytes at a time (bytes
    outside the lane masked), run starts where a byte differs from the
    one before it in the lane; a run's rank is the number of byte values
    used more recently (last-use times, -c - 1 at first)."""
    R = int(frid_ext[-1])
    rank = np.zeros(R, np.int64)
    ln = np.zeros(R, np.int64)
    bits = np.zeros(R, np.int64)
    total = np.zeros(len(starts), np.int64)
    padded = np.concatenate([data, np.zeros(16, np.uint8)])
    for k, (lo, size) in enumerate(zip(starts.tolist(), sizes.tolist())):
        hi = lo + size
        ts = -np.arange(256) - 1
        clock, q, pstart, prank, before = 0, int(frid_ext[k]), -1, 0, -1

        def close(rk, length):
            nonlocal q
            rank[q], ln[q] = rk, length
            bits[q] = _event_bits(rk, length)
            total[k] += bits[q]
            q += 1

        for span in range((lo >> 4) * 16, -(-hi // 16) * 16, 512):
            for p in range(span, min(span + 512, -(-hi // 16) * 16)):
                c = int(padded[p])
                if lo <= p < hi and (p == lo or c != before):
                    if pstart >= 0:
                        close(prank, p - pstart)
                    prank = int((ts > ts[c]).sum())
                    ts[c] = clock
                    clock += 1
                    pstart = p
                before = c
        if pstart >= 0:
            close(prank, hi - pstart)
        assert q == int(frid_ext[k + 1])
    return rank, ln, bits, total


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


def _planes_model(rank, ln, bits, total, frid_ext, IT: int,
                  threads: int = 256):
    """K10: each lane's exclusive scan of the bit counts, then thread t
    owns words t, t + threads, ...: a binary search (from its last run)
    for the run holding the word's first field, then the word's 16
    fields, 0 at or past the lane's total."""
    words = IT // 16
    out = np.zeros((len(total), words), np.uint32)
    for k in range(len(total)):
        e0, e1 = int(frid_ext[k]), int(frid_ext[k + 1])
        S = (np.cumsum(bits[e0:e1]) - bits[e0:e1]).tolist()
        for t in range(threads):
            e = 0
            for w in range(t, words, threads):
                it0 = 16 * w
                if it0 >= total[k]:
                    continue
                e = e + bisect_right(S[e:], it0) - 1
                word, ev = 0, e
                for f in range(16):
                    it = it0 + f
                    if it >= total[k]:
                        break
                    if it - S[ev] >= bits[e0 + ev]:
                        ev += 1
                    word |= (_event_bit(int(rank[e0 + ev]), int(ln[e0 + ev]),
                                        it - S[ev]) | 2) << (2 * f)
                e = ev
                out[k, w] = word
    return out.astype("<u4").view(np.uint8).reshape(len(total), IT // 4)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_models_equal_plain(name):
    data, sizes = CASES[name]
    d, starts, sizes_d, frid_ext, R, E = _inputs(data, sizes)
    ev = psched.schedule_events(d, starts, sizes_d, frid_ext, R)
    model = _events_model(data, starts.numpy(), sizes_d.numpy(),
                          frid_ext.numpy())
    for ours, theirs in zip(ev, model):
        assert np.array_equal(ours.numpy(), theirs)
    IT = psched._bucket(max(int(ev[3].max()), 256), 256)
    planes = psched.schedule_planes(*ev, frid_ext, IT)
    assert np.array_equal(planes.numpy(), _planes_model(
        *(x.numpy() for x in ev), frid_ext.numpy(), IT))


def test_wrappers_check_their_arguments():
    data, sizes = CASES["text_balanced"]
    d, starts, sizes_d, frid_ext, R, E = _inputs(data, sizes)
    with pytest.raises(ValueError):
        psched.schedule_events(d.long(), starts, sizes_d, frid_ext, R)
    ev = psched.schedule_events(d, starts, sizes_d, frid_ext, R)
    with pytest.raises(ValueError):
        psched.schedule_planes(*ev, frid_ext, 264)  # not a multiple of 16
    with pytest.raises(ValueError):
        psched.schedule_planes(ev[0].long(), *ev[1:], frid_ext, 256 * 64)
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
