"""K11-K14, the forward BWT's sort kernels (``csrc/bwt_sort.cu``), on the
CPU: each plain version against the JAX function it replaces, numpy
models of the kernels' tiles held to the plain versions, and the wrappers
on CPU tensors.

- plain versions, exactly (ranks and bytes have no tolerance), on the
  ``text``, ``random``, ``runs``, ``zeros`` and ``periodic`` kinds of
  ``make_corpus`` (40,000 bytes): the bootstrap's ranks and unresolved
  list against ``_bootstrap`` (K11, the torch sorts around K13's
  pre-pass, K13's full form; the list as a set and by its count against
  the JAX mask), a full round from those ranks against ``_full_round4``
  (K12, K13), a compact round against ``_bucket_round_compact4`` (whose
  dead slots hold n; the list in its sorted order) and the extraction,
  whole and as its two passes, against ``_extract_bwt_impl`` (K14).
  Each JAX function runs once a kind (module-scoped fixtures).  The
  quadrupling rounds give the same ranks from the unresolved list in
  sorted order, in position order and reversed, in ``suffix_ranks`` and
  in DC3's sample rank.
- numpy models of what each kernel does differently from its plain
  version: K13's pre-pass and main pass, tiles of 1,024 rows, four a
  thread, with the block scans, the status words and the look-backs 32
  tiles a step (every tile first publishes, then the look-backs run last
  tile first, so that each walks back over tiles that have not finished,
  or first tile first): the pre-pass's runs of equal low keys and its
  packed words, the main pass's ranks and its list placed by the
  look-back of sums; K11's blocks of 2,048 rows staged with their
  14-byte halo (and the sample mode's 1.5x span); K14's slot rule, each
  slot written once, and its buckets: blocks of 8,192 suffixes taking a
  cursor a bucket, every stage slot written once inside its bucket, on
  n below 2^16, not a multiple of it, with r0 on a bucket's first and
  last slot.
- each wrapper on a CPU tensor runs its plain version and counts no
  launch.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libbsc_tpu.ops import bwt as jbwt
from libbsc_tpu_torch import engine
from libbsc_tpu_torch.ops import bwt as pbwt
from tests.conftest import make_corpus

N = 40_000
KINDS = ["text", "random", "runs", "zeros", "periodic"]
K = pbwt._BOOT_DEPTH


def _block(kind: str, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(1400 + KINDS.index(kind))
    return np.frombuffer(make_corpus(rng, n, kind), np.uint8).copy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _pay_inputs(key_hi, key_lo, uidx=None):
    """The pre-pass's inputs: the first sort's values and indices and the
    high keys (and a compact round's rows)."""
    lo_s, o1 = torch.sort(key_lo, stable=True)
    return (lo_s, o1, key_hi) + (() if uidx is None else (uidx,))


def _boot_plain(d: torch.Tensor):
    """The bootstrap's plain route: ((rank, still, count), the main pass's
    inputs, the pre-pass's inputs)."""
    k_hi, k_lo = pbwt.boot_keys_plain(d)
    boot_in = pbwt._sort_rows(k_hi, k_lo)
    return (pbwt.heads_full_plain(*boot_in), boot_in,
            _pay_inputs(k_hi, k_lo))


def _mask(still: torch.Tensor, n: int) -> np.ndarray:
    mask = np.zeros(n, bool)
    mask[still.numpy()] = True
    return mask


def _compact_rows(mask: np.ndarray) -> np.ndarray:
    """The rows of the compact round under test: the unresolved positions
    and every 97th one (both routes compute the same function of any set
    of rows; the random block leaves none unresolved)."""
    return np.union1d(np.nonzero(mask)[0], np.arange(0, len(mask), 97))


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    """One kind's inputs and the JAX package's results, each JAX function
    called once."""
    kind = request.param
    d = _block(kind)
    n = len(d)
    (rank, still, cnt), boot_in, boot_pay = _boot_plain(_t(d))
    jrank, jmask = jbwt._bootstrap(jnp.asarray(d))
    j32 = jnp.asarray(rank.numpy().astype(np.int32))
    full = jbwt._full_round4(j32, K, n)
    uidx = _compact_rows(_mask(still, n))
    compact = jbwt._bucket_round_compact4(
        j32, jnp.asarray(uidx.astype(np.int32)), K, n)
    final = pbwt.suffix_ranks(_t(d))
    r = pbwt.aux_rate(n)
    ext = jbwt._extract_bwt_impl(jnp.asarray(d),
                                 jnp.asarray(final.numpy().astype(np.int32)),
                                 r)
    return {"kind": kind, "d": d, "n": n, "rank": rank, "still": still,
            "cnt": cnt, "boot_in": boot_in, "boot_pay": boot_pay,
            "uidx": uidx, "final": final, "r": r,
            "jax": {"boot": tuple(np.asarray(x) for x in (jrank, jmask)),
                    "full": tuple(np.asarray(x) for x in full),
                    "compact": tuple(np.asarray(x) for x in compact),
                    "extract": tuple(np.asarray(x) for x in ext)}}


def _compact_inputs(c):
    """A compact round's (main-pass inputs, pre-pass inputs)."""
    uidx = _t(c["uidx"].astype(np.int64))
    key_a, key_b = pbwt.round_keys_plain(c["rank"], K, uidx)
    return (pbwt._sort_rows(key_a, key_b, uidx),
            _pay_inputs(key_a, key_b, uidx))


def _assert_list(still, cnt, jmask):
    """The unresolved list against the JAX mask: as a set, and by count."""
    want = np.nonzero(jmask)[0]
    assert int(cnt) == len(want) == len(still)
    np.testing.assert_array_equal(np.sort(still.numpy()), want)


# ---------------------------------------------------------------------------
# plain versions against the JAX package
# ---------------------------------------------------------------------------

def test_bootstrap_plain_equals_jax(case):
    jrank, jmask = case["jax"]["boot"]
    np.testing.assert_array_equal(case["rank"].numpy(), jrank)
    _assert_list(case["still"], case["cnt"], jmask)


def test_full_round_plain_equals_jax(case):
    key_a, key_b = pbwt.round_keys_plain(case["rank"], K)
    rank, still, cnt = pbwt.heads_full_plain(*pbwt._sort_rows(key_a, key_b))
    jrank, jmask, jcnt = case["jax"]["full"]
    np.testing.assert_array_equal(rank.numpy(), jrank)
    _assert_list(still, cnt, jmask)
    assert int(cnt) == int(jcnt)


def test_compact_round_plain_equals_jax(case):
    rank = case["rank"].clone()
    still, cnt = pbwt.heads_compact_plain(*_compact_inputs(case)[0], rank)
    jrank, juidx, jcnt = case["jax"]["compact"]
    np.testing.assert_array_equal(rank.numpy(), jrank)
    np.testing.assert_array_equal(still[:int(cnt)].numpy(),
                                  juidx[juidx < case["n"]])
    assert int(cnt) == int(jcnt)


def test_extract_plain_equals_jax(case):
    U, primary, aux = pbwt.extract_plain(_t(case["d"]), case["final"],
                                         case["r"])
    jU, jprimary, jaux = case["jax"]["extract"]
    np.testing.assert_array_equal(U.numpy(), jU)
    assert int(primary) == int(jprimary)
    assert aux.dtype == torch.int32
    np.testing.assert_array_equal(aux.numpy(), jaux)
    stage, primary2, aux2 = pbwt.extract_bins_plain(_t(case["d"]),
                                                    case["final"], case["r"])
    np.testing.assert_array_equal(pbwt.extract_place_plain(stage).numpy(),
                                  jU)
    assert int(primary2) == int(jprimary)
    np.testing.assert_array_equal(aux2.numpy(), jaux)


@pytest.mark.parametrize("order", ["sorted", "position", "reversed"])
def test_refine_takes_the_unresolved_list_in_any_order(case, order):
    """suffix_ranks' rounds (_refine) and DC3's sample rank give the same
    ranks from the bootstrap's unresolved list in sorted order (as K13
    writes it), in position order (as torch.nonzero of a mask gives it)
    and reversed: a round ranks equal keys equally whatever their input
    order."""
    def ordered(still, cnt):
        lst = still[:int(cnt)]
        if order == "position":
            return torch.sort(lst).values
        return lst.flip(0) if order == "reversed" else lst

    d, n = _t(case["d"]), case["n"]
    rank, still, cnt = case["rank"], case["still"], case["cnt"]
    got = pbwt._refine(rank.clone(), ordered(still, cnt), cnt, K, n)
    assert torch.equal(got, case["final"])
    m = n - (n + 2) // 3
    s_rank, s_still, s_cnt = pbwt._rank_pairs(*pbwt.boot_keys(d, True))
    got = pbwt._refine(s_rank.clone(), ordered(s_still, s_cnt), s_cnt, 10,
                       m)
    assert torch.equal(got, pbwt._dc3_sample_rank(d, m))


# ---------------------------------------------------------------------------
# numpy models of the kernels
# ---------------------------------------------------------------------------

TILE, ITEMS, THREADS = 1024, 4, 256
AGG, INCL = 1 << 62, 2 << 62
VAL = AGG - 1
HALF = (1 << 31) - 1


def _max_fields(a: int, b: int) -> int:
    return max(a >> 31, b >> 31) << 31 | max(a & HALF, b & HALF)


def _add(a: int, b: int) -> int:
    return a + b


def _look_back(status: list, tile: int, op) -> int:
    """Warp 0's look-back: lane l reads the status of tile p - l; fold
    every value up to and including the nearest final one, 32 at a
    step."""
    acc, p = 0, tile - 1
    while True:
        words = [status[p - lane] if p - lane >= 0 else INCL
                 for lane in range(32)]
        assert all(w & ~VAL for w in words), "a tile had not published"
        fin = [lane for lane, w in enumerate(words) if w & ~VAL == INCL]
        first = fin[0] if fin else 31
        v = 0
        for w in words[:first + 1]:
            v = op(v, w & VAL)
        acc = op(acc, v)
        if fin:
            return acc
        p -= 32


def _blocked_scan(m: int, base: int, start_of, op, counts=None):
    """One tile's blocked rows (thread th holds base + 4 th + q): each
    row's local fold of ``start_of(r)`` (0: none), each thread's
    exclusive fold over the block and the tile's fold; with ``counts``
    (a function of the row), also each thread's exclusive sum of it and
    the tile's sum."""
    loc, ex, ex_c = [], [], []
    acc = acc_c = 0
    for th in range(THREADS):
        run, c = 0, 0
        ex.append(acc)
        ex_c.append(acc_c)
        for q in range(ITEMS):
            r = base + th * ITEMS + q
            if r < m:
                run = op(run, start_of(r))
                c += counts(r) if counts else 0
            loc.append(run)
        acc, acc_c = op(acc, run), acc_c + c
    return loc, ex, ex_c, acc, acc_c


def _tiles(tiles: int, order: str):
    return range(tiles - 1, -1, -1) if order == "last" else range(tiles)


def pay_model(lo_s, o1, key_hi, uidx=None, order="last"):
    """K13's pre-pass, tile by tile as the kernel runs it: every tile
    first publishes, then the look-backs run in ``order``.  Returns (hi1,
    pay)."""
    lo = lo_s.tolist()
    m = len(lo)
    tiles = -(-m // TILE)
    status, state = [0] * tiles, []

    def start_of(r):
        return r + 1 if r == 0 or lo[r] != lo[r - 1] else 0

    for tile in range(tiles):
        base = tile * TILE
        loc, ex, _, tile_max, _ = _blocked_scan(m, base, start_of, max)
        own = tile_max != 0
        starts = base == 0 or lo[base] != lo[base - 1]
        status[tile] = (INCL if own else AGG) | tile_max
        state.append((loc, ex, own, starts))
    g = np.empty(m, np.int64)
    for tile in _tiles(tiles, order):
        loc, ex, own, starts = state[tile]
        pre = _look_back(status, tile, max) if tile and not starts else 0
        if not own:
            status[tile] = INCL | pre
        base = tile * TILE
        for i, v in enumerate(loc):
            if base + i < m:
                g[base + i] = max(pre, ex[i // ITEMS], v) - 1
    pos = o1.numpy() if uidx is None else uidx.numpy()[o1.numpy()]
    return key_hi[o1], _t(g << 32 | pos)


def heads_model(hi_s, pay, o2, rank=None, order="last"):
    """K13's main pass, tile by tile as the kernel runs it.  Full form:
    (rank, the unresolved list, count); compact form (``rank`` updated in
    place): (the list, count).  Both lists are in sorted order, placed by
    the look-back of sums."""
    hi = hi_s.tolist()
    m = len(hi)
    pay_s = pay.numpy()[o2.numpy()]
    g_s, pos_of = (pay_s >> 32).tolist(), (pay_s & 0xFFFFFFFF).tolist()
    compact = rank is not None
    tiles = -(-m // TILE)
    op = _max_fields if compact else max
    status, status_sum, state = [0] * tiles, [0] * tiles, []

    def head(r, first_key):
        if r == 0 or r >= m:
            return True
        if first_key:
            return hi[r] >> 32 != hi[r - 1] >> 32
        return hi[r] != hi[r - 1] or g_s[r] != g_s[r - 1]

    def start_of(r):
        if compact:
            return ((r + 1) << 31 if head(r, True) else 0) | \
                (r + 1 if head(r, False) else 0)
        return r + 1 if head(r, False) else 0

    def unresolved(r):
        return int(not (head(r, False) and head(r + 1, False)))

    for tile in range(tiles):  # each block before its look-back
        base = tile * TILE
        loc, ex, ex_left, tile_max, tile_left = _blocked_scan(
            m, base, start_of, op, unresolved)
        own = (tile_max >> 31 if compact else tile_max) != 0
        starts = base == 0 or head(base, compact)
        status[tile] = (INCL if own or tile == 0 else AGG) | tile_max
        status_sum[tile] = (INCL if tile == 0 else AGG) | tile_left
        state.append((loc, ex, ex_left, tile_max, tile_left, own, starts))

    out_rank = (rank if compact else torch.empty(m, dtype=torch.int64))
    r_np = out_rank.numpy()
    still = np.full(m, -1, np.int64)
    count = 0
    for tile in _tiles(tiles, order):
        loc, ex, ex_left, tile_max, tile_left, own, starts = state[tile]
        pre = _look_back(status, tile, op) if tile and not starts else 0
        pre_left = _look_back(status_sum, tile, _add) if tile else 0
        if not own and tile:
            status[tile] = INCL | op(pre, tile_max)
        if tile:
            status_sum[tile] = INCL | (pre_left + tile_left)
        base = tile * TILE
        for th in range(THREADS):
            p = op(pre, ex[th])
            slot = pre_left + ex_left[th]
            for q in range(ITEMS):
                r = base + th * ITEMS + q
                if r >= m:
                    break
                g = op(p, loc[th * ITEMS + q])
                pos = pos_of[r]
                if compact:
                    r_np[pos] = (hi[r] >> 32) + ((g & HALF) - (g >> 31))
                else:
                    r_np[pos] = g - 1
                if unresolved(r):
                    still[slot] = pos
                    slot += 1
                    count += 1
    if compact:
        return still[:count], count
    return out_rank, still[:count], count


def _synth(m: int, heads_at, seed: int, compact: bool, lo_values: str):
    """Keys in input order whose sorted order has group heads at
    ``heads_at`` (row 0 always), first-key groups of two such groups
    each; the low key takes a distinct value a group (``many``) or one of
    three (``few``: long runs of equal low keys in the first sort).
    Returns the pre-pass's inputs (lo_s, o1, key_hi[, uidx]) and, in the
    compact form, old ranks to update."""
    g = np.random.default_rng(seed)
    flags = np.zeros(m, bool)
    flags[0] = True
    flags[np.asarray(heads_at, np.int64)] = True
    gid = np.cumsum(flags) - 1
    hi_sorted = (gid // 2 + 5) << 32 | (gid % 2) * 7
    lo_sorted = gid * 3 + 1 if lo_values == "many" else (gid * 7) % 3
    perm = g.permutation(m)
    key_hi = np.empty(m, np.int64)
    key_lo = np.empty(m, np.int64)
    key_hi[perm] = hi_sorted
    key_lo[perm] = lo_sorted
    uidx = _t(g.choice(4 * m, m, replace=False).astype(np.int64)) \
        if compact else None
    out = _pay_inputs(_t(key_hi), _t(key_lo), uidx)
    rank = _t(g.integers(0, 4 * m, 4 * m).astype(np.int64)) if compact \
        else None
    return out, rank


def _synth_case(name: str):
    g = np.random.default_rng(7)
    if name.startswith("m"):
        m = int(name[1:])
        return m, np.nonzero(g.random(m) < 0.3)[0]
    if name == "span3":  # one group over rows 900 .. 2200: three tiles
        m = 3500
        heads = np.nonzero(g.random(m) < 0.5)[0]
        return m, np.concatenate([heads[(heads <= 900) | (heads > 2200)],
                                  [900]])
    if name == "tile_start":  # groups start at tiles' first rows
        return 3073, [1024, 2048, 3000]
    if name == "deep":  # the last group spans 40 tiles: two look-back steps
        return 40 * TILE + 5, [1, 2, 3, 4]
    raise ValueError(name)


SYNTH = ["m2", "m3", "m17", "m1023", "m1024", "m1025", "m2049", "span3",
         "tile_start", "deep"]


def _sort2(hi1, pay):
    hi_s, o2 = torch.sort(hi1, stable=True)
    return hi_s, pay, o2


@pytest.mark.parametrize("lo_values", ["many", "few"])
@pytest.mark.parametrize("order", ["last", "first"])
@pytest.mark.parametrize("name", SYNTH)
def test_pay_model_equals_plain(name, order, lo_values):
    m, heads_at = _synth_case(name)
    for compact in (False, True):
        args, _ = _synth(m, heads_at, 17, compact, lo_values)
        hi1, pay = pbwt.heads_pay_plain(*args)
        mhi1, mpay = pay_model(*args, order=order)
        assert torch.equal(mhi1, hi1) and torch.equal(mpay, pay)


@pytest.mark.parametrize("order", ["last", "first"])
@pytest.mark.parametrize("name", SYNTH)
def test_heads_model_equals_plain_full(name, order):
    m, heads_at = _synth_case(name)
    args, _ = _synth(m, heads_at, 11, False, "many")
    main_in = _sort2(*pbwt.heads_pay_plain(*args))
    rank, still, cnt = pbwt.heads_full_plain(*main_in)
    mrank, mstill, mcnt = heads_model(*main_in, order=order)
    np.testing.assert_array_equal(mrank.numpy(), rank.numpy())
    np.testing.assert_array_equal(mstill, still.numpy())
    assert mcnt == int(cnt)


@pytest.mark.parametrize("order", ["last", "first"])
@pytest.mark.parametrize("name", SYNTH)
def test_heads_model_equals_plain_compact(name, order):
    m, heads_at = _synth_case(name)
    args, rank = _synth(m, heads_at, 13, True, "few")
    main_in = _sort2(*pbwt.heads_pay_plain(*args))
    rank_m = rank.clone()
    still, cnt = pbwt.heads_compact_plain(*main_in, rank)
    mstill, mcnt = heads_model(*main_in, rank_m, order=order)
    np.testing.assert_array_equal(rank_m.numpy(), rank.numpy())
    np.testing.assert_array_equal(mstill, still[:int(cnt)].numpy())
    assert mcnt == int(cnt)


def test_heads_model_on_the_rounds(case):
    """The models of K13's pre-pass and main pass on the kind's bootstrap
    (full form) and compact round, against the plain versions."""
    hi1, pay = pay_model(*case["boot_pay"])
    assert torch.equal(pay, case["boot_in"][1])
    main_in = _sort2(hi1, pay)
    rank, still, cnt = pbwt.heads_full_plain(*main_in)
    mrank, mstill, mcnt = heads_model(*main_in)
    np.testing.assert_array_equal(mrank.numpy(), rank.numpy())
    np.testing.assert_array_equal(mstill, still.numpy())
    assert mcnt == int(cnt) == int(case["cnt"])
    main_in, pay_in = _compact_inputs(case)
    mhi1, mpay = pay_model(*pay_in, order="first")
    assert torch.equal(mpay, main_in[1])
    r_plain, r_model = case["rank"].clone(), case["rank"].clone()
    still, cnt = pbwt.heads_compact_plain(*main_in, r_plain)
    mstill, mcnt = heads_model(*_sort2(mhi1, mpay), r_model)
    np.testing.assert_array_equal(r_model.numpy(), r_plain.numpy())
    np.testing.assert_array_equal(mstill, still[:int(cnt)].numpy())


BOOT_ROWS = 2048


def boot_keys_model(data: np.ndarray, sample: bool):
    """K11: blocks of 2,048 rows, each staging the bytes of its rows'
    positions and the 14-byte halo (zeros past the end)."""
    n = len(data)
    rows = n - (n + 2) // 3 if sample else n

    def pos(j):
        return 3 * (j >> 1) + (j & 1) + 1 if sample else j

    hi = np.empty(rows, np.int64)
    lo = np.empty(rows, np.int64)
    for base in range(0, rows, BOOT_ROWS):
        last = min(base + BOOT_ROWS, rows) - 1
        p0 = pos(base)
        span = pos(last) - p0 + 15
        assert span <= BOOT_ROWS * 3 // 2 + 16
        tile = np.zeros(span, np.uint64)
        have = max(0, min(span, n - p0))
        tile[:have] = data[p0:p0 + have]
        js = np.arange(base, last + 1)
        ps = pos(js)
        b = tile[(ps - p0)[:, None] + np.arange(15)]
        w = [b[:, 4 * q] << 24 | b[:, 4 * q + 1] << 16 | b[:, 4 * q + 2] << 8
             | b[:, 4 * q + 3] for q in range(3)]
        rem = np.clip(n - ps, 1, 15).astype(np.uint64)
        w3 = b[:, 12] << 24 | b[:, 13] << 16 | b[:, 14] << 8 | rem
        flip = np.uint64(1 << 63)
        hi[js] = ((w[0] << np.uint64(32) | w[1]) ^ flip).view(np.int64)
        lo[js] = ((w[2] << np.uint64(32) | w3) ^ flip).view(np.int64)
    return hi, lo


EDGES = [2, 3, 17, BOOT_ROWS - 1, BOOT_ROWS, BOOT_ROWS + 1, 2 * BOOT_ROWS + 1,
         3 * BOOT_ROWS + 2]


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("n", EDGES)
def test_boot_keys_model_equals_plain(n, sample):
    d = _block("text", n)
    d[-min(n, 20):] = np.arange(min(n, 20), dtype=np.uint8) + 200
    hi, lo = pbwt.boot_keys_plain(_t(d), sample)
    mhi, mlo = boot_keys_model(d, sample)
    np.testing.assert_array_equal(mhi, hi.numpy())
    np.testing.assert_array_equal(mlo, lo.numpy())


def extract_model(T: np.ndarray, rank: np.ndarray, r: int):
    """K14's slot rule: suffix i != 0 of rank j to U[j + (j < r0)], suffix
    0 to U[0]; each slot written once."""
    n = len(T)
    r0 = int(rank[0])
    j = rank[1:]
    slots = j + (j < r0)
    np.testing.assert_array_equal(np.sort(np.append(slots, 0)),
                                  np.arange(n))
    U = np.empty(n, np.uint8)
    U[0] = T[n - 1]
    U[slots] = T[:-1]
    aux = rank[(np.arange((n - 1) // r) + 1) * r].astype(np.int32)
    return U, r0 + 1, aux


@pytest.mark.parametrize("n", [2, 3, 17, 255, 1023, 1024, 1025, 4096])
@pytest.mark.parametrize("kind", ["text", "zeros"])
def test_extract_model_equals_plain(kind, n):
    d = _block(kind, n)
    rank = pbwt.suffix_ranks(_t(d))
    for r in sorted({1, 3, pbwt.aux_rate(n)}):
        U, primary, aux = pbwt.extract_plain(_t(d), rank, r)
        mU, mprimary, maux = extract_model(d, rank.numpy(), r)
        np.testing.assert_array_equal(mU, U.numpy())
        assert mprimary == int(primary)
        np.testing.assert_array_equal(maux, aux.numpy())


BUCKET, BIN_ROWS = 1 << 16, 8192


def extract_buckets_model(T: np.ndarray, rank: np.ndarray, r: int,
                          order: str):
    """K14's two passes: pass 1 in blocks of 8,192 suffixes, run in
    ``order``, each taking a cursor a bucket it holds rows of (its rows
    in a bucket in row order, where the kernel's shared atomics give any
    order); every slot of the stage must be written exactly once, and
    inside its bucket's region.  Pass 2 places each bucket's bytes.
    Returns (U, the stage, primary, aux)."""
    n = len(T)
    r0 = int(rank[0])
    d = rank + (rank < r0)
    d[0] = 0
    ent = (d & (BUCKET - 1)) << 8 | np.roll(T, 1).astype(np.int64)
    buckets = -(-n // BUCKET)
    size = np.minimum(BUCKET, n - np.arange(buckets) * BUCKET)
    cursor = np.zeros(buckets, np.int64)
    stage = np.full(n, -1, np.int64)
    written = np.zeros(n, np.int64)
    blocks = range(-(-n // BIN_ROWS))
    for blk in (reversed(blocks) if order == "last" else blocks):
        rows = slice(blk * BIN_ROWS, min(n, (blk + 1) * BIN_ROWS))
        b = d[rows] >> 16
        for bucket in np.unique(b):
            e = ent[rows][b == bucket]
            at = cursor[bucket] + np.arange(len(e))
            assert at[-1] < size[bucket], "a bucket overflowed"
            stage[bucket * BUCKET + at] = e
            written[bucket * BUCKET + at] += 1
            cursor[bucket] += len(e)
    np.testing.assert_array_equal(written, np.ones(n, np.int64))
    np.testing.assert_array_equal(cursor, size)
    U = np.empty(n, np.uint8)
    lo = np.arange(n) & ~(BUCKET - 1)
    U[lo + (stage >> 8)] = stage & 0xFF
    aux = rank[(np.arange((n - 1) // r) + 1) * r].astype(np.int32)
    return U, stage, r0 + 1, aux


@pytest.mark.parametrize("order", ["last", "first"])
@pytest.mark.parametrize("n,r0", [(17, 5), (BUCKET - 1, BUCKET - 2),
                                  (BUCKET + 1, 0), (70_000, BUCKET - 1),
                                  (70_000, BUCKET), (3 * BUCKET + 12_345,
                                                     2 * BUCKET - 1),
                                  (3 * BUCKET + 12_345, 3 * BUCKET)])
def test_extract_buckets_model_equals_plain(n, r0, order):
    """K14's buckets on n below 2^16, not a multiple of it and one past
    it, with suffix 0's rank r0 on a bucket's first and last slot; the
    ranks a random permutation (the slot rule needs no more)."""
    g = np.random.default_rng(n + r0)
    rank = g.permutation(n).astype(np.int64)
    rank[rank == r0], rank[0] = rank[0], r0
    T = g.integers(0, 256, n).astype(np.uint8)
    r = max(1, n // 7)
    U, primary, aux = pbwt.extract_plain(_t(T), _t(rank), r)
    mU, mstage, mprimary, maux = extract_buckets_model(T, rank.copy(), r,
                                                       order)
    np.testing.assert_array_equal(mU, U.numpy())
    assert mprimary == int(primary)
    np.testing.assert_array_equal(maux, aux.numpy())
    stage, _, _ = pbwt.extract_bins_plain(_t(T), _t(rank), r)
    whole = n - n % BUCKET
    np.testing.assert_array_equal(  # the same entries in each bucket
        np.concatenate([np.sort(mstage[:whole].reshape(-1, BUCKET), 1)
                        .reshape(-1), np.sort(mstage[whole:])]),
        stage.numpy())
    np.testing.assert_array_equal(pbwt.extract_place_plain(stage).numpy(),
                                  U.numpy())


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_take_the_plain_versions(case):
    before = dict(pbwt.LAUNCHES)
    d = _t(case["d"])
    for sample in (False, True):
        for a, b in zip(pbwt.boot_keys(d, sample),
                        pbwt.boot_keys_plain(d, sample)):
            assert torch.equal(a, b)
    rank = case["rank"]
    uidx = _t(case["uidx"].astype(np.int64))
    for rows in (None, uidx):
        for a, b in zip(pbwt.round_keys(rank, K, rows),
                        pbwt.round_keys_plain(rank, K, rows)):
            assert torch.equal(a, b)
    main_in, pay_in = _compact_inputs(case)
    for args in (case["boot_pay"], pay_in):
        for a, b in zip(pbwt.heads_pay(*args), pbwt.heads_pay_plain(*args)):
            assert torch.equal(a, b)
    for a, b in zip(pbwt.heads_full(*case["boot_in"]),
                    pbwt.heads_full_plain(*case["boot_in"])):
        assert torch.equal(a, b)
    r1, r2 = rank.clone(), rank.clone()
    s1, c1 = pbwt.heads_compact(*main_in, r1)
    s2, c2 = pbwt.heads_compact_plain(*main_in, r2)
    assert torch.equal(r1, r2) and torch.equal(s1[:int(c1)], s2[:int(c2)])
    ext = (d, case["final"], case["r"])
    for a, b in zip(pbwt.extract(*ext), pbwt.extract_plain(*ext)):
        assert torch.equal(a, b)
    stage = pbwt.extract_bins(*ext)
    for a, b in zip(stage, pbwt.extract_bins_plain(*ext)):
        assert torch.equal(a, b)
    assert torch.equal(pbwt.extract_place(stage[0]),
                       pbwt.extract_place_plain(stage[0]))
    U, primary, aux = pbwt.bwt_encode(d)
    nU = case["d"].copy()
    nprimary, num, idx = engine.bwt_encode(nU, 0)
    np.testing.assert_array_equal(U.numpy(), nU)
    assert int(primary) == nprimary
    np.testing.assert_array_equal(aux.numpy(), idx[:num])
    assert pbwt.LAUNCHES == before


def test_boot_keys_refuses_a_block_past_the_key_layout():
    # 2^31 bytes allocated and never touched: the size check comes first
    with pytest.raises(ValueError, match="2\\^31"):
        pbwt.boot_keys(torch.empty(1 << 31, dtype=torch.uint8))
    with pytest.raises(ValueError):
        pbwt.boot_keys(torch.zeros(8, dtype=torch.int8))
    with pytest.raises(ValueError):
        pbwt.boot_keys(torch.zeros((2, 4), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# tools/bwt_split.py's two drivers rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["torch", "kernel"])
def test_bwt_split_drivers_equal_the_route(driver):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import bwt_split

    d = _t(_block("periodic", 9000))
    r = engine.wideaux_rate(9000)
    clock = bwt_split.Clock(torch.device("cpu"))
    rounds = getattr(bwt_split, f"{driver}_rounds")
    rank, parts = rounds(pbwt, d, clock)
    assert torch.equal(rank, pbwt.suffix_ranks(d))
    assert [p["round"] for p in parts][:2] == ["boot", "full"]
    assert parts[0]["unresolved"] == 8986
    extract = getattr(bwt_split, f"{driver}_extract")
    out, ext = extract(pbwt, d, rank, r, clock)
    for a, b in zip(out, pbwt.bwt_encode_wideaux_device(d, r)):
        assert torch.equal(a, b)
    assert ext
