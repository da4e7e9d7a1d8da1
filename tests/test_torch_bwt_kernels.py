"""K11-K14, the forward BWT's sort kernels (``csrc/bwt_sort.cu``), on the
CPU: each plain version against the JAX function it replaces, numpy
models of the kernels' tiles held to the plain versions, and the wrappers
on CPU tensors.

- plain versions, exactly (ranks and bytes have no tolerance), on the
  ``text``, ``random``, ``runs``, ``zeros`` and ``periodic`` kinds of
  ``make_corpus`` (40,000 bytes): the bootstrap's (rank, mask) against
  ``_bootstrap`` (K11, the torch sorts, K13's full form), a full round from
  those ranks against ``_full_round4`` (K12, K13), a compact round against
  ``_bucket_round_compact4`` (whose dead slots hold n) and the extraction
  against ``_extract_bwt_impl`` (K14).  Each JAX function runs once a kind
  (module-scoped fixtures).
- numpy models of what each kernel does differently from its plain
  version: K13's tiles of 1,024 rows, four a thread, with the block scan,
  the status words and the look-back 32 tiles a step (every tile first
  publishes, then the look-backs run last tile first, so that each walks
  back over tiles that have not finished, or first tile first); K11's
  blocks of 2,048 rows staged with their 14-byte halo (and the sample
  mode's 1.5x span); K14's slot rule, each slot written once.
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


def _boot_plain(d: torch.Tensor):
    k_hi, k_lo = pbwt.boot_keys_plain(d)
    hi_s, o1, o2 = pbwt._sort_pairs(k_hi, k_lo)
    return pbwt.heads_full_plain(hi_s, k_lo, o1, o2), (hi_s, k_lo, o1, o2)


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
    (rank, mask, cnt), boot_in = _boot_plain(_t(d))
    jrank, jmask = jbwt._bootstrap(jnp.asarray(d))
    j32 = jnp.asarray(rank.numpy().astype(np.int32))
    full = jbwt._full_round4(j32, K, n)
    uidx = _compact_rows(mask.numpy())
    compact = jbwt._bucket_round_compact4(
        j32, jnp.asarray(uidx.astype(np.int32)), K, n)
    final = pbwt.suffix_ranks(_t(d))
    r = pbwt.aux_rate(n)
    ext = jbwt._extract_bwt_impl(jnp.asarray(d),
                                 jnp.asarray(final.numpy().astype(np.int32)),
                                 r)
    return {"kind": kind, "d": d, "n": n, "rank": rank, "mask": mask,
            "cnt": cnt, "boot_in": boot_in, "uidx": uidx, "final": final,
            "r": r,
            "jax": {"boot": tuple(np.asarray(x) for x in (jrank, jmask)),
                    "full": tuple(np.asarray(x) for x in full),
                    "compact": tuple(np.asarray(x) for x in compact),
                    "extract": tuple(np.asarray(x) for x in ext)}}


def _compact_inputs(c):
    uidx = _t(c["uidx"].astype(np.int64))
    key_a, key_b = pbwt.round_keys_plain(c["rank"], K, uidx)
    hi_s, o1, o2 = pbwt._sort_pairs(key_a, key_b)
    return hi_s, key_b, o1, o2, uidx


# ---------------------------------------------------------------------------
# plain versions against the JAX package
# ---------------------------------------------------------------------------

def test_bootstrap_plain_equals_jax(case):
    jrank, jmask = case["jax"]["boot"]
    np.testing.assert_array_equal(case["rank"].numpy(), jrank)
    np.testing.assert_array_equal(case["mask"].numpy(), jmask)
    assert int(case["cnt"]) == int(jmask.sum())


def test_full_round_plain_equals_jax(case):
    key_a, key_b = pbwt.round_keys_plain(case["rank"], K)
    hi_s, o1, o2 = pbwt._sort_pairs(key_a, key_b)
    rank, mask, cnt = pbwt.heads_full_plain(hi_s, key_b, o1, o2)
    jrank, jmask, jcnt = case["jax"]["full"]
    np.testing.assert_array_equal(rank.numpy(), jrank)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert int(cnt) == int(jcnt)


def test_compact_round_plain_equals_jax(case):
    rank = case["rank"].clone()
    still, cnt = pbwt.heads_compact_plain(*_compact_inputs(case), rank)
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


def heads_model(hi_s, lo, o1, o2, uidx=None, rank=None, order="last"):
    """K13, tile by tile as the kernel runs it.  Full form: (rank, mask,
    count); compact form (``uidx``, ``rank`` updated in place): (the
    still-unresolved list, count)."""
    hi = hi_s.tolist()
    m = len(hi)
    perm = o1.numpy()[o2.numpy()]
    lo_s = lo.numpy()[perm].tolist()
    compact = uidx is not None
    pos_of = (uidx.numpy()[perm] if compact else perm).tolist()
    tiles = -(-m // TILE)
    op = _max_fields if compact else max
    status, status_sum, state = [0] * tiles, [0] * tiles, []

    def head(r, first_key):
        if r == 0 or r >= m:
            return True
        if first_key:
            return hi[r] >> 32 != hi[r - 1] >> 32
        return hi[r] != hi[r - 1] or lo_s[r] != lo_s[r - 1]

    for tile in range(tiles):  # each block before its look-back
        base = tile * TILE
        loc, runs, lefts, left_bits = [], [], [], []
        for th in range(THREADS):
            run, left = 0, []
            for q in range(ITEMS):
                r = base + th * ITEMS + q
                if r < m:
                    pos1 = r + 1
                    if compact:
                        run = _max_fields(run, (pos1 << 31 if head(r, True)
                                                else 0)
                                          | (pos1 if head(r, False) else 0))
                    elif head(r, False):
                        run = pos1
                loc.append(run)
                left.append(r < m and not (head(r, False)
                                           and head(r + 1, False)))
            runs.append(run)
            left_bits.append(left)
            lefts.append(sum(left))
        ex, ex_left, acc, acc_left = [], [], 0, 0
        for th in range(THREADS):  # the block's exclusive scans
            ex.append(acc)
            ex_left.append(acc_left)
            acc, acc_left = op(acc, runs[th]), acc_left + lefts[th]
        tile_max, tile_left = acc, acc_left
        own = (tile_max >> 31 if compact else tile_max) != 0
        starts = base == 0 or head(base, compact)
        status[tile] = (INCL if own or tile == 0 else AGG) | tile_max
        status_sum[tile] = (INCL if tile == 0 else AGG) | tile_left
        state.append((loc, ex, ex_left, left_bits, tile_max, tile_left,
                      own, starts))

    n_rank = rank if compact else torch.empty(m, dtype=torch.int64)
    out_rank = n_rank.numpy()
    mask = np.zeros(m, bool)
    still = np.full(m, -1, np.int64)
    count = 0
    tiles_order = range(tiles - 1, -1, -1) if order == "last" else \
        range(tiles)
    for tile in tiles_order:
        loc, ex, ex_left, left_bits, tile_max, tile_left, own, starts = \
            state[tile]
        pre = _look_back(status, tile, op) if tile and not starts else 0
        pre_left = _look_back(status_sum, tile, _add) if compact and tile \
            else 0
        if not own and tile:
            status[tile] = INCL | op(pre, tile_max)
        if compact and tile:
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
                pos, un = pos_of[r], left_bits[th][q]
                if compact:
                    out_rank[pos] = (hi[r] >> 32) + ((g & HALF) - (g >> 31))
                    if un:
                        still[slot] = pos
                        slot += 1
                else:
                    out_rank[pos] = g - 1
                    mask[pos] = un
                count += un
    if compact:
        return still[:count], count
    return n_rank, mask, count


def _synth(m: int, heads_at, seed: int, compact: bool):
    """Sorted key pairs with group heads at ``heads_at`` (row 0 always),
    first-key groups of two such groups each, and a random split of a
    random permutation into the two sorts' indices."""
    g = np.random.default_rng(seed)
    flags = np.zeros(m, bool)
    flags[0] = True
    flags[np.asarray(heads_at, np.int64)] = True
    gid = np.cumsum(flags) - 1
    hi_s = (gid // 2 + 5) << 32 | (gid % 2) * 7
    lo_sorted = gid * 3 + 1
    perm = g.permutation(m)
    o2 = g.permutation(m)
    o1 = np.empty(m, np.int64)
    o1[o2] = perm
    lo = np.empty(m, np.int64)
    lo[perm] = lo_sorted
    out = [_t(hi_s.astype(np.int64)), _t(lo), _t(o1), _t(o2.astype(np.int64))]
    if compact:
        n = 4 * m
        out.append(_t(g.choice(n, m, replace=False).astype(np.int64)))
        out.append(_t(g.integers(0, n, n).astype(np.int64)))
    return out


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


@pytest.mark.parametrize("order", ["last", "first"])
@pytest.mark.parametrize("name", SYNTH)
def test_heads_model_equals_plain_full(name, order):
    m, heads_at = _synth_case(name)
    args = _synth(m, heads_at, 11, compact=False)
    rank, mask, cnt = pbwt.heads_full_plain(*args)
    mrank, mmask, mcnt = heads_model(*args, order=order)
    np.testing.assert_array_equal(mrank.numpy(), rank.numpy())
    np.testing.assert_array_equal(mmask, mask.numpy())
    assert mcnt == int(cnt)


@pytest.mark.parametrize("order", ["last", "first"])
@pytest.mark.parametrize("name", SYNTH)
def test_heads_model_equals_plain_compact(name, order):
    m, heads_at = _synth_case(name)
    hi_s, lo, o1, o2, uidx, rank = _synth(m, heads_at, 13, compact=True)
    rank_m = rank.clone()
    still, cnt = pbwt.heads_compact_plain(hi_s, lo, o1, o2, uidx, rank)
    mstill, mcnt = heads_model(hi_s, lo, o1, o2, uidx, rank_m, order=order)
    np.testing.assert_array_equal(rank_m.numpy(), rank.numpy())
    np.testing.assert_array_equal(mstill, still[:int(cnt)].numpy())
    assert mcnt == int(cnt)


def test_heads_model_on_the_rounds(case):
    """The model of K13 on the kind's bootstrap (full form) and compact
    round, against the plain versions."""
    rank, mask, cnt = pbwt.heads_full_plain(*case["boot_in"])
    mrank, mmask, mcnt = heads_model(*case["boot_in"])
    np.testing.assert_array_equal(mrank.numpy(), rank.numpy())
    np.testing.assert_array_equal(mmask, mask.numpy())
    assert mcnt == int(cnt)
    args = _compact_inputs(case)
    r_plain, r_model = case["rank"].clone(), case["rank"].clone()
    still, cnt = pbwt.heads_compact_plain(*args, r_plain)
    mstill, mcnt = heads_model(*args, r_model)
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
    for a, b in zip(pbwt.heads_full(*case["boot_in"]),
                    pbwt.heads_full_plain(*case["boot_in"])):
        assert torch.equal(a, b)
    args = _compact_inputs(case)
    r1, r2 = rank.clone(), rank.clone()
    s1, c1 = pbwt.heads_compact(*args, r1)
    s2, c2 = pbwt.heads_compact_plain(*args, r2)
    assert torch.equal(r1, r2) and torch.equal(s1[:int(c1)], s2[:int(c2)])
    for a, b in zip(pbwt.extract(d, case["final"], case["r"]),
                    pbwt.extract_plain(d, case["final"], case["r"])):
        assert torch.equal(a, b)
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
