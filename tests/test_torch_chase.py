"""K8, the wide-aux inverse BWT: its table (``ops/bwt.chase_inputs``: the
bucket ends and the two-step table of ``pair_table``, row k = PSI[PSI[k]]
and the char of row PSI[k]) and its chase (``ops/bwt.chase``).  The
plain versions on the CPU against the JAX package's
``_unbwt_wideaux_jit``, the native wavefront inverse
(``tbsc_bwt_decode_rate``) and the input, exactly; the table against a
numpy stable argsort; and numpy models of the CUDA kernels' threads (the
table kernel's row; the chase's 8-step search of the bucket ends, two
steps a load, 16 bytes a store, for other rates two bytes a load and a
single last step when a chain's length is odd, stop at n) against the
plain versions.

Cases: n = k r, k r + 1 and k r - 1; one chain; all-equal bytes; all 256
byte values; empty buckets at both ends of the byte range; a last chain
of odd length cut at n; the primary at 1 and at n; r = 1, 100 and 256.
The JAX chase packs (char << 25 | PSI) into u32, which keeps only 7 bits
of the char, so on bytes of 128 or more it is held to the input with bit
7 cleared."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libbsc_tpu.ops import bwt as jbwt
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch.ops import bwt as pbwt
from tests.conftest import make_corpus


def _text(n: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed)
    return np.frombuffer(make_corpus(g, n, "text"), np.uint8).copy()


def _cases() -> dict:
    """name -> (block, rate)."""
    g = np.random.default_rng(0xC8)
    r = 256
    all256 = np.repeat(np.arange(256, dtype=np.uint8), 40)
    g.shuffle(all256)
    rest = g.integers(1, 255, 6000).astype(np.uint8)
    return {
        "k_r": (_text(40 * r, 1), r),
        "k_r_plus_1": (_text(40 * r + 1, 2), r),
        "k_r_minus_1": (_text(40 * r - 1, 3), r),
        "one_chain": (_text(200, 4), r),
        "all_equal": (np.full(9000, 97, np.uint8), r),
        "all_256": (all256, r),
        "primary_1": (np.concatenate([[0], rest]).astype(np.uint8), r),
        "primary_n": (np.concatenate([[255], rest]).astype(np.uint8), r),
        "rate_100": (_text(4037, 5), 100),
        "rate_1": (_text(300, 6), 1),
        # bytes 40..199 only: buckets 0-39 and 200-255 are empty
        "empty_ends": (g.integers(40, 200, 7000).astype(np.uint8), r),
        # the last chain takes 37 bytes: odd, and cut at n
        "odd_cut": (_text(23 * r + 37, 7), r),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def chased():
    """name -> (U, primary, aux, the plain chase, the JAX chase)."""
    out = {}
    for name, (data, r) in CASES.items():
        U, primary, aux = pbwt.bwt_encode_wideaux_device(
            torch.from_numpy(data.copy()), r)
        back = pbwt.unbwt_wideaux(U, int(primary), aux, r, len(data))
        jback = jbwt._unbwt_wideaux_jit(
            jnp.asarray(U.numpy()), jnp.int32(int(primary)),
            jnp.asarray(aux.numpy()), r, len(data))
        out[name] = (U, int(primary), aux, back, np.asarray(jback))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_chase_plain_equals_input_and_jax(name, chased):
    data, r = CASES[name]
    U, primary, aux, back, jback = chased[name]
    assert aux.shape[0] == (len(data) - 1) // r
    assert np.array_equal(back.numpy(), data)
    if data.max() < 128:
        assert np.array_equal(jback, data)
    else:
        assert np.array_equal(jback, data & 0x7F)


@pytest.mark.parametrize("name", [k for k, (_, r) in CASES.items()
                                  if r >= 256])  # the native rates
def test_chase_plain_equals_native_wavefront(name, chased):
    pengine.init("cpu")
    data, r = CASES[name]
    U, primary, aux, back, _ = chased[name]
    buf = U.numpy().copy()
    assert pengine.bwt_decode_wideaux(buf, primary, aux.shape[0],
                                      aux.numpy(), r, None) == 0
    assert np.array_equal(buf, back.numpy())


def test_primaries_at_their_edges(chased):
    assert chased["primary_1"][1] == 1
    assert chased["primary_n"][1] == len(CASES["primary_n"][0])
    assert chased["one_chain"][2].shape[0] == 0


def _row_char(ends: np.ndarray, k: int) -> int:
    """The kernel's branch-free search: the number of bucket ends at or
    below row k, in 8 steps."""
    c = 0
    s = 128
    while s:
        c += s if ends[c + s - 1] <= k else 0
        s >>= 1
    return c


def _psi(u_sorted: np.ndarray, index: int, k: int) -> int:
    """PSI[k] from the sort's indices, as the table kernel reads it."""
    if k == 0:
        return index
    u = int(u_sorted[k - 1])
    return u + (u >= index)


def _table_model(u_sorted: np.ndarray, index: int,
                 ends: np.ndarray) -> np.ndarray:
    """csrc/unbwt_chase.cu's table kernel, one thread (row) at a time:
    PSI[PSI[k]] low, the char of row PSI[k] by the search above it."""
    n = len(u_sorted)
    pairs = np.empty(n + 1, np.int64)
    for k in range(n + 1):
        p = _psi(u_sorted, index, k)
        pairs[k] = _row_char(ends, p) << 32 | _psi(u_sorted, index, p)
    return pairs


def _kernel_model(pairs: np.ndarray, ends: np.ndarray, heads: np.ndarray,
                  r: int, n: int) -> np.ndarray:
    """csrc/unbwt_chase.cu's chase, one thread at a time: a step of two
    loads row k, finds row k's own char by the search and takes the next
    char from the row; 8 steps of two gathered into one 16-byte store
    when r is a multiple of 16 (a store cut at n); else two bytes a load
    and, when the chain's length is odd, a last single step with no
    load; a chain stops at n."""
    out = np.full(min(n, len(heads) * r), 0xEE, np.uint8)
    for t, k in enumerate(heads.tolist()):
        o = t * r
        if r % 16 == 0:
            for s0 in range(0, r, 16):
                if o + s0 >= n:
                    break
                group = []
                for _ in range(8):
                    x = int(pairs[k])
                    group += [_row_char(ends, k), (x >> 32) & 0xFF]
                    k = x & 0xFFFFFFFF
                m = min(16, n - o - s0)
                out[o + s0:o + s0 + m] = group[:m]
        else:
            m = min(r, n - o)
            s = 0
            while s + 1 < m:
                x = int(pairs[k])
                out[o + s] = _row_char(ends, k)
                out[o + s + 1] = (x >> 32) & 0xFF
                k = x & 0xFFFFFFFF
                s += 2
            if s < m:
                out[o + s] = _row_char(ends, k)
    return out


@pytest.mark.parametrize("name", ["k_r_plus_1", "k_r_minus_1", "one_chain",
                                  "all_256", "rate_100", "rate_1",
                                  "empty_ends", "odd_cut"])
def test_kernel_model_equals_plain(name, chased):
    data, r = CASES[name]
    U, primary, aux, back, _ = chased[name]
    pairs, ends, heads = pbwt.chase_inputs(U, primary, aux)
    plain = pbwt.chase_plain(pairs, ends, heads, r, len(data))
    assert torch.equal(plain, back)
    model = _kernel_model(pairs.numpy(), ends.numpy(), heads.numpy(), r,
                          len(data))
    assert np.array_equal(model, plain.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_table_equals_stable_argsort(name, chased):
    """The table against numpy: PSI[0] the primary, PSI[k] the position
    of the k-th smallest (char, position) shifted past the primary; the
    bucket ends' chars the sorted chars; row k of the two-step table
    PSI[PSI[k]] and the char of row PSI[k]; the table kernel's model
    equals the plain version."""
    U, primary, aux, _, _ = chased[name]
    u = U.numpy()
    n = len(u)
    order = np.argsort(u, kind="stable")
    u_sorted = torch.from_numpy(order.astype(np.int64))
    psi = np.concatenate([[primary], order + (order >= primary)])
    assert np.array_equal(pbwt.psi_rows(u_sorted, primary).numpy(), psi)
    pairs, ends, heads = pbwt.chase_inputs(U, primary, aux)
    assert ends.dtype == torch.int32 and ends.shape == (256,)
    assert np.array_equal(ends.numpy(),
                          1 + np.cumsum(np.bincount(u, minlength=256)))
    chars = np.concatenate([[0], np.sort(u)])
    assert np.array_equal(pbwt.row_chars(ends, torch.arange(n + 1)).numpy(),
                          chars)
    assert [_row_char(ends.numpy(), k) for k in range(0, n + 1, 97)] == \
        chars[::97].tolist()
    assert pairs.dtype == torch.int64
    assert np.array_equal(pairs.numpy(),
                          chars[psi].astype(np.int64) << 32 | psi[psi])
    if n < 20000:  # the model walks the rows in Python
        assert np.array_equal(_table_model(order, primary, ends.numpy()),
                              pairs.numpy())
    assert heads.dtype == torch.int32
    assert heads.tolist() == [primary] + (aux.numpy() + 1).tolist()


def test_chase_inputs_rows_and_heads():
    """Row 0 is the sentinel (PSI = primary, char 0); rows 1.. come from
    the positions of the sorted chars, shifted past the primary.  Row k
    of the table holds PSI[PSI[k]] and the char of row PSI[k]; the
    bucket ends give every row's char.  The chains start at the primary
    and at each aux index + 1."""
    U = torch.tensor([3, 1, 2, 1, 255, 0], dtype=torch.uint8)
    pairs, ends, heads = pbwt.chase_inputs(
        U, 2, torch.tensor([4, 0], dtype=torch.int32))
    u_sorted = torch.sort(U, stable=True)[1]
    assert pbwt.psi_rows(u_sorted, 2).tolist() == [2, 6, 1, 4, 3, 0, 5]
    assert pbwt.row_chars(ends, torch.arange(7)).tolist() == \
        [0, 0, 1, 1, 2, 3, 255]
    assert [_row_char(ends.numpy(), k) for k in range(7)] == \
        [0, 0, 1, 1, 2, 3, 255]
    assert (pairs & 0xFFFFFFFF).tolist() == [1, 5, 6, 3, 4, 2, 0]
    assert (pairs >> 32).tolist() == [1, 255, 0, 2, 1, 0, 3]
    assert heads.dtype == torch.int32 and heads.tolist() == [2, 5, 1]


def test_chase_checks_its_arguments():
    pairs = torch.zeros(5, dtype=torch.int64)
    ends = torch.full((256,), 5, dtype=torch.int32)
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):  # int64 start rows
        pbwt.chase(pairs, ends, starts.long(), 4, 4)
    with pytest.raises(ValueError):  # a u32 table
        pbwt.chase(pairs.int(), ends, starts, 4, 4)
    with pytest.raises(ValueError):  # 255 bucket ends
        pbwt.chase(pairs, ends[1:], starts, 4, 4)
    with pytest.raises(ValueError):
        pbwt.chase(pairs, ends, starts, 0, 4)
    with pytest.raises(ValueError):  # int32 sort indices
        pbwt.pair_table(torch.zeros(4, dtype=torch.int32), 1, ends)
    with pytest.raises(ValueError):  # int64 bucket ends
        pbwt.pair_table(torch.zeros(4, dtype=torch.int64), 1, ends.long())
    assert {"unbwt_table", "unbwt_chase"} <= set(pbwt.LAUNCHES)
    assert pbwt.LAUNCHES == dict.fromkeys(pbwt.LAUNCHES, 0)
