"""K8, the wide-aux chase (``ops/bwt.chase``): its plain version on the
CPU against the JAX package's ``_unbwt_wideaux_jit``, the native
wavefront inverse (``tbsc_bwt_decode_rate``) and the input, exactly, and a
numpy model of the CUDA kernel's thread (16 steps a store, a byte a step
for other rates, stop at n) against the plain version.

Cases: n = k r, k r + 1 and k r - 1; one chain; all-equal bytes; all 256
byte values; the primary at 1 and at n; rates that are no multiple of 16.
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


def _kernel_model(packed: np.ndarray, heads: np.ndarray, r: int,
                  n: int) -> np.ndarray:
    """csrc/unbwt_chase.cu, one thread at a time: 16 steps gathered into
    one store when r is a multiple of 16 (a store cut at n), else a byte a
    step; a chain stops at n."""
    out = np.full(min(n, len(heads) * r), 0xEE, np.uint8)
    for t, k in enumerate(heads.tolist()):
        o = t * r
        if r % 16 == 0:
            for s0 in range(0, r, 16):
                if o + s0 >= n:
                    break
                group = []
                for _ in range(16):
                    w = int(packed[k])
                    group.append((w >> 32) & 0xFF)
                    k = w & 0xFFFFFFFF
                m = min(16, n - o - s0)
                out[o + s0:o + s0 + m] = group[:m]
        else:
            for s in range(r):
                if o + s >= n:
                    break
                w = int(packed[k])
                out[o + s] = (w >> 32) & 0xFF
                k = w & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("name", ["k_r_plus_1", "k_r_minus_1", "one_chain",
                                  "all_256", "rate_100", "rate_1"])
def test_kernel_model_equals_plain(name, chased):
    data, r = CASES[name]
    U, primary, aux, back, _ = chased[name]
    packed, heads = pbwt.chase_inputs(U, primary, aux)
    plain = pbwt.chase_plain(packed, heads, r, len(data))
    assert torch.equal(plain, back)
    model = _kernel_model(packed.numpy(), heads.numpy(), r, len(data))
    assert np.array_equal(model, plain.numpy())


def test_chase_inputs_rows_and_heads():
    """Row 0 is the sentinel (char 0, PSI = primary); rows 1.. hold the
    sorted chars and the positions they came from, shifted past the
    primary.  The chains start at the primary and at each aux index + 1."""
    U = torch.tensor([3, 1, 2, 1, 255, 0], dtype=torch.uint8)
    packed, heads = pbwt.chase_inputs(U, 2, torch.tensor([4, 0],
                                                         dtype=torch.int32))
    chars = (packed >> 32).tolist()
    psi = (packed & 0xFFFFFFFF).tolist()
    assert chars == [0, 0, 1, 1, 2, 3, 255]
    assert psi == [2, 6, 1, 4, 3, 0, 5]
    assert heads.dtype == torch.int64 and heads.tolist() == [2, 5, 1]


def test_chase_checks_its_arguments():
    packed = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError):
        pbwt.chase(packed, torch.zeros(2, dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError):
        pbwt.chase(packed, torch.zeros(2, dtype=torch.int64), 0, 4)
    assert pbwt.LAUNCHES == {"unbwt_chase": 0}  # no launch on the CPU
