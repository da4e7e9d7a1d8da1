"""The port's exact-shape device BWT (``ops/bwt.bwt_encode``) against the
JAX package's ``bwt_encode`` and the native ``tbsc_bwt_encode``: U, the
primary index and every aux index, exactly."""

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


def _block(kind: str, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(600 + KINDS.index(kind))
    return np.frombuffer(make_corpus(rng, n, kind), np.uint8).copy()


def _native(d: np.ndarray):
    U = d.copy()
    primary, num_indexes, indexes = engine.bwt_encode(U, 0)
    return U, primary, indexes[:num_indexes]


@pytest.mark.parametrize("kind", KINDS)
def test_bwt_encode_equals_jax_and_native(kind):
    d = _block(kind)
    U, primary, aux = pbwt.bwt_encode(torch.from_numpy(d))
    jU, jprimary, jaux = jbwt.bwt_encode(jnp.asarray(d))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    assert int(primary) == int(jprimary)
    assert aux.dtype == torch.int32
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    nU, nprimary, naux = _native(d)
    np.testing.assert_array_equal(U.numpy(), nU)
    assert int(primary) == nprimary
    assert aux.shape[0] == (N - 1) // pbwt.aux_rate(N) == len(naux)
    np.testing.assert_array_equal(aux.numpy(), naux)


@pytest.mark.parametrize("n", [2, 3, 17, 255, 4096])
def test_bwt_encode_small_blocks_equal_native(n):
    d = _block("text", n)
    U, primary, aux = pbwt.bwt_encode(torch.from_numpy(d))
    nU, nprimary, naux = _native(d)
    np.testing.assert_array_equal(U.numpy(), nU)
    assert int(primary) == nprimary
    np.testing.assert_array_equal(aux.numpy(), naux)


@pytest.mark.parametrize("n", [0, 1])
def test_bwt_encode_of_at_most_one_byte(n):
    d = np.full(n, 65, np.uint8)
    U, primary, aux = pbwt.bwt_encode(torch.from_numpy(d))
    jU, jprimary, jaux = jbwt.bwt_encode(jnp.asarray(d))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    assert int(primary) == int(jprimary) == n
    assert aux.shape == (0,) and np.asarray(jaux).shape == (0,)
