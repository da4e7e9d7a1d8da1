"""The port's DC3 device BWT (``ops/bwt.bwt_encode_dc3``) against the JAX
package's ``bwt_encode_dc3`` and the port's native BWT, exactly (U,
primary and aux indexes), and ``engine.bwt_encode``'s ``TBSC_BWT=dc3``
route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libbsc_tpu.ops import bwt as jbwt
from libbsc_tpu_torch import engine
from libbsc_tpu_torch.ops import bwt as pbwt
from tests.conftest import make_corpus

KINDS = ["text", "random", "runs", "zeros", "periodic"]


def _data(n: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(1000 * KINDS.index(kind) + n)
    return np.frombuffer(make_corpus(rng, n, kind), np.uint8).copy()


def _native(data: np.ndarray):
    u = data.copy()
    primary, ni, idx = engine.bwt_encode(u, 0)
    assert primary >= 0
    return u, primary, idx[:ni]


@pytest.mark.parametrize("n", [64, 65, 66, 4096])
def test_equals_jax_dc3(n):
    """Every n mod 3, the smallest n that takes DC3 first."""
    data = _data(n, "text")
    U, primary, aux = pbwt.bwt_encode_dc3(torch.from_numpy(data))
    jU, jprimary, jaux = jbwt.bwt_encode_dc3(jnp.asarray(data))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    assert int(primary) == int(jprimary)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [63, 64, 65, 66, 255, 4096, 65537])
def test_equals_native_bwt(n, kind):
    data = _data(n, kind)
    U, primary, aux = pbwt.bwt_encode_dc3(torch.from_numpy(data))
    ref_u, ref_primary, ref_aux = _native(data)
    np.testing.assert_array_equal(U.numpy(), ref_u)
    assert int(primary) == ref_primary
    np.testing.assert_array_equal(aux.numpy(), ref_aux)


@pytest.mark.parametrize("kind", ["text", "runs"])
def test_suffix_array_dc3_equals_prefix_quadrupling(kind):
    data = torch.from_numpy(_data(20_000, kind))
    sa, rank = pbwt.suffix_array_dc3(data)
    ref_sa, ref_rank = pbwt.suffix_array(data)
    assert torch.equal(sa, ref_sa) and torch.equal(rank, ref_rank)


def test_engine_takes_the_dc3_route_on_request(monkeypatch):
    """TBSC_BWT_DEVICE=1 TBSC_BWT=dc3 (any case) sends a 1 MiB block
    through bwt_encode_dc3, counted under its name; the bytes are the host
    BWT's."""
    data = _data(1 << 20, "text")
    monkeypatch.setenv("TBSC_BWT_DEVICE", "1")
    monkeypatch.setenv("TBSC_BWT", "DC3")
    before = dict(engine.DEVICE_ROUTES)
    dev = data.copy()
    primary, ni, aux = engine.bwt_encode(dev, 0, torch.device("cpu"))
    assert engine.DEVICE_ROUTES == dict(
        before, bwt_encode_dc3=before["bwt_encode_dc3"] + 1)
    ref_u, ref_primary, ref_aux = _native(data)
    np.testing.assert_array_equal(dev, ref_u)
    assert primary == ref_primary
    np.testing.assert_array_equal(aux[:ni], ref_aux)


def test_engine_keeps_prefix_quadrupling_otherwise(monkeypatch):
    monkeypatch.setenv("TBSC_BWT_DEVICE", "1")
    monkeypatch.setenv("TBSC_BWT", "prefix")
    before = dict(engine.DEVICE_ROUTES)
    engine.bwt_encode(_data(1 << 20, "runs"), 0, torch.device("cpu"))
    assert engine.DEVICE_ROUTES == dict(
        before, bwt_encode=before["bwt_encode"] + 1)
