"""The port's device ST (``ops/st.py``) against the JAX package's
``st_encode`` and the native runtime's ST, k = 3..8, on blocks of about
40 KB, and the engine's device route against the native ST on blocks just
over 1 MiB.  Exact equality: a transform of bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libbsc_tpu.ops import st as jst
from libbsc_tpu_torch import engine
from libbsc_tpu_torch.ops import st as pst
from tests.conftest import make_corpus

N = 40_000
KINDS = ["text", "runs", "periodic", "zeros", "ff"]
ORDERS = [3, 4, 5, 6, 7, 8]


def _block(kind: str) -> np.ndarray:
    if kind == "ff":  # every context is all 0xFF, the largest key
        return np.full(N, 0xFF, np.uint8)
    rng = np.random.default_rng(400 + KINDS.index(kind))
    return np.frombuffer(make_corpus(rng, N, kind), np.uint8).copy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", ORDERS)
def test_st_encode_equals_jax_and_native(kind, k):
    d = _block(kind)
    out, idx = pst.st_encode(torch.from_numpy(d), k)
    ref_out, ref_idx = jst.st_encode(jnp.asarray(d), k)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    assert idx.dtype == torch.int32 and int(idx) == int(ref_idx)
    native = d.copy()
    assert engine.st_encode(native, k, 0) == int(idx)
    np.testing.assert_array_equal(out.numpy(), native)


def test_short_blocks_and_bad_orders():
    one = torch.tensor([7], dtype=torch.uint8)
    out, idx = pst.st_encode(one, 5)
    assert torch.equal(out, one) and int(idx) == 0
    for n in (2, 3, 5):  # wraps more than once for k > n
        d = np.frombuffer(b"bca\x00z"[:n], np.uint8).copy()
        out, idx = pst.st_encode(torch.from_numpy(d), 8)
        ref_out, ref_idx = jst.st_encode(jnp.asarray(d), 8)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        assert int(idx) == int(ref_idx)
    with pytest.raises(ValueError):
        pst.st_encode(one, 2)
    with pytest.raises(ValueError):
        pst.st_encode(one, 9)


_DEVICE_BLOCKS = {}


def _device_block(kind: str) -> np.ndarray:
    """A block just over 1 MiB (odd length), made once per kind."""
    if kind not in _DEVICE_BLOCKS:
        n = (1 << 20) + 12345
        if kind == "ff":
            d = np.full(n, 0xFF, np.uint8)
        else:
            rng = np.random.default_rng(500 + KINDS.index(kind))
            d = np.frombuffer(make_corpus(rng, n, kind), np.uint8).copy()
        _DEVICE_BLOCKS[kind] = d
    return _DEVICE_BLOCKS[kind]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", ORDERS)
def test_engine_device_route_equals_native(monkeypatch, kind, k):
    """engine.st_encode with a device sorts a block of 1 MiB or more there
    at its own length, in one call of ops/st.st_encode; the bytes and the
    index are the native ST's.  A block under 1 MiB stays on the host."""
    d = _device_block(kind)
    seen = []
    real = pst.st_encode

    def spy(data, order):
        seen.append((data.shape[0], order))
        return real(data, order)

    monkeypatch.setattr(pst, "st_encode", spy)
    dev = d.copy()
    idx = engine.st_encode(dev, k, 0, torch.device("cpu"))
    assert seen == [(len(d), k)]
    host = d.copy()
    assert engine.st_encode(host, k, 0) == idx
    np.testing.assert_array_equal(dev, host)
    small = d[:5000].copy()
    engine.st_encode(small, k, 0, torch.device("cpu"))  # under 1 MiB: host
    assert len(seen) == 1
