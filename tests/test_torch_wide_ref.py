"""The wide coder's Python reference (``ops/wide.wide_encode_ref`` /
``wide_decode_ref``, v2 and v3) against the JAX package's, and against the
native codec's payloads."""

import numpy as np
import pytest

from libbsc_tpu.ops import wide as jwide
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch.ops import wide as pwide
from tests.conftest import make_corpus

CASES = [("text", 40_000, None), ("runs", 40_000, 16), ("random", 12_000, 4),
         ("text", 9_000, 3), ("zeros", 20_000, 8)]


def _data(kind: str, n: int) -> bytes:
    return make_corpus(np.random.default_rng(n + len(kind)), n, kind)


@pytest.fixture(scope="module")
def jax_payloads():
    """The JAX reference's payload of every case, v2 and v3, one call
    each."""
    return {(kind, n, lanes, rans): jwide.wide_encode_ref(
        _data(kind, n), lanes, rans=rans)
        for kind, n, lanes in CASES for rans in (False, True)}


@pytest.mark.parametrize("rans", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("kind,n,lanes", CASES)
def test_reference_encode_equals_jax(kind, n, lanes, rans, jax_payloads):
    data = _data(kind, n)
    payload = pwide.wide_encode_ref(data, lanes, rans=rans)
    assert payload == jax_payloads[kind, n, lanes, rans]
    if payload is None:  # not smaller than the input (random bytes)
        return
    back = pwide.wide_decode_ref(payload)
    assert back == data
    assert back == jwide.wide_decode_ref(payload)


@pytest.mark.parametrize("rans", [False, True], ids=["v2", "v3"])
def test_reference_decodes_the_native_codec(rans):
    """The native codec's payload (balanced lanes: an explicit lane table)
    decodes through the reference."""
    pengine.init("cpu")
    data = _data("text", 60_000)
    payload = pwide.wide_encode(data, n_lanes=8, rans=rans)
    assert pwide.wide_decode_ref(payload) == data


def test_reference_refuses_an_unknown_model_version():
    payload = bytearray(pwide.wide_encode_ref(_data("text", 9_000), 4))
    payload[6] = 0  # flags: no model v2
    with pytest.raises(ValueError):
        pwide.wide_decode_ref(bytes(payload))
