"""Wide encode with K1 and K2 (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode and the native codec."""

import numpy as np
import pytest

from libbsc_tpu.ops import wide as jwide
from libbsc_tpu.ops import wide_kernels as jwk
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk


def _corpus(n, seed):
    g = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([g.integers(0, 4)]) * int(g.integers(1, 10))
    return bytes(out[:n])


@pytest.fixture(scope="module")
def corpus():
    return _corpus(1024 * 40, 212)


@pytest.fixture(scope="module")
def jax_payload(corpus):
    return jwk.device_encode(corpus, interpret=True)


def test_device_encode_equals_jax_interpret(corpus, jax_payload):
    ours = pwk.device_encode(corpus, device="cpu")
    assert jax_payload is not None
    assert ours == jax_payload
    assert ours == jwide.wide_encode(corpus, n_lanes=1024, rans=True)
    assert pwide.wide_decode(ours) == corpus


def test_device_encode_stages_on_a_native_table(corpus):
    prep = pwk._host_prep(corpus)
    planes, sizes, max_bits, IT = prep
    assert planes.shape == (IT // 4, pwk.LANES) and IT >= max_bits
    assert sizes is not None and int(sizes.sum()) == len(corpus)
    rans, (units, counts, fx), _, _ = pwk._submit(prep, "cpu")
    assert rans  # K1 + K2, the default coder
    assert units.shape == (pwk.GROUPS, 128 * max_bits)
    assert int(counts.sum()) > 0 and fx.dtype.is_signed


def test_short_block_does_not_take_the_kernels():
    assert pwk.device_encode(b"ab" * 300, device="cpu") is None
