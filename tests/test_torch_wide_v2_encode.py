"""Wide encode with the v2 range coder, K5 (plain version on the CPU),
against the JAX package's K5 in interpret mode and the native codec.

``RANS = False`` selects the v2 coder in both packages.  All comparisons are
exact: the codec is lossless."""

import numpy as np
import pytest
import torch

from libbsc_tpu.ops import wide as jwide
from libbsc_tpu.ops import wide_kernels as jwk
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk
from libbsc_tpu_torch.ops import wide_schedule as psched


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
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwk, "RANS", False)
        return jwk.device_encode(corpus, interpret=True)


@pytest.fixture
def v2(monkeypatch):
    monkeypatch.setattr(jwk, "RANS", False)
    monkeypatch.setattr(pwk, "RANS", False)


def test_device_encode_v2_equals_jax_interpret(v2, corpus, jax_payload):
    before = dict(pwk.LAUNCHES)
    ours = pwk.device_encode(corpus, device="cpu")
    assert pwk.LAUNCHES == before  # plain versions launch nothing
    assert jax_payload is not None
    assert ours == jax_payload
    assert ours == pwide.wide_encode(corpus, n_lanes=1024, rans=False)
    assert ours == jwide.wide_encode(corpus, n_lanes=1024, rans=False)
    assert not pwk._dec_parse(ours)["rans"]  # flag bit 2 clear
    assert pwide.wide_decode(ours) == corpus


def test_device_encode_resident_v2_equals_native_with_the_device_table(
        v2, corpus):
    u = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy())
    sizes = psched.device_balanced_sizes(u, pwk.LANES).numpy()
    ours = pwk.device_encode_resident(u)
    assert ours is not None
    assert ours == pwide.wide_encode(corpus, n_lanes=1024, sizes=sizes,
                                     rans=False)


def _equal_split_planes(data: bytes):
    n = len(data)
    buf = np.frombuffer(data, np.uint8).copy()
    pk, max_bits = pwk.host_schedule_packed(buf, n, None, -(-n // pwk.LANES))
    IT = pwk._it_bucket(max(max_bits, pwk.TI))
    pk = np.pad(pk, ((0, 0), (0, max(0, IT // 4 - pk.shape[1]))))
    return torch.from_numpy(np.ascontiguousarray(pk[:, : IT // 4].T)), \
        max_bits


@pytest.mark.parametrize("kind", ["dead_lanes", "few_events"])
def test_rc_encode_on_an_equal_split_table(kind):
    """The equal split of 1024 * 36 + 123 bytes leaves 24 dead lanes, whose
    warm-up slots K5 must skip.  In "few_events" the first half of the
    block is one symbol: those 500 lanes renormalise once, so their one
    emission and first flush unit fill the warm-up pair and the second
    flush unit their one event slot.  In both, dozens of lanes renormalise
    on their last bit."""
    n = 1024 * 36 + 123
    data = _corpus(n, 271)
    if kind == "few_events":
        data = b"a" * (n // 2) + data[n // 2:]
    planes, max_bits = _equal_split_planes(data)
    units, counts = pwk.rc_encode(planes, max_bits)
    payload = pwk._assemble(n, units, counts, None, max_bits)
    assert payload == pwide.wide_encode(data, n_lanes=1024, balanced=False,
                                        rans=False)
    assert pwide.wide_decode(payload) == data


def test_submit_takes_the_coder_the_switch_names(corpus, monkeypatch):
    prep = pwk._host_prep(corpus)
    rans, out, sizes, max_bits = pwk._submit(prep, "cpu")
    assert rans and len(out) == 3  # K1 + K2: units, counts, final states
    monkeypatch.setattr(pwk, "RANS", False)
    rans, out, _, _ = pwk._submit(prep, "cpu")
    assert not rans and len(out) == 2  # K5: units, counts
    assert out[0].shape == (pwk.GROUPS, 128 * (max_bits + 2))
