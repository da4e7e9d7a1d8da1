"""Wide decode of v2 (range-coded) payloads with K4 (plain version on the
CPU) against the JAX package's K4 in interpret mode, and the v2 -m9 -e4
archive through both packages' api.decompress.  All comparisons are
exact: the codec is lossless."""

import numpy as np
import pytest

from libbsc_tpu import api as japi
from libbsc_tpu.ops import wide as jwide
from libbsc_tpu.ops import wide_kernels as jwk
from libbsc_tpu_torch import api, engine
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk
from tests.test_torch_wide_decode import _v2_archive


@pytest.fixture(scope="module")
def corpus():
    # 24 dead lanes: lane_sizes gives 1000 live lanes at this size
    n = 1024 * 36 + 123
    g = np.random.default_rng(271)
    out = bytearray()
    while len(out) < n:
        out += bytes([g.integers(0, 4)]) * int(g.integers(1, 10))
    return bytes(out[:n])


@pytest.fixture(scope="module")
def payload(corpus):
    p = pwide.wide_encode(corpus, n_lanes=1024, rans=False)
    assert p == jwide.wide_encode(corpus, n_lanes=1024, rans=False)
    return p


@pytest.fixture(scope="module")
def jax_decoded(payload):
    return jwk.device_decode(payload, interpret=True)


def test_device_decode_v2_equals_jax_interpret(corpus, payload, jax_decoded):
    assert not pwk._dec_parse(payload)["rans"]  # flag bit 2 clear: K4
    before = dict(pwk.LAUNCHES)
    ours = pwk.device_decode(payload, device="cpu")
    assert pwk.LAUNCHES == before  # plain versions launch nothing
    assert jax_decoded == corpus
    assert ours == jax_decoded


def test_device_decode_v2_with_an_equal_split_table(corpus):
    p = pwide.wide_encode(corpus, n_lanes=1024, balanced=False, rans=False)
    assert pwk._dec_parse(p)["lane_sz"][-24:].sum() == 0
    assert pwk.device_decode(p, device="cpu") == corpus


def _runs(n: int, seed: int) -> bytes:
    """Runs of 20-199 bytes over four symbols: after the BWT each lane codes
    few bits, which keeps the plain decode loop short at 1 MiB."""
    g = np.random.default_rng(seed)
    sym = g.integers(97, 101, n // 20 + 1, dtype=np.uint8)
    return np.repeat(sym, g.integers(20, 200, n // 20 + 1))[:n].tobytes()


def test_v2_archive_on_the_fused_route(monkeypatch):
    """At 1 MiB the device route is the fused one (wide decode, then the
    wide-aux chase on the device), which now takes v2 payloads too."""
    d = _runs(1 << 20, 3)
    archive = _v2_archive(d)
    fused = []
    spy = engine.decompress_block_device

    def recording(*args, **kw):
        out = spy(*args, **kw)
        fused.append(out is not None)
        return out

    monkeypatch.setattr(engine, "decompress_block_device", recording)
    try:
        api.init(C.FEATURE_CUDA, device="cpu")
        assert api.decompress(archive) == d
        assert fused == [True]
    finally:
        api.init(C.DEFAULT_FEATURES, device="cpu")
    japi.init()
    assert japi.decompress(archive) == d
