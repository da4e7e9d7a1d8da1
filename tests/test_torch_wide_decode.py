"""Wide decode with K3 (plain version on the CPU) against the JAX package's
decode kernel in interpret mode, the stream prologue against its
_prep_call, and the payloads outside the v3 kernel route."""

import struct

import numpy as np
import pytest
import torch

from libbsc_tpu.ops import wide as jwide
from libbsc_tpu.ops import wide_kernels as jwk
from libbsc_tpu_torch import api, engine
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.format.header import pack_block_header, pack_mode
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk
from libbsc_tpu_torch.utils.adler32 import adler32


@pytest.fixture(scope="module")
def corpus():
    # 24 dead lanes: lane_sizes gives 1000 live lanes at this size
    n = 1024 * 36 + 123
    g = np.random.default_rng(271)
    out = bytearray()
    while len(out) < n:
        out += bytes([g.integers(0, 4)]) * int(g.integers(1, 10))
    return bytes(out[:n])


def test_device_decode_equals_jax_interpret(corpus):
    p = jwide.wide_encode(corpus, n_lanes=1024, rans=True)
    assert p == pwide.wide_encode(corpus, n_lanes=1024, rans=True)
    ref = jwk.device_decode(p, interpret=True)
    ours = pwk.device_decode(p, device="cpu")
    assert ref == corpus
    assert ours == ref


def test_device_decode_with_an_equal_split_table(corpus):
    # no explicit lane table: the decoder derives lane_sizes (24 dead lanes)
    p = pwide.wide_encode(corpus, n_lanes=1024, balanced=False)
    assert pwk._dec_parse(p)["lane_sz"][-24:].sum() == 0
    assert pwk.device_decode(p, device="cpu") == corpus


def test_prep_prologue_equals_jax_prep_call():
    g = np.random.default_rng(7)
    lane_sz = g.integers(0, 50, size=(8, 128)).astype(np.int32)
    lane_sz[2, :] = 0    # empty group
    lane_sz[5, ::3] = 0  # dead lanes inside a live group
    live_n = (lane_sz > 0).sum(axis=1).astype(np.int32)
    gunits = (2 * live_n + g.integers(0, 80, size=8)).astype(np.int32)
    gunits[2] = 0
    total = int(gunits.sum())
    units = g.integers(0, 1 << 16, size=total).astype(np.uint16)
    SROWS, UT = 16, 1 << 12
    upad = np.zeros(UT, dtype=np.uint16)
    upad[:total] = units
    jw, jg, js = jwk._prep_call(UT, SROWS, True)(upad, gunits, lane_sz)
    pw, pg, ps = pwk._prep(torch.from_numpy(upad.astype(np.int32)),
                           torch.from_numpy(gunits),
                           torch.from_numpy(lane_sz), UT, SROWS)
    assert np.array_equal(pw.numpy(), np.asarray(jw).astype(np.int64))
    assert np.array_equal(pg.numpy(), np.asarray(jg))
    # the port's stream holds the u16 units as int16 bit patterns
    assert np.array_equal(ps.numpy().view(np.uint16), np.asarray(js))


def _v2_archive(d: bytes) -> bytes:
    """A -m9 -e4 block of d whose wide payload is the v2 range-coded format
    (no rANS flag), composed from the port's host stages."""
    lz = np.frombuffer(d, dtype=np.uint8).copy()
    index, k, aux, _r = engine.bwt_encode_wideaux(lz)
    payload = pwide.wide_encode(lz.tobytes(), n_lanes=1024, rans=False)
    payload += aux.astype("<i4").tobytes() + struct.pack("<I", k) + b"\xff"
    mode = pack_mode(C.BLOCKSORTER_BWT_WIDEAUX, C.CODER_QLFC_WIDE, 0, 0)
    return pack_block_header(len(payload) + C.HEADER_SIZE, len(d), mode,
                             index, adler32(d), adler32(payload)) + payload


def test_payloads_outside_the_kernel_route():
    d = (b"a" * 50 + b"b" * 30 + b"c" * 7) * 1000
    p128 = pwide.wide_encode(d, n_lanes=128)
    assert p128 is not None
    assert pwk.device_decode(p128, device="cpu") is None  # not 1024 lanes
    # a v2 payload (no rANS flag) takes K4 on the device route, and the
    # native codec on the host route
    archive = _v2_archive(d)
    try:
        api.init(C.FEATURE_CUDA, device="cpu")
        assert api.decompress(archive) == d
        api.init(0, device="cpu")
        assert api.decompress(archive) == d
    finally:
        api.init(C.DEFAULT_FEATURES, device="cpu")
