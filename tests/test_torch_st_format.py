"""bsc's Sort Transform format (``-m5 -e1``: ST5 and the static QLFC
coder) against the benchmark's exact reference (``portbench/ref/st``,
``ref/block_st``): the reference's ST, written from its definition,
against the port's device ST (``ops/st``) and the native ST for k = 3..8;
``api.compress`` on ``device="cpu"`` under ``TBSC_ENGINE=ops`` against
``block_st.expected_many`` where LZP pays, where the screen skips it, on
a stored block, under 64 KiB and at the 1 MiB device route; and the ST
route's spans: the forward's route tag, its copies and its count, the
inverse's thread tag."""

import numpy as np
import pytest
import torch

from libbsc_tpu_torch import api, engine
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.ops import st as opsst
from libbsc_tpu_torch.utils import trace
from portbench.ref import block_st
from portbench.ref import st as refst
from tests.test_torch_default_format import (phrases, random_bytes, runs,
                                             zipf_text)

N = 40_000
CFG = {"lzp": [C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN],
       "switches": ["-b25", "-m5", "-G"]}
FEATURES = C.FEATURE_MULTITHREADING | C.FEATURE_CUDA
ST5_STATIC = C.BLOCKSORTER_ST5 | C.CODER_QLFC_STATIC << 5


def period(n: int) -> np.ndarray:
    """A 7-byte pattern over and over: every context repeats, and ties
    of equal contexts span the whole block."""
    return np.resize(np.frombuffer(b"abcabde", np.uint8), n)


KINDS = {"text": zipf_text, "runs": runs, "random": random_bytes,
         "one_byte": lambda n: np.full(n, 0x61, np.uint8), "period": period}


# -- the reference's ST against the port's ----------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [3, 4, 5, 6, 7, 8])
def test_reference_st_equals_ops_and_native(kind, k):
    data = KINDS[kind](N)
    want, index = refst.st_encode(torch.from_numpy(data.copy()), k)
    out, idx = opsst.st_encode(torch.from_numpy(data.copy()), k)
    assert torch.equal(out, want) and int(idx) == index
    native = data.copy()
    assert engine.st_encode(native, k, 0) == index
    np.testing.assert_array_equal(native, want.numpy())


def test_reference_st_orders():
    with pytest.raises(ValueError):
        refst.st_encode(torch.zeros(8, dtype=torch.uint8), 2)
    with pytest.raises(ValueError):
        refst.st_encode(torch.zeros(8, dtype=torch.uint8), 9)
    assert block_st.order_of(CFG) == 5
    with pytest.raises(ValueError):
        block_st.order_of({"switches": ["-b25", "-G"]})


# -- api.compress against the reference's blocks ----------------------------

BLOCKS = {
    "lzp_pays": lambda: phrases(N),
    "screen_skips": lambda: zipf_text(1_100_000),
    "stored": lambda: random_bytes(N),
    "under_64k": lambda: zipf_text(N),
}


@pytest.fixture
def device_st(monkeypatch):
    """The route a -G device worker's block takes: the ST of a block of
    1 MiB or more on the API's device, here under ``ops`` (the CPU)."""
    monkeypatch.setattr(engine, "_force", "ops")
    api.init(FEATURES, device="cpu")


def _compress(data: np.ndarray, **kw) -> bytes:
    kw.setdefault("lzp_hash_size", C.DEFAULT_LZPHASHSIZE)
    kw.setdefault("lzp_min_len", C.DEFAULT_LZPMINLEN)
    return api.compress(data.tobytes(), block_sorter=C.BLOCKSORTER_ST5,
                        coder=C.CODER_QLFC_STATIC, features=FEATURES, **kw)


def _mode(block: bytes) -> int:
    return int.from_bytes(block[8:12], "little")


@pytest.mark.parametrize("name", BLOCKS)
def test_reference_equals_api_compress(device_st, name):
    data = BLOCKS[name]()
    routes = engine.DEVICE_ROUTES["st_encode"]
    got = _compress(data)
    [want] = block_st.expected_many([(data, got)], CFG, "cpu")
    assert got == want
    assert engine.DEVICE_ROUTES["st_encode"] - routes == (
        name == "screen_skips")
    if name == "stored":
        assert _mode(got) == 0
    else:
        assert _mode(got) & 0xFF == ST5_STATIC
        assert bool(_mode(got) >> 8) == (name == "lzp_pays")
        assert got[-1] == 0, "an ST block carries no aux index"
    assert api.decompress(got) == data.tobytes()


def test_reference_sees_a_flipped_bit(device_st):
    data = zipf_text(N)
    got = bytearray(_compress(data))
    assert block_st.encode(data, CFG, "cpu") == bytes(got)
    got[len(got) // 2] ^= 1
    assert block_st.encode(data, CFG, "cpu") != bytes(got)


def test_reference_at_a_lower_order_is_another_block(device_st):
    """The control's shortcut: order 4 under order 5's mode word."""
    data = zipf_text(N)
    got = _compress(data)
    low = block_st.encode(data, CFG, "cpu", order=4)
    assert _mode(low) == _mode(got) and low != got


# -- the ST route's spans ---------------------------------------------------

def _profiled(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


def test_device_route_spans(device_st):
    """A block of 1 MiB or more on the device route: tag device, one
    upload and one download under the ST span, one device sort counted."""
    data = zipf_text(1_100_000)
    before = dict(engine.DEVICE_ROUTES)
    _profiled(lambda: _compress(data))
    assert engine.DEVICE_ROUTES == dict(
        before, st_encode=before["st_encode"] + 1)
    rec = trace.spans()
    [st] = [s for s in rec if s.name == "st5_encode"]
    assert st.tag == "device" and st.nbytes == len(data)
    kids = sorted((s.name, s.nbytes) for s in rec if s.parent == st.id)
    assert kids == [("st.download", len(data)), ("st.upload", len(data))]


@pytest.mark.parametrize("case", ["under_1_mib", "no_feature_cuda"])
def test_host_route_spans(device_st, monkeypatch, case):
    """A block under 1 MiB, or a call without FEATURE_CUDA (the -G farm's
    host worker, outside ``ops``), sorts on the native runtime: tag host,
    no copy spans, nothing counted."""
    if case == "under_1_mib":
        data, features = zipf_text(N), FEATURES
    else:
        monkeypatch.setattr(engine, "_force", None)
        data, features = zipf_text(1_100_000), C.FEATURE_MULTITHREADING
    before = dict(engine.DEVICE_ROUTES)
    _profiled(lambda: api.compress(
        data.tobytes(), block_sorter=C.BLOCKSORTER_ST5,
        coder=C.CODER_QLFC_STATIC, features=features))
    assert engine.DEVICE_ROUTES == before
    rec = trace.spans()
    [st] = [s for s in rec if s.name == "st5_encode"]
    assert st.tag == "host"
    assert not [s for s in rec if s.parent == st.id]


def test_decode_span_tag(device_st):
    """The inverse ST runs on the native runtime, one thread whatever
    count the features give it."""
    data = zipf_text(1_100_000)
    blob = _compress(data)
    assert _profiled(lambda: api.decompress(blob)) == data.tobytes()
    [unst] = [s for s in trace.spans() if s.name == "st5_decode"]
    assert unst.tag == "host, 1 threads" and unst.nbytes == len(data)


def test_spans_off_record_nothing(device_st):
    before = trace.spans()
    blob = _compress(zipf_text(1_100_000))
    api.decompress(blob)
    assert trace.spans() == before
