"""The rest of the port's public API against the JAX package's:
``decompress_batch``, ``compress_inplace`` / ``decompress_inplace``,
``init_full``, the exported names and constants, and the TBSC_LZP_PROBE
opt-in."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import libbsc_tpu as J
import libbsc_tpu_torch as P
from libbsc_tpu import api as japi
from libbsc_tpu_torch import constants as C
from tests.conftest import make_corpus

FEATURES = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING


def _jax_constant_names() -> list:
    """The constants libbsc_tpu/__init__.py imports from its constants."""
    src = (Path(J.__file__).parent / "__init__.py").read_text()
    block = re.search(r"from \.constants import \((.*?)\)", src, re.S)
    return re.findall(r"[A-Z][A-Z0-9_]+", block.group(1))


JAX_CONSTANTS = _jax_constant_names()


def test_the_jax_package_exports_34_constants():
    assert len(JAX_CONSTANTS) == 34


@pytest.mark.parametrize("name", JAX_CONSTANTS)
def test_constant_equals_the_jax_package(name):
    assert getattr(P, name) == getattr(J, name)


def test_public_names_equal_the_jax_package():
    assert set(J.__all__) <= set(P.__all__)
    for name in J.__all__:
        assert callable(getattr(P, name)) or name == "__version__"
    assert P.__version__ == J.__version__


@pytest.fixture(scope="module")
def batch():
    """The specs of tests/test_api.py's decompress_batch test: ST blocks of
    three orders (two of them twice), a BWT block and a stored block."""
    g = np.random.default_rng(115)
    specs = [(C.BLOCKSORTER_ST5, 150_000, "text"),
             (C.BLOCKSORTER_BWT, 120_000, "text"),
             (C.BLOCKSORTER_ST5, 90_000, "runs"),
             (C.BLOCKSORTER_ST3, 60_000, "periodic"),
             (C.BLOCKSORTER_ST8, 200_000, "text"),
             (C.BLOCKSORTER_ST8, 130_000, "runs"),
             (C.BLOCKSORTER_BWT_WIDEAUX, 70_000, "text"),
             (C.BLOCKSORTER_BWT, 50_000, "random")]  # stored
    return [(s, make_corpus(g, n, kind)) for s, n, kind in specs]


@pytest.mark.parametrize("route", ["host", "device"])
def test_decompress_batch_equals_decompress_and_jax(batch, route):
    japi.init(FEATURES)
    P.init(FEATURES, device="cpu")
    blobs = [P.compress(d, block_sorter=s) for s, d in batch]
    assert blobs == [japi.compress(d, block_sorter=s) for s, d in batch]
    expect = [d for _, d in batch]
    P.init(FEATURES | (C.FEATURE_CUDA if route == "device" else 0),
           device="cpu")
    out = P.decompress_batch(blobs)
    assert out == expect
    assert out == [P.decompress(b) for b in blobs]
    assert P.decompress_batch([]) == []


def test_decompress_batch_rejects_a_corrupt_block(batch):
    P.init(FEATURES, device="cpu")
    blobs = [P.compress(d, block_sorter=s) for s, d in batch[:3]]
    bad = bytearray(blobs[1])
    bad[40] ^= 0x10
    with pytest.raises(P.BscError) as e:
        P.decompress_batch([blobs[0], bytes(bad), blobs[2]])
    assert e.value.code == C.DATA_CORRUPT


def test_st_decode_batch_equals_st_decode():
    from libbsc_tpu_torch import engine

    g = np.random.default_rng(484)
    blocks = [np.frombuffer(make_corpus(g, n, "text"), np.uint8).copy()
              for n in (40_000, 70_001, 5)]
    for k in (3, 6):
        coded = [b.copy() for b in blocks]
        idx = [engine.st_encode(c, k, 0) for c in coded]
        one = [c.copy() for c in coded]
        for c, i in zip(one, idx):
            assert engine.st_decode(c, k, i, 0) == 0
        assert engine.st_decode_batch(coded, k, idx) == 0
        for c, o, b in zip(coded, one, blocks):
            assert np.array_equal(c, o) and np.array_equal(c, b)


def test_compress_inplace_roundtrip_equals_jax():
    japi.init(FEATURES)
    P.init(FEATURES, device="cpu")
    data = make_corpus(np.random.default_rng(457), 200_000, "text")
    ours, theirs = bytearray(data), bytearray(data)
    size = P.compress_inplace(ours, block_sorter=C.BLOCKSORTER_ST4)
    assert size == japi.compress_inplace(theirs,
                                         block_sorter=C.BLOCKSORTER_ST4)
    assert ours == theirs
    assert P.block_info(bytes(ours[:C.HEADER_SIZE])) == (size, len(data))
    assert P.decompress_inplace(ours, size, len(data)) == len(data)
    assert bytes(ours) == data


def test_decompress_inplace_grows_a_short_buffer():
    P.init(FEATURES, device="cpu")
    data = make_corpus(np.random.default_rng(470), 50_000, "text")
    block = P.compress(data)
    buf = bytearray(block)
    assert P.decompress_inplace(buf, len(block), len(data)) == len(data)
    assert bytes(buf) == data
    with pytest.raises(P.BscError) as e:  # expected size too small
        P.decompress_inplace(bytearray(block), len(block), len(data) - 1)
    assert e.value.code == C.UNEXPECTED_EOB


def test_compress_inplace_not_compressible():
    P.init(FEATURES, device="cpu")
    noise = bytearray(np.random.default_rng(3).integers(
        0, 256, 100, np.uint8).tobytes())
    before = bytes(noise)
    with pytest.raises(P.BscError) as e:
        P.compress_inplace(noise)
    assert e.value.code == C.NOT_COMPRESSIBLE
    assert bytes(noise) == before  # untouched
    with pytest.raises(J.BscError) as e:
        japi.compress_inplace(bytearray(before))
    assert e.value.code == C.NOT_COMPRESSIBLE


def test_init_full_ignores_the_allocator_hooks():
    hooks = dict(malloc=lambda n: None, zero_malloc=lambda n: None,
                 free=lambda p: None)
    assert P.init_full(FEATURES, device="cpu", **hooks) == C.NO_ERROR
    assert J.init_full(FEATURES, **hooks) == C.NO_ERROR
    data = b"init_full " * 1000
    assert P.decompress(P.compress(data)) == data
    if not torch.cuda.is_available():
        with pytest.raises(P.BscError) as e:
            P.init_full(FEATURES | C.FEATURE_CUDA)  # device None: CUDA
        assert e.value.code == C.GPU_NOT_SUPPORTED
    P.init(FEATURES, device="cpu")


def _probe_blocks() -> dict:
    """4 MiB blocks: text whose repeats LZP shortens everywhere (the probe
    keeps LZP), and the same with noise in the probe's three 512 KiB
    windows (start, middle, end: the probe drops LZP)."""
    g = np.random.default_rng(123)
    n = 4 << 20
    unit = make_corpus(g, 20_000, "text")
    rep = np.frombuffer((unit * (n // len(unit) + 1))[:n], np.uint8).copy()
    noisy = rep.copy()
    win = 512 * 1024
    for off in (0, (n - win) // 2, n - win):
        noisy[off:off + win] = g.integers(0, 256, win, np.uint8)
    return {"repeats": rep.tobytes(), "noisy_windows": noisy.tobytes()}


@pytest.fixture(scope="module")
def probe_blocks():
    return _probe_blocks()


@pytest.mark.parametrize("name", ["repeats", "noisy_windows"])
def test_lzp_probe_archive_equals_jax(monkeypatch, probe_blocks, name):
    data = probe_blocks[name]
    japi.init(FEATURES)
    P.init(FEATURES, device="cpu")
    plain = P.compress(data)
    monkeypatch.setenv("TBSC_LZP_PROBE", "1")
    probed = P.compress(data)
    assert probed == japi.compress(data)
    lzp = (int.from_bytes(probed[8:12], "little") >> 8) & 0xFFFF
    assert (lzp != 0) == (name == "repeats")
    assert (probed == plain) == (name == "repeats")
    assert P.decompress(probed) == data


@pytest.fixture(scope="module")
def mib_block():
    """Text of 1 MiB + 99 bytes, coded without LZP, so the BWT's input
    reaches the device route's 1 MiB minimum."""
    return make_corpus(np.random.default_rng(182), (1 << 20) + 99, "text")


def test_device_bwt_route_writes_the_host_archive(monkeypatch, mib_block):
    """FEATURE_CUDA on a CPU device keeps the default config's BWT on the
    host, and so do features without it; under ``ops`` the BWT goes to
    ops/bwt.bwt_encode (device="cpu": its plain version), the route a
    CUDA device takes.  The archive is the host BWT's and the JAX
    package's."""
    from libbsc_tpu_torch import engine

    P.init(FEATURES | C.FEATURE_CUDA, device="cpu")
    count = engine.DEVICE_ROUTES["bwt_encode"]
    host = P.compress(mib_block, 0, 0)
    assert engine.DEVICE_ROUTES["bwt_encode"] == count
    assert P.compress(mib_block, 0, 0, features=FEATURES) == host  # no CUDA
    assert engine.DEVICE_ROUTES["bwt_encode"] == count
    monkeypatch.setattr(engine, "_force", "ops")
    dev = P.compress(mib_block, 0, 0)
    assert engine.DEVICE_ROUTES["bwt_encode"] == count + 1
    japi.init(FEATURES)
    assert dev == host == japi.compress(mib_block, 0, 0)
    assert P.decompress(dev) == mib_block


def test_device_bwt_failure_raises(monkeypatch, mib_block):
    """No silent host fallback: a device BWT that fails raises."""
    from libbsc_tpu_torch.ops import bwt

    def broken(data):
        raise RuntimeError("device sort failed")

    from libbsc_tpu_torch import engine

    monkeypatch.setattr(bwt, "bwt_encode", broken)
    monkeypatch.setattr(engine, "_force", "ops")
    P.init(FEATURES | C.FEATURE_CUDA, device="cpu")
    with pytest.raises(RuntimeError, match="device sort failed"):
        P.compress(mib_block, 0, 0)
