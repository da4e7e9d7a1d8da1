"""Engine selection (``TBSC_ENGINE``, ``engine._force``): the ``ops``
engine on ``device="cpu"`` against the JAX package under the same engine,
on a 1,052,897-byte block (over the 1 MiB device minimum); the ``tpu``
and ``numpy`` routes; and no silent host retry after a device failure."""

import numpy as np
import pytest
import torch

import libbsc_tpu as J
import libbsc_tpu_torch as P
from libbsc_tpu import engine as jengine
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch.ops import bwt as pbwt
from libbsc_tpu_torch.ops import unbwt_rulers
from tests.conftest import make_corpus

BIG = 1_052_897
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    d = make_corpus(np.random.default_rng(1052), BIG, "text")
    # the block the sorter sees (LZP'd, or whole when LZP gains nothing)
    # stays over the device minimum, so the device routes are taken
    lz = pengine.lzp_compress(np.frombuffer(d, np.uint8),
                              C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN, 0)
    assert lz is None or len(lz) >= 1 << 20
    return d


@pytest.fixture(scope="module")
def jax_ops_archives(data):
    """The JAX package's archives under engine._force = "ops" (its device
    BWT and ST on the CPU backend), one compress each."""
    mp = pytest.MonkeyPatch()
    try:
        J.init()
        mp.setattr(jengine, "_force", "ops")
        mp.setattr(jengine, "_device", None)
        return {"default": J.compress(data),
                "m5": J.compress(data, block_sorter=C.BLOCKSORTER_ST5)}
    finally:
        mp.undo()


@pytest.fixture(autouse=True)
def _init():
    P.init(C.DEFAULT_FEATURES, device="cpu")


@pytest.mark.parametrize("config", ["default", "m5"])
def test_ops_archive_equals_jax_ops_archive(data, jax_ops_archives, config,
                                            monkeypatch):
    kw = {} if config == "default" else {"block_sorter": C.BLOCKSORTER_ST5}
    monkeypatch.setattr(pengine, "_force", "ops")
    before = dict(pengine.DEVICE_ROUTES)
    archive = P.compress(data, **kw)
    assert archive == jax_ops_archives[config]
    back = P.decompress(archive)
    assert back == data
    counted = {k: pengine.DEVICE_ROUTES[k] - before[k]
               for k in pengine.DEVICE_ROUTES}
    if config == "default":  # the device BWT both ways
        assert counted == {"bwt_encode": 1, "bwt_encode_dc3": 0,
                           "bwt_decode": 1, "st_encode": 0}
    else:  # the device ST; the inverse ST is a host chase
        assert counted == {"bwt_encode": 0, "bwt_encode_dc3": 0,
                           "bwt_decode": 0, "st_encode": 1}


def test_ops_wide_archive_equals_the_feature_cuda_archive(data, monkeypatch):
    """-m9 -e4 under ``ops``.  The JAX package's fused route fails on its
    Mosaic kernels on the CPU and takes the per-stage route (native lane
    table), while the port's runs the kernels' plain versions on the fused
    route (device lane table), so the two packages' archives differ here.
    The port's ``ops`` archive is held against its own FEATURE_CUDA
    archive instead (the same route), and must round-trip."""
    kw = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
              coder=C.CODER_QLFC_WIDE)
    want = P.compress(data, features=C.DEFAULT_FEATURES | C.FEATURE_CUDA,
                      **kw)
    monkeypatch.setattr(pengine, "_force", "ops")
    archive = P.compress(data, **kw)
    assert archive == want
    assert P.decompress(archive) == data


def test_a_device_failure_under_ops_raises(data, monkeypatch):
    archive = P.compress(data)  # the native engine

    def broken(*args, **kwargs):
        raise RuntimeError("device failure")

    monkeypatch.setattr(pengine, "_force", "ops")
    monkeypatch.setattr(unbwt_rulers, "unbwt", broken)  # the inverse, K16
    with pytest.raises(RuntimeError, match="device failure"):
        P.decompress(archive)
    monkeypatch.setattr(pbwt, "bwt_encode", broken)
    with pytest.raises(RuntimeError, match="device failure"):
        P.compress(data)


@pytest.mark.parametrize("force,features,want", [
    (None, 0, None), (None, C.FEATURE_CUDA, "dev"),
    ("native", C.FEATURE_CUDA, "dev"), ("ops", 0, "dev"),
    ("tpu", C.FEATURE_CUDA, None), ("numpy", C.FEATURE_CUDA, None)])
def test_device_route_on_the_cpu(force, features, want, monkeypatch):
    """``ops`` takes every device route on any device; ``tpu`` needs CUDA
    (on the CPU every stage runs on the host, as in the JAX package);
    ``numpy`` takes none."""
    monkeypatch.setattr(pengine, "_force", force)
    got = pengine.device_route(features, CPU)
    assert got == (CPU if want else None)


def test_tpu_on_the_cpu_writes_the_host_archive(data, monkeypatch):
    host = P.compress(data)
    monkeypatch.setattr(pengine, "_force", "tpu")
    P.init(C.DEFAULT_FEATURES | C.FEATURE_CUDA, device="cpu")
    before = dict(pengine.DEVICE_ROUTES)
    assert P.compress(data) == host
    assert P.decompress(host) == data
    assert pengine.DEVICE_ROUTES == before
