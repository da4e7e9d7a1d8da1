"""``api.compress`` / ``api.decompress`` of the port for every block sorter
(BWT, BWT_WIDEAUX, ST3-ST8) with the QLFC static, adaptive and fast
coders, on the CPU: each archive equals the JAX package's byte for byte,
and both packages decode it.  A 1 MiB ST5 block with ``FEATURE_CUDA``
takes the device-ST route (its plain version here) and still writes the
host archive."""

import numpy as np
import pytest
import torch

import libbsc_tpu_torch as P
from libbsc_tpu import api as japi
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine
from libbsc_tpu_torch.format.header import pack_block_header, pack_mode
from libbsc_tpu_torch.ops import st as pst
from libbsc_tpu_torch.parallel import make_mesh, make_transform_step, shard
from libbsc_tpu_torch.utils.adler32 import adler32
from tests.conftest import make_corpus

SORTERS = [C.BLOCKSORTER_BWT, C.BLOCKSORTER_BWT_WIDEAUX] + list(
    range(C.BLOCKSORTER_ST3, C.BLOCKSORTER_ST8 + 1))
CODERS = [C.CODER_QLFC_STATIC, C.CODER_QLFC_ADAPTIVE, C.CODER_QLFC_FAST]
FEATURES = C.FEATURE_FASTMODE


@pytest.fixture(scope="module")
def data():
    # over 64 KiB, so the BWT keeps its aux indexes in the tail
    return make_corpus(np.random.default_rng(77), 100_000, "text")


@pytest.mark.parametrize("coder", CODERS)
@pytest.mark.parametrize("sorter", SORTERS)
def test_archive_equals_jax_and_both_decode(data, sorter, coder):
    japi.init(FEATURES)
    P.init(FEATURES, device="cpu")
    blob = P.compress(data, block_sorter=sorter, coder=coder)
    assert blob == japi.compress(data, block_sorter=sorter, coder=coder)
    assert (blob[8] & 0x1F, (blob[8] >> 5) & 7) == (sorter, coder)
    assert P.decompress(blob) == data
    assert japi.decompress(blob) == data


@pytest.mark.parametrize("sorter", [C.BLOCKSORTER_BWT, C.BLOCKSORTER_ST4])
def test_without_lzp_and_incompressible(sorter):
    japi.init(FEATURES)
    P.init(FEATURES, device="cpu")
    text = make_corpus(np.random.default_rng(78), 30_000, "runs")
    blob = P.compress(text, 0, 0, block_sorter=sorter,
                      coder=C.CODER_QLFC_ADAPTIVE)
    assert blob == japi.compress(text, 0, 0, block_sorter=sorter,
                                 coder=C.CODER_QLFC_ADAPTIVE)
    assert P.decompress(blob) == text
    noise = np.random.default_rng(79).integers(0, 256, 5000, np.uint8)
    blob = P.compress(noise.tobytes(), block_sorter=sorter)
    assert blob == japi.compress(noise.tobytes(), block_sorter=sorter)
    assert P.decompress(blob) == noise.tobytes()


def test_device_st_route_writes_the_host_archive(monkeypatch):
    n = 1 << 20
    block = make_corpus(np.random.default_rng(80), n, "text")
    seen = []
    real = pst.st_encode

    def spy(data, k):
        seen.append((data.shape[0], k))
        return real(data, k)

    monkeypatch.setattr(pst, "st_encode", spy)
    kw = dict(lzp_hash_size=0, lzp_min_len=0,
              block_sorter=C.BLOCKSORTER_ST5, coder=C.CODER_QLFC_STATIC)
    P.init(FEATURES | C.FEATURE_CUDA, device="cpu")
    blob = P.compress(block, **kw)
    assert seen == [(n, 5)]
    assert P.decompress(blob) == block
    P.init(FEATURES, device="cpu")
    assert P.compress(block, **kw) == blob
    japi.init(FEATURES)
    assert japi.compress(block, **kw) == blob
    assert japi.decompress(blob) == block


@pytest.mark.parametrize("sorter", ["st", "bwt"])
def test_transform_step_archives_decode_through_the_port(sorter):
    """Blocks sorted by the transform step, coded by the native QLFC
    static coder and framed with no aux indexes (as the JAX package's
    multichip round trip does) come back through api.decompress."""
    n = 24 * 1024
    blocks = np.stack([np.frombuffer(
        make_corpus(np.random.default_rng(81 + i), n, "text"), np.uint8)
        for i in range(2)])
    mesh = make_mesh(2, dp=1, sp=2, devices=[torch.device("cpu")] * 2)
    out, idx, _ = make_transform_step(mesh, sorter=sorter, k=5)(
        shard(torch.from_numpy(blocks), mesh))
    out = torch.cat(out[0], 1).numpy()
    block_sorter = C.BLOCKSORTER_ST5 if sorter == "st" else C.BLOCKSORTER_BWT
    mode = pack_mode(block_sorter, C.CODER_QLFC_STATIC, 0, 0)
    P.init(FEATURES, device="cpu")
    japi.init(FEATURES)
    for b in range(2):
        payload = engine.coder_compress(out[b].copy(), C.CODER_QLFC_STATIC, 0)
        payload = bytes(payload) + bytes([0])  # num_indexes = 0
        raw = blocks[b].tobytes()
        block = pack_block_header(len(payload) + C.HEADER_SIZE, n, mode,
                                  int(idx[0][b]), adler32(raw),
                                  adler32(payload)) + payload
        assert P.decompress(block) == raw
        assert japi.decompress(block) == raw


def test_engine_coders_and_batch_st_decode():
    d = np.frombuffer(make_corpus(np.random.default_rng(82), 50_000, "text"),
                      np.uint8).copy()
    for coder in CODERS:
        payload = engine.coder_compress(d, coder, FEATURES)
        back = engine.coder_decompress(payload, coder, FEATURES,
                                       capacity=len(d) + 4096)
        np.testing.assert_array_equal(back, d)
    assert engine.coder_compress(
        np.random.default_rng(1).integers(0, 256, 3000, np.uint8),
        C.CODER_QLFC_STATIC, FEATURES) is None
    blocks = [d[:20_000].copy(), d[20_000:].copy()]
    sorted_, idxs = [], []
    for b in blocks:
        s = b.copy()
        idxs.append(engine.st_encode(s, 6, FEATURES))
        sorted_.append(s)
    for s, i, b in zip(sorted_, idxs, blocks):
        assert engine.st_decode(s, 6, i, FEATURES) == 0
        np.testing.assert_array_equal(s, b)
