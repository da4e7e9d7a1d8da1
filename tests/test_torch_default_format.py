"""bsc's default format (``-m0 -e1``: the BWT and the static QLFC coder)
against the benchmark's exact reference (``portbench/ref/block_default``,
``ref/qlfc``): the reference's C loops against its frozen Python spec;
the port's native static coder against the reference's coder at 1, 2, 4
and 8 segments, stored segments among them; ``api.compress`` on
``device="cpu"`` against ``block_default.expected_many`` where LZP pays,
where the screen skips it, where the block is stored and under 64 KiB;
and the per-stage route's spans: the BWT's route tag and copies (the
screen's copy of the block reused, not made again), the coder's bytes
out, segments and threads, the inverse BWT's route and aux indexes."""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from libbsc_tpu_torch import api, engine
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.ops import bwt as opsbwt
from libbsc_tpu_torch.utils import trace
from portbench.ref import block_default, qlfc

REPO = Path(__file__).resolve().parent.parent
SEED = 3_200_000_101
CFG = {"lzp": [C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN],
       "switches": ["-b25", "-G"]}
FEATURES = C.FEATURE_MULTITHREADING | C.FEATURE_CUDA


def zipf_text(n: int, seed: int = SEED) -> np.ndarray:
    """The benchmark's text traffic (portbench/gen/text.py) on the CPU."""
    from portbench.gen import text

    params = json.loads((REPO / "portbench" / "traffic" / "text_1blk.json")
                        .read_text())["params"]
    return text.make(params, seed, 0, n).numpy()


def runs(n: int, seed: int = SEED) -> np.ndarray:
    """Runs of 1-63 bytes over a 4-symbol alphabet: a BWT output's kind
    of input, few runs a byte."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 64, n // 16 + 1)
    syms = rng.integers(0, 4, len(lens)).astype(np.uint8)
    return np.repeat(syms, lens)[:n]


def random_bytes(n: int, seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def phrases(n: int, seed: int = SEED) -> np.ndarray:
    """Log lines over and over, each longer than LZP's minimum: LZP
    pays."""
    rng = np.random.default_rng(seed)
    lines = [b"%d service=api level=info request handled path=/v1/items/%d "
             b"status=200 bytes=%d elapsed_ms=%d user_agent=client/1.%d\n"
             % (i, 1000 + i, 4096 * i, 7 * i, i) * 2 for i in range(8)]
    out = bytearray()
    while len(out) < n:
        out += lines[rng.integers(0, len(lines))]
    return np.frombuffer(bytes(out[:n]), dtype=np.uint8)


# -- the reference's C loops against its Python spec ------------------------

INPUTS = {"random": random_bytes, "text": zipf_text, "runs": runs}


@pytest.mark.parametrize("kind,n", [
    ("random", 1), ("random", 2), ("random", 300), ("random", 16_384),
    ("text", 29), ("text", 4_096), ("text", 131_072),
    ("runs", 1), ("runs", 65_536), ("runs", 1 << 20)])
def test_c_loops_equal_the_spec(kind, n):
    data = INPUTS[kind](n).tobytes()
    # a budget the code fits; random input also at and under its size,
    # which its code passes (None)
    budgets = (2 * n + 64, n, n - 1) if kind == "random" else (2 * n + 64,)
    for osize in budgets:
        assert qlfc.encode(data, osize) == qlfc.encode_spec(data, osize)


def test_c_loops_stop_at_the_budget():
    data = random_bytes(4_096).tobytes()
    assert qlfc.encode(data, 4_095) is None
    assert len(qlfc.encode(data, 1 << 20)) >= 4_096


# -- the port's native static coder against the reference's ----------------

def runs_then_random(n: int) -> np.ndarray:
    """Runs, then random bytes in the second half: the coder's cuts,
    which follow sampled rank changes, fall in the random half, so some
    segments there are stored."""
    data = runs(n)
    data[n // 2:] = random_bytes(n - n // 2)
    return data


def directory(payload: bytes):
    """[(raw size, coded size)] of a coder payload's segments."""
    k = payload[0]
    if k == 1:
        return [(None, len(payload) - 1)]
    return [tuple(np.frombuffer(payload, "<i4", 2, 1 + 8 * b))
            for b in range(k)]


@pytest.mark.parametrize("k,n", [(1, 200_000), (2, 1 << 20),
                                 (4, 5 << 20), (8, 17 << 20)])
def test_native_coder_equals_the_reference(k, n):
    api.init(C.FEATURE_MULTITHREADING, device="cpu")
    data = runs_then_random(n)
    with ThreadPoolExecutor(max_workers=8) as pool:
        want = block_default.Coder(data, pool).result()
    assert want is not None and want[0] == k
    if k > 1:
        assert any(raw == coded for raw, coded in directory(want)), \
            "no stored segment"
    for features in (C.FEATURE_MULTITHREADING, C.FEATURE_NONE):
        got = engine.coder_compress(data, C.CODER_QLFC_STATIC, features)
        assert got.tobytes() == want
    assert engine.coder_segments(n) == k == block_default.segments_of(n)


def test_native_coder_rejects_what_the_reference_rejects():
    api.init(C.FEATURE_MULTITHREADING, device="cpu")
    data = random_bytes(300_000)
    with ThreadPoolExecutor(max_workers=2) as pool:
        assert block_default.Coder(data, pool).result() is None
    assert engine.coder_compress(data, C.CODER_QLFC_STATIC,
                                 C.FEATURE_MULTITHREADING) is None


# -- api.compress against the reference's blocks ----------------------------

BLOCKS = {
    "lzp_pays": lambda: phrases(1_500_000),
    "screen_skips": lambda: zipf_text(1_200_000),
    "stored": lambda: random_bytes(1 << 20),
    "under_64k": lambda: zipf_text(50_000),
}


@pytest.fixture
def device_bwt(monkeypatch):
    """The route a -G device worker's block takes on a CUDA device: the
    BWT and its inverse of a block of 1 MiB or more on the API's device,
    here under ``ops`` (the CPU's plain versions)."""
    monkeypatch.setattr(engine, "_force", "ops")
    api.init(FEATURES, device="cpu")


def _compress(data: np.ndarray, **kw) -> bytes:
    kw.setdefault("lzp_hash_size", C.DEFAULT_LZPHASHSIZE)
    kw.setdefault("lzp_min_len", C.DEFAULT_LZPMINLEN)
    return api.compress(data.tobytes(), block_sorter=C.BLOCKSORTER_BWT,
                        coder=C.CODER_QLFC_STATIC, features=FEATURES, **kw)


def test_reference_equals_api_compress(device_bwt):
    items = [(make(), None) for make in BLOCKS.values()]
    got = [_compress(data) for data, _ in items]
    want = block_default.expected_many(items, CFG, "cpu")
    for name, g, w in zip(BLOCKS, got, want):
        assert g == w, name
    modes = {name: int.from_bytes(g[8:12], "little")
             for name, g in zip(BLOCKS, got)}
    assert modes["lzp_pays"] >> 8, "LZP kept"
    assert modes["screen_skips"] == C.BLOCKSORTER_BWT | C.CODER_QLFC_STATIC << 5
    assert modes["stored"] == 0
    assert got[-1][-1] == 0, "a block under 64 KiB carries no aux index"
    assert got[1][-1] > 0, "a block of 64 KiB or more carries aux indexes"
    # the archive round-trips through the port's decoder
    for (data, _), g in zip(items, got):
        assert api.decompress(g) == data.tobytes()


def test_reference_sees_a_flipped_bit(device_bwt):
    data = zipf_text(300_000)
    got = bytearray(_compress(data))
    got[len(got) // 2] ^= 1
    assert block_default.encode(data, CFG, "cpu") != bytes(got)


# -- the per-stage route's spans --------------------------------------------

def _profiled(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


@pytest.mark.parametrize("lzp", [True, False])
def test_bwt_spans_and_uploads(device_bwt, monkeypatch, lzp):
    """With LZP on, the screen's copy of the block goes to the device BWT
    as it is: one upload (the screen's), no bwt.upload span; with LZP
    off there is no screen, and the BWT makes the one upload."""
    screened, sorted_ = [], []
    screen, sort = engine.lzp_screen, opsbwt.bwt_encode

    def spy_screen(*a):
        out = screen(*a)
        screened.append(out[0])
        return out

    def spy_sort(block_d):
        sorted_.append(block_d)
        return sort(block_d)

    monkeypatch.setattr(engine, "lzp_screen", spy_screen)
    monkeypatch.setattr(opsbwt, "bwt_encode", spy_sort)
    data = zipf_text(1_200_000)
    kw = {} if lzp else {"lzp_hash_size": 0, "lzp_min_len": 0}
    blob = _profiled(lambda: _compress(data, **kw))
    rec = trace.spans()
    [bwt] = [s for s in rec if s.name == "bwt_encode"]
    assert bwt.tag == "device" and bwt.nbytes == len(data)
    kids = {s.name: s for s in rec if s.parent == bwt.id}
    assert set(kids) == ({"bwt.download"} if lzp
                         else {"bwt.upload", "bwt.download"})
    uploads = len(screened) + ("bwt.upload" in kids)
    assert uploads == 1 and len(sorted_) == 1
    if lzp:
        assert sorted_[0] is screened[0]
    [coder] = [s for s in rec if s.name == "coder_compress"]
    assert coder.out == len(blob) - 28 - (1 + 4 * blob[-1])
    assert coder.tag == (f"2 segments, {engine.num_threads(FEATURES)} "
                         "threads")


def test_host_bwt_span_tag():
    """On a CPU device (as without FEATURE_CUDA: the farm's host worker)
    the BWT runs on the native runtime: tag host, no copy spans."""
    api.init(FEATURES, device="cpu")
    _profiled(lambda: _compress(zipf_text(1_200_000)))
    rec = trace.spans()
    [bwt] = [s for s in rec if s.name == "bwt_encode"]
    assert bwt.tag == "host"
    assert not [s for s in rec if s.parent == bwt.id]


def test_decode_spans():
    """On a CPU device the inverse runs on the native runtime: tag host,
    the block's aux indexes, one thread."""
    api.init(FEATURES, device="cpu")
    data = zipf_text(1_200_000)
    blob = _compress(data)
    out = _profiled(lambda: api.decompress(blob))
    assert out == data.tobytes()
    rec = trace.spans()
    threads = engine.num_threads(FEATURES)
    [coder] = [s for s in rec if s.name == "coder_decompress"]
    assert coder.out == len(data)
    assert coder.tag == f"2 segments, {threads} threads"
    [unbwt] = [s for s in rec if s.name == "bwt_decode"]
    assert unbwt.tag == f"host, {blob[-1]} aux, 1 threads"
    assert blob[-1] == (len(data) - 1) // opsbwt.aux_rate(len(data))


def test_spans_off_record_nothing(device_bwt):
    before = trace.spans()
    _compress(zipf_text(1_200_000))
    assert trace.spans() == before
