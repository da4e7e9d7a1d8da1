"""The host buffer pool (``utils/bufpool.py``) and its wiring: growth
against the JAX package's pool, reuse, alignment and threads, ``out=`` on
the engine's four host stages, ``engine._tune_allocator``, and the API's
archives against the JAX package's with the pool in use.  On the CPU
(``device="cpu"``), where no slot is page-locked."""

import threading
import types

import numpy as np
import pytest
import torch

import libbsc_tpu_torch as P
from libbsc_tpu import api as japi
from libbsc_tpu.utils import bufpool as jbufpool
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine
from libbsc_tpu_torch.format.header import parse_block_header
from libbsc_tpu_torch.utils import bufpool
from tests.conftest import make_corpus

FEATURES = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING
HS, ML = C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN
MIB = 1 << 20


def _in_thread(fn):
    """fn() on a new thread, whose pool starts empty."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised below
            box["err"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive()
    if "err" in box:
        raise box["err"]
    return box["out"]


SEQUENCES = {
    "grow_and_shrink": [("a", 1000), ("a", 500_000), ("a", 900_000),
                        ("a", 1_300_000), ("a", 1_200_000), ("a", 10),
                        ("a", 2_000_000), ("a", 1_700_000)],
    "two_slots": [("a", 3 * MIB), ("b", 100), ("a", 3 * MIB + 1),
                  ("b", MIB + 1), ("a", 4 * MIB), ("b", MIB),
                  ("a", 3_900_000), ("b", 2 * MIB)],
    "block_stream": [("lz", n) for n in (26_215_424, 26_000_000, 26_215_424,
                                         30_000_000, 26_215_424)],
}


def _trace(get, capacity, seq):
    """(view length, slot capacity, reused the slot's last buffer) a get."""
    last, out = {}, []
    for slot, n in seq:
        view = get(slot, n)
        addr = view.ctypes.data
        out.append((len(view), capacity(slot), last.get(slot) == addr))
        last[slot] = addr
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_growth_matches_the_jax_pool(name):
    seq = SEQUENCES[name]
    ours = _in_thread(lambda: _trace(
        bufpool.get, lambda s: len(bufpool.slots()[(s, False)]), seq))
    ref = _in_thread(lambda: _trace(
        jbufpool.get, lambda s: len(jbufpool._tls.slots[s][1]), seq))
    assert ours == ref
    assert [r for _, _, r in ours].count(True) > 0


def test_a_slot_is_reused_while_it_fits_and_grows_when_not():
    def run():
        a = bufpool.get("x", 100_000)
        b = bufpool.get("x", MIB)  # within the 1 MiB minimum
        c = bufpool.get("x", MIB + 1)  # grows
        d = bufpool.get("x", 500)
        return [v.ctypes.data for v in (a, b, c, d)], \
            len(bufpool.slots()[("x", False)])

    (a, b, c, d), cap = _in_thread(run)
    assert a == b and c != a and d == c
    assert cap == (MIB + 1) + (MIB + 1) // 4


@pytest.mark.parametrize("n", [1, 4096, MIB - 3, 3 * MIB + 7])
def test_views_are_aligned_contiguous_and_pass_as_c_without_a_copy(n):
    def run():
        view = bufpool.get("align", n)
        return view, engine._as_c(view)

    view, c = _in_thread(run)
    assert view.ctypes.data % (2 << 20) == 0
    assert view.flags["C_CONTIGUOUS"] and view.dtype == np.uint8
    assert len(view) == n
    assert c is view


def test_two_threads_get_two_buffers_for_one_slot():
    barrier = threading.Barrier(2, timeout=60)

    def run():
        view = bufpool.get("shared", 2 * MIB)
        view[:] = threading.get_ident() & 0xFF
        barrier.wait()  # both threads hold their views at once
        return view.ctypes.data, view.copy()

    out = {}
    ths = [threading.Thread(target=lambda i=i: out.__setitem__(i, run()))
           for i in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
        assert not th.is_alive()
    (a, va), (b, vb) = out[0], out[1]
    assert a != b
    assert len(np.unique(va)) == 1 and len(np.unique(vb)) == 1


def test_a_pinned_slot_is_a_buffer_of_its_own(monkeypatch):
    """pinned=True keys another buffer; on the CPU its allocation is
    replaced here, since torch has no page-locked allocator there."""
    made = []

    def fake_pinned(cap):
        raw = np.empty(cap, np.uint8)
        made.append(cap)
        return raw, raw

    monkeypatch.setattr(bufpool, "_alloc_pinned", fake_pinned)

    def run():
        a = bufpool.get("lz", 5000)
        b = bufpool.get("lz", 5000, pinned=True)
        c = bufpool.get("lz", 5000, pinned=True)
        return a.ctypes.data, b.ctypes.data, c.ctypes.data, \
            sorted(bufpool.slots())

    a, b, c, keys = _in_thread(run)
    assert a != b and b == c and made == [MIB]
    assert keys == [("lz", False), ("lz", True)]


def test_pinning_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: pinning works")
    with pytest.raises(RuntimeError):
        _in_thread(lambda: bufpool.get("lz", 5000, pinned=True))


# -- out= on the engine's host stages ----------------------------------------

CODERS = [C.CODER_QLFC_STATIC, C.CODER_QLFC_ADAPTIVE, C.CODER_QLFC_FAST]


def _repeats(seed: int, n: int) -> np.ndarray:
    """n bytes of text that repeats every n / 5 bytes: LZP pays."""
    text = make_corpus(np.random.default_rng(seed), n // 5)
    return np.frombuffer((text * 6)[:n], np.uint8)


@pytest.fixture(scope="module")
def inputs():
    P.init(FEATURES, device="cpu")
    data = _repeats(13, 40_000)
    lz = engine.lzp_compress(data, HS, ML, FEATURES).copy()
    coded = {c: engine.coder_compress(data, c, FEATURES).copy()
             for c in CODERS}
    return data, lz, coded


def _stage_call(name: str, inputs, out):
    """(the stage's result with ``out``, the bytes ``out`` must hold)."""
    data, lz, coded = inputs
    n = len(data)
    if name == "lzp_compress":
        return engine.lzp_compress(data, HS, ML, FEATURES, out=out), n + 1024
    if name == "lzp_decompress":
        return engine.lzp_decompress(lz, HS, ML, FEATURES, capacity=n + 4096,
                                     out=out), n + 4096
    kind, coder = name.rsplit("_", 1)
    if kind == "coder_compress":
        return engine.coder_compress(data, int(coder), FEATURES,
                                     out=out), n + 4096
    return engine.coder_decompress(coded[int(coder)], int(coder), FEATURES,
                                   capacity=n + 4096, out=out), n + 4096


STAGES = ["lzp_compress", "lzp_decompress"] + [
    f"{k}_{c}" for k in ("coder_compress", "coder_decompress")
    for c in CODERS]


@pytest.mark.parametrize("name", STAGES)
def test_out_gives_what_no_out_gives(inputs, name):
    want, need = _stage_call(name, inputs, None)
    out = np.full(need, 0xA5, np.uint8)
    got, _ = _stage_call(name, inputs, out)
    assert np.array_equal(got, want)
    assert got.ctypes.data == out.ctypes.data  # written into out
    if name == "lzp_decompress" or name.startswith("coder_decompress"):
        assert np.array_equal(got, inputs[0])


@pytest.mark.parametrize("name", STAGES)
def test_a_too_small_out_is_replaced_not_overrun(inputs, name):
    want, need = _stage_call(name, inputs, None)
    out = np.full(need, 0xA5, np.uint8)
    got, _ = _stage_call(name, inputs, out[:need - 1])
    assert np.array_equal(got, want)
    assert not np.shares_memory(got, out)
    assert (out == 0xA5).all()


@pytest.mark.parametrize("name", ["lzp_compress", "lzp_decompress",
                                  "coder_compress_3", "coder_decompress_3"])
def test_the_numpy_engine_ignores_out(monkeypatch, name):
    data = _repeats(14, 4000)
    P.init(FEATURES, device="cpu")
    small = (data, engine.lzp_compress(data, HS, ML, FEATURES).copy(),
             {3: engine.coder_compress(data, 3, FEATURES).copy()})
    monkeypatch.setattr(engine, "_force", "numpy")
    want, need = _stage_call(name, small, None)
    out = np.full(need, 0xA5, np.uint8)
    got, _ = _stage_call(name, small, out)
    assert np.array_equal(got, want)
    assert (out == 0xA5).all()


# -- _tune_allocator ----------------------------------------------------------

def test_tune_allocator_runs_once_from_init(monkeypatch):
    calls = []

    class Libc:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    def cdll(name, use_errno=False):
        calls.append(name)
        return Libc()

    monkeypatch.setattr(engine, "ctypes", types.SimpleNamespace(CDLL=cdll))
    monkeypatch.setattr(engine, "_mallopt_done", False)
    engine.init("cpu")
    engine.init("cpu")
    assert calls == ["libc.so.6", (-4, 0), (-1, 2**31 - 1)]


def test_tune_allocator_raises_nothing_without_libc(monkeypatch):
    def cdll(name, use_errno=False):
        raise OSError("no libc here")

    monkeypatch.setattr(engine, "ctypes", types.SimpleNamespace(CDLL=cdll))
    monkeypatch.setattr(engine, "_mallopt_done", False)
    engine.init("cpu")
    assert engine._mallopt_done


# -- the API with the pool ----------------------------------------------------

CONFIGS = {
    "m0_e1_lzp": dict(block_sorter=C.BLOCKSORTER_BWT,
                      coder=C.CODER_QLFC_STATIC),
    "m5_e0": dict(block_sorter=C.BLOCKSORTER_ST5, coder=C.CODER_QLFC_FAST),
    "m9_e4": dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                  coder=C.CODER_QLFC_WIDE),
}
# about 40 KB, growing and shrinking; LZP pays on some, not on the random
# (stored) and periodic ones
RUN = [(38_000, "text"), (44_000, "runs"), (52_000, "text"),
       (41_000, "random"), (30_000, "periodic"), (47_000, "text"),
       (36_000, "runs")]


@pytest.fixture(scope="module")
def run_blocks():
    g = np.random.default_rng(4040)
    return [make_corpus(g, n, kind) for n, kind in RUN]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_archives_equal_the_jax_package_and_come_back(run_blocks, config):
    kw = CONFIGS[config]
    japi.init(FEATURES)
    P.init(FEATURES, device="cpu")
    blobs = [P.compress(d, **kw) for d in run_blocks]
    assert blobs == [japi.compress(d, **kw) for d in run_blocks]
    back = [P.decompress(b) for b in blobs]
    assert all(type(b) is bytes for b in blobs + back)
    assert back == run_blocks


def test_the_api_uses_the_jax_package_slots(run_blocks):
    """compress: "compress_lz" and "compress_coder"; decompress:
    "decompress_lz" and "decompress_out"; decompress_batch: none."""
    P.init(FEATURES, device="cpu")
    data = run_blocks[4]  # periodic: LZP pays

    def slots_after(fn):
        return _in_thread(lambda: (fn(), sorted(bufpool.slots()))[1])

    blob = P.compress(data)
    assert parse_block_header(blob).mode >> 8  # the mode records LZP
    assert slots_after(lambda: P.compress(data)) == [
        ("compress_coder", False), ("compress_lz", False)]
    assert slots_after(lambda: P.decompress(blob)) == [
        ("decompress_lz", False), ("decompress_out", False)]
    assert slots_after(lambda: P.decompress_batch([blob, blob])) == []


def test_a_result_is_no_view_of_a_slot(run_blocks):
    P.init(FEATURES, device="cpu")
    a, b = run_blocks[0], run_blocks[2]
    blob_a, blob_b = P.compress(a), P.compress(b)
    first = P.decompress(blob_a)
    kept = bytes(bytearray(first))
    assert P.decompress(blob_b) == b
    assert first == kept == a
    assert P.compress(a) == blob_a and blob_b == P.compress(b)


def test_decompress_batch_returns_each_block(run_blocks):
    P.init(FEATURES, device="cpu")
    blobs = [P.compress(d, **CONFIGS[c])
             for d, c in zip(run_blocks, sorted(CONFIGS) * 3)]
    assert P.decompress_batch(blobs) == run_blocks
    assert [P.decompress(b) for b in blobs] == run_blocks


def test_the_fused_decode_writes_the_scratch_slot(monkeypatch):
    """-m9 -e4 with FEATURE_CUDA on device="cpu" takes the fused route
    (plain kernel versions): decompress decodes into the "decompress_lz"
    slot (pageable: the device is no CUDA device), and
    engine.decompress_block_device's out= gives what a fresh buffer
    gives."""
    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")  # 1024 lanes at 1.5 MiB
    data = make_corpus(np.random.default_rng(1537), 3 << 19)
    P.init(FEATURES | C.FEATURE_CUDA, device="cpu")
    calls = []
    fused = engine.decompress_block_device

    def spy(*args, out=None):
        calls.append(out is not None)
        return fused(*args, out=out)

    blob = P.compress(data, **CONFIGS["m9_e4"])
    monkeypatch.setattr(engine, "decompress_block_device", spy)
    back, slots = _in_thread(lambda: (P.decompress(blob), bufpool.slots()))
    assert back == data and calls == [True]
    assert ("decompress_lz", False) in slots
    assert P.decompress_batch([blob]) == [data] and calls == [True, False]
    monkeypatch.setattr(engine, "decompress_block_device", fused)
    assert P.decompress(blob) == data
