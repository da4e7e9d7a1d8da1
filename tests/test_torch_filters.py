"""The port's filters (``libbsc_tpu_torch/filters``) against the JAX
package's on the same seeded inputs: the detectors' decisions exactly, the
preprocessing round trips, and the reference's decisions where its oracle
builds."""

import ctypes

import numpy as np
import pytest

from libbsc_tpu.filters import detectors as jdet
from libbsc_tpu.filters import preprocessing as jpre
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.filters import detectors, preprocessing, tables
from tests.conftest import make_corpus


def _corpora():
    """name -> bytes: every corpus kind at two sizes, heterogeneous mixes
    (segment boundaries), record-structured data (record sizes 2-4),
    reversed text and u32 counters."""
    g = np.random.default_rng(0xF17)
    out = {}
    for kind in ("text", "random", "runs", "zeros", "periodic"):
        out[f"{kind}_200k"] = make_corpus(g, 200_000, kind)
        out[f"{kind}_50k"] = make_corpus(g, 50_001, kind)
    out["text_random"] = (make_corpus(g, 120_000, "text")
                          + make_corpus(g, 130_000, "random"))
    out["zeros_text_runs"] = (make_corpus(g, 60_000, "zeros")
                              + make_corpus(g, 90_000, "text")
                              + make_corpus(g, 70_000, "runs"))
    out["random_zeros"] = (make_corpus(g, 30_000, "random")
                           + make_corpus(g, 200_000, "zeros"))
    for rs in (2, 3, 4):
        n = 150_000 - (150_000 % rs)
        rec = np.zeros(n, dtype=np.uint8)
        for k in range(rs):
            base = g.integers(0, 200)
            rec[k::rs] = (base + g.integers(0, 3, size=n // rs)).astype(
                np.uint8)
        out[f"records_{rs}"] = rec.tobytes()
    out["reversed_text"] = make_corpus(g, 180_000, "text")[::-1]
    out["reversed_twice"] = make_corpus(g, 90_000, "text")[::-1] * 2
    out["u32_be"] = np.arange(40_000, dtype=">u4").tobytes()
    out["u32_le"] = np.arange(40_000, dtype="<u4").tobytes()
    out["tiny"] = b"ab"
    return out


CORPORA = _corpora()


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_detectors_equal_the_jax_package(name):
    arr = np.frombuffer(CORPORA[name], dtype=np.uint8)
    assert detectors.detect_segments(arr) == jdet.detect_segments(arr)
    assert detectors.detect_contextsorder(arr) == \
        jdet.detect_contextsorder(arr)
    assert detectors.detect_recordsize(arr) == jdet.detect_recordsize(arr)


def test_detectors_decide_structured_inputs():
    """The decisions themselves, on inputs whose answer is known."""
    g = np.random.default_rng(4)
    n = 400_000  # 4 interleaved byte streams of very different statistics
    streams = [np.full(n // 4, 65, dtype=np.uint8),
               g.integers(0, 4, size=n // 4, dtype=np.uint8),
               np.arange(n // 4, dtype=np.int64).astype(np.uint8),
               np.full(n // 4, 200, dtype=np.uint8)]
    rec = np.stack(streams, axis=1).reshape(-1)
    assert detectors.detect_recordsize(rec) == 4
    text = np.frombuffer(CORPORA["text_200k"], dtype=np.uint8)
    assert detectors.detect_recordsize(text) == 1
    assert detectors.detect_segments(text) == [len(text)]
    mix = np.frombuffer(CORPORA["text_random"], dtype=np.uint8)
    segs = detectors.detect_segments(mix)
    assert sum(segs) == len(mix) and len(segs) >= 2
    assert abs(segs[0] - 120_000) < 20_000
    assert detectors.detect_contextsorder(text) in (C.CONTEXTS_FOLLOWING,
                                                    C.CONTEXTS_PRECEDING)


@pytest.mark.parametrize("rs", [1, 2, 3, 4, 7])
def test_reorder_roundtrip_equals_the_jax_package(rs):
    g = np.random.default_rng(rs)
    for n in (rs * 10 + 3, 100_000):
        data = g.integers(0, 256, size=n, dtype=np.uint8)
        ours, theirs = data.copy(), data.copy()
        preprocessing.reorder_forward(ours, rs)
        jpre.reorder_forward(theirs, rs)
        assert np.array_equal(ours, theirs)
        preprocessing.reorder_reverse(ours, rs)
        assert np.array_equal(ours, data)


def test_reverse_roundtrip():
    data = np.random.default_rng(3).integers(0, 256, size=999,
                                             dtype=np.uint8)
    arr = data.copy()
    preprocessing.reverse_block(arr)
    assert np.array_equal(arr, data[::-1])
    preprocessing.reverse_block(arr)
    assert np.array_equal(arr, data)


def test_entropy_tables_equal_the_jax_package():
    from libbsc_tpu.filters import tables as jtables

    assert np.array_equal(tables.code_table, jtables.code_table)
    assert np.array_equal(tables.delta_table, jtables.delta_table)
    n = np.array([0, 1, 2, 4095, 4096, 0xFFFFF, 0x100000, 0x10000000, 255,
                  0x1FF, 0x12345FF], dtype=np.int64)
    assert np.array_equal(tables.entropy(n), jtables.entropy(n))
    assert np.array_equal(tables.delta(n), jtables.delta(n))


def test_detectors_match_reference_decisions(oracle):
    segbuf = (ctypes.c_int * 256)()
    for name, blob in CORPORA.items():
        arr = np.frombuffer(blob, dtype=np.uint8)
        n = len(blob)
        nseg = oracle.o_detect_segments(blob, n, segbuf, 256, 0)
        assert nseg > 0
        assert detectors.detect_segments(arr) == list(segbuf[:nseg]), name
        assert detectors.detect_contextsorder(arr) == \
            oracle.o_detect_contextsorder(blob, n, 0), name
        assert detectors.detect_recordsize(arr) == \
            oracle.o_detect_recordsize(blob, n, 0), name
