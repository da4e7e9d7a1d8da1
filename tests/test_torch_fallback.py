"""The no-native engine's stages (``libbsc_tpu_torch/fallback/``) against
the JAX package's fallback and both packages' native runtimes: each cell
of tests/test_fallback.py, port against JAX and native."""

import numpy as np
import pytest
import torch

import libbsc_tpu as J
from libbsc_tpu.fallback import bwt as jbwt, lzp as jlzp, qlfc as jqlfc, \
    st as jst
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch.fallback import bwt as fbwt, lzp as flzp, \
    qlfc as fqlfc, st as fst
from tests.conftest import make_corpus

CPU = torch.device("cpu")
ST_CELLS = [(n, kind, k) for kind in ("text", "random", "runs")
            for n in (17, 255, 30000) for k in (3, 5, 8)]


def _block(n: int, kind: str, salt: int = 0) -> np.ndarray:
    g = np.random.default_rng(n * 11 + salt + len(kind))
    return np.frombuffer(make_corpus(g, n, kind), np.uint8).copy()


@pytest.fixture(scope="module", autouse=True)
def _init():
    J.init()
    pengine.init(CPU)


@pytest.fixture(scope="module")
def jax_st():
    """The JAX fallback's forward ST of every cell, one call each."""
    out = {}
    for n, kind, k in ST_CELLS:
        buf = _block(n, kind)
        idx = jst.st_encode(buf, k)
        out[n, kind, k] = (buf, idx)
    return out


@pytest.mark.parametrize("n,kind,k", ST_CELLS)
def test_fallback_st_roundtrip(n, kind, k, jax_st):
    d = _block(n, kind)
    buf = d.copy()
    idx = fst.st_encode(buf, k, CPU)
    ref = d.copy()
    ref_idx = pengine.st_encode(ref, k, 0)
    jbuf, jidx = jax_st[n, kind, k]
    assert np.array_equal(buf, ref) and np.array_equal(buf, jbuf)
    assert idx == ref_idx == jidx
    jback = buf.copy()
    assert jst.st_decode(jback, k, idx) == 0
    assert fst.st_decode(buf, k, idx) == 0
    assert np.array_equal(buf, d) and np.array_equal(jback, d)


@pytest.mark.parametrize("n", [255, 30000])
def test_fallback_bwt_roundtrip(n):
    d = _block(n, "text")
    buf = d.copy()
    p, ni, aux = fbwt.bwt_encode(buf, CPU)
    ref = d.copy()
    rp, rni, raux = pengine.bwt_encode(ref, 0)
    jbuf = d.copy()
    jp, jni, jaux = jbwt.bwt_encode(jbuf)
    assert np.array_equal(buf, ref) and np.array_equal(buf, jbuf)
    assert (p, ni) == (rp, rni) == (jp, jni)
    if ni:
        assert np.array_equal(aux, raux[:ni]) and np.array_equal(aux, jaux)
    jback = buf.copy()
    assert jbwt.bwt_decode(jback, p, ni, aux) == 0
    assert fbwt.bwt_decode(buf, p, ni, aux, CPU) == 0
    assert np.array_equal(buf, d) and np.array_equal(jback, d)


@pytest.mark.parametrize("index", [0, 256])
def test_fallback_bwt_bad_primary_is_refused_as_in_jax(index):
    buf = _block(255, "text")
    want = jbwt.bwt_decode(buf.copy(), index, 0, None)
    assert fbwt.bwt_decode(buf, index, 0, None, CPU) == want == -1


@pytest.mark.parametrize("kind", ["text", "periodic"])
@pytest.mark.parametrize("n", [5000, 300000])
def test_fallback_lzp_matches_native(n, kind):
    d = _block(n, kind)
    mine = flzp.lzp_compress(d.copy(), 15, 32)
    ref = pengine.lzp_compress(d.copy(), 15, 32, 0)
    theirs = jlzp.lzp_compress(d.copy(), 15, 32)
    assert (mine is None) == (ref is None) == (theirs is None)
    if mine is not None:
        assert np.array_equal(mine, ref) and np.array_equal(mine, theirs)
        assert np.array_equal(flzp.lzp_decompress(mine, 15, 32), d)


@pytest.mark.parametrize("coder", [C.CODER_QLFC_STATIC, C.CODER_QLFC_ADAPTIVE,
                                   C.CODER_QLFC_FAST])
def test_fallback_qlfc_matches_native(coder):
    d = _block(50000, "text")
    buf = d.copy()
    pengine.bwt_encode(buf, 0)
    mine = fqlfc.coder_compress(buf, coder)
    ref = pengine.coder_compress(buf, coder, 0)
    theirs = jqlfc.coder_compress(buf, coder)
    assert (mine is None) == (ref is None) == (theirs is None)
    if mine is not None:
        assert np.array_equal(mine, ref) and np.array_equal(mine, theirs)
        assert np.array_equal(fqlfc.coder_decompress(mine, coder), buf)



@pytest.mark.parametrize("n", [0, 1, 262_143, 262_144, 4 << 20, 16 << 20])
def test_subblock_directory_equals_jax(n):
    from libbsc_tpu.format import subblocks as jsub
    from libbsc_tpu_torch.format import subblocks as psub

    k = psub.num_sub_blocks(n)
    assert k == jsub.num_sub_blocks(n)
    raw = [n // k + i for i in range(k)]
    packed = [r // 2 + 1 for r in raw]
    d = psub.write_directory(raw, packed)
    assert d == jsub.write_directory(raw, packed)
    got = psub.read_directory(d + b"payload")
    assert got == jsub.read_directory(d + b"payload")
    assert got[0] == k and got[2] == (1 if k == 1 else 1 + 8 * k)
