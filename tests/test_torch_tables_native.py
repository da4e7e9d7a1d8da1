"""The port's own copies of the format tables and of the native runtime
agree with the JAX package's."""

import numpy as np
import pytest

import libbsc_tpu_torch as P
from libbsc_tpu import api as japi
from libbsc_tpu import engine as jengine
from libbsc_tpu import native as jnative
from libbsc_tpu.ops import wide as jwide
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch import tables
from libbsc_tpu_torch.ops import wide as pwide
from tests.conftest import make_corpus

KINDS = ["text", "random", "runs", "zeros", "periodic"]


def _jax_tables():
    tdir = jnative._DIR.parent / "coder" / "tables"
    return {name: np.load(tdir / f"{name}.npy") for name in tables.NAMES}


def test_load_tables_installs_the_jax_package_tables():
    ref = _jax_tables()
    own = tables.defaults()
    for name in tables.NAMES:
        assert np.array_equal(own[name], ref[name]), name
        assert own[name].dtype == ref[name].dtype, name
    P.load_tables(ref)
    try:
        for name in tables.NAMES:
            assert np.array_equal(tables.current()[name], ref[name])
        assert np.array_equal(pwide.priors(), jwide.priors())
        d = make_corpus(np.random.default_rng(3), 50_000, "runs")
        assert pwide.wide_encode(d, n_lanes=64) == \
            jwide.wide_encode(d, n_lanes=64)
    finally:
        P.load_tables()


def test_load_tables_rejects_bad_priors():
    bad = tables.defaults()
    bad["wide_priors_v2"] = np.zeros(281, np.int16)
    with pytest.raises(ValueError):
        P.load_tables(bad)


@pytest.mark.parametrize("kind", KINDS)
def test_native_copy_gives_the_jax_package_bytes(kind):
    japi.init()
    g = np.random.default_rng(KINDS.index(kind) + 100)
    data = np.frombuffer(make_corpus(g, 120_000, kind), np.uint8).copy()

    lz_p = pengine.lzp_compress(data, 15, 16, 0)
    lz_j = jengine.lzp_compress(data, 15, 16, 0)
    assert (lz_p is None) == (lz_j is None)
    if lz_p is not None:
        assert np.array_equal(lz_p, lz_j)
        back = pengine.lzp_decompress(lz_p, 15, 16, 0, len(data) + 4096)
        assert np.array_equal(back, data)

    up, uj = data.copy(), data.copy()
    rp = pengine.bwt_encode_wideaux(up)
    rj = jengine.bwt_encode_wideaux(uj, 0)
    assert rp[0] == rj[0] and rp[1] == rj[1] and rp[3] == rj[3]
    assert np.array_equal(rp[2], rj[2]) and np.array_equal(up, uj)
    assert pengine.bwt_decode_wideaux(up, rp[0], rp[1], rp[2], rp[3],
                                      None) == 0
    assert np.array_equal(up, data)

    for lanes in (8, 1024):
        pp = pwide.wide_encode(uj.tobytes(), n_lanes=lanes)
        pj = jwide.wide_encode(uj.tobytes(), n_lanes=lanes)
        assert pp == pj
        if pp is not None:
            assert pwide.wide_decode(pp) == uj.tobytes()
