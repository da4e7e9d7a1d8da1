"""Device wide-aux BWT and device lane balancer / bit schedule (torch ops
on the CPU) against the JAX package's and the native runtime's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libbsc_tpu import api as japi
from libbsc_tpu import engine as jengine
from libbsc_tpu import native as jnative
from libbsc_tpu.ops import bwt as jbwt
from libbsc_tpu.ops import wide as jwide
from libbsc_tpu.ops import wide_schedule as jsched
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch.ops import bwt as pbwt
from libbsc_tpu_torch.ops import wide_schedule as psched
from tests.conftest import make_corpus


def test_bwt_encode_wideaux_device_equals_jax_and_native():
    japi.init()
    g = np.random.default_rng(392)
    data = np.frombuffer(make_corpus(g, 200_000, "text"), np.uint8).copy()
    r = pengine.wideaux_rate(len(data))
    assert r == jengine.wideaux_rate(len(data))
    ref = data.copy()
    idx_ref, k_ref, aux_ref, r_ref = jengine.bwt_encode_wideaux(ref, 0)
    assert r_ref == r
    U, primary, aux = pbwt.bwt_encode_wideaux_device(torch.from_numpy(data),
                                                     r)
    jU, jprimary, jaux = jbwt.bwt_encode_wideaux_device(jnp.asarray(data), r)
    assert int(primary) == idx_ref == int(jprimary)
    assert np.array_equal(U.numpy(), ref)
    assert np.array_equal(U.numpy(), np.asarray(jU))
    assert np.array_equal(aux.numpy(), aux_ref[:k_ref])
    assert np.array_equal(aux.numpy(), np.asarray(jaux, np.int32))

    # the wide-aux chase inverts it, as the JAX chase does
    back = pbwt.unbwt_wideaux(U, idx_ref, aux, r, len(data))
    jback = jbwt._unbwt_wideaux_jit(jnp.asarray(ref), jnp.int32(idx_ref),
                                    jnp.asarray(aux_ref[:k_ref]), r,
                                    len(data))
    assert np.array_equal(back.numpy(), data)
    assert np.array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("kind", ["text", "runs", "periodic", "zeros"])
def test_suffix_ranks_are_the_inverse_suffix_array(kind):
    g = np.random.default_rng(5)
    data = np.frombuffer(make_corpus(g, 5000, kind), np.uint8)
    sa, rank = pbwt.suffix_array(torch.from_numpy(data.copy()))
    raw = data.tobytes()
    expect = sorted(range(len(raw)), key=lambda i: raw[i:])
    assert sa.tolist() == expect
    assert torch.equal(rank[sa], torch.arange(len(raw)))


@pytest.mark.parametrize("kind,n,lanes", [
    ("text", 65536, 16), ("random", 65536, 16), ("runs", 65536, 16),
    ("text", 300_000, 64), ("periodic", 2048, 16)])
def test_device_schedule_v2_equals_jax_and_native(kind, n, lanes):
    japi.init()
    lib = jnative.load()
    g = np.random.default_rng(n + lanes + len(kind))
    data = np.frombuffer(make_corpus(g, n, kind), np.uint8).copy()
    sizes = np.zeros(lanes, np.int32)
    if lib.tbsc_wide_balanced_sizes(jnative._u8p(data), n, lanes,
                                    jnative._i32p(sizes)) != 0:
        sizes = np.asarray(jwide.lane_sizes(n, lanes), np.int32)
    dev_sizes = psched.device_balanced_sizes(torch.from_numpy(data), lanes)
    jdev_sizes = np.asarray(jsched.device_balanced_sizes(jnp.asarray(data),
                                                         lanes))
    assert np.array_equal(dev_sizes.numpy(), jdev_sizes)
    assert int(dev_sizes.sum()) == n
    for sz in (sizes, dev_sizes.numpy()):
        cap4 = -(-(17 * int(max(sz.max(), 1)) + 64) // 4)
        pk = np.zeros((lanes, cap4), np.uint8)
        mb = lib.tbsc_wide_schedule_packed(jnative._u8p(data), n, lanes,
                                           cap4, jnative._u8p(pk),
                                           jnative._i32p(sz))
        assert mb >= 0
        ours, mb_p = psched.device_schedule_v2(torch.from_numpy(data), sz,
                                               lanes)
        theirs, mb_j = jsched.device_schedule_v2(data, sz, lanes)
        assert mb_p == mb == mb_j
        ours = ours.numpy()
        assert np.array_equal(ours, np.asarray(theirs))
        m = min(ours.shape[1], pk.shape[1])
        assert np.array_equal(ours[:, :m], pk[:, :m])
        assert not ours[:, m:].any() and not pk[:, m:].any()


def test_device_balancer_overflow_regression():
    """floor(k R / L) at ~4.7M runs x 1024 lanes: the quantile targets must
    stay exact (k R passes 2^31)."""
    g = np.random.default_rng(479)
    n = 9 * 1024 * 1024
    data = g.integers(0, 2, n, dtype=np.uint8)
    ours = psched.device_balanced_sizes(torch.from_numpy(data), 1024)
    theirs = np.asarray(jsched.device_balanced_sizes(jnp.asarray(data),
                                                     1024))
    assert np.array_equal(ours.numpy(), theirs)
    ds = ours.numpy().astype(np.int64)
    assert ds.sum() == n and (ds >= 0).all()
    nr = np.ones(n, bool)
    nr[1:] = data[1:] != data[:-1]
    R = int(nr.sum())
    starts = np.cumsum(ds) - ds
    cum = np.cumsum(nr)
    frid = cum[np.minimum(starts, n - 1)] - 1
    frid[starts >= n] = R
    counts = np.diff(np.append(frid, R))
    assert counts.max() <= R // 1024 + 2
