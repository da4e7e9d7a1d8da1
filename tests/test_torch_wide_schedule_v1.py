"""The device bit schedule for an explicit lane table
(``ops/wide_schedule.device_schedule``, the JAX package's v1) against the
JAX function and the native walker, unequal lane tables included, and its
``TBSC_WIDE_DEV_SCHED`` route in the per-stage device encode."""

import numpy as np
import pytest
import torch

from libbsc_tpu.ops import wide_schedule as jsched
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch import native as pnative
from libbsc_tpu_torch.ops import wide as pwide
from libbsc_tpu_torch.ops import wide_kernels as pwk
from libbsc_tpu_torch.ops import wide_schedule as psched
from tests.conftest import make_corpus


def _skewed(n: int, lanes: int) -> np.ndarray:
    """Empty lanes first and last, one lane with half the block."""
    sizes = np.zeros(lanes, np.int32)
    sizes[3] = n // 2
    sizes[lanes - 3] = n // 4
    sizes[lanes - 2] = n - n // 2 - n // 4
    return sizes


def _table(kind: str, n: int, lanes: int, table: str) -> np.ndarray:
    if table == "equal":
        return np.asarray(pwide.lane_sizes(n, lanes), np.int32)
    if table == "skewed":
        return _skewed(n, lanes)
    g = np.random.default_rng(n + lanes)  # random cut points
    cuts = np.sort(g.integers(0, n + 1, lanes - 1))
    return np.diff(np.concatenate([[0], cuts, [n]])).astype(np.int32)


CASES = [("text", 65_536, 16, "equal"), ("runs", 65_536, 16, "skewed"),
         ("random", 20_000, 16, "random"), ("zeros", 30_000, 16, "skewed"),
         ("text", 100_000, 64, "random")]


def _data(kind: str, n: int) -> np.ndarray:
    g = np.random.default_rng(n * 3 + len(kind))
    return np.frombuffer(make_corpus(g, n, kind), np.uint8).copy()


@pytest.fixture(scope="module")
def jax_planes():
    """JAX device_schedule (v1) of every case, one call each."""
    out = {}
    for kind, n, lanes, table in CASES:
        planes, mb = jsched.device_schedule(
            _data(kind, n), _table(kind, n, lanes, table), lanes)
        out[kind, n, lanes, table] = (np.asarray(planes), mb)
    return out


@pytest.mark.parametrize("kind,n,lanes,table", CASES)
def test_device_schedule_equals_jax_v1_and_native(kind, n, lanes, table,
                                                  jax_planes):
    pengine.init("cpu")
    lib = pnative.load()
    data = _data(kind, n)
    sizes = _table(kind, n, lanes, table)
    assert int(sizes.sum()) == n
    ours, mb = psched.device_schedule(torch.from_numpy(data), sizes, lanes)
    theirs, mb_j = jax_planes[kind, n, lanes, table]
    cap4 = -(-(17 * int(max(sizes.max(), 1)) + 64) // 4)
    pk = np.zeros((lanes, cap4), np.uint8)
    mb_n = lib.tbsc_wide_schedule_packed(pnative.u8p(data), n, lanes, cap4,
                                         pnative.u8p(pk), pnative.i32p(sizes))
    assert mb == mb_j == mb_n
    ours = ours.numpy()
    assert np.array_equal(ours, theirs)
    m = min(ours.shape[1], pk.shape[1])
    assert np.array_equal(ours[:, :m], pk[:, :m])
    assert not ours[:, m:].any() and not pk[:, m:].any()


def test_device_schedule_takes_what_v2_refuses():
    """v2 refuses an iteration count at its packing cap; v1 (and so the
    port's device_schedule) returns planes for it."""
    data = _data("random", 40_000)
    sizes = np.zeros(16, np.int32)
    sizes[0] = len(data)  # one lane: ~17 bits a byte, past 2^19 iterations
    assert psched.device_schedule_v2(torch.from_numpy(data), sizes,
                                     16)[0] is None
    planes, mb = psched.device_schedule(torch.from_numpy(data), sizes, 16)
    assert mb >= psched._IT_CAP
    assert planes.shape == (16, psched._bucket(mb, 256) // 4)


def test_wide_dev_sched_routes_the_schedule_to_the_device(monkeypatch):
    """TBSC_WIDE_DEV_SCHED: the per-stage device encode takes its planes
    from device_schedule on the native lane table; planes and payload
    equal the native walker's route.  (device_encode_many keeps the
    walker: its prep thread is the host stage it overlaps.)"""
    pengine.init("cpu")
    data = _data("text", 120_000).tobytes()
    host = pwk._host_prep(data, torch.device("cpu"))
    want = pwk.device_encode(data, "cpu")
    monkeypatch.setenv("TBSC_WIDE_DEV_SCHED", "1")
    dev = pwk._host_prep(data, torch.device("cpu"))
    assert isinstance(dev[0], torch.Tensor)
    assert np.array_equal(dev[0].numpy(), host[0])
    assert np.array_equal(dev[1], host[1]) and dev[2:] == host[2:]
    assert pwk.device_encode(data, "cpu") == want
