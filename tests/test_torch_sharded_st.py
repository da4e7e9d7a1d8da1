"""The port's sample-sort ST step (``parallel.make_sharded_st_step``) on
grids of CPU devices against the JAX package's ``make_sharded_st_step`` on
its 8-device CPU mesh and against the port's ``ops/st.st_encode`` of the
whole block.  Transformed bytes, indexes and ``ok`` are compared exactly.

Each JAX step is built and called once per (mesh, k), on a batch that
holds every block of the case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libbsc_tpu.parallel import make_mesh as jmake_mesh
from libbsc_tpu.parallel import make_sharded_st_step as jmake_sharded
from libbsc_tpu_torch.ops import st as pst
from libbsc_tpu_torch.parallel import (
    make_mesh,
    make_sharded_st_step,
    shard,
    unshard,
)

CPU = torch.device("cpu")
N = 1 << 16


def _text(n: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    words = [b"abra ", b"cadabra ", b"alakazam ", b"xyz "]
    text = bytearray()
    while len(text) < n:
        text += words[rng.integers(0, 4)]
    return np.frombuffer(bytes(text[:n]), np.uint8)


def _blocks(dp: int) -> np.ndarray:
    """Text and random blocks and their reversals, dp rows of them."""
    text = _text(N)
    rand = np.random.default_rng(8).integers(0, 256, N, dtype=np.uint8)
    base = [text, text[::-1], rand, rand[::-1]]
    return np.stack([base[i % 4] for i in range(max(4, dp))])


def _port(blocks: np.ndarray, mesh, **kw):
    out, idx, ok = make_sharded_st_step(mesh, **kw)(
        shard(torch.from_numpy(blocks), mesh))
    return unshard(out).numpy(), unshard(idx), unshard(ok)


def _jax(blocks: np.ndarray, dp: int, sp: int, **kw):
    step = jmake_sharded(jmake_mesh(dp * sp, dp=dp, sp=sp), **kw)
    out, idx, ok = step(jnp.asarray(blocks))
    return np.asarray(out), np.asarray(idx), np.asarray(ok)


def _assert_is_st(blocks: np.ndarray, out: np.ndarray, idx, k: int):
    for b, block in enumerate(blocks):
        ref, ref_idx = pst.st_encode(torch.from_numpy(block.copy()), k)
        np.testing.assert_array_equal(out[b], ref.numpy())
        assert int(idx[b]) == int(ref_idx)


@pytest.fixture(scope="module", params=[(2, 5), (2, 8), (4, 5), (4, 8)],
                ids=lambda p: f"sp{p[0]}-k{p[1]}")
def case(request):
    sp, k = request.param
    blocks = _blocks(2)
    return sp, k, blocks, _jax(blocks, 2, sp, k=k)


def test_equals_jax_step(case):
    sp, k, blocks, (ref_out, ref_idx, ref_ok) = case
    mesh = make_mesh(2 * sp, dp=2, sp=sp, devices=[CPU] * (2 * sp))
    out, idx, ok = _port(blocks, mesh, k=k)
    assert bool(np.all(ref_ok))
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool


def test_equals_st_encode(case):
    sp, k, blocks, _ = case
    mesh = make_mesh(2 * sp, dp=2, sp=sp, devices=[CPU] * (2 * sp))
    out, idx, _ = _port(blocks, mesh, k=k)
    _assert_is_st(blocks, out, idx, k)


def test_output_layout(case):
    """Shards on the members' devices, the index and ok per row."""
    sp, k, blocks, _ = case
    mesh = make_mesh(2 * sp, dp=2, sp=sp, devices=[CPU] * (2 * sp))
    out, idx, ok = make_sharded_st_step(mesh, k=k)(
        shard(torch.from_numpy(blocks), mesh))
    assert len(out) == 2 and all(len(row) == sp for row in out)
    assert all(x.shape == (2, N // sp) and x.dtype == torch.uint8
               for row in out for x in row)
    assert [i.shape for i in idx] == [(2,), (2,)]
    assert [o.shape for o in ok] == [(2,), (2,)]


def test_all_zero_block_on_a_2x2_mesh():
    blocks = np.zeros((2, N), np.uint8)
    ref_out, ref_idx, ref_ok = _jax(blocks, 2, 2, k=5)
    mesh = make_mesh(4, dp=2, sp=2, devices=[CPU] * 4)
    out, idx, ok = _port(blocks, mesh, k=5)
    assert bool(np.all(ref_ok))
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    _assert_is_st(blocks, out, idx, 5)


def test_ok_flags_the_jax_steps_overflow_alike():
    """Two samples a member and a bucket capacity of nl/S + nl/64 overflow
    the JAX step's fixed capacities on some rows: ``ok`` must say so for
    the same rows, while the port's output stays the whole block's ST."""
    rng = np.random.default_rng(3)
    n = 1 << 12
    rand = rng.integers(0, 256, n, dtype=np.uint8)
    blocks = np.stack([rand, rand[::-1], np.zeros(n, np.uint8),
                       np.sort(rand)])
    kw = dict(k=6, n_samples=2, slack_frac=64)
    _, _, ref_ok = _jax(blocks, 2, 2, **kw)
    mesh = make_mesh(4, dp=2, sp=2, devices=[CPU] * 4)
    out, idx, ok = _port(blocks, mesh, **kw)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    assert not ok.all()
    _assert_is_st(blocks, out, idx, 6)


def test_one_member_wraps_onto_its_own_head():
    blocks = _blocks(2)
    ref_out, ref_idx, ref_ok = _jax(blocks, 2, 1, k=7)
    mesh = make_mesh(2, dp=2, sp=1, devices=[CPU] * 2)
    out, idx, ok = _port(blocks, mesh, k=7)
    assert ok.all()
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    _assert_is_st(blocks, out, idx, 7)


def test_a_mesh_that_lists_one_device_four_times():
    blocks = _blocks(1)[:1]
    mesh = make_mesh(4, dp=1, sp=4, devices=[CPU] * 4)
    out, idx, ok = _port(blocks, mesh, k=8)
    assert ok.all()
    _assert_is_st(blocks, out, idx, 8)


@pytest.mark.parametrize("k", [2, 9])
def test_order_outside_3_to_8_raises(k):
    with pytest.raises(ValueError):
        make_sharded_st_step(make_mesh(1, devices=[CPU]), k=k)


def test_shards_under_8_bytes_raise():
    mesh = make_mesh(4, dp=1, sp=4, devices=[CPU] * 4)
    step = make_sharded_st_step(mesh, k=5)
    with pytest.raises(ValueError):
        step(shard(torch.zeros((1, 16), dtype=torch.uint8), mesh))
