"""The port's sharded transform step (``parallel/pipeline.py``) on a grid
of CPU devices against the JAX package's ``make_transform_step`` on its
8-device CPU mesh.  Outputs, sort indexes and histograms are compared
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libbsc_tpu.ops import st as jst
from libbsc_tpu.parallel import make_mesh as jmake_mesh
from libbsc_tpu.parallel import make_transform_step as jmake_step
from libbsc_tpu_torch.parallel import pipeline as pp
from libbsc_tpu_torch.parallel import (
    batch_bwt_encode,
    batch_st_encode,
    make_mesh,
    make_transform_step,
    shard,
    unshard,
)
from tests.conftest import make_corpus

CPU = torch.device("cpu")


def _blocks(seed: int, b: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([
        np.frombuffer(make_corpus(rng, n, ["text", "runs", "periodic"][i % 3]),
                      dtype=np.uint8)
        for i in range(b)])


def _jax_step(blocks: np.ndarray, sorter: str, k: int, **mesh_kw):
    mesh = jmake_mesh(**mesh_kw)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("dp", "sp"))
    out, idx, hist = jmake_step(mesh, sorter=sorter, k=k)(
        jax.device_put(jnp.asarray(blocks), sharding))
    return np.asarray(out), np.asarray(idx), np.asarray(hist)


def test_mesh_shapes():
    cpus = [CPU] * 8
    assert make_mesh(8, devices=cpus).shape == {"dp": 4, "sp": 2}
    assert make_mesh(8, dp=8, devices=cpus).shape == {"dp": 8, "sp": 1}
    assert make_mesh(1, devices=cpus).shape == {"dp": 1, "sp": 1}
    assert make_mesh(devices=cpus[:6], sp=3).shape == {"dp": 2, "sp": 3}
    with pytest.raises(ValueError):
        make_mesh(8, dp=3, devices=cpus)
    with pytest.raises(ValueError):
        make_mesh(9, devices=cpus)


def test_make_mesh_never_takes_the_cpu_for_missing_cuda_devices():
    with pytest.raises(ValueError):
        make_mesh(torch.cuda.device_count() + 1)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            make_mesh()


def test_shard_and_unshard_are_inverse():
    mesh = make_mesh(8, devices=[CPU] * 8)
    blocks = torch.from_numpy(_blocks(1, 8, 1024))
    grid = shard(blocks, mesh)
    assert len(grid) == 4 and all(len(row) == 2 for row in grid)
    assert all(x.shape == (2, 512) and x.is_contiguous()
               for row in grid for x in row)
    assert torch.equal(unshard(grid), blocks)
    with pytest.raises(ValueError):
        shard(blocks[:, :1023], mesh)


@pytest.mark.parametrize("sorter", ["st", "bwt"])
def test_step_equals_jax_on_a_4x2_mesh(sorter):
    blocks = _blocks(2, 8, 1024)
    ref_out, ref_idx, ref_hist = _jax_step(blocks, sorter, 5, n_devices=8)
    mesh = make_mesh(8, devices=[CPU] * 8)
    out, idx, hist = make_transform_step(mesh, sorter=sorter, k=5)(
        shard(torch.from_numpy(blocks), mesh))
    assert len(out) == 4 and len(idx) == 4 and len(hist) == 4
    np.testing.assert_array_equal(unshard(out).numpy(), ref_out)
    np.testing.assert_array_equal(unshard(idx).numpy(), ref_idx)
    np.testing.assert_array_equal(unshard(hist).numpy(), ref_hist)
    assert unshard(idx).dtype == unshard(hist).dtype == torch.int32


def test_large_shards_take_the_histogram_kernel(monkeypatch):
    """Shards of _HIST_TILE bytes or more go through byte_histogram (K6;
    its plain version here), one call per block and member."""
    blocks = _blocks(3, 1, 2 * pp._HIST_TILE)
    ref_out, ref_idx, ref_hist = _jax_step(blocks, "st", 4, n_devices=2,
                                           dp=1, sp=2)
    calls = []
    real = pp.byte_histogram

    def spy(row):
        calls.append(row.shape[0])
        return real(row)

    monkeypatch.setattr(pp, "byte_histogram", spy)
    mesh = make_mesh(2, dp=1, sp=2, devices=[CPU] * 2)
    out, idx, hist = make_transform_step(mesh, sorter="st", k=4)(
        shard(torch.from_numpy(blocks), mesh))
    assert calls == [pp._HIST_TILE] * 2
    np.testing.assert_array_equal(unshard(out).numpy(), ref_out)
    np.testing.assert_array_equal(unshard(idx).numpy(), ref_idx)
    np.testing.assert_array_equal(unshard(hist).numpy(), ref_hist)


def test_batch_st_encode():
    blocks = _blocks(4, 4, 512)
    out, idx = batch_st_encode(torch.from_numpy(blocks), 4)
    for i in range(4):
        ref_out, ref_idx = jst.st_encode(jnp.asarray(blocks[i]), 4)
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref_out))
        assert int(idx[i]) == int(ref_idx)


def test_batch_bwt_encode_keeps_the_aux_indexes():
    from libbsc_tpu_torch.ops import bwt as pbwt

    blocks = _blocks(5, 2, 70_000)
    U, primary, aux = batch_bwt_encode(torch.from_numpy(blocks))
    assert aux.shape == (2, (70_000 - 1) // pbwt.aux_rate(70_000))
    for i in range(2):
        u, p, a = pbwt.bwt_encode(torch.from_numpy(blocks[i]))
        assert torch.equal(U[i], u) and int(primary[i]) == int(p)
        assert torch.equal(aux[i], a)


def test_unknown_sorter_raises():
    with pytest.raises(ValueError):
        make_transform_step(make_mesh(1, devices=[CPU]), sorter="lzp")
