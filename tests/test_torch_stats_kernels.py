"""K6 (byte histogram) and K7 (Adler-32 partials): the port's plain
versions, which the wrappers run for CPU tensors, against the JAX
package's Pallas kernels in interpret mode and against zlib.  All
comparisons are exact (integer counts and checksums)."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libbsc_tpu.ops import pallas_kernels as jpk
from libbsc_tpu_torch.ops import stats_kernels as S

HIST_SIZES = [1, 100, 2048, 131072, 131079]
ADLER_SIZES = [0, 1, 2047, 2048, 2049, 131072]
SEED = 0x9ABCDEF1


def _bytes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_constants_are_the_jax_kernels():
    assert S._HIST_TILE == jpk._HIST_TILE == 131072
    assert S._ADLER_CHUNK == jpk._ADLER_CHUNK == 2048


@pytest.mark.parametrize("n", HIST_SIZES)
def test_byte_histogram_equals_jax(n):
    d = _bytes(n, n)
    ours = S.byte_histogram(torch.from_numpy(d))
    assert ours.dtype == torch.int32 and ours.shape == (256,)
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jpk.byte_histogram(jnp.asarray(d))))


def test_byte_histogram_skewed_and_offset():
    zeros = torch.zeros(300_000, dtype=torch.uint8)
    assert S.byte_histogram(zeros)[0] == 300_000
    assert S.byte_histogram(zeros)[1:].sum() == 0
    d = _bytes(200_003, 3)
    view = torch.from_numpy(d)[3:3 + 199_997]  # a view at an odd offset
    np.testing.assert_array_equal(
        S.byte_histogram(view).numpy(),
        np.bincount(d[3:3 + 199_997], minlength=256))
    assert S.byte_histogram(torch.zeros(0, dtype=torch.uint8)).sum() == 0


@pytest.mark.parametrize("n", [n for n in ADLER_SIZES if n])
def test_adler_partials_equal_jax(n):
    """The port writes ceil(n / 2048) rows; the JAX kernel pads to 64
    chunks, whose extra rows are zero."""
    d = _bytes(n, n + 1)
    ours = S._adler_partials(torch.from_numpy(d))
    ref = np.asarray(jpk._adler_partials(jnp.asarray(d)))
    rows = -(-n // 2048)
    assert ours.dtype == torch.int32 and ours.shape == (rows, 2)
    np.testing.assert_array_equal(ours.numpy(), ref[:rows])
    assert not ref[rows:].any()


@pytest.mark.parametrize("n", ADLER_SIZES)
def test_adler32_device_equals_jax_and_zlib(n):
    d = _bytes(n, n + 2)
    expect = zlib.adler32(d.tobytes()) & 0xFFFFFFFF
    assert S.adler32_device(torch.from_numpy(d)) == expect
    assert jpk.adler32_device(jnp.asarray(d)) == expect


def test_adler32_device_seeded():
    d = _bytes(10000, 5)
    expect = zlib.adler32(d.tobytes(), SEED) & 0xFFFFFFFF
    assert S.adler32_device(torch.from_numpy(d), value=SEED) == expect
    assert jpk.adler32_device(jnp.asarray(d), value=SEED) == expect
    assert S.adler32_device(torch.zeros(0, dtype=torch.uint8), SEED) == SEED


@pytest.mark.parametrize("n", ADLER_SIZES)
def test_adler32_device_seeded_at_every_size(n):
    d = _bytes(n, n + 3)
    expect = zlib.adler32(d.tobytes(), SEED) & 0xFFFFFFFF
    assert S.adler32_device(torch.from_numpy(d), value=SEED) == expect
    assert jpk.adler32_device(jnp.asarray(d), value=SEED) == expect


@pytest.mark.parametrize("offset", [1, 2, 3, 5, 7, 15])
def test_views_at_an_offset(offset):
    """A shard is a view at any byte offset: K6's and K7's plain versions
    and adler32_device take it as the bytes it shows."""
    d = _bytes(5000 + 2 * offset, offset)
    view = torch.from_numpy(d)[offset:offset + 4099]
    host = d[offset:offset + 4099]
    np.testing.assert_array_equal(S.byte_histogram(view).numpy(),
                                  np.bincount(host, minlength=256))
    assert S.adler32_device(view) == zlib.adler32(host.tobytes())
    np.testing.assert_array_equal(
        S._adler_partials(view).numpy(),
        np.asarray(jpk._adler_partials(jnp.asarray(host)))[:3])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        S.byte_histogram(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        S._adler_partials(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        S.byte_histogram(torch.zeros(16, dtype=torch.uint8)[::2])


def test_plain_versions_count_no_launch():
    S.reset_launches()
    S.byte_histogram(torch.from_numpy(_bytes(5000, 1)))
    S.adler32_device(torch.from_numpy(_bytes(5000, 2)))
    assert S.LAUNCHES == {"byte_hist": 0, "adler_partials": 0}
