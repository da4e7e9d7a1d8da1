"""The slice as a whole: the port's -m9 -e4 -G archive (plain kernel
versions on the CPU) against the archive composed from the JAX package's
parts, and both packages' decoders on it."""

import struct

import numpy as np
import pytest

import jax.numpy as jnp

import libbsc_tpu_torch as P
from libbsc_tpu import api as japi
from libbsc_tpu import engine as jengine
from libbsc_tpu import native as jnative
from libbsc_tpu.format.header import pack_block_header, pack_mode
from libbsc_tpu.ops import bwt as jbwt
from libbsc_tpu.ops import wide_schedule as jsched
from libbsc_tpu.utils.adler32 import adler32
from libbsc_tpu_torch import constants as C
from tests.conftest import make_corpus

FEATURES = C.FEATURE_FASTMODE | C.FEATURE_CUDA
MODE_ARGS = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                 coder=C.CODER_QLFC_WIDE)


def _native_wide_encode(U: np.ndarray, sizes: np.ndarray) -> bytes:
    lib = jnative.load()
    out = np.empty(len(U) + 65536, np.uint8)
    sizes = np.ascontiguousarray(sizes, np.int32)
    rc = lib.tbsc_wide_encode(jnative._u8p(U), len(U), jnative._u8p(out),
                              len(out), 1024, jnative._i32p(sizes), 1)
    assert rc > 0
    return out[:rc].tobytes()


def _composed_archive(data: bytes) -> bytes:
    """native LZP -> JAX device BWT -> JAX device lane table -> native wide
    encode -> wide-aux tail and header."""
    lz = jengine.lzp_compress(np.frombuffer(data, np.uint8),
                              C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                              0).copy()
    assert len(lz) >= 1 << 20  # the fused route's minimum
    r = jengine.wideaux_rate(len(lz))
    U, primary, aux = jbwt.bwt_encode_wideaux_device(jnp.asarray(lz), r)
    U = np.asarray(U)
    sizes = np.asarray(jsched.device_balanced_sizes(jnp.asarray(U), 1024))
    aux = np.asarray(aux, np.int32)
    payload = _native_wide_encode(U, sizes)
    payload += aux.astype("<i4").tobytes() + struct.pack("<I", len(aux)) \
        + b"\xff"
    mode = pack_mode(C.BLOCKSORTER_BWT_WIDEAUX, C.CODER_QLFC_WIDE,
                     C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN)
    return pack_block_header(len(payload) + C.HEADER_SIZE, len(data), mode,
                             int(primary), adler32(data), adler32(payload)) \
        + payload


@pytest.fixture(scope="module")
def data():
    return make_corpus(np.random.default_rng(1536), 3 << 19, "text")


@pytest.fixture(scope="module")
def archive(data):
    mp = pytest.MonkeyPatch()
    mp.setenv("TBSC_WIDE_LANES", "1024")  # the 1024-lane policy at 1.5 MiB
    try:
        japi.init()
        P.init(FEATURES, device="cpu")
        yield P.compress(data, **MODE_ARGS), _composed_archive(data)
    finally:
        mp.undo()


def test_archive_equals_the_one_composed_from_jax_parts(archive):
    ours, composed = archive
    assert ours == composed


def test_jax_package_decodes_the_port_archive(data, archive):
    japi.init()
    assert japi.decompress(archive[0]) == data


def test_port_decodes_its_archive_on_both_routes(data, archive):
    P.init(FEATURES, device="cpu")
    assert P.decompress(archive[0]) == data
    P.init(C.FEATURE_FASTMODE, device="cpu")  # host stages only
    assert P.decompress(archive[0]) == data
    assert P.block_info(archive[0][:C.HEADER_SIZE]) == (len(archive[0]),
                                                        len(data))


def test_jax_fused_payload_equals_native_with_the_device_table():
    """40 KB: the JAX fused wide encode (interpret mode) is the native
    encode with the device balancer's lane table — and so is the port's."""
    from libbsc_tpu.ops import wide_kernels as jwk
    from libbsc_tpu_torch.ops import wide_kernels as pwk

    japi.init()
    d = np.frombuffer(make_corpus(np.random.default_rng(40), 40_000, "text"),
                      np.uint8).copy()
    jengine.bwt_encode(d, 0)
    ref = jwk.device_encode_resident(jnp.asarray(d), interpret=True)
    sizes = np.asarray(jsched.device_balanced_sizes(jnp.asarray(d), 1024))
    assert ref == _native_wide_encode(d, sizes)
    import torch

    assert pwk.device_encode_resident(torch.from_numpy(d)) == ref


def test_small_and_unsupported_blocks():
    P.init(FEATURES, device="cpu")
    assert P.decompress(P.compress(b"x" * 20, **MODE_ARGS)) == b"x" * 20
    small = make_corpus(np.random.default_rng(9), 70_000, "text")
    blob = P.compress(small, **MODE_ARGS)  # per-stage route, native codec
    japi.init()
    assert japi.decompress(blob) == small
    assert blob == japi.compress(small, **MODE_ARGS)
    zeros = bytes(300_000)  # LZP output under a header: plain BWT sorter
    blob = P.compress(zeros, **MODE_ARGS)
    assert blob == japi.compress(zeros, **MODE_ARGS)
    assert P.decompress(blob) == zeros
