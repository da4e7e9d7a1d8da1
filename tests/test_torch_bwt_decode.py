"""The default format's device inverse BWT (list ranking, ``ops/bwt.
bwt_decode``) and the host-driven forward (``suffix_array_fast`` /
``bwt_encode_fast``), torch ops on the CPU, against the JAX package's
functions and the native runtime; corrupt blocks under
``TBSC_ENGINE=ops`` end in DATA_CORRUPT."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libbsc_tpu_torch as P
from libbsc_tpu.ops import bwt as jbwt
from libbsc_tpu_torch import api as papi
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch.format.header import pack_block_header, pack_mode
from libbsc_tpu_torch.ops import bwt as pbwt
from libbsc_tpu_torch.utils.adler32 import adler32
from tests.conftest import make_corpus

KINDS = ["text", "random", "runs", "zeros", "periodic"]
DECODE_SIZES = [1, 2, 255, 4096, 40_000]
FAST_SIZES = [1, 2, 255, 4096, 65_537]
BIG = 1_052_897  # over the 1 MiB device minimum


def _block(n: int, kind: str) -> np.ndarray:
    g = np.random.default_rng(n * 7 + KINDS.index(kind))
    return np.frombuffer(make_corpus(g, n, kind), np.uint8).copy()


def _native_bwt(d: np.ndarray):
    """The native BWT of d: (U, primary, aux indexes)."""
    U = d.copy()
    primary, ni, aux = pengine.bwt_encode(U, 0)
    return U, primary, (aux[:ni] if ni else np.zeros(0, np.int32))


@pytest.fixture(scope="module", autouse=True)
def _init():
    P.init(C.DEFAULT_FEATURES, device="cpu")


@pytest.fixture(scope="module")
def jax_decoded():
    """JAX bwt_decode of every (size, kind) case's native BWT, one call
    each."""
    out = {}
    for n in DECODE_SIZES:
        for kind in KINDS:
            U, primary, _ = _native_bwt(_block(n, kind))
            out[n, kind] = np.asarray(jbwt.bwt_decode(jnp.asarray(U),
                                                      primary))
    return out


@pytest.fixture(scope="module")
def jax_fast():
    """JAX bwt_encode_fast and suffix_array_fast of every case, one call
    each."""
    out = {}
    for n in FAST_SIZES:
        for kind in KINDS:
            d = jnp.asarray(_block(n, kind))
            U, primary, aux = jbwt.bwt_encode_fast(d)
            rank = jbwt.suffix_array_fast(d) if n > 1 else None
            out[n, kind] = (np.asarray(U), int(primary), np.asarray(aux),
                            None if rank is None else np.asarray(rank))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", DECODE_SIZES)
def test_list_ranking_equals_jax_and_native(n, kind, jax_decoded):
    d = _block(n, kind)
    U, primary, aux = _native_bwt(d)
    out = pbwt.bwt_decode(torch.from_numpy(U), primary).numpy()
    assert np.array_equal(out, d)
    assert np.array_equal(out, jax_decoded[n, kind])
    back = U.copy()  # the native inverse of the same stream
    assert pengine.bwt_decode(back, primary, len(aux), aux, 0) == 0
    assert np.array_equal(back, out)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", FAST_SIZES)
def test_bwt_encode_fast_equals_jax_and_native(n, kind, jax_fast):
    d = _block(n, kind)
    U, primary, aux = pbwt.bwt_encode_fast(torch.from_numpy(d))
    jU, jprimary, jaux, jrank = jax_fast[n, kind]
    nU, nprimary, naux = _native_bwt(d)
    assert np.array_equal(U.numpy(), nU) and np.array_equal(U.numpy(), jU)
    assert int(primary) == nprimary == jprimary
    assert np.array_equal(aux.numpy(), naux)
    assert np.array_equal(aux.numpy(), jaux.astype(np.int32))
    if n > 1:
        rank = pbwt.suffix_array_fast(torch.from_numpy(d)).numpy()
        assert np.array_equal(rank, jrank)


@pytest.mark.parametrize("index", [0, 4097])
def test_bad_primary_is_refused_before_any_launch(index):
    U, _, _ = _native_bwt(_block(4096, "text"))
    with pytest.raises(ValueError):
        pbwt.bwt_decode(torch.from_numpy(U), index)


def test_a_non_bwt_with_a_valid_primary_raises_no_index_error():
    """Random bytes are no BWT: the LF permutation has several cycles and
    their distances pass n - 1; the out-of-range writes are dropped."""
    U = _block(40_000, "random")
    out = pbwt.bwt_decode(torch.from_numpy(U), 1234)
    assert out.shape == (40_000,) and out.dtype == torch.uint8


@pytest.fixture(scope="module")
def big():
    """A 1,052,897-byte text block whose LZP output stays over 1 MiB,
    compressed with the default config on the native engine."""
    d = make_corpus(np.random.default_rng(53), BIG, "text")
    return d, P.compress(d)


def _with_index(block: bytes, index: int) -> bytes:
    """The block with its header's primary replaced (header checksum
    recomputed, so the header check passes)."""
    h = papi.parse_block_header(block)
    head = pack_block_header(h.block_size, h.data_size, h.mode, index,
                             h.adler32_data, h.adler32_payload)
    return head + block[C.HEADER_SIZE:]


def _lz_len(block: bytes) -> int:
    """The LZP'd length the sorter inverts."""
    h = papi.parse_block_header(block)
    st = papi._decode_to_sorter(block, None)
    assert st["sorter"] == C.BLOCKSORTER_BWT and h.index > 0
    return len(st["lz"])


@pytest.mark.parametrize("which", ["zero", "n_plus_1"])
def test_a_bad_primary_under_ops_is_data_corrupt(big, which, monkeypatch):
    data, block = big
    n = _lz_len(block)
    assert (1 << 20) <= n < len(data)  # the device route, primary n+1 legal
    monkeypatch.setattr(pengine, "_force", "ops")
    before = pengine.DEVICE_ROUTES["bwt_decode"]
    bad = _with_index(block, 0 if which == "zero" else n + 1)
    with pytest.raises(P.BscError) as e:
        P.decompress(bad)
    assert e.value.code == C.DATA_CORRUPT
    assert pengine.DEVICE_ROUTES["bwt_decode"] == before  # no launch
    buf = np.zeros(n, np.uint8)
    assert pengine.bwt_decode(buf, 0, 0, None, 0,
                              torch.device("cpu")) == C.DATA_CORRUPT


def test_a_non_bwt_block_under_ops_is_data_corrupt(big, monkeypatch):
    """A block whose entropy-decoded bytes are no BWT (two bytes of a real
    BWT swapped) and whose primary is valid: the list ranking runs and the
    Adler-32 check rejects its output."""
    data, _ = big
    d = np.frombuffer(data, np.uint8)
    U, primary, _ = _native_bwt(d)
    i = int(np.argmax(U != U[0]))
    U[[0, i]] = U[[i, 0]]
    payload = bytes(pengine.coder_compress(U, C.CODER_QLFC_STATIC, 0)) \
        + b"\x00"
    mode = pack_mode(C.BLOCKSORTER_BWT, C.CODER_QLFC_STATIC, 0, 0)
    block = pack_block_header(len(payload) + C.HEADER_SIZE, len(d), mode,
                              primary, adler32(data), adler32(payload)) \
        + payload
    monkeypatch.setattr(pengine, "_force", "ops")
    before = pengine.DEVICE_ROUTES["bwt_decode"]
    with pytest.raises(P.BscError) as e:
        P.decompress(block)
    assert e.value.code == C.DATA_CORRUPT
    assert pengine.DEVICE_ROUTES["bwt_decode"] == before + 1
