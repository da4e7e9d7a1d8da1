"""The default format's torch inverse BWTs (the list ranking, ``ops/bwt.
bwt_decode``, and K16, ``ops/unbwt_rulers``, as a numpy model and its
plain versions) and the host-driven forward (``suffix_array_fast`` /
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
    BWT swapped) and whose primary is valid: the device route runs (K16's
    plain versions on the CPU) and finds it no BWT."""
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


# K16 (ops/unbwt_rulers.py): a numpy model of its steps, held to the
# native inverse and to the module's plain versions, which the card's
# kernels are held to (tests/test_torch_gpu.py).

K16_KINDS = ["zipf", "zeros", "periodic", "random"]


def _k16_block(n: int, kind: str) -> np.ndarray:
    if kind == "zipf":
        from tests.test_torch_default_format import zipf_text

        return zipf_text(n).copy()
    return np.frombuffer(make_corpus(np.random.default_rng(n + 16), n, kind),
                         np.uint8).copy()


def _model_is_ruler(k, srows, shift):
    t = k >> shift
    h = ((t * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - shift)
    return (k == 0) | ((t << shift) + h == k) | np.isin(k, srows)


def _model(U: np.ndarray, index: int, aux):
    """K16 in numpy, every chain at once, a ruler a ``2**shift`` rows
    (the module's TILE_SHIFT): (table, succ, gap, dist, out, ok)."""
    from libbsc_tpu_torch.ops.unbwt_rulers import TILE_SHIFT as shift

    n = len(U)
    rows = [index] + ([] if aux is None else [int(a) + 1 for a in aux])
    r = pbwt.aux_rate(n)
    offs = [0] + [(t + 1) * r for t in range(len(rows) - 1)]
    order = np.argsort(rows)
    srows = np.array(rows, np.int64)[order]
    offs = np.array(offs, np.int64)[order]
    # table: PSI from one stable sort, a row's char from its bucket
    u = np.argsort(U, kind="stable").astype(np.int64)
    psi = np.concatenate([[index], u + (u >= index)])
    first = np.concatenate([[0], np.sort(U)]).astype(np.int64)
    stop = _model_is_ruler(psi, srows, shift)
    table = (_model_is_ruler(np.arange(n + 1), srows, shift).astype(np.int64)
             << 40 | stop.astype(np.int64) << 41 | first[psi] << 32
             | np.where(stop, psi, psi[psi]))
    # the rulers: a row a tile (none where it passes n, is 0 or a start),
    # the starts, the sentinel
    tiles = -(-(n + 1) >> shift)
    t = np.arange(tiles, dtype=np.int64)
    trow = (t << shift) + (((t * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - shift))
    trow[(trow > n) | (trow == 0) | np.isin(trow, srows)] = 0
    start = np.concatenate([trow, srows])
    sentinel = len(start)

    def node(k):
        j = np.searchsorted(srows, k).clip(max=len(srows) - 1)
        return np.where(k == 0, sentinel,
                        np.where(srows[j] == k, tiles + j, k >> shift))

    # chase 1: each ruler to the next, one or two rows a load
    succ = np.arange(sentinel + 1)
    gap = np.zeros(sentinel + 1, np.int64)
    live = np.flatnonzero(start)
    k, g = start[live], np.zeros(len(live), np.int64)
    while len(live):
        x = table[k]
        met = (g > 0) & (x >> 40 & 1 == 1)
        nxt = ~met & (x >> 41 & 1 == 1)
        k = np.where(met, k, x & 0xFFFFFFFF)
        g = g + np.where(met, 0, np.where(nxt, 1, 2))
        done = met | nxt
        succ[live[done]] = node(k[done])
        gap[live[done]] = g[done]
        keep = ~done & (g <= n)
        live, k, g = live[keep], k[keep], g[keep]
    # ranking by pointer doubling
    s, dist = succ.copy(), gap.copy()
    for _ in range(max(1, (sentinel).bit_length())):
        dist, s = dist + dist[s], s[s]
    reached = s[:sentinel] == sentinel
    pos = n - dist[:sentinel]
    ok = bool((reached[tiles:] & (pos[tiles:] == offs)).all())
    # chase 2: each reached ruler writes its gap from its offset
    out = np.zeros(n, np.uint8)
    live = np.flatnonzero(reached & (gap[:sentinel] > 0))
    k, w, end = start[live], pos[live], pos[live] + gap[live]
    while len(k):
        out[w] = first[k]
        w, k = w + 1, psi[k]
        keep = w < end
        k, w, end = k[keep], w[keep], end[keep]
    return table, succ, gap, dist, out, ok


@pytest.mark.parametrize("n,kind", [(2, "text"), (3, "text"),
                                    (4097, "text"), (1 << 20, "zipf")]
                         + [(65_536, kind) for kind in K16_KINDS])
def test_k16_model_equals_the_native_inverse(n, kind):
    """The numpy model of K16, with the aux indexes as start rows, gives
    the native tbsc_bwt_decode's bytes, and the module's plain versions
    give the model's table, gaps, ranks and bytes."""
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    d = _k16_block(n, kind)
    U, primary, aux = _native_bwt(d)
    aux = aux if len(aux) == (n - 1) // pbwt.aux_rate(n) else None
    table, succ, gap, dist, out, ok = _model(U, primary, aux)
    back = U.copy()
    assert pengine.bwt_decode(back, primary, 0 if aux is None else len(aux),
                              aux, 0) == 0
    assert ok and np.array_equal(out, back) and np.array_equal(out, d)
    assert gap.sum() == n  # the gaps cover the block once
    rows, offs = K16.start_rows(n, primary, aux)
    srows = torch.from_numpy(rows)
    chars, u_sorted = torch.sort(torch.from_numpy(U), stable=True)
    ends = pbwt.bucket_ends(chars)
    pairs = K16.table(u_sorted, primary, ends, srows)
    assert np.array_equal(pairs.numpy(), table)
    psucc, pgap = K16.gaps(pairs, n, srows)
    assert np.array_equal(psucc.numpy(), succ)
    assert np.array_equal(pgap.numpy(), gap)
    rsucc, pdist = K16.rank(psucc, pgap)
    assert np.array_equal(pdist.numpy(), dist)
    pout, status = K16.write(pairs, ends, n, srows, torch.from_numpy(offs),
                             rsucc, pdist, pgap)
    assert np.array_equal(pout.numpy(), d) and int(status) == 0


def _non_bwts():
    """(U, primary, aux) of two blocks that are no BWT, each primary (and
    aux index) in range: random bytes, and a real BWT with two bytes
    swapped."""
    rnd = _block(40_000, "random")
    U, primary, aux = _native_bwt(_k16_block(65_536, "zipf"))
    i = int(np.argmax(U != U[0]))
    U[[0, i]] = U[[i, 0]]
    return {"random": (rnd, 1234, None), "swapped": (U, primary, aux)}


@pytest.mark.parametrize("case", ["random", "swapped"])
def test_k16_on_a_non_bwt_stops_and_writes_inside_the_block(case):
    """A non-BWT with a valid primary: the model and the plain versions
    end (no walk passes n rows), agree, report a status of 1 and write no
    byte outside [0, n) (guard bytes around the output)."""
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    U, primary, aux = _non_bwts()[case]
    n = len(U)
    *_, out, ok = _model(U, primary, aux)
    assert not ok
    rows, offs = K16.start_rows(n, primary, aux)
    srows = torch.from_numpy(rows)
    chars, u_sorted = torch.sort(torch.from_numpy(U), stable=True)
    ends = pbwt.bucket_ends(chars)
    pairs = K16.table(u_sorted, primary, ends, srows)
    succ, gap = K16.gaps(pairs, n, srows)
    assert int(gap.max()) <= n
    rsucc, dist = K16.rank(succ, gap)
    guarded = torch.full((n + 64,), 0xA5, dtype=torch.uint8)
    guarded[32: 32 + n] = 0
    pout, status = K16.write(pairs, ends, n, srows, torch.from_numpy(offs),
                             rsucc, dist, gap, out=guarded[32: 32 + n])
    assert int(status) == 1
    assert np.array_equal(pout.numpy(), out)
    assert bool((guarded[:32] == 0xA5).all() and
                (guarded[32 + n:] == 0xA5).all())


@pytest.mark.parametrize("bad", ["primary", "aux_range", "aux_twice",
                                 "aux_count"])
def test_k16_refuses_starts_no_bwt_has(bad):
    """start_rows raises before any launch for a primary outside [1, n],
    an aux index outside [0, n), two starts on one row, or a count of aux
    indexes other than the format's."""
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    U, primary, aux = _native_bwt(_k16_block(65_536, "zipf"))
    n = len(U)
    aux = aux.copy()
    if bad == "primary":
        primary = n + 1
    elif bad == "aux_range":
        aux[1] = n
    elif bad == "aux_twice":
        aux[1] = aux[0]
    else:
        aux = aux[:-1]
    with pytest.raises(ValueError):
        K16.start_rows(n, primary, aux)
    with pytest.raises(ValueError):
        K16.unbwt(torch.from_numpy(U), primary, aux)


def test_the_inverse_routes_a_cuda_device_to_the_card(monkeypatch):
    """bwt_route(n, device), one rule for the BWT and its inverse: a CUDA
    device and n >= 1 MiB give device (no launch needed to decide); the
    CPU, a smaller block or no device keep the host; ``ops`` sends a
    block of 1 MiB or more on any device to it; ``numpy`` takes every
    block.  bwt_encode and bwt_decode both ask it with the block's
    length and device."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    big, small = 1 << 20, (1 << 20) - 1
    assert pengine.bwt_route(big, cuda) == "device"
    assert pengine.bwt_route(big, cpu) == "host"
    assert pengine.bwt_route(small, cuda) == "host"
    assert pengine.bwt_route(big, None) == "host"
    with monkeypatch.context() as m:
        m.setattr(pengine, "_force", "ops")
        assert pengine.bwt_route(big, cpu) == "device"
        assert pengine.bwt_route(big, cuda) == "device"
        assert pengine.bwt_route(small, cpu) == "host"
        assert pengine.bwt_route(big, None) == "host"
    with monkeypatch.context() as m:
        m.setattr(pengine, "_force", "numpy")
        assert {pengine.bwt_route(n, d) for n in (big, small)
                for d in (cuda, cpu, None)} == {"numpy"}

    asked = []
    monkeypatch.setattr(pengine, "bwt_route",
                        lambda n, device: asked.append((n, device)) or "host")
    data = _block(5000, "text")
    block = data.copy()
    primary, ni, aux = pengine.bwt_encode(block, 0, cuda)
    assert pengine.bwt_decode(block, primary, ni, aux, 0, cuda) == 0
    assert asked == [(5000, cuda), (5000, cuda)]
    np.testing.assert_array_equal(block, data)


def test_the_benchmark_readers_of_the_device_inverse(monkeypatch):
    """unbwt_device_pct.decode: the share of the decode phase's bwt_decode
    spans tagged device; unbwt_copy_ms.decode: their bwt.upload and
    bwt.download children, ms a block; both None without their spans
    (a program whose inverse stays on the host)."""
    from pathlib import Path
    from types import SimpleNamespace

    from portbench import harness

    def S(id, name, parent=None, end=0, tag=""):
        return SimpleNamespace(id=id, name=name, parent=parent, start=0,
                               end=end, out=None, tag=tag)

    root = Path(__file__).resolve().parent.parent / "portbench" / "metrics"
    pct = harness.load_file(root / "unbwt_device_pct.decode.py", "pct")
    copy = harness.load_file(root / "unbwt_copy_ms.decode.py", "copy")
    rec = [S(1, "api.decompress"), S(2, "api.decompress"),
           S(3, "bwt_decode", 1, 5_000_000, "device, 13 aux, 0 threads"),
           S(4, "bwt.upload", 3, 1_000_000),
           S(5, "bwt.download", 3, 2_000_000),
           S(6, "bwt_decode", 2, 9_000_000, "host, 13 aux, 1 threads"),
           S(7, "api.compress"), S(8, "bwt_decode", 7, 1, "device")]
    monkeypatch.setattr("portbench.spans.record", lambda: rec)
    assert pct.read(None) == 50.0
    assert copy.read(None) == 1.5
    monkeypatch.setattr("portbench.spans.record", lambda: rec[5:])
    assert pct.read(None) is None and copy.read(None) is None
    monkeypatch.setattr("portbench.spans.record", lambda: None)
    assert pct.read(None) is None and copy.read(None) is None

