"""The CUDA kernels K1-K7 against their plain PyTorch versions on the card,
at small size, the fused -m9 -e4 -G route through them (v3 and v2 coder),
the pipelined many-block entry points, the sharded transform step on a
one-GPU mesh (K6 in its stage 1), the -m5 -G device ST route, the
CLI: -m9 -e4 -G through K1, K2 and K3, and the -G default config through
the device BWT, the sample-sort ST step on a mesh that lists cuda:0
twice, and the DC3 device BWT.

These tests need a CUDA device and skip without one.  tests/conftest.py
imports JAX, which a GPU machine need not have, so run them there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

All comparisons are exact: the codec is lossless.
"""

import numpy as np
import pytest
import torch

import libbsc_tpu_torch as P
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import native
from libbsc_tpu_torch.ops import wide as W
from libbsc_tpu_torch.ops import wide_kernels as WK
from libbsc_tpu_torch.ops import wide_schedule as WS
from libbsc_tpu_torch.ops import stats_kernels as S

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _runs(n: int, seed: int) -> bytes:
    g = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([g.integers(0, 4)]) * int(g.integers(1, 10))
    return bytes(out[:n])


def _text(n: int, seed: int) -> bytes:
    g = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
             b"a lazy dog. ", b"compression ", b"transform ", b"lanes "]
    out = bytearray()
    while len(out) < n:
        out += words[g.integers(0, len(words))]
    return bytes(out[:n])


def _equal_split_planes(data: bytes):
    """Planes of the native walker over the equal-split lane table
    (dead lanes at the end when the block is not a multiple of 1024)."""
    n = len(data)
    buf = np.frombuffer(data, np.uint8).copy()
    pk, max_bits = WK.host_schedule_packed(buf, n, None, -(-n // WK.LANES))
    assert max_bits > 0
    IT = WK._it_bucket(max(max_bits, WK.TI))
    pk = np.pad(pk, ((0, 0), (0, max(0, IT // 4 - pk.shape[1]))))
    return np.ascontiguousarray(pk[:, : IT // 4].T), max_bits


@pytest.fixture(scope="module", params=["balanced", "dead_lanes"])
def case(request):
    if request.param == "balanced":
        data = _runs(1024 * 40, 212)
        planes, sizes, max_bits, _ = WK._host_prep(data)
    else:  # 24 dead lanes: the equal split gives 1000 live lanes
        data = _runs(1024 * 36 + 123, 271)
        planes, max_bits = _equal_split_planes(data)
        sizes = None
    return data, planes, sizes, max_bits


def test_model_kernel_equals_plain(cuda, case):
    _, planes, _, max_bits = case
    planes_d = torch.from_numpy(planes).to(cuda)
    before = WK.LAUNCHES["wide_model"]
    ours = WK.model_probs(planes_d, max_bits)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["wide_model"] == before + 1
    plain = WK.model_probs_plain(planes_d, max_bits)
    assert torch.equal(ours, plain)


def test_rans_kernel_equals_plain_and_native(cuda, case):
    data, planes, sizes, max_bits = case
    planes_d = torch.from_numpy(planes).to(cuda)
    probs = WK.model_probs_plain(planes_d, max_bits)
    units, counts, fx = WK.rans_encode(planes_d, probs, max_bits)
    torch.cuda.synchronize()
    p_units, p_counts, p_fx = WK.rans_encode_plain(planes_d, probs, max_bits,
                                                   units.shape[1])
    assert torch.equal(counts, p_counts) and torch.equal(fx, p_fx)
    cap = units.shape[1]
    for g, c in enumerate(counts.tolist()):
        assert torch.equal(units[g, cap - c:], p_units[g, cap - c:])
    payload = WK._assemble_rans(len(data), units, counts, fx, sizes,
                                max_bits)
    assert payload == W.wide_encode(data, n_lanes=WK.LANES,
                                    balanced=sizes is not None, rans=True)


def test_rans_kernel_on_a_block_under_one_ring(cuda):
    """K2 on chip_smoke.py's all-zero hard block: 35 steps, under one ring
    of 8 chunks of 32 and not a multiple of the chunk, 60 live lanes."""
    from chip_smoke import hard_blocks, lane_planes

    data, sizes = hard_blocks(b"")["zeros"]
    planes, sizes, max_bits = lane_planes(data, sizes)
    assert max_bits < 256 and max_bits % 32
    planes_d = torch.from_numpy(planes).to(cuda)
    probs = WK.model_probs(planes_d, max_bits)
    before = WK.LAUNCHES["wide_rans"]
    units, counts, fx = WK.rans_encode(planes_d, probs, max_bits)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["wide_rans"] == before + 1
    p_units, p_counts, p_fx = WK.rans_encode_plain(planes_d, probs, max_bits,
                                                   units.shape[1])
    assert torch.equal(counts, p_counts) and torch.equal(fx, p_fx)
    cap = units.shape[1]
    for g, c in enumerate(counts.tolist()):
        assert torch.equal(units[g, cap - c:], p_units[g, cap - c:])
    assert WK._assemble_rans(len(data), units, counts, fx, sizes,
                             max_bits) == W.wide_encode(
        data, n_lanes=WK.LANES, sizes=sizes, rans=True)


def test_decode_kernel_equals_plain_and_input(cuda, case):
    data, _, sizes, _ = case
    payload = W.wide_encode(data, n_lanes=WK.LANES,
                            balanced=sizes is not None, rans=True)
    args = WK._dec_args(WK._dec_parse(payload), cuda)
    ours = WK.decode_lanes(*args)
    torch.cuda.synchronize()
    assert torch.equal(ours, WK.decode_lanes_plain(*args))
    assert ours.cpu().numpy().tobytes() == data


def test_rc_encode_kernel_equals_plain_and_native(cuda, case):
    data, planes, sizes, max_bits = case
    planes_d = torch.from_numpy(planes).to(cuda)
    before = WK.LAUNCHES["wide_rc_encode"]
    units, counts = WK.rc_encode(planes_d, max_bits)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["wide_rc_encode"] == before + 1
    p_units, p_counts = WK.rc_encode_plain(planes_d, max_bits, units.shape[1])
    assert torch.equal(counts, p_counts)
    for g, c in enumerate(counts.tolist()):
        assert torch.equal(units[g, :c], p_units[g, :c])
    payload = WK._assemble(len(data), units, counts, sizes, max_bits)
    assert payload == W.wide_encode(data, n_lanes=WK.LANES,
                                    balanced=sizes is not None, rans=False)


def test_decode_v2_kernel_equals_plain_and_input(cuda, case):
    data, _, sizes, _ = case
    payload = W.wide_encode(data, n_lanes=WK.LANES,
                            balanced=sizes is not None, rans=False)
    parsed = WK._dec_parse(payload)
    assert not parsed["rans"]
    args = WK._dec_args(parsed, cuda)
    before = dict(WK.LAUNCHES)
    ours = WK.decode_lanes(*args, rans=False)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["wide_decode_v2"] == before["wide_decode_v2"] + 1
    assert WK.LAUNCHES["wide_decode"] == before["wide_decode"]
    assert torch.equal(ours, WK.decode_lanes_plain(*args, rans=False))
    assert ours.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("rans", [True, False])
@pytest.mark.parametrize("case", ["random", "zeros", "skewed"])
def test_decode_kernels_on_hard_blocks(cuda, case, rans):
    """chip_smoke.py's hard decode blocks: ranks up to 255 with group
    rings that wrap many times, runs over 2^16 bytes, a skewed table with
    an empty group and dead lanes."""
    from chip_smoke import hard_blocks

    data, sizes = hard_blocks(_text(1 << 20, 45))[case]
    payload = W.wide_encode(data, n_lanes=WK.LANES, sizes=sizes, rans=rans)
    args = WK._dec_args(WK._dec_parse(payload), cuda)
    name = "wide_decode" if rans else "wide_decode_v2"
    before = WK.LAUNCHES[name]
    ours = WK.decode_lanes(*args, rans=rans)
    torch.cuda.synchronize()
    assert WK.LAUNCHES[name] == before + 1
    assert torch.equal(ours, WK.decode_lanes_plain(*args, rans=rans))
    assert ours.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("case", ["random", "zeros", "skewed"])
def test_encode_kernels_on_hard_blocks(cuda, case):
    """K1 + K2 and K5 on chip_smoke.py's hard blocks, each with its own
    lane table: ranks up to 255, runs over 2^16 bytes, a skewed table with
    an empty group and dead lanes.  The payloads are the native codec's
    and decode on the card; on the skewed block the kernels equal their
    plain versions."""
    from chip_smoke import hard_blocks, lane_planes

    data, sizes = hard_blocks(_text(1 << 20, 45))[case]
    planes, sizes, max_bits = lane_planes(data, sizes)
    planes = torch.from_numpy(planes).to(cuda)
    before = dict(WK.LAUNCHES)
    probs = WK.model_probs(planes, max_bits)
    k2 = WK.rans_encode(planes, probs, max_bits)
    k5 = WK.rc_encode(planes, max_bits)
    torch.cuda.synchronize()
    for name in ("wide_model", "wide_rans", "wide_rc_encode"):
        assert WK.LAUNCHES[name] == before[name] + 1
    n = len(data)
    for rans, payload in ((True, WK._assemble_rans(n, *k2, sizes, max_bits)),
                          (False, WK._assemble(n, *k5, sizes, max_bits))):
        assert payload == W.wide_encode(data, n_lanes=WK.LANES,
                                        balanced=sizes is not None,
                                        rans=rans, sizes=sizes)
        assert WK.device_decode(payload, cuda) == data
    if case == "skewed":
        assert torch.equal(probs, WK.model_probs_plain(planes, max_bits))
        p_units, p_counts = WK.rc_encode_plain(planes, max_bits,
                                               k5[0].shape[1])
        assert torch.equal(k5[1], p_counts)
        for g, c in enumerate(k5[1].tolist()):
            assert torch.equal(k5[0][g, :c], p_units[g, :c])


_V3 = ("wide_model", "wide_rans", "wide_decode")
_V2 = ("wide_rc_encode", "wide_decode_v2")


@pytest.mark.parametrize("rans", [True, False])
def test_fused_route_goes_through_the_kernels(cuda, monkeypatch, rans):
    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")
    monkeypatch.setattr(WK, "RANS", rans)
    data = _text(3 << 19, 1536)
    feats = C.FEATURE_FASTMODE | C.FEATURE_CUDA
    P.init(feats, device=cuda)
    WK.reset_launches()
    blob = P.compress(data, block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                      coder=C.CODER_QLFC_WIDE)
    assert P.decompress(blob) == data
    ran, idle = (_V3, _V2) if rans else (_V2, _V3)
    assert all(WK.LAUNCHES[k] == 1 for k in ran)
    assert all(WK.LAUNCHES[k] == 0 for k in idle)
    # the resident payload is the native codec's with the device table
    native.load()
    U = torch.from_numpy(np.frombuffer(data[:1 << 20], np.uint8).copy())
    U = U.to(cuda)
    sizes = WS.device_balanced_sizes(U, WK.LANES).cpu().numpy()
    assert WK.device_encode_resident(U) == W.wide_encode(
        U.cpu().numpy().tobytes(), n_lanes=WK.LANES, sizes=sizes, rans=rans)
    P.init(C.FEATURE_FASTMODE, device=cuda)  # host stages only
    assert P.decompress(blob) == data


def test_many_block_entry_points(cuda):
    datas = [_runs(1024 * 40, s) for s in (1, 2, 3)] + [b"ab" * 300]
    payloads = WK.device_encode_many(datas, cuda)
    assert payloads[:3] == [WK.device_encode(d, cuda) for d in datas[:3]]
    assert payloads[3] is None
    blocks = WK.device_decode_many(payloads[:3] + [b"\0" * 16], cuda)
    assert blocks == datas[:3] + [None]


def _hist_and_adler_inputs(cuda):
    g = np.random.default_rng(6)
    d = torch.from_numpy(g.integers(0, 256, 300_007, np.uint8)).to(cuda)
    return {"random": d, "zeros": torch.zeros(262_144, dtype=torch.uint8,
                                              device=cuda),
            "offset": d[3:3 + 200_001], "short": d[5:18],
            "runs": torch.from_numpy(np.frombuffer(_runs(100_000, 7), np.uint8)
                                     .copy()).to(cuda)}


def test_byte_hist_kernel_equals_plain_and_bincount(cuda):
    for name, d in _hist_and_adler_inputs(cuda).items():
        before = S.LAUNCHES["byte_hist"]
        ours = S.byte_histogram(d)
        torch.cuda.synchronize()
        assert S.LAUNCHES["byte_hist"] == before + 1, name
        assert torch.equal(ours, S.byte_histogram_plain(d)), name
        assert torch.equal(ours.long(), torch.bincount(d.long(),
                                                       minlength=256)), name
    empty = torch.zeros(0, dtype=torch.uint8, device=cuda)
    assert int(S.byte_histogram(empty).sum()) == 0


def _hist_agrees(d, name):
    before = S.LAUNCHES["byte_hist"]
    ours = S.byte_histogram(d)
    torch.cuda.synchronize()
    assert S.LAUNCHES["byte_hist"] == before + 1, name
    assert torch.equal(ours, S.byte_histogram_plain(d)), name
    assert torch.equal(ours.long(), torch.bincount(d.long(),
                                                   minlength=256)), name


def test_byte_hist_kernel_on_skewed_and_cyclic_bytes(cuda):
    """Every lane of a warp on one bin (zeros), every bin in turn (a
    0..255 cycle), and uniform random bytes."""
    n = (1 << 20) + 7
    g = np.random.default_rng(66)
    cases = {"zeros": torch.zeros(n, dtype=torch.uint8, device=cuda),
             "cycle": (torch.arange(n, device=cuda) % 256).to(torch.uint8),
             "random": torch.from_numpy(g.integers(0, 256, n, np.uint8))
             .to(cuda)}
    for name, d in cases.items():
        _hist_agrees(d, name)


@pytest.mark.parametrize("offset", range(1, 16))
def test_byte_hist_kernel_on_views_at_an_offset(cuda, offset):
    """A shard is a view at any byte offset: lengths 1-15 (no whole
    16-byte word) and 1 MiB + 7."""
    g = np.random.default_rng(offset)
    d = torch.from_numpy(g.integers(0, 256, (1 << 20) + 64, np.uint8)) \
        .to(cuda)
    for length in list(range(1, 16)) + [(1 << 20) + 7]:
        _hist_agrees(d[offset:offset + length], f"{offset}+{length}")


def test_adler_partials_kernel_equals_plain_and_zlib(cuda):
    import zlib

    for name, d in _hist_and_adler_inputs(cuda).items():
        before = S.LAUNCHES["adler_partials"]
        ours = S._adler_partials(d)
        torch.cuda.synchronize()
        assert S.LAUNCHES["adler_partials"] == before + 1, name
        assert torch.equal(ours, S._adler_partials_plain(d)), name
        host = d.cpu().numpy().tobytes()
        assert S.adler32_device(d) == zlib.adler32(host), name
        assert S.adler32_device(d, 0x9ABCDEF1) == \
            zlib.adler32(host, 0x9ABCDEF1), name


@pytest.mark.parametrize("sorter", ["st", "bwt"])
def test_transform_step_on_one_gpu(cuda, sorter):
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.parallel import (make_mesh, make_transform_step,
                                           shard, unshard)

    native.load()
    n = 2 * S._HIST_TILE  # K6 takes shards this large
    blocks = np.stack([np.frombuffer(_text(n, 90 + i), np.uint8)
                       for i in range(2)])
    mesh = make_mesh(1)
    S.reset_launches()
    out, idx, hist = make_transform_step(mesh, sorter=sorter, k=5)(
        shard(torch.from_numpy(blocks), mesh))
    torch.cuda.synchronize()
    assert S.LAUNCHES["byte_hist"] == 2
    out, idx, hist = unshard(out), unshard(idx), unshard(hist)
    for b in range(2):
        ref = blocks[b].copy()
        if sorter == "st":
            ref_idx = engine.st_encode(ref, 5, 0)
        else:
            ref_idx = engine.bwt_encode(ref, 0)[0]
        assert out[b].numpy().tobytes() == ref.tobytes()
        assert int(idx[b]) == ref_idx
        assert np.array_equal(hist[b].numpy(),
                              np.bincount(blocks[b], minlength=256))


def test_st_device_route_writes_the_host_archive(cuda):
    data = _text((1 << 20) + 777, 33)
    kw = dict(lzp_hash_size=0, lzp_min_len=0,
              block_sorter=C.BLOCKSORTER_ST5, coder=C.CODER_QLFC_STATIC)
    P.init(C.FEATURE_FASTMODE | C.FEATURE_CUDA, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blob = P.compress(data, **kw)
    assert torch.cuda.max_memory_allocated() > 0  # the sort ran there
    assert P.decompress(blob) == data
    P.init(C.FEATURE_FASTMODE, device=cuda)
    assert P.compress(data, **kw) == blob


def _entries(path) -> dict:
    """Container entries: block offset -> (record size, contexts, block)."""
    import struct

    from libbsc_tpu_torch import cli

    raw = open(path, "rb").read()
    off, out = 8, {}
    while off < len(raw):
        boff, rs, ctx = struct.unpack_from(cli.BLOCK_HEADER_FMT, raw, off)
        off += cli.BLOCK_HEADER_SIZE
        (csz,) = struct.unpack_from("<i", raw, off)
        out[boff] = (rs, ctx, raw[off:off + csz])
        off += csz
    return out


def test_cli_m9_e4_gpu_round_trip(cuda, tmp_path):
    """A 6 MiB file through the CLI's -m9 -e4 -G farm: K1 and K2 encode
    it, K3 decodes it, and the host route decodes the archive too."""
    from libbsc_tpu_torch import cli

    data = _text(6 << 20, 66)
    inp, arch, back = tmp_path / "in", tmp_path / "a.bsc", tmp_path / "r"
    inp.write_bytes(data)
    p = cli.parse_args(["x", "e", "a", "b", "-m9e4G"])
    WK.reset_launches()
    cli.compress_file(str(inp), str(arch), p, quiet=True)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["wide_model"] > 0 and WK.LAUNCHES["wide_rans"] > 0
    cli.decompress_file(str(arch), str(back), p, quiet=True)
    torch.cuda.synchronize()
    assert WK.LAUNCHES["wide_decode"] > 0
    assert back.read_bytes() == data
    back.unlink()
    cli.decompress_file(str(arch), str(back), cli.Params(), quiet=True)
    assert back.read_bytes() == data


def test_cli_gpu_default_config_entries_equal_host(cuda, tmp_path):
    """-G on the default config: the farm's device workers sort 2 MiB
    blocks on the card, and every container entry equals the host's."""
    import os

    from libbsc_tpu_torch import cli, engine

    data = _text(3 * (2 << 20) + 4321, 67)
    inp = tmp_path / "in"
    inp.write_bytes(data)
    p = cli.parse_args(["x", "e", "a", "b", "-b2"])
    cli.compress_file(str(inp), str(tmp_path / "host.bsc"), p, quiet=True)
    q = cli.parse_args(["x", "e", "a", "b", "-b2G"])
    before = engine.DEVICE_ROUTES["bwt_encode"]
    prior = os.environ.get("TBSC_BWT_DEVICE")
    cli.compress_file(str(inp), str(tmp_path / "dev.bsc"), q, quiet=True)
    assert engine.DEVICE_ROUTES["bwt_encode"] > before
    assert os.environ.get("TBSC_BWT_DEVICE") == prior
    assert _entries(tmp_path / "dev.bsc") == _entries(tmp_path / "host.bsc")
    back = tmp_path / "r"
    cli.decompress_file(str(tmp_path / "dev.bsc"), str(back), q, quiet=True)
    assert back.read_bytes() == data


@pytest.mark.parametrize("k", [5, 8])
def test_sharded_st_step_on_one_gpu_twice(cuda, k):
    """The sample-sort ST step on a (1, 2) mesh that lists cuda:0 twice
    equals the native ST of the whole block, with ok True."""
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.parallel import (make_mesh, make_sharded_st_step,
                                           shard, unshard)

    data = np.frombuffer(_text(2 << 20, 68), np.uint8)
    mesh = make_mesh(2, dp=1, sp=2, devices=[cuda] * 2)
    out, idx, ok = make_sharded_st_step(mesh, k=k)(
        shard(torch.from_numpy(data[None].copy()), mesh))
    assert out[0][0].device == cuda and bool(unshard(ok).all())
    ref = data.copy()
    index = engine.st_encode(ref, k, C.FEATURE_MULTITHREADING)
    assert unshard(out)[0].numpy().tobytes() == ref.tobytes()
    assert int(unshard(idx)[0]) == index


def test_dc3_bwt_equals_native_at_1_mib(cuda):
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt

    data = np.frombuffer(_text(1 << 20, 69), np.uint8).copy()
    U, primary, aux = bwt.bwt_encode_dc3(torch.from_numpy(data).to(cuda))
    ref = data.copy()
    ref_primary, ni, ref_aux = engine.bwt_encode(ref, C.FEATURE_MULTITHREADING)
    assert U.cpu().numpy().tobytes() == ref.tobytes()
    assert int(primary) == ref_primary
    assert np.array_equal(aux.cpu().numpy(), ref_aux[:ni])
