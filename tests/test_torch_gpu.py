"""The CUDA kernels K1-K14 against their plain PyTorch versions on the card,
at small size, the fused -m9 -e4 -G route through them (v3 and v2 coder),
the pipelined many-block entry points, the sharded transform step on a
one-GPU mesh (K6 in its stage 1), the -m5 -G device ST route, the
CLI: -m9 -e4 -G through K1, K2 and K3, and the -G default config through
the device BWT from the farm and from -G -t's pool, the sample-sort ST
step on a mesh that lists cuda:0 twice, the DC3 device BWT, the list-ranking inverse BWT (on cuda against
its CPU run at 4 MiB, and through the API under TBSC_ENGINE=ops) and the
lockstep range coder against the serial reference; the host buffer
pool's page-locked slots on the fused route; K8 (the wide-aux
inverse BWT: its chase at any rate, its table kernel), K9 and K10 (the
bit schedule) on its edge block, the hard blocks and their batch and tile
edges, their launches on the fused route, and the v1 schedule
(TBSC_WIDE_DEV_SCHED) through them against the native walker; K11-K14
(the forward BWT's sort) on the hard blocks and at their tile edges, and
every forward BWT route through them with no plain version, cummax or
shifted copy; -G encodes that read each block once, into the
page-locked read ring the API uploads from with no copy of its own; and
-b25 -m5 -G through the farm, its 25 MiB block sorted on the card, each
entry the benchmark reference's block.

These tests need a CUDA device and skip without one.  tests/conftest.py
imports JAX, which a GPU machine need not have, so run them there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

All comparisons are exact: the codec is lossless.
"""

import threading

import numpy as np
import pytest
import torch

import libbsc_tpu_torch as P
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import native
from libbsc_tpu_torch.ops import bwt as BW
from libbsc_tpu_torch.ops import wide as W
from libbsc_tpu_torch.ops import wide_kernels as WK
from libbsc_tpu_torch.ops import wide_schedule as WS
from libbsc_tpu_torch.ops import stats_kernels as S
from libbsc_tpu_torch.utils import bufpool

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
    env = dict(os.environ)
    cli.compress_file(str(inp), str(tmp_path / "dev.bsc"), q, quiet=True)
    assert engine.DEVICE_ROUTES["bwt_encode"] > before
    assert dict(os.environ) == env  # never written
    assert _entries(tmp_path / "dev.bsc") == _entries(tmp_path / "host.bsc")
    back = tmp_path / "r"
    cli.decompress_file(str(tmp_path / "dev.bsc"), str(back), q, quiet=True)
    assert back.read_bytes() == data


def test_cli_gpu_t_sorts_every_block_on_the_card(cuda, tmp_path,
                                                 monkeypatch):
    """-b2 -G -t: no farm, a thread pool of workers that each carry
    FEATURE_CUDA, so every block of 1 MiB or more sorts on the card
    (DEVICE_ROUTES, K11-K14 launched), with no opt-in; every container
    entry equals the host's."""
    from libbsc_tpu_torch import cli, engine

    data = _text(3 * (2 << 20) + 4321, 68)
    inp = tmp_path / "in"
    inp.write_bytes(data)
    sizes = []
    sort = engine.bwt_encode

    def spy(block, *a, **k):
        sizes.append(len(block))
        return sort(block, *a, **k)

    monkeypatch.setattr(engine, "bwt_encode", spy)
    p = cli.parse_args(["x", "e", "a", "b", "-b2"])
    cli.compress_file(str(inp), str(tmp_path / "host.bsc"), p, quiet=True)
    big = sum(n >= 1 << 20 for n in sizes)  # LZP'd blocks of 1 MiB or more
    assert big > 0
    q = cli.parse_args(["x", "e", "a", "b", "-b2Gt"])
    assert not q.parallel
    before = engine.DEVICE_ROUTES["bwt_encode"]
    launches = {k: BW.LAUNCHES[k] for k in _SORT}
    cli.compress_file(str(inp), str(tmp_path / "dev.bsc"), q, quiet=True)
    torch.cuda.synchronize()
    assert engine.DEVICE_ROUTES["bwt_encode"] == before + big
    assert all(BW.LAUNCHES[k] > launches[k] for k in _SORT
               if k != "bwt_round_keys")
    assert _entries(tmp_path / "dev.bsc") == _entries(tmp_path / "host.bsc")


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


def test_list_ranking_on_cuda_equals_cpu_at_4_mib(cuda):
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt

    data = np.frombuffer(_text(4 << 20, 70), np.uint8).copy()
    U = data.copy()
    primary, _, _ = engine.bwt_encode(U, C.FEATURE_MULTITHREADING)
    on_card = bwt.bwt_decode(torch.from_numpy(U).to(cuda), primary)
    assert on_card.device == cuda
    on_cpu = bwt.bwt_decode(torch.from_numpy(U), primary)
    assert torch.equal(on_card.cpu(), on_cpu)
    assert on_cpu.numpy().tobytes() == data.tobytes()
    junk = bwt.bwt_decode(torch.from_numpy(U[::-1].copy()).to(cuda), 7)
    torch.cuda.synchronize()  # a non-BWT: no device-side assert
    assert junk.shape == on_card.shape


def test_ops_engine_on_cuda_counts_both_bwt_routes(cuda, monkeypatch):
    from libbsc_tpu_torch import engine

    data = _text((1 << 20) + 4321, 71)
    P.init(C.DEFAULT_FEATURES, device=cuda)
    host = P.compress(data)
    monkeypatch.setattr(engine, "_force", "ops")
    before = dict(engine.DEVICE_ROUTES)
    archive = P.compress(data, lzp_hash_size=0, lzp_min_len=0)
    assert P.decompress(archive) == data
    assert engine.DEVICE_ROUTES["bwt_encode"] == before["bwt_encode"] + 1
    assert engine.DEVICE_ROUTES["bwt_decode"] == before["bwt_decode"] + 1
    assert P.compress(data) == host  # the ops archive is the host's


def test_wide_rc_on_cuda_equals_the_serial_reference(cuda):
    from libbsc_tpu_torch.fallback.qlfc import RcEncoder
    from libbsc_tpu_torch.ops import wide_rc

    g = np.random.default_rng(72)
    lanes = [[(int(g.integers(0, 2)), int(g.integers(1, 4095)), 12)
              for _ in range(int(g.integers(1, 500)))] for _ in range(64)]
    streams = wide_rc.encode(lanes, device=cuda)
    for seq, stream in zip(lanes, streams):
        rc = RcEncoder(1 << 20)
        for b, p, prec in seq:
            rc.encode(b, p, prec)
        assert stream == rc.finish()
    probs = [[(p, prec) for _, p, prec in seq] for seq in lanes]
    bits = wide_rc.decode(probs, streams, device=cuda)
    assert bits == [[b for b, _, _ in seq] for seq in lanes]


_SCAN = ("sched_events", "sched_planes", "unbwt_table", "unbwt_chase")


def _scan_launches() -> dict:
    return {k: v for k, v in {**BW.LAUNCHES, **WS.LAUNCHES}.items()
            if k in _SCAN}


@pytest.mark.parametrize("case", ["edges", "random", "zeros", "skewed"])
def test_scan_kernels_equal_plain_on_hard_blocks(cuda, case):
    """K8 (table and chase), K9 and K10 against their plain versions through
    chip_smoke.check_scan (also: K10's planes against the native walker's
    for the same lane table, K8's chase against the block) on the
    schedule's edge block (an empty lane, a one-run lane, all 256 byte
    values, runs across lane starts, dead lanes) and the hard blocks."""
    from chip_smoke import check_scan, edge_block, hard_blocks, lane_planes

    if case == "edges":
        data, sizes = edge_block()
    else:
        data, sizes = hard_blocks(_text(1 << 20, 45))[case]
        if sizes is None:
            sizes = lane_planes(data, None)[1]
    if sizes is None:
        sizes = np.asarray(W.lane_sizes(len(data), WK.LANES), np.int32)
    before = _scan_launches()
    err = check_scan(case, np.frombuffer(data, np.uint8), sizes, cuda)
    torch.cuda.synchronize()
    assert err == dict.fromkeys(_SCAN, 0)
    assert all(_scan_launches()[k] == before[k] + 1 for k in _SCAN)


@pytest.mark.parametrize("case", ["runs_1", "runs_31", "runs_32", "runs_33",
                                  "runs_64", "runs_512", "runs_513",
                                  "recur_3", "carry_over", "all_256",
                                  "same_byte_at_lane_start", "empty_lane"])
def test_schedule_kernels_on_batch_edges(cuda, case):
    """K9 and K10 on their batch and tile edges (chip_smoke.batch_edges,
    laid on 1024 lanes), against their plain versions and the native
    walker's planes through chip_smoke.check_schedule, once each."""
    from chip_smoke import batch_edges, check_schedule, lay_lanes

    data, sizes = lay_lanes(batch_edges()[case], WK.LANES)
    before = _scan_launches()
    err, _, _ = check_schedule(case, np.frombuffer(data, np.uint8), sizes,
                               cuda)
    torch.cuda.synchronize()
    assert err == {"sched_events": 0, "sched_planes": 0}
    assert all(_scan_launches()[k] == before[k] + 1 for k in _SCAN[:2])


@pytest.mark.parametrize("r", [1, 100, 256, 1000, 4096])
def test_chase_kernel_at_any_rate(cuda, r):
    """K8's chase with 16-byte stores (r a multiple of 16) and a byte a
    step (other r), n = 37 r - 1, 37 r and 37 r + 1."""
    for n in (37 * r - 1, 37 * r, 37 * r + 1):
        data = _text(n, r + n)
        d = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
        U, primary, aux = BW.bwt_encode_wideaux_device(d, r)
        pairs, ends, heads = BW.chase_inputs(U, int(primary), aux)
        before = BW.LAUNCHES["unbwt_chase"]
        out = BW.chase(pairs, ends, heads, r, n)
        torch.cuda.synchronize()
        assert BW.LAUNCHES["unbwt_chase"] == before + 1
        assert torch.equal(out, BW.chase_plain(pairs, ends, heads, r, n))
        assert out.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("r", [1, 100, 256, 4096])
def test_table_kernel_equals_plain(cuda, r):
    """K8's table kernel against its plain version (and its CPU run) at
    n = 37 r - 1, 37 r and 37 r + 1, and on a block of all 256 byte
    values (every bucket's char in the table); the launch counter rises
    by one a call."""
    g = np.random.default_rng(r)
    all256 = np.repeat(np.arange(256, dtype=np.uint8), 3 + r // 64)
    g.shuffle(all256)
    blocks = [np.frombuffer(_text(n, 7 * r + n), np.uint8)
              for n in (37 * r - 1, 37 * r, 37 * r + 1)] + [all256]
    for data in blocks:
        d = torch.from_numpy(data.copy()).to(cuda)
        U, primary, _ = BW.bwt_encode_wideaux_device(d, r)
        chars, u_sorted = torch.sort(U, stable=True)
        ends = BW.bucket_ends(chars)
        before = BW.LAUNCHES["unbwt_table"]
        pairs = BW.pair_table(u_sorted, int(primary), ends)
        torch.cuda.synchronize()
        assert BW.LAUNCHES["unbwt_table"] == before + 1
        assert torch.equal(pairs, BW.pair_table_plain(u_sorted, int(primary),
                                                      ends))
        assert torch.equal(pairs.cpu(), BW.pair_table(
            u_sorted.cpu(), int(primary), ends.cpu()))


def test_fused_route_launches_k8_to_k10_once(cuda, monkeypatch):
    """-m9 -e4 -G: K9 and K10 once in the encode, K8 once in the
    decode."""
    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")
    data = _text(3 << 19, 1536)
    P.init(C.FEATURE_FASTMODE | C.FEATURE_CUDA, device=cuda)
    BW.reset_launches()
    WS.reset_launches()
    blob = P.compress(data, block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                      coder=C.CODER_QLFC_WIDE)
    assert _scan_launches() == {"unbwt_table": 0, "unbwt_chase": 0,
                                "sched_events": 1, "sched_planes": 1}
    BW.reset_launches()
    WS.reset_launches()
    assert P.decompress(blob) == data
    assert _scan_launches() == {"unbwt_table": 1, "unbwt_chase": 1,
                                "sched_events": 0, "sched_planes": 0}


def test_v1_schedule_through_k9_k10_equals_native(cuda, monkeypatch):
    """device_schedule (v1) on the card: the edge block's planes equal the
    native walker's; TBSC_WIDE_DEV_SCHED's per-stage prep on a text block
    equals the native route's, through K9 and K10."""
    from chip_smoke import edge_block, lane_planes

    data, sizes = edge_block()
    WS.reset_launches()
    planes, mb = WS.device_schedule(
        torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda),
        sizes, WK.LANES, it_bucket=lambda m: WK._it_bucket(max(m, WK.TI)))
    native_planes, _, native_mb = lane_planes(data, sizes)
    assert mb == native_mb
    assert np.array_equal(planes.t().cpu().numpy(), native_planes)
    text = _text(600_000, 61)
    host = WK._host_prep(text, cuda)
    monkeypatch.setenv("TBSC_WIDE_DEV_SCHED", "1")
    dev = WK._host_prep(text, cuda)
    assert np.array_equal(dev[0].cpu().numpy(), host[0])
    assert dev[2:] == host[2:]
    assert WS.LAUNCHES == {"sched_events": 2, "sched_planes": 2}


_FUSED = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX, coder=C.CODER_QLFC_WIDE)


def _pinned_slots() -> dict:
    return {k[0]: v for k, v in bufpool.slots().items() if k[1]}


def test_fused_route_slots_are_page_locked_and_stay(cuda, monkeypatch):
    """-m9 -e4 -G on a 4 MiB block: the "compress_lz" slot (the H2D's
    source) and decompress's "decompress_lz" slot (the D2H's destination)
    are page-locked and keep their addresses across three warm calls, each
    of which gives the same archive and the same bytes."""
    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")
    data = _text(4 << 20, 404)
    P.init(C.FEATURE_FASTMODE | C.FEATURE_CUDA, device=cuda)
    WK.reset_launches()
    blob = P.compress(data, **_FUSED)
    assert P.decompress(blob) == data
    assert WK.LAUNCHES["wide_model"] == 1 and WK.LAUNCHES["wide_decode"] == 1
    slots = _pinned_slots()
    assert sorted(slots) == ["compress_lz", "decompress_lz"]
    assert all(torch.from_numpy(v).is_pinned() for v in slots.values())
    addrs = {k: v.ctypes.data for k, v in slots.items()}
    for _ in range(3):
        assert P.compress(data, **_FUSED) == blob
        assert P.decompress(blob) == data
        assert {k: v.ctypes.data for k, v in _pinned_slots().items()} \
            == addrs


def test_decompress_batch_keeps_fresh_buffers_on_cuda(cuda, monkeypatch):
    """decompress_batch on the card returns each block and draws no slot
    from the pool (it holds several blocks at once)."""
    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")
    blocks = [_text(3 << 19, 77), _runs(200_000, 78), _text(300_000, 79)]
    P.init(C.FEATURE_FASTMODE | C.FEATURE_CUDA, device=cuda)
    blobs = [P.compress(blocks[0], **_FUSED), P.compress(blocks[1]),
             P.compress(blocks[2], block_sorter=C.BLOCKSORTER_ST5)]
    box = {}

    def run():
        box["out"] = P.decompress_batch(blobs)
        box["slots"] = bufpool.slots()

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=300)
    assert not th.is_alive()
    assert box["out"] == blocks and box["slots"] == {}
    assert [P.decompress(b) for b in blobs] == blocks


_SORT = ("bwt_boot_keys", "bwt_round_keys", "bwt_heads_pay", "bwt_heads",
         "bwt_extract_bins", "bwt_extract")


@pytest.mark.parametrize("case", ["text", "zeros", "periodic",
                                  "high-entropy", "2", "3", "17", "255",
                                  "1023", "1025", "2047", "2049", "4096",
                                  "8193", "65537", "208953"])
def test_sort_kernels_equal_plain_and_native(cuda, case):
    """K11-K14 on one block through chip_smoke.check_sort: every kernel
    call of the wide-aux BWT and of DC3 held to its plain version on the
    same inputs, U, the primary and the aux indexes to the native BWT's;
    K13's tile is 1,024 rows, K11's block 2,048, K14's pass-1 block 8,192
    and its bucket 65,536 slots."""
    from chip_smoke import check_sort, hard_blocks, periodic_block

    text = _text(1 << 20, 1400)
    blocks = {"text": text, "zeros": bytes(300_000),
              "periodic": periodic_block(300_000),
              "high-entropy": hard_blocks(text)["random"][0]}
    data = blocks.get(case) or text[:int(case)]
    before = {k: BW.LAUNCHES[k] for k in _SORT}
    err = check_sort(case, np.frombuffer(data, np.uint8), cuda)
    torch.cuda.synchronize()
    assert err == dict.fromkeys(_SORT, 0)
    assert all(BW.LAUNCHES[k] > before[k] for k in _SORT
               if k != "bwt_round_keys")


def test_forward_bwt_routes_launch_only_the_kernels(cuda, monkeypatch):
    """bwt_encode, bwt_encode_wideaux_device, bwt_encode_dc3, suffix_array
    and the transform step's batch_bwt_encode on the card with every plain
    version, torch.cummax and _shifted made to raise: each equals the
    native BWT, and K11-K14 launch."""
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.parallel import pipeline

    def refuse(*a, **k):
        raise AssertionError("a plain step ran on the card")

    for name in ("boot_keys_plain", "round_keys_plain", "heads_pay_plain",
                 "heads_full_plain", "heads_compact_plain", "extract_plain",
                 "extract_bins_plain", "extract_place_plain", "_shifted"):
        monkeypatch.setattr(BW, name, refuse)
    monkeypatch.setattr(torch, "cummax", refuse)
    data = _text(300_000, 1401)
    d = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    ref = np.frombuffer(data, np.uint8).copy()
    primary, ni, idx = engine.bwt_encode(ref, 0)
    before = {k: BW.LAUNCHES[k] for k in _SORT}
    for fn in (BW.bwt_encode, BW.bwt_encode_dc3,
               lambda x: pipeline.batch_bwt_encode(x[None])):
        U, p, aux = fn(d)
        assert U.reshape(-1).cpu().numpy().tobytes() == ref.tobytes()
        assert int(p.reshape(-1)[0]) == primary
        np.testing.assert_array_equal(aux.reshape(-1).cpu().numpy(),
                                      idx[:ni])
    r = engine.wideaux_rate(len(data))
    U, p, aux = BW.bwt_encode_wideaux_device(d, r)
    ref = np.frombuffer(data, np.uint8).copy()
    k = (len(data) - 1) // r
    idx = np.zeros(k, np.int32)
    assert int(p) == native.load().tbsc_bwt_encode_rate(
        native.u8p(ref), len(data), r, native.i32p(idx))
    assert U.cpu().numpy().tobytes() == ref.tobytes()
    np.testing.assert_array_equal(aux.cpu().numpy(), idx)
    sa, rank = BW.suffix_array(d)
    assert torch.equal(sa[rank], torch.arange(len(data), device=cuda))
    assert all(BW.LAUNCHES[k] >= before[k] + 4 for k in _SORT
               if k != "bwt_round_keys")


def test_sort_wrappers_hold_their_scratch_through_the_launch(cuda,
                                                             monkeypatch):
    """K13's and K14's wrappers zero their scratch (status words, tile
    counter, count, cursors) with torch and hold it until the kernel is
    queued.  Freed before, its memory could go to a tensor that another
    thread (the CLI's device workers share the stream) fills before the
    launch.  Here every launch is preceded by such tensors, of each
    scratch's size, filled with words that read as final status or as a
    cursor: the BWTs must still equal the native ones."""
    from libbsc_tpu_torch import engine

    launch = BW._launch

    rows_at = {"bwt_heads_pay": 4, "bwt_heads": 4, "bwt_extract_bins": 2}

    def crowded(name, dev, *args):
        if name not in rows_at:
            return launch(name, dev, *args)
        m = args[rows_at[name]]
        tiles = -(-m // 1024)
        junk = [torch.full((k,), -(1 << 63), dtype=torch.int64, device=dev)
                for k in (tiles + 2, 2 * tiles + 2)]
        junk.append(torch.full((-(-m // (1 << 16)),), 4096,
                               dtype=torch.int32, device=dev))
        launch(name, dev, *args)
        del junk

    monkeypatch.setattr(BW, "_launch", crowded)
    data = _text(300_000, 1402)
    d = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(cuda)
    ref = np.frombuffer(data, np.uint8).copy()
    primary, ni, idx = engine.bwt_encode(ref, 0)
    for fn in (BW.bwt_encode, BW.bwt_encode_dc3):
        U, p, aux = fn(d)
        assert U.cpu().numpy().tobytes() == ref.tobytes()
        assert int(p) == primary
        np.testing.assert_array_equal(aux.cpu().numpy(), idx[:ni])


def _k16_block(kind: str, n: int) -> np.ndarray:
    g = np.random.default_rng(1600 + n)
    if kind == "text":
        return np.frombuffer(_text(n, 1601), np.uint8).copy()
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "periodic":
        return np.resize(g.integers(0, 256, 1000, dtype=np.uint8), n)
    return g.integers(0, 256, n, dtype=np.uint8)


def _k16_steps(U, primary: int, aux, out=None):
    """K16's four launches on U (on the card), and each step's plain
    version on the kernels' own inputs: (kernel results, plain results),
    each (pairs, succ, gap, dist, out, status)."""
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    n = int(U.shape[0])
    rows, offs = K16.start_rows(n, primary, aux)
    srows = torch.from_numpy(rows).to(U.device)
    offsets = torch.from_numpy(offs).to(U.device)
    chars, u_sorted = torch.sort(U, stable=True)
    ends = BW.bucket_ends(chars)
    K16.reset_launches()
    pairs = K16.table(u_sorted, primary, ends, srows)
    succ, gap = K16.gaps(pairs, n, srows)
    rsucc, dist = K16.rank(succ, gap)
    got, status = K16.write(pairs, ends, n, srows, offsets, rsucc, dist,
                            gap, out=out)
    torch.cuda.synchronize()
    # the ranking's C call reports its rounds, ceil(log2 nodes)
    rounds = (int(succ.shape[0]) - 1).bit_length()
    assert K16.LAUNCHES == {"rulers_table": 1, "rulers_gaps": 1,
                            "rulers_rank": rounds, "rulers_write": 1}
    plain = (K16.table_plain(u_sorted, primary, ends, srows),
             *K16.gaps_plain(pairs, n, srows))
    plain += K16.rank_plain(succ, gap)
    plain += K16.write_plain(pairs, ends, n, srows, offsets, rsucc, dist,
                             gap)
    kernel = (pairs, succ, gap, rsucc, dist, got, status)
    return kernel, plain


@pytest.mark.parametrize("kind", ["text", "zeros", "periodic", "random"])
def test_k16_equals_plain_and_native_at_25_mib(cuda, kind):
    """K16 on a 25 MiB block of each kind (the device BWT's U, primary
    and aux indexes): each of its four kernels equals its plain version
    on the same inputs, the block comes back with status 0, and the
    native inverse gives the same bytes."""
    from libbsc_tpu_torch import engine

    data = _k16_block(kind, 25 << 20)
    U, primary, aux = BW.bwt_encode(torch.from_numpy(data).to(cuda))
    primary, aux = int(primary), aux.cpu().numpy()
    kernel, plain = _k16_steps(U, primary, aux)
    for got, want in zip(kernel, plain):
        assert torch.equal(got.cpu(), want.cpu().to(got.dtype))
    assert int(kernel[-1]) == 0
    assert kernel[-2].cpu().numpy().tobytes() == data.tobytes()
    back = U.cpu().numpy()
    assert engine.bwt_decode(back, primary, len(aux), aux,
                             C.FEATURE_MULTITHREADING) == 0
    assert back.tobytes() == data.tobytes()


@pytest.mark.parametrize("case", ["random", "swapped"])
def test_k16_on_a_non_bwt_ends_inside_the_block(cuda, case):
    """Bytes that are no BWT, each start row valid (random bytes, primary
    1234; a real 4 MiB BWT with two bytes swapped, with its aux indexes):
    K16 ends, writes nothing outside [0, n) (guard bytes on both sides of
    its output), reports status 1 and equals its plain version; the
    engine's device route returns DATA_CORRUPT."""
    from libbsc_tpu_torch import engine

    n = 4 << 20
    if case == "random":
        U, primary, aux = _k16_block("random", n), 1234, None
    else:
        U = _k16_block("text", n)
        primary, ni, aux = engine.bwt_encode(U, C.FEATURE_MULTITHREADING)
        aux = aux[:ni]
        i = int(np.argmax(U != U[0]))
        U[[0, i]] = U[[i, 0]]
    guarded = torch.full((n + 1024,), 0xA5, dtype=torch.uint8, device=cuda)
    guarded[512: 512 + n] = 0
    kernel, plain = _k16_steps(torch.from_numpy(U).to(cuda), primary, aux,
                               out=guarded[512: 512 + n])
    for got, want in zip(kernel, plain):
        assert torch.equal(got.cpu(), want.cpu().to(got.dtype))
    assert int(kernel[-1]) == 1
    assert bool((guarded[:512] == 0xA5).all())
    assert bool((guarded[512 + n:] == 0xA5).all())
    buf = U.copy()
    assert engine.bwt_decode(buf, primary, 0 if aux is None else len(aux),
                             aux, 0, cuda) == C.DATA_CORRUPT


def test_cli_gpu_default_format_decodes_on_the_card(cuda, tmp_path):
    """A default-format file (-b2: three 2 MiB blocks and a tail) encoded
    on the host comes back through decompress_file -G; each block of
    1 MiB or more takes K16 (DEVICE_ROUTES counts three), from the
    page-locked "decompress_lz" slot."""
    from libbsc_tpu_torch import cli, engine
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    data = _text(3 * (2 << 20) + 4321, 1602)
    inp, arch, back = tmp_path / "in", tmp_path / "a.bsc", tmp_path / "r"
    inp.write_bytes(data)
    cli.compress_file(str(inp), str(arch),
                      cli.parse_args(["x", "e", "a", "b", "-b2"]), quiet=True)
    before = engine.DEVICE_ROUTES["bwt_decode"]
    K16.reset_launches()
    cli.decompress_file(str(arch), str(back),
                        cli.parse_args(["x", "d", "a", "b", "-G"]),
                        quiet=True)
    assert back.read_bytes() == data
    assert engine.DEVICE_ROUTES["bwt_decode"] == before + 3
    assert [K16.LAUNCHES[k] for k in ("rulers_table", "rulers_gaps",
                                      "rulers_write")] == [3, 3, 3]
    # a block of 1 to 2 MiB (LZP may shorten it) has 2^14 to 2^15 + 9
    # nodes (a ruler a 64 rows, 8 start rows, the sentinel): 15 or 16
    # rounds of the ranking each
    assert 3 * 15 <= K16.LAUNCHES["rulers_rank"] <= 3 * 16
    P.init(C.DEFAULT_FEATURES | C.FEATURE_CUDA, device=cuda)
    blob = P.compress(data[: 2 << 20])
    assert _in_thread_slots(lambda: P.decompress(blob)) == data[: 2 << 20]


def _in_thread_slots(fn):
    """fn's result in a fresh thread, after checking that its page-locked
    slots are "decompress_lz" alone."""
    box = {}

    def run():
        box["out"] = fn()
        box["pinned"] = sorted(_pinned_slots())

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and box["pinned"] == ["decompress_lz"]
    return box["out"]


def test_k16_route_spans_and_tag(cuda):
    """A 2 MiB default-format block decoded on the card, under the
    profiler: its bwt_decode span is tagged "device, <k> aux, 0 threads"
    and holds one bwt.upload and one bwt.download."""
    from libbsc_tpu_torch.utils import trace

    data = _text(2 << 20, 1603)
    P.init(C.DEFAULT_FEATURES | C.FEATURE_CUDA, device=cuda)
    blob = P.compress(data)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert P.decompress(blob) == data
    finally:
        prof.stop()
    rec = trace.spans()
    [unbwt] = [s for s in rec if s.name == "bwt_decode"]
    assert unbwt.tag == f"device, {blob[-1]} aux, 0 threads"
    assert sorted(s.name for s in rec if s.parent == unbwt.id) == [
        "bwt.download", "bwt.upload"]


@pytest.mark.parametrize("switches", ["-G", "-m9e4G"], ids=["default",
                                                            "m9e4"])
def test_cli_gpu_reads_each_block_once(cuda, tmp_path, monkeypatch,
                                       switches):
    """A 4 MiB text file through -G's farm, under the profiler: the block
    is read into the page-locked read ring (every cli.read tagged
    "pinned") and handed to the API as it is, which uploads it from there
    (no api.copy span under any api.compress) and leaves it unchanged;
    the default format's device BWT downloads U into a page-locked slot
    of its own.  The entry is the block api.compress writes for the
    block's bytes and, for the default format, portbench/ref's
    block_default's."""
    from libbsc_tpu_torch import api, cli, engine
    from libbsc_tpu_torch.utils import trace

    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")
    data = _text(4 << 20, 2301)
    inp, arch = tmp_path / "in", tmp_path / "a.bsc"
    inp.write_bytes(data)
    p = cli.parse_args(["x", "e", "a", "b", switches])
    handed, outs = [], []
    compress, sort = api.compress, engine.bwt_encode

    def watched(block, *a, **k):
        handed.append((bufpool.lent(block), bytes(block)))
        blob = compress(block, *a, **k)
        assert bytes(block) == data
        return blob

    def spy(block, *a, out=None, **k):
        outs.append((out, np.shares_memory(block, out) if out is not None
                     else None))
        return sort(block, *a, out=out, **k)

    monkeypatch.setattr(api, "compress", watched)
    monkeypatch.setattr(engine, "bwt_encode", spy)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        cli.compress_file(str(inp), str(arch), p, quiet=True)
    finally:
        prof.stop()
    rec = trace.spans()
    assert handed == [(True, data)]
    reads = [s for s in rec if s.name == "cli.read"]
    assert reads and {s.tag for s in reads} == {"pinned"}
    calls = {s.id for s in rec if s.name == "api.compress"}
    assert len(calls) == 1
    assert not [s for s in rec if s.name == "api.copy" and s.parent in calls]
    if switches == "-G":
        ((out, shared),) = outs
        assert torch.from_numpy(out).is_pinned() and shared is False
    else:
        assert outs == []

    ((_, _, blob),) = _entries(arch).values()
    monkeypatch.setattr(api, "compress", compress)
    P.init(p.features(), device=cuda)
    assert blob == P.compress(data, p.lzp_hash_size, p.lzp_min_len,
                              p.block_sorter, p.coder, p.features())
    if switches == "-G":
        from portbench.ref import block_default

        cfg = {"lzp": [p.lzp_hash_size, p.lzp_min_len]}
        assert blob == block_default.encode(np.frombuffer(data, np.uint8),
                                            cfg, cuda)


def test_cli_gpu_m5_farm_sorts_on_the_card(cuda, tmp_path):
    """-b25 -m5 -G (the benchmark's bsc-m5-G-b25) on a 25 MiB block and a
    600,000-byte tail, through the farm under the profiler: the block
    sorts on the card (DEVICE_ROUTES counts it, its st5_encode span is
    tagged "device" and holds one st.upload and one st.download), the
    tail, under 1 MiB, on the host; each entry is the block
    portbench/ref's block_st writes, and decompress_file -G restores the
    file (the inverse ST tagged "host, 1 threads")."""
    import json
    from pathlib import Path

    from libbsc_tpu_torch import cli, engine
    from libbsc_tpu_torch.utils import trace
    from portbench.ref import block_st

    big = 25 << 20
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
             b"a lazy dog. ", b"compression ", b"transform ", b"lanes "]
    picks = np.random.default_rng(2401).integers(0, len(words), big // 3)
    data = b"".join(words[i] for i in picks)[:big + 600_000]
    inp, arch, back = tmp_path / "in", tmp_path / "a.bsc", tmp_path / "r"
    inp.write_bytes(data)
    p = cli.parse_args(["x", "e", "a", "b", "-b25", "-m5", "-G"])
    before = engine.DEVICE_ROUTES["st_encode"]
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        cli.compress_file(str(inp), str(arch), p, quiet=True)
        cli.decompress_file(str(arch), str(back),
                            cli.parse_args(["x", "d", "a", "b", "-G"]),
                            quiet=True)
    finally:
        prof.stop()
    assert back.read_bytes() == data
    assert engine.DEVICE_ROUTES["st_encode"] == before + 1
    rec = trace.spans()
    tags = sorted((s.nbytes, s.tag) for s in rec if s.name == "st5_encode")
    assert tags == [(600_000, "host"), (big, "device")]
    [st] = [s for s in rec if s.name == "st5_encode" and s.tag == "device"]
    assert sorted(s.name for s in rec if s.parent == st.id) == [
        "st.download", "st.upload"]
    assert {s.tag for s in rec if s.name == "st5_decode"} == {
        "host, 1 threads"}
    cfg = json.loads((Path(__file__).resolve().parent.parent / "portbench"
                      / "configs" / "bsc-m5-G-b25.json").read_text())
    raw = np.frombuffer(data, np.uint8)
    entries = _entries(arch)
    assert sorted(entries) == [0, big]
    for off, (rs, ctx, blob) in entries.items():
        assert (rs, ctx) == (1, 1)
        assert blob == block_st.encode(raw[off:off + big], cfg, cuda)
