"""The port's CLI (``python -m libbsc_tpu_torch.cli``): the container,
round trips, switches, the farm policy and the -G routes, on the CPU.

The tests of ``tests/test_cli.py``, run against the port; archives equal
to the JAX CLI's per container entry for each configuration (``-t``, so
that neither farm reorders blocks); the -G default config through the
device BWT route (``ops`` on ``device="cpu"``: its plain version) equal
to the host archive, from the farm and from -G -t's pool alike, with the
process environment left as it was; ``-m9 -e4 -G`` archives decoded by
the other package's CLI; and -G without CUDA refused.  Subprocesses only
where a process is the thing tested: exit codes, messages, usage,
TBSC_DECOMPRESSION_ONLY.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import libbsc_tpu_torch as P
from libbsc_tpu import cli as jcli
from libbsc_tpu_torch import cli, engine
from libbsc_tpu_torch import constants as C
from tests.conftest import make_corpus
from tests.oracle import bsc_binary

REPO = Path(__file__).resolve().parent.parent


def run_cli(args, **env):
    env = dict(os.environ, PYTHONPATH=str(REPO), **env)
    return subprocess.run(
        [sys.executable, "-m", "libbsc_tpu_torch.cli"] + args,
        capture_output=True, text=True, env=env,
    )


def blocks_of(path):
    """Container entries, read to EOF (nBlocks is advisory): block offset
    -> (record size, contexts, block).  The farm writes blocks as they
    finish, so archives are compared entry by entry."""
    raw = Path(path).read_bytes()
    assert raw[:4] == b"bsc1"
    off, out = 8, {}
    while off < len(raw):
        boff, rs, ctx = struct.unpack_from(cli.BLOCK_HEADER_FMT, raw, off)
        off += cli.BLOCK_HEADER_SIZE
        (csz,) = struct.unpack_from("<i", raw, off)
        out[boff] = (rs, ctx, raw[off:off + csz])
        off += csz
    assert off == len(raw)
    return out


def params(*switches):
    return cli.parse_args(["x", "e", "a", "b", *switches])


def test_cli_roundtrip(tmp_path, rng):
    data = make_corpus(rng, 600000, "text")
    inp = tmp_path / "in"
    inp.write_bytes(data)
    arch = tmp_path / "a.bsc"
    out = tmp_path / "out"
    r = run_cli(["e", str(inp), str(arch), "-b1"])
    assert r.returncode == 0, r.stderr
    assert "encoded" in r.stdout
    r = run_cli(["d", str(arch), str(out)])
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == data
    assert arch.stat().st_size < len(data) // 2


def test_cli_corrupt_archive_message(tmp_path, rng):
    data = make_corpus(rng, 100000, "text")
    inp = tmp_path / "in"
    inp.write_bytes(data)
    arch = tmp_path / "a.bsc"
    cli.compress_file(str(inp), str(arch), cli.Params(), quiet=True)
    blob = bytearray(arch.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    arch.write_bytes(bytes(blob))
    r = run_cli(["d", str(arch), str(tmp_path / "out")])
    assert r.returncode == 2
    assert "corrupt" in r.stderr.lower()
    assert "Traceback" not in r.stderr


def test_cli_not_an_archive(tmp_path):
    f = tmp_path / "x"
    f.write_bytes(b"definitely not a bsc archive")
    r = run_cli(["d", str(f), str(tmp_path / "out")])
    assert r.returncode == 1
    assert "not a valid bsc archive" in r.stderr


@pytest.mark.parametrize("flags", [[], ["-e0"], ["-m5", "-e0"], ["-p"],
                                   ["-b1"]])
def test_cli_reference_binary_interop(tmp_path, rng, flags):
    bsc = bsc_binary()
    if bsc is None:
        pytest.skip("reference binary unavailable")
    data = make_corpus(rng, 800000, "text")
    inp = tmp_path / "in"
    inp.write_bytes(data)
    _reference_interop(bsc, tmp_path, inp, data, flags)


def _reference_interop(bsc, tmp_path, inp, data, flags):
    mine = tmp_path / "m.bsc"
    cli.compress_file(str(inp), str(mine), params(*flags), quiet=True)
    ref_out = tmp_path / "ref_out"
    r = subprocess.run([bsc, "d", str(mine), str(ref_out)],
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    assert ref_out.read_bytes() == data

    theirs = tmp_path / "r.bsc"
    r = subprocess.run([bsc, "e", str(inp), str(theirs)] + flags,
                       capture_output=True)
    assert r.returncode == 0
    my_out = tmp_path / "my_out"
    cli.decompress_file(str(theirs), str(my_out), cli.Params(), quiet=True)
    assert my_out.read_bytes() == data


def test_cli_empty_file(tmp_path):
    inp = tmp_path / "empty"
    inp.write_bytes(b"")
    arch = tmp_path / "a.bsc"
    out = tmp_path / "out"
    assert run_cli(["e", str(inp), str(arch)]).returncode == 0
    assert run_cli(["d", str(arch), str(out)]).returncode == 0
    assert out.read_bytes() == b""
    assert arch.read_bytes() == b"bsc1" + bytes(4)


def test_parse_combined_switches():
    p = params("-b128p", "-m5e1")
    assert p.block_size == 128 * 1024 * 1024
    assert p.lzp is False and p.segmentation is False
    assert p.block_sorter == C.BLOCKSORTER_ST5
    assert p.coder == C.CODER_QLFC_STATIC

    p = params("-pl", "-cpGT")
    assert p.lzp is True  # -l re-enables after -p
    assert p.sorting_contexts == C.CONTEXTS_PRECEDING
    assert p.gpu is True
    assert p.multithreading is False

    p = params("-m9e4G", "-H20M64", "-srPf", "-ca")
    assert p.block_sorter == C.BLOCKSORTER_BWT_WIDEAUX
    assert p.coder == C.CODER_QLFC_WIDE
    assert (p.lzp_hash_size, p.lzp_min_len) == (20, 64)
    assert p.segmentation and p.reordering and p.largepages and p.gpu
    assert p.sorting_contexts == C.CONTEXTS_AUTODETECT
    assert p.features() == (C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING
                            | C.FEATURE_CUDA)


def test_parse_accepts_every_switch_of_the_jax_cli():
    """Every switch of the JAX CLI parses to the same parameters."""
    for switches in (["-b1"], ["-b2047"], ["-m0"], ["-m3"], ["-m8"], ["-m9"],
                     ["-e0"], ["-e1"], ["-e2"], ["-e4"], ["-H10"], ["-H28"],
                     ["-M4"], ["-M255"], ["-p"], ["-s"], ["-r"], ["-l"],
                     ["-t"], ["-T"], ["-G"], ["-P"], ["-f"], ["-cf"],
                     ["-cp"], ["-ca"], ["-b128p", "-m5e1"], ["-pl", "-cpGT"]):
        ours = params(*switches)
        theirs = jcli.parse_args(["x", "e", "a", "b", *switches])
        assert ours.__dict__ == theirs.__dict__, switches
        assert ours.features() == theirs.features(), switches


def test_parse_rejects_bad_options():
    for bad in (["-H5"], ["-M2"], ["-m10"], ["-e7"], ["-q"], ["-b0"],
                ["-cz"], ["x"], ["-"], ["-e"]):
        with pytest.raises(SystemExit):
            params(*bad)


def test_cli_segmentation_homogeneous_no_data_loss(tmp_path, rng):
    """A 3 MB homogeneous file at -b1 with -s: every block comes back."""
    data = make_corpus(rng, 3 * 1024 * 1024, "text")
    inp = tmp_path / "in"
    inp.write_bytes(data)
    arch = tmp_path / "a.bsc"
    out = tmp_path / "out"
    cli.compress_file(str(inp), str(arch), params("-b1s"), quiet=True)
    cli.decompress_file(str(arch), str(out), cli.Params(), quiet=True)
    assert out.read_bytes() == data


def test_cli_segmentation_heterogeneous_roundtrip(tmp_path, rng):
    """Segmentation splits at content boundaries and may change the block
    count against nBlocks; decode reads blocks to EOF (bsc.cpp:507-520)."""
    data = (make_corpus(rng, 700000, "text")
            + make_corpus(rng, 600000, "random")
            + make_corpus(rng, 500000, "zeros")
            + make_corpus(rng, 700000, "text"))
    inp = tmp_path / "in"
    inp.write_bytes(data)
    arch = tmp_path / "a.bsc"
    out = tmp_path / "out"
    cli.compress_file(str(inp), str(arch), params("-b1s"), quiet=True)
    assert sum(len(b[2]) > 0 for b in blocks_of(arch).values()) >= 3
    cli.decompress_file(str(arch), str(out), cli.Params(), quiet=True)
    assert out.read_bytes() == data


def test_cli_segmentation_reference_interop(tmp_path, rng):
    bsc = bsc_binary()
    if bsc is None:
        pytest.skip("reference binary unavailable")
    data = (make_corpus(rng, 900000, "text")
            + make_corpus(rng, 700000, "random")
            + make_corpus(rng, 900000, "runs"))
    inp = tmp_path / "in"
    inp.write_bytes(data)
    _reference_interop(bsc, tmp_path, inp, data, ["-b1s"])


def test_cli_farm_path_roundtrip(tmp_path, rng):
    """-G with ST8 engages the heterogeneous farm (three device workers
    and a host worker, device="cpu"); the queue, the sentinel and the
    out-of-order writes are all exercised."""
    data = make_corpus(rng, 3 * 1024 * 1024 + 777, "text")
    inp = tmp_path / "in.bin"
    arch = tmp_path / "a.bsc"
    restored = tmp_path / "r.bin"
    inp.write_bytes(data)

    p = cli.Params()
    p.gpu = True
    p.block_size = 1024 * 1024
    p.block_sorter = 8
    cli.compress_file(str(inp), str(arch), p, quiet=True, device="cpu")
    assert len(blocks_of(arch)) == 4

    cli.decompress_file(str(arch), str(restored), cli.Params(), quiet=True)
    assert restored.read_bytes() == data


@pytest.mark.parametrize("prior", [None, "0"])
def test_cli_gpu_default_config_identical_bytes(tmp_path, rng, monkeypatch,
                                                prior):
    """-G on the default config writes the host archive, entry for entry
    (the reference's CUDA flag accelerates the default config unchanged,
    bwt/bwt.cpp:178-181).  2 MiB blocks, so that LZP output stays over
    the device route's 1 MiB minimum: under ``ops`` (the route a CUDA
    device takes; device="cpu": its plain version) the farm's workers
    sort them through engine.bwt_encode's device route.  The farm writes
    nothing into the environment: TBSC_BWT_DEVICE (the JAX package's
    opt-in, here unset or "0") and every other variable are as the test
    left them."""
    if prior is None:
        monkeypatch.delenv("TBSC_BWT_DEVICE", raising=False)
    else:
        monkeypatch.setenv("TBSC_BWT_DEVICE", prior)
    data = make_corpus(rng, 3 * (2 << 20) + 4321, "text")
    inp = tmp_path / "in.bin"
    inp.write_bytes(data)

    host_arch = tmp_path / "host.bsc"
    p = cli.Params()
    p.block_size = 2 << 20
    cli.compress_file(str(inp), str(host_arch), p, quiet=True)

    dev_arch = tmp_path / "dev.bsc"
    q = cli.Params()
    q.block_size = 2 << 20
    q.gpu = True
    before = engine.DEVICE_ROUTES["bwt_encode"]
    env = dict(os.environ)
    with monkeypatch.context() as m:
        m.setattr(engine, "_force", "ops")
        cli.compress_file(str(inp), str(dev_arch), q, quiet=True,
                          device="cpu")
    assert engine.DEVICE_ROUTES["bwt_encode"] > before
    assert dict(os.environ) == env  # never written

    assert blocks_of(dev_arch) == blocks_of(host_arch)
    restored = tmp_path / "r.bin"
    cli.decompress_file(str(dev_arch), str(restored), q, quiet=True,
                        device="cpu")
    assert restored.read_bytes() == data


@pytest.mark.parametrize("switches", ["-G", "-Gt"], ids=["farm", "pool"])
def test_gpu_bwt_routes_leave_the_environment_alone(tmp_path, monkeypatch,
                                                    switches):
    """-G's farm and -G -t's thread pool take the same route for a block
    of 1 MiB or more: under ``ops`` on device="cpu" (the route a CUDA
    device takes) each sorts it through engine.bwt_encode's device route,
    counted in DEVICE_ROUTES.  Neither writes the process environment:
    it is the same before the call, inside the sort and after."""
    from tests.test_torch_default_format import zipf_text

    data = zipf_text(1_200_000).tobytes()  # the LZP screen skips it
    inp, arch = tmp_path / "in.bin", tmp_path / "out.bsc"
    inp.write_bytes(data)
    env = dict(os.environ)
    seen = []
    sort = engine.bwt_encode

    def spy(*a, **k):
        seen.append(dict(os.environ))
        return sort(*a, **k)

    monkeypatch.setattr(engine, "bwt_encode", spy)
    before = engine.DEVICE_ROUTES["bwt_encode"]
    with monkeypatch.context() as m:
        m.setattr(engine, "_force", "ops")
        cli.compress_file(str(inp), str(arch), params("-b2", switches),
                          quiet=True, device="cpu")
    assert engine.DEVICE_ROUTES["bwt_encode"] == before + 1
    assert seen == [env]
    assert dict(os.environ) == env
    restored = tmp_path / "r.bin"
    cli.decompress_file(str(arch), str(restored), cli.Params(), quiet=True)
    assert restored.read_bytes() == data


def test_cli_m9_e4_gpu_cross_decodes_with_the_jax_cli(tmp_path, rng,
                                                      monkeypatch):
    """-m9 -e4 -G through the farm (device="cpu"), on a 1.5 MiB block that
    takes the fused route (TBSC_WIDE_LANES=1024 gives it 1024 lanes):
    the entry is the fused route's block or, if the host worker took it,
    the host route's; the JAX CLI decodes it, and the port's CLI restores
    the JAX CLI's archive (its host route's: the JAX package has no device
    here)."""
    monkeypatch.setenv("TBSC_WIDE_LANES", "1024")
    data = make_corpus(rng, 3 << 19, "text")
    inp = tmp_path / "in.bin"
    inp.write_bytes(data)
    p = params("-m9e4G")
    ours = tmp_path / "ours.bsc"
    cli.compress_file(str(inp), str(ours), p, quiet=True, device="cpu")
    (entry,) = blocks_of(ours).values()
    P.init(C.FEATURE_FASTMODE | C.FEATURE_CUDA, device="cpu")
    kw = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
              coder=C.CODER_QLFC_WIDE)
    fused = P.compress(data, **kw)
    assert entry[2] in (fused, P.compress(data, features=0, **kw))
    back = tmp_path / "back.bin"
    jcli.decompress_file(str(ours), str(back), jcli.Params(), quiet=True)
    assert back.read_bytes() == data

    theirs = tmp_path / "theirs.bsc"
    jcli.compress_file(str(inp), str(theirs),
                       jcli.parse_args(["x", "e", "a", "b", "-m9e4G"]),
                       quiet=True)
    back.unlink()
    cli.decompress_file(str(theirs), str(back), cli.Params(), quiet=True)
    assert back.read_bytes() == data


def test_cli_gpu_without_cuda_exits_and_names_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inp = tmp_path / "in"
    inp.write_bytes(b"some bytes " * 100)
    arch = tmp_path / "a.bsc"
    for mode, src in (("e", inp), ("d", arch)):
        if mode == "d":
            cli.compress_file(str(inp), str(arch), cli.Params(), quiet=True)
        with pytest.raises(SystemExit) as e:
            cli.main(["x", mode, str(src), str(tmp_path / "out"), "-G"])
        assert e.value.code != 0
        assert "CUDA" in capsys.readouterr().err
    with pytest.raises(P.BscError) as e:
        cli.compress_file(str(inp), str(arch), params("-G"), quiet=True)
    assert e.value.code == C.GPU_NOT_SUPPORTED


@pytest.mark.parametrize("flags", [["-r"], ["-cp"], ["-ca"]])
def test_cli_container_fields_reference_interop(tmp_path, rng, flags):
    """recordSize / sortingContexts container fields: cross-decode both
    directions with the reference binary."""
    bsc = bsc_binary()
    if bsc is None:
        pytest.skip("reference binary unavailable")
    data = _record_data(rng)
    inp = tmp_path / "in"
    inp.write_bytes(data)
    _reference_interop(bsc, tmp_path, inp, data, flags)


def _record_data(rng) -> bytes:
    """Four interleaved byte streams (so -r reorders) and a text tail (so
    -ca has context structure to detect)."""
    n = 600_000
    rec = np.zeros(n, dtype=np.uint8)
    for k in range(4):
        rec[k::4] = (50 * k + rng.integers(0, 3, size=len(rec[k::4]))
                     ).astype(np.uint8)
    return rec.tobytes() + make_corpus(rng, 400_000, "text")


def test_cli_big_block_8_subblock_directories(tmp_path, rng):
    """>= 16 MB in one block: the 8-sub-block LZP and coder directories
    (lzp.cpp:44-51, coder.cpp:52-59); cross-decode both ways."""
    bsc = bsc_binary()
    if bsc is None:
        pytest.skip("reference binary unavailable")
    base = make_corpus(rng, 4 * 1024 * 1024, "text")
    data = (base * 5)[: 17 * 1024 * 1024]
    inp = tmp_path / "in"
    inp.write_bytes(data)
    _reference_interop(bsc, tmp_path, inp, data, ["-b25"])


def test_cli_wide_profile_roundtrip(tmp_path, rng):
    """-e4 selects the wide-lane profile (format extension)."""
    data = make_corpus(rng, 400_000, "runs")
    inp = tmp_path / "in"
    inp.write_bytes(data)
    arch = tmp_path / "a.bsc"
    out = tmp_path / "out"
    assert run_cli(["e", str(inp), str(arch), "-e4"]).returncode == 0
    assert run_cli(["d", str(arch), str(out)]).returncode == 0
    assert out.read_bytes() == data
    (entry,) = blocks_of(arch).values()
    assert (entry[2][8] >> 5) & 7 == C.CODER_QLFC_WIDE


def test_farm_policy_matches_reference():
    """bsc.cpp:184-190: inner multithreading only when threads > blocks;
    never more workers than blocks."""
    assert cli.farm_policy(4, 4) == (4, False)
    assert cli.farm_policy(4, 100) == (4, False)
    assert cli.farm_policy(1, 1) == (1, False)
    assert cli.farm_policy(8, 3) == (3, True)
    assert cli.farm_policy(8, 1) == (1, True)
    assert cli.farm_policy(8, 0) == (1, True)


def test_apply_farm_policy_mocked_cores(monkeypatch):
    monkeypatch.setattr(cli.os, "cpu_count", lambda: 4)
    p = cli.Params()
    p.parallel = True
    p.multithreading = True

    q, workers = cli._apply_farm_policy(p, 16)  # blocks >= threads
    assert workers == 4
    assert not q.multithreading
    assert not (q.features() & C.FEATURE_MULTITHREADING)
    assert p.multithreading  # original untouched

    q2, workers2 = cli._apply_farm_policy(p, 2)  # threads > blocks
    assert workers2 == 2
    assert q2.multithreading
    assert q2 is p

    p.parallel = False
    q3, workers3 = cli._apply_farm_policy(p, 16)
    assert (q3, workers3) == (p, 1)


def test_decompression_only_profile(tmp_path, rng):
    """TBSC_DECOMPRESSION_ONLY (the reference's BSC_DECOMPRESSION_ONLY
    build profile, bsc.cpp:891): `e` is not offered, `d` still works."""
    data = make_corpus(rng, 100000, "text")
    inp = tmp_path / "in"
    inp.write_bytes(data)
    arch = tmp_path / "a.bsc"
    out = tmp_path / "out"
    cli.compress_file(str(inp), str(arch), params("-b1"), quiet=True)

    r = run_cli(["e", str(inp), str(arch)], TBSC_DECOMPRESSION_ONLY="1")
    assert r.returncode == 0
    assert "Usage" in r.stdout  # e falls through to usage
    r = run_cli(["d", str(arch), str(out)], TBSC_DECOMPRESSION_ONLY="1")
    assert r.returncode == 0
    assert out.read_bytes() == data


# --- parity with the JAX CLI ------------------------------------------------

PARITY = [[], ["-p"], ["-e0"], ["-e2"], ["-m5"], ["-m9"], ["-e4"], ["-r"],
          ["-cp"], ["-ca"], ["-s"], ["-b1"]]


@pytest.fixture(scope="module")
def parity_input(tmp_path_factory):
    """Record-structured bytes, text, noise and runs: 1.6 MB, so that -b1
    cuts two blocks and -s finds segments."""
    g = np.random.default_rng(0xC11)
    data = (_record_data(g) + make_corpus(g, 200_000, "random")
            + make_corpus(g, 400_000, "runs"))
    path = tmp_path_factory.mktemp("parity") / "in"
    path.write_bytes(data)
    return path, data


@pytest.mark.parametrize("flags", PARITY, ids=lambda f: "".join(f) or "default")
def test_archive_equals_the_jax_cli(tmp_path, parity_input, flags):
    inp, data = parity_input
    ours, theirs = tmp_path / "ours.bsc", tmp_path / "theirs.bsc"
    cli.compress_file(str(inp), str(ours), params("-t", *flags), quiet=True)
    jcli.compress_file(str(inp), str(theirs),
                       jcli.parse_args(["x", "e", "a", "b", "-t", *flags]),
                       quiet=True)
    assert blocks_of(ours) == blocks_of(theirs)
    assert ours.read_bytes()[:8] == theirs.read_bytes()[:8]
    back = tmp_path / "back"
    cli.decompress_file(str(theirs), str(back), cli.Params(), quiet=True)
    assert back.read_bytes() == data
