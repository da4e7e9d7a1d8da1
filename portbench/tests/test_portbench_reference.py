"""The reference against the program: its choices (LZP, lane tables)
against the program's own, its blocks against the archives of the CLI's
host route on the CPU; the control; and a run with the timed path broken
underneath for each fault a cell can have, each of which must come out
not correct."""

import json

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.harness import Cell
from portbench.ref import block, bwt, container, lanes, lzp
from portbench.tests.helpers import REPO, tiny_bench

SEED = 2**31 + 91


def quiet(*a, **k):
    pass


def _program_block(tmp_path, data: np.ndarray, switches) -> bytes:
    from libbsc_tpu_torch import cli

    src, out = tmp_path / "in", tmp_path / "out"
    src.write_bytes(data.tobytes())
    cli.compress_file(str(src), str(out),
                      cli.parse_args(["bsc", "e", "i", "o", *switches]),
                      quiet=True)
    return container.parse_archive(out.read_bytes())[0][3]


@pytest.mark.parametrize("traffic,n", [("text_1blk", 150_000),
                                       ("text_1blk", 1_500_000),
                                       ("logs_1blk", 400_000)])
def test_reference_equals_the_program(tmp_path, traffic, n):
    cell = Cell.__new__(Cell)
    cell.dir = REPO / "portbench"
    cell.traffic = json.loads((cell.dir / "traffic" / f"{traffic}.json")
                              .read_text())
    cfg = json.loads((cell.dir / "configs" / "bsc-m9e4-G-b25.json")
                     .read_text())
    data = cell.generator().make(cell.traffic["params"], SEED, 0, n,
                                 "cpu").numpy()
    got = _program_block(tmp_path, data, ["-b25", "-m9", "-e4"])
    if traffic.startswith("logs"):
        assert container.HEADER.unpack_from(got)[2] >> 8, "LZP kept"
    assert block.expected(data, got, cfg, "cpu") == got
    flipped = bytearray(got)
    flipped[len(got) // 2] ^= 1
    assert block.expected(data, bytes(flipped), cfg, "cpu") != bytes(flipped)


def _mix(traffic: str, n: int, seed: int = SEED) -> np.ndarray:
    cell = Cell.__new__(Cell)
    cell.dir = REPO / "portbench"
    cell.traffic = json.loads((cell.dir / "traffic" / f"{traffic}.json")
                              .read_text())
    return cell.generator().make(cell.traffic["params"], seed, 0, n,
                                 "cpu").numpy()


def _runny(n: int) -> np.ndarray:
    g = torch.Generator().manual_seed(5)
    chars = torch.randint(0, 4, (n // 100,), generator=g, dtype=torch.uint8)
    reps = torch.randint(1, 200, (n // 100,), generator=g)
    return torch.repeat_interleave(chars, reps)[:n].numpy()


@pytest.mark.parametrize("kind,n", [("text_1blk", 150_000),
                                    ("text_1blk", 1_500_000),
                                    ("logs_1blk", 600_000),
                                    ("runny", 300_000)])
def test_lane_tables_are_the_programs(kind, n):
    from libbsc_tpu_torch import native
    from libbsc_tpu_torch.ops import wide_schedule

    data = _runny(n) if kind == "runny" else _mix(kind, n)
    U = bwt.bwt_wideaux(torch.from_numpy(data), bwt.wideaux_rate(n))[0]
    buf = np.ascontiguousarray(U.numpy())
    for L in sorted({lanes.lane_count(n), 1024, 64, 3}):
        want = wide_schedule.device_balanced_sizes(U, L).numpy()
        assert np.array_equal(lanes.device_table(U, L), want)
        want = np.zeros(L, dtype=np.int32)
        rc = native.load().tbsc_wide_balanced_sizes(
            native.u8p(buf), n, L, native.i32p(want))
        got = lanes.host_table(U, L)
        assert (got is None) == (rc != 0)
        assert got is None or np.array_equal(got, want)


@pytest.mark.parametrize("kind,n", [("text_1blk", 300_000),
                                    ("text_1blk", 1_100_000),
                                    ("logs_1blk", 300_000)])
def test_lzp_decision_is_the_programs(kind, n):
    from libbsc_tpu_torch import engine

    data = _mix(kind, n)
    got = lzp.lzp_compress(data, 15, 128)
    want = engine.lzp_compress(data, 15, 128, 0)
    assert (got is None) == (want is None)
    assert got is None or np.array_equal(got, np.asarray(want))
    # a part where no match is possible is one the encoder leaves
    parts = lzp._num_blocks(n)
    size = n // parts
    for lo in range(0, size * parts, size):
        part = data[lo:lo + size]
        if not lzp.may_match(torch.from_numpy(part), 15, 128):
            assert lzp.lzp_encode_block(part.tobytes(), 15, 128) is None


def test_control_reads_wrong(tmp_path):
    root = tiny_bench(tmp_path)
    for seed in (SEED, SEED + 1, SEED + 2):
        res = control.control_run(root, "tiny.cell", seed, 2.0,
                                  device="cpu", say=quiet)
        assert res["correct"] is False
        assert res["checks"]["blocks_wrong"]["value"] > 0


def _broken_run(tmp_path, monkeypatch, fault, file_bytes=300_000,
                traffic="text_1blk"):
    from libbsc_tpu_torch import api, cli, native
    from libbsc_tpu_torch.ops import wide

    root = tiny_bench(tmp_path, file_bytes=file_bytes, traffic=traffic)
    if fault == "lane table shifted":
        # a valid partition that is not the balancer's: the archive
        # still restores
        encode = wide.wide_encode

        def shifted(data, n_lanes=None, balanced=True, rans=True,
                    sizes=None):
            buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
            sizes = np.zeros(n_lanes, dtype=np.int32)
            assert native.load().tbsc_wide_balanced_sizes(
                native.u8p(buf), len(buf), n_lanes, native.i32p(sizes)) == 0
            sizes[0] += 1
            sizes[1] -= 1
            return encode(data, n_lanes, balanced, rans, sizes)

        monkeypatch.setattr(wide, "wide_encode", shifted)
    elif fault == "LZP skipped":
        monkeypatch.setattr(api, "_lzp_probe_pays", lambda *a: False)
    elif fault == "stored":
        monkeypatch.setattr(api, "compress", lambda data, *a, **k:
                            api.store(data))
    comp, decomp = cli.compress_file, cli.decompress_file
    last = {}

    def compress_file(inp, outp, p, quiet=False, device=None):
        comp(inp, outp, p, quiet, device)
        with open(outp, "rb") as f:
            arc = f.read()
        if fault == "state unchanged" and "arc" in last:
            arc, last["arc"] = last["arc"], arc
        elif fault == "state unchanged":
            last["arc"] = arc
        elif fault == "half left out":
            blocks = container.parse_archive(arc)
            keep = blocks[:len(blocks) - len(blocks) // 2]
            arc = b"bsc1" + np.int32(len(keep)).tobytes() + b"".join(
                container.ENTRY.pack(o, r, c) + b for o, r, c, b in keep)
        elif fault == "archive altered":
            arc = bytearray(arc)
            arc[len(arc) // 2] ^= 0x10
        with open(outp, "wb") as f:
            f.write(arc)

    def decompress_file(inp, outp, p, quiet=False, device=None):
        decomp(inp, outp, p, quiet, device)
        if fault == "restored altered":
            with open(outp, "r+b") as f:
                f.seek(1000)
                b = f.read(1)
                f.seek(1000)
                f.write(bytes([b[0] ^ 1]))

    monkeypatch.setattr(cli, "compress_file", compress_file)
    monkeypatch.setattr(cli, "decompress_file", decompress_file)
    return harness.run_cell(root, "tiny.cell", SEED, 2.0, False,
                            device="cpu", say=quiet)


@pytest.mark.parametrize("fault,check", [
    ("state unchanged", "restored_wrong"),
    ("archive altered", "blocks_wrong"),
    ("restored altered", "restored_wrong")])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault, check):
    res = _broken_run(tmp_path, monkeypatch, fault)
    assert res["correct"] is False
    assert res["checks"][check]["value"] > 0


@pytest.mark.parametrize("fault,traffic", [
    ("lane table shifted", "text_1blk"),
    ("LZP skipped", "logs_1blk"),
    ("stored", "text_1blk")])
def test_a_choice_not_the_formats_is_not_correct(tmp_path, monkeypatch,
                                                fault, traffic):
    """Blocks that restore, with a choice the format does not make:
    only the reference's own choices can find them."""
    res = _broken_run(tmp_path, monkeypatch, fault, traffic=traffic)
    assert res["correct"] is False
    assert res["checks"]["blocks_wrong"]["value"] > 0
    assert res["checks"]["restored_wrong"]["value"] == 0
    assert res["checks"]["calls_failed"]["value"] == 0


def test_half_the_blocks_left_out(tmp_path, monkeypatch):
    res = _broken_run(tmp_path, monkeypatch, "half left out",
                      file_bytes=2_500_000)
    assert res["correct"] is False
    assert res["checks"]["container_faults"]["value"] > 0


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_control_on_the_card_at_the_cell_size(cuda):
    for seed in (4_100_000_001, 4_100_000_002, 4_100_000_003):
        res = control.control_run(REPO, "m9e4.text.1blk", seed, 20.0,
                                  say=quiet)
        assert res["correct"] is False
        assert res["checks"]["blocks_wrong"]["value"] > 0
