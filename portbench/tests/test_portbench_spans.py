"""The readers of the program's spans (portbench/spans.py and the seven
metrics on it): on hand-made records against numbers worked out by hand,
on a tiny traced cell through the CLI on device="cpu", and on a program
without ``trace.spans``."""

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.harness import Cell, Phase, Run
from portbench.tests.helpers import REPO, tiny_bench
from portbench.trace import Trace

SEED = 2**31 + 91
NAMES = ["cli_ms.encode", "cli_ms.decode", "host_stage_ms.encode",
         "host_stage_ms.decode", "lzp_wasted_ms.encode",
         "device_stage_idle_pct.encode", "device_stage_idle_pct.decode"]


def read(name, run):
    cell = Cell.__new__(Cell)
    cell.dir = REPO / "portbench"
    return cell.reader(name).read(run)


def S(id, name, start_us, end_us, parent=None, call=None, out=None):
    return SimpleNamespace(id=id, name=name, start=start_us * 1000,
                           end=end_us * 1000, parent=parent,
                           call=id if call is None else call, out=out,
                           offset=0, nbytes=0, tag="", thread=1)


# one encode call (two blocks on two threads) and one decode call; times in
# us on the record's clock, which lies 500 us before the trace's
RECORD = [
    S(1, "cli.compress_file", 0, 1000),
    S(2, "api.compress", 100, 600, 1, 1),
    S(3, "api.compress", 400, 900, 1, 1),
    S(4, "lzp_compress", 100, 200, 2, 1, out=0),
    S(5, "lzp_compress", 400, 450, 3, 1, out=7),
    S(6, "compress_block_device", 250, 550, 2, 1),
    S(7, "cli.decompress_file", 1000, 1600),
    S(8, "api.decompress", 1100, 1500, 7, 7),
    S(9, "decompress_block_device", 1200, 1400, 8, 7),
]


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = Trace([
    X("tbsc::cli.compress_file", "user_annotation", 500, 1000),
    X("tbsc::cli.decompress_file", "user_annotation", 1500, 600),
    X("k1", "kernel", 800, 100),     # [250, 550) + 500: 100 busy of 300
    X("k2", "kernel", 1700, 150),    # [1200, 1400) + 500: 150 of 200
])


@pytest.fixture
def hand_made(monkeypatch):
    from libbsc_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: list(RECORD))
    return Run(Cell.__new__(Cell), [None], 1 << 20,
               encode=Phase("encode"), decode=Phase("decode"), trace=TRACE)


def test_hand_made_record(hand_made):
    run = hand_made
    # encode: api spans cover [100, 900) of [0, 1000); decode [1100, 1500)
    assert read("cli_ms.encode", run) == pytest.approx(0.2)
    assert read("cli_ms.decode", run) == pytest.approx(0.2)
    # (500 - 300) and 500 over two blocks; 400 - 200
    assert read("host_stage_ms.encode", run) == pytest.approx(0.35)
    assert read("host_stage_ms.decode", run) == pytest.approx(0.2)
    # the rejected attempt, 100 us, over two blocks
    assert read("lzp_wasted_ms.encode", run) == pytest.approx(0.05)
    assert spans.trace_offset_us(RECORD, TRACE) == pytest.approx(500)
    assert read("device_stage_idle_pct.encode", run) == pytest.approx(
        100 * 200 / 300)
    assert read("device_stage_idle_pct.decode", run) == pytest.approx(25.0)
    assert spans.device_stage_ms("encode") == pytest.approx(0.15)
    assert spans.covered_ns([(5, 8), (0, 3), (2, 4)], 1, 7) == 5


def test_without_the_record_every_reader_reads_nothing(hand_made,
                                                       monkeypatch):
    from libbsc_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "spans")
    for name in NAMES:
        assert read(name, hand_made) is None
    monkeypatch.setattr(trace, "spans", lambda: [], raising=False)
    for name in NAMES:
        assert read(name, hand_made) is None


def test_tiny_traced_cell(tmp_path, monkeypatch):
    """One 1 MiB block a file through the fused device route on the CPU:
    the route wants 1,024 lanes, which the lane policy gives a block of 4
    MiB or more (TBSC_WIDE_LANES=1024, which the harness clears, gives it
    at 1 MiB; the policy is patched to the same effect, so the judge reads
    the blocks as not the format's and the run is not correct)."""
    from libbsc_tpu_torch.ops import wide

    policy = wide.pick_lanes_policy
    monkeypatch.setattr(wide, "pick_lanes_policy",
                        lambda n: 1024 if n >= 1 << 20 else policy(n))
    runs = []
    judge = harness.judge

    def keep(run, expected):
        runs.append(run)
        return judge(run, expected)

    monkeypatch.setattr(harness, "judge", keep)
    root = tiny_bench(tmp_path, file_bytes=1 << 20, pool=1)
    res = harness.run_cell(root, "tiny.cell", SEED, 1.0, True,
                           device="cpu", say=lambda *a, **k: None)
    got = res["metrics"]
    assert set(NAMES) <= set(got)
    for name in NAMES:
        assert got[name]["value"] >= 0, name
    # the CPU runs no kernel: the device stage is idle throughout
    assert got["device_stage_idle_pct.decode"]["value"] == pytest.approx(100)
    [run] = runs
    for phase in (run.encode, run.decode):
        mean_call_ms = 1e3 * sum(c.seconds for c in phase.calls) \
            / len(phase.calls)
        parts = (got[f"cli_ms.{phase.name}"]["value"]
                 + got[f"host_stage_ms.{phase.name}"]["value"]
                 + spans.device_stage_ms(phase.name))
        assert parts <= mean_call_ms
