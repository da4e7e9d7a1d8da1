"""The harness end to end on the CPU: a tiny cell through the CLI on
device="cpu" (the command itself refuses a machine without a card), the
result line's keys, and a cell, mix and metric added by files alone."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.helpers import REPO, tiny_bench

SEED = 2**31 + 77


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell(tmp_path, traced):
    root = tiny_bench(tmp_path)
    res = harness.run_cell(root, "tiny.cell", SEED, 2.0, traced,
                           device="cpu", say=quiet)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    assert set(line["checks"]) == {"calls_failed", "container_faults",
                                   "blocks_wrong", "restored_wrong"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        # the CPU has no device events; the host-clock tail is still read
        assert set(line["metrics"]) == {"encode_p95_ms"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"encode_MBps", "decode_MBps",
                                        "ratio", "setup_s"}
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]


def test_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix, a metric and a cell, each a new
    file or entry; no file of the harness changes."""
    root = tiny_bench(tmp_path)
    d = root / "portbench"
    cfg = json.loads((d / "configs" / "tiny.json").read_text())
    cfg["switches"] = ["-b1", "-m9", "-e4", "-G", "-H16"]
    cfg["lzp"] = [16, 128]
    (d / "configs" / "tiny_h16.json").write_text(json.dumps(cfg))
    tr = json.loads((d / "traffic" / "tiny.json").read_text())
    tr["generator"] = "logs"
    tr["params"] = json.loads((d / "traffic" / "logs_1blk.json")
                              .read_text())["params"]
    (d / "traffic" / "tiny_logs.json").write_text(json.dumps(tr))
    (d / "metrics" / "calls.encode.py").write_text(
        "def read(run):\n    return float(len(run.encode.calls))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_h16", "source": "a test",
                             "file": "portbench/configs/tiny_h16.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "added.cell", "config": "tiny_h16",
                               "traffic": "tiny_logs", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "calls.encode", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["added.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell(root, "added.cell", SEED, 2.0, False,
                           device="cpu", say=quiet)
    assert res["correct"] is True
    assert res["metrics"]["calls.encode"]["value"] >= 1
    assert "encode_MBps" in res["metrics"]


def test_command_refuses_a_machine_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
         "m9e4.text.1blk", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_command_fails_without_the_program(tmp_path):
    """A checkout with BENCHMARK.json and portbench/ alone fails."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "portbench" / "run.py"),
         "--workload", "m9e4.text.1blk", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""
