"""The default format's cell on the CPU: a tiny copy of
``default.text.1blk`` (the ``bsc-default-G-b25`` configuration at -b2,
files of 1.1 MB, so that each block takes the device BWT's route on the
CPU's plain versions) through the harness, untraced and traced; its
control, which must come out not correct; and the new per-layer
readers on a program's record and on one without their spans."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

from portbench import control_default, harness, stage_spans
from portbench.tests.helpers import REPO

SEED = 2**31 + 2024
CELL = "tiny.default"
NEW = {"bwt_stage_ms.encode", "bwt_copy_ms.encode", "qlfc_ms.encode",
       "qlfc_ms.decode", "unbwt_ms.decode"}


def quiet(*a, **k):
    pass


def tiny_default(tmp: Path, file_bytes: int = 1_100_000,
                 pool: int = 2) -> Path:
    """``tmp`` holding BENCHMARK.json and portbench/ with one cell
    ``tiny.default``: the default configuration at -b2 on text files of
    ``file_bytes``; every per-layer metric listing cells lists it."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = tmp / "portbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    tr = json.loads((d / "traffic" / "text_1blk.json").read_text())
    tr.update(file_bytes=file_bytes, pool_files=pool, restored_kept=0.5)
    (d / "traffic" / "tiny.json").write_text(json.dumps(tr))
    cfg = json.loads((d / "configs" / "bsc-default-G-b25.json").read_text())
    cfg["switches"] = ["-b2", "-G"]
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"] = [{"name": "tiny", "source": "a test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def test_tiny_default_cell(tmp_path):
    root = tiny_default(tmp_path)
    res = harness.run_cell(root, CELL, SEED, 2.0, False, device="cpu",
                           say=quiet)
    assert res["correct"] is True and res["failed"] == 0
    assert {k: v["value"] for k, v in res["checks"].items()} == dict.fromkeys(
        res["checks"], 0)
    assert {"encode_MBps", "decode_MBps", "ratio",
            "setup_s"} <= set(res["metrics"])


def test_tiny_default_cell_traced(tmp_path):
    from libbsc_tpu_torch.utils import trace

    root = tiny_default(tmp_path)
    res = harness.run_cell(root, CELL, SEED + 1, 2.0, True, device="cpu",
                           say=quiet)
    assert res["correct"] is True
    got = set(res["metrics"]) & NEW
    device_blocks = [s for s in trace.spans()
                     if s.name == "bwt_encode" and s.tag == "device"]
    want = NEW if device_blocks else NEW - {"bwt_copy_ms.encode"}
    assert got == want
    for name in got:
        assert res["metrics"][name]["value"] > 0
        assert res["metrics"][name]["unit"] == "ms"


def test_control_is_not_correct(tmp_path):
    root = tiny_default(tmp_path, file_bytes=300_000)
    res = control_default.control_run(root, CELL, SEED, 1.0, device="cpu",
                                      say=quiet)
    assert res["correct"] is False
    assert res["checks"]["blocks_wrong"]["value"] > 0


def S(id, name, parent=None, start=0, end=0):
    return SimpleNamespace(id=id, name=name, parent=parent, start=start,
                           end=end, out=None, tag="")


def test_per_block_ms(monkeypatch):
    """Spans under the phase's API spans, at any depth, over the API
    spans; None where there are none (a program without the spans)."""
    rec = [S(1, "api.compress"), S(2, "api.compress"),
           S(3, "bwt_encode", 1, 0, 4_000_000),
           S(4, "bwt.download", 3, 0, 1_000_000),
           S(5, "bwt_encode", 2, 0, 2_000_000),
           S(6, "bwt_encode", None, 0, 9_000_000),  # outside any block
           S(7, "api.decompress"), S(8, "bwt_decode", 7, 0, 3_000_000)]
    monkeypatch.setattr("portbench.spans.record", lambda: rec)
    assert stage_spans.per_block_ms({"bwt_encode"}, "encode") == 3.0
    assert stage_spans.per_block_ms({"bwt.upload", "bwt.download"},
                                    "encode") == 0.5
    assert stage_spans.per_block_ms({"bwt_decode"}, "decode") == 3.0
    assert stage_spans.per_block_ms({"coder_compress"}, "encode") is None
    monkeypatch.setattr("portbench.spans.record", lambda: None)
    assert stage_spans.per_block_ms({"bwt_encode"}, "encode") is None
