"""The Sort Transform's cell on the CPU: a tiny copy of ``m5.text.1blk``
(the ``bsc-m5-G-b25`` configuration at -b2, files of 1.1 MB, so that a
block on a device worker takes the device ST's route on the CPU) through
the harness, untraced and traced, with the four new per-layer metrics;
its control, which must come out not correct; and the ST readers on a
record without their spans or tags."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

from portbench import control_st, harness
from portbench.harness import load_file
from portbench.tests.helpers import REPO

SEED = 2**31 + 2405
CELL = "tiny.m5"
NEW = {"st_stage_ms.encode", "st_copy_ms.encode", "st_device_pct.encode",
       "unst_ms.decode"}


def quiet(*a, **k):
    pass


def tiny_m5(tmp: Path, file_bytes: int = 1_100_000, pool: int = 2) -> Path:
    """``tmp`` holding BENCHMARK.json and portbench/ with one cell
    ``tiny.m5``: the -m5 configuration at -b2 on text files of
    ``file_bytes``; every per-layer metric listing cells lists it."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    d = tmp / "portbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    tr = json.loads((d / "traffic" / "text_1blk.json").read_text())
    tr.update(file_bytes=file_bytes, pool_files=pool, restored_kept=0.5)
    (d / "traffic" / "tiny.json").write_text(json.dumps(tr))
    cfg = json.loads((d / "configs" / "bsc-m5-G-b25.json").read_text())
    cfg["switches"] = ["-b2", "-m5", "-G"]
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


def test_tiny_m5_cell(tmp_path):
    root = tiny_m5(tmp_path)
    res = harness.run_cell(root, CELL, SEED, 2.0, False, device="cpu",
                           say=quiet)
    assert res["correct"] is True and res["failed"] == 0
    assert {k: v["value"] for k, v in res["checks"].items()} == dict.fromkeys(
        res["checks"], 0)
    assert {"encode_MBps", "decode_MBps", "ratio",
            "setup_s"} <= set(res["metrics"])


def test_tiny_m5_cell_traced(tmp_path):
    from libbsc_tpu_torch.utils import trace

    root = tiny_m5(tmp_path)
    res = harness.run_cell(root, CELL, SEED + 1, 2.0, True, device="cpu",
                           say=quiet)
    assert res["correct"] is True
    got = set(res["metrics"]) & NEW
    tags = [s.tag for s in trace.spans() if s.name == "st5_encode"]
    assert tags and set(tags) <= {"device", "host"}
    want = NEW if "device" in tags else NEW - {"st_copy_ms.encode"}
    assert got == want
    m = {k: res["metrics"][k] for k in got}
    assert m["st_device_pct.encode"] == {
        "value": 100.0 * tags.count("device") / len(tags), "unit": "%"}
    for name in got - {"st_device_pct.encode"}:
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"


def test_control_is_not_correct(tmp_path):
    root = tiny_m5(tmp_path, file_bytes=300_000)
    res = control_st.control_run(root, CELL, SEED, 1.0, device="cpu",
                                 say=quiet)
    assert res["correct"] is False
    assert res["checks"]["blocks_wrong"]["value"] > 0


def S(id, name, parent=None, start=0, end=0, tag=""):
    return SimpleNamespace(id=id, name=name, parent=parent, start=start,
                           end=end, out=None, tag=tag)


def _reader(name):
    return load_file(REPO / "portbench" / "metrics" / f"{name}.py",
                     f"test_reader_{name.replace('.', '_')}")


def test_st_readers(monkeypatch):
    """Spans under the phase's API spans, over the API spans; the route
    share over the tagged ST spans; None where the program records no
    such span or no tag (a program without them)."""
    rec = [S(1, "api.compress"), S(2, "api.compress"),
           S(3, "st5_encode", 1, 0, 4_000_000, "device"),
           S(4, "st.upload", 3, 0, 1_000_000),
           S(5, "st.download", 3, 0, 500_000),
           S(6, "st5_encode", 2, 0, 2_000_000, "host"),
           S(7, "st5_encode", None, 0, 9_000_000, "device"),  # no block's
           S(8, "api.decompress"),
           S(9, "st5_decode", 8, 0, 3_000_000, "host, 1 threads")]
    monkeypatch.setattr("portbench.spans.record", lambda: rec)
    read = {name: _reader(name).read for name in NEW}
    assert read["st_stage_ms.encode"](None) == 3.0
    assert read["st_copy_ms.encode"](None) == 0.75
    assert read["st_device_pct.encode"](None) == 50.0
    assert read["unst_ms.decode"](None) == 3.0
    for s in rec:  # a program that tags no ST span and has no copies
        s.tag = ""
    rec[:] = [s for s in rec if not s.name.startswith("st.")]
    assert read["st_device_pct.encode"](None) is None
    assert read["st_copy_ms.encode"](None) is None
    assert read["st_stage_ms.encode"](None) == 3.0
    monkeypatch.setattr("portbench.spans.record", lambda: None)
    assert all(read[name](None) is None for name in NEW)
