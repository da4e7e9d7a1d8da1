"""A tiny copy of the benchmark in a temporary folder, for CPU runs of
the harness: the -m9 -e4 -G configuration at -b1 on small text files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_bench(tmp: Path, file_bytes: int = 300_000, pool: int = 3,
               name: str = "tiny.cell", traffic: str = "text_1blk") -> Path:
    """``tmp`` holding BENCHMARK.json and portbench/ with one cell
    ``name``: the -m9 -e4 -G config at -b1, files of ``file_bytes`` from
    the mix of ``traffic``; returns ``tmp``."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    d = tmp / "portbench"
    tr = json.loads((d / "traffic" / f"{traffic}.json").read_text())
    tr.update(file_bytes=file_bytes, pool_files=pool, restored_kept=0.5)
    (d / "traffic" / "tiny.json").write_text(json.dumps(tr))
    cfg = json.loads((d / "configs" / "bsc-m9e4-G-b25.json").read_text())
    cfg["switches"] = ["-b1", "-m9", "-e4", "-G"]
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"] = [{"name": "tiny", "source": "a test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": name, "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
