"""The stage tracer (``utils/trace``): under ``TBSC_TRACE`` the port's
stage lines carry the JAX package's stage names and byte counts for the
same compress and decompress (times ignored); ``TBSC_PROFILE`` writes a
trace after ``stop_profiler()``."""

import json
import re

import numpy as np
import pytest

import libbsc_tpu as J
import libbsc_tpu_torch as P
from libbsc_tpu.utils import trace as jtrace
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.utils import trace as ptrace
from tests.conftest import make_corpus

LINE = re.compile(r"^\[tbsc\] (\S+): (\d+)B (\d+\.\d{4})s( [0-9.]+ MB/s)?$")
CONFIGS = {
    "default": {},
    "m5": dict(block_sorter=C.BLOCKSORTER_ST5),
    "m9e4": dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                 coder=C.CODER_QLFC_WIDE),
    "e4": dict(coder=C.CODER_QLFC_WIDE),
    "m3e3": dict(block_sorter=C.BLOCKSORTER_ST3, coder=C.CODER_QLFC_FAST),
}


@pytest.fixture(scope="module")
def data():
    return make_corpus(np.random.default_rng(77), 300_000, "text")


def _stages(capsys, fn):
    """(name, bytes) of every stage line fn prints, and fn's result."""
    capsys.readouterr()
    out = fn()
    lines = capsys.readouterr().err.splitlines()
    got = []
    for line in lines:
        m = LINE.match(line)
        assert m, line
        got.append((m.group(1), int(m.group(2))))
    return got, out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_stage_names_and_bytes_equal_jax(data, config, capsys, monkeypatch):
    monkeypatch.setattr(ptrace, "TRACE", True)
    monkeypatch.setattr(jtrace, "TRACE", True)
    P.init(C.DEFAULT_FEATURES, device="cpu")
    J.init()
    kw = CONFIGS[config]
    ours, a = _stages(capsys, lambda: P.compress(data, **kw))
    theirs, b = _stages(capsys, lambda: J.compress(data, **kw))
    assert a == b
    assert ours == theirs and ours
    ours, back = _stages(capsys, lambda: P.decompress(a))
    theirs, _ = _stages(capsys, lambda: J.decompress(b))
    assert back == data
    assert ours == theirs
    ours, _ = _stages(capsys, lambda: P.decompress_batch([a, a]))
    theirs, _ = _stages(capsys, lambda: J.decompress_batch([b, b]))
    assert ours == theirs


def test_untraced_calls_print_nothing(data, capsys, monkeypatch):
    monkeypatch.setattr(ptrace, "TRACE", False)
    P.init(C.DEFAULT_FEATURES, device="cpu")
    capsys.readouterr()
    assert P.decompress(P.compress(data)) == data
    assert capsys.readouterr().err == ""


def test_profile_writes_a_trace(data, tmp_path, monkeypatch):
    """Under TBSC_ENGINE=numpy the BWT runs through torch ops at any size,
    so the trace holds their sorts."""
    from libbsc_tpu_torch import engine

    monkeypatch.setattr(ptrace, "_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setattr(engine, "_force", "numpy")
    P.init(C.DEFAULT_FEATURES, device="cpu")
    assert ptrace.stop_profiler() is None  # nothing started yet
    small = data[:20_000]
    assert P.decompress(P.compress(small, coder=C.CODER_QLFC_FAST)) == small
    path = ptrace.stop_profiler()
    assert path is not None and path.startswith(str(tmp_path / "prof"))
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::sort" in names
    assert {"tbsc::lzp_compress", "tbsc::bwt_encode", "tbsc::bwt_decode",
            "tbsc::coder_compress"} <= names
    assert ptrace.stop_profiler() is None  # stopped
