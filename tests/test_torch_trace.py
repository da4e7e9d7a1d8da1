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


# -- spans: the record on every thread, on the profiler's clock -------------

def _profiled(fn, **kw):
    """Run fn under a torch profiler of the CPU started on this thread;
    returns the stopped profiler."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], **kw)
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    return prof


@pytest.fixture(scope="module")
def two_blocks(tmp_path_factory):
    """A text file of two -b1 blocks: 1 MiB, where LZP pays, and a tail of
    300,000 bytes, where it does not."""
    path = tmp_path_factory.mktemp("spans") / "in.txt"
    path.write_bytes(make_corpus(np.random.default_rng(5), (1 << 20)
                                 + 300_000, "text"))
    return path


def _cli_round_trip(src, tmp_path):
    from libbsc_tpu_torch import cli

    enc = cli.parse_args(["bsc", "e", "i", "o", "-b1", "-m9", "-e4", "-G"])
    dec = cli.parse_args(["bsc", "d", "i", "o", "-G"])
    arc, back = tmp_path / "a.bsc", tmp_path / "back"
    cli.compress_file(str(src), str(arc), enc, quiet=True, device="cpu")
    cli.decompress_file(str(arc), str(back), dec, quiet=True, device="cpu")
    assert back.read_bytes() == src.read_bytes()
    return arc


def _lzp_by_offset(arc) -> dict:
    """Whether LZP ran on each block of a bsc1 archive (its mode word)."""
    import struct

    from libbsc_tpu_torch.format.header import parse_block_header

    blob = arc.read_bytes()
    at, out = 8, {}
    while at < len(blob):
        offset = struct.unpack_from("<q", blob, at)[0]
        h = parse_block_header(blob[at + 10:])
        out[offset] = bool((h.mode >> 8) & 0xFFFF)
        at += 10 + h.block_size
    return out


def test_cli_spans_on_every_thread(two_blocks, tmp_path):
    """Under a profiler started on this thread, the farm's workers and the
    decode pool's threads record their blocks' api spans, each with the
    file call's id, its block's offset and a parent chain up to the file
    call; LZP's span holds its bytes out (0: the attempt was rejected)."""
    import threading

    arcs = []
    _profiled(lambda: arcs.append(_cli_round_trip(two_blocks, tmp_path)))
    rec = ptrace.spans()
    by_id = {s.id: s for s in rec}
    main = threading.get_native_id()

    def chain(s):
        names = [s.name]
        while s.parent is not None:
            s = by_id[s.parent]
            names.append(s.name)
        return names

    for root_name, api_name, block in (
            ("cli.compress_file", "api.compress", "farm.block"),
            ("cli.decompress_file", "api.decompress", "pool.block")):
        [root] = [s for s in rec if s.name == root_name]
        assert root.thread == main and root.call == root.id
        calls = [s for s in rec if s.name == api_name]
        assert sorted(s.offset for s in calls) == [0, 1 << 20]
        for s in calls:
            assert s.call == root.id and s.thread != main
            assert chain(s) == [api_name, block, root_name]
            assert root.start <= s.start <= s.end <= root.end
        assert {s.name for s in rec if s.call == root.id} >= {
            "api.init", "cli.open", "cli.read", "cli.write", "adler32",
            "api.copy", "bufpool.alloc"}
    assert {s.tag for s in rec if s.name == "farm.block"} <= {"device",
                                                              "host"}
    lzp = {s.offset: s for s in rec if s.name == "lzp_compress"}
    kept = _lzp_by_offset(arcs[0])
    assert set(lzp) == set(kept) == {0, 1 << 20}
    assert set(kept.values()) == {True, False}
    for offset, s in lzp.items():
        assert s.nbytes == (1 << 20 if offset == 0 else 300_000)
        assert (0 < s.out < s.nbytes) if kept[offset] else s.out == 0


def test_no_profiler_records_and_prints_nothing(two_blocks, tmp_path,
                                                 capsys, monkeypatch):
    monkeypatch.setattr(ptrace, "TRACE", False)
    before = ptrace.spans()
    capsys.readouterr()
    _cli_round_trip(two_blocks, tmp_path)
    assert ptrace.spans() == before
    assert capsys.readouterr() == ("", "")
    with ptrace.span("x", 1, 0, "t") as sp:
        sp.out = 1
        assert sp is ptrace._OFF and ptrace.current() is None
    assert ptrace.stage("y", 1) is ptrace._OFF


def test_stamps_on_the_profilers_clock(tmp_path):
    """A main-thread span's stamps in the record and its record_function
    event in the exported trace (ts plus baseTimeNanoseconds / 1000, Unix
    microseconds) agree within 50 us."""
    import torch

    def run():
        with ptrace.span("clock.warm"):
            pass
        with ptrace.span("clock"):
            torch.ones(1000).sum()

    prof = _profiled(run)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1000
    [ev] = [e for e in trace["traceEvents"] if e.get("name") == "tbsc::clock"]
    [s] = [s for s in ptrace.spans() if s.name == "clock"]
    assert abs(ev["ts"] + base_us - s.start / 1000) < 50
    assert abs(ev["ts"] + ev["dur"] + base_us - s.end / 1000) < 50


def test_profile_cli_writes_every_threads_spans(two_blocks, tmp_path,
                                                monkeypatch, capsys):
    """``bsc e`` under TBSC_PROFILE writes one Chrome trace at exit, and
    the farm's workers' api.compress spans are in it."""
    import threading

    from libbsc_tpu_torch import api, cli

    prof_dir = tmp_path / "prof"
    monkeypatch.setattr(ptrace, "_PROFILE_DIR", str(prof_dir))
    monkeypatch.setattr(cli, "_init",
                        lambda p, device: api.init(p.features(), "cpu"))
    cli.main(["bsc", "e", str(two_blocks), str(tmp_path / "a.bsc"), "-b1",
              "-m9", "-e4", "-G"])
    assert ptrace._profiler is None
    [path] = list(prof_dir.iterdir())
    assert f"[tbsc] profile: {path}" in capsys.readouterr().err
    events = json.loads(path.read_text())["traceEvents"]
    tids = {e["tid"] for e in events if e.get("name") == "tbsc::api.compress"}
    main = {e["tid"] for e in events
            if e.get("name") == "tbsc::cli.compress_file"}
    assert main == {threading.get_native_id()}
    assert tids and not tids & main
