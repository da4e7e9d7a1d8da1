"""The pipelined many-block entry points, device_encode_many and
device_decode_many: their orchestration with the port's own stages
replaced by fakes (on the model of test_wide.py's device_decode_many
check), and their payloads and blocks against the one-block entry points
(plain kernel versions on the CPU)."""

import threading
import time

import numpy as np
import pytest

from libbsc_tpu_torch.ops import wide_kernels as pwk


class _Stages:
    """Fake stages that record what is in flight: a block is in flight from
    its submission until it is finished (collected or fetched)."""

    def __init__(self):
        self.inflight: list = []
        self.finished: list = []
        self.most = 0
        self.lock = threading.Lock()

    def submit(self, tag):
        with self.lock:
            self.inflight.append(tag)
            self.most = max(self.most, len(self.inflight))
            assert len(self.inflight) <= 2
        return {"tag": tag}

    def finish(self, st) -> bytes:
        time.sleep(0.01)  # a slow finish lets the submissions run ahead
        with self.lock:
            self.inflight.remove(st["tag"])
            self.finished.append(st["tag"])
        return b"out-%d" % st["tag"]


def test_encode_many_orchestration(monkeypatch):
    s = _Stages()
    # a block that does not take the kernels preps to None
    monkeypatch.setattr(pwk, "_host_prep",
                        lambda d: None if d == b"-" else ("prep", int(d)))
    monkeypatch.setattr(pwk, "_submit", lambda p, device: s.submit(p[1]))
    monkeypatch.setattr(pwk, "_collect", lambda n, st: s.finish(st))
    outs = pwk.device_encode_many([b"0", b"-", b"1", b"2", b"-", b"3"], "cpu")
    assert outs == [b"out-0", None, b"out-1", b"out-2", None, b"out-3"]
    assert s.finished == [0, 1, 2, 3]  # each once, in submission order
    assert not s.inflight


def test_decode_many_orchestration(monkeypatch):
    s = _Stages()
    monkeypatch.setattr(pwk, "_dec_parse",
                        lambda p: None if p is None else {"tag": p})
    monkeypatch.setattr(pwk, "_dec_submit",
                        lambda parsed, device: s.submit(parsed["tag"]))
    monkeypatch.setattr(pwk, "_dec_fetch", lambda out, ready: s.finish(out))
    outs = pwk.device_decode_many([0, None, 1, 2, None, 3, 4], "cpu")
    assert outs == [b"out-0", None, b"out-1", b"out-2", None, b"out-3",
                    b"out-4"]
    assert s.finished == [0, 1, 2, 3, 4]  # each once, in submission order
    assert s.most == 2  # the fetch of one block overlaps the next's kernels
    assert not s.inflight


def test_encode_many_raises_a_prep_thread_error(monkeypatch):
    def prep(data):
        if data == b"2":
            raise ValueError("prep failed on block 2")
        return ("prep", int(data))

    s = _Stages()
    monkeypatch.setattr(pwk, "_host_prep", prep)
    monkeypatch.setattr(pwk, "_submit", lambda p, device: s.submit(p[1]))
    monkeypatch.setattr(pwk, "_collect", lambda n, st: s.finish(st))
    with pytest.raises(ValueError, match="block 2"):
        pwk.device_encode_many([b"%d" % i for i in range(6)], "cpu")
    assert 2 not in s.finished


def test_decode_many_raises_a_fetch_error(monkeypatch):
    s = _Stages()

    def fetch(out, ready):
        if out["tag"] == 1:
            raise OSError("fetch failed on block 1")
        return s.finish(out)

    monkeypatch.setattr(pwk, "_dec_parse", lambda p: {"tag": p})
    monkeypatch.setattr(pwk, "_dec_submit",
                        lambda parsed, device: s.submit(parsed["tag"]))
    monkeypatch.setattr(pwk, "_dec_fetch", fetch)
    with pytest.raises(OSError, match="block 1"):
        pwk.device_decode_many([0, 1, 2, 3, 4, 5], "cpu")


def _runs(n: int, seed: int) -> bytes:
    g = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([g.integers(0, 4)]) * int(g.integers(1, 10))
    return bytes(out[:n])


@pytest.mark.parametrize("rans", [True, False])
def test_many_equals_one_at_a_time(monkeypatch, rans):
    monkeypatch.setattr(pwk, "RANS", rans)
    datas = [_runs(1024 * 20, s) for s in (1, 2, 3)] + [b"ab" * 300]
    payloads = pwk.device_encode_many(datas, "cpu")
    assert payloads[:3] == [pwk.device_encode(d, "cpu") for d in datas[:3]]
    assert payloads[3] is None  # too short for the kernels
    assert all(pwk._dec_parse(p)["rans"] == rans for p in payloads[:3])
    native = b"\0" * 16  # not 1024 lanes: the native codec's
    blocks = pwk.device_decode_many(payloads[:3] + [native], "cpu")
    assert blocks == datas[:3] + [None]
