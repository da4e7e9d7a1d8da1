"""Each traffic generator: the same bytes for the same seed, other bytes
for another seed or file, the size asked for, and the mix's shape."""

import json

import numpy as np
import pytest

from portbench.harness import Cell
from portbench.tests.helpers import REPO

BIG = 2**31 + 12345  # seeds reach past 32 signed bits


def _make(traffic: str, seed: int, index: int, n: int) -> np.ndarray:
    tr = json.loads((REPO / "portbench" / "traffic" / f"{traffic}.json")
                    .read_text())
    cell = Cell.__new__(Cell)
    cell.dir, cell.traffic = REPO / "portbench", tr
    return cell.generator().make(tr["params"], seed, index, n,
                                 "cpu").numpy()


@pytest.mark.parametrize("traffic", ["text_1blk", "text_8blk", "logs_1blk"])
def test_deterministic_by_seed(traffic):
    a = _make(traffic, BIG, 0, 200_000)
    assert a.dtype == np.uint8 and a.shape == (200_000,)
    assert np.array_equal(a, _make(traffic, BIG, 0, 200_000))
    assert (a != _make(traffic, BIG + 1, 0, 200_000)).mean() > 0.5
    assert (a != _make(traffic, BIG, 1, 200_000)).mean() > 0.5


def test_text_shape():
    a = bytes(_make("text_1blk", BIG, 0, 500_000))
    lines = a.split(b"\n")[:-1]
    assert max(len(x) for x in lines) <= 72 + 17
    words = a.replace(b"\n", b" ").split(b" ")[:-1]
    hexes = [w for w in words if len(w) == 16
             and all(c in b"0123456789abcdef" for c in w)]
    assert abs(len(hexes) / len(words) - 1 / 37) < 0.005
    assert set(a) <= set(b"abcdefghijklmnopqrstuvwxyz0123456789 \n")


def test_logs_shape():
    a = bytes(_make("logs_1blk", BIG, 0, 500_000))
    lines = [x for x in a.split(b"\n")[:-1] if x.startswith(b"2026-")]
    stamps = [x[:24] for x in lines]
    assert stamps == sorted(stamps)   # the time rises
    assert all(x[24:30] == b" host-" for x in lines)
    assert b"\tat org.apache." in a   # stack traces for LZP
