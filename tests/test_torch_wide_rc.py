"""The lockstep range coder (``ops/wide_rc``, torch ops on the CPU)
against the serial reference (the port's ``fallback/qlfc.RcEncoder`` /
``RcDecoder``) and the JAX package's ``wide_rc``: tests/test_wide_rc.py's
cases."""

import numpy as np
import pytest

from libbsc_tpu.ops import wide_rc as jrc
from libbsc_tpu_torch.fallback.qlfc import RcDecoder, RcEncoder
from libbsc_tpu_torch.ops import wide_rc

CPU = "cpu"


def _ref_encode(seq):
    rc = RcEncoder(1 << 20)
    for b, p, prec in seq:
        rc.encode(b, p, prec)
    return rc.finish()


def _ref_decode(probs, stream):
    rc = RcDecoder(stream)
    return [rc.decode(p, prec) for p, prec in probs]


def _random_lanes(seed, n_lanes, max_len):
    g = np.random.default_rng(seed)
    lanes = []
    for _ in range(n_lanes):
        m = int(g.integers(1, max_len))
        seq = []
        for _ in range(m):
            prec = int(g.choice([11, 12, 13]))
            p = int(g.integers(1, (1 << prec) - 1))
            seq.append((int(g.integers(0, 2)), p, prec))
        lanes.append(seq)
    return lanes


def _skewed_lanes():
    return [[(1, skew, 12)] * 600 + [(0, skew, 12)] * 600
            for skew in (1, 4094, 2048)]


def _probs(lanes):
    return [[(p, prec) for (_, p, prec) in seq] for seq in lanes]


@pytest.fixture(scope="module")
def jax_streams():
    """JAX wide_rc.encode of every case, one call each."""
    cases = {f"{n}x{m}": _random_lanes(n * 1000 + m, n, m)
             for n, m in [(1, 50), (4, 200), (16, 400)]}
    cases["skewed"] = _skewed_lanes()
    return {k: (lanes, jrc.encode(lanes)) for k, lanes in cases.items()}


@pytest.mark.parametrize("case", ["1x50", "4x200", "16x400", "skewed"])
def test_wide_encode_matches_serial_and_jax(case, jax_streams):
    lanes, jstreams = jax_streams[case]
    streams = wide_rc.encode(lanes, device=CPU)
    assert streams == jstreams
    for lane, stream in zip(lanes, streams):
        assert stream == _ref_encode(lane)


@pytest.mark.parametrize("case", ["4x200", "16x400", "skewed"])
def test_wide_decode_roundtrip(case, jax_streams):
    lanes, jstreams = jax_streams[case]
    bits = wide_rc.decode(_probs(lanes), jstreams, device=CPU)
    for seq, got, stream in zip(lanes, bits, jstreams):
        assert got == [b for (b, _, _) in seq]
        assert got == _ref_decode(_probs([seq])[0], stream)


def test_wide_decode_serial_streams():
    """Streams produced by the serial encoder decode on the wide decoder,
    as on the JAX one."""
    lanes = _random_lanes(4150, 4, 150)
    streams = [_ref_encode(seq) for seq in lanes]
    bits = wide_rc.decode(_probs(lanes), streams, device=CPU)
    assert bits == jrc.decode(_probs(lanes), streams)
    for seq, got in zip(lanes, bits):
        assert got == [b for (b, _, _) in seq]


def test_empty_lanes():
    """A lane with no bits still flushes its four units."""
    lanes = [[], [(1, 100, 12)], []]
    streams = wide_rc.encode(lanes, device=CPU)
    assert streams == [_ref_encode(s) for s in lanes]
    assert wide_rc.decode(_probs(lanes), streams, device=CPU) == \
        [[], [1], []]
