"""The -G encode path's read ring, on the CPU: ``bufpool.Ring`` lends each
buffer to one holder at a time; ``api.compress`` reads a buffer a ring
lent out and never writes into it, on every route it takes here, with
the archive the ``bytes`` path writes; a random block in a ring buffer
comes back as a stored block of the same bytes; a -G file of more blocks
than the ring holds gives the host archive, no buffer refilled while its
block is in flight; and ``cli._compress_one`` hands the block's own
memory to the API unless a filter changes it.

The CPU has no page-locked memory: a ring made ``pinned`` here takes
pageable buffers (``bufpool._alloc_pinned`` replaced, as in
``tests/test_torch_bufpool.py``), which the API treats as it treats the
card's: no copy where no stage writes in place."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from libbsc_tpu_torch import api, cli, engine
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.format.header import parse_block_header
from libbsc_tpu_torch.utils import bufpool, trace
from tests.test_torch_cli import blocks_of, params
from tests.test_torch_default_format import phrases, random_bytes, zipf_text

CUDA = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING | C.FEATURE_CUDA
MIB = 1 << 20


def _pageable(cap):
    raw = np.empty(cap, np.uint8)
    return raw, raw


@pytest.fixture
def fake_pinned(monkeypatch):
    """Rings made ``pinned`` take pageable buffers."""
    monkeypatch.setattr(bufpool, "_alloc_pinned", _pageable)


def _lzp_rejected(n: int) -> np.ndarray:
    """Random bytes with one 300-byte stretch repeated close by (in one
    LZP part): the screen sees a match may occur, and the host LZP, run,
    does not pay."""
    data = random_bytes(n).copy()
    data[10_000:10_300] = data[1000:1300]
    return data


# name: (block, sorter, coder, TBSC_ENGINE=ops, api.copy spans for a lent
# buffer, for another buffer)
ROUTES = {
    "bwt_device": (zipf_text, C.BLOCKSORTER_BWT, C.CODER_QLFC_STATIC, True,
                   0, 1),
    "bwt_host": (zipf_text, C.BLOCKSORTER_BWT, C.CODER_QLFC_STATIC, False,
                 1, 1),
    "st5": (zipf_text, C.BLOCKSORTER_ST5, C.CODER_QLFC_STATIC, False, 1, 1),
    "lzp_pays": (phrases, C.BLOCKSORTER_BWT, C.CODER_QLFC_STATIC, True, 0,
                 1),
    "lzp_rejected": (_lzp_rejected, C.BLOCKSORTER_BWT, C.CODER_QLFC_STATIC,
                     True, 0, 2),
}


def _profiled(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, trace.spans()


@pytest.mark.parametrize("lent", [True, False], ids=["lent", "other"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_compress_reads_a_buffer_and_never_writes_it(monkeypatch,
                                                     fake_pinned, route,
                                                     lent):
    """A 1.2 MiB block on a device route (device="cpu": the kernels' plain
    versions), from a buffer a page-locked ring lent out or from any
    other array: the buffer is unchanged after the call, the block is the
    one ``bytes`` gives, and the API copied the block only where a stage
    writes in place (or, for another buffer, into the card's slot)."""
    make, sorter, coder, ops, copies_lent, copies_other = ROUTES[route]
    if ops:
        monkeypatch.setattr(engine, "_force", "ops")
    api.init(CUDA, device="cpu")
    data = np.ascontiguousarray(make(1_200_000))
    kw = dict(block_sorter=sorter, coder=coder, features=CUDA)
    want = api.compress(data.tobytes(), **kw)

    ring = bufpool.Ring(1, pinned=True)
    buf = ring.take(len(data)) if lent else np.empty_like(data)
    buf[:] = data
    assert bufpool.lent(buf) == lent
    got, spans = _profiled(lambda: api.compress(buf, **kw))
    if lent:
        ring.give(buf)
    assert np.array_equal(buf, data)
    assert got == want
    copies = [s for s in spans if s.name == "api.copy"]
    assert len(copies) == (copies_lent if lent else copies_other)
    if route == "lzp_pays":
        assert parse_block_header(got).mode >> 8, "LZP kept"
    if route == "lzp_rejected":
        assert [s.out for s in spans if s.name == "lzp_compress"] == [0]


def test_a_random_block_in_a_ring_buffer_is_stored_as_it_is(
        tmp_path, monkeypatch, fake_pinned):
    """-G on a random file, read into a page-locked ring (the CPU's
    stand-in) and handed to the API as it is: the entry is a stored block
    whose payload is the file."""
    monkeypatch.setattr(cli, "_rings",
                        {False: bufpool.Ring(cli.READ_RING, pinned=True)})
    data = random_bytes(1_500_000).tobytes()
    inp, arch = tmp_path / "in", tmp_path / "a.bsc"
    inp.write_bytes(data)
    cli.compress_file(str(inp), str(arch), params("-G"), quiet=True,
                      device="cpu")
    ((rs, ctx, blob),) = blocks_of(arch).values()
    h = parse_block_header(blob)
    assert (rs, ctx, h.mode) == (1, C.CONTEXTS_FOLLOWING, 0)
    assert blob[C.HEADER_SIZE:] == data


class _WatchedRing(bufpool.Ring):
    """A ring that checks, at each take, that the buffer it lends is out
    to no one else, and counts the buffers it has made."""

    def __init__(self, count, pinned):
        super().__init__(count, pinned)
        self.held, self.made, self.peak = set(), set(), 0
        self.lock = threading.Lock()

    def take(self, nbytes):
        buf = super().take(nbytes)
        with self.lock:
            assert buf.ctypes.data not in self.held
            self.held.add(buf.ctypes.data)
            self.made.add(buf.ctypes.data)
            self.peak = max(self.peak, len(self.held))
        return buf

    def give(self, arr):
        with self.lock:
            self.held.remove(arr.ctypes.data)
        super().give(arr)


@pytest.mark.parametrize("switches", ["-b1G", "-b1Gt"], ids=["farm", "pool"])
@pytest.mark.parametrize("pinned", [True, False],
                         ids=["page_locked", "pageable"])
def test_more_blocks_than_ring_buffers(tmp_path, monkeypatch, fake_pinned,
                                       switches, pinned):
    """6 MiB and a tail at -b1 -G (the farm) and -b1 -G -t, on the plain
    device versions: seven blocks through a ring of five.  Each block's
    buffer holds its bytes from the read until its entry is written
    (checked after the API returns and again in emit's place, after a
    pause that lets the reader run ahead), no buffer is lent twice at
    once, the ring makes at most five, and every entry equals the host
    archive's (-t: the whole archive, written in order)."""
    ring = _WatchedRing(cli.READ_RING, pinned=pinned)
    monkeypatch.setattr(cli, "_rings", {False: ring})
    data = zipf_text(6 * MIB + 777).tobytes()
    inp = tmp_path / "in"
    inp.write_bytes(data)
    host = tmp_path / "host.bsc"
    cli.compress_file(str(inp), str(host), params("-b1t"), quiet=True)

    one = cli._compress_one
    seen = []

    def watched(p, block):
        before = bytes(block)
        out = one(p, block)
        time.sleep(0.02)
        assert bytes(block) == before
        seen.append(len(block))
        return out

    monkeypatch.setattr(cli, "_compress_one", watched)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        dev = tmp_path / "dev.bsc"
        cli.compress_file(str(inp), str(dev), params(switches), quiet=True,
                          device="cpu")
    finally:
        sys.setswitchinterval(old)
    assert sorted(seen) == [777] + [MIB] * 6
    assert ring.held == set() and len(ring.made) <= cli.READ_RING
    if switches == "-b1G":
        assert ring.peak > 1
    assert blocks_of(dev) == blocks_of(host)
    if switches == "-b1Gt":
        assert dev.read_bytes() == host.read_bytes()


@pytest.mark.parametrize("switches,copied", [("", False), ("-r", True),
                                             ("-cp", True)])
def test_prepare_copies_only_under_a_filter(monkeypatch, switches, copied):
    """cli.prepare hands the API the block's own memory with no filter,
    and a buffer of its own under -r (records reordered) and -cp
    (reversed)."""
    walk = np.cumsum(np.random.default_rng(23).integers(-3, 4, 75_000))
    rec = (walk + 10**6).astype("<i4").view(np.uint8)  # records of 4
    handed = []

    def spy(block, *a, **k):
        handed.append(block)
        return api.store(block)

    monkeypatch.setattr(api, "compress", spy)
    block = rec.copy()
    rs, _, _ = cli._compress_one(params(*switches.split()), block)
    assert np.shares_memory(handed[0], block) != copied
    assert rs == (4 if switches == "-r" else 1)
    assert np.array_equal(block, rec)


def test_ring_lends_each_buffer_to_one_holder_at_a_time():
    """Sixteen threads take and give a ring of three a hundred times each
    with a short switch interval: each writes its mark over the whole
    buffer it holds and finds it there before giving it back, and the
    ring makes three buffers."""
    ring = bufpool.Ring(3, pinned=False)
    made, lock, bad = set(), threading.Lock(), []

    def run(mark):
        for i in range(100):
            buf = ring.take(4096 + i)
            with lock:
                made.add(buf.ctypes.data)
            buf[:] = mark
            time.sleep(0)
            if not (buf == mark).all():
                bad.append(mark)
            ring.give(buf[: i + 1])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(m,))
                   for m in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(made) == 3
    assert not ring.lends(np.zeros(1, np.uint8))


class _FailingRing(_WatchedRing):
    """A ring whose third take raises, as a failed page-locked allocation
    would."""

    def take(self, nbytes):
        if len(self.made) == 2:
            raise RuntimeError("no page-locked memory")
        return super().take(nbytes)


def test_a_failed_read_stops_the_farm(tmp_path, monkeypatch):
    """-b1 -G over 4 MiB where the read ring fails at the third block: the
    farm's workers finish the two blocks read, stop, and give their
    buffers back, and compress_file raises the reader's error."""
    ring = _FailingRing(cli.READ_RING, pinned=False)
    monkeypatch.setattr(cli, "_rings", {False: ring})
    inp = tmp_path / "in"
    inp.write_bytes(zipf_text(4 * MIB).tobytes())
    box = {}

    def run():
        try:
            cli.compress_file(str(inp), str(tmp_path / "a.bsc"),
                              params("-b1G"), quiet=True, device="cpu")
        except RuntimeError as e:
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert str(box["error"]) == "no page-locked memory"
    assert len(ring.made) == 2 and ring.held == set()
