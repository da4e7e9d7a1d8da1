"""K15, the LZP screen (``ops/lzp_screen``): its plain version against the
native LZP, which must reject every block the screen rules out; planted
repeats at and under ``min_len`` and across a part boundary; its keys
against Python integers; ``api.compress`` writing the same bytes with the
screen as with a screen that always says "may match", where LZP is
rejected and where it pays; the routes that must not screen; the span it
records and the benchmark's reader of it; and, on the card, the kernel
against the plain version.

The file imports no JAX, so the card test runs there with

    python -m pytest --noconftest -m gpu tests/test_torch_lzp_screen.py -q
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import libbsc_tpu_torch as P
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine
from libbsc_tpu_torch.ops import lzp_screen as Z
from libbsc_tpu_torch.ops import wide

REPO = Path(__file__).resolve().parent.parent
ML, HS = C.DEFAULT_LZPMINLEN, C.DEFAULT_LZPHASHSIZE
TWO = (1 << 20) + 12_345         # 2 parts
EIGHT = (16 << 20) + 777         # 8 parts
M64 = (1 << 64) - 1


def zipf_text(n: int, seed: int = 3180000101) -> np.ndarray:
    """The benchmark's text traffic (portbench/gen/text.py) on the CPU."""
    from portbench.gen import text

    params = json.loads((REPO / "portbench" / "traffic" / "text_1blk.json")
                        .read_text())["params"]
    return text.make(params, seed, 0, n).numpy()


def random_bytes(n: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def phrases(n: int, seed: int = 3) -> bytes:
    """Eight log lines over and over, each longer than min_len: LZP
    pays."""
    rng = np.random.default_rng(seed)
    lines = [b"%d service=api level=info request handled path=/v1/items/%d "
             b"status=200 bytes=%d elapsed_ms=%d user_agent=client/1.%d\n"
             % (i, 1000 + i, 4096 * i, 7 * i, i) * 2 for i in range(8)]
    out = bytearray()
    while len(out) < n:
        out += lines[rng.integers(0, len(lines))]
    return bytes(out[:n])


def planted(n: int, length: int, src_part: int, dst_part: int) -> np.ndarray:
    """Random bytes with the ``length`` bytes at 1,000 into part
    ``src_part`` copied to 5,000 into part ``dst_part``."""
    x = random_bytes(n, 11)
    geo = Z.geometry(n, ML)
    src = geo.windows[src_part][0] + 1000
    dst = geo.windows[dst_part][0] + 5000
    x[dst:dst + length] = x[src:src + length]
    x[dst - 1] = x[src - 1] ^ 1  # the repeat is exactly ``length`` long
    x[dst + length] = x[src + length] ^ 1
    return x


CASES = {
    # name: (block, the flags expected)
    "zipf_text_2_parts": (lambda: zipf_text(TWO), [0, 0]),
    "zipf_text_8_parts": (lambda: zipf_text(EIGHT), [0] * 8),
    "random_2_parts": (lambda: random_bytes(TWO), [0, 0]),
    "random_8_parts": (lambda: random_bytes(EIGHT), [0] * 8),
    "zeros_2_parts": (lambda: np.zeros(TWO, np.uint8), [1, 1]),
    "zeros_8_parts": (lambda: np.zeros(EIGHT, np.uint8), [1] * 8),
    "repeat_of_min_len": (lambda: planted(TWO, ML, 1, 1), [0, 1]),
    "repeat_of_min_len_less_1": (lambda: planted(TWO, ML - 1, 0, 0),
                                 [0, 0]),
    "repeat_across_parts": (lambda: planted(TWO, 4 * ML, 0, 1), [0, 0]),
    "phrases": (lambda: np.frombuffer(phrases(TWO), np.uint8).copy(),
                [1, 1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_screen_is_sound(case):
    """Flags as expected; where every flag is 0 the native LZP rejects the
    block (the screen's contract), and a 1 where LZP pays."""
    make, want = CASES[case]
    block = make()
    flags = Z.screen(torch.from_numpy(block), ML)
    assert flags.dtype == torch.int32
    assert flags.tolist() == want
    assert torch.equal(flags, Z.screen_plain(torch.from_numpy(block), ML))
    lz = engine.lzp_compress(block, HS, ML, C.FEATURE_MULTITHREADING)
    if not any(want):
        assert lz is None
    if case == "phrases":
        assert lz is not None and len(lz) < len(block) // 2


@pytest.mark.parametrize("min_len", [4, 5, 7, 128, 129, 255])
def test_keys_equal_python_integers(min_len):
    """The plain keys (int64 arithmetic wrapping mod 2**64) against the
    definition in Python integers."""
    def mix(z):
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
        return z ^ (z >> 31)

    b = random_bytes(700, min_len)
    keys = Z.keys_plain(torch.from_numpy(b), min_len)
    assert keys.numel() == len(b) - min_len + 1
    for g in (0, 1, 33, len(b) - min_len):
        f = 0
        for x in b[g:g + min_len]:
            f = (f * Z.BASE + int(x)) & M64
        assert int(keys[g]) & M64 == mix(f) | 1


@pytest.mark.parametrize("n", [100, 256 * 1024 - 1, 4 << 20, (16 << 20) + 5])
def test_geometry_is_the_native_split(n):
    """Parts as native/lzp.cc lzp_num_blocks cuts them; eligible starts
    [start + 4, end - min_len - 32)."""
    geo = Z.geometry(n, ML)
    assert geo.parts == {100: 1, 256 * 1024 - 1: 1, 4 << 20: 4}.get(n, 8)
    for p, (lo, count) in enumerate(geo.windows):
        start = p * (n // geo.parts)
        end = n if p == geo.parts - 1 else start + n // geo.parts
        assert lo == start + 4
        assert count == max(0, end - ML - 32 - lo)
    assert -(-max(c for _, c in geo.windows) // geo.per_part) <= Z.MEAN


def test_full_bucket_says_may_match(monkeypatch):
    """A bucket over CAP keys proves nothing: its part reads 1."""
    block = torch.from_numpy(random_bytes(TWO))
    assert Z.screen_plain(block, ML).tolist() == [0, 0]
    monkeypatch.setattr(Z, "CAP", 10)
    assert Z.screen_plain(block, ML).tolist() == [1, 1]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1000, dtype=torch.uint8)
    with pytest.raises(TypeError):
        Z.screen(x.to(torch.int32), ML)
    with pytest.raises(ValueError):
        Z.screen(x[::2], ML)
    with pytest.raises(ValueError):
        Z.screen(x, 3)


# -- through the API -----------------------------------------------------------

M9E4 = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX, coder=C.CODER_QLFC_WIDE)


@pytest.fixture
def lzp_calls(monkeypatch):
    """The host LZP attempts, counted; 1,024 lanes from 1 MiB, so the
    fused route runs on the CPU at that size."""
    calls = []
    real = engine.lzp_compress

    def counted(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(engine, "lzp_compress", counted)
    policy = wide.pick_lanes_policy
    monkeypatch.setattr(wide, "pick_lanes_policy",
                        lambda n: 1024 if n >= 1 << 20 else policy(n))
    P.init(C.FEATURE_CUDA, device="cpu")
    return calls


def _always_may(x, min_len):
    return torch.ones(Z.num_parts(x.numel()), dtype=torch.int32)


@pytest.mark.parametrize("config", ["m9e4", "default"])
@pytest.mark.parametrize("kind", ["zipf_text", "phrases"])
def test_api_bytes_equal_without_the_screen(lzp_calls, monkeypatch, config,
                                            kind):
    """The same archive block whether the screen runs or always says "may
    match"; the host attempt is skipped only where LZP is rejected."""
    data = (zipf_text(TWO).tobytes() if kind == "zipf_text"
            else phrases(TWO))
    kw = M9E4 if config == "m9e4" else {}
    screened = P.compress(data, features=C.FEATURE_CUDA, **kw)
    attempts = len(lzp_calls)
    monkeypatch.setattr(Z, "screen", _always_may)
    assert P.compress(data, features=C.FEATURE_CUDA, **kw) == screened
    assert len(lzp_calls) == attempts + 1
    assert attempts == (0 if kind == "zipf_text" else 1)
    lzp = (int.from_bytes(screened[8:12], "little") >> 8) & 0xFFFF
    assert (lzp != 0) == (kind == "phrases")
    assert P.decompress(screened) == data


@pytest.mark.parametrize("route", ["under_1_MiB", "no_device_route",
                                   "lzp_off"])
def test_routes_that_do_not_screen(lzp_calls, monkeypatch, route):
    """Blocks under 1 MiB, blocks without a device route and blocks
    without LZP never reach the screen."""
    def refused(*a, **k):
        raise AssertionError("screened")

    monkeypatch.setattr(engine, "lzp_screen", refused)
    data = zipf_text(TWO).tobytes()
    if route == "under_1_MiB":
        data = data[:(1 << 20) - 1]
    features = C.FEATURE_NONE if route == "no_device_route" \
        else C.FEATURE_CUDA
    lzp = (0, 0) if route == "lzp_off" else (HS, ML)
    out = P.compress(data, *lzp, features=features)
    assert len(lzp_calls) == (0 if route == "lzp_off" else 1)
    assert P.decompress(out) == data


def _profiled(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()


@pytest.mark.parametrize("kind", ["zipf_text", "phrases"])
def test_screen_span(lzp_calls, kind):
    """An lzp_screen span under api.compress: out the parts that may
    match, tagged with the part count; no lzp_compress span where it
    reads 0."""
    from libbsc_tpu_torch.utils import trace

    data = (zipf_text(TWO).tobytes() if kind == "zipf_text"
            else phrases(TWO))
    _profiled(lambda: P.compress(data, features=C.FEATURE_CUDA, **M9E4))
    rec = trace.spans()
    [api] = [s for s in rec if s.name == "api.compress"]
    [sp] = [s for s in rec if s.name == "lzp_screen"]
    assert sp.parent == api.id and sp.tag == "2" and sp.nbytes == TWO
    lzp = [s for s in rec if s.name == "lzp_compress"]
    if kind == "zipf_text":
        assert sp.out == 0 and not lzp
    else:
        assert sp.out == 2 and len(lzp) == 1 and lzp[0].out > 0


def S(id, name, parent=None, out=None):
    return SimpleNamespace(id=id, name=name, start=0, end=1, parent=parent,
                           call=1, out=out, offset=0, nbytes=0, tag="",
                           thread=1)


@pytest.mark.parametrize("record,want", [
    ([S(2, "api.compress"), S(3, "api.compress"),
      S(4, "lzp_screen", 2, 0), S(5, "lzp_screen", 3, 1),
      S(6, "api.decompress")], 50.0),
    ([S(2, "api.compress"), S(4, "lzp_screen", 2, 0)], 100.0),
    ([S(2, "api.compress"), S(3, "lzp_compress", 2, 0)], None),
    ([], None),
])
def test_screened_share_reader(monkeypatch, record, want):
    """portbench/metrics/lzp_screened_pct.encode.py: the share of the
    encode phase's api.compress spans with an lzp_screen child reading
    0; nothing where the program records no lzp_screen span."""
    from portbench.harness import Cell
    from libbsc_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: list(record))
    cell = Cell.__new__(Cell)
    cell.dir = REPO / "portbench"
    got = cell.reader("lzp_screened_pct.encode").read(None)
    assert got == (None if want is None else pytest.approx(want))


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain(cuda, case):
    """K15's flags against the plain version's on the same block, and its
    launch counted."""
    block = torch.from_numpy(CASES[case][0]())
    before = Z.LAUNCHES["lzp_screen"]
    got = Z.screen(block.to(cuda), ML)
    torch.cuda.synchronize()
    assert got.is_cuda
    assert got.cpu().tolist() == Z.screen_plain(block, ML).tolist()
    assert Z.LAUNCHES["lzp_screen"] == before + 1
