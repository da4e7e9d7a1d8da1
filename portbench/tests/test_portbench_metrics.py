"""Each metric reader on a small hand-made run and Chrome trace, against
numbers worked out by hand."""

import struct

import pytest

from portbench.harness import Call, Cell, Phase, Run
from portbench.memfile import MemFile
from portbench.ref import container
from portbench.tests.helpers import REPO
from portbench.trace import Trace


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


EVENTS = [
    X("portbench::encode", "user_annotation", 0, 1000),
    X("portbench::decode", "user_annotation", 1000, 1000),
    X("aten::sort", "cpu_op", 550, 400),
    X("bwt_boot_keys_kernel", "kernel", 100, 50),
    X("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>",
      "kernel", 160, 40),
    X("wide_model_kernel", "kernel", 300, 100),
    X("wide_rans_chain_kernel", "kernel", 400, 50),
    X("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 500, 20),
    X("void wide_chain_kernel<true>(int const*)", "kernel", 1100, 200),
    X("unbwt_chase_kernel", "kernel", 1300, 50),
    X("unbwt_table_kernel", "kernel", 1320, 40),   # overlaps the chase
]


def wide_block(n, L, max_bits, sizes, gunits) -> bytes:
    body = struct.pack("<IHHI", n, L, 7, max_bits)
    body += struct.pack(f"<{L}I", *sizes) + struct.pack("<8I", *gunits)
    return container.block_header(28 + len(body), n, 2 | 4 << 5, 1, 0,
                                  0) + body


@pytest.fixture
def run():
    cell = Cell.__new__(Cell)
    L = 1024
    sizes = [1000] * 1000 + [0] * 24
    blk = wide_block(1_000_000, L, 3000, sizes, [500] * 8)
    arc = b"bsc1" + struct.pack("<i", 1) + struct.pack("<qbb", 0, 1, 1) + blk
    out = MemFile("arc", arc)
    enc = Phase("encode", 0.0, 2.0, blocks=2)
    enc.calls = [Call(0.0, 0.5, 0, out, None, 1_000_000, None, len(arc)),
                 Call(0.5, 2.0, 0, out, None, 1_000_000, None, len(arc))]
    dec = Phase("decode", 2.0, 2.5, blocks=2)
    dec.calls = [Call(2.0, 2.25, 0, MemFile("r"), None, len(arc),
                      enc.calls[0], 1_000_000),
                 Call(2.25, 2.5, 0, MemFile("r"), None, len(arc),
                      enc.calls[1], 1_000_000)]
    r = Run(cell, [None], 1 << 20, setup_s=12.5, encode=enc, decode=dec,
            trace=Trace(EVENTS))
    yield r
    out.close()


def read(name, run):
    cell = Cell.__new__(Cell)
    cell.dir = REPO / "portbench"
    return cell.reader(name).read(run)


def test_end_to_end(run):
    assert read("encode_MBps", run) == pytest.approx(1.0)
    assert read("decode_MBps", run) == pytest.approx(4.0)
    # 95th percentile of 500 and 1500 ms, linear: 500 + 0.95 * 1000
    assert read("encode_p95_ms", run) == pytest.approx(1450.0)
    arc = run.encode.calls[0].out_bytes
    assert read("ratio", run) == pytest.approx(1_000_000 / arc)
    assert read("setup_s", run) == 12.5


def test_idle(run):
    # encode: 50 + 40 + 100 + 50 + 20 us busy of 1000
    assert read("device_idle_pct.encode", run) == pytest.approx(74.0)
    # decode: 200 + the union of [1300, 1350) and [1320, 1360)
    assert read("device_idle_pct.decode", run) == pytest.approx(74.0)


def test_kernel_ms(run):
    assert read("bwt_kernel_ms.encode", run) == pytest.approx(0.025)
    assert read("sort_kernel_ms.encode", run) == pytest.approx(0.020)
    assert read("coder_kernel_ms.encode", run) == pytest.approx(0.075)
    assert read("coder_kernel_ms.decode", run) == pytest.approx(0.145)


def test_rooflines(run):
    L, mb, live, units = 1024, 3000, 1000, 4000
    planes, probs = 750 * L, 4 * mb * L
    k12 = (planes + probs + 4 * 281) + (planes + probs
                                        + 4 * (units - 2 * live) + 32
                                        + 4 * L)
    # one K1 launch for the phase's two blocks: one block's bound
    want = 100 * (k12 / 3.35e12) / 150e-6
    assert read("coder_roofline_pct.encode", run) == pytest.approx(want)
    k3 = 2 * units + 16 * L + 4 * 281 + 16 * 363 + 1_000_000
    want = 100 * (k3 / 3.35e12) / 200e-6
    assert read("coder_roofline_pct.decode", run) == pytest.approx(want)


def test_no_trace_reads_nothing(run):
    run.trace = None
    for name in ("device_idle_pct.encode", "bwt_kernel_ms.encode",
                 "coder_roofline_pct.decode"):
        assert read(name, run) is None


def test_breakdown(run):
    from portbench.harness import breakdown_of

    b = breakdown_of(run.trace, 0, 2000)
    assert b["device_ops"][0] == ["void wide_chain_kernel<true>(int const*)",
                                  200e-6]
    # the longest gap, [1360, 2000), in the decode phase, in its span;
    # then [600, 1100), during aten::sort
    assert b["idle_gaps"][0] == ["decode: portbench::decode", 640e-6]
    assert b["idle_gaps"][1] == ["encode: aten::sort", 580e-6]
