#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # one CUDA card, about eight minutes

Phases, one line or more each:
  1. build: the CUDA kernels (one nvcc per csrc/*.cu, all started together)
     and the native host runtime, with the card's name and power limit;
  2. the five wide-coder kernels.  check: each against its plain PyTorch
     version on a 4 MiB block of the corpus (the smallest block on which
     the 1024-lane policy holds) through the port's own stages (native
     LZP, device wide-aux BWT, device lane table and bit schedule): K1's
     probability plane, K2's and K5's payloads (also against the native
     codec with the same lane table, v3 and v2), K3's and K4's decoded
     blocks (also against the input), all exactly equal (tolerance 0: a
     lossless codec), the plain versions timed by the wall clock; K3 and
     K4 also on three hard blocks (hard_blocks: high-entropy bytes, long
     all-zero lanes, a skewed lane table with an empty group and dead
     lanes), against their plain versions and the input; K1 + K2 and K5
     on those blocks, each with its own lane table, against the native
     codec and, through the device decode, the input, K2 against its
     plain version (and, on the skewed block, K1 and K5 against theirs).
     time:
     each kernel timed with CUDA events on one 25 MiB block's own inputs
     (bsc's default -b25; kernels only, after a warm-up), its payload or
     decoded block again held against the native codec or the input,
     with its measured cycles per iteration (ms x max SM clock /
     iterations);
  3. the v3 main path: the 25 MiB block through api.compress and
     api.decompress with -m9 -e4 -G, launch counters set to 0 just before
     and read just after.  K1, K2 and K3 must have launched and K4 and K5
     not; the archive must equal the one composed from the stages and the
     native wide encode; both the device decode and the native host decode
     must restore the input.  Then each stage of the fused route is timed
     once, stage by stage, for the breakdown; the archive those stages
     compose must equal the main path's, so the breakdown cannot drift
     from the code it times;
  4. the v2 main path: the same with wide_kernels.RANS = False.  K5 and K4
     must have launched and K1, K2 and K3 not;
  5. many blocks: three other 25 MiB blocks of the corpus, each after the
     port's device BWT, through device_encode_many (each payload must
     equal device_encode of its block) and device_decode_many (each block
     must come back); prints the sustained MB/s;
  6. the sharded transform step on a one-GPU mesh (make_mesh(1) on
     cuda:0) over a local batch of two 25 MiB blocks of that corpus, with
     sorter="bwt" and with sorter="st", k=5: U and the primary must equal
     the native tbsc_bwt_encode, ops/bwt.bwt_encode's aux the native aux
     indexes, the ST output and index the native tbsc_st_encode, the
     histograms torch.bincount; K6 must launch once a block in each step.
     The ST outputs, coded by the native QLFC static coder and framed with
     no aux indexes, must come back through api.decompress.  K7's
     adler32_device of each device-resident block must equal the host
     Adler-32.  Prints each step's wall time and MB/s;
  7. the -m5 -G path: the 25 MiB block through api.compress with
     BLOCKSORTER_ST5 + CODER_QLFC_STATIC and FEATURE_CUDA (the ST sorts on
     the card); the archive must equal the host-ST archive byte for byte
     and api.decompress must restore it.  Prints encode and decode MB/s;
  8. the CLI on the card (cli.py): a file of the corpus's first two 25 MiB
     blocks and a 1,234,567-byte tail (which takes the per-stage route).
     (a) -m9 -e4 -G through cli.compress_file with the farm (three device
     workers and a host worker), launch counters set to 0 just before and
     read just after: K1 and K2 must have launched; cli.decompress_file
     with -G must launch K3 and restore the file, and the decode without
     -G (the native host route) must restore it too; the same file with
     -t (one worker) for comparison, both ways; (b) the -G default config (-m0 -e1):
     every container entry must equal the host archive's, and
     engine.DEVICE_ROUTES must show that the farm's device workers sorted
     blocks on the card (the farm hands each block to whichever worker
     takes it first, so the host worker may take a 25 MiB block: the
     count is printed); then the device BWT route (counted) and the host
     BWT on one 25 MiB block, equal and each timed; (c)
     one subprocess each of `python3 -m libbsc_tpu_torch.cli e IN OUT -m9
     -e4 -G` and `d OUT R -G`: both must exit 0 and R must equal IN.
     Prints each file MB/s with the card's name and power limit.
  9. scale-out and DC3: (a) parallel.make_sharded_st_step, the sample
     sort, on meshes that list cuda:0 several times: the corpus's first
     25 MiB block on (1, 4) with k = 8 and k = 5, the first two blocks on
     (2, 2) with k = 8; each output and index must equal ops/st.st_encode
     on the card and the native ST, ok all True; the step and st_encode
     are timed (on one card the step does more work than one sort; its
     speed across cards is not measured here); (b) the multi-process
     farm, parallel/distributed.py, on phase 8's file with -m9 -e4: once
     in this process, once as two `python3 -c` ranks on one gloo group
     (a free TCP port), both on cuda:0; each rank prints its device, its
     block offsets and its K1/K2 launches (both must launch) and must
     import no JAX; the two-process archive must decode with cli -G (K3
     launched) to the file, and its entries must equal the one-process
     archive's; (c) the LZP'd 25 MiB block through engine.bwt_encode with
     TBSC_BWT_DEVICE=1, by prefix quadrupling and with TBSC_BWT=dc3 by
     DC3, in turns (prefix, dc3, dc3, prefix), each equal to the native
     BWT, timed, with its peak device memory; DEVICE_ROUTES must count
     both; both variables are restored.

Phase 2 also holds K6 (byte histogram) and K7 (Adler-32 partials) against
their plain versions on the 4 MiB check block, an all-zero 4 MiB block and
an odd-length view at an odd offset, exactly, and times them (in a CUDA
graph, so that a call of microseconds is not timed by its dispatch), their
plain versions and K6's library call (torch.bincount) on the 25 MiB block,
each launch on one of four copies in turn so that its input is not in the
50 MB L2 cache; K6 also on an all-zero block, uniform random bytes and the
text at offset 3, each of 25 MiB and held against its plain version.

The script prints a JSON line of per-kernel numbers (launches from the
main path that runs the kernel: K1-K3 phase 3, K4 and K5 phase 4, K6 and
K7 phase 6; cli_launches of K1-K3 from phase 8's -m9 -e4 -G encode and
decode, counted from several threads, so read as launched or not;
farm_launches of K1-K3 from phase 9's farm: the one-process encode, the
two ranks' encodes summed from their lines, and the -G decode), the
nvidia-smi line, and, last, {"ok": true, "device": ...}
only when every phase passed.  It exits non-zero without CUDA or outside
a checkout of the repository.

Each kernel's bound_ms is the larger of its bytes (each input read once,
each output written once; for the encode kernels the max_bits rows of
planes and probabilities they touch) over 3.35 TB/s and its operations
(one per coded bit, a floor) over 67 TFLOP/s, the H100 SXM's device-memory
rate and peak outside the tensor cores.  K3/K4's record buffer is scratch
between their two kernels, not an input or output of the function.
"""

from __future__ import annotations

import itertools
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores
BLOCK = 25 << 20             # bsc's default block size, -b25
PLAIN_BLOCK = 4 << 20        # phase 2's check block
HARD_BLOCK = 1 << 20         # the hard decode blocks (the zero one: 4 MiB)
MANY_BLOCKS = 3
STEP_BLOCKS = 2              # phase 6's local batch
CLI_TAIL = 1_234_567         # phase 8's file: two blocks and this tail
TIMED_LAUNCHES = 5
STATS_LAUNCHES = 40          # K6 and K7 take microseconds a launch
COLD_COPIES = 4              # 4 x 25 MiB exceeds the 50 MB L2 cache
REPLACES = {  # kernel -> the Pallas kernel it replaces
    "wide_model": "libbsc_tpu/ops/wide_kernels.py:546",
    "wide_rans": "libbsc_tpu/ops/wide_kernels.py:749",
    "wide_rc_encode": "libbsc_tpu/ops/wide_kernels.py:432",
    "wide_decode": "libbsc_tpu/ops/wide_kernels.py:1729",
    "wide_decode_v2": "libbsc_tpu/ops/wide_kernels.py:1729",
    "byte_hist": "libbsc_tpu/ops/pallas_kernels.py:64",
    "adler_partials": "libbsc_tpu/ops/pallas_kernels.py:100",
}
V3 = ("wide_model", "wide_rans", "wide_decode")
V2 = ("wide_rc_encode", "wide_decode_v2")
SOURCE = {"wide_decode_v2": "wide_decode"}  # K4 is K3's template twin


def make_corpus(n_bytes: int) -> bytes:
    """Deterministic text-like corpus (seeded Zipf word mix + hex tokens),
    the same bytes as the repository's bench.py corpus."""
    rng = np.random.default_rng(0xB5C)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    vocab = []
    for _ in range(4096):
        ln = int(rng.integers(2, 13))
        vocab.append(bytes(alphabet[rng.integers(0, 26, ln)]))
    ranks = rng.zipf(1.3, size=n_bytes // 4) % 4096
    out = bytearray()
    col = 0
    for i, r in enumerate(ranks):
        if len(out) >= n_bytes:
            break
        if i % 37 == 13:  # sprinkle low-compressibility tokens
            tok = bytes(rng.integers(0, 256, 8, dtype=np.uint8)).hex().encode()
        else:
            tok = vocab[int(r)]
        out += tok
        col += len(tok) + 1
        if col > 72:
            out += b"\n"
            col = 0
        else:
            out += b" "
    return bytes(out[:n_bytes])


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls captured in one
    CUDA graph.  The replay launches the captured kernels back to back
    with no host work between them, so a call that takes microseconds is
    timed on the device, not by how fast Python dispatches it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """(fn(), wall milliseconds up to a device synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NONTENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compose(data: bytes, lzp: bool, primary: int, aux: np.ndarray,
            payload: bytes) -> bytes:
    """The -m9 -e4 block: 28-byte header, wide payload, and the wide-aux
    tail [i32 aux x K][u32 K][u8 255]."""
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.format.header import pack_block_header, pack_mode
    from libbsc_tpu_torch.utils.adler32 import adler32

    mode = pack_mode(C.BLOCKSORTER_BWT_WIDEAUX, C.CODER_QLFC_WIDE,
                     C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN)
    if not lzp:  # LZP does not pay: the mode word records no LZP
        mode &= 0xFF
    payload = payload + aux.astype("<i4").tobytes() \
        + struct.pack("<I", len(aux)) + b"\xff"
    return pack_block_header(len(payload) + C.HEADER_SIZE, len(data), mode,
                             int(primary), adler32(data),
                             adler32(payload)) + payload


def stages(data: bytes, features: int, device) -> dict:
    """The port's own stages on one block, as the fused route runs them:
    native LZP, device wide-aux BWT, device lane table and bit schedule;
    and, for each coder (v3 rANS, v2 range), the native wide encode with
    that lane table and the -m9 -e4 archive composed from it."""
    import torch

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt, wide
    from libbsc_tpu_torch.ops import wide_kernels as WK

    lz = engine.lzp_compress(np.frombuffer(data, np.uint8),
                             C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                             features)
    lzp = lz is not None
    if not lzp:
        lz = np.frombuffer(data, np.uint8)
    if wide.pick_lanes_policy(len(lz)) != WK.LANES:
        fail(f"a {len(lz)}-byte LZP output does not get 1024 lanes")
    r = engine.wideaux_rate(len(lz))
    U, primary, aux = bwt.bwt_encode_wideaux_device(
        torch.from_numpy(lz.copy()).to(device), r)
    prep = WK.resident_prep(U)
    if prep is None:
        fail("the device schedule refused the block")
    planes, sizes, max_bits, _IT = prep
    u_host = U.cpu().numpy()
    native, archive = {}, {}
    for rans in (True, False):
        native[rans] = wide.wide_encode(u_host.tobytes(), n_lanes=WK.LANES,
                                        sizes=sizes, rans=rans)
        archive[rans] = compose(data, lzp, int(primary), aux.cpu().numpy(),
                                native[rans])
    coded = int(sum(((planes >> s) & 2).ne(0).sum() for s in (0, 2, 4, 6)))
    return {"U": u_host, "planes": planes, "sizes": sizes,
            "max_bits": max_bits, "coded": coded, "native": native,
            "archive": archive}


def encode_payloads(st: dict) -> dict:
    """K1 + K2 and K5 on the block's planes: kernel name -> (its output,
    the payload assembled from it).  The payloads must be the native
    codec's with the same lane table."""
    from libbsc_tpu_torch.ops import wide_kernels as WK

    planes, sizes, max_bits = st["planes"], st["sizes"], st["max_bits"]
    n = len(st["U"])
    probs = WK.model_probs(planes, max_bits)
    k2 = WK.rans_encode(planes, probs, max_bits)
    k5 = WK.rc_encode(planes, max_bits)
    out = {"wide_model": (probs, None),
           "wide_rans": (k2, WK._assemble_rans(n, *k2, sizes, max_bits)),
           "wide_rc_encode": (k5, WK._assemble(n, *k5, sizes, max_bits))}
    for name, rans in (("wide_rans", True), ("wide_rc_encode", False)):
        if out[name][1] is None or out[name][1] != st["native"][rans]:
            fail(f"{name}: the payload differs from the native codec's")
    return out


def decode_args(payload: bytes, device) -> tuple:
    from libbsc_tpu_torch.ops import wide_kernels as WK

    p = WK._dec_parse(payload)
    if p is None:
        fail("the payload does not take the kernel decode")
    return WK._dec_args(p, device), p["rans"], int(p["gunits"].sum())


def check_kernels(st: dict, device) -> dict:
    """Phase 2 check: each kernel against its plain version on the main
    path's inputs for this block.  Returns name -> {max_abs_err,
    plain_ms}."""
    from libbsc_tpu_torch.ops import wide_kernels as WK

    planes, sizes, max_bits = st["planes"], st["sizes"], st["max_bits"]
    U = st["U"]
    n = len(U)
    res = {}
    enc = encode_payloads(st)

    probs = enc["wide_model"][0]
    probs_p, ms = timed(lambda: WK.model_probs_plain(planes, max_bits))
    res["wide_model"] = ((probs.long() - probs_p.long()).abs().max(), ms)
    del probs_p

    units, counts, fx = enc["wide_rans"][0]
    (pu, pc, pf), ms = timed(lambda: WK.rans_encode_plain(
        planes, probs, max_bits, int(units.shape[1])))
    if WK._assemble_rans(n, pu, pc, pf, sizes, max_bits) != \
            enc["wide_rans"][1]:
        fail("K2's payload differs from its plain version's")
    res["wide_rans"] = (max((counts.long() - pc.long()).abs().max(),
                            (fx.long() - pf.long()).abs().max()), ms)
    del pu, probs, enc["wide_model"]

    units, counts = enc["wide_rc_encode"][0]
    (pu, pc), ms = timed(lambda: WK.rc_encode_plain(
        planes, max_bits, int(units.shape[1])))
    if WK._assemble(n, pu, pc, sizes, max_bits) != enc["wide_rc_encode"][1]:
        fail("K5's payload differs from its plain version's")
    res["wide_rc_encode"] = ((counts.long() - pc.long()).abs().max(), ms)
    del pu

    for name, enc_name in (("wide_decode", "wide_rans"),
                           ("wide_decode_v2", "wide_rc_encode")):
        args, rans, _ = decode_args(enc[enc_name][1], device)
        out = WK.decode_lanes(*args, rans=rans)
        out_p, ms = timed(lambda: WK.decode_lanes_plain(*args, rans=rans))
        res[name] = ((out.long() - out_p.long()).abs().max(), ms)
        if out.cpu().numpy().tobytes() != U.tobytes():
            fail(f"{name}: the decoded block differs from the input")
    out = {}
    for name, (err, ms) in res.items():
        err = int(err)
        if err:
            fail(f"{name} differs from its plain version by {err}")
        out[name] = {"max_abs_err": err, "plain_ms": ms}
        print(f"phase 2 check {name}: equal to plain (plain {ms:.1f} ms), "
              f"{max_bits} iterations, {n} bytes", flush=True)
    return out


def hard_blocks(text: bytes) -> dict:
    """The hard inputs of the wide coder's kernels, name -> (block, lane
    table or None for the native balancer's): high-entropy bytes (ranks up
    to 255, the most stream units a step, group rings that wrap some 15
    times; 30% zeros, since uniform bytes do not code smaller than the
    block); an all-zero block of 4 MiB + 3 over 60 live lanes, each one
    run of about 70,000 bytes (over 2^16, where the run exponent passes
    16); and text under a skewed table (log-normal spans, group 2 empty,
    every third lane of group 5 dead; an eighth of the size and spans
    capped at 4x the mean, so that the plain versions' loops stay
    short)."""
    g = np.random.default_rng(0x4B34)
    n = HARD_BLOCK
    rand = np.where(g.random(n) < 0.3, 0, g.integers(0, 256, n))
    zn = PLAIN_BLOCK + 3
    live = np.arange(0, 60 * 17, 17)
    zeros = np.zeros(1024, np.int64)
    zeros[live] = zn // len(live)
    zeros[live[:zn % len(live)]] += 1
    w = g.lognormal(0.0, 0.75, 1024)
    w[256:384] = 0
    w[640:768:3] = 0
    w = np.minimum(w, 4 * w[w > 0].mean())  # the longest lane, 4x the mean
    skew = np.floor(w / w.sum() * (n // 8)).astype(np.int64)
    skew[np.nonzero(w)[0][:n // 8 - skew.sum()]] += 1
    return {"random": (rand.astype(np.uint8).tobytes(), None),
            "zeros": (bytes(zn), zeros.astype(np.int32)),
            "skewed": (text[:n // 8], skew.astype(np.int32))}


def check_hard_decode(text: bytes, device) -> None:
    """Phase 2 check of K3 and K4 on the hard blocks, each against its
    plain version and the input, exactly."""
    from libbsc_tpu_torch.ops import wide
    from libbsc_tpu_torch.ops import wide_kernels as WK

    for case, (data, sizes) in hard_blocks(text).items():
        for name, rans in (("wide_decode", True), ("wide_decode_v2", False)):
            payload = wide.wide_encode(data, n_lanes=WK.LANES, sizes=sizes,
                                       rans=rans)
            if payload is None:
                fail(f"{name}: the {case} block does not code")
            args, _, units = decode_args(payload, device)
            out = WK.decode_lanes(*args, rans=rans)
            err = int((out.long() - WK.decode_lanes_plain(
                *args, rans=rans).long()).abs().max())
            if err:
                fail(f"{name} differs from its plain version by {err} on "
                     f"the {case} block")
            if out.cpu().numpy().tobytes() != data:
                fail(f"{name}: the decoded {case} block differs from the "
                     "input")
        lanes = args[2]
        print(f"phase 2 check hard {case}: K3 and K4 equal to plain and the "
              f"input; {len(data)} bytes, {int((lanes > 0).sum())} live "
              f"lanes, longest {int(lanes.max())} bytes, {args[5]} "
              f"iterations, {units} v2 units", flush=True)


def lane_planes(data: bytes, sizes):
    """(planes u8 [IT/4, 1024], sizes, max_bits) of the native walker over
    the lane table ``sizes`` (None: the native balancer's, as
    wide_kernels._host_prep)."""
    from libbsc_tpu_torch import native
    from libbsc_tpu_torch.ops import wide_kernels as WK

    if sizes is None:
        planes, sizes, max_bits, _ = WK._host_prep(data)
        return planes, sizes, max_bits
    n = len(data)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    pk, max_bits = WK.host_schedule_packed(
        np.frombuffer(data, np.uint8).copy(), n, native.i32p(sizes),
        -(-n // WK.LANES))
    if max_bits <= 0:
        fail("the native walker refused a lane table")
    IT = WK._it_bucket(max(max_bits, WK.TI))
    pk = np.pad(pk, ((0, 0), (0, max(0, IT // 4 - pk.shape[1]))))
    return np.ascontiguousarray(pk[:, : IT // 4].T), sizes, max_bits


def check_hard_encode(text: bytes, device) -> None:
    """Phase 2 check of K1 + K2 and K5 on the hard blocks, each block with
    its own lane table (the native balancer's for the high-entropy one):
    each payload must equal the native codec's with that table and come
    back through the device decode.  K2 is held against its plain version
    on every block (the all-zero one takes 35 steps, under one ring of its
    chain kernel); on the skewed block, the smallest, K1 and K5 too."""
    import torch

    from libbsc_tpu_torch.ops import wide
    from libbsc_tpu_torch.ops import wide_kernels as WK

    for case, (data, sizes) in hard_blocks(text).items():
        planes, sizes, max_bits = lane_planes(data, sizes)
        n = len(data)
        planes = torch.from_numpy(planes).to(device)
        probs = WK.model_probs(planes, max_bits)
        k2 = WK.rans_encode(planes, probs, max_bits)
        k5 = WK.rc_encode(planes, max_bits)
        for name, rans, payload in (
                ("K1 + K2", True, WK._assemble_rans(n, *k2, sizes, max_bits)),
                ("K5", False, WK._assemble(n, *k5, sizes, max_bits))):
            if payload is None or payload != wide.wide_encode(
                    data, n_lanes=WK.LANES, balanced=sizes is not None,
                    rans=rans, sizes=sizes):
                fail(f"{name}: the {case} block's payload differs from the "
                     "native codec's")
            if WK.device_decode(payload, device) != data:
                fail(f"{name}: the {case} block's payload does not decode "
                     "to the input")
        cap = int(k2[0].shape[1])
        pu, pc, pf = WK.rans_encode_plain(planes, probs, max_bits, cap)
        if not (torch.equal(k2[1], pc) and torch.equal(k2[2], pf) and all(
                torch.equal(k2[0][g, cap - c:], pu[g, cap - c:])
                for g, c in enumerate(pc.tolist()))):
            fail(f"wide_rans differs from its plain version on the {case} "
                 "block")
        del pu
        plain = ""
        if case == "skewed":
            if not torch.equal(probs, WK.model_probs_plain(planes, max_bits)):
                fail("wide_model differs from its plain version on the "
                     "skewed block")
            if WK._assemble(n, *WK.rc_encode_plain(
                    planes, max_bits, int(k5[0].shape[1])), sizes,
                    max_bits) != WK._assemble(n, *k5, sizes, max_bits):
                fail("wide_rc_encode differs from its plain version on the "
                     "skewed block")
            plain = "; K1 and K5 equal to their plain versions"
        live = 0 if sizes is None else int((np.asarray(sizes) > 0).sum())
        print(f"phase 2 check hard encode {case}: K1 + K2 and K5 payloads "
              f"equal to the native codec's and decoded to the input, K2 "
              f"equal to its plain version{plain};"
              f" {n} bytes, {live or WK.LANES} live lanes, {max_bits} "
              "iterations", flush=True)


def time_kernels(st: dict, device, clock_mhz: float) -> list:
    """Phase 2 time: each kernel with CUDA events on this block's inputs,
    its output held against the native codec or the input."""
    from libbsc_tpu_torch.ops import wide_kernels as WK

    planes, max_bits, coded = st["planes"], st["max_bits"], st["coded"]
    n = len(st["U"])
    enc = encode_payloads(st)
    probs = enc["wide_model"][0]
    # the bytes the encode kernels touch: max_bits rows of probabilities
    # and the plane rows that hold them, not the bucketed planes' padding
    plane_bytes = -(-max_bits // 4) * WK.LANES
    prob_bytes = 4 * max_bits * WK.LANES
    units2 = int(enc["wide_rans"][0][1].long().sum())
    units5 = int(enc["wide_rc_encode"][0][1].long().sum())
    runs = {
        "wide_model": (lambda: WK.model_probs(planes, max_bits),
                       plane_bytes + prob_bytes + 4 * 281),
        "wide_rans": (lambda: WK.rans_encode(planes, probs, max_bits),
                      plane_bytes + prob_bytes + 4 * units2 + 4 * 8
                      + 4 * WK.LANES),
        "wide_rc_encode": (lambda: WK.rc_encode(planes, max_bits),
                           plane_bytes + 4 * units5 + 4 * 8 + 4 * 281),
    }
    for name, enc_name in (("wide_decode", "wide_rans"),
                           ("wide_decode_v2", "wide_rc_encode")):
        args, rans, units = decode_args(enc[enc_name][1], device)
        if WK.decode_lanes(*args, rans=rans).cpu().numpy().tobytes() != \
                st["U"].tobytes():
            fail(f"{name}: the decoded block differs from the input")
        runs[name] = ((lambda a=args, r=rans: WK.decode_lanes(*a, rans=r)),
                      2 * units + 16 * WK.LANES + 4 * 281
                      + 16 * WK.SM_NPOS + n)
    del enc
    rows = []
    for name in ("wide_model", "wide_rans", "wide_rc_encode", "wide_decode",
                 "wide_decode_v2"):
        fn, nbytes = runs[name]
        ms = cuda_ms(fn, TIMED_LAUNCHES)
        b, by = bound_ms(nbytes, coded)
        cycles = ms * clock_mhz * 1e3 / max_bits
        rows.append({"name": name, "route": "cuda",
                     "source": "libbsc_tpu_torch/csrc/"
                               f"{SOURCE.get(name, name)}.cu",
                     "replaces": REPLACES[name], "ms": ms,
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "iters": max_bits, "coded_bits": coded,
                     "cycles_per_iteration": cycles})
        print(f"phase 2 time {name}: {ms:.3f} ms (bound {b:.4f} ms by {by})"
              f", {max_bits} iterations, {coded} coded bits, {n} bytes; "
              f"{cycles:.0f} cycles an iteration at {clock_mhz:.0f} MHz",
              flush=True)
    return rows


def main_path(data: bytes, features: int, composed: bytes, device,
              rans: bool):
    """Phase 3 (v3 coder) or 4 (v2): the -m9 -e4 -G main path on one
    block."""
    import torch

    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.ops import wide_kernels as WK

    phase, coder = (3, "v3") if rans else (4, "v2")
    WK.RANS = rans
    P.init(features, device=device)
    kw = dict(lzp_hash_size=C.DEFAULT_LZPHASHSIZE,
              lzp_min_len=C.DEFAULT_LZPMINLEN,
              block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
              coder=C.CODER_QLFC_WIDE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    WK.reset_launches()
    archive, t_enc = timed(lambda: P.compress(data, **kw))
    back, t_dec = timed(lambda: P.decompress(archive))
    launches = dict(WK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    WK.RANS = True
    ran, idle = (V3, V2) if rans else (V2, V3)
    if back != data:
        fail(f"{coder}: the device decode did not restore the input")
    if min(launches[k] for k in ran) == 0 or max(launches[k] for k in idle):
        fail(f"{coder}: the main path did not run its kernels, and only "
             f"them: {launches}")
    if archive != composed:
        fail(f"{coder}: the archive differs from the one composed from the "
             "stages")
    P.init(features & ~C.FEATURE_CUDA, device=device)
    if P.decompress(archive) != data:
        fail(f"{coder}: the native host decode did not restore the input")
    mb = len(data) / 1e6
    print(f"phase {phase} {coder} main path: {len(data)} -> {len(archive)} "
          f"bytes, encode {mb / t_enc * 1e3:.2f} MB/s ({t_enc:.1f} ms), "
          f"decode {mb / t_dec * 1e3:.2f} MB/s ({t_dec:.1f} ms), peak device "
          f"memory {peak} B, launches {launches}", flush=True)
    return launches, archive


def many(blocks: list, device) -> None:
    """Phase 5: device_encode_many / device_decode_many on several blocks,
    each after the port's device BWT.  device_encode_many takes the native
    lane table; on these blocks it puts a group over the 2^23 bytes both
    packages' kernel decode takes, so those payloads take the native codec
    and the decode leg gets each block's device-table payload instead (the
    fused route's, the one -m9 -e4 -G archives hold)."""
    import torch

    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import wide_kernels as WK

    us, resident = [], []
    for b in blocks:
        u, _, _ = bwt.bwt_encode_wideaux_device(
            torch.from_numpy(np.frombuffer(b, np.uint8).copy()).to(device),
            engine.wideaux_rate(len(b)))
        us.append(u.cpu().numpy().tobytes())
        resident.append(WK.device_encode_resident(u))
    k = len(us)
    WK.reset_launches()
    payloads, t_enc = timed(lambda: WK.device_encode_many(us, device))
    enc = dict(WK.LAUNCHES)
    WK.reset_launches()
    back, t_dec = timed(lambda: WK.device_decode_many(resident, device))
    dec = dict(WK.LAUNCHES)
    if enc["wide_model"] != k or enc["wide_rans"] != k \
            or dec["wide_decode"] != k:
        fail(f"many: not one launch of each v3 kernel a block: encode "
             f"{enc}, decode {dec}")
    for i, (u, p, b) in enumerate(zip(us, payloads, back)):
        if p is None or p != WK.device_encode(u, device):
            fail(f"many: payload {i} differs from device_encode's")
        if b != u:
            fail(f"many: block {i} was not restored")
    native = sum(WK._dec_parse(p) is None for p in payloads)
    mb = sum(map(len, us)) / 1e6
    print(f"phase 5 many: {k} blocks of {len(us[0])} bytes, sustained "
          f"encode {mb / t_enc * 1e3:.2f} MB/s ({t_enc:.1f} ms, "
          f"{sum(map(len, payloads))} bytes), decode "
          f"{mb / t_dec * 1e3:.2f} MB/s ({t_dec:.1f} ms, "
          f"{sum(map(len, resident))} bytes); {native} of {k} native-table "
          "payloads take the native codec (a group of 2^23 bytes or more)",
          flush=True)


def breakdown(data: bytes, features: int, archive: bytes, device) -> dict:
    """Wall milliseconds of each stage of the fused route on one block,
    each ending in a device synchronize (run after the main path, so
    warm; these launches are not the main path's).  The stages must
    compose the main path's archive and restore the input."""
    import torch

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import wide_kernels as WK

    ms = {}

    def stage(name, fn):
        out, ms[name] = timed(fn)
        return out

    lz = stage("lzp", lambda: engine.lzp_compress(
        np.frombuffer(data, np.uint8), C.DEFAULT_LZPHASHSIZE,
        C.DEFAULT_LZPMINLEN, features))
    lzp = lz is not None
    if not lzp:  # LZP does not pay: the block goes on unchanged
        lz = np.frombuffer(data, np.uint8).copy()
    r = engine.wideaux_rate(len(lz))
    lz_d = stage("h2d", lambda: torch.from_numpy(lz).to(device))
    U, primary, aux = stage("bwt", lambda: bwt.bwt_encode_wideaux_device(
        lz_d, r))
    prep = stage("schedule", lambda: WK.resident_prep(U))
    probs = stage("k1", lambda: WK.model_probs(prep[0], prep[2]))
    k2 = stage("k2", lambda: WK.rans_encode(prep[0], probs, prep[2]))
    payload = stage("assemble", lambda: WK._assemble_rans(
        len(lz), *k2, prep[1], prep[2]))
    del probs, k2, prep
    if compose(data, lzp, int(primary), aux.cpu().numpy(),
               payload) != archive:
        fail("the timed stages do not compose the main path's archive")
    parsed = stage("parse", lambda: WK._dec_parse(payload))
    args = stage("prep", lambda: WK._dec_args(parsed, device))
    U2 = stage("k3", lambda: WK.decode_lanes(*args))
    T = stage("unbwt", lambda: bwt.unbwt_wideaux(
        U2, int(primary), aux, r, len(lz)))
    T_h = stage("d2h", lambda: T.cpu().numpy())
    out = T_h
    if lzp:
        out = stage("unlzp", lambda: engine.lzp_decompress(
            T_h, C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN, features,
            capacity=len(data) + 4096))
    if out.tobytes() != data:
        fail("the stage-by-stage round trip did not restore the input")
    print("phase 3 stages (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ms.items()), flush=True)
    return ms


def check_stats(data: bytes, device) -> dict:
    """Phase 2 check of K6 and K7: each against its plain version on the
    4 MiB check block, an all-zero block of that size and a view of odd
    length at an odd offset, exactly (integer counts); the Adler-32 from
    K7's partials against the host's on each."""
    import torch

    from libbsc_tpu_torch.ops import stats_kernels as S
    from libbsc_tpu_torch.utils.adler32 import adler32

    block = torch.from_numpy(np.frombuffer(data[:PLAIN_BLOCK], np.uint8)
                             .copy()).to(device)
    cases = {"block": block,
             "zeros": torch.zeros(PLAIN_BLOCK, dtype=torch.uint8,
                                  device=device),
             "odd": block[3:3 + PLAIN_BLOCK - 3]}
    out = {}
    for name, kernel, plain in (
            ("byte_hist", S.byte_histogram, S.byte_histogram_plain),
            ("adler_partials", S._adler_partials, S._adler_partials_plain)):
        for case, x in cases.items():
            err = int((kernel(x).long() - plain(x).long()).abs().max())
            if err:
                fail(f"{name} differs from its plain version by {err} on "
                     f"the {case} block")
        out[name] = {"max_abs_err": 0}
        print(f"phase 2 check {name}: equal to plain on the 4 MiB block, "
              f"an all-zero 4 MiB block and {PLAIN_BLOCK - 3} bytes at "
              "offset 3", flush=True)
    for case, x in cases.items():
        if S.adler32_device(x) != adler32(x.cpu().numpy()):
            fail(f"adler32_device differs from the host on the {case} block")
    return out


def time_stats(data: bytes, device) -> list:
    """Phase 2 time of K6 and K7 on the 25 MiB block, beside their plain
    versions and K6's library call (torch.bincount).  The kernels' wrappers
    are timed in a CUDA graph (graph_ms: the device time of a wrapper's
    work, K6's 1 KiB zero fill included) and, for comparison, with CUDA
    events around back-to-back Python calls (cuda_ms: what a caller waits,
    dispatch included).  The plain versions and torch.bincount synchronise
    with the host inside a call (bincount reads the input's maximum), so
    they cannot be captured and are timed with events.  Each launch reads
    one of COLD_COPIES copies in turn, so its input is not in L2, as it
    would not be for a block that just arrived."""
    import torch

    from libbsc_tpu_torch.ops import stats_kernels as S

    n = len(data)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    copies = [x] + [x.clone() for _ in range(COLD_COPIES - 1)]

    def rotating(fn):
        turn = itertools.cycle(copies)
        return lambda: fn(next(turn))

    n_chunks = -(-n // S._ADLER_CHUNK)
    runs = {
        "byte_hist": (S.byte_histogram, S.byte_histogram_plain,
                      lambda t: torch.bincount(t, minlength=256),
                      n + 4 * 256, n),
        "adler_partials": (S._adler_partials, S._adler_partials_plain, None,
                           n + 8 * n_chunks, 2 * n),
    }
    rows = []
    for name, (kernel, plain, library, nbytes, ops) in runs.items():
        if not torch.equal(kernel(x).long(), plain(x).long()):
            fail(f"{name} differs from its plain version on the 25 MiB "
                 "block")
        ms = graph_ms(rotating(kernel), STATS_LAUNCHES)
        call_ms = cuda_ms(rotating(kernel), STATS_LAUNCHES)
        plain_ms = cuda_ms(rotating(plain), STATS_LAUNCHES)
        lib_ms = None if library is None else cuda_ms(rotating(library),
                                                      STATS_LAUNCHES)
        b, by = bound_ms(nbytes, ops)
        row = {"name": name, "route": "cuda",
               "source": f"libbsc_tpu_torch/csrc/{name}.cu",
               "replaces": REPLACES[name], "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms, "plain_at_bytes": n,
               "bound_ms": b, "bound_by": by, "library_ms": lib_ms}
        if name == "byte_hist":  # K6's other inputs, each against plain
            g = np.random.default_rng(0x4B36)
            others = {
                "zeros": lambda: torch.zeros_like(x),  # one bin a warp
                "random": lambda: torch.from_numpy(g.integers(
                    0, 256, n, np.uint8)).to(device),
                "offset3": lambda: x.clone()[3:],  # odd length at offset 3
            }
            for case, make in others.items():
                views = [make() for _ in range(COLD_COPIES)]
                if not torch.equal(kernel(views[0]), plain(views[0])):
                    fail(f"byte_hist differs from its plain version on the "
                         f"25 MiB {case} input")
                turn = itertools.cycle(views)
                row[f"{case}_ms"] = graph_ms(lambda: kernel(next(turn)),
                                             STATS_LAUNCHES)
                print(f"phase 2 time byte_hist on {case}: "
                      f"{row[f'{case}_ms']:.4f} ms (graph), "
                      f"{views[0].numel()} bytes", flush=True)
                del views, turn
        rows.append(row)
        lib = "" if lib_ms is None else f", torch.bincount {lib_ms:.4f} ms"
        print(f"phase 2 time {name}: {ms:.4f} ms in a graph, {call_ms:.4f}"
              f" ms a Python call (bound {b:.4f} ms by {by}), plain "
              f"{plain_ms:.4f} ms{lib}, {n} bytes", flush=True)
    return rows


def transform_step(blocks: list, features: int, device) -> dict:
    """Phase 6: the sharded transform step on a one-GPU mesh, both
    sorters, held against the native sorters; the ST leg's archive through
    api.decompress; K7 on the device-resident blocks.  Returns the launch
    counts of K6 and K7, set to 0 at the start of the phase."""
    import torch

    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.format.header import pack_block_header, pack_mode
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import stats_kernels as S
    from libbsc_tpu_torch.parallel import (make_mesh, make_transform_step,
                                           shard, unshard)
    from libbsc_tpu_torch.utils.adler32 import adler32

    host = [np.frombuffer(b, np.uint8) for b in blocks]
    mesh = make_mesh(1)
    grid = shard(torch.from_numpy(np.stack(host)), mesh)
    if grid[0][0].device != device:
        fail(f"make_mesh(1) is not on {device}")
    mb = sum(map(len, blocks)) / 1e6
    S.reset_launches()
    st_out = None
    for sorter in ("bwt", "st"):
        before = S.LAUNCHES["byte_hist"]
        (out, idx, hist), ms = timed(
            lambda: make_transform_step(mesh, sorter=sorter, k=5)(grid))
        if S.LAUNCHES["byte_hist"] - before != len(blocks):
            fail(f"step {sorter}: K6 launched "
                 f"{S.LAUNCHES['byte_hist'] - before} times for "
                 f"{len(blocks)} blocks")
        out, idx, hist = unshard(out), unshard(idx), unshard(hist)
        for b, ref in enumerate(host):
            ref = ref.copy()
            if sorter == "bwt":
                primary, ni, indexes = engine.bwt_encode(ref, features)
                _, _, aux = bwt.bwt_encode(grid[0][0][b])
                if not np.array_equal(aux.cpu().numpy(), indexes[:ni]):
                    fail(f"step bwt: block {b}'s aux differs from native")
            else:
                primary = engine.st_encode(ref, 5, features)
            if out[b].numpy().tobytes() != ref.tobytes() \
                    or int(idx[b]) != primary:
                fail(f"step {sorter}: block {b} differs from the native "
                     "sorter")
            if not torch.equal(hist[b].to(device).long(), torch.bincount(
                    grid[0][0][b], minlength=256)):
                fail(f"step {sorter}: block {b}'s histogram is wrong")
        if sorter == "st":
            st_out, st_idx = out.numpy(), idx
        print(f"phase 6 step {sorter}: {len(blocks)} blocks of "
              f"{len(blocks[0])} bytes, {ms:.1f} ms, {mb / ms * 1e3:.2f} "
              "MB/s, equal to the native sorter", flush=True)
    mode = pack_mode(C.BLOCKSORTER_ST5, C.CODER_QLFC_STATIC, 0, 0)
    P.init(features, device=device)
    for b, raw in enumerate(blocks):
        payload = engine.coder_compress(st_out[b].copy(),
                                        C.CODER_QLFC_STATIC, features)
        if payload is None:
            fail(f"step st: block {b} does not compress")
        payload = bytes(payload) + bytes([0])  # num_indexes = 0
        archive = pack_block_header(len(payload) + C.HEADER_SIZE, len(raw),
                                    mode, int(st_idx[b]), adler32(raw),
                                    adler32(payload)) + payload
        if P.decompress(archive) != raw:
            fail(f"step st: api.decompress did not restore block {b}")
    for b, raw in enumerate(blocks):
        if S.adler32_device(grid[0][0][b]) != adler32(raw):
            fail(f"adler32_device differs from the host on block {b}")
    launches = dict(S.LAUNCHES)
    if launches["adler_partials"] != len(blocks):
        fail(f"K7 did not launch once a block: {launches}")
    print(f"phase 6 archives: the ST outputs decode through api.decompress;"
          f" adler32_device equals the host; launches {launches}",
          flush=True)
    return launches


def st_device_path(data: bytes, features: int, device) -> None:
    """Phase 7: -m5 -G, the ST on the card; the archive must be the host
    ST's and must decode."""
    import torch

    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C

    kw = dict(lzp_hash_size=C.DEFAULT_LZPHASHSIZE,
              lzp_min_len=C.DEFAULT_LZPMINLEN,
              block_sorter=C.BLOCKSORTER_ST5, coder=C.CODER_QLFC_STATIC)
    P.init(features, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    archive, t_enc = timed(lambda: P.compress(data, **kw))
    peak = torch.cuda.max_memory_allocated()
    back, t_dec = timed(lambda: P.decompress(archive))
    P.init(features & ~C.FEATURE_CUDA, device=device)
    host, t_host = timed(lambda: P.compress(data, **kw))
    if peak == 0:
        fail("-m5 -G: the ST did not run on the card")
    if archive != host:
        fail("-m5 -G: the archive differs from the host-ST archive")
    if back != data:
        fail("-m5 -G: api.decompress did not restore the block")
    mb = len(data) / 1e6
    print(f"phase 7 -m5 -G: {len(data)} -> {len(archive)} bytes, equal to "
          f"the host-ST archive; encode {mb / t_enc * 1e3:.2f} MB/s "
          f"({t_enc:.1f} ms; host ST {mb / t_host * 1e3:.2f} MB/s), decode "
          f"{mb / t_dec * 1e3:.2f} MB/s ({t_dec:.1f} ms), peak device "
          f"memory {peak} B", flush=True)
    st_breakdown(data, kw, archive, features, device)


def st_breakdown(data: bytes, kw: dict, archive: bytes, features: int,
                 device) -> None:
    """Wall milliseconds of each stage of phase 7's encode and decode,
    each ending in a device synchronize; the stages must compose the
    archive's payload and restore the block."""
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine

    ms = {}

    def stage(name, fn):
        out, ms[name] = timed(fn)
        return out

    hs, ml = kw["lzp_hash_size"], kw["lzp_min_len"]
    lz = stage("lzp", lambda: engine.lzp_compress(
        np.frombuffer(data, np.uint8), hs, ml, features))
    lzp = lz is not None
    if not lzp:  # LZP does not pay: the block goes on unchanged
        lz = np.frombuffer(data, np.uint8).copy()
    dev_lz, host_lz = lz.copy(), lz.copy()
    index = stage("st_device", lambda: engine.st_encode(
        dev_lz, 5, features, device))
    stage("st_host", lambda: engine.st_encode(host_lz, 5, features))
    payload = stage("qlfc", lambda: engine.coder_compress(
        dev_lz, C.CODER_QLFC_STATIC, features))
    if payload is None or bytes(payload) + b"\0" != \
            archive[C.HEADER_SIZE:] or not np.array_equal(dev_lz, host_lz):
        fail("-m5 -G: the timed stages do not compose the archive")
    out = stage("unqlfc", lambda: engine.coder_decompress(
        payload, C.CODER_QLFC_STATIC, features, capacity=len(data) + 4096))
    stage("unst", lambda: engine.st_decode(out, 5, index, features))
    if lzp:
        out = stage("unlzp", lambda: engine.lzp_decompress(
            out, hs, ml, features, capacity=len(data) + 4096))
    if out.tobytes() != data:
        fail("-m5 -G: the timed stages did not restore the block")
    print("phase 7 stages (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ms.items()), flush=True)


def _entries(path: str) -> dict:
    """Container entries of an archive: offset -> (record size, contexts,
    block).  The -G farm writes blocks as they finish."""
    from libbsc_tpu_torch import cli

    with open(path, "rb") as f:
        raw = f.read()
    off, out = 8, {}
    while off < len(raw):
        boff, rs, ctx = struct.unpack_from(cli.BLOCK_HEADER_FMT, raw, off)
        off += cli.BLOCK_HEADER_SIZE
        (csz,) = struct.unpack_from("<i", raw, off)
        out[boff] = (rs, ctx, raw[off:off + csz])
        off += csz
    return out


def cli_path(data: bytes, features: int, device, repo: str) -> dict:
    """Phase 8: the CLI on the card.  Returns the launches of K1-K3 in the
    -m9 -e4 -G encode and decode."""
    import tempfile

    import torch

    from libbsc_tpu_torch import cli, engine
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.ops import wide_kernels as WK

    card = smi()
    mb = len(data) / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        inp, arch, back = (os.path.join(tmp, n) for n in ("in", "a", "r"))
        with open(inp, "wb") as f:
            f.write(data)

        def args(*switches):
            return cli.parse_args(["cli", "e", inp, arch, *switches])

        def restored() -> bool:
            with open(back, "rb") as f:
                return f.read() == data

        # (a) -m9 -e4 -G, with the farm and with -t
        WK.reset_launches()
        _, t_enc = timed(lambda: cli.compress_file(inp, arch, args("-m9e4G"),
                                                   quiet=True))
        enc = dict(WK.LAUNCHES)
        WK.reset_launches()
        _, t_dec = timed(lambda: cli.decompress_file(
            arch, back, args("-m9e4G"), quiet=True))
        dec = dict(WK.LAUNCHES)
        if not (enc["wide_model"] and enc["wide_rans"]):
            fail(f"cli -m9 -e4 -G: K1 and K2 did not launch: {enc}")
        if not dec["wide_decode"]:
            fail(f"cli d -G: K3 did not launch: {dec}")
        if not restored():
            fail("cli d -G did not restore the file")
        farm = _entries(arch)
        os.remove(back)
        _, t_host = timed(lambda: cli.decompress_file(arch, back, args(),
                                                      quiet=True))
        if not restored():
            fail("cli d without -G did not restore the -m9 -e4 -G file")
        _, t_serial = timed(lambda: cli.compress_file(
            inp, arch, args("-m9e4Gt"), quiet=True))
        serial = _entries(arch)
        os.remove(back)
        _, t_serial_dec = timed(lambda: cli.decompress_file(
            arch, back, args("-m9e4Gt"), quiet=True))
        if not restored():
            fail("cli d -G -t did not restore the file")
        same = sum(farm[k] == serial.get(k) for k in farm)
        print(f"phase 8 cli -m9 -e4 -G: {len(data)} bytes in {len(farm)} "
              f"blocks -> {sum(len(v[2]) for v in farm.values())} bytes; "
              f"encode {mb / t_enc * 1e3:.2f} MB/s with the farm "
              f"({t_enc:.1f} ms; {same} of {len(farm)} entries equal to -t's "
              f"device-route entries), {mb / t_serial * 1e3:.2f} MB/s with "
              f"-t ({t_serial:.1f} ms); decode -G {mb / t_dec * 1e3:.2f} "
              f"MB/s ({t_dec:.1f} ms), with -t "
              f"{mb / t_serial_dec * 1e3:.2f} MB/s ({t_serial_dec:.1f} ms), "
              f"without -G {mb / t_host * 1e3:.2f} "
              f"MB/s ({t_host:.1f} ms); launches encode {enc}, decode {dec};"
              f" {card}", flush=True)

        # (b) the -G default config against the host
        _, t_host_enc = timed(lambda: cli.compress_file(inp, arch, args(),
                                                        quiet=True))
        host = _entries(arch)
        before = engine.DEVICE_ROUTES["bwt_encode"]
        _, t_dev_enc = timed(lambda: cli.compress_file(inp, arch, args("-G"),
                                                       quiet=True))
        sorted_on_card = engine.DEVICE_ROUTES["bwt_encode"] - before
        if os.environ.get("TBSC_BWT_DEVICE") is not None:
            fail("cli -G did not restore TBSC_BWT_DEVICE")
        if _entries(arch) != host:
            fail("cli -G: the default config's entries differ from the "
                 "host archive's")
        if sorted_on_card < 1:
            fail(f"cli -G: the device BWT ran {sorted_on_card} times for "
                 f"{len(host)} blocks")
        os.remove(back)
        _, t_def_dec = timed(lambda: cli.decompress_file(
            arch, back, args("-G"), quiet=True))
        if not restored():
            fail("cli -G did not restore the default-config file")
        lz = engine.lzp_compress(np.frombuffer(data[:BLOCK], np.uint8),
                                 C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                                 features)
        lz = np.frombuffer(data[:BLOCK], np.uint8) if lz is None else lz
        os.environ["TBSC_BWT_DEVICE"] = "1"
        before = engine.DEVICE_ROUTES["bwt_encode"]
        try:
            dev_bwt, t_dev_bwt = timed(lambda: engine.bwt_encode(
                lz.copy(), features, device))
        finally:
            del os.environ["TBSC_BWT_DEVICE"]
        if engine.DEVICE_ROUTES["bwt_encode"] != before + 1:
            fail("the 25 MiB block did not take the device BWT route")
        host_bwt, t_host_bwt = timed(lambda: engine.bwt_encode(
            lz.copy(), features))
        if dev_bwt[:2] != host_bwt[:2] or not np.array_equal(
                dev_bwt[2][:dev_bwt[1]], host_bwt[2][:host_bwt[1]]):
            fail("the device BWT stage differs from the host's")
        print(f"phase 8 cli -G default config: entries equal to the host "
              f"archive's; the device BWT sorted {sorted_on_card} of "
              f"{len(host)} blocks; encode {mb / t_dev_enc * 1e3:.2f} MB/s "
              f"with -G ({t_dev_enc:.1f} ms), {mb / t_host_enc * 1e3:.2f} "
              f"MB/s without ({t_host_enc:.1f} ms); decode -G "
              f"{mb / t_def_dec * 1e3:.2f} MB/s; bwt stage on a "
              f"{len(lz)}-byte block: device {t_dev_bwt:.1f} ms, host "
              f"{t_host_bwt:.1f} ms; {card}", flush=True)

        # (c) the entry point itself, one process each way
        env = dict(os.environ, PYTHONPATH=repo)
        for cmd in (["e", inp, arch, "-m9", "-e4", "-G"],
                    ["d", arch, back, "-G"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "libbsc_tpu_torch.cli", *cmd],
                cwd=repo, env=env, capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                fail(f"python3 -m libbsc_tpu_torch.cli {' '.join(cmd[:1])} "
                     f"exited {proc.returncode}:\n{proc.stderr[-2000:]}")
            print(f"phase 8 subprocess {cmd[0]} -m9 -e4 -G: exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s: "
                  f"{proc.stdout.strip().splitlines()[-1].strip()}",
                  flush=True)
        if not restored():
            fail("the cli subprocesses did not restore the file")
    return {name: {"encode": enc[name], "decode": dec[name]}
            for name in V3}


def sharded_st(blocks: list, features: int, device) -> None:
    """Phase 9 (a): the sample-sort ST step on meshes that list cuda:0
    several times: the first block on (1, 4) with k = 8 and k = 5, both
    blocks on (2, 2) with k = 8.  Each output and index must equal
    ops/st.st_encode on the card and the native host ST, and ok must be
    all True.  Each step and st_encode are timed warm (the second call)."""
    import torch

    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import st as opsst
    from libbsc_tpu_torch.parallel import (make_mesh, make_sharded_st_step,
                                           shard, unshard)

    host = np.stack([np.frombuffer(b, np.uint8) for b in blocks])
    card = smi()
    for (dp, sp), k in (((1, 4), 8), ((1, 4), 5), ((2, 2), 8)):
        mesh = make_mesh(dp * sp, dp=dp, sp=sp, devices=[device] * (dp * sp))
        batch = torch.from_numpy(host[:dp])
        grid = shard(batch, mesh)
        step = make_sharded_st_step(mesh, k=k)
        step(grid)
        (out, idx, ok), ms = timed(lambda: step(grid))
        out, idx, ok = unshard(out), unshard(idx), unshard(ok)
        if not bool(ok.all()):
            fail(f"sharded st ({dp}, {sp}) k={k}: ok is {ok.tolist()}")
        dev_block = batch[0].to(device)
        opsst.st_encode(dev_block, k)
        _, st_ms = timed(lambda: opsst.st_encode(dev_block, k))
        for b in range(dp):
            ref_out, ref_idx = opsst.st_encode(batch[b].to(device), k)
            if not torch.equal(out[b], ref_out.cpu()) \
                    or int(idx[b]) != int(ref_idx):
                fail(f"sharded st ({dp}, {sp}) k={k}: block {b} differs "
                     "from ops/st.st_encode")
            ref = host[b].copy()
            index = engine.st_encode(ref, k, features)
            if out[b].numpy().tobytes() != ref.tobytes() \
                    or int(idx[b]) != index:
                fail(f"sharded st ({dp}, {sp}) k={k}: block {b} differs "
                     "from the native ST")
        print(f"phase 9 sharded st ({dp}, {sp}) of {device} k={k}: {dp} "
              f"block(s) of {host.shape[1]} bytes equal to st_encode and "
              f"the native ST, ok all True; step {ms:.1f} ms, st_encode "
              f"{st_ms:.1f} ms a block; {card}", flush=True)


# One rank of phase 9's two-process farm, run as `python3 -c FARM_RANK
# in out port block pid features`; it prints one RANK line.
FARM_RANK = """
import json, os, sys, time
import torch
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.ops import wide_kernels as WK
from libbsc_tpu_torch.parallel import distributed as dist
inp, arch, port, block, pid, features = sys.argv[1:7]
block, pid = int(block), int(pid)
dist.init(coordinator=f"localhost:{port}", num_processes=2, process_id=pid)
t0 = time.perf_counter()
dist.compress_file(inp, arch, block_size=block,
                   block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                   coder=C.CODER_QLFC_WIDE, features=int(features))
ms = (time.perf_counter() - t0) * 1e3
n_blocks = -(-os.path.getsize(inp) // block)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "libbsc_tpu" or m.startswith("libbsc_tpu.")]
print("RANK " + json.dumps({
    "rank": pid, "device": str(dist._device),
    "offsets": [i * block for i in range(n_blocks) if i % 2 == pid],
    "launches": dict(WK.LAUNCHES), "ms": ms, "jax_modules": bad}))
torch.distributed.destroy_process_group()
"""


def farm(data: bytes, features: int, device, repo: str) -> dict:
    """Phase 9 (b): the multi-process farm on phase 8's file with -m9 -e4:
    one process here, then two `python3 -c` ranks on one gloo group, both
    on cuda:0 (distributed.init's default device on one card).  Each rank
    must launch K1 and K2; the two-process archive
    must decode through the CLI with -G (K3 launched) to the file, and its
    entries must equal the one-process archive's.  Returns K1-K3's
    launches."""
    import socket
    import tempfile

    import torch

    from libbsc_tpu_torch import cli
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.ops import wide_kernels as WK
    from libbsc_tpu_torch.parallel import distributed as dist

    card = smi()
    mb = len(data) / 1e6
    kw = dict(block_size=BLOCK, block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
              coder=C.CODER_QLFC_WIDE, features=features)
    with tempfile.TemporaryDirectory() as tmp:
        inp, one, two, back = (os.path.join(tmp, n)
                               for n in ("in", "one", "two", "r"))
        with open(inp, "wb") as f:
            f.write(data)
        dist.init(num_processes=1, process_id=0)
        if dist._device != device:
            fail(f"distributed.init chose {dist._device}, not {device}")
        WK.reset_launches()
        _, t_one = timed(lambda: dist.compress_file(inp, one, **kw))
        one_launches = dict(WK.LAUNCHES)
        if not (one_launches["wide_model"] and one_launches["wide_rans"]):
            fail(f"farm, one process: K1 and K2 did not launch: "
                 f"{one_launches}")
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=repo)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", FARM_RANK, inp, two, str(port),
             str(BLOCK), str(pid), str(features)], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_two = (time.perf_counter() - t0) * 1e3
        ranks = []
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                fail(f"farm rank exited {p.returncode}:\n{err[-2000:]}")
            line = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
            if not line:
                fail(f"farm rank printed no RANK line:\n{out[-2000:]}")
            ranks.append(json.loads(line[-1][5:]))
        for r in ranks:
            print(f"phase 9 farm rank {r['rank']}: device {r['device']}, "
                  f"block offsets {r['offsets']}, K1 "
                  f"{r['launches']['wide_model']} K2 "
                  f"{r['launches']['wide_rans']} launches, compress_file "
                  f"{r['ms']:.1f} ms", flush=True)
            if r["device"] != str(device):
                fail(f"farm rank {r['rank']} ran on {r['device']}")
            if not (r["launches"]["wide_model"]
                    and r["launches"]["wide_rans"]):
                fail(f"farm rank {r['rank']}: K1 and K2 did not launch")
            if r["jax_modules"]:
                fail(f"farm rank {r['rank']} imported {r['jax_modules']}")
        want = _entries(one)
        got = _entries(two)
        if got != want:
            fail("farm: the two-process archive's entries differ from the "
                 "one-process archive's")
        if sorted(sum((r["offsets"] for r in ranks), [])) != sorted(got):
            fail("farm: the ranks' stripes do not cover the archive")
        WK.reset_launches()
        args = cli.parse_args(["cli", "d", two, back, "-G"])
        _, t_dec = timed(lambda: cli.decompress_file(
            two, back, args, quiet=True, device=device))
        dec = WK.LAUNCHES["wide_decode"]
        if not dec:
            fail("farm: cli d -G did not launch K3")
        with open(back, "rb") as f:
            if f.read() != data:
                fail("farm: cli d -G did not restore the file")
    print(f"phase 9 farm -m9 -e4: {len(data)} bytes in {len(want)} blocks,"
          f" the two-process archive's entries equal the one-process "
          f"archive's and decode with -G (K3 {dec} launches); one process "
          f"{t_one:.1f} ms ({mb / t_one * 1e3:.2f} MB/s), two processes "
          f"{t_two:.1f} ms from their start ({mb / t_two * 1e3:.2f} MB/s); "
          f"decode -G {t_dec:.1f} ms; {card}", flush=True)
    return {name: {"farm_one_process": one_launches.get(name, 0),
                   "farm_two_processes": sum(r["launches"].get(name, 0)
                                             for r in ranks),
                   "farm_decode": dec if name == "wide_decode" else 0}
            for name in V3}


def dc3(data: bytes, features: int, device) -> None:
    """Phase 9 (c): the LZP'd 25 MiB block through engine.bwt_encode with
    TBSC_BWT_DEVICE=1, by prefix quadrupling (TBSC_BWT unset) and by DC3
    (TBSC_BWT=dc3), in the turns prefix, dc3, dc3, prefix; U, primary and
    aux must equal the native BWT's, and DEVICE_ROUTES must count both
    routes.  Both variables are restored."""
    import torch

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine

    lz = engine.lzp_compress(np.frombuffer(data, np.uint8),
                             C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                             features)
    lz = np.frombuffer(data, np.uint8) if lz is None else lz
    ref = lz.copy()
    primary, ni, aux = engine.bwt_encode(ref, features)
    saved = {v: os.environ.get(v) for v in ("TBSC_BWT_DEVICE", "TBSC_BWT")}
    ms = {"bwt_encode": [], "bwt_encode_dc3": []}
    peak = {}
    before = dict(engine.DEVICE_ROUTES)
    try:
        os.environ["TBSC_BWT_DEVICE"] = "1"
        for route in ("bwt_encode", "bwt_encode_dc3", "bwt_encode_dc3",
                      "bwt_encode"):
            if route == "bwt_encode_dc3":
                os.environ["TBSC_BWT"] = "dc3"
            else:
                os.environ.pop("TBSC_BWT", None)
            buf = lz.copy()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            got, t = timed(lambda: engine.bwt_encode(buf, features, device))
            peak[route] = torch.cuda.max_memory_allocated()
            ms[route].append(t)
            if got[:2] != (primary, ni) or not np.array_equal(
                    got[2][:ni], aux[:ni]) or not np.array_equal(buf, ref):
                fail(f"{route}: the device BWT differs from the native BWT")
    finally:
        for v, prior in saved.items():
            if prior is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = prior
    counted = {r: engine.DEVICE_ROUTES[r] - before[r] for r in ms}
    if counted != {"bwt_encode": 2, "bwt_encode_dc3": 2}:
        fail(f"DEVICE_ROUTES counted {counted}, not two calls of each")
    print(f"phase 9 dc3: a {len(lz)}-byte block, both routes equal to the "
          f"native BWT; prefix quadrupling "
          f"{', '.join(f'{t:.1f}' for t in ms['bwt_encode'])} ms, peak "
          f"{peak['bwt_encode']} B; dc3 "
          f"{', '.join(f'{t:.1f}' for t in ms['bwt_encode_dc3'])} ms, peak "
          f"{peak['bwt_encode_dc3']} B; routes counted {counted}; {smi()}",
          flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.exists(os.path.join(repo, "libbsc_tpu_torch",
                                       "__init__.py")):
        print("FAIL: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    device = torch.device("cuda", 0)

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import native
    from libbsc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    cuda_s = _cuda.build_all()
    native.load()
    card = smi()
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"phase 1 build: kernels {cuda_s:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s; {card}, max SM clock "
          f"{clock_mhz:.0f} MHz; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    for src in _cuda.sources():
        for line in _cuda.build_log(src.stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src.stem}: {line.strip()}")

    features = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING | C.FEATURE_CUDA
    data = make_corpus(BLOCK)
    checked = check_kernels(stages(data[:PLAIN_BLOCK], features, device),
                            device)
    check_hard_decode(data, device)
    check_hard_encode(data, device)
    checked.update(check_stats(data, device))
    st = stages(data, features, device)
    rows = time_kernels(st, device, clock_mhz)
    stats_rows = time_stats(data, device)
    composed = st["archive"]
    del st
    torch.cuda.empty_cache()
    launches, archive = main_path(data, features, composed[True], device,
                                  rans=True)
    breakdown(data, features, archive, device)
    launches.update({k: v for k, v in main_path(
        data, features, composed[False], device, rans=False)[0].items()
        if k in V2})
    corpus = make_corpus(MANY_BLOCKS * BLOCK)
    many([corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(MANY_BLOCKS)],
         device)
    launches.update(transform_step(
        [corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(STEP_BLOCKS)],
        features, device))
    st_device_path(data, features, device)
    cli_launches = cli_path(corpus[:2 * BLOCK + CLI_TAIL], features, device,
                            repo)
    t9 = time.perf_counter()
    sharded_st([corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(2)],
               features, device)
    farm_launches = farm(corpus[:2 * BLOCK + CLI_TAIL], features, device,
                         repo)
    dc3(corpus[:BLOCK], features, device)
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)
    for r in rows:
        r.update(checked[r["name"]], launches=launches[r["name"]],
                 plain_at_bytes=PLAIN_BLOCK)
        if r["name"] in cli_launches:
            r["cli_launches"] = cli_launches[r["name"]]
            r["farm_launches"] = farm_launches[r["name"]]
    for r in stats_rows:
        r.update(checked[r["name"]], launches=launches[r["name"]])
    print(json.dumps({"kernels": rows + stats_rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
