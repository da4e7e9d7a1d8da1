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
     iterations); K8 (the wide-aux inverse BWT: its table kernel and its
     chase), K9 and K10 (the bit schedule's events and planes) against
     their plain versions on the 4 MiB block
     (its device lane table), on edge_block (an empty lane, a one-run
     lane, all 256 byte values, runs across lane starts, dead lanes) and
     on the hard blocks (each with its own lane table), exactly, K10's
     planes also against the native walker's and K8's chase of each
     block's own wide-aux BWT against the block; K9 and K10 also on their
     batch and tile edges (batch_edges); then each timed with CUDA events
     on the 25 MiB block's own inputs, beside its plain version (once);
     K8 also one chain alone (its latency floor), the stable sort of the
     block's bytes and its whole table build; K8's step 0 (the torch ops
     of the int64 table up to f242faf, each alone, and the two ways to the
     bucket ends) and its other designs, each table and chase timed and
     each chase's latency floor (tools/chase_variants.py); K9's clock64()
     split and its longest lane alone (tools/schedule_step_split.py);
     K11-K14 (the forward BWT's sort: bootstrap keys, round keys, group
     heads and ranks in a pre-pass and a main pass, the extraction in two
     passes) held to their plain versions call by call (held_to_plain)
     through the wide-aux BWT and DC3 of the 4 MiB block, all-zero and
     periodic 4 MiB blocks, the high-entropy hard block and the text at
     SORT_SIZES (2, 3, 17, 255, 4,096, K13's and K11's tiles +- 1, K14's
     8,192-row blocks + 1, one and three 64 KiB buckets + a part),
     exactly, each BWT also against the native one; then each timed with
     CUDA events on the 25 MiB block's own inputs beside its plain
     version, K13's main pass also beside torch.cummax of its rows
     (library_ms), its pre-pass beside the gather it took over, K13 and
     K14 whole beside the bound of their function, and K12 and K13 in the
     compact round's form;
  3. the v3 main path: the 25 MiB block through api.compress and
     api.decompress with -m9 -e4 -G, launch counters set to 0 just before
     and read just after (K8-K10's also between the two).  K1, K2 and K3
     must have launched and K4 and K5 not, K9 and K10 once in the encode
     and K8 once in the decode, K11-K14 in the encode (SORT_ENCODE at
     least) and not in the decode; the archive must equal the one composed
     from the stages and the native wide encode; both the device decode
     and the native host decode must restore the input.  Then each stage
     of the fused route is timed once, stage by stage, for the breakdown
     (the BWT split into boot, rounds, with each round's unresolved
     count, and extract; the schedule split into lanes, stats, events (K9), planes (K10) and
     transpose; the inverse BWT into psi, K8's table: the sort, the
     bucket ends and the table kernel, and chase, K8's chase); the archive those stages compose must equal the main path's, so
     the breakdown cannot drift from the code it times.  After the first
     (counted) calls, three warm calls each way, timed (the warm MB/s
     beside the first call's): each archive must equal the composed one,
     each decode restore the block, the host buffer pool's slots
     (utils/bufpool) keep their addresses, and the fused route's two copy
     slots ("compress_lz", "decompress_lz") be page-locked;
     (b) the split of the time outside the stages, tools/host_split.py on
     this checkout in a fresh process: compress and decompress walls, the
     process's first call and three warm ones, beside the sums of their
     TBSC_TRACE stages, and each host step outside the stages alone, cold
     and warm (the Adler-32s, allocations and copies, tobytes, the LZP
     attempt's output, H2D and D2H pageable and page-locked, a pinned
     slot's allocation in this thread and in new ones), and the CLI on
     phase 8's file, -m9 -e4 -G with the farm and -t, three times;
  4. the v2 main path: the same with wide_kernels.RANS = False.  K5 and K4
     must have launched and K1, K2 and K3 not (K8-K10 as in phase 3); its
     warm calls and pool checks as phase 3's;
  5. many blocks: three other 25 MiB blocks of the corpus, each after the
     port's device BWT, through device_encode_many (each payload must
     equal device_encode of its block) and device_decode_many (each block
     must come back); prints the sustained MB/s;
  6. the sharded transform step on a one-GPU mesh (make_mesh(1) on
     cuda:0) over a local batch of two 25 MiB blocks of that corpus, with
     sorter="bwt" and with sorter="st", k=5: U and the primary must equal
     the native tbsc_bwt_encode, ops/bwt.bwt_encode's aux the native aux
     indexes, the ST output and index the native tbsc_st_encode, the
     histograms torch.bincount; K6 must launch once a block in each step,
     K11, K13 and K14 at least once a block in the bwt step.
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
     count is printed; K11, K13 and K14 at least once a block sorted on
     the card), and the farm must leave os.environ as it was; its decode
     with -G must restore the file, each block of 1 MiB or more inverted
     by K16 (DEVICE_ROUTES["bwt_decode"] and K16's launch counters, set to
     0 just before, must count one table, gaps and write launch a block
     and its ranking's rounds: k16_launches);
     then the device BWT route (counted, through K11-K14) and the host
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
     archive's; (c) the LZP'd 25 MiB block through engine.bwt_encode on
     the card (a CUDA device takes the route by itself), by prefix
     quadrupling and with TBSC_BWT=dc3 by DC3, in turns (prefix, dc3,
     dc3, prefix), each equal to the native BWT, timed, with its peak
     device memory; DEVICE_ROUTES must count both, and each call must
     launch K11-K14; TBSC_BWT is restored.
 10. the last modules (each variable and engine._force it sets is
     restored): (a) TBSC_ENGINE=ops (engine._force) on the 25 MiB block,
     default config, no FEATURE_CUDA: DEVICE_ROUTES must count one
     bwt_encode and one bwt_decode (K16 launched once), the archive must
     equal the native engine's and come back; -m9 -e4 under ops: K1-K3
     launched, phase 3's archive; (b) TBSC_ENGINE=numpy
     through `python3 -m libbsc_tpu_torch.cli` (under runpy, so each
     process prints whether it loaded the native runtime: it must not)
     on a 128 KiB file with -e0, -e1, -e2, -m5 and -e4, e then d: exit
     0, the file back, every container entry equal to the native
     engine's (-e4, the wide coder's reference with equal lanes: decoded
     by the native engine instead); (c) ops/bwt.bwt_encode_fast on the
     LZP'd block, equal to the native BWT, timed beside bwt_encode, and
     TBSC_WIDE_DEV_SCHED's device_schedule on its BWT: planes and payload
     equal to the native walker's, K9 and K10 launched once a schedule;
     (d) ops/wide_rc, 256 lanes x 1,000 bits on the card: each stream
     equal to the serial RcEncoder's, the bits decoded back; (e)
     TBSC_TRACE over one -m9 -e4 -G compress and decompress: stage lines
     printed, summing to at most each call's wall time; then untraced
     under TBSC_PROFILE: the torch.profiler trace must hold K1-K3's CUDA
     kernels, and the device's busy share over that window is printed.

Phase 2 also holds K6 (byte histogram) and K7 (Adler-32 partials) against
their plain versions on the 4 MiB check block, an all-zero 4 MiB block and
an odd-length view at an odd offset, exactly, and times them (in a CUDA
graph, so that a call of microseconds is not timed by its dispatch), their
plain versions and K6's library call (torch.bincount) on the 25 MiB block,
each launch on one of four copies in turn so that its input is not in the
50 MB L2 cache; K6 also on an all-zero block, uniform random bytes and the
text at offset 3, each of 25 MiB and held against its plain version.  And
K15, the LZP screen (time_lzp_screen), on the 25 MiB text block and a 25
MiB block of log lines where LZP pays: its flags against its plain
version's, the kernel (CUDA events, cold copies), the API's copy, screen
and read back, the host LZP attempt it spares or precedes, and the plain
version on the CPU; where it rules LZP out, the native LZP must reject
the block.  Phase 3's encode must launch K15 once.  And K16, the default
format's inverse BWT (time_rulers): its four kernels on a 25 MiB block of
each kind (the text, all zeros, a 1,000-byte period, random bytes), each
held exactly against its plain version on the same inputs, timed with CUDA
events, with the longest gap, K16 whole, the list ranking and the native
inverse beside them.

The script prints each phase's wall seconds (the run-time line), a JSON
line of per-kernel numbers (launches from the main path that runs the
kernel: K1-K3 and K8-K15 phase 3, K4 and K5 phase 4, K6 and K7 phase 6,
K16 phase 8's -G default-config decode; cli_launches of K1-K3 from phase 8's -m9 -e4 -G encode and decode,
counted from several threads, so read as launched or not; farm_launches
of K1-K3 from phase 9's farm: the one-process encode, the two ranks'
encodes summed from their lines, and the -G decode), the nvidia-smi
line, and, last, {"ok": true, "device": ...} only when every phase
passed.  It exits non-zero without CUDA or outside
a checkout of the repository.

Each kernel's bound_ms is the larger of its bytes (each input read once,
each output written once; for the encode kernels the max_bits rows of
planes and probabilities they touch) over 3.35 TB/s and its operations
(one per coded bit, a floor) over 67 TFLOP/s, the H100 SXM's device-memory
rate and peak outside the tensor cores.  K3/K4's record buffer is scratch
between their two kernels, not an input or output of the function.  K9
writes 16 bytes a run (rank, length, bit count and first bit S); K10
reads 12 (rank, length and S) and writes the planes.  K8's table kernel
reads the sort's indices (8 bytes a row) and the bucket ends and writes
the two-step table (8 bytes a row); its chase reads the rows its chains
load (8 bytes each, one for two steps), the ends and the start rows once
and writes the block (operations: 8 search steps a row searched); what
bounds the chase is the latency of its r / 2 dependent loads a chain,
which no bytes count shows: latency_floor_ms is one chain launched alone.
K11 reads the block and writes two int64 keys a row (17 bytes a row),
K12 reads the ranks and writes the keys (24).  K13's pre-pass reads the
first sort's values and indices and the high keys and writes the second
sort's input and the packed words (40); its main pass reads the sorted
high keys, the second sort's indices and the packed words and writes the
ranks and the unresolved list (32, and 8 an unresolved row); the
function K13 computes reads the sorted keys and the permutation and
writes the ranks and a mask (41, k13_bound_ms).  K14's pass 1 reads the
ranks and the block and writes the stage (13, and the aux indexes), its
pass 2 reads the stage and writes U (5); the function reads the block and
the ranks and writes U (10, k14_bound_ms).  K16's table kernel reads the
sort's indices and writes its table (8 bytes a row each; 8 search steps
a row); its first chase loads 8 bytes a row for two (g // 2 + 1 loads a
gap of g) and writes a successor and a gap a node (12), its ranking reads
and gathers 24 bytes a node and writes 12 in each round, its second chase
loads ceil(g / 2) rows a gap, reads 20 bytes a node and writes the block;
k16_bound_ms is the four summed.  Like K8's, its chases are bound by the
latency of the longest gap's dependent loads, which no bytes count shows.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

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
WARM_CALLS = 3               # phase 3's warm calls after the first
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
    # K8-K10 replace XLA programs of the JAX package, not Pallas kernels
    "unbwt_table": "libbsc_tpu/ops/bwt.py:870",
    "unbwt_chase": "libbsc_tpu/ops/bwt.py:870",
    "sched_events": "libbsc_tpu/ops/wide_schedule.py:262",
    "sched_planes": "libbsc_tpu/ops/wide_schedule.py:371",
    # K11-K14 replace the XLA suffix sort and extraction of the forward BWT
    "bwt_boot_keys": "libbsc_tpu/ops/bwt.py:74",
    "bwt_round_keys": "libbsc_tpu/ops/bwt.py:153",
    "bwt_heads_pay": "libbsc_tpu/ops/bwt.py:120",
    "bwt_heads": "libbsc_tpu/ops/bwt.py:120",
    "bwt_extract_bins": "libbsc_tpu/ops/bwt.py:754",
    "bwt_extract": "libbsc_tpu/ops/bwt.py:754",
    # K15 replaces nothing: it spares the host its LZP attempt
    "lzp_screen": "none",
}
V3 = ("wide_model", "wide_rans", "wide_decode")
V2 = ("wide_rc_encode", "wide_decode_v2")
# K8 (its table and its chase), K9, K10
SCAN = ("unbwt_table", "unbwt_chase", "sched_events", "sched_planes")
# the launches of K8-K10 in a -m9 -e4 -G encode and decode
SCAN_ENCODE = {"unbwt_table": 0, "unbwt_chase": 0, "sched_events": 1,
               "sched_planes": 1}
SCAN_DECODE = {"unbwt_table": 1, "unbwt_chase": 1, "sched_events": 0,
               "sched_planes": 0}
SOURCE = {"wide_decode_v2": "wide_decode",  # K4 is K3's template twin
          "unbwt_table": "unbwt_chase",
          "sched_events": "wide_schedule", "sched_planes": "wide_schedule",
          "bwt_boot_keys": "bwt_sort", "bwt_round_keys": "bwt_sort",
          "bwt_heads_pay": "bwt_sort", "bwt_heads": "bwt_sort",
          "bwt_extract_bins": "bwt_sort", "bwt_extract": "bwt_sort"}
# K11-K14, the forward BWT's sort (K13 its pre-pass and main pass, K14 its
# two passes), and their fewest launches in a -m9 -e4 -G encode (the
# bootstrap, a round at least, and the extraction)
SORT = ("bwt_boot_keys", "bwt_round_keys", "bwt_heads_pay", "bwt_heads",
        "bwt_extract_bins", "bwt_extract")
SORT_ENCODE = {"bwt_boot_keys": 1, "bwt_round_keys": 1, "bwt_heads_pay": 2,
               "bwt_heads": 2, "bwt_extract_bins": 1, "bwt_extract": 1}
K14_BUCKET = 1 << 16         # K14's slots of U a bucket
# phase 2's block sizes for K11-K14: K13's tile is 1,024 rows, K11's block
# 2,048, K14's pass-1 block 8,192 and its bucket 65,536 slots
SORT_SIZES = (2, 3, 17, 255, 4096, 1023, 1025, 2047, 2049, 8193, 65537,
              3 * 65536 + 12345)


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
            "archive": archive, "lz": lz, "primary": int(primary),
            "aux": aux, "r": r}


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


def edge_block(lanes: int = 1024, lane_bytes: int = 300,
               seed: int = 0xED6E) -> tuple:
    """A block and its lane table with the bit schedule's edge cases: an
    empty first lane, a lane of one run (5,000 zero bytes), a lane that
    holds all 256 byte values (a run each, 255 down to 0, so the ranks
    reach 255), an empty lane between live ones, then runs of 1-40 bytes
    over four byte values cut into lanes at random points (runs cross
    lane starts), and a sixteenth of the lanes dead at the end.  Returns
    (bytes, int32 sizes summing to the length)."""
    g = np.random.default_rng(seed)
    head = [b"", bytes(5000), np.repeat(np.arange(255, -1, -1, dtype=np.uint8),
                                        g.integers(1, 4, 256)).tobytes(), b""]
    live = lanes - len(head) - lanes // 16
    body = np.repeat(g.integers(0, 4, live * lane_bytes).astype(np.uint8),
                     g.integers(1, 41, live * lane_bytes))[:live * lane_bytes]
    cuts = np.sort(g.integers(0, len(body), live - 1))
    spans = np.diff(np.concatenate([[0], cuts, [len(body)]]))
    sizes = [len(h) for h in head] + spans.tolist() + [0] * (lanes // 16)
    return b"".join(head) + body.tobytes(), np.asarray(sizes, np.int32)


def batch_edges(seed: int = 0xBA7C) -> dict:
    """K9's and K10's edges, name -> the lanes of a block (bytes each;
    lay_lanes makes the block and its lane table).  K9 ranks 32 runs a
    warp step and K10 stages 512 runs a tile: two lanes each of 1, 31,
    32, 33, 64, 512 and 513 runs; a batch in which one char recurs three
    times; a batch whose first run's char was last used in the batch
    before it; all 256 byte values in one lane, its first two batches
    drawn from all eight 32-value words of the table, then every value
    once (ranks up to 255); a lane that starts with the byte the lane
    before it ends with (a run cut by the lane start); empty lanes before
    and between live ones."""
    g = np.random.default_rng(seed)

    def lane(chars) -> bytes:
        return b"".join(bytes([c]) * int(g.integers(1, 4)) for c in chars)

    def walk(n: int, alphabet: int = 10, avoid=()) -> list:
        """n chars below ``alphabet``, each unlike the one before it, none
        in ``avoid``."""
        out = []
        while len(out) < n:
            c = int(g.integers(0, alphabet))
            if c not in avoid and (not out or c != out[-1]):
                out.append(c)
        return out

    cases = {f"runs_{n}": [lane(walk(n)), lane(walk(n, 40))]
             for n in (1, 31, 32, 33, 64, 512, 513)}
    recur = walk(40, avoid=(200,))
    for i in (3, 9, 20):
        recur[i] = 200
    carry = walk(40, avoid=(77,))
    carry[30] = carry[32] = 77  # run 32 opens the second batch
    cases["recur_3"] = [lane(recur)]
    cases["carry_over"] = [lane(carry)]
    every = g.permutation(256).tolist()
    cases["all_256"] = [lane(g.permutation(256)[:64].tolist() + every)]
    a = walk(20)
    cases["same_byte_at_lane_start"] = [
        lane(a), bytes([a[-1]]) * 3 + lane(walk(20, avoid=(a[-1],)))]
    cases["empty_lane"] = [b"", lane(walk(20)), b"", lane(walk(20))]
    return cases


def lay_lanes(lanes: list, L: int) -> tuple:
    """(bytes, int32 sizes [L]): the lanes end to end, then empty ones."""
    sizes = [len(x) for x in lanes] + [0] * (L - len(lanes))
    return b"".join(lanes), np.asarray(sizes, np.int32)


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
    pk, max_bits = WK.host_schedule_packed(  # room for the longest lane
        np.frombuffer(data, np.uint8).copy(), n, native.i32p(sizes),
        max(-(-n // WK.LANES), int(sizes.max())))
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
    from libbsc_tpu_torch.ops import lzp_screen as Z
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
    reset_scan_launches()
    Z.reset_launches()
    archive, t_enc = timed(lambda: P.compress(data, **kw))
    scan_enc, sort_enc = scan_launches(), sort_launches()
    screened = Z.LAUNCHES["lzp_screen"]
    reset_scan_launches()
    back, t_dec = timed(lambda: P.decompress(archive))
    scan_dec, sort_dec = scan_launches(), sort_launches()
    launches = dict(WK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if back != data:
        fail(f"{coder}: the device decode did not restore the input")
    warm_enc, warm_dec = warm_calls(data, kw, composed, archive)
    WK.RANS = True
    ran, idle = (V3, V2) if rans else (V2, V3)
    if min(launches[k] for k in ran) == 0 or max(launches[k] for k in idle):
        fail(f"{coder}: the main path did not run its kernels, and only "
             f"them: {launches}")
    if scan_enc != SCAN_ENCODE or scan_dec != SCAN_DECODE:
        fail(f"{coder}: K8-K10 did not launch once each where they run: "
             f"encode {scan_enc}, decode {scan_dec}")
    launches.update({k: scan_enc[k] + scan_dec[k] for k in SCAN})
    if any(sort_enc[k] < SORT_ENCODE[k] for k in SORT) or \
            any(sort_dec.values()):
        fail(f"{coder}: K11-K14 did not launch in the encode ({SORT_ENCODE}"
             f" at least), or launched in the decode: encode {sort_enc}, "
             f"decode {sort_dec}")
    launches.update(sort_enc)
    if screened != 1:
        fail(f"{coder}: K15 launched {screened} times in the encode, not "
             "once")
    launches["lzp_screen"] = screened
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
          f"memory {peak} B, launches {launches}; warm (best of "
          f"{len(warm_enc)}) encode {mb / min(warm_enc) * 1e3:.2f} MB/s "
          f"({'/'.join(f'{t:.1f}' for t in warm_enc)} ms), decode "
          f"{mb / min(warm_dec) * 1e3:.2f} MB/s "
          f"({'/'.join(f'{t:.1f}' for t in warm_dec)} ms)", flush=True)
    return launches, archive


def warm_calls(data: bytes, kw: dict, composed: bytes, archive: bytes):
    """WARM_CALLS more api.compress / api.decompress calls of the main
    path after its first, timed (ms lists).  Each archive must equal the
    composed one and each decode must restore the block; the host buffer
    pool's slots on this thread must keep the addresses they had after
    the first call, and the fused route's two copy slots ("compress_lz",
    the H2D's source, and "decompress_lz", the D2H's destination) must be
    page-locked."""
    import torch

    import libbsc_tpu_torch as P
    from libbsc_tpu_torch.utils import bufpool

    def held():
        return {k: (v.ctypes.data, len(v)) for k, v in bufpool.slots().items()}

    first = held()
    enc, dec = [], []
    for _ in range(WARM_CALLS):
        a, t = timed(lambda: P.compress(data, **kw))
        enc.append(t)
        b, t = timed(lambda: P.decompress(archive))
        dec.append(t)
        if a != composed or b != data:
            fail("a warm call's archive differs from the composed one or "
                 "its decode did not restore the block")
        if held() != first:
            fail(f"the pool's slots moved in a warm call: {first} -> "
                 f"{held()}")
    pinned = sorted(k[0] for k, v in bufpool.slots().items()
                    if k[1] and torch.from_numpy(v).is_pinned())
    if pinned != ["compress_lz", "decompress_lz"]:
        fail(f"the fused route's slots are not page-locked: pinned {pinned} "
             f"of {sorted(bufpool.slots())}")
    return enc, dec


def host_split(repo: str) -> None:
    """Phase 3 (b): tools/host_split.py on this checkout, in a fresh
    process, so its first call is the process's first: the -m9 -e4 -G
    walls beside their stages and each host step outside the stages,
    cold and warm (see the tool).  Fails when the tool fails."""
    from tools import host_split as tool

    out = subprocess.run([sys.executable, tool.__file__, "--tree", repo],
                         capture_output=True, text=True, timeout=900)
    lines = [ln[10:] for ln in out.stdout.splitlines()
             if ln.startswith("HOSTSPLIT ")]
    if out.returncode != 0 or not lines:
        fail(f"tools/host_split.py exit {out.returncode}:\n"
             f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    print(f"phase 3 (b) host split: {tool.summary(json.loads(lines[0]))}; "
          f"{smi()}", flush=True)


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


def schedule_stages(U, stage) -> tuple:
    """wide_kernels.resident_prep on the block U, its schedule split into
    timed sub-stages (``stage(name, fn)``): lanes (device_balanced_sizes),
    stats (run boundaries, counts, longest run: the refusals' inputs),
    events (K9, and the read of max_bits), planes (K10) and transpose (to
    K1's [IT/4, 1024] layout).  Returns resident_prep's tuple."""
    from libbsc_tpu_torch.ops import wide_kernels as WK
    from libbsc_tpu_torch.ops import wide_schedule as WS

    sizes_d = stage("lanes", lambda: WS.device_balanced_sizes(U, WK.LANES))
    rs, starts, sizes64, frid_ext = stage(
        "stats", lambda: sched_inputs(U, sizes_d))
    ev, max_bits = stage("events", lambda: (lambda e: (e, int(e[3].max())))(
        WS.schedule_events(U, rs, starts, sizes64, frid_ext)))
    IT = WK._it_bucket(max(max_bits, WK.TI))
    packed = stage("planes", lambda: WS.schedule_planes(*ev, frid_ext, IT))
    planes = stage("transpose", lambda: packed[:, : IT // 4].t().contiguous())
    return planes, sizes_d.cpu().numpy().astype(np.int32), max_bits, IT


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
    n = len(lz)
    left = []  # each round's unresolved count
    rank, still, cnt = stage("boot", lambda: (lambda t: (t[0], t[1], int(
        t[2])))(bwt._rank_pairs(*bwt.boot_keys(lz_d))))
    rank = stage("rounds", lambda: bwt._refine(rank, still, cnt,
                                               bwt._BOOT_DEPTH, n, left))
    del still
    U, primary, aux = stage("extract", lambda: bwt.extract(lz_d, rank, r))
    ms["bwt"] = ms["boot"] + ms["rounds"] + ms["extract"]
    del rank
    prep = schedule_stages(U, stage)
    ms["schedule"] = sum(ms[k] for k in ("lanes", "stats", "events",
                                         "planes", "transpose"))
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
    pairs, ends, heads = stage("psi", lambda: bwt.chase_inputs(
        U2, int(primary), aux))
    T = stage("chase", lambda: bwt.chase(pairs, ends, heads, r, len(lz)))
    ms["unbwt"] = ms["psi"] + ms["chase"]
    del pairs, ends, heads
    T_h = stage("d2h", lambda: T.cpu().numpy())
    out = T_h
    if lzp:
        out = stage("unlzp", lambda: engine.lzp_decompress(
            T_h, C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN, features,
            capacity=len(data) + 4096))
    if out.tobytes() != data:
        fail("the stage-by-stage round trip did not restore the input")
    print("phase 3 stages (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ms.items())
        + f"; the bootstrap left {cnt} unresolved, the rounds {left}",
        flush=True)
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


def lzp_pays_block(n_bytes: int) -> bytes:
    """Log lines: 32 fixed texts of about 150 bytes, each line with two
    fields drawn from a seed; the native LZP shortens such a block."""
    rng = np.random.default_rng(0x15C)
    heads = [b"host-%02d service=%s level=info msg=\"request handled\" "
             b"path=/v1/%s/items method=GET status=200 proto=HTTP/1.1 "
             b"agent=client/%d.%d " % (i, b"api-gateway-%d" % (i % 5),
                                      b"tenant-%d" % i, i % 3, i)
             for i in range(32)]
    out = bytearray()
    while len(out) < n_bytes:
        for h, a, b in zip(rng.integers(0, 32, 4096),
                           rng.integers(0, 10**6, 4096),
                           rng.integers(0, 10**4, 4096)):
            out += heads[h] + b"bytes=%d elapsed_us=%d\n" % (a, b)
    return bytes(out[:n_bytes])


def time_lzp_screen(data: bytes, device) -> list:
    """Phase 2: K15 on the 25 MiB text block, where LZP is rejected, and
    on a 25 MiB block where it pays (lzp_pays_block): its flags against
    the plain version's, the kernel (CUDA events; each launch reads one of
    COLD_COPIES copies), what the API waits for (engine.lzp_screen: the
    page-locked slot's copy, the screen, the flags read back), the host
    LZP attempt the screen spares or precedes, and the plain version on
    the CPU.  Where every flag is 0 the native LZP must reject the
    block."""
    import torch

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import lzp_screen as Z
    from libbsc_tpu_torch.utils import bufpool

    ml, hs = C.DEFAULT_LZPMINLEN, C.DEFAULT_LZPHASHSIZE
    features = C.FEATURE_MULTITHREADING | C.FEATURE_CUDA
    row = {"name": "lzp_screen", "route": "cuda",
           "source": "libbsc_tpu_torch/csrc/lzp_screen.cu",
           "replaces": REPLACES["lzp_screen"], "library_ms": None}
    for kind, block in (("text", data), ("pays", lzp_pays_block(len(data)))):
        n = len(block)
        buf = np.frombuffer(block, np.uint8)
        x = torch.from_numpy(buf.copy()).to(device)
        flags = Z.screen(x, ml).cpu()
        t0 = time.perf_counter()
        plain = Z.screen_plain(torch.from_numpy(buf.copy()), ml)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(flags, plain):
            fail(f"lzp_screen differs from its plain version on the 25 MiB "
                 f"{kind} block: {flags.tolist()} against {plain.tolist()}")
        copies = [x] + [x.clone() for _ in range(COLD_COPIES - 1)]
        turn = itertools.cycle(copies)
        ms = cuda_ms(lambda: Z.screen(next(turn), ml), TIMED_LAUNCHES)
        del copies, turn
        slot = bufpool.get("compress_lz", n, pinned=True)
        np.copyto(slot, buf)
        call = [timed(lambda: engine.lzp_screen(slot, ml, device))[1]
                for _ in range(3)]
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            lz = engine.lzp_compress(buf, hs, ml, features)
            host.append((time.perf_counter() - t0) * 1e3)
        if not flags.any() and lz is not None:
            fail(f"lzp_screen ruled out LZP on the {kind} block, but LZP "
                 f"shortened it to {len(lz)} bytes")
        geo = Z.geometry(n, ml)
        b, by = bound_ms(n + 16 * geo.total, 20 * geo.total)
        key = "" if kind == "text" else "pays_"
        row.update({f"{key}ms": ms, f"{key}call_ms": min(call),
                    f"{key}host_lzp_ms": min(host),
                    f"{key}flags": flags.tolist()})
        if kind == "text":
            row.update(plain_ms=plain_ms, plain_at_bytes=n, bound_ms=b,
                       bound_by=by)
        print(f"phase 2 time lzp_screen on {kind}: {ms:.4f} ms (bound "
              f"{b:.4f} ms by {by}), flags {flags.tolist()}; the API's "
              f"copy + screen + read back {'/'.join(f'{t:.3f}' for t in call)}"
              f" ms; host LZP attempt {'/'.join(f'{t:.1f}' for t in host)} "
              f"ms, {'rejected' if lz is None else f'{len(lz)} bytes'}; "
              f"plain {plain_ms:.1f} ms, {n} bytes", flush=True)
        del x
    return [row]


def scan_launches() -> dict:
    """K8-K10's launch counts."""
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import wide_schedule as WS

    return {k: v for k, v in {**bwt.LAUNCHES, **WS.LAUNCHES}.items()
            if k in SCAN}


def sort_launches() -> dict:
    """K11-K14's launch counts."""
    from libbsc_tpu_torch.ops import bwt

    return {k: bwt.LAUNCHES[k] for k in SORT}


def reset_scan_launches() -> None:
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import wide_schedule as WS

    bwt.reset_launches()
    WS.reset_launches()


def sched_inputs(u, sizes) -> tuple:
    """What device_schedule_v2 hands K9 for the block ``u`` (on the card)
    and the lane table ``sizes``: (rs, starts, sizes, frid_ext), the
    arguments of schedule_events after the block."""
    import torch

    from libbsc_tpu_torch.ops import wide_schedule as WS

    sizes_d = torch.as_tensor(sizes).to(device=u.device, dtype=torch.int64)
    starts, frid_ext, _, rs, _, _ = WS.lane_runs(u, sizes_d)
    return rs, starts, sizes_d, frid_ext


def max_err(a: tuple, b: tuple) -> int:
    """Largest absolute difference over pairs of equal-shape tensors;
    a shape mismatch is a failure."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            fail(f"shapes differ: {tuple(x.shape)} and {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def check_schedule(case: str, u: np.ndarray, sizes, device) -> dict:
    """K9 and K10 on one block ``u`` (the coder's input) with the lane
    table ``sizes`` (1024 lanes), each against its plain version on the
    same inputs, exactly: K9's per-run ranks, lengths, bit counts and
    first bits and lane totals, K10's planes, which must also equal the
    native walker's for that table.  Returns name -> max_abs_err (0, or
    the script fails), and the run count and max_bits."""
    import torch

    from libbsc_tpu_torch.ops import wide_kernels as WK
    from libbsc_tpu_torch.ops import wide_schedule as WS

    u_d = torch.from_numpy(np.array(u, np.uint8)).to(device)
    rs, starts, sizes_d, frid_ext = sched_inputs(u_d, sizes)
    ev = WS.schedule_events(u_d, rs, starts, sizes_d, frid_ext)
    err = {"sched_events": max_err(ev, WS.schedule_events_plain(
        u_d, starts, sizes_d, frid_ext))}
    max_bits = int(ev[3].max())
    IT = WK._it_bucket(max(max_bits, WK.TI))
    planes = WS.schedule_planes(*ev, frid_ext, IT)
    err["sched_planes"] = max_err((planes,), (WS.schedule_planes_plain(
        *ev, frid_ext, IT),))
    for name, e in err.items():
        if e:
            fail(f"{name} differs from its plain version by {e} on the "
                 f"{case} block")
    native, _, native_bits = lane_planes(u.tobytes(), sizes)
    if native_bits != max_bits or not np.array_equal(
            planes.t().cpu().numpy(), native):
        fail(f"K9 + K10: the {case} block's planes differ from the native "
             "walker's")
    return err, int(rs.shape[0]), max_bits


def check_scan(case: str, u: np.ndarray, sizes, device) -> dict:
    """Phase 2 check of K8, K9 and K10 on one block ``u`` (the coder's
    input, a BWT output) with the lane table ``sizes``, each against its
    plain version on the same inputs, exactly: K9 and K10 as
    check_schedule holds them, and K8's chase of the block's own wide-aux
    BWT (also against the block).  Returns name -> max_abs_err (0, or the
    script fails)."""
    import torch

    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt

    n = len(u)
    err, R, max_bits = check_schedule(case, u, sizes, device)
    u_d = torch.from_numpy(np.array(u, np.uint8)).to(device)
    r = engine.wideaux_rate(n)
    U, primary, aux = bwt.bwt_encode_wideaux_device(u_d, r)
    pairs, ends, heads = bwt.chase_inputs(U, int(primary), aux)
    u_sorted = torch.sort(U, stable=True)[1]
    err["unbwt_table"] = max_err((pairs,), (bwt.pair_table_plain(
        u_sorted, int(primary), ends),))
    del u_sorted
    out = bwt.chase(pairs, ends, heads, r, n)
    err["unbwt_chase"] = max_err((out,), (bwt.chase_plain(
        pairs, ends, heads, r, n),))
    if out.cpu().numpy().tobytes() != u.tobytes():
        fail(f"K8: the chase of the {case} block does not restore it")
    for name in ("unbwt_table", "unbwt_chase"):
        if err[name]:
            fail(f"{name} differs from its plain version by {err[name]} on "
                 f"the {case} block")
    print(f"phase 2 check {case}: K8 (table and chase), K9 and K10 equal to "
          f"their plain versions, the planes to the native walker's, the "
          f"chase to the "
          f"block; {n} bytes, {R} runs, {int((np.asarray(sizes) > 0).sum())}"
          f" live lanes, {max_bits} iterations, {aux.shape[0] + 1} chains of "
          f"{r}", flush=True)
    return err


def check_scan_all(st: dict, text: bytes, device) -> dict:
    """check_scan on the 4 MiB block (its device lane table), edge_block
    and the hard blocks (each with its own table; the native balancer's
    for the high-entropy one); check_schedule on each of batch_edges."""
    from libbsc_tpu_torch.ops import wide as W
    from libbsc_tpu_torch.ops import wide_kernels as WK

    data, sizes = edge_block()
    errs = [check_scan("4 MiB", st["U"], st["sizes"], device),
            check_scan("edges", np.frombuffer(data, np.uint8), sizes,
                       device)]
    edges = batch_edges()
    for case, lanes in edges.items():
        data, sizes = lay_lanes(lanes, WK.LANES)
        errs.append(check_schedule(case, np.frombuffer(data, np.uint8),
                                   sizes, device)[0])
    print(f"phase 2 check: K9 and K10 equal to their plain versions and the "
          f"native walker's planes on the batch edges: {', '.join(edges)}",
          flush=True)
    for case, (data, sizes) in hard_blocks(text).items():
        u = np.frombuffer(data, np.uint8)
        if sizes is None:
            sizes = lane_planes(data, None)[1]
        if sizes is None:  # the native balancer gave no table
            sizes = np.asarray(W.lane_sizes(len(u), WK.LANES), np.int32)
        errs.append(check_scan(f"hard {case}", u, sizes, device))
    return {name: {"max_abs_err": max(e.get(name, 0) for e in errs)}
            for name in SCAN}


def canonical(f: str, out: tuple) -> tuple:
    """An output of ops/bwt's wrapper ``f`` in the form its plain version
    gives it: K13's unresolved list cut to its count, K14's stage sorted
    within each bucket (the kernel's order there is its atomics')."""
    import torch

    if f in ("heads_full", "heads_compact"):
        *rest, still, cnt = out
        return (*rest, still[:int(cnt)], cnt)
    if f == "extract_bins":
        stage, *rest = out
        whole = stage.shape[0] - stage.shape[0] % K14_BUCKET
        return (torch.cat([
            torch.sort(stage[:whole].view(-1, K14_BUCKET), 1).values.view(-1),
            torch.sort(stage[whole:]).values]), *rest)
    return out


@contextlib.contextmanager
def held_to_plain(err: dict):
    """Within the block, every call of K11-K14's wrappers (ops/bwt's
    boot_keys, round_keys, heads_pay, heads_full, heads_compact,
    extract_bins, extract_place and extract) also runs its plain version
    on the same inputs (heads_compact's on a copy of the ranks it
    updates), and err[kernel] gets the largest absolute difference of any
    output (each in canonical form)."""
    from libbsc_tpu_torch.ops import bwt

    names = {"boot_keys": "bwt_boot_keys", "round_keys": "bwt_round_keys",
             "heads_pay": "bwt_heads_pay", "heads_full": "bwt_heads",
             "heads_compact": "bwt_heads",
             "extract_bins": "bwt_extract_bins",
             "extract_place": "bwt_extract", "extract": "bwt_extract"}
    saved = {f: getattr(bwt, f) for f in names}

    def held(f):
        plain = getattr(bwt, f + "_plain")

        def call(*args, **kw):
            if f == "heads_compact":
                rank_p = args[3].clone()
                out = saved[f](*args)
                e = max_err(canonical(f, (args[3], *out)),
                            (rank_p, *plain(*args[:3], rank_p)))
            else:
                out = saved[f](*args, **kw)
                got = out if isinstance(out, tuple) else (out,)
                want = plain(*args, **kw)
                e = max_err(canonical(f, got),
                            want if isinstance(want, tuple) else (want,))
            err[names[f]] = max(err[names[f]], e)
            return out
        return call

    for f in names:
        setattr(bwt, f, held(f))
    try:
        yield
    finally:
        for f, fn in saved.items():
            setattr(bwt, f, fn)


def check_sort(case: str, data: np.ndarray, device) -> dict:
    """Phase 2 check of K11-K14 on one block: the wide-aux BWT (prefix
    quadrupling) and, from 64 bytes, the DC3 BWT on the card, each kernel
    call held to its plain version on the same inputs (held_to_plain),
    exactly; U, the primary and the aux indexes equal to the native
    tbsc_bwt_encode_rate's at the wide-aux rate, and DC3's to the native
    tbsc_bwt_encode's.  K11, K13 and K14 must launch.  Returns name ->
    max_abs_err (0, or the script fails)."""
    import torch

    from libbsc_tpu_torch import engine, native
    from libbsc_tpu_torch.ops import bwt

    n = len(data)
    d = torch.from_numpy(np.array(data, np.uint8)).to(device)
    r = engine.wideaux_rate(n)
    err = dict.fromkeys(SORT, 0)
    before = sort_launches()
    with held_to_plain(err):
        U, primary, aux = bwt.bwt_encode_wideaux_device(d, r)
        dc3 = bwt.bwt_encode_dc3(d) if n >= 64 else None
    launched = {k: v - before[k] for k, v in sort_launches().items()}
    ref = np.array(data, np.uint8)
    k = (n - 1) // r
    idx = np.zeros(max(k, 1), np.int32)
    p = native.load().tbsc_bwt_encode_rate(native.u8p(ref), n, r,
                                           native.i32p(idx))
    if U.cpu().numpy().tobytes() != ref.tobytes() or int(primary) != p \
            or not np.array_equal(aux.cpu().numpy(), idx[:k]):
        fail(f"K11-K14: the {case} block's wide-aux BWT differs from the "
             "native tbsc_bwt_encode_rate")
    if dc3 is not None:
        ref = np.array(data, np.uint8)
        p, ni, idx = engine.bwt_encode(ref, 0)
        if dc3[0].cpu().numpy().tobytes() != ref.tobytes() or \
                int(dc3[1]) != p or \
                not np.array_equal(dc3[2].cpu().numpy(), idx[:ni]):
            fail(f"K11-K14: the {case} block's DC3 BWT differs from the "
                 "native tbsc_bwt_encode")
    for name, e in err.items():
        if e:
            fail(f"{name} differs from its plain version by {e} on the "
                 f"{case} block")
    if min(launched[k] for k in SORT if k != "bwt_round_keys") == 0:
        fail(f"K11-K14 did not launch on the {case} block: {launched}")
    print(f"phase 2 check {case}: K11-K14 equal to their plain versions, "
          f"the BWT to the native one{' (and DC3)' if dc3 else ''}; {n} "
          f"bytes, rate {r}, launches {launched}", flush=True)
    return err


def periodic_block(n: int) -> bytes:
    return (b"abcd" * (n // 4 + 1))[:n]


def check_sort_all(st: dict, text: bytes, device) -> dict:
    """check_sort on the 4 MiB block (its LZP output, as the main path
    sorts it), an all-zero and a periodic 4 MiB block, the high-entropy
    hard block and the text at SORT_SIZES."""
    blocks = {"4 MiB": st["lz"], "zeros": bytes(PLAIN_BLOCK),
              "periodic": periodic_block(PLAIN_BLOCK),
              "high-entropy": hard_blocks(text)["random"][0]}
    blocks.update({f"{n} bytes": text[:n] for n in SORT_SIZES})
    t0 = time.perf_counter()
    errs = [check_sort(case, np.frombuffer(b, np.uint8), device)
            for case, b in blocks.items()]
    print(f"phase 2 check: K11-K14 on {len(blocks)} blocks in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {name: {"max_abs_err": max(e[name] for e in errs)}
            for name in SORT}


def time_sort(st: dict, device) -> list:
    """Phase 2 time of K11-K14 with CUDA events on the 25 MiB block's own
    inputs (the main path's: the block as its LZP leaves it, the
    bootstrap's sorted keys, its ranks, the final ranks), each held to its
    plain version there and beside it (timed once); K13's main pass
    beside torch.cummax of its rows' head positions (library_ms: the call
    the plain version makes, alone), its pre-pass beside the torch gather
    key_hi[o1] it took over.  K13 (pre-pass + main pass) and K14 (both
    passes) are also summed, beside the bound of the function each
    computes.  K12 and K13 also in the compact round's form, on that
    round's rows."""
    import torch

    from libbsc_tpu_torch.ops import bwt

    d = torch.from_numpy(np.array(st["lz"], np.uint8)).to(device)
    n, r = int(d.shape[0]), st["r"]
    k0 = bwt._BOOT_DEPTH
    k_hi, k_lo = bwt.boot_keys(d)
    lo_s, o1 = torch.sort(k_lo, stable=True)
    del k_lo
    hi1, pay = bwt.heads_pay(lo_s, o1, k_hi)
    hi_s, o2 = torch.sort(hi1, stable=True)
    del hi1
    rank, _, cnt = bwt.heads_full(hi_s, pay, o2)
    where = torch.where(bwt._pay_sorted(hi_s, pay, o2)[1],
                        torch.arange(n, device=device), -1)
    full = bwt._rank_pairs(*bwt.round_keys(rank, k0))
    uidx = full[1][:int(full[2])]
    c_a, c_lo = bwt.round_keys(full[0], 4 * k0, uidx)
    c_hi, c_pay, c_o2 = bwt._sort_rows(c_a, c_lo, uidx)
    c_lo_s, c_o1 = torch.sort(c_lo, stable=True)
    c_rank = full[0].clone()
    del c_lo
    final = bwt.suffix_ranks(d)
    stage = bwt.extract_bins(d, final, r)[0]
    m = int(uidx.shape[0])
    n_aux = (n - 1) // r
    left = int(cnt)
    runs = {  # name -> (kernel, plain, bytes, library call)
        "bwt_boot_keys": (lambda: bwt.boot_keys(d),
                          lambda: bwt.boot_keys_plain(d), 17 * n, None),
        "bwt_round_keys": (lambda: bwt.round_keys(rank, k0),
                           lambda: bwt.round_keys_plain(rank, k0), 24 * n,
                           None),
        # the first sort's values and indices, the high keys read; the
        # second sort's input and the packed words written
        "bwt_heads_pay": (lambda: bwt.heads_pay(lo_s, o1, k_hi),
                          lambda: bwt.heads_pay_plain(lo_s, o1, k_hi),
                          40 * n, None),
        # the sorted high keys, the second sort's indices and the packed
        # words read; rank and the unresolved list written
        "bwt_heads": (lambda: bwt.heads_full(hi_s, pay, o2),
                      lambda: bwt.heads_full_plain(hi_s, pay, o2),
                      32 * n + 8 * left + 8, lambda: torch.cummax(where, 0)),
        # the ranks and the block read; the stage, aux and primary written
        "bwt_extract_bins": (lambda: bwt.extract_bins(d, final, r),
                             lambda: bwt.extract_bins_plain(d, final, r),
                             13 * n + 4 * n_aux + 8, None),
        # the stage read, U written
        "bwt_extract": (lambda: bwt.extract_place(stage),
                        lambda: bwt.extract_place_plain(stage), 5 * n, None),
    }
    wrapper = {"bwt_boot_keys": "boot_keys", "bwt_round_keys": "round_keys",
               "bwt_heads_pay": "heads_pay", "bwt_heads": "heads_full",
               "bwt_extract_bins": "extract_bins",
               "bwt_extract": "extract_place"}
    compact_calls = {
        "bwt_round_keys": lambda: bwt.round_keys(full[0], 4 * k0, uidx),
        "bwt_heads_pay": lambda: bwt.heads_pay(c_lo_s, c_o1, c_a, uidx),
        "bwt_heads": lambda: bwt.heads_compact(c_hi, c_pay, c_o2, c_rank)}
    rows = []
    for name, (kernel, plain, nbytes, library) in runs.items():
        ms = cuda_ms(kernel, TIMED_LAUNCHES)
        out_p, plain_ms = timed(plain)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        out_k = kernel()
        if max_err(canonical(wrapper[name], out_k if isinstance(
                out_k, tuple) else (out_k,)), out_p):
            fail(f"{name} differs from its plain version on the 25 MiB "
                 "block")
        del out_p, out_k
        b, by = bound_ms(nbytes, 0)
        lib_ms = cuda_ms(library, TIMED_LAUNCHES) if library else None
        row = {"name": name, "route": "cuda",
               "source": f"libbsc_tpu_torch/csrc/{SOURCE[name]}.cu",
               "replaces": REPLACES[name], "ms": ms, "plain_ms": plain_ms,
               "plain_at_bytes": n, "bound_ms": b, "bound_by": by,
               "library_ms": lib_ms, "rows": n}
        extra = f", torch.cummax {lib_ms:.3f} ms" if lib_ms else ""
        if name == "bwt_heads_pay":
            row["gather_ms"] = cuda_ms(lambda: k_hi[o1], TIMED_LAUNCHES)
            extra += f", the gather key_hi[o1] {row['gather_ms']:.4f} ms"
        if name in compact_calls and m:
            row["compact_ms"] = cuda_ms(compact_calls[name], TIMED_LAUNCHES)
            row["compact_rows"] = m
            extra += (f"; its compact form on the compact round's {m} rows "
                      f"{row['compact_ms']:.4f} ms")
        rows.append(row)
        print(f"phase 2 time {name}: {ms:.4f} ms (bound {b:.4f} ms by {by})"
              f", plain {plain_ms:.1f} ms{extra}; {n} rows, the bootstrap "
              f"left {left} unresolved, the full round {int(full[2])}",
              flush=True)
    by_name = {row["name"]: row for row in rows}
    # K13 and K14 whole, beside the bound of the function each computes:
    # K13 reads the sorted keys and the permutation and writes rank and
    # mask (41 bytes a row); K14 reads T and rank and writes U (10)
    for kid, parts, nbytes in (
            ("K13", ("bwt_heads_pay", "bwt_heads"), 41 * n),
            ("K14", ("bwt_extract_bins", "bwt_extract"),
             10 * n + 4 * n_aux + 8)):
        ms = sum(by_name[p]["ms"] for p in parts)
        b = bound_ms(nbytes, 0)[0]
        by_name[parts[-1]].update({f"{kid.lower()}_ms": ms,
                                   f"{kid.lower()}_bound_ms": b})
        print(f"phase 2 time {kid} ({' + '.join(parts)}): {ms:.4f} ms, "
              f"{ms / b:.1f}x the function's bound {b:.4f} ms; {smi()}",
              flush=True)
    return rows


def chase_latency(chase, heads, r: int, n: int, lz: np.ndarray) -> float:
    """K8's latency floor on the card: one chain of dependent loads
    through the whole table, launched alone (``chase(heads[t:t + 1], m)``
    chases chain t's m bytes), so that nothing overlaps its round trips.
    The mean milliseconds over eight chains spread over the block (CUDA
    events), each launched after a 256 MiB write has evicted the 50 MB
    L2; each chain's bytes must equal the block's."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=heads.device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    chains = int(heads.shape[0])
    ms = []
    for t in range(0, chains, -(-chains // 8)):
        m = min(r, n - t * r)
        flush.fill_(t & 0xFF)
        start.record()
        out = chase(heads[t:t + 1], m)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        if out.cpu().numpy().tobytes() != lz[t * r:t * r + m].tobytes():
            fail(f"K8: chain {t} alone does not restore its bytes")
    return float(np.mean(ms))


def time_scan(st: dict, device, clock_mhz: float) -> list:
    """Phase 2 time of K8 (its table and its chase), K9 and K10 with CUDA
    events on the 25 MiB block's own inputs (the main path's: its BWT,
    device lane table and wide-aux tail), each beside its plain version
    (timed once: a plain version takes as long as the stage did before
    its kernel).  No PyTorch call computes any of them (library_ms null).
    The chase's row also carries its whole table build (table_ms:
    ops/bwt.chase_inputs, the stable sort of the block's bytes, the bucket
    ends and the table kernel; sort_ms, the sort alone) and its latency
    floor (chase_latency).  Each kernel's output is held against
    its plain version's here too, and the chase's against the LZP'd
    block.  Then K8's step 0 and its other designs, each with its latency
    floor (tools/chase_variants.py), and K9's clock64() split and its
    longest lane launched alone (tools/schedule_step_split.py), both on
    this checkout's csrc/."""
    import torch

    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import wide_kernels as WK
    from libbsc_tpu_torch.ops import wide_schedule as WS
    from tools import chase_variants, schedule_step_split

    u_d = torch.from_numpy(st["U"]).to(device)
    n = len(st["U"])
    rs, starts, sizes_d, frid_ext = sched_inputs(u_d, st["sizes"])
    R, L = int(rs.shape[0]), int(starts.shape[0])
    ev = WS.schedule_events(u_d, rs, starts, sizes_d, frid_ext)
    max_bits = int(ev[3].max())
    IT = WK._it_bucket(max(max_bits, WK.TI))
    lanes = {"longest_lane": int(st["sizes"].max()),
             "longest_run": int(ev[1].max())}
    r, primary = st["r"], st["primary"]
    pairs, ends, heads = bwt.chase_inputs(u_d, primary, st["aux"])
    u_sorted = torch.sort(u_d, stable=True)[1]
    chains = int(heads.shape[0])
    # the chase loads a row for each two steps; a chain's odd last step
    # needs none
    loads = sum(min(r, n - t * r) // 2 for t in range(chains))
    runs = {  # name -> (kernel, plain, bytes, operations)
        "sched_events": (
            lambda: WS.schedule_events(u_d, rs, starts, sizes_d, frid_ext),
            lambda: WS.schedule_events_plain(u_d, starts, sizes_d,
                                             frid_ext),
            n + 8 * (3 * L + 1) + 16 * R + 8 * L, R),
        "sched_planes": (
            lambda: WS.schedule_planes(*ev, frid_ext, IT),
            lambda: WS.schedule_planes_plain(*ev, frid_ext, IT),
            12 * R + 8 * (2 * L + 1) + L * IT // 4, L * IT),
        "unbwt_table": (  # 8 search steps a row
            lambda: bwt.pair_table(u_sorted, primary, ends),
            lambda: bwt.pair_table_plain(u_sorted, primary, ends),
            8 * n + 4 * 256 + 8 * (n + 1), 8 * (n + 1)),
        "unbwt_chase": (  # 8 search steps a row's own char
            lambda: bwt.chase(pairs, ends, heads, r, n),
            lambda: bwt.chase_plain(pairs, ends, heads, r, n),
            8 * loads + 4 * 256 + 4 * chains + n, 8 * (n - loads)),
    }
    rows = []
    for name, (kernel, plain, nbytes, ops) in runs.items():
        ms = cuda_ms(kernel, TIMED_LAUNCHES)
        out = kernel()
        out = out if isinstance(out, tuple) else (out,)
        out_p, plain_ms = timed(plain)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        if max_err(out, out_p):
            fail(f"{name} differs from its plain version on the 25 MiB "
                 "block")
        del out_p
        if name == "unbwt_chase" and \
                out[0].cpu().numpy().tobytes() != st["lz"].tobytes():
            fail("K8: the chase of the 25 MiB block does not restore it")
        del out
        b, by = bound_ms(nbytes, ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "libbsc_tpu_torch/csrc/"
                               f"{SOURCE.get(name, name)}.cu",
                     "replaces": REPLACES[name], "ms": ms,
                     "plain_ms": plain_ms, "plain_at_bytes": n,
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "runs": R, "iters": max_bits, "chains": chains,
                     "rate": r, **lanes})
        extra = ""
        if name == "unbwt_chase":
            row = rows[-1]
            row["sort_ms"] = cuda_ms(
                lambda: torch.sort(u_d, stable=True), TIMED_LAUNCHES)
            row["table_ms"] = cuda_ms(
                lambda: bwt.chase_inputs(u_d, primary, st["aux"]),
                TIMED_LAUNCHES)
            row["latency_floor_ms"] = chase_latency(
                lambda h, m: bwt.chase(pairs, ends, h, r, m), heads, r, n,
                st["lz"])
            row["loads"] = loads
            extra = (f", one chain alone {row['latency_floor_ms']:.3f} ms "
                     f"({row['latency_floor_ms'] * 2e6 / r:.0f} ns a "
                     f"dependent load; {r // 2} loads); its table: "
                     f"torch.sort(stable=True) of the block "
                     f"{row['sort_ms']:.3f} ms, chase_inputs (sort, bucket "
                     f"ends, table kernel) {row['table_ms']:.3f} ms")
        print(f"phase 2 time {name}: {ms:.4f} ms (bound {b:.4f} ms by {by})"
              f", plain {plain_ms:.1f} ms{extra}; {n} bytes, {R} runs, "
              f"{max_bits} iterations, {chains} chains of {r}, longest lane "
              f"{lanes['longest_lane']} bytes, longest run "
              f"{lanes['longest_run']}", flush=True)
    del pairs, ends, heads, u_sorted
    repo = Path(os.path.dirname(os.path.abspath(__file__)))
    build = repo / "libbsc_tpu_torch" / "_build"
    k8 = next(row for row in rows if row["name"] == "unbwt_chase")
    k8.update(chase_variants.run(u_d, primary, st["aux"], r, st["lz"],
                                 build / "chase_variants"))
    csrc = str(repo / "libbsc_tpu_torch" / "csrc")
    split = schedule_step_split.run(
        [Path(csrc)], u_d, st["sizes"], clock_mhz,
        build / "schedule_step_split")
    row = split[csrc]
    rows[0].update({k: row[k] for k in ("longest_lane_ms", "most_runs_ms",
                                        "cycles_per_run_from_ms")},
                   split=row.get("split"))
    return rows


def k16_blocks(text: np.ndarray, n: int) -> dict:
    """K16's four kinds of block of n bytes: the text block, all zeros, a
    random 1,000-byte period repeated, uniform random bytes."""
    g = np.random.default_rng(1600)
    return {"text": np.array(text[:n], np.uint8),
            "zeros": np.zeros(n, np.uint8),
            "periodic": np.resize(g.integers(0, 256, 1000, dtype=np.uint8),
                                  n),
            "random": g.integers(0, 256, n, dtype=np.uint8)}


def time_rulers(text: np.ndarray, features: int, device) -> list:
    """Phase 2 time of K16's four kernels (rulers_table, rulers_gaps,
    rulers_rank with all its rounds, rulers_write) with CUDA events, on
    each kind of 25 MiB block of k16_blocks (the text: the block as the
    main path's LZP leaves it) through the device BWT at the format's aux
    rate (ops/bwt.bwt_encode: U, primary, aux indexes).  On every kind
    each kernel's output must equal its plain version's on the same
    inputs (timed once), the block must come back with status 0, and the
    native inverse must give it too.  The rows carry the text block's
    numbers, each kind's beside them (``by_kind``: ms, the longest gap);
    rulers_write's row also K16 whole (``unbwt_rulers.unbwt``: the sort,
    the bucket ends and the four kernels), the sort alone, the list
    ranking (``ops/bwt.bwt_decode``, the numpy engine's inverse) on the
    card and the native inverse on the host, by kind."""
    import torch

    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    names = ("rulers_table", "rulers_gaps", "rulers_rank", "rulers_write")
    rows = {name: {"name": name, "route": "cuda",
                   "source": "libbsc_tpu_torch/csrc/unbwt_rulers.cu",
                   "replaces": "none", "library_ms": None, "by_kind": {}}
            for name in names}
    for kind, data in k16_blocks(text, BLOCK).items():
        n = len(data)
        U, primary, aux = bwt.bwt_encode(torch.from_numpy(data).to(device))
        primary, aux = int(primary), aux.cpu().numpy()
        rows_h, offs = K16.start_rows(n, primary, aux)
        srows = torch.from_numpy(rows_h).to(device)
        offsets = torch.from_numpy(offs).to(device)
        chars, u_sorted = torch.sort(U, stable=True)
        ends = bwt.bucket_ends(chars)
        del chars
        pairs = K16.table(u_sorted, primary, ends, srows)
        succ, gap = K16.gaps(pairs, n, srows)
        rsucc, dist = K16.rank(succ, gap)
        out = torch.empty(n, dtype=torch.uint8, device=device)
        got, status = K16.write(pairs, ends, n, srows, offsets, rsucc, dist,
                                gap, out=out)
        if int(status) != 0 or not np.array_equal(got.cpu().numpy(), data):
            fail(f"K16: the 25 MiB {kind} block did not come back")
        nodes = int(succ.shape[0])
        rounds = (nodes - 1).bit_length()
        g = gap.cpu().numpy()
        walks = g[g > 0]
        # a walk of gap g loads g // 2 + 1 rows in the first chase (its
        # last load finds the next ruler) and ceil(g / 2) in the second
        loads1 = int((walks // 2 + 1).sum())
        loads2 = int(((walks + 1) // 2).sum())
        starts = int(srows.shape[0])
        runs = {  # name -> (kernel, plain, kernel outputs, bytes, ops)
            "rulers_table": (  # 8 search steps a row for its char
                lambda: K16.table(u_sorted, primary, ends, srows),
                lambda: K16.table_plain(u_sorted, primary, ends, srows),
                (pairs,), 8 * n + 4 * 256 + 4 * starts + 8 * (n + 1),
                8 * (n + 1)),
            "rulers_gaps": (
                lambda: K16.gaps(pairs, n, srows),
                lambda: K16.gaps_plain(pairs, n, srows), (succ, gap),
                8 * loads1 + 4 * starts + 12 * nodes, 0),
            "rulers_rank": (  # a round reads and gathers 24, writes 12
                lambda: K16.rank(succ, gap),
                lambda: K16.rank_plain(succ, gap), (rsucc, dist),
                36 * nodes * rounds, 0),
            "rulers_write": (  # 8 search steps a row whose char is sought
                lambda: K16.write(pairs, ends, n, srows, offsets, rsucc,
                                  dist, gap, out=out),
                lambda: K16.write_plain(pairs, ends, n, srows, offsets,
                                        rsucc, dist, gap),
                (got, status), 8 * loads2 + 4 * 256 + 12 * starts
                + 20 * nodes + n, 8 * loads2),
        }
        line = []
        for name, (kernel, plain, outs, nbytes, ops) in runs.items():
            ms = cuda_ms(kernel, TIMED_LAUNCHES)
            want, plain_ms = timed(plain)
            want = want if isinstance(want, tuple) else (want,)
            if any(not torch.equal(a.cpu(), b.cpu().to(a.dtype))
                   for a, b in zip(outs, want)):
                fail(f"{name} differs from its plain version on the 25 MiB "
                     f"{kind} block")
            del want
            b, by = bound_ms(nbytes, ops)
            rows[name]["by_kind"][kind] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                "longest_gap": int(walks.max()), "rulers": len(walks),
                "nodes": nodes, "rounds": rounds}
            if kind == "text":
                rows[name].update(ms=ms, plain_ms=plain_ms,
                                  plain_at_bytes=n, bound_ms=b, bound_by=by,
                                  rows=n, nodes=nodes, rounds=rounds,
                                  longest_gap=int(walks.max()))
            line.append(f"{name} {ms:.4f} (bound {b:.4f} by {by}, plain "
                        f"{plain_ms:.1f})")
        k16_ms = cuda_ms(lambda: K16.unbwt(U, primary, aux), TIMED_LAUNCHES)
        sort_ms = cuda_ms(lambda: bwt.bucket_ends(
            torch.sort(U, stable=True)[0]), TIMED_LAUNCHES)
        lr_ms = cuda_ms(lambda: bwt.bwt_decode(U, primary), 1)
        buf = U.cpu().numpy()
        rc, native_ms = timed(lambda: engine.bwt_decode(
            buf, primary, len(aux), aux, features))
        if rc != 0 or not np.array_equal(buf, data):
            fail(f"the native inverse did not restore the {kind} block")
        rows["rulers_write"]["by_kind"][kind].update(
            k16_ms=k16_ms, sort_ms=sort_ms, list_ranking_ms=lr_ms,
            native_ms=native_ms)
        if kind == "text":
            rows["rulers_write"].update(
                k16_ms=k16_ms, sort_ms=sort_ms, list_ranking_ms=lr_ms,
                native_ms=native_ms, k16_bound_ms=sum(
                    rows[k]["bound_ms"] for k in names))
        print(f"phase 2 time K16 on the {n}-byte {kind} block ({nodes} nodes, "
              f"{len(walks)} rulers, longest gap {int(walks.max())} rows, "
              f"{rounds} rounds): {'; '.join(line)} ms; whole "
              f"{k16_ms:.4f} ms (sort and bucket ends {sort_ms:.4f}); list "
              f"ranking {lr_ms:.2f} ms, native {native_ms:.1f} ms; {smi()}",
              flush=True)
        del U, u_sorted, pairs, succ, gap, rsucc, dist, out, got
        torch.cuda.empty_cache()
    return list(rows.values())


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
        sort_before = sort_launches()
        (out, idx, hist), ms = timed(
            lambda: make_transform_step(mesh, sorter=sorter, k=5)(grid))
        sorted_by = {k: v - sort_before[k]
                     for k, v in sort_launches().items()}
        if sorter == "bwt" and min(sorted_by[k] for k in SORT if k !=
                                   "bwt_round_keys") < len(blocks):
            fail(f"step bwt: K11, K13 and K14 did not launch for each "
                 f"block: {sorted_by}")
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
              "MB/s, equal to the native sorter"
              + (f"; K11-K14 launches {sorted_by}" if sorter == "bwt"
                 else ""), flush=True)
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
    from libbsc_tpu_torch.ops import unbwt_rulers as K16
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
        sort_before = sort_launches()
        env = dict(os.environ)
        _, t_dev_enc = timed(lambda: cli.compress_file(inp, arch, args("-G"),
                                                       quiet=True))
        sorted_on_card = engine.DEVICE_ROUTES["bwt_encode"] - before
        farm_sort = {k: v - sort_before[k]
                     for k, v in sort_launches().items()}
        if min(farm_sort[k] for k in SORT if k != "bwt_round_keys") < \
                sorted_on_card:
            fail(f"cli -G: K11, K13 and K14 did not launch for each of the "
                 f"{sorted_on_card} blocks sorted on the card: {farm_sort}")
        if dict(os.environ) != env:
            fail("cli -G wrote into the process environment")
        if _entries(arch) != host:
            fail("cli -G: the default config's entries differ from the "
                 "host archive's")
        if sorted_on_card < 1:
            fail(f"cli -G: the device BWT ran {sorted_on_card} times for "
                 f"{len(host)} blocks")
        os.remove(back)
        k16_want = k16_launches(arch)
        before = engine.DEVICE_ROUTES["bwt_decode"]
        K16.reset_launches()
        _, t_def_dec = timed(lambda: cli.decompress_file(
            arch, back, args("-G"), quiet=True))
        k16 = dict(K16.LAUNCHES)
        inverted = engine.DEVICE_ROUTES["bwt_decode"] - before
        if not restored():
            fail("cli -G did not restore the default-config file")
        if k16 != k16_want or inverted != k16_want["rulers_write"]:
            fail(f"cli d -G: K16 launched {k16} and DEVICE_ROUTES counted "
                 f"{inverted} inverses, where its blocks of 1 MiB or more "
                 f"want {k16_want}")
        lz = engine.lzp_compress(np.frombuffer(data[:BLOCK], np.uint8),
                                 C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                                 features)
        lz = np.frombuffer(data[:BLOCK], np.uint8) if lz is None else lz
        before = engine.DEVICE_ROUTES["bwt_encode"]
        sort_before = sort_launches()
        dev_bwt, t_dev_bwt = timed(lambda: engine.bwt_encode(
            lz.copy(), features, device))
        block_sort = {k: v - sort_before[k]
                      for k, v in sort_launches().items()}
        if engine.DEVICE_ROUTES["bwt_encode"] != before + 1 or \
                block_sort["bwt_boot_keys"] != 1 or \
                block_sort["bwt_extract"] != 1:
            fail("the 25 MiB block did not take the device BWT route "
                 f"through K11-K14: {block_sort}")
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
              f"{mb / t_def_dec * 1e3:.2f} MB/s, K16 launches {k16} "
              f"({inverted} blocks inverted on the card); bwt stage on a "
              f"{len(lz)}-byte block: device {t_dev_bwt:.1f} ms, host "
              f"{t_host_bwt:.1f} ms; K11-K14 launches: the farm "
              f"{farm_sort}, the block {block_sort}; {card}", flush=True)

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
    out = {name: {"encode": enc[name], "decode": dec[name]} for name in V3}
    out.update({name: {"encode": 0, "decode": k16[name]} for name in k16})
    return out


def k16_launches(path: str) -> dict:
    """The K16 launches that decoding the default-format archive at path
    on the card must count: one table, gaps and write launch a block
    whose sorter input is 1 MiB or more, and ceil(log2 nodes) rounds of
    the ranking, nodes = ceil((n + 1) / 64) tiles + the start rows (the
    primary, and the aux indexes where the block has the format's count
    of them) + the sentinel."""
    from libbsc_tpu_torch import api
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import unbwt_rulers as K16

    want = dict.fromkeys(K16.LAUNCHES, 0)
    for _, _, block in _entries(path).values():
        st = api._decode_to_sorter(block, None)
        if isinstance(st, bytes):  # a stored block
            continue
        n = len(st["lz"])
        if st["sorter"] != C.BLOCKSORTER_BWT or n < 1 << 20:
            continue
        aux = st["num_indexes"] == (n - 1) // bwt.aux_rate(n)
        nodes = K16.tiles_of(n) + 1 + aux * st["num_indexes"] + 1
        for name in ("rulers_table", "rulers_gaps", "rulers_write"):
            want[name] += 1
        want["rulers_rank"] += (nodes - 1).bit_length()
    return want


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
    """Phase 9 (c): the LZP'd 25 MiB block through engine.bwt_encode on
    the card, by prefix quadrupling (TBSC_BWT unset) and by DC3
    (TBSC_BWT=dc3), in the turns prefix, dc3, dc3, prefix; U, primary and
    aux must equal the native BWT's, and DEVICE_ROUTES must count both
    routes.  TBSC_BWT is restored."""
    import torch

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine

    lz = engine.lzp_compress(np.frombuffer(data, np.uint8),
                             C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                             features)
    lz = np.frombuffer(data, np.uint8) if lz is None else lz
    ref = lz.copy()
    primary, ni, aux = engine.bwt_encode(ref, features)
    saved = os.environ.get("TBSC_BWT")
    ms = {"bwt_encode": [], "bwt_encode_dc3": []}
    peak, sorted_by = {}, {}
    before = dict(engine.DEVICE_ROUTES)
    try:
        for route in ("bwt_encode", "bwt_encode_dc3", "bwt_encode_dc3",
                      "bwt_encode"):
            if route == "bwt_encode_dc3":
                os.environ["TBSC_BWT"] = "dc3"
            else:
                os.environ.pop("TBSC_BWT", None)
            buf = lz.copy()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sort_before = sort_launches()
            got, t = timed(lambda: engine.bwt_encode(buf, features, device))
            peak[route] = torch.cuda.max_memory_allocated()
            sorted_by[route] = {k: v - sort_before[k]
                                for k, v in sort_launches().items()}
            if min(sorted_by[route].values()) == 0:
                fail(f"{route}: K11-K14 did not all launch: "
                     f"{sorted_by[route]}")
            ms[route].append(t)
            if got[:2] != (primary, ni) or not np.array_equal(
                    got[2][:ni], aux[:ni]) or not np.array_equal(buf, ref):
                fail(f"{route}: the device BWT differs from the native BWT")
    finally:
        if saved is None:
            os.environ.pop("TBSC_BWT", None)
        else:
            os.environ["TBSC_BWT"] = saved
    counted = {r: engine.DEVICE_ROUTES[r] - before[r] for r in ms}
    if counted != {"bwt_encode": 2, "bwt_encode_dc3": 2}:
        fail(f"DEVICE_ROUTES counted {counted}, not two calls of each")
    print(f"phase 9 dc3: a {len(lz)}-byte block, both routes equal to the "
          f"native BWT; prefix quadrupling "
          f"{', '.join(f'{t:.1f}' for t in ms['bwt_encode'])} ms, peak "
          f"{peak['bwt_encode']} B; dc3 "
          f"{', '.join(f'{t:.1f}' for t in ms['bwt_encode_dc3'])} ms, peak "
          f"{peak['bwt_encode_dc3']} B; routes counted {counted}; K11-K14 "
          f"launches {sorted_by}; {smi()}", flush=True)


# The CLI as __main__ under runpy, then whether it loaded the native
# runtime (stderr): phase 10 (b)'s processes show they did not.
NUMPY_CLI = (
    "import runpy, sys\n"
    "sys.argv = ['libbsc_tpu_torch.cli'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('libbsc_tpu_torch.cli', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "finally:\n"
    "    from libbsc_tpu_torch import native\n"
    "    print('native loaded:', native._lib is not None, file=sys.stderr)\n")
NUMPY_FILE = 128 * 1024      # phase 10 (b)'s file
RC_LANES, RC_BITS = 256, 1000  # phase 10 (d)'s lockstep range coder


def ops_engine(data: bytes, features: int, device, phase3: bytes) -> None:
    """Phase 10 (a): TBSC_ENGINE=ops (engine._force) on the 25 MiB block
    with the default config and no FEATURE_CUDA: DEVICE_ROUTES must count
    one bwt_encode and one bwt_decode, the decode K16's four kernels once
    each (and its ranking's rounds), the archive must equal the native
    engine's and come back; then -m9 -e4 under ops: K1-K3 must launch and
    the archive must equal phase 3's.  (K16, the list ranking and the
    native inverse are timed in phase 2, time_rulers.)"""
    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import unbwt_rulers as K16
    from libbsc_tpu_torch.ops import wide_kernels as WK

    feats = features & ~C.FEATURE_CUDA
    P.init(feats, device=device)
    want = P.compress(data)
    saved = engine._force
    try:
        engine._force = "ops"
        before = dict(engine.DEVICE_ROUTES)
        archive, t_enc = timed(lambda: P.compress(data))
        K16.reset_launches()
        back, t_dec = timed(lambda: P.decompress(archive))
        k16 = dict(K16.LAUNCHES)
        counted = {k: engine.DEVICE_ROUTES[k] - before[k]
                   for k in ("bwt_encode", "bwt_decode")}
        if counted != {"bwt_encode": 1, "bwt_decode": 1}:
            fail(f"ops: DEVICE_ROUTES counted {counted}")
        if [k16[k] for k in ("rulers_table", "rulers_gaps",
                             "rulers_write")] != [1, 1, 1] or \
                not k16["rulers_rank"]:
            fail(f"ops: the inverse BWT did not run K16 once: {k16}")
        if archive != want:
            fail("ops: the default-config archive differs from the native "
                 "engine's")
        if back != data:
            fail("ops: the default-config block did not come back")
        WK.reset_launches()
        kw = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                  coder=C.CODER_QLFC_WIDE)
        wide_archive, t9_enc = timed(lambda: P.compress(data, **kw))
        wide_back, t9_dec = timed(lambda: P.decompress(wide_archive))
        launches = dict(WK.LAUNCHES)
    finally:
        engine._force = saved
    if min(launches[k] for k in V3) == 0:
        fail(f"ops -m9 -e4: K1-K3 did not all launch: {launches}")
    if wide_archive != phase3:
        fail("ops -m9 -e4: the archive differs from phase 3's")
    if wide_back != data:
        fail("ops -m9 -e4: the block did not come back")
    mb = len(data) / 1e6
    print(f"phase 10 (a) ops default config: {len(data)} -> {len(archive)} "
          f"bytes, equal to the native engine's; encode "
          f"{mb / t_enc * 1e3:.2f} MB/s ({t_enc:.1f} ms), decode "
          f"{mb / t_dec * 1e3:.2f} MB/s ({t_dec:.1f} ms); routes {counted}; "
          f"K16 launches {k16}; ops -m9 -e4: phase 3's archive, encode "
          f"{t9_enc:.1f} ms, decode {t9_dec:.1f} ms, launches {launches}; "
          f"{smi()}", flush=True)


def numpy_engine(data: bytes, repo: str) -> None:
    """Phase 10 (b): TBSC_ENGINE=numpy through the CLI, as subprocesses,
    on a 128 KiB file with -e0, -e1, -e2, -m5 and -e4 (the encodes
    started together, then the decodes): each must exit 0 without
    loading the native runtime and restore the file, and each container
    entry must equal the native engine's archive's.  -e4 is the wide
    coder's Python reference, whose lanes are equal-sized, so its
    entries differ from the native codec's by design: its archive must
    decode through the native engine here instead."""
    import tempfile

    from libbsc_tpu_torch import cli

    configs = (["-e0"], ["-e1"], ["-e2"], ["-m5"], ["-e4"])
    env = dict(os.environ, PYTHONPATH=repo, TBSC_ENGINE="numpy")
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        with open(inp, "wb") as f:
            f.write(data)
        names = [f"c{i}" for i in range(len(configs))]
        want = {}
        for name, sw in zip(names, configs):
            arch = os.path.join(tmp, name + ".native")
            cli.compress_file(inp, arch, cli.parse_args(
                ["cli", "e", inp, arch, *sw]), quiet=True)
            want[name] = _entries(arch)
        secs = {}
        for step in ("e", "d"):
            procs = {}
            t0 = time.perf_counter()
            for name, sw in zip(names, configs):
                arch = os.path.join(tmp, name + ".numpy")
                args = ([inp, arch, *sw] if step == "e"
                        else [arch, os.path.join(tmp, name + ".back")])
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", NUMPY_CLI, step, *args],
                    cwd=repo, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=600)
                secs[name, step] = time.perf_counter() - t0
                if proc.returncode != 0:
                    fail(f"numpy cli {step} {name}: exit "
                         f"{proc.returncode}:\n{err[-2000:]}")
                if "native loaded: False" not in err:
                    fail(f"numpy cli {step} {name} loaded the native "
                         f"runtime:\n{err[-2000:]}")
        for name, sw in zip(names, configs):
            arch = os.path.join(tmp, name + ".numpy")
            if sw == ["-e4"]:
                back = os.path.join(tmp, name + ".native_back")
                cli.decompress_file(arch, back, cli.parse_args(
                    ["cli", "d", arch, back]), quiet=True)
                with open(back, "rb") as f:
                    if f.read() != data:
                        fail("numpy cli -e4: the native engine did not "
                             "decode the reference codec's archive")
            elif _entries(arch) != want[name]:
                fail(f"numpy cli {' '.join(sw)}: entries differ from the "
                     "native engine's")
            with open(os.path.join(tmp, name + ".back"), "rb") as f:
                if f.read() != data:
                    fail(f"numpy cli {' '.join(sw)}: the file did not "
                         "come back")
    print("phase 10 (b) numpy engine cli: " + "; ".join(
        f"{' '.join(sw)} e {secs[n, 'e']:.1f} s, d {secs[n, 'd']:.1f} s"
        for n, sw in zip(names, configs)) + f" (each step's processes run "
          f"together; seconds from the step's start), {len(data)} bytes, "
          f"entries equal to the native engine's (-e4: decoded by it), "
          f"native runtime not loaded; {smi()}", flush=True)


def encode_fast(data: bytes, features: int, device) -> None:
    """Phase 10 (c): bwt_encode_fast on the LZP'd 25 MiB block, equal to
    the native BWT, timed beside bwt_encode (turns: bwt_encode, fast,
    fast, bwt_encode)."""
    import torch

    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt

    lz = engine.lzp_compress(np.frombuffer(data, np.uint8),
                             C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                             features)
    lz = np.frombuffer(data, np.uint8).copy() if lz is None else lz
    ref = lz.copy()
    primary, ni, aux = engine.bwt_encode(ref, features)
    d = torch.from_numpy(lz.copy()).to(device)
    ms = {"bwt_encode": [], "bwt_encode_fast": []}
    for name in ("bwt_encode", "bwt_encode_fast", "bwt_encode_fast",
                 "bwt_encode"):
        (U, p, a), t = timed(lambda: getattr(bwt, name)(d))
        ms[name].append(t)
        if int(p) != primary or not np.array_equal(
                U.cpu().numpy(), ref) or not np.array_equal(
                a.cpu().numpy(), aux[:ni]):
            fail(f"{name} differs from the native BWT")
    print(f"phase 10 (c) bwt_encode_fast: a {len(lz)}-byte block, equal to "
          f"the native BWT; fast "
          f"{', '.join(f'{t:.1f}' for t in ms['bwt_encode_fast'])} ms, "
          f"bwt_encode {', '.join(f'{t:.1f}' for t in ms['bwt_encode'])} "
          f"ms; {smi()}", flush=True)
    sched_payloads(ref.tobytes(), device)


def sched_payloads(u: bytes, device) -> None:
    """Phase 10 (c): TBSC_WIDE_DEV_SCHED routes the per-stage
    wide_kernels.device_encode's bit schedule to the card
    (wide_schedule.device_schedule, the JAX package's v1): its planes and
    payload must equal the native walker's route on the BWT'd block.
    The variable is restored."""
    import torch

    from libbsc_tpu_torch.ops import wide_kernels as WK

    saved = os.environ.get("TBSC_WIDE_DEV_SCHED")
    try:
        os.environ.pop("TBSC_WIDE_DEV_SCHED", None)
        host, t_host = timed(lambda: WK._host_prep(u, device))
        want = WK.device_encode(u, device)
        os.environ["TBSC_WIDE_DEV_SCHED"] = "1"
        reset_scan_launches()
        dev, t_dev = timed(lambda: WK._host_prep(u, device))
        got = WK.device_encode(u, device)
        launched = scan_launches()
    finally:
        if saved is None:
            os.environ.pop("TBSC_WIDE_DEV_SCHED", None)
        else:
            os.environ["TBSC_WIDE_DEV_SCHED"] = saved
    if host is None or not isinstance(dev[0], torch.Tensor):
        fail("TBSC_WIDE_DEV_SCHED: the schedule did not run on the card")
    if not np.array_equal(dev[0].cpu().numpy(), host[0]) or \
            dev[2] != host[2] or got != want or want is None:
        fail("TBSC_WIDE_DEV_SCHED: planes or payload differ from the "
             "native walker's")
    if launched != {"unbwt_table": 0, "unbwt_chase": 0, "sched_events": 2,
                    "sched_planes": 2}:
        fail(f"TBSC_WIDE_DEV_SCHED: K9 and K10 did not launch once a "
             f"schedule: {launched}")
    print(f"phase 10 (c) device_schedule: TBSC_WIDE_DEV_SCHED planes and "
          f"payload equal to the native walker's ({host[2]} iterations; "
          f"K9 and K10 launched once a schedule); "
          f"schedule on the card {t_dev:.1f} ms, native lane table and "
          f"walker {t_host:.1f} ms; {smi()}", flush=True)


def lockstep_rc(device) -> None:
    """Phase 10 (d): ops/wide_rc on the card, RC_LANES lanes of RC_BITS
    bits: each lane's stream must equal the serial RcEncoder's, and the
    decode must return the bits."""
    from libbsc_tpu_torch.fallback.qlfc import RcEncoder
    from libbsc_tpu_torch.ops import wide_rc

    g = np.random.default_rng(0xAC)
    lanes = [[(int(b), int(p), int(q)) for b, p, q in zip(
        g.integers(0, 2, RC_BITS), g.integers(1, 2047, RC_BITS),
        g.choice([11, 12, 13], RC_BITS))] for _ in range(RC_LANES)]
    streams, t_enc = timed(lambda: wide_rc.encode(lanes, device=device))
    for seq, stream in zip(lanes, streams):
        rc = RcEncoder(1 << 20)
        for b, p, q in seq:
            rc.encode(b, p, q)
        if stream != rc.finish():
            fail("wide_rc: a lane's stream differs from RcEncoder's")
    probs = [[(p, q) for _, p, q in seq] for seq in lanes]
    bits, t_dec = timed(lambda: wide_rc.decode(probs, streams,
                                               device=device))
    if bits != [[b for b, _, _ in seq] for seq in lanes]:
        fail("wide_rc: the decode did not return the bits")
    print(f"phase 10 (d) wide_rc: {RC_LANES} lanes x {RC_BITS} bits on "
          f"{device}, every stream equal to RcEncoder's and decoded; "
          f"encode {t_enc:.1f} ms, decode {t_dec:.1f} ms; {smi()}",
          flush=True)


def _busy_share(events: list):
    """(device busy microseconds, the traced window's microseconds): the
    union of the kernel, copy and set intervals, and the span of every
    stage range (``tbsc::<stage>``), host op, runtime call and device
    interval in the trace (the profiler starts recording after its own
    start-up, at the first stage)."""
    dev = ("kernel", "gpu_memcpy", "gpu_memset")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in dev)
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    window = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") in dev + ("cpu_op", "cuda_runtime",
                                        "user_annotation")]
    return busy, max(t for _, t in window) - min(s for s, _ in window)


def traced(data: bytes, features: int, device) -> None:
    """Phase 10 (e): TBSC_TRACE over one -m9 -e4 -G compress and
    decompress of the 25 MiB block: the stage lines must print and sum to
    at most each call's wall time.  Then, untraced, with TBSC_PROFILE: the
    trace file must hold the CUDA kernels of K1-K3, and the device's busy
    share over the profiled window is printed."""
    import contextlib
    import io
    import tempfile

    import torch

    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.utils import trace

    P.init(features, device=device)
    kw = dict(block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
              coder=C.CODER_QLFC_WIDE)
    sums, walls, lines = {}, {}, {}
    saved = trace.TRACE, trace._PROFILE_DIR
    try:
        trace.TRACE = True
        for step in ("compress", "decompress"):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                if step == "compress":
                    archive, walls[step] = timed(lambda: P.compress(data,
                                                                    **kw))
                else:
                    back, walls[step] = timed(lambda: P.decompress(archive))
            lines[step] = [ln for ln in err.getvalue().splitlines()
                           if ln.startswith("[tbsc] ")]
            sums[step] = sum(float(ln.split()[3][:-1]) * 1e3
                             for ln in lines[step])
            if not lines[step] or sums[step] > walls[step]:
                fail(f"trace {step}: stage lines {lines[step]} sum to "
                     f"{sums[step]:.1f} ms of a {walls[step]:.1f} ms call")
        if back != data:
            fail("trace: the block did not come back")
        trace.TRACE = False
        with tempfile.TemporaryDirectory() as tmp:
            trace._PROFILE_DIR = tmp
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            archive2 = P.compress(data, **kw)
            back2 = P.decompress(archive2)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            path = trace.stop_profiler()
            size = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    finally:
        trace.TRACE, trace._PROFILE_DIR = saved
    if archive2 != archive or back2 != data:
        fail("profiled run: the archive differs or the block did not come "
             "back")
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    want = {"K1": "wide_model_kernel", "K2": "wide_rans_chain_kernel",
            "K3": "wide_chain_kernel"}
    missing = [k for k, sym in want.items()
               if not any(sym in name for name in kernels)]
    if missing:
        fail(f"the profiler trace holds no kernel of {missing}; kernel "
             f"names: {sorted(kernels)[:20]}")
    print("phase 10 (e) trace compress: " + "; ".join(
        ln[7:] for ln in lines["compress"]) + f" (sum {sums['compress']:.1f}"
          f" of {walls['compress']:.1f} ms)", flush=True)
    print("phase 10 (e) trace decompress: " + "; ".join(
        ln[7:] for ln in lines["decompress"]) + f" (sum "
          f"{sums['decompress']:.1f} of {walls['decompress']:.1f} ms)",
          flush=True)
    busy, window = _busy_share(events)
    print(f"phase 10 (e) profile: a {size}-byte trace with "
          f"{len(kernels)} kernel names, K1-K3 among them; device busy "
          f"{busy / 1e3:.1f} ms of the {window / 1e3:.1f} ms traced window "
          f"({busy / window * 100:.1f}%; the profiled compress + "
          f"decompress took {wall_us / 1e3:.1f} ms with the profiler's "
          f"start-up); {smi()}", flush=True)


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
    seconds = {}  # phase -> wall seconds, for the run-time line

    def lap(phase: str) -> None:
        seconds[phase] = time.perf_counter() - t0 - sum(seconds.values())

    lap("1")
    data = make_corpus(BLOCK)
    st = stages(data[:PLAIN_BLOCK], features, device)
    checked = check_kernels(st, device)
    checked.update(check_scan_all(st, data, device))
    checked.update(check_sort_all(st, data, device))
    del st
    check_hard_decode(data, device)
    check_hard_encode(data, device)
    checked.update(check_stats(data, device))
    st = stages(data, features, device)
    rows = time_kernels(st, device, clock_mhz)
    scan_rows = time_scan(st, device, clock_mhz)
    rulers_rows = time_rulers(st["lz"], features, device)
    sort_rows = time_sort(st, device)
    stats_rows = time_stats(data, device)
    screen_rows = time_lzp_screen(data, device)
    lap("2")
    composed = st["archive"]
    del st
    torch.cuda.empty_cache()
    launches, archive = main_path(data, features, composed[True], device,
                                  rans=True)
    breakdown(data, features, archive, device)
    host_split(repo)
    launches.update({k: v for k, v in main_path(
        data, features, composed[False], device, rans=False)[0].items()
        if k in V2})
    lap("3-4")
    corpus = make_corpus(MANY_BLOCKS * BLOCK)
    many([corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(MANY_BLOCKS)],
         device)
    lap("5")
    launches.update(transform_step(
        [corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(STEP_BLOCKS)],
        features, device))
    lap("6")
    st_device_path(data, features, device)
    lap("7")
    cli_launches = cli_path(corpus[:2 * BLOCK + CLI_TAIL], features, device,
                            repo)
    lap("8")
    t9 = time.perf_counter()
    sharded_st([corpus[i * BLOCK:(i + 1) * BLOCK] for i in range(2)],
               features, device)
    farm_launches = farm(corpus[:2 * BLOCK + CLI_TAIL], features, device,
                         repo)
    dc3(corpus[:BLOCK], features, device)
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)
    t10 = time.perf_counter()
    ops_engine(data, features, device, archive)
    numpy_engine(corpus[:NUMPY_FILE], repo)
    encode_fast(data, features, device)
    lockstep_rc(device)
    traced(data, features, device)
    print(f"phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    lap("9-10")
    print("run time (s): " + ", ".join(
        f"phase {k} {v:.1f}" for k, v in seconds.items())
        + f"; all {time.perf_counter() - t0:.1f}", flush=True)
    for r in rows:
        r.update(checked[r["name"]], launches=launches[r["name"]],
                 plain_at_bytes=PLAIN_BLOCK)
        if r["name"] in cli_launches:
            r["cli_launches"] = cli_launches[r["name"]]
            r["farm_launches"] = farm_launches[r["name"]]
    for r in stats_rows + scan_rows + sort_rows:
        r.update(checked[r["name"]], launches=launches[r["name"]])
    for r in screen_rows:
        r.update(launches=launches[r["name"]])
    for r in rulers_rows:  # the main path that runs K16: phase 8's -G d
        r.update(launches=cli_launches[r["name"]]["decode"],
                 cli_launches=cli_launches[r["name"]])
    print(json.dumps({"kernels": rows + stats_rows + scan_rows + sort_rows
                      + screen_rows + rulers_rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
