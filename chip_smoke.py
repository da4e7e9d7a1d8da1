#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py            # one CUDA card, about seven minutes

Phases, one line each:
  1. build: the CUDA kernels (one nvcc per csrc/*.cu, all started together)
     and the native host runtime, with the card's name and power limit;
  2. kernels against their plain PyTorch versions, on the inputs the main
     path gives them: one 25 MiB block (bsc's default -b25) of the corpus
     through the port's own stages (native LZP, device wide-aux BWT, device
     lane table and bit schedule).  K1's probability plane, K2's payload
     (also against the native codec with the same lane table) and K3's
     decoded block must be exactly equal (tolerance 0: a lossless codec);
     each kernel is timed with CUDA events, its plain version by the wall
     clock;
  3. the main path: the same block through api.compress and
     api.decompress with -m9 -e4 -G, launch counters set to 0 just before
     and read just after.  Every kernel must have launched; the archive
     must equal the one composed from the phase-2 stages and the native
     wide encode; both the device decode and the native host decode must
     restore the input.  Then each stage of the fused route is timed
     once, stage by stage, for the breakdown; the archive those stages
     compose must equal the main path's, so the breakdown cannot drift
     from the code it times.

The script prints a JSON line of per-kernel numbers, the nvidia-smi line,
and, last, {"ok": true, "device": ...} only when every phase passed.  It
exits non-zero without CUDA or outside a checkout of the repository.

Each kernel's bound_ms is the larger of its bytes (each input read once,
each output written once; for K1 and K2 the max_bits rows of planes and
probabilities the kernels touch) over 3.35 TB/s and its operations (one
per coded bit, a floor) over 67 TFLOP/s, the H100 SXM's device-memory rate
and peak outside the tensor cores.  The phase-2 lines also print a
serial-chain reckoning: max_bits dependent steps per lane at one dependent
integer instruction (4 cycles) each, at the card's maximum SM clock.  It
is a model of a floor, not a measurement: a real step is dozens of
dependent instructions.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
NONTENSOR_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores
STEP_CYCLES = 4              # latency of one dependent integer instruction
BLOCK_MB = 25
TIMED_LAUNCHES = 5


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
    and the -m9 -e4 archive composed from them with the native wide
    encode."""
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
    native = wide.wide_encode(u_host.tobytes(), n_lanes=WK.LANES,
                              sizes=sizes, rans=True)
    archive = compose(data, lzp, int(primary), aux.cpu().numpy(), native)
    return {"U": u_host, "planes": planes, "sizes": sizes,
            "max_bits": max_bits, "native": native, "archive": archive}


def check_kernels(st: dict, device, clock_mhz: float) -> list:
    """Phase 2: each kernel against its plain version on the main path's
    inputs for this block."""
    import torch

    from libbsc_tpu_torch.ops import wide_kernels as WK

    planes, sizes, max_bits = st["planes"], st["sizes"], st["max_bits"]
    U = st["U"]
    n = len(U)
    coded = int(sum(((planes >> s) & 2).ne(0).sum() for s in (0, 2, 4, 6)))
    chain = max_bits * STEP_CYCLES / (clock_mhz * 1e3)
    # the bytes K1 and K2 touch: max_bits rows of probabilities and the
    # plane rows that hold them, not the bucketed planes' padding
    plane_bytes = -(-max_bits // 4) * WK.LANES
    prob_bytes = 4 * max_bits * WK.LANES
    rows = []

    def row(name, err, ms, plain, nbytes):
        b, by = bound_ms(nbytes, coded)
        rows.append({"name": name, "route": "cuda",
                     "source": f"libbsc_tpu_torch/csrc/{name}.cu",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": None,
                     "iters": max_bits, "coded_bits": coded})

    # K1: the probability plane
    probs = WK.model_probs(planes, max_bits)
    probs_p, plain1 = timed(lambda: WK.model_probs_plain(planes, max_bits))
    err1 = int((probs.long() - probs_p.long()).abs().max())
    del probs_p
    ms1 = cuda_ms(lambda: WK.model_probs(planes, max_bits), TIMED_LAUNCHES)
    row("wide_model", err1, ms1, plain1, plane_bytes + prob_bytes + 4 * 281)
    rows[-1]["replaces"] = "libbsc_tpu/ops/wide_kernels.py:546"

    # K2: units, counts and final states; the payload against the plain
    # version's and the native codec's with the same lane table
    units, counts, fx = WK.rans_encode(planes, probs, max_bits)
    cap = int(units.shape[1])
    plain, plain2 = timed(
        lambda: WK.rans_encode_plain(planes, probs, max_bits, cap))
    pay_k = WK._assemble_rans(n, units, counts, fx, sizes, max_bits)
    pay_p = WK._assemble_rans(n, *plain, sizes, max_bits)
    if pay_k is None or pay_k != pay_p or pay_k != st["native"]:
        fail("K2 payload differs from its plain version or the native codec")
    err2 = max(int((counts.long() - plain[1].long()).abs().max()),
               int((fx.long() - plain[2].long()).abs().max()))
    del plain
    ms2 = cuda_ms(lambda: WK.rans_encode(planes, probs, max_bits),
                  TIMED_LAUNCHES)
    n_units = int(counts.long().sum())
    row("wide_rans", err2, ms2, plain2,
        plane_bytes + prob_bytes + 4 * n_units + 4 * 8 + 4 * WK.LANES)
    rows[-1]["replaces"] = "libbsc_tpu/ops/wide_kernels.py:749"
    del probs, units

    # K3: decode the payload back to the block
    p = WK._dec_parse(pay_k)
    if p is None:
        fail("the payload does not take the kernel decode")
    args = WK._dec_args(p, device)
    out_k = WK.decode_lanes(*args)
    out_p, plain3 = timed(lambda: WK.decode_lanes_plain(*args))
    err3 = int((out_k.long() - out_p.long()).abs().max())
    if err3 or out_k.cpu().numpy().tobytes() != U.tobytes():
        fail("K3 output differs from its plain version or the input")
    ms3 = cuda_ms(lambda: WK.decode_lanes(*args), TIMED_LAUNCHES)
    row("wide_decode", err3, ms3, plain3,
        4 * int(p["gunits"].sum()) + 16 * WK.LANES + 4 * 281 + n)
    rows[-1]["replaces"] = "libbsc_tpu/ops/wide_kernels.py:1729"

    if err1 or err2:
        fail(f"kernel differs from its plain version: K1 {err1}, K2 {err2}")
    for r in rows:
        print(f"phase 2 {r['name']}: equal to plain, {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms"
              f" by {r['bound_by']}), {max_bits} iterations, {coded} coded "
              f"bits, {n} bytes; serial-chain reckoning {chain:.4f} ms "
              f"(one 4-cycle step per iteration, a model, not measured)",
              flush=True)
    return rows


def main_path(data: bytes, features: int, composed: bytes, device):
    """Phase 3: the -m9 -e4 -G main path on one block."""
    import torch

    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.ops import wide_kernels as WK

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
    if back != data:
        fail("the device decode did not restore the input")
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    if archive != composed:
        fail("the archive differs from the one composed from the stages")
    P.init(features & ~C.FEATURE_CUDA, device=device)
    if P.decompress(archive) != data:
        fail("the native host decode did not restore the input")
    mb = len(data) / 1e6
    print(f"phase 3 main path: {len(data)} -> {len(archive)} bytes, encode "
          f"{mb / t_enc * 1e3:.2f} MB/s ({t_enc:.1f} ms), decode "
          f"{mb / t_dec * 1e3:.2f} MB/s ({t_dec:.1f} ms), peak device "
          f"memory {peak} B, launches {launches}", flush=True)
    return launches, archive


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
    data = make_corpus(BLOCK_MB << 20)
    st = stages(data, features, device)
    rows = check_kernels(st, device, clock_mhz)
    composed = st["archive"]
    del st
    torch.cuda.empty_cache()
    launches, archive = main_path(data, features, composed, device)
    breakdown(data, features, archive, device)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
