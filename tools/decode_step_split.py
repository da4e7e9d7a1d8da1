#!/usr/bin/env python3
"""Where a step of the wide decoder's per-lane chain goes, on the card.

Takes a ``wide_decode.cu`` of the single-kernel design (up to commit
91338da: one block of 128 lanes per group, two barriers a step, units
loaded from device memory, move-to-front and run writing inline), adds
``clock64()`` counters to a copy of it, builds the copy with nvcc and runs
it on one 25 MiB block's own decode inputs (``chip_smoke.py``'s phase-2
time inputs, v3 and v2).  Lane 0 of every warp sums, over the iterations
of its warp, the cycles of each part of the step, read where the warp is
converged:

    barrier   __syncthreads_or (the stop test) and the __syncthreads
              before the unit prefix, the ballot and count store included
    model     context, model load, bit, model update
    fetch     the unit prefix and the renormalising lanes' device-memory
              load, up to the point where the new state is in a register
    sm        sm_next
    mtf       the symbol lookup and the move-to-front loop
    store     the run's byte stores

and prints cycles per iteration of each part (the mean over the 32 warps)
beside the kernel's time with and without the counters (CUDA events).

Given the two-kernel design (a chain kernel writing run records, an
expand kernel replaying them; the source holds ``wide_chain_kernel``) it
splits the chain kernel's step into

    bit       the bit step and the model update, including the wait for
              the previous step's model and table loads
    sm        the table transition and the record store
    publish   the ballots, the count store, the next context and the issue
              of its model and table loads
    barrier   the __syncthreads
    unit      the unit prefix and the ring read, up to the new state
    refill    the stop test and the ring refill

and times the expand kernel alone.

    git archive 91338da libbsc_tpu_torch/csrc | tar -x -C _archive/parent
    python3 tools/decode_step_split.py _archive/parent/libbsc_tpu_torch/csrc

Needs a CUDA card and nvcc; writes its build and a JSON of the split into
libbsc_tpu_torch/_build/decode_step_split/ and prints the JSON last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PARTS = ("barrier", "model", "fetch", "sm", "mtf", "store")
PARTS2 = ("bit", "sm", "publish", "barrier", "unit", "refill")

# (anchor in the single-kernel wide_decode.cu, its replacement); each
# anchor must occur exactly once
PATCHES = [
    ("namespace {\n\nconstexpr int kModelBytes",
     "__device__ unsigned long long g_clk[32][8];\n\n"
     "namespace {\n\nconstexpr int kModelBytes"),
    ("  for (int i = 0; i < iters; ++i) {\n",
     "  unsigned long long acc[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  long long c0 = 0, c1 = 0;\n"
     "  unsigned long long n_it = 0;\n"
     "  for (int i = 0; i < iters; ++i) {\n"),
    ("    if (!__syncthreads_or(active)) break;\n",
     "    c0 = clock64();\n"
     "    if (!__syncthreads_or(active)) break;\n"
     "    c1 = clock64(); acc[0] += c1 - c0; c0 = c1; ++n_it;\n"),
    ("    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);\n",
     "    __syncwarp(); c1 = clock64(); acc[1] += c1 - c0; c0 = c1;\n"
     "    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);\n"),
    ("    __syncthreads();\n",
     "    __syncthreads();\n"
     "    c1 = clock64(); acc[0] += c1 - c0; c0 = c1;\n"),
    ("    cursor += n_ren;\n    if (active) {\n      int run = sm_next(s, bit);\n"
     "      if (run) {\n",
     "    asm volatile(\"\" :: \"r\"(x) : \"memory\");\n"
     "    __syncwarp(); c1 = clock64(); acc[2] += c1 - c0; c0 = c1;\n"
     "    cursor += n_ren;\n"
     "    int run = active ? sm_next(s, bit) : 0;\n"
     "    uint8_t sym = 0;\n"
     "    __syncwarp(); c1 = clock64(); acc[3] += c1 - c0; c0 = c1;\n"
     "    if (active) {\n"
     "      if (run) {\n"),
    ("        const uint8_t sym = mtf[r * kGroup + tid];\n",
     "        sym = mtf[r * kGroup + tid];\n"),
    ("        mtf[tid] = sym;\n",
     "        mtf[tid] = sym;\n"
     "      }\n"
     "    }\n"
     "    __syncwarp(); c1 = clock64(); acc[4] += c1 - c0; c0 = c1;\n"
     "    if (active) {\n"
     "      if (run) {\n"),
    ("        if (left <= 0) s.phase = kDone;\n      }\n    }\n  }\n}\n",
     "        if (left <= 0) s.phase = kDone;\n      }\n    }\n"
     "    __syncwarp(); c1 = clock64(); acc[5] += c1 - c0;\n"
     "  }\n"
     "  if ((tid & 31) == 0) {\n"
     "    for (int k = 0; k < 6; ++k) g_clk[g * 4 + warp][k] = acc[k];\n"
     "    g_clk[g * 4 + warp][7] = n_it;\n"
     "  }\n"
     "}\n"),
]

# the same for the two-kernel design
PATCHES2 = [
    ("namespace {\n\nconstexpr int kRing",
     "__device__ unsigned long long g_clk[32][8];\n\n"
     "namespace {\n\nconstexpr int kRing"),
    ("  for (int i = 0; i < iters; ++i) {\n",
     "  unsigned long long acc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long t0 = 0, t1 = 0;\n"
     "  unsigned long long n_it = 0;\n"
     "  for (int i = 0; i < iters; ++i) {\n"
     "    t0 = clock64(); ++n_it;\n"),
    ("    int run = table_next(s, e, bit);",
     "    __syncwarp(); t1 = clock64(); acc[0] += t1 - t0; t0 = t1;\n"
     "    int run = table_next(s, e, bit);"),
    ("    const unsigned mask = __ballot_sync(kFull, ren);\n",
     "    __syncwarp(); t1 = clock64(); acc[1] += t1 - t0; t0 = t1;\n"
     "    const unsigned mask = __ballot_sync(kFull, ren);\n"),
    ("    __syncthreads();\n\n    const int4 v = info[i & 1];\n",
     "    __syncwarp(); t1 = clock64(); acc[2] += t1 - t0; t0 = t1;\n"
     "    __syncthreads();\n"
     "    t1 = clock64(); acc[3] += t1 - t0; t0 = t1;\n\n"
     "    const int4 v = info[i & 1];\n"),
    ("    cursor += c0 + c1 + c2 + c3;\n",
     "    asm volatile(\"\" :: \"r\"(x) : \"memory\");\n"
     "    __syncwarp(); t1 = clock64(); acc[4] += t1 - t0; t0 = t1;\n"
     "    cursor += c0 + c1 + c2 + c3;\n"),
    ("    if (!((v.x | v.y | v.z | v.w) & 256)) break;\n",
     "    if (!((v.x | v.y | v.z | v.w) & 256)) {\n"
     "      t1 = clock64(); acc[5] += t1 - t0;\n"
     "      break;\n"
     "    }\n"),
    ("      asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
     "    }\n  }\n",
     "      asm volatile(\"cp.async.wait_group 1;\\n\" ::: \"memory\");\n"
     "    }\n"
     "    __syncwarp(); t1 = clock64(); acc[5] += t1 - t0;\n"
     "  }\n"),
    ("  nrec[lane] = n_out;\n}\n",
     "  nrec[lane] = n_out;\n"
     "  if ((tid & 31) == 0) {\n"
     "    for (int k = 0; k < 6; ++k) g_clk[g * 4 + warp][k] = acc[k];\n"
     "    g_clk[g * 4 + warp][7] = n_it;\n"
     "  }\n"
     "}\n"),
]

EXPAND_ONLY = """
extern "C" int expand_only(const int* rec, const int* nrec,
                           const int* lstart, uint8_t* out, void* stream) {
  wide_expand_kernel<<<kLanes / 4, 128, 0, (cudaStream_t)stream>>>(
      rec, nrec, lstart, out);
  return (int)cudaGetLastError();
}
"""

TAIL = """
extern "C" int clk_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));
}
"""


def instrument(src: str) -> str:
    for old, new in PATCHES2 if "wide_chain_kernel" in src else PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found exactly once: {old!r}")
        src = src.replace(old, new)
    return src + TAIL


def nvcc(src: Path, inc: Path, out: Path) -> None:
    cmd = ["/usr/local/cuda/bin/nvcc" if os.path.exists(
        "/usr/local/cuda/bin/nvcc") else "nvcc", "-gencode",
        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(inc), "-o",
        str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print(res.stdout + res.stderr, flush=True)
    if res.returncode:
        raise SystemExit("nvcc failed")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    csrc = Path(sys.argv[1] if len(sys.argv) > 1 else
                ROOT / "libbsc_tpu_torch" / "csrc")
    out_dir = ROOT / "libbsc_tpu_torch" / "_build" / "decode_step_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    plain_src = (csrc / "wide_decode.cu").read_text()
    two = "wide_chain_kernel" in plain_src
    parts = PARTS2 if two else PARTS
    (out_dir / "wide_decode_clock.cu").write_text(instrument(plain_src))
    (out_dir / "wide_decode_plain.cu").write_text(
        plain_src + (EXPAND_ONLY if two else ""))
    libs = {}
    for name in ("clock", "plain"):
        so = out_dir / f"lib{name}.so"
        nvcc(out_dir / f"wide_decode_{name}.cu", csrc, so)
        libs[name] = ctypes.CDLL(str(so))

    import chip_smoke as CS
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import native
    from libbsc_tpu_torch.ops import wide_kernels as WK

    native.load()
    dev = torch.device("cuda", 0)
    card = CS.smi()
    clock_mhz = float(CS.smi("clocks.max.sm").split()[0])
    features = C.FEATURE_FASTMODE | C.FEATURE_MULTITHREADING | C.FEATURE_CUDA
    data = CS.make_corpus(CS.BLOCK)
    st = CS.stages(data, features, dev)
    enc = CS.encode_payloads(st)
    VP, I = ctypes.c_void_p, ctypes.c_int
    result = {"card": card, "max_sm_clock_mhz": clock_mhz}
    for rans, enc_name, sym in ((True, "wide_rans", "wide_decode_launch"),
                                (False, "wide_rc_encode",
                                 "wide_decode_v2_launch")):
        p = WK._dec_parse(enc[enc_name][1])
        warm, goff, lane_sz, lstart, stream, max_bits, n = \
            WK._dec_args(p, dev)
        pri = WK.priors_tensor(dev)
        handle = torch.cuda.current_stream(dev).cuda_stream
        if two:  # u16 stream, table, record scratch
            tab = WK.sm_table_tensor(dev)
            rec = torch.empty(n, dtype=torch.int32, device=dev)
            nrec = torch.empty(WK.LANES, dtype=torch.int32, device=dev)
            ptrs = [warm, goff, lane_sz, lstart, stream, int(stream.shape[1]),
                    max_bits, pri, tab, rec, nrec]
        else:  # the single-kernel layout: int32 [8, S] holding u16 values
            stream = (stream.to(torch.int32) & 0xFFFF).contiguous()
            ptrs = [warm, goff, lane_sz, lstart, stream, int(stream.shape[1]),
                    max_bits, pri]
        ptrs = [a if isinstance(a, int) else a.data_ptr() for a in ptrs]
        row = {}
        for name, lib in libs.items():
            fn = getattr(lib, sym)
            fn.restype = I
            fn.argtypes = [VP] * 5 + [I, I] + [VP] * (len(ptrs) - 5)
            out = torch.empty(n, dtype=torch.uint8, device=dev)

            def call():
                rc = fn(*ptrs, out.data_ptr(), handle)
                if rc:
                    raise SystemExit(f"launch failed: cudaError_t {rc}")

            row[f"{name}_ms"] = CS.cuda_ms(call, 3)
            if out.cpu().numpy().tobytes() != st["U"].tobytes():
                raise SystemExit(f"{name} {sym}: decoded block differs")
        if two:
            exp = libs["plain"].expand_only
            exp.restype = I
            exp.argtypes = [VP] * 5

            def expand():
                rc = exp(rec.data_ptr(), nrec.data_ptr(), lstart.data_ptr(),
                         out.data_ptr(), handle)
                if rc:
                    raise SystemExit(f"expand failed: cudaError_t {rc}")

            row["expand_ms"] = CS.cuda_ms(expand, 3)
            row["records"] = int(nrec.long().sum())
        clk = np.zeros((32, 8), dtype=np.uint64)
        rc = libs["clock"].clk_read(clk.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise SystemExit(f"clk_read failed: {rc}")
        iters = clk[:, 7].astype(np.float64)
        per = clk[:, :len(parts)].astype(np.float64) / iters[:, None]
        mean = per.mean(axis=0)
        row.update({"iterations": max_bits, "warp_iterations_min":
                    int(iters.min()), "warp_iterations_max": int(iters.max()),
                    "cycles_per_iteration": dict(zip(parts, mean.tolist())),
                    "cycles_per_iteration_total": float(mean.sum()),
                    "cycles_per_iteration_from_ms":
                        row["plain_ms"] * clock_mhz * 1e3 / max_bits,
                    "per_warp_max": dict(zip(parts,
                                             per.max(axis=0).tolist()))})
        result["v3" if rans else "v2"] = row
        print(f"{'K3 v3' if rans else 'K4 v2'}: {row['plain_ms']:.3f} ms "
              f"({row['clock_ms']:.3f} with counters), {max_bits} iterations"
              f", {row['cycles_per_iteration_from_ms']:.0f} cycles an "
              f"iteration at {clock_mhz:.0f} MHz; counted "
              f"{row['cycles_per_iteration_total']:.0f}: " + ", ".join(
                  f"{k} {v:.0f}" for k, v in zip(parts, mean))
              + (f"; expand kernel {row['expand_ms']:.3f} ms for "
                 f"{row['records']} records" if two else ""), flush=True)
    (out_dir / "split.json").write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
