#!/usr/bin/env python3
"""Where a step of the wide encoder's forward kernels goes, on the card.

For each given ``csrc`` directory, takes its ``wide_model.cu`` (K1, the v3
model pass), ``wide_rc_encode.cu`` (K5, the v2 range encode) and
``wide_rans.cu`` (K2, the v3 rANS pass; ``--kernels=`` picks some), adds
``clock64()`` counters to a copy of each, builds the copies with nvcc and
runs them on one 25 MiB block's own encode inputs (``chip_smoke.py``'s
phase-2 time inputs: the port's device wide-aux BWT, device lane table and
bit schedule).  Lane 0 of every warp sums, over the steps of its warp, the
cycles of each part, read where the warp is converged (``__syncwarp``
before each ``clock64()``, as tools/decode_step_split.py does), and the
tool prints cycles per step of each part (the mean over the warps) beside
the kernel's time with and without the counters (CUDA events, the mean of
three launches after a warm-up).

The switch-form design (up to commit 486c5c2: one warp per lane group, the
state machine's switch, the plane byte from device memory) splits a step
into

    fetch     the plane byte, a device-memory load every fourth step
    model     the context, the model load, the adaptation and the store
    sm        sm_next
    coder     K5: the range-coder step, renormalisation and clamp
    barrier   K5: the ballot, the count store, the __syncthreads and the
              prefix of the four warp counts
    store     K1: the probability store; K5: the unit store and the slots

The design of wide_encode_step.cuh (state warps ahead of model warps) is
split per kind of warp.  State warps:

    fetch     the staging turn (every 16 rows) and the plane byte
    sm        a row's four table loads, contexts and transitions
    store     its four word stores
    barrier   the wait for a free chunk slot and the hand-over

and model warps:

    fetch     the wait for a chunk and its words into registers
    model     the adaptation, the next step's model load and the store
              (the wait for that load lands where p is next used: the
              model part in K1, the coder part in K5)
    coder     K5: the range-coder step, renormalisation and clamp
    barrier   K5: the ballot and its count, and the barrier a chunk
    store     K1: the probability store; K5: the slot pass (the prefix of
              each step's four counts, the unit stores and the slots)

K2 up to commit fcee879 (one block of 128 threads per group, the plane
byte and the probability from device memory, a native divide, a
__syncthreads a step) splits a step into

    plane     the plane byte
    prob      the probability, a second device-memory load
    division  the renormalisation and the u32 divide and modulo
    ballot    the ballot and the warp's count store
    barrier   the __syncthreads
    store     the prefix of the four warp counts and the unit store

and its chain design (csrc/wide_rans.cu: a warp a block, a ring staged by
cp.async, a quotient table) a chunk of 32 steps, per step, into

    wait      the wait for the chunk's rows and the next chunk's copies
    stage     the chunk's loads from the ring and the table
    walk      the 32 steps: renormalisation, quotient, unit store, ballot
    chunk     the ballot word's store and the warp's emission count

(the placement kernel is in the time, not in the counts).

Every variant's output is held against the native codec: K1's plane
through the checkout's K2, and K2's units over the checkout's K1 plane,
must give the native v3 payload, K5's units the native v2 payload.

    git archive fcee879 libbsc_tpu_torch/csrc | tar -x -C _archive/parent
    python3 tools/encode_step_split.py _archive/parent/libbsc_tpu_torch/csrc \\
        libbsc_tpu_torch/csrc

With no argument it splits the checkout's own csrc; a kernel whose source
the counters' anchors do not fit is timed only.  Needs a CUDA card and nvcc;
writes its builds and a JSON of the splits into
libbsc_tpu_torch/_build/encode_step_split/ and prints the JSON last.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.decode_step_split import nvcc  # noqa: E402

PARTS = ("fetch", "model", "sm", "coder", "barrier", "store")
MAX_WARPS = 64  # 8 blocks of up to 8 warps

PRELUDE = """
__device__ unsigned long long g_clk[64][8];
#define SPLIT_MARK(k)                \\
  do {                               \\
    __syncwarp();                    \\
    const long long t1_ = clock64(); \\
    acc_[k] += t1_ - t0_;            \\
    t0_ = t1_;                       \\
  } while (0)
#define SPLIT_BEGIN                                \\
  unsigned long long acc_[6] = {0, 0, 0, 0, 0, 0}; \\
  unsigned long long n_it_ = 0;                    \\
  long long t0_ = clock64()
#define SPLIT_END                                                   \\
  if ((threadIdx.x & 31) == 0) {                                    \\
    const int w_ = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); \\
    for (int k_ = 0; k_ < 6; ++k_) g_clk[w_][k_] = acc_[k_];        \\
    g_clk[w_][7] = n_it_;                                           \\
  }
"""

TAIL = """
extern "C" int clk_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(g_clk));
}
"""

# (anchor, replacement) pairs; each anchor must occur exactly once.  The
# switch-form design: one loop per kernel, the plane byte loaded from
# device memory every fourth step.
SWITCH_K1 = [
    ("  int packed = 0;\n  for (int i = 0; i < iters; ++i) {\n"
     "    if ((i & 3) == 0) packed = planes[(size_t)(i >> 2) * kLanes + lane];\n"
     "    const int fld = (packed >> ((i & 3) * 2)) & 3;\n"
     "    int p = 0;\n"
     "    if (fld & 2) {\n"
     "      const int bit = fld & 1;\n"
     "      uint16_t* m = &model[sm_ctx(s) * kGroup + tid];\n"
     "      p = *m;\n"
     "      *m = (uint16_t)adapt(p, bit);\n"
     "      sm_next(s, bit);\n"
     "    }\n"
     "    probs[(size_t)i * kLanes + lane] = p;\n"
     "  }\n}\n",
     "  int packed = 0;\n  SPLIT_BEGIN;\n"
     "  for (int i = 0; i < iters; ++i) {\n"
     "    ++n_it_;\n"
     "    if ((i & 3) == 0) packed = planes[(size_t)(i >> 2) * kLanes + lane];\n"
     "    const int fld = (packed >> ((i & 3) * 2)) & 3;\n"
     "    asm volatile(\"\" :: \"r\"(fld) : \"memory\");\n"
     "    SPLIT_MARK(0);\n"
     "    int p = 0;\n"
     "    const int bit = fld & 1;\n"
     "    if (fld & 2) {\n"
     "      uint16_t* m = &model[sm_ctx(s) * kGroup + tid];\n"
     "      p = *m;\n"
     "      *m = (uint16_t)adapt(p, bit);\n"
     "    }\n"
     "    asm volatile(\"\" :: \"r\"(p) : \"memory\");\n"
     "    SPLIT_MARK(1);\n"
     "    if (fld & 2) sm_next(s, bit);\n"
     "    SPLIT_MARK(2);\n"
     "    probs[(size_t)i * kLanes + lane] = p;\n"
     "    SPLIT_MARK(5);\n"
     "  }\n  SPLIT_END\n}\n"),
]

SWITCH_K5 = [
    ("  for (int i = 0; i < iters; ++i) {\n"
     "    if ((i & 3) == 0) packed = planes[(size_t)(i >> 2) * kLanes + lane];\n"
     "    const int fld = (packed >> ((i & 3) * 2)) & 3;\n"
     "    bool ren = false;\n"
     "    uint32_t unit = 0;\n"
     "    if (fld & 2) {\n"
     "      const int bit = fld & 1;\n"
     "      uint16_t* mp = &model[sm_ctx(s) * kGroup + tid];\n"
     "      const uint32_t p = *mp;\n"
     "      *mp = (uint16_t)adapt(p, bit);\n"
     "      sm_next(s, bit);\n"
     "      const uint32_t r = (rng >> 12) * p;\n",
     "  SPLIT_BEGIN;\n"
     "  for (int i = 0; i < iters; ++i) {\n"
     "    ++n_it_;\n"
     "    if ((i & 3) == 0) packed = planes[(size_t)(i >> 2) * kLanes + lane];\n"
     "    const int fld = (packed >> ((i & 3) * 2)) & 3;\n"
     "    asm volatile(\"\" :: \"r\"(fld) : \"memory\");\n"
     "    SPLIT_MARK(0);\n"
     "    bool ren = false;\n"
     "    uint32_t unit = 0;\n"
     "    const int bit = fld & 1;\n"
     "    uint32_t p = 0;\n"
     "    if (fld & 2) {\n"
     "      uint16_t* mp = &model[sm_ctx(s) * kGroup + tid];\n"
     "      p = *mp;\n"
     "      *mp = (uint16_t)adapt(p, bit);\n"
     "    }\n"
     "    asm volatile(\"\" :: \"r\"(p) : \"memory\");\n"
     "    SPLIT_MARK(1);\n"
     "    if (fld & 2) sm_next(s, bit);\n"
     "    SPLIT_MARK(2);\n"
     "    if (fld & 2) {\n"
     "      const uint32_t r = (rng >> 12) * p;\n"),
    ("    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);\n"
     "    int* wc = warp_cnt[i & 1];\n",
     "    asm volatile(\"\" :: \"r\"(rng), \"r\"(low) : \"memory\");\n"
     "    SPLIT_MARK(3);\n"
     "    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);\n"
     "    int* wc = warp_cnt[i & 1];\n"),
    ("    group_prefix(wc, warp, before, m);\n    if (ren) {\n",
     "    group_prefix(wc, warp, before, m);\n"
     "    asm volatile(\"\" :: \"r\"(before), \"r\"(m) : \"memory\");\n"
     "    SPLIT_MARK(4);\n"
     "    if (ren) {\n"),
    ("    cursor += m;\n  }\n",
     "    cursor += m;\n    SPLIT_MARK(5);\n  }\n  SPLIT_END\n"),
]

# The state-warp design: the state warps' loop is in wide_encode_step.cuh
# (counted per plane row, four steps), the model warps' in each kernel.
WARPS_HEADER = [
    ("  uint2 ab;           // the current step's half entry: (A, B) for its"
     " bit\n",
     "  uint2 ab;           // the current step's half entry: (A, B) for its"
     " bit\n  SPLIT_BEGIN;\n"),
    ("    if (c >= kCtxChunks) bar_sync(kBarEmpty + k, kThreads);\n",
     "    if (c >= kCtxChunks) bar_sync(kBarEmpty + k, kThreads);\n"
     "    SPLIT_MARK(4);\n"),
    ("      const uint32_t next = m.ring[((r + 1) & (kRingRows - 1)) * kGroup"
     " + t];\n",
     "      const uint32_t next = m.ring[((r + 1) & (kRingRows - 1)) * kGroup"
     " + t];\n"
     "      asm volatile(\"\" :: \"r\"(next), \"r\"(byte) : \"memory\");\n"
     "      SPLIT_MARK(0);\n"),
    ("#pragma unroll\n      for (int j = 0; j < 4; ++j)\n"
     "        dst[(4 * rr + j) * kGroup] = (uint16_t)word[j];\n",
     "      n_it_ += 4;\n"
     "      SPLIT_MARK(2);\n"
     "#pragma unroll\n      for (int j = 0; j < 4; ++j)\n"
     "        dst[(4 * rr + j) * kGroup] = (uint16_t)word[j];\n"
     "      SPLIT_MARK(5);\n"),
    ("    bar_arrive(kBarFull + k, kThreads);\n  }\n"
     "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n",
     "    bar_arrive(kBarFull + k, kThreads);\n    SPLIT_MARK(4);\n  }\n"
     "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
     "  SPLIT_END\n"),
]

WARPS_TAKE = [
    ("  for (int c = 0; c < nchunks; ++c) {\n    uint32_t wv[kSteps];\n"
     "    take_chunk(m, c, nchunks, lane, wv);\n",
     "  SPLIT_BEGIN;\n"
     "  for (int c = 0; c < nchunks; ++c) {\n    uint32_t wv[kSteps];\n"
     "    take_chunk(m, c, nchunks, lane, wv);\n"
     "    asm volatile(\"\" :: \"r\"(wv[kSteps - 1]) : \"memory\");\n"
     "    SPLIT_MARK(0);\n"),
]

WARPS_K1 = WARPS_TAKE + [
    ("      const uint32_t np = adapt(p, bit);\n",
     "      ++n_it_;\n      const uint32_t np = adapt(p, bit);\n"),
    ("      store_if(out, (int)out_p, c * kSteps + j < iters);\n"
     "      out += kLanes;\n    }\n  }\n}\n",
     "      asm volatile(\"\" :: \"r\"(p) : \"memory\");\n"
     "      SPLIT_MARK(1);\n"
     "      store_if(out, (int)out_p, c * kSteps + j < iters);\n"
     "      out += kLanes;\n      SPLIT_MARK(5);\n    }\n  }\n"
     "  SPLIT_END\n}\n"),
]

WARPS_K5 = WARPS_TAKE + [
    ("    uint8_t* cc = reinterpret_cast<uint8_t*>(cnt[c & 1]);\n",
     "    SPLIT_MARK(4);\n"
     "    uint8_t* cc = reinterpret_cast<uint8_t*>(cnt[c & 1]);\n"),
    ("      rng = ren ? nrng << 16 : (active ? nrng : rng);\n",
     "      rng = ren ? nrng << 16 : (active ? nrng : rng);\n"
     "      ++n_it_;\n"
     "      asm volatile(\"\" :: \"r\"(rng), \"r\"(low) : \"memory\");\n"
     "      SPLIT_MARK(3);\n"),
    ("      const unsigned mask = __ballot_sync(kFull, ren);\n",
     "      asm volatile(\"\" :: \"r\"(p) : \"memory\");\n"
     "      SPLIT_MARK(1);\n"
     "      const unsigned mask = __ballot_sync(kFull, ren);\n"),
    ("      rens |= (uint32_t)ren << j;\n    }\n",
     "      rens |= (uint32_t)ren << j;\n      SPLIT_MARK(4);\n    }\n"),
    ("    bar_sync(kBarModel, kGroup);\n    const uint4* c4",
     "    bar_sync(kBarModel, kGroup);\n    SPLIT_MARK(4);\n"
     "    const uint4* c4"),
    ("        cursor += (int)((wd * 0x01010101u) >> 24);\n      }\n    }\n",
     "        cursor += (int)((wd * 0x01010101u) >> 24);\n      }\n    }\n"
     "    asm volatile(\"\" :: \"r\"(cursor) : \"memory\");\n"
     "    SPLIT_MARK(5);\n"),
    ("  if (lane == 0) counts[g] = cursor;\n",
     "  SPLIT_END\n  if (lane == 0) counts[g] = cursor;\n"),
]

# K2 up to commit fcee879: one block of 128 threads per group, a step's
# plane byte and probability loaded from device memory, a native divide,
# and a ballot plus a __syncthreads a step for the group's prefix.
BARRIER_K2 = [
    ("  for (int i = iters - 1; i >= 0; --i) {\n"
     "    const int fld = (planes[(size_t)(i >> 2) * kLanes + lane]\n"
     "                     >> ((i & 3) * 2)) & 3;\n"
     "    bool ren = false;\n"
     "    uint32_t unit = 0;\n"
     "    if (fld & 2) {\n"
     "      const int bit = fld & 1;\n"
     "      const uint32_t p = (uint32_t)probs[(size_t)i * kLanes + lane];\n"
     "      const uint32_t f = bit ? 4096u - p : p;\n",
     "  SPLIT_BEGIN;\n"
     "  for (int i = iters - 1; i >= 0; --i) {\n"
     "    ++n_it_;\n"
     "    const int fld = (planes[(size_t)(i >> 2) * kLanes + lane]\n"
     "                     >> ((i & 3) * 2)) & 3;\n"
     "    asm volatile(\"\" :: \"r\"(fld) : \"memory\");\n"
     "    SPLIT_MARK(0);\n"
     "    uint32_t p = 0;\n"
     "    if (fld & 2) p = (uint32_t)probs[(size_t)i * kLanes + lane];\n"
     "    asm volatile(\"\" :: \"r\"(p) : \"memory\");\n"
     "    SPLIT_MARK(1);\n"
     "    bool ren = false;\n"
     "    uint32_t unit = 0;\n"
     "    if (fld & 2) {\n"
     "      const int bit = fld & 1;\n"
     "      const uint32_t f = bit ? 4096u - p : p;\n"),
    ("    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);\n",
     "    asm volatile(\"\" :: \"r\"(x) : \"memory\");\n"
     "    SPLIT_MARK(2);\n"
     "    const unsigned mask = __ballot_sync(0xFFFFFFFFu, ren);\n"),
    ("    __syncthreads();\n",
     "    SPLIT_MARK(3);\n    __syncthreads();\n    SPLIT_MARK(4);\n"),
    ("    cursor -= m;\n  }\n",
     "    cursor -= m;\n    SPLIT_MARK(5);\n  }\n  SPLIT_END\n"),
]

# K2 from this design on: a chain kernel, one warp a block, 32 steps a
# chunk from a ring staged by cp.async, then a placement kernel.  Counted
# per chunk in the chain kernel (a mark inside the 32 steps would stop
# them overlapping).
CHAIN_K2 = [
    ("  uint32_t x = 1u << 16;\n  for (int s = 0; s < nchunks; ++s) {\n",
     "  uint32_t x = 1u << 16;\n  SPLIT_BEGIN;\n"
     "  for (int s = 0; s < nchunks; ++s) {\n    n_it_ += kSteps;\n"),
    ("    stage(ring_p, ring_b, probs, planes, s + kAhead, nchunks, iters, w,"
     " t);\n",
     "    stage(ring_p, ring_b, probs, planes, s + kAhead, nchunks, iters, w,"
     " t);\n    SPLIT_MARK(0);\n"),
    ("    uint16_t* dst = dense + (size_t)c * kSteps * kLanes + lane;\n",
     "#pragma unroll\n    for (int j = 0; j < kSteps; ++j)\n"
     "      asm volatile(\"\" :: \"r\"(m[j]), \"r\"(fb[j]) : \"memory\");\n"
     "    SPLIT_MARK(1);\n"
     "    uint16_t* dst = dense + (size_t)c * kSteps * kLanes + lane;\n"),
    ("    const size_t npad = (size_t)nchunks * kSteps;\n    ballots[",
     "    asm volatile(\"\" :: \"r\"(x), \"r\"(mine) : \"memory\");\n"
     "    SPLIT_MARK(2);\n"
     "    const size_t npad = (size_t)nchunks * kSteps;\n    ballots["),
    ("    if (t == 0) chunk_cnt[w * nchunks + c] = (int)cnt;\n  }\n",
     "    if (t == 0) chunk_cnt[w * nchunks + c] = (int)cnt;\n"
     "    SPLIT_MARK(3);\n  }\n  SPLIT_END\n"),
]

PATCHES = {("switch", "wide_model"): SWITCH_K1,
           ("switch", "wide_rc_encode"): SWITCH_K5,
           ("warps", "wide_model"): WARPS_K1,
           ("warps", "wide_rc_encode"): WARPS_K5,
           ("barrier", "wide_rans"): BARRIER_K2,
           ("chain", "wide_rans"): CHAIN_K2}
KERNELS = ("wide_model", "wide_rc_encode", "wide_rans")
HEADER = "wide_encode_step.cuh"
# the parts of a step, per kernel
K2_PARTS = {"barrier": ("plane", "prob", "division", "ballot", "barrier",
                        "store"),
            "chain": ("wait", "stage", "walk", "chunk")}


def design(src: str) -> str:
    if "wide_rans_kernel" in src:
        return "barrier"
    if "wide_rans_chain_kernel" in src:
        return "chain"
    return "warps" if "take_chunk(" in src else "switch"


def patch(src: str, patches: list, name: str) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found exactly once: "
                             f"{old!r}")
        src = src.replace(old, new)
    return src


def instrument(src: str, stem: str) -> str:
    """The counted copy of a kernel source.  The state-warp design gets
    its counter definitions from the counted copy of the header."""
    kind = design(src)
    src = patch(src, PATCHES[(kind, stem)], f"{stem}.cu")
    if kind != "warps":
        anchor = "namespace {\n"
        if src.count(anchor) != 1:
            raise SystemExit(f"{stem}.cu: anchor not found exactly once: "
                             f"{anchor!r}")
        src = src.replace(anchor, PRELUDE + "\n" + anchor)
    return src + TAIL


def instrument_header(src: str) -> str:
    src = patch(src, WARPS_HEADER, HEADER)
    return src.replace("#pragma once\n", "#pragma once\n" + PRELUDE, 1)


def build(dirs: list, kernels: tuple, out_dir: Path) -> dict:
    """(dir index, kernel, variant) -> CDLL; one nvcc per copy, all
    started together.  Each variant's copies sit in a directory of their
    own, so that a quoted include finds the counted header first."""
    jobs = {}
    for d, csrc in enumerate(dirs):
        for stem in kernels:
            src = (csrc / f"{stem}.cu").read_text()
            variants = [("plain", src, None)]
            try:
                variants.append((
                    "clock", instrument(src, stem),
                    instrument_header((csrc / HEADER).read_text())
                    if design(src) == "warps" else None))
            except (KeyError, SystemExit) as e:  # timed only
                print(f"{csrc} {stem}: no counters ({e})")
            for variant, text, header in variants:
                vdir = out_dir / f"{d}_{variant}"
                vdir.mkdir(parents=True, exist_ok=True)
                if header is not None:
                    (vdir / HEADER).write_text(header)
                path = vdir / f"{stem}.cu"
                path.write_text(text)
                jobs[(d, stem, variant)] = (path, csrc,
                                            vdir / f"lib{stem}.so")
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(lambda j: nvcc(*j), jobs.values()))
    return {k: ctypes.CDLL(str(j[2])) for k, j in jobs.items()}


def split(clk, kind: str, block_warps: int, parts: tuple = PARTS) -> dict:
    """Cycles per step of each part, the mean over each role's warps."""
    import numpy as np

    n = clk[:, 7].astype(np.float64)
    role = np.arange(MAX_WARPS) % block_warps // 4
    if kind == "warps":
        kinds = {name: (role == r) & (n > 0)
                 for r, name in enumerate(("state", "model"))}
    else:
        kinds = {"lane": n > 0}
    out = {}
    for name, sel in kinds.items():
        if not sel.any():
            continue
        per = clk[sel, :len(parts)].astype(np.float64) / n[sel, None]
        mean = per.mean(axis=0)
        out[name] = {"cycles_per_step": dict(zip(parts, mean.tolist())),
                     "total": float(mean.sum()),
                     "per_warp_max": dict(zip(parts,
                                              per.max(axis=0).tolist())),
                     "warps": int(sel.sum())}
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    kernels = KERNELS
    argv = []
    for a in sys.argv[1:]:
        if a.startswith("--kernels="):
            kernels = tuple(a.split("=", 1)[1].split(","))
        else:
            argv.append(a)
    dirs = [Path(a).resolve() for a in argv] or \
        [ROOT / "libbsc_tpu_torch" / "csrc"]
    out_dir = ROOT / "libbsc_tpu_torch" / "_build" / "encode_step_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(dirs, kernels, out_dir)

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
    planes, sizes, max_bits = st["planes"], st["sizes"], st["max_bits"]
    if planes.data_ptr() % 16:
        planes = planes.clone()
    n = len(st["U"])
    rows = planes.shape[0]
    pri = WK.priors_tensor(dev)
    tab = WK.sm_table_tensor(dev, encoder=True)
    cap = WK.W.GROUP * (max_bits + 2)
    handle = torch.cuda.current_stream(dev).cuda_stream
    VP, I = ctypes.c_void_p, ctypes.c_int
    result = {"card": card, "max_sm_clock_mhz": clock_mhz,
              "iterations": max_bits, "dirs": [str(d) for d in dirs]}
    k1_probs = WK.model_probs(planes, max_bits) \
        if "wide_rans" in kernels else None
    for d, csrc in enumerate(dirs):
        kind = design((csrc / "wide_model.cu").read_text())
        extra = [tab.data_ptr()] if kind != "switch" else []
        for stem in kernels:
            kind_s = design((csrc / f"{stem}.cu").read_text())
            row = {"design": kind_s}
            for variant in ("plain", "clock"):
                lib = libs.get((d, stem, variant))
                if lib is None:
                    continue
                if stem == "wide_rans":
                    cap2 = WK.W.GROUP * max(max_bits, 1)
                    k2 = (torch.empty((WK.GROUPS, cap2), dtype=torch.int32,
                                      device=dev),
                          torch.empty(WK.GROUPS, dtype=torch.int32,
                                      device=dev),
                          torch.empty(WK.LANES, dtype=torch.int32,
                                      device=dev))
                    fn = lib.wide_rans_launch
                    if kind_s == "barrier":
                        mid = []
                    else:  # the chain design's table and scratch
                        scratch = torch.empty(WK.rans_scratch_bytes(max_bits),
                                              dtype=torch.uint8, device=dev)
                        mid = [WK.rans_table_tensor(dev).data_ptr(),
                               scratch.data_ptr()]
                    args = [planes.data_ptr(), k1_probs.data_ptr(), max_bits,
                            cap2, *mid, *(t.data_ptr() for t in k2), handle]
                    fn.argtypes = [VP, VP, I, I] + [VP] * (len(args) - 4)
                elif stem == "wide_model":
                    probs = torch.zeros((4 * rows, WK.LANES),
                                        dtype=torch.int32, device=dev)
                    fn = lib.wide_model_launch
                    args = [planes.data_ptr(), max_bits, pri.data_ptr(),
                            *extra, probs.data_ptr(), handle]
                    fn.argtypes = [VP, I] + [VP] * (len(args) - 2)
                else:
                    units = torch.empty((WK.GROUPS, cap), dtype=torch.int32,
                                        device=dev)
                    counts = torch.empty(WK.GROUPS, dtype=torch.int32,
                                         device=dev)
                    fn = lib.wide_rc_encode_launch
                    args = [planes.data_ptr(), max_bits, cap, pri.data_ptr(),
                            *extra, units.data_ptr(), counts.data_ptr(),
                            handle]
                    fn.argtypes = [VP, I, I] + [VP] * (len(args) - 3)
                fn.restype = I

                def call(fn=fn, args=args):
                    rc = fn(*args)
                    if rc:
                        raise SystemExit(f"{stem} launch failed: "
                                         f"cudaError_t {rc}")

                row[f"{variant}_ms"] = CS.cuda_ms(call, 3)
                if stem == "wide_rans":
                    payload = WK._assemble_rans(n, *k2, sizes, max_bits)
                    rans = True
                elif stem == "wide_model":
                    k2 = WK.rans_encode(planes, probs, max_bits)
                    payload = WK._assemble_rans(n, *k2, sizes, max_bits)
                    rans = True
                else:
                    payload = WK._assemble(n, units, counts, sizes, max_bits)
                    rans = False
                if payload != st["native"][rans]:
                    raise SystemExit(f"{csrc} {stem} {variant}: the payload "
                                     "differs from the native codec's")
            row["cycles_per_step_from_ms"] = \
                row["plain_ms"] * clock_mhz * 1e3 / max_bits
            name = {"wide_model": "K1", "wide_rc_encode": "K5",
                    "wide_rans": "K2"}[stem]
            line = (f"{csrc} {name} ({kind_s}): {row['plain_ms']:.3f} ms, "
                    f"{max_bits} steps, {row['cycles_per_step_from_ms']:.0f}"
                    f" cycles a step at {clock_mhz:.0f} MHz")
            if (d, stem, "clock") in libs:
                clk = np.zeros((MAX_WARPS, 8), dtype=np.uint64)
                rc = libs[(d, stem, "clock")].clk_read(
                    clk.ctypes.data_as(ctypes.c_void_p))
                if rc:
                    raise SystemExit(f"clk_read failed: {rc}")
                row["split"] = split(clk, kind_s,
                                     8 if kind_s == "warps" else 4,
                                     K2_PARTS.get(kind_s, PARTS))
                line += f" ({row['clock_ms']:.3f} ms with counters)"
                for who, sp in row["split"].items():
                    line += f"; {who} warps counted {sp['total']:.0f}: " + \
                        ", ".join(f"{k} {v:.0f}" for k, v in
                                  sp["cycles_per_step"].items() if v)
            result.setdefault(str(csrc), {})[stem] = row
            print(line, flush=True)
    (out_dir / "split.json").write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
