#!/usr/bin/env python3
"""K6, the byte histogram, on the card: given kernels and design candidates.

Times ``byte_hist.cu`` of each given ``csrc`` directory (with no argument,
the checkout's) and, with ``--candidates``, a grid of candidate designs
built from the template below, on four inputs of 25 MiB (bsc's default
block): the text block of ``chip_smoke.py``'s corpus, an all-zero block,
uniform random bytes, and an odd-length view of the text at offset 3.
Each call is timed as ``chip_smoke.py`` times K6: the wrapper's work (the
1 KiB zero fill of the output and the kernel) in a CUDA graph of 40 calls,
each call on one of four copies of the input in turn, so that the input is
not in the 50 MB L2 cache.  Every output is held against
``torch.bincount``.

The candidates count every byte into shared-memory sub-histograms with
plain atomics (no ``__match_any_sync``); they differ in

    COPIES  sub-histograms a warp; lane l adds into copy l % COPIES, and
            bin b of copy k lies at b * COPIES + k, so that lanes of
            different copies fall into different banks;
    AGG     1: a thread first merges runs of equal bytes among its 16
            bytes in registers and adds each run once (a predicated
            atomic where the byte changes), 0: one atomic a byte;
    VEC     16-byte loads a thread issues before it counts them (16, 32
            or 64 bytes in flight a thread).

    python3 tools/byte_hist_variants.py [csrc ...] [--candidates]

Needs a CUDA card and nvcc; builds into libbsc_tpu_torch/_build/
byte_hist_variants/ and prints a JSON of the times last.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.decode_step_split import nvcc  # noqa: E402

GRID = {"COPIES": (1, 4, 8, 16), "AGG": (0, 1), "VEC": (1, 2, 4)}

TEMPLATE = r"""
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCopies = COPIES;
constexpr int kVec = VEC;
constexpr int kBins = 256 * kCopies;  // one warp's sub-histograms

// a thread's 16 bytes into its copy h (bin b at h[b * kCopies])
__device__ __forceinline__ void count16(unsigned* h, uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#if AGG
  unsigned prev = v.x & 0xFF, run = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned c = (w[q] >> (8 * b)) & 0xFF;
      const bool flush = c != prev;
      if (flush) atomicAdd(&h[prev * kCopies], run);
      run = flush ? 1u : run + 1u;
      prev = c;
    }
  }
  atomicAdd(&h[prev * kCopies], run);
#else
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      atomicAdd(&h[((w[q] >> (8 * b)) & 0xFF) * kCopies], 1u);
  }
#endif
}

__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const uint8_t* __restrict__ data, int head, long long n_vec,
                 int tail, int* __restrict__ out) {
  extern __shared__ unsigned hist[];  // [kWarps][256][kCopies]
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* h = hist + warp * kBins + lane % kCopies;
  const uint4* vec = reinterpret_cast<const uint4*>(data + head);
  const long long tile = (long long)kThreads * kVec;
  for (long long base = blockIdx.x * tile; base < n_vec;
       base += (long long)gridDim.x * tile) {
    uint4 v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long i = base + threadIdx.x + j * kThreads;
      v[j] = i < n_vec ? vec[i] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (base + threadIdx.x + j * kThreads < n_vec) count16(h, v[j]);
  }
  if (blockIdx.x == 0 && warp == 0) {  // head + tail <= 30 bytes
    if (lane < head) atomicAdd(&h[data[lane] * kCopies], 1u);
    else if (lane - head < tail)
      atomicAdd(&h[data[head + 16 * n_vec + (lane - head)] * kCopies], 1u);
  }
  __syncthreads();
  unsigned s = 0;
  for (int w = 0; w < kWarps; ++w)
    for (int k = 0; k < kCopies; ++k)
      s += hist[w * kBins + threadIdx.x * kCopies + k];
  if (s) atomicAdd(&out[threadIdx.x], (int)s);
}

}  // namespace

extern "C" int byte_hist_launch(const uint8_t* data, long long n, int* out,
                                void* stream) {
  static int max_blocks = 0;
  const int smem = kWarps * kBins * 4;
  if (n <= 0) return 0;
  if (!max_blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (!err) err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = cudaFuncSetAttribute(
        byte_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, byte_hist_kernel, kThreads, smem);
    if (err) return (int)err;
    max_blocks = sms * per_sm;
  }
  int head = (int)((16 - ((uintptr_t)data & 15)) & 15);
  if (head > n) head = (int)n;
  const long long n_vec = (n - head) / 16;
  const int tail = (int)(n - head - 16 * n_vec);
  long long blocks = (n_vec + kThreads * kVec - 1) / (kThreads * kVec);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  byte_hist_kernel<<<(unsigned)blocks, kThreads, smem,
                     (cudaStream_t)stream>>>(data, head, n_vec, tail, out);
  return (int)cudaGetLastError();
}
"""


def candidates() -> list:
    keys = list(GRID)
    return [dict(zip(keys, vals)) for vals in itertools.product(
        *(GRID[k] for k in keys))]


def variant_name(params: dict) -> str:
    return "c{COPIES}_a{AGG}_v{VEC}".format(**params)


def build(dirs: list, with_candidates: bool, out_dir: Path) -> dict:
    """name -> CDLL; one nvcc per source, all started together."""
    jobs = {}
    for d, csrc in enumerate(dirs):
        vdir = out_dir / f"dir{d}"
        vdir.mkdir(parents=True, exist_ok=True)
        src = vdir / "byte_hist.cu"
        src.write_text((csrc / "byte_hist.cu").read_text())
        jobs[str(csrc)] = (src, csrc, vdir / "libbyte_hist.so")
    if with_candidates:
        for params in candidates():
            name = variant_name(params)
            src = out_dir / f"{name}.cu"
            defs = "".join(f"#define {k} {v}\n" for k, v in params.items())
            src.write_text(defs + TEMPLATE)
            jobs[name] = (src, out_dir, out_dir / f"lib{name}.so")
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda j: nvcc(*j), jobs.values()))
    libs = {}
    for name, job in jobs.items():
        lib = ctypes.CDLL(str(job[2]))
        lib.byte_hist_launch.restype = ctypes.c_int
        lib.byte_hist_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    with_candidates = "--candidates" in sys.argv[1:]
    dirs = [Path(a).resolve() for a in args] or \
        [ROOT / "libbsc_tpu_torch" / "csrc"]
    out_dir = ROOT / "libbsc_tpu_torch" / "_build" / "byte_hist_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(dirs, with_candidates, out_dir)

    import chip_smoke as CS

    dev = torch.device("cuda", 0)
    card = CS.smi()
    n = CS.BLOCK
    text = torch.from_numpy(np.frombuffer(CS.make_corpus(n), np.uint8)
                            .copy()).to(dev)
    g = np.random.default_rng(0x4B36)
    inputs = {
        "text": text,
        "zeros": torch.zeros(n, dtype=torch.uint8, device=dev),
        "random": torch.from_numpy(g.integers(0, 256, n, np.uint8)).to(dev),
        "offset3": None,  # text[3:], made per copy below
    }
    result = {"card": card, "bytes": n, "times_ms": {}}
    for case, x in inputs.items():
        if case == "offset3":
            copies = [text.clone()[3:] for _ in range(CS.COLD_COPIES)]
        else:
            copies = [x] + [x.clone() for _ in range(CS.COLD_COPIES - 1)]
        ref = torch.bincount(copies[0].long(), minlength=256)
        for name, lib in libs.items():
            def call(t, lib=lib):
                # the current stream: a graph capture runs on its own
                out = torch.zeros(256, dtype=torch.int32, device=dev)
                rc = lib.byte_hist_launch(
                    t.data_ptr(), t.numel(), out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise SystemExit(f"{name}: cudaError_t {rc}")
                return out

            if not torch.equal(call(copies[0]).long(), ref):
                raise SystemExit(f"{name} differs from torch.bincount on "
                                 f"{case}")
            turn = itertools.cycle(copies)
            ms = CS.graph_ms(lambda: call(next(turn)), CS.STATS_LAUNCHES)
            result["times_ms"].setdefault(name, {})[case] = ms
            print(f"{name} {case}: {ms:.4f} ms in a graph", flush=True)
        del copies
    (out_dir / "times.json").write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
