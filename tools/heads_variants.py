#!/usr/bin/env python3
"""K13, the forward BWT's group-head kernel, on the card: what each of its
random accesses costs.

    python3 tools/heads_variants.py

On the 25 MiB corpus block's own bootstrap inputs (the first block of
``chip_smoke.make_corpus``, seed 0xB5C, whose LZP is rejected on the main
path, so the BWT sorts the raw block), with CUDA events, the best of
``REPS`` single launches after a warm-up:

- the variants of ``tools/heads_variants.cu``: K13's full form as it stood
  in 34e0e9c (``base``, its ranks and mask held to a torch version of the
  same function) and four throwaway copies, each without one class of
  access: ``no_mask`` (no mask scatter), ``rank_at_row`` (the rank
  written coalesced at its row), ``lo_direct`` (the low key read as the
  first sort's values at ``o2[r]``, not through ``o1``), ``gathers_only``
  (no write);
- the package's own K13 on the same rows: ``heads_pay`` and
  ``heads_full`` apart where the tree has the pre-pass (each held to its
  plain version), else ``heads_full``; with the pre-pass also
  ``heads_full`` on packed words whose position field is the row's own
  (``rank_at_row``: its rank scatter and list coalesced, all else the
  same), which prices the one scatter left;
- the package's K14 on the block's final ranks: ``extract_bins`` and
  ``extract_place`` apart where the tree has them (held to
  ``extract_plain``), else ``extract``;
- torch around it: the bootstrap's two sorts and the gather
  ``key_hi[o1]`` between them, and the first full round's two sorts.

Needs a CUDA card and nvcc; builds into
``libbsc_tpu_torch/_build/heads_variants/``; prints one line of parts,
then the JSON (also written to that directory).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.decode_step_split import nvcc  # noqa: E402

REPS = 5
BLOCK = 25 << 20
VARIANTS = ("base", "no_mask", "rank_at_row", "lo_direct", "gathers_only")
BUILD = ROOT / "libbsc_tpu_torch" / "_build" / "heads_variants"


def build(out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libheads_variants.so"
    nvcc(ROOT / "tools" / "heads_variants.cu",
         ROOT / "libbsc_tpu_torch" / "csrc", lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.heads_variant_launch
    VP, L = ctypes.c_void_p, ctypes.c_int64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [VP] * 5 + [L] + [VP] * 4
    return fn


def best_ms(fn, reps: int = REPS) -> float:
    """The fastest of ``reps`` launches of fn(), each between two CUDA
    events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return min(ms)


def torch_heads(hi_s, lo, o1, o2):
    """K13's full form as torch ops (34e0e9c's heads_full_plain): the
    position-order group-start ranks and the unresolved mask."""
    import torch

    n = hi_s.shape[0]
    pos_s = o1[o2]
    lo_s = lo[pos_s]
    heads = torch.ones(n, dtype=torch.bool, device=hi_s.device)
    heads[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    idx = torch.arange(n, device=hi_s.device)
    gstart = torch.cummax(torch.where(heads, idx, -1), 0).values
    nxt = torch.ones_like(heads)
    nxt[:-1] = heads[1:]
    rank = torch.empty_like(hi_s)
    rank[pos_s] = gstart
    mask = torch.empty(n, dtype=torch.uint8, device=hi_s.device)
    mask[pos_s] = (~(heads & nxt)).to(torch.uint8)
    return rank, mask


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import make_corpus
    from libbsc_tpu_torch.ops import bwt

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    launch = build(BUILD)
    stream = torch.cuda.current_stream(dev).cuda_stream
    d = torch.from_numpy(np.frombuffer(make_corpus(BLOCK), np.uint8)
                         .copy()).to(dev)
    n = int(d.shape[0])
    k_hi, k_lo = bwt.boot_keys(d)
    lo_s, o1 = torch.sort(k_lo, stable=True)
    hi1 = k_hi[o1]
    hi_s, o2 = torch.sort(hi1, stable=True)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    mask = torch.empty(n, dtype=torch.uint8, device=dev)
    scratch = torch.empty(-(-n // 1024) + 3, dtype=torch.int64, device=dev)

    def variant(i):
        rc = launch(i, hi_s.data_ptr(), k_lo.data_ptr(), lo_s.data_ptr(),
                    o1.data_ptr(), o2.data_ptr(), n, rank.data_ptr(),
                    mask.data_ptr(), scratch.data_ptr(), stream)
        if rc:
            raise SystemExit(f"variant {VARIANTS[i]}: cudaError_t {rc}")

    variant(0)
    ref_rank, ref_mask = torch_heads(hi_s, k_lo, o1, o2)
    if not (torch.equal(rank, ref_rank) and torch.equal(mask, ref_mask)
            and int(scratch[-(-n // 1024) + 1]) == int(ref_mask.sum())):
        raise SystemExit("the base variant differs from the torch version")
    del ref_mask
    res = {"n": n, "card": smi(), "unresolved": int(mask.sum())}
    for i, name in enumerate(VARIANTS):
        res[name] = best_ms(lambda i=i: variant(i))
    if hasattr(bwt, "heads_pay"):
        res["package_heads_pay"] = best_ms(lambda: bwt.heads_pay(lo_s, o1,
                                                                 k_hi))
        hi1_k, pay = bwt.heads_pay(lo_s, o1, k_hi)
        hi1_p, pay_p = bwt.heads_pay_plain(lo_s, o1, k_hi)
        if not (torch.equal(hi1_k, hi1_p) and torch.equal(pay, pay_p)):
            raise SystemExit("heads_pay differs from its plain version")
        del hi1_k, hi1_p, pay_p
        res["package_heads_full"] = best_ms(lambda: bwt.heads_full(hi_s, pay,
                                                                   o2))
        k_rank, still, cnt = bwt.heads_full(hi_s, pay, o2)
        p_rank, p_still, p_cnt = bwt.heads_full_plain(hi_s, pay, o2)
        if not (torch.equal(k_rank, p_rank) and int(cnt) == int(p_cnt)
                and torch.equal(still[:int(cnt)], p_still)
                and torch.equal(k_rank, ref_rank)):
            raise SystemExit("heads_full differs from its plain version")
        del k_rank, still, p_rank, p_still
        row_of = torch.empty_like(o2)
        row_of[o2] = torch.arange(n, device=dev)
        pay_row = (pay >> 32 << 32) | row_of
        del row_of
        res["package_heads_full_rank_at_row"] = best_ms(
            lambda: bwt.heads_full(hi_s, pay_row, o2))
        del pay, pay_row
    else:
        res["package_heads_full"] = best_ms(lambda: bwt.heads_full(hi_s, k_lo,
                                                                   o1, o2))
    res["boot_sort1"] = best_ms(lambda: torch.sort(k_lo, stable=True))
    res["boot_gather"] = best_ms(lambda: k_hi[o1])
    res["boot_sort2"] = best_ms(lambda: torch.sort(hi1, stable=True))
    del lo_s, o1, hi1, hi_s, o2, k_hi, k_lo
    key_a, key_b = bwt.round_keys(ref_rank, bwt._BOOT_DEPTH)
    del ref_rank, rank, mask
    final = bwt.suffix_ranks(d)
    r = bwt.aux_rate(n)
    want = bwt.extract_plain(d, final, r)
    if hasattr(bwt, "extract_bins"):
        res["package_extract_bins"] = best_ms(
            lambda: bwt.extract_bins(d, final, r))
        stage = bwt.extract_bins(d, final, r)[0]
        res["package_extract_place"] = best_ms(
            lambda: bwt.extract_place(stage))
        del stage
    else:
        res["package_extract"] = best_ms(lambda: bwt.extract(d, final, r))
    got = bwt.extract(d, final, r)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit("extract differs from extract_plain")
    del final, got, want
    res["full_sort1"] = best_ms(lambda: torch.sort(key_b, stable=True))
    o1 = torch.sort(key_b, stable=True).indices
    g = key_a[o1]
    res["full_gather"] = best_ms(lambda: key_a[o1])
    res["full_sort2"] = best_ms(lambda: torch.sort(g, stable=True))
    print("heads variants (ms, best of %d; %d rows, %d unresolved; %s): %s"
          % (REPS, n, res["unresolved"], res["card"],
             ", ".join(f"{k} {v:.4f}" for k, v in res.items()
                       if isinstance(v, float))), flush=True)
    (BUILD / "heads_variants.json").write_text(json.dumps(res))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
