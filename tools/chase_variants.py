#!/usr/bin/env python3
"""K8, the wide-aux inverse BWT, on the card: where its table's time goes,
and its table and chase beside other designs.

On one 25 MiB block's own inputs (the corpus's first block of
``chip_smoke.py`` through the port's LZP attempt and device wide-aux BWT,
as ``chip_smoke.py`` phase 2 times K8), with CUDA events (the mean of five
launches after a warm-up):

  step 0   the design up to f242faf built its int64 table with torch ops:
           the stable u8 sort, the PSI fix-up (``u + (u >= primary)`` and
           the primary in front), the rows' chars (a cast and a cat) and
           the pack (a shift and an OR); each is timed alone, then the
           whole.  Beside them the two ways to the bucket ends: the
           sorted chars by ``torch.searchsorted`` (``ops/bwt.bucket_ends``)
           and K6 (``stats_kernels.byte_histogram``) plus a cumsum.
  designs  each a table build and a chase (``tools/chase_variants.cu``,
           which includes the package's ``csrc/unbwt_chase.cu``):
           ``packed``  the int64 table and chase up to f242faf, one load a
                       step;
           ``split``   a u32 PSI beside a u8 char array (torch-built), two
                       loads a step;
           ``bucket``  a u32 PSI table by a kernel, one load a step, the
                       row's char from the bucket ends;
           ``pairs8``  the package's K8: ``ops/bwt.chase_inputs`` (sort,
                       bucket ends, the two-step table kernel: row k =
                       PSI[PSI[k]] and the char of row PSI[k] in one int64)
                       and ``ops/bwt.chase`` (r / 2 loads a chain);
           ``pairs5``  the two-step table as a u32 beside a u8, two loads
                       a step of two;
           ``pairs8_psi`` the package's table built from the u32 PSI
                       table instead of the sort's indices.
           Each design's table time counts everything from the u8 block
           (the sort included), its chase's output is held against the
           block, and each chase is also launched one chain at a time
           (``chip_smoke.chase_latency``: eight chains spread over the
           block, each after a 256 MiB write has evicted the L2), its
           latency floor.

    python3 tools/chase_variants.py [--step0]

``--step0`` runs step 0 and the designs that do not launch the package's
K8 (``packed``, ``split``).  Needs a CUDA card and nvcc; builds into
libbsc_tpu_torch/_build/chase_variants/ and prints a JSON of the times
last.  The table kernels are also timed alone (the package's two-step
one and the u32 PSI one, on the sort's indices).
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.decode_step_split import nvcc  # noqa: E402

REPS = 5
VP, I, L, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
SIGNATURES = {
    "packed_chase_launch": [VP, VP, I, I, L, VP, VP],
    "psi_chase_launch": [VP] * 4 + [I, I, L, VP, VP],
    "psi_table_launch": [VP, L, U32, VP, VP],
    "pairs_table_launch": [VP, VP, L, U32, VP, VP, VP, VP, VP],
    "pairs5_chase_launch": [VP] * 4 + [I, I, L, VP, VP],
}


def build(out_dir: Path):
    """tools/chase_variants.cu with the package's csrc on the include
    path, as a CDLL with its launchers' argtypes set."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libchase_variants.so"
    nvcc(ROOT / "tools" / "chase_variants.cu",
         ROOT / "libbsc_tpu_torch" / "csrc", lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return lib


def _ok(rc: int, what: str) -> None:
    if rc:
        raise SystemExit(f"{what} failed to launch: cudaError_t {rc}")


def step0(u_d, primary: int) -> dict:
    """The torch ops of the int64 table up to f242faf, each timed alone, and
    the two ways to the bucket ends."""
    import torch

    import chip_smoke as CS
    from libbsc_tpu_torch.ops import bwt
    from libbsc_tpu_torch.ops import stats_kernels as S

    head = torch.tensor([primary], device=u_d.device)
    chars, u_sorted = torch.sort(u_d, stable=True)
    psi = torch.cat([head, u_sorted + (u_sorted >= primary).long()])
    row_char = torch.cat([torch.zeros_like(head), chars.long()])
    ends = bwt.bucket_ends(chars)

    def by_hist():
        return (torch.cumsum(S.byte_histogram(u_d), 0) + 1).to(torch.int32)

    if not torch.equal(by_hist(), ends):
        raise SystemExit("step 0: the bucket ends by K6 differ from "
                         "searchsorted's")
    ms = {
        "sort_ms": lambda: torch.sort(u_d, stable=True),
        "psi_fixup_ms": lambda: torch.cat(
            [head, u_sorted + (u_sorted >= primary).long()]),
        "row_char_ms": lambda: torch.cat([torch.zeros_like(head),
                                          chars.long()]),
        "pack_ms": lambda: (row_char << 32) | psi,
        "table_ms": lambda: _packed_table(u_d, primary),
        "ends_searchsorted_ms": lambda: bwt.bucket_ends(chars),
        "ends_hist_ms": by_hist,
    }
    out = {k: CS.cuda_ms(fn, REPS) for k, fn in ms.items()}
    print(f"K8 step 0 (the int64 table up to f242faf, ms): sort "
          f"{out['sort_ms']:.4f}, psi fix-up {out['psi_fixup_ms']:.4f}, "
          f"row_char {out['row_char_ms']:.4f}, pack {out['pack_ms']:.4f}; "
          f"chase_inputs all {out['table_ms']:.4f}; bucket ends by "
          f"searchsorted {out['ends_searchsorted_ms']:.4f}, by K6 + cumsum "
          f"{out['ends_hist_ms']:.4f}; {CS.smi()}", flush=True)
    return out


def _packed_table(u_d, primary: int):
    """The int64 table up to f242faf, by torch ops."""
    import torch

    head = torch.tensor([primary], device=u_d.device)
    chars, u_sorted = torch.sort(u_d, stable=True)
    psi = torch.cat([head, u_sorted + (u_sorted >= primary).long()])
    row_char = torch.cat([torch.zeros_like(head), chars.long()])
    return (row_char << 32) | psi


def designs(lib, u_d, primary: int, aux, r: int, lz, only_old: bool
            ) -> dict:
    """name -> {table_ms, chase_ms, latency_floor_ms, loads}: each design's
    table build from the u8 block and its chase on the block's chains."""
    import torch

    import chip_smoke as CS
    from libbsc_tpu_torch.ops import bwt

    dev = u_d.device
    n = int(u_d.shape[0])
    handle = torch.cuda.current_stream(dev).cuda_stream
    starts64 = torch.cat([torch.tensor([primary], device=dev),
                          aux.long() + 1])
    starts32 = starts64.to(torch.int32)
    chains = int(starts64.shape[0])

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def launch(name, *tensors):
        def call(heads, m):
            out = torch.empty(min(m, int(heads.shape[0]) * r),
                              dtype=torch.uint8, device=dev)
            _ok(getattr(lib, name)(*map(ptr, tensors), heads.data_ptr(),
                                   int(heads.shape[0]), r, m,
                                   out.data_ptr(), handle), name)
            return out
        return call

    def sorted_block():
        chars, u_sorted = torch.sort(u_d, stable=True)
        return u_sorted, bwt.bucket_ends(chars)

    def psi_table(u_sorted):
        psi = torch.empty(n + 1, dtype=torch.int32, device=dev)
        _ok(lib.psi_table_launch(u_sorted.data_ptr(), n, primary,
                                 psi.data_ptr(), handle), "psi_table_launch")
        return psi

    def split_table():
        chars, u_sorted = torch.sort(u_d, stable=True)
        return (bwt.psi_rows(u_sorted, primary).to(torch.int32),
                torch.cat([chars.new_zeros(1), chars]))

    def bucket_table():
        u_sorted, ends = sorted_block()
        return psi_table(u_sorted), ends

    def pairs5_table():
        u_sorted, ends = sorted_block()
        psi2 = torch.empty(n + 1, dtype=torch.int32, device=dev)
        c2 = torch.empty(n + 1, dtype=torch.uint8, device=dev)
        _ok(lib.pairs_table_launch(u_sorted.data_ptr(), 0, n, primary,
                                   ends.data_ptr(), 0, psi2.data_ptr(),
                                   c2.data_ptr(), handle),
            "pairs_table_launch")
        return psi2, c2, ends

    def pairs8_psi_table():
        u_sorted, ends = sorted_block()
        psi = psi_table(u_sorted)
        del u_sorted
        pairs = torch.empty(n + 1, dtype=torch.int64, device=dev)
        _ok(lib.pairs_table_launch(0, psi.data_ptr(), n, primary,
                                   ends.data_ptr(), pairs.data_ptr(), 0, 0,
                                   handle), "pairs_table_launch")
        return pairs, ends

    def package(t):
        return lambda h, m: bwt.chase(t[0], t[1], h, r, m)

    # name -> (table build, its chase, the start rows' dtype, loads a chain)
    table_fns = {
        "packed": (lambda: _packed_table(u_d, primary),
                   lambda t: launch("packed_chase_launch", t), starts64, r),
        "split": (split_table,
                  lambda t: launch("psi_chase_launch", t[0], t[1], None),
                  starts32, r),
    }
    if not only_old:
        table_fns.update({
            "bucket": (bucket_table,
                       lambda t: launch("psi_chase_launch", t[0], None,
                                        t[1]), starts32, r),
            "pairs8": (lambda: bwt.chase_inputs(u_d, primary, aux)[:2],
                       package, starts32, r // 2),
            "pairs5": (pairs5_table,
                       lambda t: launch("pairs5_chase_launch", *t),
                       starts32, r // 2),
            "pairs8_psi": (pairs8_psi_table, package, starts32, r // 2),
        })
    res = {}
    for name, (table, chase_of, heads, loads) in table_fns.items():
        # each design starts from the same allocator state, so that its
        # warm-up call, not a timed one, takes the device allocations
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t = table()
        chase = chase_of(t)
        row = {"table_ms": CS.cuda_ms(table, REPS),
               "chase_ms": CS.cuda_ms(lambda: chase(heads, n), REPS),
               "loads": loads}
        if chase(heads, n).cpu().numpy().tobytes() != lz.tobytes():
            raise SystemExit(f"K8 design {name}: the chase does not restore "
                             "the block")
        row["latency_floor_ms"] = CS.chase_latency(chase, heads, r, n, lz)
        res[name] = row
        del t, chase
        print(f"K8 design {name}: table {row['table_ms']:.4f} ms, chase "
              f"{row['chase_ms']:.4f} ms, both "
              f"{row['table_ms'] + row['chase_ms']:.4f} ms; one chain alone "
              f"{row['latency_floor_ms']:.4f} ms ({loads} dependent loads, "
              f"{row['latency_floor_ms'] * 1e6 / loads:.0f} ns a load)",
              flush=True)
    if not only_old:
        u_sorted, ends = sorted_block()
        res["psi_kernel_ms"] = CS.cuda_ms(lambda: psi_table(u_sorted), REPS)
        res["pair_kernel_ms"] = CS.cuda_ms(
            lambda: bwt.pair_table(u_sorted, primary, ends), REPS)
        print(f"K8 table kernels alone: the package's two-step table "
              f"{res['pair_kernel_ms']:.4f} ms, the u32 PSI table "
              f"{res['psi_kernel_ms']:.4f} ms", flush=True)
    return {"chains": chains, "rate": r, **res}


def run(u_d, primary: int, aux, r: int, lz, out_dir: Path,
        only_old: bool = False) -> dict:
    """Step 0 and the designs on one block (u8 on the card, its primary,
    its aux indexes on the card, its rate, the bytes the chase must
    give)."""
    lib = build(out_dir)
    return {"step0": step0(u_d, primary),
            "designs": designs(lib, u_d, primary, aux, r, lz, only_old)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch import engine, native
    from libbsc_tpu_torch.ops import bwt

    native.load()
    dev = torch.device("cuda", 0)
    data = CS.make_corpus(CS.BLOCK)
    lz = engine.lzp_compress(np.frombuffer(data, np.uint8),
                             C.DEFAULT_LZPHASHSIZE, C.DEFAULT_LZPMINLEN,
                             C.FEATURE_FASTMODE)
    if lz is None:  # LZP does not pay: the block goes on unchanged
        lz = np.frombuffer(data, np.uint8).copy()
    r = engine.wideaux_rate(len(lz))
    U, primary, aux = bwt.bwt_encode_wideaux_device(
        torch.from_numpy(lz).to(dev), r)
    out_dir = ROOT / "libbsc_tpu_torch" / "_build" / "chase_variants"
    result = {"card": CS.smi(), "bytes": len(lz),
              **run(U, int(primary), aux, r, lz, out_dir,
                    only_old="--step0" in sys.argv[1:])}
    (out_dir / "variants.json").write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
