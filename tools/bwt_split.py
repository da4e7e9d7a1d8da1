#!/usr/bin/env python3
"""Where the device BWT's time goes, part by part (CUDA).

    python3 tools/bwt_split.py                  # this checkout
    python3 tools/bwt_split.py TREE [TREE ...]  # each tree, in turns

A tree is a directory that holds ``libbsc_tpu_torch`` (an unpacked
``git archive`` of some commit, say).  Each tree runs in a fresh process
of its own on cuda:0, in the order given (parent, change, change, parent
compares two commits), and drives that tree's ``ops/bwt`` forward
transform, ``suffix_array``'s rounds and the extraction of U, the primary
and the aux indexes at the wide-aux rate (``engine.wideaux_rate``), step
by step, with a CUDA event between every two parts, on three blocks:

- ``corpus``: the first 25 MiB block of the bench corpus
  (``chip_smoke.make_corpus``, seed 0xB5C; its LZP is rejected on the
  main path, so the BWT sorts the raw block);
- ``zeros``: 4 MiB of zero bytes (a round for every quadrupling of the
  depth, each over nearly every position);
- ``periodic``: 4 MiB of ``abcd`` repeated.

Each round (``boot``, ``full``, ``compact``) reports its parts in ms:

- a tree whose rounds are torch ops (up to PR 13): ``keys`` (the key
  build: ``_shifted`` and the packing), ``sort1``, ``gather`` (the high
  key into the first sort's order), ``sort2``, ``perm`` (the permutation
  composed), ``key_gather`` (the sorted keys), ``heads``, ``where`` (the
  head positions, input of the cummax), ``cummax`` (and ``cummax2`` in a
  compact round, each alone), ``scatter`` (ranks and mask, or the compact
  round's ranks), ``count`` (``mask.sum()``, or the compact round's
  boolean selection of the still-unresolved positions, which syncs);
- a tree with the sort's kernels (``bwt_sort.cu``): ``keys`` (K11 or
  K12), ``sort1``, ``gather`` (up to 34e0e9c; since, ``pay``: K13's
  pre-pass, which took the gather over), ``sort2``, ``heads`` (K13's
  main pass: heads, the group-start scan, the rank scatter, the mask or
  the list, and the count);

then ``host_read`` (the unresolved count read by the host, after a
synchronize, host clock) and ``unresolved``.  ``nonzero`` is the switch
from full to compact rounds (``torch.nonzero`` of the mask, or with the
pre-pass the cut of the unresolved list).  The
extraction reports ``roll``, ``sa_of``, ``gather`` and ``rest`` (torch
ops), or ``extract`` (K14 up to 34e0e9c), or ``bins`` and ``place``
(K14's two passes); a torch tree's ``suffix_array`` also builds a
suffix array that the BWT routes do not use (``sa_unused``).

Each block is first sorted twice by the tree's own
``bwt_encode_wideaux_device`` (``total``, CUDA events; the first call
builds the kernels and is not reported), and the split's ranks and bytes
must equal that call's; then the split runs ``REPEATS`` times, with the
peak device memory of the tree's own call.  Prints ``bwt split <tree>
<block>:`` lines (the best of the repeats, part by part) and writes the
whole JSON to ``chiprun_out/bwt_split.json`` (one object per tree).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 25 << 20
SMALL = 4 << 20
REPEATS = 2
OUT = os.path.join(ROOT, "chiprun_out", "bwt_split.json")


class Clock:
    """Marks between parts: CUDA events on the card, the host clock on the
    CPU (where only the control flow is rehearsed, no time)."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = device.type == "cuda"
        self.marks = []

    def _now(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [(None, self._now())]

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def read(self) -> dict:
        """Part -> ms since the start, summed by name; synchronizes."""
        if self.cuda:
            self.torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out

    def host(self, fn):
        """(fn(), its host ms), after a synchronize."""
        if self.cuda:
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = fn()
        return v, (time.perf_counter() - t0) * 1e3


def _torch_sort_rank(bw, k_hi, k_lo, n: int, clock: Clock):
    """The torch tree's ``_lex_order`` + ``_heads`` +
    ``_rank_mask_to_position_order``, part by part."""
    import torch

    o1 = torch.sort(k_lo, stable=True).indices
    clock.mark("sort1")
    g = k_hi[o1]
    clock.mark("gather")
    o2 = torch.sort(g, stable=True).indices
    clock.mark("sort2")
    pos_s = o1[o2]
    clock.mark("perm")
    hs, ls = k_hi[pos_s], k_lo[pos_s]
    clock.mark("key_gather")
    heads = bw._heads(hs, ls)
    clock.mark("heads")
    pos = torch.arange(n, device=heads.device)
    w = torch.where(heads, pos, -1)
    clock.mark("where")
    gstart = torch.cummax(w, 0).values
    clock.mark("cummax")
    nxt_head = torch.ones_like(heads)
    nxt_head[:-1] = heads[1:]
    rank = torch.empty(n, dtype=torch.int64, device=heads.device)
    rank[pos_s] = gstart
    mask = torch.empty(n, dtype=torch.bool, device=heads.device)
    mask[pos_s] = ~(heads & nxt_head)
    clock.mark("scatter")
    return rank, mask


def _sorted(k_hi, k_lo, clock: Clock):
    import torch

    o1 = torch.sort(k_lo, stable=True).indices
    clock.mark("sort1")
    g = k_hi[o1]
    clock.mark("gather")
    hi_s, o2 = torch.sort(g, stable=True)
    clock.mark("sort2")
    return hi_s, o1, o2


def torch_rounds(bw, data, clock: Clock):
    """A torch tree's ``suffix_array`` (up to PR 13), part by part.
    Returns (rank, rounds)."""
    import torch

    n = data.shape[0]
    dev = data.device
    rounds = []

    def close(name, cnt_fn, k):
        parts = clock.read()
        cnt, parts["host_read"] = clock.host(cnt_fn)
        rounds.append({"round": name, "k": k, "parts": parts,
                       "unresolved": cnt})
        return cnt

    clock.start()
    idx = torch.arange(n, device=dev)
    d = data.long()
    words = []
    for w in range(3):
        acc = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(4):
            acc = (acc << 8) | bw._shifted(d, 4 * w + j, 0)
        words.append(acc)
    rem = torch.clamp(n - idx, 1, bw._BOOT_DEPTH)
    w3 = (((bw._shifted(d, 12, 0) << 8 | bw._shifted(d, 13, 0)) << 8
           | bw._shifted(d, 14, 0)) << 8) | rem
    k_hi = bw._pair_key(words[0], words[1], -(1 << 31))
    k_lo = bw._pair_key(words[2], w3, -(1 << 31))
    del words, w3, rem, d, idx
    clock.mark("keys")
    rank, mask = _torch_sort_rank(bw, k_hi, k_lo, n, clock)
    del k_hi, k_lo
    cnt_t = mask.sum()
    clock.mark("count")
    cnt = close("boot", lambda: int(cnt_t), bw._BOOT_DEPTH)

    k = bw._BOOT_DEPTH
    m1 = min(n, max(4096, n // 4))
    while cnt > m1 and k < 2 * n:
        clock.start()
        key_a, key_b = bw._round_keys(rank, bw._shifted(rank, k, -1),
                                      bw._shifted(rank, 2 * k, -1),
                                      bw._shifted(rank, 3 * k, -1))
        clock.mark("keys")
        rank, mask = _torch_sort_rank(bw, key_a, key_b, n, clock)
        del key_a, key_b
        cnt_t = mask.sum()
        clock.mark("count")
        cnt = close("full", lambda: int(cnt_t), k)
        k *= 4
    clock.start()
    uidx = torch.nonzero(mask)[:, 0]
    clock.mark("nonzero")
    rounds.append({"round": "nonzero", "parts": clock.read()})
    while uidx.numel() > 0 and k < 2 * n:
        clock.start()
        r1 = rank[uidx]

        def cont(off, uidx=uidx):
            j = uidx + off
            return torch.where(j < n, rank[j.clamp(max=n - 1)], -1)

        key_a, key_b = bw._round_keys(r1, cont(k), cont(2 * k),
                                      cont(3 * k))
        clock.mark("keys")
        o1 = torch.sort(key_b, stable=True).indices
        clock.mark("sort1")
        g = key_a[o1]
        clock.mark("gather")
        o2 = torch.sort(g, stable=True).indices
        clock.mark("sort2")
        perm = o1[o2]
        clock.mark("perm")
        r1s, ka, kb = r1[perm], key_a[perm], key_b[perm]
        clock.mark("key_gather")
        h1 = bw._heads(r1s)
        hall = bw._heads(ka, kb)
        clock.mark("heads")
        pos = torch.arange(uidx.shape[0], device=dev)
        w1 = torch.where(h1, pos, -1)
        wall = torch.where(hall, pos, -1)
        clock.mark("where")
        s1 = torch.cummax(w1, 0).values
        clock.mark("cummax")
        sall = torch.cummax(wall, 0).values
        clock.mark("cummax2")
        uidx_s = uidx[perm]
        rank[uidx_s] = r1s + (sall - s1)
        clock.mark("scatter")
        nxt = torch.ones_like(hall)
        nxt[:-1] = hall[1:]
        uidx = uidx_s[~(hall & nxt)]
        clock.mark("count")
        close("compact", lambda: int(uidx.numel()), k)
        k *= 4
    clock.start()
    bw._sa_of(rank)
    clock.mark("sa_unused")
    rounds.append({"round": "suffix_array", "parts": clock.read()})
    return rank, rounds


def _sorted_pay(bw, k_hi, k_lo, clock: Clock, uidx=None):
    """A tree with K13's pre-pass: the first sort, the pre-pass, the
    second sort."""
    import torch

    lo_s, o1 = torch.sort(k_lo, stable=True)
    clock.mark("sort1")
    hi1, pay = bw.heads_pay(lo_s, o1, k_hi, uidx)
    clock.mark("pay")
    del lo_s, o1
    hi_s, o2 = torch.sort(hi1, stable=True)
    clock.mark("sort2")
    return hi_s, pay, o2


def kernel_rounds(bw, data, clock: Clock):
    """A tree with the sort's kernels (K11-K13), part by part: up to
    34e0e9c the gather between the two sorts was torch's and K13 one
    launch; since, K13's pre-pass takes the gather's place.  Returns
    (rank, rounds)."""
    import torch

    n = data.shape[0]
    rounds = []
    pay = hasattr(bw, "heads_pay")

    def close(name, cnt_t, k):
        parts = clock.read()
        cnt, parts["host_read"] = clock.host(lambda: int(cnt_t))
        rounds.append({"round": name, "k": k, "parts": parts,
                       "unresolved": cnt})
        return cnt

    def full(k_hi, k_lo):
        if pay:
            out = bw.heads_full(*_sorted_pay(bw, k_hi, k_lo, clock))
        else:
            hi_s, o1, o2 = _sorted(k_hi, k_lo, clock)
            out = bw.heads_full(hi_s, k_lo, o1, o2)
        clock.mark("heads")
        return out

    clock.start()
    k_hi, k_lo = bw.boot_keys(data)
    clock.mark("keys")
    rank, left, cnt_t = full(k_hi, k_lo)
    del k_hi, k_lo
    cnt = close("boot", cnt_t, bw._BOOT_DEPTH)

    k = bw._BOOT_DEPTH
    m1 = min(n, max(4096, n // 4))
    while cnt > m1 and k < 2 * n:
        clock.start()
        key_a, key_b = bw.round_keys(rank, k)
        clock.mark("keys")
        rank, left, cnt_t = full(key_a, key_b)
        del key_a, key_b
        cnt = close("full", cnt_t, k)
        k *= 4
    clock.start()
    # since 34e0e9c the full form returns the list; before, the mask
    uidx = left[:cnt] if pay else torch.nonzero(left)[:, 0]
    clock.mark("nonzero")
    rounds.append({"round": "nonzero", "parts": clock.read()})
    while uidx.numel() > 0 and k < 2 * n:
        clock.start()
        key_a, key_b = bw.round_keys(rank, k, uidx)
        clock.mark("keys")
        if pay:
            still, cnt_t = bw.heads_compact(
                *_sorted_pay(bw, key_a, key_b, clock, uidx), rank)
        else:
            hi_s, o1, o2 = _sorted(key_a, key_b, clock)
            still, cnt_t = bw.heads_compact(hi_s, key_b, o1, o2, uidx, rank)
        clock.mark("heads")
        uidx = still[:close("compact", cnt_t, k)]
        k *= 4
    return rank, rounds


def torch_extract(bw, data, rank, r: int, clock: Clock):
    import torch

    n = data.shape[0]
    clock.start()
    rolled = torch.roll(data, 1)
    clock.mark("roll")
    sa = bw._sa_of(rank)
    clock.mark("sa_of")
    A = rolled[sa]
    clock.mark("gather")
    r0 = rank[0]
    w = torch.arange(n, device=data.device)
    U = torch.where(w <= r0, torch.roll(A, 1), A)
    U[0] = A[r0]
    aux = rank[(torch.arange((n - 1) // r, device=data.device) + 1) * r]
    out = (U, r0 + 1, aux.to(torch.int32))
    clock.mark("rest")
    return out, clock.read()


def kernel_extract(bw, data, rank, r: int, clock: Clock):
    """K14 as one launch (up to 34e0e9c), or its two passes apart."""
    clock.start()
    if hasattr(bw, "extract_bins"):
        stage, primary, aux = bw.extract_bins(data, rank, r)
        clock.mark("bins")
        out = (bw.extract_place(stage), primary, aux)
        clock.mark("place")
    else:
        out = bw.extract(data, rank, r)
        clock.mark("extract")
    return out, clock.read()


def split_block(bw, data, r: int, clock: Clock) -> dict:
    """One split of ``data`` by the tree module ``bw``: the rounds and the
    extraction, each part in ms, and the ranks and outputs to check."""
    kernels = hasattr(bw, "heads_full")
    rank, rounds = (kernel_rounds if kernels else torch_rounds)(
        bw, data, clock)
    out, ext = (kernel_extract if kernels else torch_extract)(
        bw, data, rank, r, clock)
    return {"route": "kernels" if kernels else "torch", "rounds": rounds,
            "extract": ext, "rank": rank, "out": out}


def blocks() -> dict:
    import numpy as np

    sys.path.insert(0, ROOT)
    from chip_smoke import make_corpus

    return {"corpus": np.frombuffer(make_corpus(BLOCK), np.uint8),
            "zeros": np.zeros(SMALL, np.uint8),
            "periodic": np.frombuffer((b"abcd" * (SMALL // 4)), np.uint8)}


def split(tree: str) -> dict:
    """The split of one tree on the three blocks, in this process (the
    tree is imported first on the path)."""
    sys.path.insert(0, tree)
    import torch

    from libbsc_tpu_torch import engine
    from libbsc_tpu_torch.ops import bwt as bw

    if not torch.cuda.is_available():
        raise SystemExit("bwt_split needs a CUDA device")
    dev = torch.device("cuda", 0)
    res = {"tree": tree, "blocks": {}}
    for name, block in blocks().items():
        data = torch.from_numpy(block.copy()).to(dev)
        n = data.shape[0]
        r = engine.wideaux_rate(n)
        ref = bw.bwt_encode_wideaux_device(data, r)  # builds the kernels
        torch.cuda.synchronize()
        total = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            clock = Clock(dev)
            clock.start()
            ref = bw.bwt_encode_wideaux_device(data, r)
            clock.mark("total")
            total.append(clock.read()["total"])
        peak = torch.cuda.max_memory_allocated()
        splits = []
        for _ in range(REPEATS):
            s = split_block(bw, data, r, Clock(dev))
            U, primary, aux = s.pop("out")
            if not (torch.equal(U, ref[0]) and int(primary) == int(ref[1])
                    and torch.equal(aux, ref[2])):
                raise SystemExit(f"{tree} {name}: the split's BWT differs "
                                 "from bwt_encode_wideaux_device's")
            del s["rank"]
            splits.append(s)
        res["blocks"][name] = {"n": n, "r": r, "total_ms": total,
                               "peak_bytes": peak, "splits": splits}
        del data, ref
        torch.cuda.empty_cache()
    return res


def summary(b: dict) -> str:
    """One block's split: the total, then each round's parts, the best of
    the repeats."""
    first, *rest = b["splits"]

    def best(i, key):
        vals = [s["rounds"][i]["parts"][key] for s in b["splits"]]
        return min(vals)

    parts = []
    for i, rd in enumerate(first["rounds"]):
        ps = " ".join(f"{k} {best(i, k):.3f}" for k in rd["parts"])
        tot = sum(best(i, k) for k in rd["parts"])
        un = f", unresolved {rd['unresolved']}" if "unresolved" in rd else ""
        parts.append(f"[{rd['round']}{un}: {tot:.2f} ms = {ps}]")
    ext = " ".join(
        f"{k} {min(s['extract'][k] for s in b['splits']):.3f}"
        for k in first["extract"])
    return (f"n {b['n']}, route {first['route']}, total "
            f"{'/'.join(f'{t:.2f}' for t in b['total_ms'])} ms, peak "
            f"{b['peak_bytes']} B; " + " ".join(parts)
            + f" [extract: {ext}]")


def main(argv: list) -> int:
    if argv[:1] == ["--tree"]:
        print("BWTSPLIT " + json.dumps(split(os.path.abspath(argv[1]))),
              flush=True)
        return 0
    code = 0
    results = []
    for tree in argv or [ROOT]:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--tree", tree],
            capture_output=True, text=True, timeout=900)
        lines = [ln[9:] for ln in out.stdout.splitlines()
                 if ln.startswith("BWTSPLIT ")]
        if out.returncode != 0 or not lines:
            print(f"bwt split {tree}: FAILED (exit {out.returncode})\n"
                  f"{out.stdout[-2000:]}{out.stderr[-4000:]}",
                  file=sys.stderr)
            code = 1
            continue
        res = json.loads(lines[0])
        results.append(res)
        for name, b in res["blocks"].items():
            print(f"bwt split {tree} {name}: {summary(b)}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f)
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
