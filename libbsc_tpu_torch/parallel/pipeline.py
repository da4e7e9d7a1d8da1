"""The sharded block-transform step over a (dp, sp) grid of devices.

Counterpart of the JAX package's ``parallel/pipeline.py``, and, like the
JAX mesh it replaces, single-controller: one process drives a ``dp x sp``
grid of ``torch.device``s.

  dp - data parallel over independent blocks: row d of the grid holds
       blocks [d B/dp, (d+1) B/dp) of a [B, n] batch.
  sp - sequence parallel within a block: member s of a row holds bytes
       [s n/sp, (s+1) n/sp) of each of the row's blocks.

:func:`shard` lays a batch out so (the ``device_put`` with
``P('dp', 'sp')``); :func:`unshard` assembles a step's outputs.  The step
(:func:`make_transform_step`) runs the JAX step's two stages:
  1. content statistics: each member takes the histogram of its shard on
     its own device, with K6 (``ops/stats_kernels.byte_histogram``) when
     the shard holds at least ``_HIST_TILE`` bytes and ``torch.bincount``
     below that, the JAX package's condition; the row's sum of its
     members' histograms, on the row's first device, is the ``psum`` over
     sp;
  2. the row's shards are concatenated on its first device (the
     ``all_gather`` over sp), each full block is sorted there once (ST-k
     or BWT), and each member gets its part of the output on its own
     device.  Under ``shard_map`` every member sorts the whole row,
     because every device runs the same program; one controller sorts it
     once.
The rows are driven one after another from this process.

:func:`make_sharded_st_step` is the other step: ST-k of each block sorted
where it lies, a sample sort over the sp members with no gather of the
block (see its docstring).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import bwt as opsbwt
from ..ops import st as opsst
from ..ops.stats_kernels import _HIST_TILE, byte_histogram


@dataclass(frozen=True)
class Mesh:
    """A dp x sp grid of devices: ``devices[d][s]``."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, devices=None) -> Mesh:
    """A (dp, sp) mesh over the first ``n_devices`` of ``devices`` (default:
    the CUDA devices).  Raises when there are too few; it never takes the
    CPU in their place (pass ``devices=[torch.device("cpu")] * n`` to run
    the plain versions on the CPU)."""
    if devices is None:
        have = torch.cuda.device_count()
        if n_devices is None:
            n_devices = have
        if n_devices < 1 or have < n_devices:
            raise ValueError(f"need {n_devices} CUDA devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
    if dp is None and sp is None:
        sp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
        dp = n_devices // sp
    elif dp is None:
        dp = n_devices // sp
    elif sp is None:
        sp = n_devices // dp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp={dp * sp} != n_devices={n_devices}")
    return Mesh(tuple(tuple(devices[d * sp:(d + 1) * sp])
                      for d in range(dp)))


def shard(blocks: torch.Tensor, mesh: Mesh) -> list:
    """A [B, n] batch as the grid ``[d][s]`` of contiguous
    [B/dp, n/sp] shards, each on its mesh device."""
    b, n = blocks.shape
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if b % dp or n % sp:
        raise ValueError(f"a [{b}, {n}] batch does not split over a "
                         f"({dp}, {sp}) mesh")
    bl, nl = b // dp, n // sp
    return [[blocks[d * bl:(d + 1) * bl, s * nl:(s + 1) * nl]
             .to(dev).contiguous() for s, dev in enumerate(row)]
            for d, row in enumerate(mesh.devices)]


def unshard(parts: list, device="cpu") -> torch.Tensor:
    """Assemble a step output on ``device``: a grid ``[d][s]`` (members
    joined along the bytes, rows along the blocks) or a list ``[d]`` of
    per-row tensors (rows joined)."""
    rows = [torch.cat([p.to(device) for p in r], 1)
            if isinstance(r, (list, tuple)) else r.to(device) for r in parts]
    return torch.cat(rows, 0)


def batch_st_encode(blocks: torch.Tensor, k: int):
    """Forward ST-k of each row of a [B, n] batch: (u8 [B, n],
    index i32 [B])."""
    outs = [opsst.st_encode(b, k) for b in blocks]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([i.to(torch.int32) for _, i in outs]))


def batch_bwt_encode(blocks: torch.Tensor):
    """Forward BWT of each row of a [B, n] batch: (u8 [B, n],
    primary i32 [B], aux i32 [B, (n-1)//aux_rate(n)])."""
    outs = [opsbwt.bwt_encode(b) for b in blocks]
    return (torch.stack([u for u, _, _ in outs]),
            torch.stack([p.to(torch.int32) for _, p, _ in outs]),
            torch.stack([a for _, _, a in outs]))


def _histograms(x: torch.Tensor) -> torch.Tensor:
    """int32 [B_local, 256]: the byte histogram of each row of a shard."""
    b_local, n_local = x.shape
    if n_local >= _HIST_TILE:
        return torch.stack([byte_histogram(row) for row in x])
    offset = 256 * torch.arange(b_local, device=x.device)[:, None]
    return torch.bincount((x.long() + offset).reshape(-1),
                          minlength=256 * b_local).view(b_local, 256) \
        .to(torch.int32)


def make_transform_step(mesh: Mesh, sorter: str = "st", k: int = 5):
    """The sharded transform step.  It takes the grid of :func:`shard` and
    returns (transformed shards, grid ``[d][s]`` of u8 [B/dp, n/sp]; the
    sort index of each block, list ``[d]`` of i32 [B/dp]; the byte
    histogram of each block, list ``[d]`` of i32 [B/dp, 256]), the
    per-row outputs on the row's first device."""
    if sorter not in ("st", "bwt"):
        raise ValueError(sorter)

    def sort(full: torch.Tensor):
        if sorter == "st":
            return batch_st_encode(full, k)
        out, idx, _aux = batch_bwt_encode(full)
        return out, idx

    def step(grid: list):
        out_grid, idx_rows, hist_rows = [], [], []
        for row in grid:
            head = row[0].device
            n_local = row[0].shape[1]
            # stage 1: each member's histograms, summed over the row
            hists = [_histograms(x) for x in row]
            hist_rows.append(torch.stack([h.to(head) for h in hists])
                             .sum(0, dtype=torch.int32))
            # stage 2: gather the full blocks on the head, sort them once,
            # hand each member its part
            out, idx = sort(torch.cat([y.to(head) for y in row], 1))
            idx_rows.append(idx)
            out_grid.append([out[:, s * n_local:(s + 1) * n_local]
                             .to(x.device).contiguous()
                             for s, x in enumerate(row)])
        return out_grid, idx_rows, hist_rows

    return step


# ---------------------------------------------------------------------------
# ST-k of one block sharded over sp: a sample sort
# ---------------------------------------------------------------------------

_HASH = 2654435761  # the multiplicative hash of the JAX step's deal


def _sample_positions(nl: int, n_samples: int) -> list:
    """Each member's sample positions within its shard: one per stride
    cell, at a fixed pseudo-random offset in the cell, so a periodic block
    whose period divides the stride does not put every sample in one
    context class."""
    r = min(n_samples, nl)
    cell = max(1, nl // r)
    return [min((j * nl) // r + (j * _HASH) % cell, nl - 1)
            for j in range(r)]


def _shard_keys(ext: torch.Tensor, k: int) -> torch.Tensor:
    """int64 context keys of the nl = len(ext) - 8 positions of a shard
    extended by the next member's first 8 bytes: bytes 0..k-1 packed
    big-endian from bit 56 down, the sign bit flipped, so the signed order
    is the unsigned order of the JAX step's (hi, lo) pair."""
    nl = ext.shape[0] - 8
    d = ext.long()
    key = torch.zeros(nl, dtype=torch.int64, device=ext.device)
    for j in range(k):
        key |= d[j:j + nl] << (56 - 8 * j)
    return key ^ opsst._SIGN


def make_sharded_st_step(mesh: Mesh, k: int = 8, n_samples: int = 128,
                         slack_frac: int = 4):
    """ST-k of each block sorted where its shards lie: a sample sort over
    the sp members of each row, with no gather of the block.

    It takes the grid of :func:`shard` and returns (transformed shards,
    grid ``[d][s]`` of u8 [B/dp, n/sp] on the members' devices; the index
    of each block, list ``[d]`` of i32 [B/dp] on the row's first device;
    ``ok``, list ``[d]`` of bool [B/dp]).  Output and index are those of
    ``ops/st.st_encode`` of the whole block, whatever ``ok`` says.

    Per block, with S members of nl bytes each:
      1. context keys where the shard lies: member s's context wraps into
         member (s+1) mod S's first 8 bytes, its first preceding byte is
         member (s-1) mod S's last;
      2. splitters: every R-th of the S*R (key, global position) pairs
         of the members' R jittered samples each, sorted; the pairs are
         distinct (the position breaks ties), so an all-equal block
         splits by position;
      3. bucket = the number of splitters at or below (key, position);
         each member partitions its positions stably by bucket (one sort
         of the small bucket ids), and one read of the [S, S, S] count
         matrix gives every segment's true size;
      4. member b receives every member's bucket-b segment in member order,
         which is position order, so one stable sort of the key alone gives
         (key, position) order;
      5. member s's output is global ranks [s nl, (s+1) nl) of the sorted
         ranges joined in member order; the index is the rank of position
         0, found by counting the keys below its key in its bucket.

    The JAX step pads every exchange to a fixed capacity, as XLA needs
    static shapes, first deals the positions to members by a hash of the
    position so the capacities hold, and rebalances the output by edge
    windows.  One controller sends each segment at its own size instead,
    so none of that data moves here; ``ok`` still reports whether the JAX
    step's capacities would hold (deal cells ``nl//S + max(64,
    nl//(4S))``, buckets ``nl//S + nl//slack_frac``, edge windows of the
    bucket capacity), computed from the counts, so a caller that falls
    back to :func:`make_transform_step` on ``ok == False`` does so in both
    packages alike."""
    S = mesh.shape["sp"]
    opsst._check_k(k)

    def one_block(xs: list):
        """xs: this block's S shards, u8 [nl] each on its member's device.
        Returns (the S output shards, index 0-dim i32 on member 0's
        device, ok)."""
        nl = xs[0].shape[0]
        if nl < 8:
            raise ValueError(f"sharded ST needs shards of 8 bytes or more, "
                             f"got {nl}")
        devs = [x.device for x in xs]
        head = devs[0]
        spos = _sample_positions(nl, n_samples)
        keys, prevs, gposs = [], [], []
        for s, x in enumerate(xs):
            nxt, prv = xs[(s + 1) % S], xs[(s - 1) % S]
            keys.append(_shard_keys(torch.cat([x, nxt[:8].to(x.device)]), k))
            prevs.append(torch.cat([prv[-1:].to(x.device), x[:-1]]))
            gposs.append(torch.arange(s * nl, (s + 1) * nl,
                                      device=x.device))
        # splitters, on the head
        sp_at = torch.tensor(spos, device=head)
        s_key = torch.cat([kk[sp_at.to(kk.device)].to(head) for kk in keys])
        s_gp = torch.cat([g[sp_at.to(g.device)].to(head) for g in gposs])
        order = opsbwt._lex_order(s_key, s_gp)
        q = torch.tensor([(t + 1) * len(spos) for t in range(S - 1)],
                         dtype=torch.long, device=head)
        sp_key, sp_gp = s_key[order][q], s_gp[order][q]
        # buckets, deal cells and the stable partition, where the data lie
        parts, cells, buckets = [], [], []
        for s in range(S):
            key, gpos = keys[s], gposs[s]
            a, c = sp_key.to(devs[s]), sp_gp.to(devs[s])
            bucket = torch.zeros(nl, dtype=torch.int16, device=devs[s])
            for t in range(S - 1):
                bucket += ((key > a[t]) | ((key == a[t]) & (gpos >= c[t])))
            deal = (((gpos * _HASH) & 0xFFFFFFFF) >> 16) % S
            cells.append(torch.bincount(deal * S + bucket, minlength=S * S)
                         .to(head))
            perm = torch.sort(bucket, stable=True).indices
            parts.append((key[perm], prevs[s][perm]))
            buckets.append(bucket)
        # the one read: [source, deal cell, bucket] counts and position 0's
        # bucket
        got = torch.cat(cells + [buckets[0][:1].long().to(head)]).tolist()
        cnt3 = np.asarray(got[:-1], dtype=np.int64).reshape(S, S, S)
        b0 = got[-1]
        seg = cnt3.sum(1)                    # [source, bucket]
        seg_off = (np.cumsum(seg, 1) - seg).tolist()
        cnt = seg.sum(0)                     # elements of each bucket
        offs = np.cumsum(cnt) - cnt
        me = np.arange(S) * nl
        cap = nl // S + nl // slack_frac
        ok = bool(cnt3.sum(2).max() <= nl // S + max(64, nl // (4 * S))
                  and cnt3.sum(0).max() <= cap
                  and np.all(offs - me < cap)
                  and np.all(me + nl - offs - cnt < cap))
        seg, cnt, offs = seg.tolist(), cnt.tolist(), offs.tolist()
        # exchange and sort each bucket on its member
        ranges = []
        for b in range(S):
            cut = [slice(seg_off[s][b], seg_off[s][b] + seg[s][b])
                   for s in range(S)]
            kb = torch.cat([parts[s][0][cut[s]].to(devs[b])
                            for s in range(S)])
            pb = torch.cat([parts[s][1][cut[s]].to(devs[b])
                            for s in range(S)])
            o = torch.sort(kb, stable=True).indices
            ranges.append(pb[o])
            if b == b0:  # position 0 sorts first among its equal keys
                index = (offs[b] + (kb < keys[0][0].to(devs[b])).sum()) \
                    .to(torch.int32).to(head)
        # member s takes global ranks [s nl, (s+1) nl)
        outs = []
        for s in range(S):
            lo, hi = s * nl, (s + 1) * nl
            pieces = [ranges[b][max(lo, offs[b]) - offs[b]:
                                min(hi, offs[b] + cnt[b]) - offs[b]]
                      .to(devs[s]) for b in range(S)
                      if offs[b] < hi and offs[b] + cnt[b] > lo]
            outs.append(torch.cat(pieces))
        return outs, index, ok

    def step(grid: list):
        out_grid, idx_rows, ok_rows = [], [], []
        for row in grid:
            head = row[0].device
            res = [one_block([x[b] for x in row])
                   for b in range(row[0].shape[0])]
            out_grid.append([torch.stack([r[0][s] for r in res])
                             for s in range(S)])
            idx_rows.append(torch.stack([r[1] for r in res]))
            ok_rows.append(torch.full((len(res),),
                                      all(r[2] for r in res),
                                      dtype=torch.bool, device=head))
        return out_grid, idx_rows, ok_rows

    return step
