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
"""

from __future__ import annotations

from dataclasses import dataclass

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
