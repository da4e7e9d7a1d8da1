"""K16: the default format's inverse BWT on the card, by a ruling-set
chase (``csrc/unbwt_rulers.cu``, whose note gives the design).

One stable sort of the BWT's chars (``torch.sort``) and the 256 bucket
ends (:func:`bwt.bucket_ends`), then four steps, each a kernel for a CUDA
tensor and its plain version (``*_plain``, every chain at once) for a CPU
one:

- :func:`table`: a two-step table of n + 1 int64 that stops at rulers;
- :func:`gaps`: a thread a ruler walks to the next ruler;
- :func:`rank`: pointer doubling over the rulers gives each its output
  offset;
- :func:`write`: a thread a reached ruler walks its gap again and writes
  its chars, and a status word says whether the block was a BWT.

Rulers: one row a tile of ``2**TILE_SHIFT`` rows at a hashed offset (the
kernels' kTileShift), the start rows (the primary, offset 0, and each aux
index + 1, offset t r), and the sentinel row 0, the terminal.  K8 (``ops/bwt.chase``, the wide-aux
profile's chains of known offsets) shares no kernel with it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda
from . import bwt

TILE_SHIFT = 6      # a ruler a 64 rows: the fastest of 6-9 on the H100
MAX_STARTS = 256    # the primary and 255 aux indexes (kMaxStarts)

_SELF = 1 << 40     # row k is a ruler
_NEXT = 1 << 41     # row PSI[k] is a ruler; the low word is PSI[k]
_LOW = 0xFFFFFFFF

LAUNCHES = {"rulers_table": 0, "rulers_gaps": 0, "rulers_rank": 0,
            "rulers_write": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, dev, *args) -> None:
    with torch.cuda.device(dev):
        rc = _cuda.launcher(name)(*args, _cuda.stream_handle(dev))
    _cuda.check(name, rc)
    LAUNCHES[name] += 1


def start_rows(n: int, index: int, aux=None):
    """The start rows, sorted, and their output offsets, as int64 arrays:
    the primary ``index`` (offset 0) and, where ``aux`` is given (the
    format's ``(n - 1) // aux_rate(n)`` indexes), each aux index + 1
    (offset (t + 1) r).  Raises ValueError where they can be no BWT's:
    a primary outside [1, n], an aux index outside [0, n), two starts on
    one row."""
    if not 0 < index <= n:
        raise ValueError(f"BWT primary {index} outside [1, {n}]")
    rows = [index]
    offsets = [0]
    if aux is not None:
        aux = np.asarray(aux, dtype=np.int64)
        r = bwt.aux_rate(n)
        if aux.shape != ((n - 1) // r,) or ((aux < 0) | (aux >= n)).any():
            raise ValueError("aux indexes: (n - 1) // aux_rate(n) of them, "
                             "each in [0, n)")
        rows += (aux + 1).tolist()
        offsets += [(t + 1) * r for t in range(aux.shape[0])]
    rows = np.array(rows, dtype=np.int64)
    if len(rows) > MAX_STARTS or len(np.unique(rows)) != len(rows):
        raise ValueError("start rows: at most 256, no two alike")
    order = np.argsort(rows)
    return rows[order], np.array(offsets, dtype=np.int64)[order]


def tiles_of(n: int) -> int:
    """The tiles of ``2**TILE_SHIFT`` rows over the n + 1 rows."""
    return -(-(n + 1) >> TILE_SHIFT)


def tile_rows(t: torch.Tensor) -> torch.Tensor:
    """Tile t's ruler row (int64), before the checks of
    :func:`is_ruler_plain`: t 2^TILE_SHIFT + the top TILE_SHIFT bits of
    the 32-bit t * 0x9E3779B1."""
    return (t << TILE_SHIFT) + (((t * 0x9E3779B1) & _LOW)
                                >> (32 - TILE_SHIFT))


def is_ruler_plain(k: torch.Tensor, srows: torch.Tensor) -> torch.Tensor:
    return (k == 0) | (tile_rows(k >> TILE_SHIFT) == k) | \
        torch.isin(k, srows)


def node_rows_plain(n: int, srows: torch.Tensor) -> torch.Tensor:
    """The ruler row of every node but the sentinel (int64), 0 where a
    tile has none."""
    k = tile_rows(torch.arange(tiles_of(n), device=srows.device))
    k[(k > n) | torch.isin(k, srows)] = 0
    return torch.cat([k, srows])


def node_of_plain(k: torch.Tensor, srows: torch.Tensor,
                  tiles: int) -> torch.Tensor:
    """The node of each ruler row in ``k``."""
    j = torch.searchsorted(srows, k).clamp(max=srows.shape[0] - 1)
    node = torch.where(srows[j] == k, tiles + j, k >> TILE_SHIFT)
    return torch.where(k == 0, tiles + srows.shape[0], node)


def _check(name: str, **tensors) -> torch.device:
    dev = {t.device for t in tensors.values()}
    if len(dev) != 1 or next(iter(dev)).type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: every input on one CPU or CUDA device")
    for key, t in tensors.items():
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous 1-D tensor")
    return next(iter(dev))


def table(u_sorted: torch.Tensor, index: int, ends: torch.Tensor,
          srows: torch.Tensor) -> torch.Tensor:
    """K16's table, i64 [n + 1]: row k holds, for p = PSI[k], p in the low
    32 bits where p is a ruler (bit 41), else PSI[p]; the first char of
    row p in bits 32-39; bit 40 where k is a ruler.  ``u_sorted`` (int64)
    is the stable sort's indices, ``ends`` the 256 int32 bucket ends,
    ``srows`` the sorted int64 start rows (:func:`start_rows`)."""
    dev = _check("table", u_sorted=u_sorted, ends=ends, srows=srows)
    if u_sorted.dtype != torch.int64 or ends.dtype != torch.int32 or \
            ends.shape != (256,) or srows.dtype != torch.int64 or \
            not 1 <= srows.shape[0] <= MAX_STARTS:
        raise ValueError("table: int64 indices, 256 int32 bucket ends and "
                         "1 to 256 int64 start rows")
    if dev.type == "cpu":
        return table_plain(u_sorted, index, ends, srows)
    n = int(u_sorted.shape[0])
    s32 = srows.to(torch.int32)
    pairs = torch.empty(n + 1, dtype=torch.int64, device=dev)
    _launch("rulers_table", dev, u_sorted.data_ptr(), n, index,
            ends.data_ptr(), s32.data_ptr(), int(srows.shape[0]),
            pairs.data_ptr())
    return pairs


def table_plain(u_sorted, index, ends, srows):
    """K16's table's plain version."""
    psi = bwt.psi_rows(u_sorted, index)
    rows = torch.arange(psi.shape[0], device=psi.device)
    stop = is_ruler_plain(psi, srows)
    low = torch.where(stop, psi, psi[psi])
    return (is_ruler_plain(rows, srows).long() << 40
            | stop.long() << 41
            | bwt.row_chars(ends, psi).long() << 32 | low)


def gaps(pairs: torch.Tensor, n: int, srows: torch.Tensor):
    """K16's first chase: (succ i32 [nodes], gap i64 [nodes]).  Each
    ruler's next ruler (its node) and the rows between, itself included;
    the sentinel and a tile with no ruler point at themselves with gap 0,
    and so does a walk that passes n rows."""
    dev = _check("gaps", pairs=pairs, srows=srows)
    if pairs.dtype != torch.int64 or pairs.shape[0] != n + 1 or \
            srows.dtype != torch.int64 or \
            not 1 <= srows.shape[0] <= MAX_STARTS:
        raise ValueError("gaps: an int64 table of n + 1 rows and 1 to 256 "
                         "int64 start rows")
    if dev.type == "cpu":
        return gaps_plain(pairs, n, srows)
    tiles = tiles_of(n)
    nodes = tiles + int(srows.shape[0]) + 1
    succ = torch.empty(nodes, dtype=torch.int32, device=dev)
    gap = torch.empty(nodes, dtype=torch.int64, device=dev)
    s32 = srows.to(torch.int32)
    _launch("rulers_gaps", dev, pairs.data_ptr(), n, s32.data_ptr(),
            int(srows.shape[0]), tiles, succ.data_ptr(), gap.data_ptr())
    return succ, gap


def gaps_plain(pairs, n, srows):
    """K16's first chase's plain version: every live ruler a step at a
    time."""
    tiles = tiles_of(n)
    rows = node_rows_plain(n, srows)
    nodes = rows.shape[0] + 1
    succ = torch.arange(nodes, device=pairs.device)
    gap = torch.zeros(nodes, dtype=torch.int64, device=pairs.device)
    live = torch.nonzero(rows).flatten()
    k = rows[live]
    g = torch.zeros_like(k)
    while live.numel():
        x = pairs[k]
        met = (g > 0) & (x & _SELF != 0)
        nxt = ~met & (x & _NEXT != 0)
        k = torch.where(met, k, x & _LOW)
        g = g + torch.where(met, 0, torch.where(nxt, 1, 2))
        lost = ~met & ~nxt & (g > n)
        done = met | nxt
        succ[live[done]] = node_of_plain(k[done], srows, tiles)
        gap[live[done]] = g[done]
        keep = ~(done | lost)
        live, k, g = live[keep], k[keep], g[keep]
    return succ.to(torch.int32), gap


def rank(succ: torch.Tensor, gap: torch.Tensor):
    """K16's ranking: (succ i32, dist i64) after ceil(log2 nodes) rounds of
    pointer doubling, each a launch (LAUNCHES counts the rounds the C
    call reports); a node is reached where its succ is the sentinel (the
    last node), at output offset n - dist."""
    dev = _check("rank", succ=succ, gap=gap)
    if succ.dtype != torch.int32 or gap.dtype != torch.int64 or \
            succ.shape != gap.shape:
        raise ValueError("rank: int32 successors and int64 gaps, one a node")
    if dev.type == "cpu":
        return rank_plain(succ, gap)
    nodes = int(succ.shape[0])
    if nodes < 2:
        raise ValueError("rank: the sentinel and at least one start")
    s2 = torch.empty(2 * nodes, dtype=torch.int32, device=dev)
    d2 = torch.empty(2 * nodes, dtype=torch.int64, device=dev)
    rounds = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _cuda.launcher("rulers_rank")(
            succ.data_ptr(), gap.data_ptr(), s2.data_ptr(), d2.data_ptr(),
            nodes, ctypes.byref(rounds), _cuda.stream_handle(dev))
    _cuda.check("rulers_rank", rc)
    LAUNCHES["rulers_rank"] += rounds.value
    lo = ((rounds.value - 1) & 1) * nodes
    return s2[lo: lo + nodes], d2[lo: lo + nodes]


def rank_plain(succ, gap):
    """K16's ranking's plain version."""
    s, d = succ.long(), gap.clone()
    span = 1
    while span < s.shape[0]:
        d = d + d[s]
        s = s[s]
        span <<= 1
    return s.to(torch.int32), d


def write(pairs: torch.Tensor, ends: torch.Tensor, n: int,
          srows: torch.Tensor, offsets: torch.Tensor, succ: torch.Tensor,
          dist: torch.Tensor, gap: torch.Tensor,
          out: torch.Tensor | None = None):
    """K16's second chase: (out u8 [n], status i32 0-dim).  Each reached
    ruler writes the first chars of the rows of its gap from its offset
    into ``out`` (u8 [n]; zeros where not given); the status is 0 exactly
    when every start row is reached at its own ``offsets`` entry (int64,
    in ``srows``' order).  Bytes no reached ruler covers (a non-BWT's)
    are left as they were."""
    if out is None:
        out = torch.zeros(n, dtype=torch.uint8, device=pairs.device)
    dev = _check("write", pairs=pairs, ends=ends, srows=srows,
                 offsets=offsets, succ=succ, dist=dist, gap=gap, out=out)
    if offsets.shape != srows.shape or offsets.dtype != torch.int64 or \
            out.shape != (n,) or out.dtype != torch.uint8:
        raise ValueError("write: an int64 offset a start row, u8 [n] out")
    if dev.type == "cpu":
        return write_plain(pairs, ends, n, srows, offsets, succ, dist, gap,
                           out)
    tiles = tiles_of(n)
    status = torch.empty((), dtype=torch.int32, device=dev)
    s32 = srows.to(torch.int32)
    _launch("rulers_write", dev, pairs.data_ptr(), ends.data_ptr(), n,
            s32.data_ptr(), offsets.data_ptr(), int(srows.shape[0]), tiles,
            succ.data_ptr(), dist.data_ptr(), gap.data_ptr(),
            out.data_ptr(), status.data_ptr())
    return out, status


def write_plain(pairs, ends, n, srows, offsets, succ, dist, gap, out=None):
    """K16's second chase's plain version."""
    tiles = tiles_of(n)
    sentinel = tiles + srows.shape[0]
    pos = n - dist[:sentinel]
    reached = succ[:sentinel].long() == sentinel
    ok = bool((reached[tiles:] & (pos[tiles:] == offsets)).all())
    g = gap[:sentinel]
    live = torch.nonzero(reached & (g > 0) & (pos >= 0)
                         & (pos + g <= n)).flatten()
    k = node_rows_plain(n, srows)[live]
    w, end = pos[live], (pos + g)[live]
    if out is None:
        out = torch.zeros(n, dtype=torch.uint8, device=pairs.device)
    while live.numel():
        x = pairs[k]
        out[w] = bwt.row_chars(ends, k)
        w = w + 1
        more = w < end
        out[w[more]] = (x[more] >> 32).to(torch.uint8)
        w = w + 1
        keep = more & (w < end)
        live, k, w, end = live[keep], (x & _LOW)[keep], w[keep], end[keep]
    return out, torch.tensor(0 if ok else 1, dtype=torch.int32)


def unbwt(T: torch.Tensor, index: int, aux=None):
    """Inverse BWT of u8[n] in the default format by K16: (out u8 [n],
    status i32 0-dim, 0 where the block was a BWT of ``index`` and
    ``aux``).  ``aux`` (host ints, the format's count of them, or None)
    adds the aux indexes as start rows; a start that can be no BWT's
    raises ValueError before any launch (:func:`start_rows`)."""
    bwt._vec("unbwt", T, torch.uint8)
    n = int(T.shape[0])
    dev = T.device
    if n <= 1:
        return T.clone(), torch.zeros((), dtype=torch.int32, device=dev)
    rows, offs = start_rows(n, index, aux)
    srows = torch.from_numpy(rows).to(dev)
    offsets = torch.from_numpy(offs).to(dev)
    chars, u_sorted = torch.sort(T, stable=True)
    ends = bwt.bucket_ends(chars)
    del chars
    pairs = table(u_sorted, index, ends, srows)
    del u_sorted
    succ, gap = gaps(pairs, n, srows)
    succ_r, dist = rank(succ, gap)
    return write(pairs, ends, n, srows, offsets, succ_r, dist, gap)
