"""K15, the LZP screen on the card, with its plain PyTorch version.

Replaces no TPU kernel: it was added to spare the host its LZP attempt
on blocks where LZP cannot pay.  :func:`screen` returns one flag per LZP
part of a block (the split of ``native/lzp.cc`` ``lzp_num_blocks``: 1, 2,
4 or 8 parts, ``n // parts`` bytes each, the remainder in the last).  A
flag is 0 only if no two match-eligible windows of ``min_len`` bytes of
the part have equal fingerprints; the native encoder takes a match only
between two such windows that are equal, so when every flag is 0 its
output is literals alone and ``engine.lzp_compress`` returns None.  A 1
(a repeat, a fingerprint collision, a full bucket) proves nothing.

The function, which the kernel (``csrc/lzp_screen.cu``) and
:func:`screen_plain` both compute: a window starting at g has the key
``mix64(sum_k b[g + k] * BASE**(min_len - 1 - k) mod 2**64) | 1``
(``mix64`` is splitmix64's finalizer); the part's keys fall into
``per_part`` buckets by their high 32 bits; the flag is 1 when a key
occurs twice in the part or a bucket holds more than ``CAP`` keys.

The wrapper launches the kernel for a CUDA tensor, counting the call in
``LAUNCHES`` (one call is two kernels: keys, dedup), and runs the plain
version for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _cuda

BASE = 0x9E3779B97F4A7C15
MEAN = 2048  # keys a bucket the bucket count aims at
CAP = 3072   # keys a bucket holds (csrc kCap): MEAN plus 22 deviations
_STRIDE = 8  # int32 a bucket's cursor (csrc kStride)
_MIX = (0xBF58476D1CE4E5B9, 0x94D049BB133111EB)
_M64 = (1 << 64) - 1

LAUNCHES = {"lzp_screen": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def num_parts(n: int) -> int:
    """The native LZP's part count for an n-byte block (lzp_num_blocks)."""
    if n < 256 * 1024:
        return 1
    if n < 4 * 1024 * 1024:
        return 2
    if n < 16 * 1024 * 1024:
        return 4
    return 8


@dataclass(frozen=True)
class Geometry:
    n: int
    min_len: int
    parts: int
    chunk: int
    windows: tuple   # (first eligible start, count) a part
    per_part: int    # buckets a part

    @property
    def total(self) -> int:
        return sum(c for _, c in self.windows)


def geometry(n: int, min_len: int) -> Geometry:
    """Each part's eligible window starts, [start + 4, end - min_len - 32),
    and the buckets a part (its largest count over MEAN, at least 1)."""
    parts = num_parts(n)
    chunk = n // parts
    windows = []
    for p in range(parts):
        start = p * chunk
        end = n if p == parts - 1 else start + chunk
        windows.append((start + 4, max(0, end - min_len - 32 - start - 4)))
    most = max(c for _, c in windows)
    return Geometry(n, min_len, parts, chunk, tuple(windows),
                    max(1, -(-most // MEAN)))


def _s64(x: int) -> int:
    """x mod 2**64 as the int64 of the same bits."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def keys_plain(data: torch.Tensor, min_len: int) -> torch.Tensor:
    """int64[n - min_len + 1]: the key of the window at every start (bits
    of the u64; int64 arithmetic wraps mod 2**64).  The fingerprint of
    length min_len is built by doubling: F_{a+w}(g) = F_a(g) * BASE**w +
    F_w(g + a)."""
    n = data.numel()
    f, w = data.to(torch.int64), 1           # F_w at every start
    acc, a = None, 0                          # F_a, a = min_len's low bits
    while w <= min_len:
        if min_len & w:
            if acc is None:
                acc = f
            else:
                m = n - a - w + 1
                acc = acc[:m] * _s64(pow(BASE, w, 1 << 64)) + f[a:a + m]
            a += w
        if 2 * w <= min_len:
            m = n - 2 * w + 1
            f = f[:m] * _s64(pow(BASE, w, 1 << 64)) + f[w:w + m]
        w *= 2
    z = acc
    z = (z ^ _srl(z, 30)) * _s64(_MIX[0])
    z = (z ^ _srl(z, 27)) * _s64(_MIX[1])
    return (z ^ _srl(z, 31)) | 1


def _check(data: torch.Tensor, min_len: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError(f"lzp_screen: expected a 1-D uint8 tensor, got "
                        f"{data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("lzp_screen: must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lzp_screen: unsupported device {data.device}")
    if not 4 <= min_len <= 255:
        raise ValueError(f"lzp_screen: min_len {min_len} outside [4, 255]")


def screen(data: torch.Tensor, min_len: int) -> torch.Tensor:
    """K15.  int32[parts]: 0 where no LZP match can occur in the part of
    u8[n], 1 where one may (module docstring)."""
    _check(data, min_len)
    if data.device.type == "cpu":
        return screen_plain(data, min_len)
    geo = geometry(data.numel(), min_len)
    dev = data.device
    flags = torch.zeros(geo.parts, dtype=torch.int32, device=dev)
    if geo.total < 2:
        return flags
    nb = geo.parts * geo.per_part
    cursor = torch.zeros(nb * _STRIDE, dtype=torch.int32, device=dev)
    entries = torch.empty(nb * CAP, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.launcher("lzp_screen")(
            data.data_ptr(), geo.n, geo.chunk, geo.parts, min_len,
            pow(BASE, min_len - 1, 1 << 64), geo.per_part,
            cursor.data_ptr(), entries.data_ptr(), flags.data_ptr(),
            _cuda.stream_handle(dev))
    _cuda.check("lzp_screen", rc)
    LAUNCHES["lzp_screen"] += 1
    return flags


def screen_plain(data: torch.Tensor, min_len: int) -> torch.Tensor:
    """:func:`screen` in plain PyTorch: each part's keys sorted, a repeat
    looked for between neighbours, each bucket counted against CAP."""
    _check(data, min_len)
    geo = geometry(data.numel(), min_len)
    flags = torch.zeros(geo.parts, dtype=torch.int32, device=data.device)
    if geo.total < 2:
        return flags
    keys = keys_plain(data, min_len)
    for p, (lo, count) in enumerate(geo.windows):
        k = keys[lo:lo + count]
        buckets = (_srl(k, 32) * geo.per_part) >> 32
        full = torch.bincount(buckets, minlength=geo.per_part).max() > CAP
        k = torch.sort(k).values
        if full or bool((k[1:] == k[:-1]).any()):
            flags[p] = 1
    return flags
