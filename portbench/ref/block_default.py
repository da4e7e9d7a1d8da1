"""The block bsc's default format requires for a block of input (``-m0
-e1``, the BWT and the static QLFC coder, with the configuration's LZP):
the reference encodings the judge compares the program's blocks with,
byte for byte.

Every choice is made from the input by the format's rules:

- LZP (the configuration's hash bits and minimum length) iff it shortens
  the block (``lzp.may_match``, then the frozen LZP);
- the BWT by prefix doubling on the block's device, with its primary
  index and, for a block of 64 KiB or more, the ranks of every
  ``aux_rate(n)``-th suffix (bwt.cpp:192-197).  The BWT is unique and
  the rate depends on the size alone, so the card's route and the host
  worker's write the same block;
- the coder's split (coder.cpp:70-109): 1, 2, 4 or 8 segments by size,
  cut at sampled rank changes; each segment coded by the static QLFC
  loops (``qlfc.encode``, segments in parallel on threads), and stored
  where its code is not shorter than it;
- a stored block where the coder's output with its tail is not shorter
  than the input, or the segments' directory and code are not shorter
  than what they code;
- the 28-byte header with both Adler-32s.

The program's block is not consulted: the format leaves no choice.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.ref import bwt, container, lzp, qlfc
from portbench.ref.block import stored

SORTER_BWT = 1
CODER_QLFC_STATIC = 1
AUX_MIN_BLOCK = 64 * 1024  # a smaller block carries no aux index


def aux_rate(n: int) -> int:
    """The aux indexes' sampling rate: n / 8 with every bit below its
    highest set, shifted right once, plus one (bwt.cpp:192-197)."""
    mod = n // 8
    for s in (1, 2, 4, 8, 16):
        mod |= mod >> s
    return (mod >> 1) + 1


def segments_of(n: int) -> int:
    """How many segments the coder cuts ``n`` bytes into."""
    if n < 256 * 1024:
        return 1
    if n < 4 * 1024 * 1024:
        return 2
    if n < 16 * 1024 * 1024:
        return 4
    return 8


def split(data: np.ndarray, k: int):
    """(starts, sizes) of ``k`` segments of ``data``: every 32nd byte
    that differs from the one before it is a rank change, and each
    segment but the last takes ``changes // k`` of them; equal cuts where
    there are no more changes than segments."""
    n = len(data)
    samp = np.arange(1, n, 32)
    changes = samp[data[samp] != data[samp - 1]]
    if len(changes) > k:
        per = len(changes) // k
        starts = [0] + [int(changes[(b + 1) * per - 1]) for b in range(k - 1)]
    else:
        starts = [(n // k) * b for b in range(k)]
    sizes = [b - a for a, b in zip(starts, starts[1:] + [n])]
    return starts, sizes


class Coder:
    """The static coder's payload of a BWT output, its segments coded on
    ``pool``'s threads; :meth:`result` waits for them."""

    def __init__(self, U: np.ndarray, pool: ThreadPoolExecutor):
        self.U = U
        n = len(U)
        self.k = segments_of(n)
        if self.k == 1:
            self.cuts = [(0, n)]
            self.jobs = [pool.submit(qlfc.encode, U, n - 1)]
            return
        starts, sizes = split(U, self.k)
        self.cuts = list(zip(starts, sizes))
        self.jobs = [pool.submit(qlfc.encode, U[s:s + z], z)
                     for s, z in self.cuts]

    def result(self):
        """The payload, or None where coding does not shorten it."""
        coded = [job.result() for job in self.jobs]
        if self.k == 1:
            return None if coded[0] is None else b"\x01" + coded[0]
        head, body = [bytes([self.k])], []
        for (s, z), code in zip(self.cuts, coded):
            if code is None or len(code) >= z:
                code = self.U[s:s + z].tobytes()
            head.append(struct.pack("<ii", z, len(code)))
            body.append(code)
        payload = b"".join(head + body)
        return payload if len(payload) < len(self.U) else None


class _Block:
    """A block of input through LZP and the BWT, its coder running."""

    def __init__(self, data: np.ndarray, cfg: dict, device, pool,
                 bwt_limit: int | None = None):
        self.data = data
        hash_bits, min_len = cfg["lzp"]
        self.mode = SORTER_BWT | CODER_QLFC_STATIC << 5
        lz = lzp.lzp_compress(data, hash_bits, min_len, device)
        if lz is None:
            lz = data
        else:
            self.mode |= min_len << 8 | hash_bits << 16
        n_lz = len(lz)
        r = aux_rate(n_lz)
        U, self.primary, aux = bwt.bwt_wideaux(
            torch.from_numpy(np.array(lz, dtype=np.uint8)).to(device), r,
            bwt_limit)
        self.aux = (aux.cpu().numpy().astype("<i4")
                    if len(data) >= AUX_MIN_BLOCK else np.empty(0, "<i4"))
        self.coder = Coder(U.cpu().numpy(), pool)

    def result(self) -> bytes:
        data = self.data
        payload = self.coder.result()
        tail = self.aux.tobytes() + bytes([len(self.aux)])
        if payload is None or len(payload) + len(tail) >= len(data):
            return stored(data)
        payload += tail
        return container.block_header(
            len(payload) + container.HEADER_SIZE, len(data), self.mode,
            self.primary, container.adler32(data),
            container.adler32(payload)) + payload


def _blocks(datas, cfg: dict, device, bwt_limit=None) -> list:
    """The required block of each u8 ndarray of ``datas``: the BWTs one
    after another on ``device``, the segments coded meanwhile."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        preps = []
        for data in datas:
            if len(data) <= container.HEADER_SIZE:
                preps.append(None)
                continue
            preps.append(_Block(data, cfg, device, pool, bwt_limit))
        return [stored(d) if p is None else p.result()
                for d, p in zip(datas, preps)]


def expected_many(items, cfg: dict, device) -> list:
    """For each (data u8 [n], the program's block) of ``items``, the
    block the format requires."""
    return _blocks([data for data, _ in items], cfg, device)


def encode(data: np.ndarray, cfg: dict, device,
           bwt_limit: int | None = None) -> bytes:
    """The block of ``data``; ``bwt_limit`` cuts the suffix sort at that
    many bytes (the benchmark's control)."""
    return _blocks([data], cfg, device, bwt_limit)[0]
