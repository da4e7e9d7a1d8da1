"""The block bsc's Sort Transform formats require for a block of input
(``-m3`` .. ``-m8`` with ``-e1``: the ST of order k and the static QLFC
coder, with the configuration's LZP): the reference encodings the judge
compares the program's blocks with, byte for byte.

Every choice is made from the input by the format's rules (upstream
libbsc 3.3.5, ``libbsc/libbsc.cpp``; line numbers as SURVEY.md gives
them):

- a block of at most 28 bytes is stored (libbsc.cpp:68-81);
- LZP (the configuration's hash bits and minimum length) iff it shortens
  the block (libbsc.cpp:267; ``lzp.may_match``, then the frozen LZP),
  the mode word recording its two parameters.  LZP leaves its last
  min_len + 32 bytes (min_len 4 or more) as literals, so its output
  never shrinks to the 28 bytes at which the format would sort by the
  BWT instead;
- ST-k (libbsc.cpp:287, st/st.cpp:990), k the mode word's sorter, by
  ``ref/st.py`` from its definition.  The ST is unique, so the card's
  route and the host's write the same block;
- the coder's split and static QLFC of ``block_default.Coder``
  (coder.cpp:70-109, libbsc.cpp:312), the same coder as bsc's default
  format;
- a stored block where the coder's output with its tail is not shorter
  than the input (libbsc.cpp:315-317);
- the tail: an ST block carries no aux index, so one byte of 0
  (libbsc.cpp:303, :319-326);
- the 28-byte header with the ST index in its index field and both
  Adler-32s (libbsc.cpp:327-333).

The program's block is not consulted: the format leaves no choice.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.ref import block_default, container, lzp, st
from portbench.ref.block import stored

CODER_QLFC_STATIC = 1


def order_of(cfg: dict) -> int:
    """The ST order k that the configuration's ``-m<k>`` switch names
    (the mode word's sorter, 3 to 8)."""
    for sw in cfg["switches"]:
        if sw.startswith("-m") and sw[2:].isdigit():
            k = int(sw[2:])
            if 3 <= k <= 8:
                return k
    raise ValueError(f"no ST sorter among {cfg['switches']}")


class _Block:
    """A block of input through LZP and the ST, its coder running."""

    def __init__(self, data: np.ndarray, cfg: dict, device, pool,
                 order: int | None = None):
        self.data = data
        k = order_of(cfg)
        hash_bits, min_len = cfg["lzp"]
        self.mode = k | CODER_QLFC_STATIC << 5
        lz = lzp.lzp_compress(data, hash_bits, min_len, device)
        if lz is None:
            lz = data
        else:
            self.mode |= min_len << 8 | hash_bits << 16
        U, self.index = st.st_encode(
            torch.from_numpy(np.array(lz, dtype=np.uint8)).to(device),
            k if order is None else order)
        self.coder = block_default.Coder(U.cpu().numpy(), pool)

    def result(self) -> bytes:
        data = self.data
        payload = self.coder.result()
        if payload is None or len(payload) + 1 >= len(data):
            return stored(data)
        payload += b"\x00"
        return container.block_header(
            len(payload) + container.HEADER_SIZE, len(data), self.mode,
            self.index, container.adler32(data),
            container.adler32(payload)) + payload


def _blocks(datas, cfg: dict, device, order=None) -> list:
    """The required block of each u8 ndarray of ``datas``: the STs one
    after another on ``device``, the segments coded meanwhile."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        preps = [None if len(data) <= container.HEADER_SIZE
                 else _Block(data, cfg, device, pool, order)
                 for data in datas]
        return [stored(d) if p is None else p.result()
                for d, p in zip(datas, preps)]


def expected_many(items, cfg: dict, device) -> list:
    """For each (data u8 [n], the program's block) of ``items``, the
    block the format requires."""
    return _blocks([data for data, _ in items], cfg, device)


def encode(data: np.ndarray, cfg: dict, device,
           order: int | None = None) -> bytes:
    """The block of ``data``; ``order`` sorts at that order in place of
    the mode word's (the benchmark's control)."""
    return _blocks([data], cfg, device, order)[0]
