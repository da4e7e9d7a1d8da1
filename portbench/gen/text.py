"""Text traffic: a Zipf word mix with hex tokens, made with torch on the
run's device.

The mix of the repository's old benchmark corpus: words drawn Zipf(a)
(taken modulo the vocabulary) over a vocabulary of 2-12 letter words,
one token in ``hex_every`` 8 random bytes written as hex, a space
between tokens and a newline where the running column count passes a
multiple of ``line_columns``.  The vocabulary comes from the traffic
file's ``vocab_seed``, so every run draws the same words; the token
sequence comes from the run's seed and the file's index.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen import seeded

_HEX = b"0123456789abcdef"


def vocabulary(vocab_seed: int, size: int, min_len: int, max_len: int):
    """(letters u8[total], starts i64[size], lengths i64[size]), numpy."""
    rng = np.random.default_rng(vocab_seed)
    lengths = rng.integers(min_len, max_len + 1, size)
    letters = (rng.integers(0, 26, int(lengths.sum())) + ord("a")).astype(
        np.uint8)
    starts = np.cumsum(lengths) - lengths
    return letters, starts, lengths


def zipf_cdf(a: float, size: int) -> np.ndarray:
    """CDF of (Zipf(a) - 1) mod size: the mass of every m = k + 1 + j size,
    summed to j < 4096 and the rest by its integral."""
    k = np.arange(size, dtype=np.float64) + 1
    j = np.arange(4096, dtype=np.float64)[:, None] * size
    pmf = ((k + j) ** -a).sum(axis=0)
    pmf += (k + 4096 * size) ** (1 - a) / ((a - 1) * size)
    cdf = np.cumsum(pmf)
    return cdf / cdf[-1]


def make(params: dict, seed: int, index: int, n_bytes: int,
         device="cpu") -> torch.Tensor:
    """``n_bytes`` of text as u8 on ``device``, the same for the same
    (seed, index, device)."""
    letters, vstart, vlen = vocabulary(
        params["vocab_seed"], params["vocab_size"], params["word_min"],
        params["word_max"])
    dev = torch.device(device)
    gen = seeded(seed, index, dev)
    letters = torch.from_numpy(letters).to(dev)
    vstart = torch.from_numpy(vstart).to(dev)
    vlen = torch.from_numpy(vlen).to(dev)
    cdf = torch.from_numpy(zipf_cdf(params["zipf_a"],
                                    params["vocab_size"])).to(dev)
    # tokens average about 7 letters; draw with room and cut to n_bytes
    n_tok = n_bytes // 4 + 64
    u = torch.rand(n_tok, generator=gen, device=dev, dtype=torch.float64)
    ranks = torch.searchsorted(cdf, u).clamp_(max=params["vocab_size"] - 1)
    every = params["hex_every"]
    is_hex = torch.arange(n_tok, device=dev) % every == every // 3
    tl = torch.where(is_hex, 16, vlen[ranks])
    step = tl + 1
    start = torch.cumsum(step, 0) - step
    total = int(start[-1] + step[-1])
    # every byte first as its word's letter; hex tokens and separators are
    # written over it
    tok = torch.repeat_interleave(torch.arange(n_tok, device=dev), step)
    src = vstart[ranks] - start
    out = letters[(src[tok] + torch.arange(total, device=dev)).clamp_(
        max=letters.numel() - 1)]
    del tok, src
    h = torch.nonzero(is_hex).squeeze(1)
    raw = torch.randint(0, 256, (h.numel(), 8), generator=gen, device=dev)
    nib = torch.stack([raw >> 4, raw & 15], dim=2).reshape(-1)
    hexd = torch.frombuffer(bytearray(_HEX), dtype=torch.uint8).to(dev)
    pos = (start[h][:, None] + torch.arange(16, device=dev)).reshape(-1)
    out[pos] = hexd[nib]
    line = start // params["line_columns"]
    newline = torch.cat([line[1:] != line[:-1],
                         torch.zeros(1, dtype=torch.bool, device=dev)])
    out[start + tl] = torch.where(newline, ord("\n"), ord(" ")).to(
        torch.uint8)
    return out[:n_bytes]
