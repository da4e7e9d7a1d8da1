"""Traffic generators, one module a kind, found by the ``generator`` name
in a traffic file.  Each has ``make(params, seed, index, n_bytes,
device)`` returning the file's bytes as a u8 tensor on ``device``."""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def seeded(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for file ``index`` of a run's ``seed``
    (any whole number; the pair is mixed into 63 bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 0x9E3779B97F4A7C15 + index * 0xBF58476D1CE4E5B9)
                    & _MASK)
    return gen
