"""The statistics kernels on the card: K6, the byte histogram, and K7, the
Adler-32 chunk partials, with their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.  K6
(``csrc/byte_hist.cu``) is stage 1 of the sharded transform step
(``parallel/pipeline.py``); K7 (``csrc/adler_partials.cu``) gives the
Adler-32 of a block that is already on the card (:func:`adler32_device`).

Each wrapper launches its CUDA kernel for a CUDA tensor, and counts the
launch in ``LAUNCHES``, and runs its plain version for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _cuda

_HIST_TILE = 256 * 512  # the JAX kernel's tile: shards this large take K6
_ADLER_CHUNK = 2048     # 2048*2049/2*255 < 2**31: int32-safe weighted sum
_ADLER_BASE = 65521

LAUNCHES = {"byte_hist": 0, "adler_partials": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_bytes(data: torch.Tensor, name: str) -> torch.device:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError(f"{name}: expected a 1-D uint8 tensor, got "
                        f"{data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {data.device}")
    return data.device


def _launch(name: str, data: torch.Tensor, out: torch.Tensor) -> None:
    dev = data.device
    with torch.cuda.device(dev):
        rc = _cuda.launcher(name)(data.data_ptr(), data.numel(),
                                  out.data_ptr(), _cuda.stream_handle(dev))
    _cuda.check(name, rc)
    LAUNCHES[name] += 1


def byte_histogram(data: torch.Tensor) -> torch.Tensor:
    """K6.  256-bin histogram of u8[n] (any storage offset) as int32[256]."""
    dev = _check_bytes(data, "byte_histogram")
    if dev.type == "cpu":
        return byte_histogram_plain(data)
    out = torch.zeros(256, dtype=torch.int32, device=dev)
    if data.numel():
        _launch("byte_hist", data, out)
    return out


def byte_histogram_plain(data: torch.Tensor) -> torch.Tensor:
    return torch.bincount(data.long(), minlength=256).to(torch.int32)


def _adler_partials(data: torch.Tensor) -> torch.Tensor:
    """K7.  int32[ceil(n / 2048), 2]: (s1, s2) = (sum x_j,
    sum (2048 - j) x_j) of each 2048-byte chunk, the last chunk as if
    zero-padded."""
    dev = _check_bytes(data, "_adler_partials")
    if dev.type == "cpu":
        return _adler_partials_plain(data)
    n_chunks = -(-data.numel() // _ADLER_CHUNK)
    out = torch.empty((n_chunks, 2), dtype=torch.int32, device=dev)
    if n_chunks:
        _launch("adler_partials", data, out)
    return out


def _adler_partials_plain(data: torch.Tensor) -> torch.Tensor:
    n = data.numel()
    n_chunks = -(-n // _ADLER_CHUNK)
    x = torch.zeros(n_chunks * _ADLER_CHUNK, dtype=torch.int32,
                    device=data.device)
    x[:n] = data
    x = x.view(n_chunks, _ADLER_CHUNK)
    w = torch.arange(_ADLER_CHUNK, 0, -1, dtype=torch.int32,
                     device=data.device)
    return torch.stack([x.sum(1), (x * w).sum(1)], 1).to(torch.int32)


def adler32_device(data: torch.Tensor, value: int = 1) -> int:
    """Adler-32 of u8[n] on its device from K7's partials, equal to
    ``zlib.adler32(data, value)``.  The partials are combined exactly in
    int64 on the same device: the bytes of chunk c (offset o_c, k_c real
    bytes) weigh (n - o_c - k_c) + (k_c - j), and the kernel's weights
    assumed a whole chunk, so the last chunk's s2 loses
    (2048 - k_c) * s1."""
    n = data.numel()
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    if n == 0:
        return ((b << 16) | a) & 0xFFFFFFFF
    m = _ADLER_BASE
    parts = _adler_partials(data).long()
    s1, s2 = parts[:, 0], parts[:, 1].clone()
    n_chunks = parts.shape[0]
    k = torch.full((n_chunks,), _ADLER_CHUNK, dtype=torch.int64,
                   device=parts.device)
    k[-1] = n - (n_chunks - 1) * _ADLER_CHUNK
    s2[-1] -= (_ADLER_CHUNK - k[-1]) * s1[-1]
    offset = torch.arange(n_chunks, device=parts.device) * _ADLER_CHUNK
    after = (n - offset - k) % m
    a_sum = s1.sum() % m
    b_sum = ((after * (s1 % m)) % m).sum() + (s2 % m).sum()
    a_out, b_sum = torch.stack([a_sum, b_sum % m]).tolist()
    a_out = (a + a_out) % m
    b_out = (b + (n % m) * a + b_sum) % m
    return ((b_out << 16) | a_out) & 0xFFFFFFFF
