"""LZP as bsc writes it: a frozen copy of the pure-Python stage the
program ships for machines without its native runtime (the reference
may not import the program).  Stream format per libbsc lzp/lzp.cpp:
first 4 bytes verbatim; on an order-4 context-hash hit, a confirmed
match of >= min_len bytes becomes flag 0xF2 + base-254 length
continuation; a literal 0xF2 under a hash hit is escaped as 0xF2 0xFF.
Blocks of 256 KiB or more split into 2, 4 or 8 parts behind a
[raw, packed] directory.  Slow: about 1.6 s a MiB on one core, so
:func:`lzp_compress` runs it only on the parts where
:func:`may_match` finds a match it could take: a part with none comes
out of the encoder as literals alone, longer than the part, and so
unencoded."""

from __future__ import annotations

import numpy as np
import torch

FLAG = 0xF2

def _hash(context: int, mask: int) -> int:
    return ((context >> 15) ^ context ^ (context >> 3)) & mask


def _load_ctx(buf, pos: int) -> int:
    return (buf[pos - 1] | (buf[pos - 2] << 8) | (buf[pos - 3] << 16)
            | (buf[pos - 4] << 24))


def may_match(part: torch.Tensor, hash_size: int, min_len: int) -> bool:
    """Whether :func:`lzp_encode_block` could take a match in ``part``
    (u8 on any device).  Until its first match the encoder has read
    every position before the current one, so the candidate of position
    i is the last earlier position of the same context hash; a match
    needs its first ``min_len`` bytes equal to the candidate's.  False
    means no position has such a candidate."""
    m = part.shape[0]
    end = m - min_len - 32
    if end <= 4:
        return False
    b = part.long()
    i = torch.arange(4, end, device=part.device)
    ctx = b[i - 1] | b[i - 2] << 8 | b[i - 3] << 16 | b[i - 4] << 24
    h = ((ctx >> 15) ^ ctx ^ (ctx >> 3)) & ((1 << hash_size) - 1)
    order = torch.sort(h * m + i).indices
    same = h[order[1:]] == h[order[:-1]]
    pos = i[order[1:][same]]             # positions with a candidate,
    cand = i[order[:-1][same]]           # and the candidate
    del ctx, h, order, same, i
    for k in range(min_len):
        keep = b[pos + k] == b[cand + k]
        pos, cand = pos[keep], cand[keep]
        if pos.numel() == 0:
            return False
    return True


def lzp_encode_block(data: bytes, hash_size: int, min_len: int):
    n = len(data)
    if n - min_len < 32:
        return None
    mask = (1 << hash_size) - 1
    lookup = np.zeros(1 << hash_size, dtype=np.int64)
    out = bytearray()
    out_cap = n - 8  # mirror the native out_eob margin
    min_len_end = n - min_len - 32

    out += data[:4]
    i = 4
    heuristic = 0  # index of known-bad region end (0 = none)
    context = _load_ctx(data, i)
    while i < min_len_end and len(out) < out_cap:
        idx = _hash(context, mask)
        value = int(lookup[idx])
        lookup[idx] = i
        matched = False
        if value > 0:
            r = value
            if (data[i + min_len - 4:i + min_len] == data[r + min_len - 4:r + min_len]
                    and data[i:i + 4] == data[r:r + 4]):
                if heuristic > i and data[heuristic:heuristic + 4] != \
                        data[r + heuristic - i:r + heuristic - i + 4]:
                    pass  # known-bad region: skip extension
                else:
                    ln = 4
                    while i + ln < min_len_end and \
                            data[i + ln:i + ln + 4] == data[r + ln:r + ln + 4]:
                        ln += 4
                    if ln < min_len:
                        if heuristic < i + ln:
                            heuristic = i + ln
                    else:
                        if data[i + ln:i + ln + 2] == data[r + ln:r + ln + 2]:
                            ln += 2
                        if data[i + ln] == data[r + ln]:
                            ln += 1
                        i += ln
                        context = _load_ctx(data, i)
                        out.append(FLAG)
                        ln -= min_len
                        while ln >= 254:
                            ln -= 254
                            out.append(254)
                            if len(out) >= out_cap:
                                break
                        out.append(ln)
                        matched = True
        if not matched:
            nxt = data[i]
            i += 1
            out.append(nxt)
            context = ((context << 8) | nxt) & 0xFFFFFFFF
            if nxt == FLAG and value > 0:
                out.append(255)
            elif nxt == FLAG:
                pass

    # tail: literals with escaping under hash hits
    context = _load_ctx(data, i)
    while i < n and len(out) < out_cap:
        idx = _hash(context, mask)
        value = int(lookup[idx])
        lookup[idx] = i
        nxt = data[i]
        i += 1
        out.append(nxt)
        context = ((context << 8) | nxt) & 0xFFFFFFFF
        if nxt == FLAG and value > 0:
            out.append(255)

    if len(out) >= out_cap:
        return None
    return bytes(out)


def _num_blocks(n: int) -> int:
    if n < 256 * 1024:
        return 1
    if n < 4 * 1024 * 1024:
        return 2
    if n < 16 * 1024 * 1024:
        return 4
    return 8


def lzp_compress(data: np.ndarray, hash_size: int, min_len: int,
                 device="cpu"):
    """ndarray in -> LZP'd ndarray, or None when LZP does not shorten it
    (the format then leaves the block as it is).  ``device`` runs
    :func:`may_match`."""
    raw = data.tobytes()
    n = len(raw)
    whole = torch.from_numpy(np.array(data, dtype=np.uint8)).to(device)

    def encode_part(start, size):
        if not may_match(whole[start:start + size], hash_size, min_len):
            return None
        return lzp_encode_block(raw[start:start + size], hash_size, min_len)

    n_blocks = _num_blocks(n)
    if n_blocks == 1:
        r = encode_part(0, n)
        if r is None:
            return None
        return np.frombuffer(bytes([1]) + r, dtype=np.uint8).copy()

    chunk = n // n_blocks
    out = bytearray([n_blocks])
    dirs = []
    payloads = []
    for b in range(n_blocks):
        start = b * chunk
        size = chunk if b != n_blocks - 1 else n - start
        r = encode_part(start, size)
        if r is None:
            r = raw[start:start + size]
        dirs.append((size, len(r)))
        payloads.append(r)
    total = 1 + 8 * n_blocks + sum(len(p) for p in payloads)
    if total >= n:
        return None
    for size, packed in dirs:
        out += int(size).to_bytes(4, "little") + int(packed).to_bytes(4, "little")
    for p in payloads:
        out += p
    return np.frombuffer(bytes(out), dtype=np.uint8).copy()


