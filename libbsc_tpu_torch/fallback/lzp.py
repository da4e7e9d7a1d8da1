"""LZP of the no-native engine (``TBSC_ENGINE=numpy``): a Python port of
the native stage (native/lzp.cc).

Stream format per reference lzp/lzp.cpp: first 4 bytes verbatim; on an
order-4 context-hash hit, a confirmed match of >= min_len bytes becomes
flag 0xF2 + base-254 length continuation; a literal 0xF2 under a hash hit is
escaped as 0xF2 0xFF.  Sub-block splitting (1/2/4/8 with an in-stream
[raw,packed] directory after the count byte) applied above.
"""

from __future__ import annotations

import numpy as np

FLAG = 0xF2


def _hash(context: int, mask: int) -> int:
    return ((context >> 15) ^ context ^ (context >> 3)) & mask


def _load_ctx(buf, pos: int) -> int:
    return (buf[pos - 1] | (buf[pos - 2] << 8) | (buf[pos - 3] << 16)
            | (buf[pos - 4] << 24))


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


def lzp_decode_block(data: bytes, hash_size: int, min_len: int) -> bytes:
    mask = (1 << hash_size) - 1
    lookup = np.zeros(1 << hash_size, dtype=np.int64)
    out = bytearray(data[:4])
    i = 4
    n = len(data)
    context = _load_ctx(out, len(out))
    while i < n:
        idx = _hash(context, mask)
        value = int(lookup[idx])
        lookup[idx] = len(out)
        if data[i] == FLAG and value > 0:
            i += 1
            if data[i] != 255:
                ln = min_len
                while True:
                    ln += data[i]
                    b = data[i]
                    i += 1
                    if b != 254:
                        break
                ref = value
                for _ in range(ln):
                    out.append(out[ref])
                    ref += 1
                context = _load_ctx(out, len(out))
            else:
                i += 1
                out.append(FLAG)
                context = ((context << 8) | FLAG) & 0xFFFFFFFF
        else:
            nxt = data[i]
            i += 1
            out.append(nxt)
            context = ((context << 8) | nxt) & 0xFFFFFFFF
    return bytes(out)


def _num_blocks(n: int) -> int:
    if n < 256 * 1024:
        return 1
    if n < 4 * 1024 * 1024:
        return 2
    if n < 16 * 1024 * 1024:
        return 4
    return 8


def lzp_compress(data: np.ndarray, hash_size: int, min_len: int):
    """Engine contract: ndarray in -> compressed ndarray or None."""
    raw = data.tobytes()
    n = len(raw)
    n_blocks = _num_blocks(n)
    if n_blocks == 1:
        r = lzp_encode_block(raw, hash_size, min_len)
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
        r = lzp_encode_block(raw[start:start + size], hash_size, min_len)
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


def lzp_decompress(data: np.ndarray, hash_size: int, min_len: int):
    raw = data.tobytes()
    n_blocks = raw[0]
    if n_blocks == 1:
        return np.frombuffer(lzp_decode_block(raw[1:], hash_size, min_len),
                             dtype=np.uint8).copy()
    ip = 1 + 8 * n_blocks
    out = bytearray()
    for b in range(n_blocks):
        out_size = int.from_bytes(raw[1 + 8 * b:5 + 8 * b], "little")
        in_size = int.from_bytes(raw[5 + 8 * b:9 + 8 * b], "little")
        seg = raw[ip:ip + in_size]
        ip += in_size
        if in_size != out_size:
            out += lzp_decode_block(seg, hash_size, min_len)
        else:
            out += seg
    return np.frombuffer(bytes(out), dtype=np.uint8).copy()
