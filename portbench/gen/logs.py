"""Log traffic: service log lines of the shapes in Loghub's Apache and
HDFS sets, made with torch on the run's device.

Each line is ``<timestamp> <host> <level> <component>: <body>``: an
ISO timestamp (millisecond resolution) that rises by exponential gaps, a
host drawn Zipf over ``hosts``, and one of ``templates`` templates drawn
Zipf, whose body holds fixed words and fields (ids, sizes, latencies,
status codes) written as zero-padded digits of fixed widths.  A share
``trace_share`` of the lines is followed by a Java stack trace, one of
``traces`` fixed traces: those lines give LZP the long repeats it
codes.  Templates and traces come from the traffic file's
``vocab_seed``; which line, host, field value and gap from the run's
seed and the file's index.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.gen import seeded
from portbench.gen.text import zipf_cdf

_LEVELS = (b"INFO", b"INFO", b"INFO", b"WARN", b"ERROR")
_PREFIX = len(b"2026-03-01T12:34:56.789Z host-00 ")
# field kinds: (digits, how the value is drawn)
_KINDS = {"id": 10, "size": 8, "ms": 5, "status": 3, "port": 5}
_STATUS = (200, 200, 200, 200, 200, 200, 304, 404, 500, 503)


def _catalogue(params: dict):
    """Templates and traces from vocab_seed: (source bytes, template
    starts, lengths, field offsets [T, F] (-1 none), field kinds [T, F],
    trace starts, trace lengths)."""
    rng = np.random.default_rng(params["vocab_seed"])
    words = [bytes(rng.integers(97, 123, int(n)).astype(np.uint8))
             for n in rng.integers(3, 11, 512)]
    kinds = list(_KINDS)
    src, t_start, t_len = bytearray(), [], []
    f_off = np.full((params["templates"], 4), -1, dtype=np.int64)
    f_kind = np.zeros((params["templates"], 4), dtype=np.int64)
    for t in range(params["templates"]):
        level = _LEVELS[int(rng.integers(len(_LEVELS)))]
        comp = b".".join(words[int(w)] for w in rng.integers(0, 512, 3))
        body = bytearray(level + b" " + comp + b": ")
        if rng.random() < 0.5:  # an access line
            path = b"/".join(words[int(w)] for w in rng.integers(0, 512, 3))
            body += b"GET /" + path + b" HTTP/1.1"
        for f in range(int(rng.integers(1, 5))):
            body += b" " + b" ".join(
                words[int(w)] for w in rng.integers(0, 512,
                                                    int(rng.integers(1, 4))))
            k = int(rng.integers(len(kinds)))
            body += b" " + kinds[k].encode() + b"="
            f_off[t, f] = len(body)
            f_kind[t, f] = k
            body += b"0" * _KINDS[kinds[k]]
        body += b"\n"
        t_start.append(len(src))
        t_len.append(len(body))
        src += body
    tr_start, tr_len = [], []
    for _ in range(params["traces"]):
        text = bytearray(b"java.io.IOException: " + words[
            int(rng.integers(512))] + b"\n")
        for _ in range(int(rng.integers(5, 16))):
            cls = b".".join(words[int(w)] for w in rng.integers(0, 512, 4))
            text += (b"\tat org.apache." + cls + b"(" + cls.split(b".")[-1]
                     + b".java:" + str(int(rng.integers(40, 2000))).encode()
                     + b")\n")
        tr_start.append(len(src))
        tr_len.append(len(text))
        src += text
    return (np.frombuffer(bytes(src), dtype=np.uint8), np.asarray(t_start),
            np.asarray(t_len), f_off, f_kind, np.asarray(tr_start),
            np.asarray(tr_len))


def _digits(values: torch.Tensor, width: int) -> torch.Tensor:
    """[n, width] ASCII digits of values, zero-padded."""
    p = 10 ** torch.arange(width - 1, -1, -1, device=values.device)
    return (values[:, None] // p % 10 + ord("0")).to(torch.uint8)


def make(params: dict, seed: int, index: int, n_bytes: int,
         device="cpu") -> torch.Tensor:
    """``n_bytes`` of log lines as u8 on ``device``, the same for the same
    (seed, index, device)."""
    src, t_start, t_len, f_off, f_kind, tr_start, tr_len = _catalogue(params)
    dev = torch.device(device)
    gen = seeded(seed, index, dev)
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa
    src, t_start, t_len = T(src), T(t_start), T(t_len)
    f_off, f_kind, tr_start, tr_len = T(f_off), T(f_kind), T(tr_start), \
        T(tr_len)
    # lines average well over 60 bytes; draw with room and cut
    n = n_bytes // 60 + 64
    rand = lambda *s: torch.rand(*s, generator=gen, device=dev,  # noqa
                                 dtype=torch.float64)
    tpl = torch.searchsorted(T(zipf_cdf(params["zipf_a"],
                                        params["templates"])), rand(n))
    tpl.clamp_(max=params["templates"] - 1)
    host = torch.searchsorted(T(zipf_cdf(params["zipf_a"], params["hosts"])),
                              rand(n)).clamp_(max=params["hosts"] - 1)
    has_tr = rand(n) < params["trace_share"]
    trc = torch.randint(0, params["traces"], (n,), generator=gen, device=dev)
    body = t_len[tpl]
    trl = torch.where(has_tr, tr_len[trc], 0)
    step = _PREFIX + body + trl
    start = torch.cumsum(step, 0) - step
    total = int(start[-1] + step[-1])
    line = torch.repeat_interleave(torch.arange(n, device=dev), step)
    off = torch.arange(total, device=dev) - start[line]
    # template bytes at every offset; the prefix and the trace over them
    out = src[(t_start[tpl][line] + off - _PREFIX).clamp_(0, len(src) - 1)]
    del off
    del line
    tl = torch.nonzero(has_tr).squeeze(1)
    if tl.numel():
        k = torch.repeat_interleave(torch.arange(tl.numel(), device=dev),
                                    trl[tl])
        toff = torch.arange(k.numel(), device=dev) - (
            torch.cumsum(trl[tl], 0) - trl[tl])[k]
        out[(start + _PREFIX + body)[tl][k] + toff] = src[
            tr_start[trc[tl]][k] + toff]
    # prefix: ISO time of day (one day, wrapping), then the host
    ms = torch.cumsum((-torch.log1p(-rand(n)) * params["gap_ms"]).long()
                      + 1, 0) % 86_400_000
    hh, mm = ms // 3_600_000, ms // 60_000 % 60
    ss, mss = ms // 1000 % 60, ms % 1000
    pre = torch.empty((n, _PREFIX), dtype=torch.uint8, device=dev)
    pre[:] = torch.frombuffer(bytearray(b"2026-03-01T00:00:00.000Z host-00 "),
                              dtype=torch.uint8).to(dev)
    for col, v, w in ((11, hh, 2), (14, mm, 2), (17, ss, 2), (20, mss, 3),
                      (30, host, 2)):
        pre[:, col:col + w] = _digits(v, w)
    out[(start[:, None] + torch.arange(_PREFIX, device=dev)).reshape(-1)] = \
        pre.reshape(-1)
    # fields
    for f in range(f_off.shape[1]):
        for k, (kind, width) in enumerate(_KINDS.items()):
            sel = torch.nonzero((f_off[tpl, f] >= 0)
                                & (f_kind[tpl, f] == k)).squeeze(1)
            if not sel.numel():
                continue
            if kind == "status":
                v = T(np.asarray(_STATUS))[torch.randint(
                    0, len(_STATUS), (sel.numel(),), generator=gen,
                    device=dev)]
            elif kind in ("ms", "size"):
                v = (-torch.log1p(-rand(sel.numel()))
                     * 10 ** (width - 3)).long().clamp_(max=10 ** width - 1)
            else:
                v = (rand(sel.numel()) * 10 ** width).long()
            pos = start[sel] + _PREFIX + f_off[tpl[sel], f]
            out[(pos[:, None] + torch.arange(width, device=dev)).reshape(
                -1)] = _digits(v, width).reshape(-1)
    return out[:n_bytes]
