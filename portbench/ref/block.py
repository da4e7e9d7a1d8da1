"""The blocks the format requires for a block of input under the
configuration's -m9 -e4 mode: the reference encodings the judge
compares the program's blocks with, byte for byte.

Every choice is the reference's own, made from the input by the
format's rules: LZP (the configuration's hash bits and minimum length)
is applied iff it shortens the block; the wide-aux BWT; the lane count;
the lane table; stored iff the coded block would not be shorter.  Two
lane tables are the format's, one for each route a block can take
under -G (``lanes.device_table`` on the card, ``lanes.host_table`` on
the host, whose worker in the -G farm takes blocks too); a program
block is held to the one it carries, and a block with any other table
is wrong.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from portbench.ref import bwt, container, lanes, lzp, wide

SORTER_BWT_WIDEAUX = 2
CODER_QLFC_WIDE = 4
DEVICE_MIN_BLOCK = 1 << 20  # the least block the card's route takes
FLAGS = wide.FLAG_MODEL_V2 | wide.FLAG_RANS


@dataclass
class Prepared:
    """A block of input through LZP and the BWT."""
    data: np.ndarray
    mode: int            # the block header's mode word when coded
    n_lz: int            # bytes the coder sees
    U: torch.Tensor
    primary: int
    aux: np.ndarray
    gpu: bool            # the card's route is open (-G)
    _host: object = None

    @property
    def tail(self) -> bytes:
        return self.aux.astype("<i4").tobytes() + struct.pack(
            "<I", len(self.aux)) + b"\xff"

    def tables(self):
        """(name, sizes, flags) of each table the format allows, the
        card's first, each worked out when it is asked for."""
        L = lanes.lane_count(self.n_lz)
        if (self.gpu and L == lanes.DEFAULT_LANES
                and self.n_lz >= DEVICE_MIN_BLOCK):
            yield ("device", lanes.device_table(self.U, L),
                   FLAGS | wide.FLAG_SIZES)
        yield self.host()

    def host(self):
        if self._host is None:
            L = lanes.lane_count(self.n_lz)
            sizes = lanes.host_table(self.U, L)
            self._host = (("host", sizes, FLAGS | wide.FLAG_SIZES)
                          if sizes is not None else
                          ("equal", wide.equal_sizes(self.n_lz, L), FLAGS))
        return self._host

    def shorter(self, payload: bytes) -> bool:
        """Whether the coder's ``payload`` is kept: shorter than what it
        coded, and the block shorter than the input."""
        return (len(payload) < self.n_lz and len(payload) + len(self.tail)
                < len(self.data))

    def block(self, payload: bytes) -> bytes:
        """The coded block of ``payload``, or the stored block when that
        would not be shorter than the input."""
        n = len(self.data)
        adler = container.adler32(self.data)
        if not self.shorter(payload):
            return stored(self.data)
        payload += self.tail
        return container.block_header(
            len(payload) + container.HEADER_SIZE, n, self.mode,
            self.primary, adler, container.adler32(payload)) + payload


def stored(data: np.ndarray) -> bytes:
    n = len(data)
    adler = container.adler32(data)
    return container.block_header(n + container.HEADER_SIZE, n, 0, 0,
                                  adler, adler) + data.tobytes()


def prepare(data: np.ndarray, cfg: dict, device,
            bwt_limit: int | None = None) -> Prepared:
    """LZP when it shortens ``data`` (u8), then the wide-aux BWT.
    ``bwt_limit`` cuts the suffix sort (the benchmark's control)."""
    hash_bits, min_len = cfg["lzp"]
    mode = SORTER_BWT_WIDEAUX | CODER_QLFC_WIDE << 5
    lz = lzp.lzp_compress(data, hash_bits, min_len, device)
    if lz is None:
        lz = data
    else:
        mode |= min_len << 8 | hash_bits << 16
    U, primary, aux = bwt.bwt_wideaux(
        torch.from_numpy(np.array(lz, dtype=np.uint8)).to(device),
        bwt.wideaux_rate(len(lz)), bwt_limit)
    return Prepared(data, mode, len(lz), U, primary,
                    aux.cpu().numpy().astype(np.int64),
                    "-G" in cfg["switches"])


def lane_table(block: bytes):
    """(flags, sizes) of a coded -m9 -e4 block's wide payload, or None
    when the payload's header does not parse."""
    body = block[container.HEADER_SIZE:]
    if len(body) < 12:
        return None
    _, L, flags, _ = struct.unpack_from("<IHHI", body, 0)
    if not flags & wide.FLAG_SIZES:
        return flags, None
    if L == 0 or len(body) < 12 + 4 * L:
        return None
    return flags, np.frombuffer(body, dtype="<u4", count=L,
                                offset=12).astype(np.int64)


def _same(table, flags, sizes) -> bool:
    _, want_sizes, want_flags = table
    if flags != want_flags:
        return False
    if sizes is None:
        return True
    return np.array_equal(sizes, want_sizes)


def expected_many(items, cfg: dict, device) -> list:
    """For each (data u8 [n], the program's block) of ``items``, the
    block the format requires (the reference's choices; of the two lane
    tables, the one the program's block carries), or None when the
    program's block carries neither."""
    preps = [prepare(data, cfg, device) for data, _ in items]
    jobs, picks = [], []
    for prep, (_, got) in zip(preps, items):
        mode = (container.HEADER.unpack_from(got)[2]
                if len(got) >= container.HEADER_SIZE else None)
        if mode == 0:
            picks.append(("stored", len(jobs)))
            for _, sizes, flags in prep.tables():
                jobs.append((prep.U, sizes, flags))
            continue
        found = lane_table(got)
        pick = None
        if found is not None:
            pick = next((t for t in prep.tables() if _same(t, *found)),
                        None)
        if pick is None:
            picks.append(None)
            continue
        picks.append(("coded", len(jobs)))
        jobs.append((prep.U, pick[1], pick[2]))
    payloads = wide.encode_many(jobs) if jobs else []
    out = []
    for i, (prep, pick) in enumerate(zip(preps, picks)):
        if pick is None:
            out.append(None)
        elif pick[0] == "coded":
            out.append(prep.block(payloads[pick[1]]))
        else:
            # stored is right where a route stores: the host's when its
            # payload is not kept, the card's when its payload is shorter
            # than what it coded and the block still is not (a longer
            # payload sends the block to the host's route)
            *card, host = payloads[pick[1]:pick[1] + len(list(
                prep.tables()))]
            if not prep.shorter(host) or (card and len(card[0]) < prep.n_lz
                                          and not prep.shorter(card[0])):
                out.append(stored(prep.data))
            else:
                out.append(prep.block((card or [host])[0]))
        preps[i] = None
    return out


def expected(data: np.ndarray, got: bytes, cfg: dict, device):
    """:func:`expected_many` of one block."""
    return expected_many([(data, got)], cfg, device)[0]


def encode(data: np.ndarray, cfg: dict, device,
           bwt_limit: int | None = None) -> bytes:
    """The block the reference writes for ``data`` on the card's route
    where it is open (the control, with ``bwt_limit``)."""
    prep = prepare(data, cfg, device, bwt_limit)
    _, sizes, flags = next(prep.tables())
    return prep.block(wide.encode(prep.U, sizes, flags))
