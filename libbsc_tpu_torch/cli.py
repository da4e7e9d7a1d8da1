"""bsc-compatible command-line archiver on PyTorch and CUDA.

File format (bsc.cpp:46-59, 171-178):
    'bsc1' magic (4 bytes)
    int32 nBlocks
    per block: BSC_BLOCK_HEADER { int64 blockOffset; int8 recordSize;
               int8 sortingContexts } (packed, 10 bytes)
               followed by the compressed block (28-byte header + payload).

Usage mirrors the reference:
    python -m libbsc_tpu_torch.cli e input output [switches]
    python -m libbsc_tpu_torch.cli d input output [switches]
Switches: -b<N> block size MB, -m<N> sorter (0=BWT, 3..8=ST, 9=BWT+wideaux),
-e<N> coder (1=static 2=adaptive 0=fast 4=wide), -H<N> LZP hash, -M<N> LZP
minlen, -p disable LZP/filters, -s segmentation, -r record reordering, -c
contexts (f/p/a), -t/-T disable multithreading, -G the CUDA device.

-G asks for the CUDA device and fails without one; without -G no stage
touches the device.  The filters (segmentation, record reordering, context
order) are host code, as in the reference.
"""

from __future__ import annotations

import os
import queue
import struct
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import api, constants as C
from .filters import detectors, preprocessing

FILE_SIGN = b"bsc1"
BLOCK_HEADER_FMT = "<qbb"  # blockOffset, recordSize, sortingContexts
BLOCK_HEADER_SIZE = 10
DEVICE_WORKERS = 3  # -G farm: device workers beside one host worker


class Params:
    block_size = 25 * 1024 * 1024
    block_sorter = C.BLOCKSORTER_BWT
    coder = C.CODER_QLFC_STATIC
    sorting_contexts = C.CONTEXTS_FOLLOWING
    parallel = True
    multithreading = True
    fastmode = True
    segmentation = False
    reordering = False
    lzp = True
    lzp_hash_size = 15
    lzp_min_len = 128
    gpu = False  # -G: the CUDA device, the reference's CUDA flag
    largepages = False  # -P parity; numpy manages host memory

    def features(self):
        f = C.FEATURE_NONE
        if self.fastmode:
            f |= C.FEATURE_FASTMODE
        if self.multithreading:
            f |= C.FEATURE_MULTITHREADING
        if self.gpu:
            f |= C.FEATURE_CUDA
        return f

    def copy(self, **changes) -> "Params":
        q = Params.__new__(Params)
        q.__dict__.update(self.__dict__, **changes)
        return q


def farm_policy(n_threads: int, n_blocks: int):
    """The reference's adaptive nested-parallelism policy (bsc.cpp:184-190):
    with parallel processing on, numThreads = omp_get_max_threads(); when
    threads <= blocks, per-block (inner) multithreading is off, each
    thread owning whole blocks; the farm never runs more workers than
    blocks.  Returns (workers, inner_mt)."""
    inner_mt = n_threads > max(n_blocks, 0)
    workers = max(1, min(n_threads, max(n_blocks, 1)))
    return workers, inner_mt


def _apply_farm_policy(p: Params, n_blocks: int):
    """Params adjusted per `farm_policy` (a copy when inner multithreading
    must be turned off; the original otherwise), and the farm's workers."""
    if not p.parallel:
        return p, 1
    workers, inner_mt = farm_policy(os.cpu_count() or 1, n_blocks)
    if p.multithreading and not inner_mt:
        return p.copy(multithreading=False), workers
    return p, workers


def _init(p: Params, device) -> None:
    """api.init for this run: the CUDA device (``device``, None meaning
    ``cuda``) with -G, the CPU without it."""
    api.init(p.features(), device if p.gpu else "cpu")


def _compress_one(p: Params, data: bytes):
    """Filters + compress one block; returns (record_size, contexts, blob)."""
    record_size = 1
    buf = np.frombuffer(data, dtype=np.uint8)
    if p.reordering:
        rs = detectors.detect_recordsize(buf)
        if rs > 1:
            buf = buf.copy()
            preprocessing.reorder_forward(buf, rs)
            record_size = rs
    contexts = p.sorting_contexts
    if contexts == C.CONTEXTS_AUTODETECT:
        contexts = detectors.detect_contextsorder(buf)
    if contexts == C.CONTEXTS_PRECEDING:
        buf = buf[::-1]

    hs = p.lzp_hash_size if p.lzp else 0
    ml = p.lzp_min_len if p.lzp else 0
    try:
        blob = api.compress(buf.tobytes(), hs, ml, p.block_sorter, p.coder,
                            p.features())
    except api.BscError as e:
        if e.code != C.NOT_COMPRESSIBLE:
            raise
        blob = api.store(data)  # the format's own fallback: a stored block
        record_size, contexts = 1, C.CONTEXTS_FOLLOWING
    return record_size, contexts, blob


def _read_blocks(f, block_size: int, segmentation: bool):
    """(offset, bytes) of each block of f.  With segmentation (bsc.cpp:
    234-277): detect_segments on a full block, emit cached segments one by
    one; the last cached segment is topped up with fresh data and
    segmented again (a boundary can move once more data is visible).
    Every byte read is yielded."""
    offset = 0
    if not segmentation:
        while True:
            data = f.read(block_size)
            if not data:
                return
            yield offset, data
            offset += len(data)
    pending = b""
    seg_queue: list = []
    at_eof = False
    while True:
        if len(seg_queue) > 1:
            size = seg_queue.pop(0)
            yield offset, pending[:size]
            offset += size
            pending = pending[size:]
            continue
        if not at_eof and len(pending) < block_size:
            chunk = f.read(block_size - len(pending))
            if not chunk:
                at_eof = True
            pending += chunk
        if not pending:
            return
        if not (len(seg_queue) == 1 and seg_queue[0] == len(pending)):
            seg_queue = list(detectors.detect_segments(
                np.frombuffer(pending, dtype=np.uint8)))
        size = min(seg_queue.pop(0), len(pending))
        yield offset, pending[:size]
        offset += size
        pending = pending[size:]


def _device_farm(p: Params, blocks, emit) -> None:
    """The -G farm: DEVICE_WORKERS device workers and one host worker
    (features without FEATURE_CUDA) pull blocks from one bounded queue, so
    the host coder runs while the device sorts.  -G runs the default
    config unchanged, the reference's CUDA semantics (bwt/bwt.cpp:
    178-181): TBSC_BWT_DEVICE=1 sends a BWT block of a device worker to
    the device sorter for the farm's run and is restored afterwards."""
    bwt_prev = os.environ.get("TBSC_BWT_DEVICE")
    if p.block_sorter == C.BLOCKSORTER_BWT:
        os.environ["TBSC_BWT_DEVICE"] = "1"
    jobs: queue.Queue = queue.Queue(maxsize=8)
    done = object()
    errors: list = []

    def worker(q: Params):
        while True:
            item = jobs.get()
            if item is done:
                jobs.put(done)
                return
            offset, data = item
            try:
                emit(offset, *_compress_one(q, data))
            except BaseException as e:  # handed to the main thread
                errors.append(e)
                # drain, so that a producer blocked on the queue wakes up
                # even when every worker died
                try:
                    while True:
                        if jobs.get_nowait() is done:
                            jobs.put(done)
                            break
                except queue.Empty:
                    pass
                return

    params = [p] * DEVICE_WORKERS + [p.copy(gpu=False)]
    try:
        with ThreadPoolExecutor(max_workers=len(params)) as ex:
            futs = [ex.submit(worker, q) for q in params]
            for item in blocks:
                while not errors:
                    try:
                        jobs.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if errors:
                    break
            jobs.put(done)
            for fut in futs:
                fut.result()
    finally:
        if bwt_prev is None:
            os.environ.pop("TBSC_BWT_DEVICE", None)
        else:
            os.environ["TBSC_BWT_DEVICE"] = bwt_prev
    if errors:
        raise errors[0]


def compress_file(inp: str, outp: str, p: Params, quiet: bool = False,
                  device=None) -> None:
    """Compress the file ``inp`` into the archive ``outp``.  With -G
    (``p.gpu``) the stages run on ``device`` (None: CUDA, which must be
    present; "cpu": the kernels' plain versions); without it on the
    host."""
    t0 = time.time()
    in_size = os.path.getsize(inp)
    block_size = min(p.block_size, in_size) if in_size > 0 else p.block_size
    n_blocks = (in_size + block_size - 1) // block_size
    p, farm_workers = _apply_farm_policy(p, n_blocks)
    _init(p, device)

    with open(inp, "rb") as f, open(outp, "wb") as out:
        out.write(FILE_SIGN)
        out.write(struct.pack("<i", n_blocks))
        out_size = 8
        done = 0
        write_lock = threading.Lock()

        def emit(offset, rs, ctx, blob):
            nonlocal out_size, done
            with write_lock:  # blocks may finish out of order; each
                # carries its absolute offset (the reference's
                # critical(output), bsc.cpp:397-418)
                if not quiet and in_size > 0:
                    print(f"\rCompressing {inp}"
                          f"({100 * done // max(in_size, 1):02d}%)",
                          end="", flush=True)
                out.write(struct.pack(BLOCK_HEADER_FMT, offset, rs, ctx))
                out.write(blob)
                out_size += BLOCK_HEADER_SIZE + len(blob)
                done = max(done, offset)

        def job(item):
            offset, data = item
            return (offset, *_compress_one(p, data))

        blocks = _read_blocks(f, block_size, p.segmentation)
        if p.gpu and p.parallel:
            _device_farm(p, blocks, emit)
        else:
            with ThreadPoolExecutor(max_workers=farm_workers) as ex:
                for result in ex.map(job, blocks):
                    emit(*result)
        if not quiet:
            print("\r", end="")

    dt = time.time() - t0
    if not quiet:
        mbps = in_size / 1e6 / dt if dt > 0 else 0.0
        print(f"{inp} encoded {in_size} => {out_size} in {dt:.3f}s "
              f"({mbps:.2f} MB/s)")


def decompress_file(inp: str, outp: str, p: Params, quiet: bool = False,
                    device=None) -> None:
    """Restore the archive ``inp`` into the file ``outp``; -G and
    ``device`` as for :func:`compress_file`."""
    t0 = time.time()
    in_size = os.path.getsize(inp)

    with open(inp, "rb") as f, open(outp, "wb") as out:
        if f.read(4) != FILE_SIGN:
            print("This is not a valid bsc archive!", file=sys.stderr)
            sys.exit(1)
        (n_blocks,) = struct.unpack("<i", f.read(4))
        p, farm_workers = _apply_farm_policy(p, n_blocks)
        _init(p, device)

        def read_jobs():
            # reads to EOF like the reference (bsc.cpp:507-520): nBlocks is
            # advisory (segmentation may change the block count)
            while True:
                bh = f.read(BLOCK_HEADER_SIZE)
                if len(bh) == 0:
                    return
                if len(bh) < BLOCK_HEADER_SIZE:
                    print("Unexpected end of file!", file=sys.stderr)
                    sys.exit(1)
                offset, rs, ctx = struct.unpack(BLOCK_HEADER_FMT, bh)
                if rs < 1 or ctx not in (C.CONTEXTS_FOLLOWING,
                                         C.CONTEXTS_PRECEDING):
                    print("This is not bsc archive or invalid compression "
                          "method!", file=sys.stderr)
                    sys.exit(2)
                header = f.read(C.HEADER_SIZE)
                block_size, _ = api.block_info(header)
                payload = f.read(block_size - C.HEADER_SIZE)
                yield offset, rs, ctx, header + payload

        def job(args):
            offset, rs, ctx, blob = args
            data = api.decompress(blob)
            if ctx == C.CONTEXTS_PRECEDING:
                data = data[::-1]
            if rs > 1:
                arr = np.frombuffer(data, dtype=np.uint8).copy()
                preprocessing.reorder_reverse(arr, rs)
                data = arr.tobytes()
            return offset, data

        total = 0
        with ThreadPoolExecutor(max_workers=farm_workers) as ex:
            for b, (offset, data) in enumerate(ex.map(job, read_jobs())):
                if not quiet and n_blocks > 0:
                    print(f"\rDecompressing {inp}"
                          f"({100 * b // n_blocks:02d}%)", end="",
                          flush=True)
                out.seek(offset)
                out.write(data)
                total += len(data)
        if not quiet:
            print("\r", end="")

    dt = time.time() - t0
    if not quiet:
        mbps = total / 1e6 / dt if dt > 0 else 0.0
        print(f"{inp} decoded {in_size} => {total} in {dt:.3f}s "
              f"({mbps:.2f} MB/s)")


USAGE = """This is a block sorting data compressor on PyTorch and CUDA,
format-compatible with bsc.
Usage: python -m libbsc_tpu_torch.cli <e|d> inputfile outputfile <options>

Switches:
  -b<size> Block size in megabytes, default: -b25
  -m<algo> Block sorting algorithm, default: -m0 (BWT); -m3..-m8 = ST3..ST8;
           -m9 = BWT with wide aux indexes (format extension, device unbwt)
  -c<ctx>  Contexts: -cf following (default), -cp preceding, -ca autodetect
  -e<coder> Coder: -e1 static QLFC (default), -e2 adaptive QLFC, -e0 fast QLFC,
           -e4 wide-lane QLFC (GPU lockstep profile; not bsc-decodable)
  -H<size> LZP hash size, default: -H15 (0 disables LZP)
  -M<len>  LZP minimum match length, default: -M128
  -p       Disable all preprocessing techniques
  -s       Enable segmentation
  -r       Enable record reordering
  -l       Enable LZP preprocessing (default: enabled; use after -p)
  -t       Disable parallel blocks processing
  -T       Disable multi-core systems support
  -G       Enable the CUDA device (block sorting and the wide coder)
  -P       Enable large RAM pages (accepted for parity)

Options may be combined into one, like -b128p -m5e1
"""


def parse_args(argv):
    # Decompression-only profile (the reference's BSC_DECOMPRESSION_ONLY
    # compile flag, bsc.cpp:687-695,891): with TBSC_DECOMPRESSION_ONLY set
    # the `e` command is not offered and falls through to usage.
    modes = ("d",) if os.environ.get("TBSC_DECOMPRESSION_ONLY") else ("e", "d")
    if len(argv) < 4 or argv[1] not in modes:
        print(USAGE)
        sys.exit(0)
    p = Params()

    def bad(a):
        print(f"Unknown option: {a}", file=sys.stderr)
        sys.exit(1)

    coders = {0: C.CODER_QLFC_FAST, 1: C.CODER_QLFC_STATIC,
              2: C.CODER_QLFC_ADAPTIVE, 4: C.CODER_QLFC_WIDE}
    contexts = {"f": C.CONTEXTS_FOLLOWING, "p": C.CONTEXTS_PRECEDING,
                "a": C.CONTEXTS_AUTODETECT}
    for a in argv[4:]:
        if not a.startswith("-") or len(a) < 2:
            bad(a)
        # switches combine into one argument, e.g. -b128p -m5e1 (bsc.cpp:868)
        body = a[1:]
        i = 0
        while i < len(body):
            ch = body[i]
            i += 1
            if ch in "bmeHM":  # numeric-valued switches
                j = i
                while j < len(body) and body[j].isdigit():
                    j += 1
                if j == i:
                    bad(a)
                v = int(body[i:j])
                i = j
                if ch == "b":
                    if not 1 <= v <= 2047:
                        bad(a)
                    p.block_size = v * 1024 * 1024
                elif ch == "m":
                    if v != 0 and v != 9 and not 3 <= v <= 8:
                        bad(a)
                    p.block_sorter = (
                        C.BLOCKSORTER_BWT if v == 0
                        else C.BLOCKSORTER_BWT_WIDEAUX if v == 9 else v)
                elif ch == "e":
                    if v not in coders:
                        bad(a)
                    p.coder = coders[v]
                elif ch == "H":
                    if not 10 <= v <= 28:
                        bad(a)
                    p.lzp_hash_size = v
                elif ch == "M":
                    if not 4 <= v <= 255:
                        bad(a)
                    p.lzp_min_len = v
            elif ch == "c":
                ctx = body[i:i + 1]
                i += 1
                if ctx not in contexts:
                    bad(a)
                p.sorting_contexts = contexts[ctx]
            elif ch == "p":
                p.lzp = False
                p.segmentation = False
                p.reordering = False
                p.sorting_contexts = C.CONTEXTS_FOLLOWING
            elif ch == "s":
                p.segmentation = True
            elif ch == "r":
                p.reordering = True
            elif ch == "l":
                p.lzp = True
            elif ch == "t":
                p.parallel = False
            elif ch == "T":
                p.parallel = False
                p.multithreading = False
            elif ch == "G":
                p.gpu = True
            elif ch == "P":
                p.largepages = True  # accepted for parity
            elif ch == "f":
                p.fastmode = True
            else:
                bad(a)
    return p


_ERROR_MESSAGES = {
    C.NOT_ENOUGH_MEMORY: "Not enough memory!",
    C.DATA_CORRUPT: "The compressed data is corrupted!",
    C.NOT_SUPPORTED: "Specified compression method is not supported on this "
                     "platform!",
    C.UNEXPECTED_EOB: "Unexpected end of block!",
    C.GPU_NOT_SUPPORTED: "-G needs a CUDA device, and CUDA is not available "
                         "on this machine!",
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = parse_args(argv)
    mode, inp, outp = argv[1], argv[2], argv[3]
    try:
        if mode == "e":
            compress_file(inp, outp, p)
        else:
            decompress_file(inp, outp, p)
    except api.BscError as e:
        print(_ERROR_MESSAGES.get(
            e.code, "Internal program error, please contact the author!"),
            file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
