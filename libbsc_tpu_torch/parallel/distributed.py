"""Multi-process block farm over torch.distributed.

Counterpart of the JAX package's ``parallel/distributed.py``, with the
same file protocol, so both write the same archive.  Each process owns a
stripe of blocks (block i belongs to process i % num_processes),
compresses its stripe on its own device into a part file
``{out}.part{pid}``, marks it done with ``{out}.part{pid}.done`` (the
number of blocks written), and process 0 merges the parts in pid order
behind the ``bsc1`` sign.  Every block carries its absolute offset in its
``<qbb`` entry header, so blocks may be written in any order and the
decoder seeks per block.

Usage (the same call in every process, on a shared file system):

    from libbsc_tpu_torch.parallel import distributed as dist
    dist.init(coordinator="host0:1234", num_processes=N, process_id=i)
    dist.compress_file("in.bin", "out.bsc")   # process 0 writes out.bsc

The process group uses gloo: its only collective is a host barrier, and
each process's device work is its own ``api.compress``.  (NCCL would also
need one card per rank; gloo lets several ranks share one card.)  With
one process there is no process group.  The process count, rank and
device are module state set by :func:`init`, as in the JAX package.
"""

from __future__ import annotations

import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import api, constants as C
from ..errors import BscError

FILE_SIGN = b"bsc1"
BLOCK_HEADER_FMT = "<qbb"

_num_processes = 1
_process_id = 0
_device = None


def init(coordinator: str | None = None, num_processes: int = 1,
         process_id: int = 0, device=None) -> None:
    """Set up this process's place in the farm: with ``num_processes > 1``
    join the gloo process group at ``tcp://{coordinator}``.  ``device``
    None means ``cuda:{process_id % device_count}``, which must exist;
    ``device="cpu"`` runs the kernels' plain versions."""
    global _num_processes, _process_id, _device
    if device is None:
        if not torch.cuda.is_available():
            raise BscError(C.GPU_NOT_SUPPORTED,
                           "CUDA is not available; pass device='cpu' to "
                           "run the kernels' plain versions on the CPU")
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
    _num_processes = num_processes
    _process_id = process_id
    _device = torch.device(device)
    if num_processes > 1:
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)


def _part_path(outp: str, pid: int) -> str:
    return f"{outp}.part{pid}"


def _barrier(tag: str) -> None:
    """Every process reaches ``tag`` before any goes on."""
    del tag  # gloo's barrier is not named
    if _num_processes > 1:
        torch.distributed.barrier()


def compress_file(inp: str, outp: str, block_size: int = 25 * 1024 * 1024,
                  block_sorter: int = C.DEFAULT_BLOCKSORTER,
                  coder: int = C.DEFAULT_CODER,
                  features: int = C.DEFAULT_FEATURES,
                  workers: int | None = None) -> None:
    """Compress inp to outp with blocks striped across processes.

    Every process calls this with the same arguments.  Process p
    compresses blocks {i : i % num_processes == p} into its part file;
    process 0 waits for every part's done marker and joins the parts in
    pid order behind the 'bsc1' header, raising DATA_CORRUPT when a
    part's block count is not its stripe's."""
    api.init(features, device=_device)
    in_size = os.path.getsize(inp)
    n_blocks = (in_size + block_size - 1) // block_size if in_size else 0

    def jobs():
        with open(inp, "rb") as f:
            for i in range(n_blocks):
                if i % _num_processes != _process_id:
                    continue
                f.seek(i * block_size)
                yield i * block_size, f.read(block_size)

    def encode(args):
        offset, data = args
        blob = api.compress(data, block_sorter=block_sorter, coder=coder,
                            features=features)
        return offset, blob

    part = _part_path(outp, _process_id)

    # Remove stale part/marker files a previous crashed run may have left,
    # then synchronize so no process can observe another's stale marker.
    for stale in (part, part + ".done"):
        if os.path.exists(stale):
            os.unlink(stale)
    _barrier("tbsc-compress-start")

    nworkers = workers or min(4, os.cpu_count() or 1)
    n_written = 0
    with open(part, "wb") as out:
        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            for offset, blob in ex.map(encode, jobs()):
                out.write(struct.pack(BLOCK_HEADER_FMT, offset, 1,
                                      C.CONTEXTS_FOLLOWING))
                out.write(blob)
                n_written += 1
    with open(part + ".done", "w") as f:
        f.write(str(n_written))

    if _process_id == 0:
        # wait for every part (shared-file-system barrier), then merge in
        # pid order
        for p in range(_num_processes):
            while not os.path.exists(_part_path(outp, p) + ".done"):
                time.sleep(0.05)
        with open(outp, "wb") as out:
            out.write(FILE_SIGN)
            out.write(struct.pack("<i", n_blocks))
            for p in range(_num_processes):
                expected = sum(1 for i in range(n_blocks)
                               if i % _num_processes == p)
                with open(_part_path(outp, p) + ".done") as f:
                    got = int(f.read().strip() or "-1")
                if got != expected:
                    raise BscError(
                        C.DATA_CORRUPT,
                        f"part {p} has {got} blocks, expected {expected}")
                with open(_part_path(outp, p), "rb") as f:
                    out.write(f.read())
                os.unlink(_part_path(outp, p))
                os.unlink(_part_path(outp, p) + ".done")


def decompress_file(inp: str, outp: str,
                    features: int = C.DEFAULT_FEATURES,
                    workers: int | None = None) -> None:
    """Decompress a striped (or regular CLI) archive; process p decodes
    its stripe and seek-writes each block at its offset."""
    from ..filters import preprocessing

    api.init(features, device=_device)
    with open(inp, "rb") as f:
        if f.read(4) != FILE_SIGN:
            raise BscError(C.DATA_CORRUPT, "bad file sign")
        (n_blocks,) = struct.unpack("<i", f.read(4))
        blobs = []
        total_size = 0
        for i in range(n_blocks):
            offset, rs, ctx = struct.unpack(BLOCK_HEADER_FMT, f.read(10))
            header = f.read(C.HEADER_SIZE)
            block_size, data_size = api.block_info(header)
            payload = f.read(block_size - C.HEADER_SIZE)
            total_size = max(total_size, offset + data_size)
            if i % _num_processes == _process_id:
                blobs.append((offset, rs, ctx, header + payload))

    def decode(args):
        offset, rs, ctx, blob = args
        data = api.decompress(blob)
        if ctx == C.CONTEXTS_PRECEDING:
            data = data[::-1]
        if rs > 1:
            arr = np.frombuffer(data, dtype=np.uint8).copy()
            preprocessing.reorder_reverse(arr, rs)
            data = arr.tobytes()
        return offset, data

    # Ensure the file exists and is sized exactly: a pre-existing longer
    # file must not keep stale bytes past the decoded data.  Every process
    # computed total_size from all block headers, so truncating is safe
    # with concurrent stripe writes.
    if not os.path.exists(outp):
        open(outp, "wb").close()
    nworkers = workers or min(4, os.cpu_count() or 1)
    with open(outp, "r+b") as out:
        out.truncate(total_size)
        with ThreadPoolExecutor(max_workers=nworkers) as ex:
            for offset, data in ex.map(decode, blobs):
                out.seek(offset)
                out.write(data)
