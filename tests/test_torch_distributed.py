"""The port's multi-process block farm (``parallel/distributed.py``) on the
CPU: the one-process archive is byte-equal to the JAX package's
``distributed.compress_file`` and both CLIs decode it; two real processes
on a gloo process group stripe a file through the port's device ST route
(its plain version on the CPU tensors)."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libbsc_tpu import cli as jcli
from libbsc_tpu.parallel import distributed as jdist
from libbsc_tpu_torch import cli
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch.errors import BscError
from libbsc_tpu_torch.parallel import distributed as dist
from tests.conftest import make_corpus

REPO = Path(__file__).resolve().parent.parent
MIB = 1 << 20


@pytest.fixture
def one_process():
    dist.init(num_processes=1, process_id=0, device="cpu")
    jdist.init(num_processes=1, process_id=0)
    yield
    dist.init(num_processes=1, process_id=0, device="cpu")


def _write(tmp_path, n: int, seed: int) -> tuple:
    data = make_corpus(np.random.default_rng(seed), n, "text")
    inp = tmp_path / "in.bin"
    inp.write_bytes(data)
    return data, inp


def test_round_trip(one_process, tmp_path):
    data, inp = _write(tmp_path, 3 * MIB + 12345, 1)
    arch, back = tmp_path / "out.bsc", tmp_path / "back.bin"
    dist.compress_file(str(inp), str(arch), block_size=MIB)
    dist.decompress_file(str(arch), str(back))
    assert back.read_bytes() == data
    assert not list(tmp_path.glob("out.bsc.part*"))


def test_archive_is_the_jax_packages_and_both_clis_decode_it(
        one_process, tmp_path):
    data, inp = _write(tmp_path, 2 * MIB + 777, 2)
    arch, ref = tmp_path / "port.bsc", tmp_path / "jax.bsc"
    dist.compress_file(str(inp), str(arch), block_size=MIB)
    jdist.compress_file(str(inp), str(ref), block_size=MIB)
    assert arch.read_bytes() == ref.read_bytes()
    for name, decode, params in (("port", cli.decompress_file, cli.Params()),
                                 ("jax", jcli.decompress_file,
                                  jcli.Params())):
        back = tmp_path / f"back_{name}"
        decode(str(arch), str(back), params, quiet=True)
        assert back.read_bytes() == data, name


def test_decompress_file_truncates_a_longer_output(one_process, tmp_path):
    data, inp = _write(tmp_path, MIB + 5, 3)
    arch, back = tmp_path / "out.bsc", tmp_path / "back.bin"
    dist.compress_file(str(inp), str(arch), block_size=MIB // 2)
    back.write_bytes(b"x" * (2 * MIB))
    dist.decompress_file(str(arch), str(back))
    assert back.read_bytes() == data


def test_stripe_filter_covers_all_blocks():
    for nproc in (1, 2, 3, 8):
        seen = []
        for pid in range(nproc):
            seen += [i for i in range(17) if i % nproc == pid]
        assert sorted(seen) == list(range(17))


def test_a_part_with_the_wrong_block_count_is_corrupt(one_process, tmp_path,
                                                      monkeypatch):
    """Process 0 of two finds process 1's done marker with a count that is
    not its stripe's."""
    _, inp = _write(tmp_path, 2 * MIB, 4)
    arch = tmp_path / "out.bsc"
    (tmp_path / "out.bsc.part1").write_bytes(b"")
    (tmp_path / "out.bsc.part1.done").write_text("0")
    monkeypatch.setattr(dist, "_num_processes", 2)
    monkeypatch.setattr(dist, "_barrier", lambda tag: None)
    with pytest.raises(BscError) as e:
        dist.compress_file(str(inp), str(arch), block_size=MIB)
    assert e.value.code == C.DATA_CORRUPT


def test_a_bad_file_sign_is_corrupt(one_process, tmp_path):
    bad = tmp_path / "bad.bsc"
    bad.write_bytes(b"bsc0" + bytes(8))
    with pytest.raises(BscError) as e:
        dist.decompress_file(str(bad), str(tmp_path / "x"))
    assert e.value.code == C.DATA_CORRUPT


def test_init_without_cuda_raises_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BscError) as e:
        dist.init()
    assert e.value.code == C.GPU_NOT_SUPPORTED
    dist.init(device="cpu")
    assert dist._device == torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_farm_through_the_device_st_route(tmp_path):
    """Two processes on one gloo group stripe a 2 MiB + 99 file with ST8
    and FEATURE_CUDA on the CPU, so the two 1 MiB blocks take the device
    ST route; neither process loads JAX; both CLIs decode the archive."""
    data, inp = _write(tmp_path, 2 * MIB + 99, 5)
    arch = tmp_path / "out.bsc"
    script = (
        "import sys\n"
        "from libbsc_tpu_torch import constants as C\n"
        "from libbsc_tpu_torch.parallel import distributed as dist\n"
        "pid = int(sys.argv[1])\n"
        f"dist.init(coordinator='localhost:{_free_port()}', "
        "num_processes=2, process_id=pid, device='cpu')\n"
        f"dist.compress_file({str(inp)!r}, {str(arch)!r}, "
        f"block_size={MIB}, block_sorter=8,\n"
        "                   features=C.DEFAULT_FEATURES | C.FEATURE_CUDA)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'libbsc_tpu.'))"
        " for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              cwd=REPO, env=env) for i in range(2)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0, 0]
    for name, decode, params in (("port", cli.decompress_file, cli.Params()),
                                 ("jax", jcli.decompress_file,
                                  jcli.Params())):
        back = tmp_path / f"back_{name}"
        decode(str(arch), str(back), params, quiet=True)
        assert back.read_bytes() == data, name
