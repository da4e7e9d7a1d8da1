"""The API under the no-native engine (``TBSC_ENGINE=numpy``,
``engine._force``): every QLFC coder and sorter round-trips on the port
without loading its native runtime, and each archive equals the JAX
package's with its native runtime disabled (``engine._force = "numpy"``,
``engine._native = None``, ``ops.wide._native_lib`` returning None)."""

import numpy as np
import pytest

import libbsc_tpu as J
import libbsc_tpu_torch as P
from libbsc_tpu import engine as jengine
from libbsc_tpu.ops import wide as jwide
from libbsc_tpu_torch import constants as C
from libbsc_tpu_torch import engine as pengine
from libbsc_tpu_torch import native as pnative
from libbsc_tpu_torch.utils import adler32 as padler
from tests.conftest import make_corpus

N = 30_000
CODERS = [C.CODER_QLFC_STATIC, C.CODER_QLFC_ADAPTIVE, C.CODER_QLFC_FAST,
          C.CODER_QLFC_WIDE]
SORTERS = [C.BLOCKSORTER_BWT, C.BLOCKSORTER_ST3, C.BLOCKSORTER_ST5,
           C.BLOCKSORTER_ST8]
CELLS = [(s, c) for s in SORTERS for c in CODERS]


@pytest.fixture(scope="module")
def data():
    return make_corpus(np.random.default_rng(3030), N, "text")


@pytest.fixture(scope="module")
def jax_archives(data):
    """The JAX package's archive of every cell with its native runtime
    disabled, one compress each (the JAX package itself unedited)."""
    mp = pytest.MonkeyPatch()
    try:
        J.init()
        mp.setattr(jengine, "_force", "numpy")
        mp.setattr(jengine, "_native", None)
        mp.setattr(jwide, "_native_lib", lambda: None)
        out = {cell: J.compress(data, block_sorter=cell[0], coder=cell[1])
               for cell in CELLS}
        with pytest.raises(J.BscError) as e:
            J.compress(data, block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                       coder=C.CODER_QLFC_WIDE)
        out["wideaux"] = e.value.code
        return out
    finally:
        mp.undo()


@pytest.fixture
def numpy_engine(monkeypatch):
    """The port under TBSC_ENGINE=numpy with a native runtime that must
    never be loaded."""
    def refuse():
        raise AssertionError("native.load called under TBSC_ENGINE=numpy")

    monkeypatch.setattr(pengine, "_force", "numpy")
    monkeypatch.setattr(pnative, "load", refuse)
    monkeypatch.setattr(padler, "_native_fn", None)
    P.init(C.DEFAULT_FEATURES, device="cpu")


@pytest.mark.parametrize("sorter,coder", CELLS)
def test_numpy_engine_archive_equals_jax_no_native(data, jax_archives,
                                                   numpy_engine, sorter,
                                                   coder):
    archive = P.compress(data, block_sorter=sorter, coder=coder)
    assert archive == jax_archives[sorter, coder]
    assert P.decompress(archive) == data


def test_numpy_engine_decompress_batch(data, jax_archives, numpy_engine):
    blocks = [jax_archives[C.BLOCKSORTER_ST5, C.CODER_QLFC_STATIC],
              jax_archives[C.BLOCKSORTER_BWT, C.CODER_QLFC_WIDE],
              jax_archives[C.BLOCKSORTER_ST5, C.CODER_QLFC_FAST]]
    assert P.decompress_batch(blocks) == [data] * 3


def test_bwt_wideaux_raises_minus_10_in_both(data, jax_archives,
                                             numpy_engine):
    with pytest.raises(P.BscError) as e:
        P.compress(data, block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                   coder=C.CODER_QLFC_WIDE)
    assert e.value.code == jax_archives["wideaux"] == -10


def test_bwt_wideaux_decode_raises_minus_10(data, monkeypatch):
    P.init(C.DEFAULT_FEATURES, device="cpu")
    archive = P.compress(data, block_sorter=C.BLOCKSORTER_BWT_WIDEAUX,
                         coder=C.CODER_QLFC_WIDE)  # the native engine
    monkeypatch.setattr(pengine, "_force", "numpy")
    with pytest.raises(P.BscError) as e:
        P.decompress(archive)
    assert e.value.code == -10


def test_a_corrupt_block_under_numpy_is_data_corrupt(data, jax_archives,
                                                     numpy_engine):
    """A flipped payload byte under a recomputed payload checksum reaches
    the Python decoders; they end in DATA_CORRUPT, never an IndexError."""
    from libbsc_tpu_torch.api import parse_block_header
    from libbsc_tpu_torch.format.header import pack_block_header
    from libbsc_tpu_torch.utils.adler32 import adler32

    for cell in [(C.BLOCKSORTER_BWT, C.CODER_QLFC_STATIC),
                 (C.BLOCKSORTER_ST5, C.CODER_QLFC_FAST),
                 (C.BLOCKSORTER_BWT, C.CODER_QLFC_WIDE)]:
        block = jax_archives[cell]
        h = parse_block_header(block)
        for pos in (C.HEADER_SIZE + 13, len(block) // 2, len(block) - 9):
            body = bytearray(block[C.HEADER_SIZE:])
            body[pos - C.HEADER_SIZE] ^= 0x5A
            bad = pack_block_header(h.block_size, h.data_size, h.mode,
                                    h.index, h.adler32_data,
                                    adler32(bytes(body))) + bytes(body)
            with pytest.raises(P.BscError) as e:
                P.decompress(bad)
            assert e.value.code in (C.DATA_CORRUPT, C.BAD_PARAMETER,
                                    C.UNEXPECTED_EOB)


# The CLI as __main__ under runpy, then whether it loaded the native
# runtime (stderr), so the subprocess can show it did not.
NUMPY_CLI = (
    "import runpy, sys\n"
    "sys.argv = ['libbsc_tpu_torch.cli'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('libbsc_tpu_torch.cli', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "finally:\n"
    "    from libbsc_tpu_torch import native\n"
    "    print('native loaded:', native._lib is not None, file=sys.stderr)\n")


@pytest.mark.parametrize("switches", [["-e2"], ["-m5", "-e1"]])
def test_numpy_engine_cli_subprocess(tmp_path, switches):
    """``TBSC_ENGINE=numpy python -m libbsc_tpu_torch.cli e/d``: both exit
    0 without loading the native runtime, each container entry equals
    the native engine's archive's, and the file comes back."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from libbsc_tpu_torch import cli
    from tests.test_torch_cli import blocks_of

    repo = Path(__file__).resolve().parent.parent
    inp = tmp_path / "in.bin"
    inp.write_bytes(make_corpus(np.random.default_rng(64), 64 * 1024,
                                "text"))
    want = tmp_path / "native.bsc"
    cli.compress_file(str(inp), str(want),
                      cli.parse_args(["x", "e", "a", "b", *switches]),
                      quiet=True)
    env = dict(os.environ, PYTHONPATH=str(repo), TBSC_ENGINE="numpy")
    arch, back = tmp_path / "numpy.bsc", tmp_path / "back.bin"
    for args in (["e", str(inp), str(arch), *switches],
                 ["d", str(arch), str(back)]):
        r = subprocess.run([sys.executable, "-c", NUMPY_CLI, *args],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode == 0, r.stderr
        assert "native loaded: False" in r.stderr
    assert blocks_of(arch) == blocks_of(want)
    assert back.read_bytes() == inp.read_bytes()
