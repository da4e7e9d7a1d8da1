"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, and without CUDA it refuses to run unless asked for the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_no_jax_package():
    # a subprocess: this test process already imported jax (conftest)
    code = (
        "import sys\n"
        "import libbsc_tpu_torch\n"
        "from libbsc_tpu_torch import api, cli, engine, filters, native\n"
        "from libbsc_tpu_torch.filters import detectors, preprocessing, "
        "tables\n"
        "from libbsc_tpu_torch.ops import _cuda, bwt, st, stats_kernels, "
        "wide, wide_kernels, wide_schedule\n"
        "from libbsc_tpu_torch import parallel\n"
        "from libbsc_tpu_torch.parallel import distributed\n"
        "from libbsc_tpu_torch.utils import adler32\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'libbsc_tpu' or "
        "m.startswith('libbsc_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_without_cuda_a_call_that_does_not_ask_for_the_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C
    from libbsc_tpu_torch.ops import wide_kernels

    with pytest.raises(P.BscError) as e:
        P.init(C.FEATURE_CUDA)
    assert e.value.code == C.GPU_NOT_SUPPORTED
    with pytest.raises((RuntimeError, AssertionError)):
        wide_kernels.device_encode(bytes(64 * 1024))  # default: cuda
    P.init(C.FEATURE_CUDA, device="cpu")  # asking for the CPU works


def test_other_configurations_are_not_supported():
    """Every sorter and coder of the format is supported; one outside the
    format is refused as a bad parameter, as in the JAX package."""
    import libbsc_tpu_torch as P
    from libbsc_tpu_torch import constants as C

    P.init(C.FEATURE_CUDA, device="cpu")
    for kw in (dict(block_sorter=C.BLOCKSORTER_NONE),
               dict(coder=C.CODER_NONE), dict(block_sorter=9)):
        with pytest.raises(P.BscError) as e:
            P.compress(b"abc" * 1000, **kw)
        assert e.value.code == C.BAD_PARAMETER
    blob = P.compress(b"abc" * 1000, block_sorter=C.BLOCKSORTER_BWT,
                      coder=C.CODER_QLFC_STATIC)
    assert P.decompress(blob) == b"abc" * 1000
