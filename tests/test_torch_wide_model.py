"""K1's plain version against the JAX package's model kernel (interpret
mode) on the same packed planes."""

import numpy as np
import torch

from libbsc_tpu import api as japi
from libbsc_tpu.ops import wide_kernels as jwk
from libbsc_tpu_torch.ops import wide_kernels as pwk
from tests.conftest import make_corpus


def test_model_plane_equals_jax_model_kernel():
    japi.init()
    g = np.random.default_rng(459)
    data = make_corpus(g, 1024 * 48, "text")
    planes, _sizes, max_bits, IT = pwk._host_prep(data)
    ours = pwk.model_probs(torch.from_numpy(planes), max_bits)
    ref = jwk._model_call(256, IT, True)(planes.reshape(IT // 4, 8, 128))
    ref = np.asarray(ref).reshape(IT, 1024)
    assert ours.shape == (IT, 1024)
    assert np.array_equal(ours.numpy(), ref)
    assert not ref[max_bits:].any()
