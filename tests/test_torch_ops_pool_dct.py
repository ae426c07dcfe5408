"""The PyTorch port's tensor ops against their ``mumpy_tpu.ops`` counterparts: pooling and
the DCT frequency branch.

Each test draws its inputs with numpy from a seed and feeds the same arrays
to the JAX function and to the port, in f32.  Tolerance: 1e-5 abs/rel for pooling;
1e-4 for the 224-wide DCT sandwich (four chained 224-term f32 contractions
summed in different orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mumpy_tpu.ops import dct as jdct
from mumpy_tpu.ops import pixel as jpix
from mumpy_tpu_torch.ops import dct as tdct
from mumpy_tpu_torch.ops import pixel as tpix
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


def test_avg_pool_2d():
    x = _rand(8, 2, 8, 6, 5)
    _close(tpix.avg_pool_2d(torch.from_numpy(x), 2), jpix.avg_pool_2d(jnp.asarray(x), 2))


def test_dap_pool():
    x = _rand(9, 2, 6, 6, 16)
    _close(tpix.dap_pool(torch.from_numpy(x), 2), jpix.dap_pool(jnp.asarray(x), 2))


@pytest.mark.parametrize("size", [32, 224])
def test_dct_matrix_and_bands(size):
    np.testing.assert_array_equal(tdct.dct_matrix(size), jdct.dct_matrix(size))
    np.testing.assert_array_equal(tdct.band_filters(size), jdct.band_filters(size))


@pytest.mark.parametrize("size", [32, 224])
def test_faf(size):
    x = _rand(10, 2, size, size, 3)
    _close(tdct.faf(torch.from_numpy(x)), jdct.faf(jnp.asarray(x)), atol=1e-4, rtol=1e-4)
