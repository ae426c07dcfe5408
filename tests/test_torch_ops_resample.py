"""The PyTorch port's tensor ops against their ``mumpy_tpu.ops`` counterparts: resizing and
pixel shuffle.

Each test draws its inputs with numpy from a seed and feeds the same arrays
to the JAX function and to the port, in f32.  Tolerance: 1e-5 abs/rel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mumpy_tpu.ops import pixel as jpix
from mumpy_tpu.ops import resize as jres
from mumpy_tpu_torch.ops import pixel as tpix
from mumpy_tpu_torch.ops import resize as tres
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("hw_in,hw_out", [((7, 7), (14, 14)), ((13, 9), (17, 30))])
def test_resize_bilinear(align, hw_in, hw_out):
    x = _rand(5, 2, *hw_in, 3)
    _close(tres.resize_bilinear(torch.from_numpy(x), hw_out, align),
           jres.resize_bilinear(jnp.asarray(x), hw_out, align))


@pytest.mark.parametrize("align", [True, False])
def test_upsample_2d(align):
    x = _rand(6, 2, 7, 7, 4)
    _close(tres.upsample_2d(torch.from_numpy(x), 4, align),
           jres.upsample_2d(jnp.asarray(x), 4, align))


def test_pixel_shuffle():
    x = _rand(7, 2, 5, 6, 12)
    _close(tpix.pixel_shuffle(torch.from_numpy(x), 2), jpix.pixel_shuffle(jnp.asarray(x), 2))
