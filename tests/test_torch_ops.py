"""The PyTorch port's tensor ops against their ``mumpy_tpu.ops`` counterparts: windows, the
relative-position bias and the grid sample.

Each test draws its inputs with numpy from a seed and feeds the same arrays
to the JAX function and to the port, in f32.  Tolerance: 1e-5 abs/rel.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mumpy_tpu.models import swin as jswin
from mumpy_tpu.ops import grid_sample as jgs
from mumpy_tpu.ops import window as jwin
from mumpy_tpu_torch.models import swin as tswin
from mumpy_tpu_torch.ops import grid_sample as tgs
from mumpy_tpu_torch.ops import window as twin
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


def test_window_partition_and_reverse():
    x = _rand(0, 2, 8, 12, 5)
    wins = twin.window_partition(torch.from_numpy(x), 4)
    _close(wins, jwin.window_partition(jnp.asarray(x), 4))
    _close(twin.window_reverse(wins, 4, 8, 12),
           jwin.window_reverse(jnp.asarray(np.asarray(wins)), 4, 8, 12))


@pytest.mark.parametrize("shift", [0, 2])
def test_partition_tokens_roundtrip(shift):
    x = _rand(1, 2, 8 * 12, 5)
    wins = twin.partition_tokens(torch.from_numpy(x), 8, 12, 4, shift)
    _close(wins, jwin.partition_tokens(jnp.asarray(x), 8, 12, 4, shift))
    _close(twin.unpartition_tokens(wins, 8, 12, 4, shift),
           jwin.unpartition_tokens(jnp.asarray(np.asarray(wins)), 8, 12, 4, shift))


@pytest.mark.parametrize("hw,window,shift", [((8, 8), 4, 2), ((42, 14), 7, 3)])
def test_shifted_window_mask(hw, window, shift):
    _close(twin.shifted_window_mask(*hw, window, shift),
           jwin.shifted_window_mask(*hw, window, shift))


def test_relative_position_bias():
    table = _rand(2, 169, 3)
    np.testing.assert_array_equal(tswin.relative_position_index(7, 7),
                                  jswin.relative_position_index(7, 7))
    _close(tswin.rel_pos_bias(torch.from_numpy(table), 7, 7),
           jswin.rel_pos_bias(jnp.asarray(table), 7, 7))


def test_grid_sample_bilinear():
    x = _rand(3, 3, 7, 7, 6)
    grid = np.random.default_rng(4).uniform(-1.3, 1.3, (3, 49, 2)).astype(np.float32)
    _close(tgs.grid_sample_bilinear(torch.from_numpy(x), torch.from_numpy(grid)),
           jgs.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid)))
