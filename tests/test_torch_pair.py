"""The port's ``swin_pair`` against the JAX package's Pallas pair kernel.

``swin_pair_plain`` (two plain blocks around the rolled window permutation)
is held against ``fused_pair_prepared(..., interpret=True)`` at two of
``tests/test_pair_fusion.py``'s cases, drawn as that test draws them (same
generator, weights, mask and bias), f32, 1e-5 abs/rel; and the port's row
map against the JAX package's own permutation of the shifted layout
(``ops/window.py:img_to_window_perm``), including the view-3 grid whose roll
wraps across the three folded time slices.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mumpy_tpu.ops import window as jwin
from mumpy_tpu.ops.pallas import swin_pair as p_swin_pair
from mumpy_tpu_torch.ops import swin_pair
from test_fused_block import _make_weights
from torch_cases import PAIR_GEOMETRIES, block_operands, t
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("geometry", list(PAIR_GEOMETRIES))
def test_swin_pair_plain_matches_pallas(geometry):
    win, shift, nwh, nww, c, heads = PAIR_GEOMETRIES[geometry]
    gh, gw, n, nw = nwh * win, nww * win, win * win, nwh * nww
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2 * nw, n, c)).astype(np.float32)
    wa, wb = (_make_weights(rng, c, 4 * c) for _ in range(2))
    mask = np.asarray(jwin.shifted_window_mask(gh, gw, win, shift))
    bias_s, bias_p = ((rng.standard_normal((heads, n, n)) * 0.1).astype(np.float32)
                      for _ in range(2))
    mb_s, mb_p = mask[:, None] + bias_s[None], bias_p[None]
    prepared = p_swin_pair.prepare_pair(wa, wb, jnp.asarray(mb_s), jnp.asarray(mb_p),
                                        wdtype=jnp.float32)
    ref = p_swin_pair.fused_pair_prepared(jnp.asarray(x), prepared, heads=heads, w=win,
                                          s=shift, nwh=nwh, nww=nww, interpret=True)
    numpy_w = [{k: np.array(v, np.float32) for k, v in w.items()} for w in (wa, wb)]
    ops = swin_pair.swin_pair_operands(
        block_operands(numpy_w[0], mb_s, heads), block_operands(numpy_w[1], mb_p, heads),
        swin_pair.shift_row_map(gh, gw, win, shift), (gh, gw, win, shift))
    np.testing.assert_allclose(swin_pair.swin_pair(t(x), ops).numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("grid", [(8, 8, 4, 2), (42, 14, 7, 3)])
def test_shift_row_map_matches_jax_permutation(grid):
    """Row m of the shifted layout holds the token at image position
    img_to_window_perm(...)[m]; the map points at the unshifted row that
    holds the same position."""
    gh, gw, win, shift = grid
    shifted_pos = np.asarray(jwin.img_to_window_perm(gh, gw, win, shift))
    unshifted_pos = np.asarray(jwin.img_to_window_perm(gh, gw, win, 0))
    row_map = swin_pair.shift_row_map(gh, gw, win, shift).numpy()
    np.testing.assert_array_equal(unshifted_pos[row_map], shifted_pos)
