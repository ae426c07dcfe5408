"""The port's ``vit3`` against the JAX package's Pallas ViT-layer kernel.

``vit3_plain`` is held against ``fused_vit3_prepared(..., interpret=True)``
on time-major (3, R, C) tokens at R = 20, C = 48, 4 heads, f32, 1e-5 abs/rel.
The Pallas body's polynomial erf differs from the port's exact GELU by less
than 1.5e-7.
"""

import numpy as np

import jax.numpy as jnp

from mumpy_tpu.ops.pallas import vit3 as p_vit3
from mumpy_tpu_torch.ops import vit3
from torch_cases import VIT3_HEADS, t, vit3_case
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


def test_vit3_plain_matches_pallas():
    w, x, ops = vit3_case()
    prepared = p_vit3.prepare_vit3_weights({k: jnp.asarray(v) for k, v in w.items()},
                                           heads=VIT3_HEADS)
    ref = p_vit3.fused_vit3_prepared(jnp.asarray(x), prepared, heads=VIT3_HEADS,
                                     interpret=True)
    np.testing.assert_allclose(vit3.vit3(t(x), ops).numpy(), np.asarray(ref), **TOL)
