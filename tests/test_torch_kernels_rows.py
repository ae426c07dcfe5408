"""The port's kernels against the JAX package's Pallas kernels: ``ln_mlp`` and ``cva``.

On the CPU each kernel wrapper runs its plain PyTorch version; those are held
against the Pallas functions in interpret mode (``interpret=True``) on the
same numpy-drawn inputs and weights, at tiny shapes, to 1e-5 abs/rel (f32).
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda*.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mumpy_tpu.ops.pallas import cva as p_cva
from mumpy_tpu.ops.pallas import ln_mlp as p_ln_mlp
from mumpy_tpu_torch.ops import cva, ln_mlp
from torch_cases import C, HEADS, WIN, Draw, cva_case, mlp_operands, mlp_weights, t
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [37, 64])  # 37: ragged against the Pallas row tile
def test_ln_mlp_plain_matches_pallas(rows):
    d = Draw(3)
    w, x = mlp_weights(d), d(rows, C, std=1.0)
    ref = p_ln_mlp.fused_ln_mlp(jnp.asarray(x), *(jnp.asarray(w[k]) for k in (
        "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")), interpret=True)
    np.testing.assert_allclose(ln_mlp.ln_mlp(t(x), mlp_operands(w)).numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("ratio", [1, 3])
def test_cva_plain_matches_pallas(ratio):
    w, (x1, x2, gy, gx), ops = cva_case(ratio)
    prepared = p_cva.prepare_cva_weights({k: jnp.asarray(v) for k, v in w.items()},
                                         groups=3, heads=HEADS, ws=WIN)
    ref = p_cva.fused_cva_prepared(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(gy),
                                   jnp.asarray(gx), prepared, groups=3, heads=HEADS, ws=WIN,
                                   ratio=ratio, interpret=True)
    got = cva.cva(t(x1), t(x2), t(gy), t(gx), ops)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
