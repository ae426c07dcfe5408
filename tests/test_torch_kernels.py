"""The port's kernels against the JAX package's Pallas kernels: ``swin_block`` and ``attn_ln``.

On the CPU each kernel wrapper runs its plain PyTorch version; those are held
against the Pallas functions in interpret mode (``interpret=True``) on the
same numpy-drawn inputs and weights, at tiny shapes, to 1e-5 abs/rel (f32).
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda*.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from mumpy_tpu.ops.pallas import attn_ln as p_attn_ln
from mumpy_tpu.ops.pallas import swin_block as p_swin_block
from mumpy_tpu_torch.ops import attn_ln, swin_block
from torch_cases import (HEADS, WIN, Draw, attn_operands, attn_weights, mask_bias,
                         mlp_operands, mlp_weights, t, windows)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_plain_matches_pallas(shifted):
    d = Draw(1)
    a, m, mb, x = attn_weights(d), mlp_weights(d), mask_bias(d, shifted), windows(d)
    jw = dict(a, ln1_scale=a["ln_scale"], ln1_bias=a["ln_bias"], ln2_scale=m["ln_scale"],
              ln2_bias=m["ln_bias"], fc1_kernel=m["w1"], fc1_bias=m["b1"],
              fc2_kernel=m["w2"], fc2_bias=m["b2"])
    jw = {k: jnp.asarray(v) for k, v in jw.items()}
    prepared = p_swin_block.prepare_weights(jw, jnp.asarray(mb), heads=HEADS, r=x.shape[0],
                                            form="perhead")
    ref = p_swin_block.fused_swin_block_prepared(
        jnp.asarray(x), prepared, heads=HEADS, n=WIN * WIN, p_w=mb.shape[0],
        interpret=True, form="perhead")
    ops = {"attn": attn_operands(a, mb), "mlp": mlp_operands(m)}
    np.testing.assert_allclose(swin_block.swin_block(t(x), ops).numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_attn_ln_plain_matches_pallas(shifted):
    d = Draw(2)
    a, mb, x = attn_weights(d), mask_bias(d, shifted), windows(d)
    prepared = p_attn_ln.prepare_attn_weights({k: jnp.asarray(v) for k, v in a.items()},
                                              jnp.asarray(mb), heads=HEADS, r=x.shape[0])
    y_ref, out_ref = p_attn_ln.fused_attn_ln_prepared(
        jnp.asarray(x), prepared, heads=HEADS, n=WIN * WIN, p_w=mb.shape[0], interpret=True)
    y, out = attn_ln.attn_ln(t(x), attn_operands(a, mb))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
