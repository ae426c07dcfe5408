"""The whole-block training kernel's plain version against the JAX
package's XLA twin.

``swin_block_train_plain`` (the plain PyTorch version of the port's
``swin_block_train`` kernel, differentiated by autograd) against ``jax.vjp``
of ``mumpy_tpu/ops/pallas/swin_block_vjp.py:xla_block_reference``, the
pure-XLA function with the Pallas kernel's contract, un-jitted
(``tests/test_train_kernel.py`` holds the Pallas kernel against it, so
nothing here runs Pallas).  The same numpy-seeded inputs (``torch_cases``:
C 24, 3 heads, 16 tokens, MLP 96) go through both, unshifted (mask+bias
period 1) and shifted (period nW), with keep factors 0, 1 and 1/(1-p) on
both branches in different cycles and a seeded cotangent; y, dx, all 12
weight gradients and d(mask+bias) summed over the period agree within
1e-5 * max(1, max|ref|) in f32.  The twin's GELU uses the polynomial erf of
the Pallas kernels (|error| < 1.5e-7), the port the exact one; that is
inside the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mumpy_tpu.ops.pallas.swin_block_vjp import xla_block_reference
from mumpy_tpu_torch.ops.swin_block_train import swin_block_train_plain
from torch_cases import HEADS, block_train_case, run_with_grads
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
# port name -> (JAX name, stored transposed in the port)
NAMES = {"ln1_g": ("ln1s", False), "ln1_b": ("ln1b", False), "w_qkv": ("wqkv", True),
         "b_qkv": ("bqkv", False), "w_proj": ("wproj", True), "b_proj": ("bproj", False),
         "ln2_g": ("ln2s", False), "ln2_b": ("ln2b", False), "w1": ("wfc1", True),
         "b1": ("bfc1", False), "w2": ("wfc2", True), "b2": ("bfc2", False)}


def _close(got, ref, name):
    ref = np.asarray(ref, np.float32)
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_train_plain_matches_jax_vjp(shifted):
    x, mb, p, keep1, keep2, cots = block_train_case(91, shifted)
    (y,), grads = run_with_grads(swin_block_train_plain, (x, mb, p, keep1, keep2), cots)
    jw = {j: p[k].numpy().T if tr else p[k].numpy()[None] for k, (j, tr) in NAMES.items()}
    r, n, _ = x.shape
    k1, k2 = (jnp.asarray(k.numpy())[:, None] for k in (keep1, keep2))

    def f(xj, mbj, wj):
        return xla_block_reference(xj, mbj, wj, k1, k2, heads=HEADS, n=n, p_w=mb.shape[0])

    jy, vjp = jax.vjp(f, jnp.asarray(x.numpy()), jnp.asarray(mb.numpy()), jw)
    dx, dmb, dw = vjp(jnp.asarray(cots[0].numpy()))
    _close(y, jy, "y")
    _close(grads["x"], dx, "dx")
    _close(grads["mb"].sum(0), np.asarray(dmb).sum(0), "d(mask+bias) summed over P")
    for ours, (theirs, tr) in NAMES.items():
        ref = np.asarray(dw[theirs])
        _close(grads[ours], ref.T if tr else ref[0], ours)
