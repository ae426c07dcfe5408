"""The training kernels' plain versions against the JAX package's XLA twins.

``attn_ln_train_plain`` and ``ln_mlp_train_plain`` (the plain PyTorch
versions of the port's ``attn_ln_train`` / ``ln_mlp_train`` kernels,
differentiated by autograd) against ``jax.vjp`` of
``mumpy_tpu/ops/pallas/attn_ln_vjp.py:xla_attn_ln_reference`` and
``ln_mlp_vjp.py:xla_ln_mlp_reference``, the pure-XLA functions with the
Pallas kernels' contract (``tests/test_train_kernel.py`` holds the Pallas
kernels against them, so nothing here runs Pallas).  The same numpy-seeded
inputs (``torch_cases``: C 24, 3 heads, 16 tokens) go through both, with
keep factors 0, 1 and 1/(1-p) and seeded cotangents; y, out, dx, every
weight gradient and d(mask+bias) agree within 1e-5 * max(1, max|ref|) in
f32.  ln_mlp also runs on a row count that is not a multiple of 8.  The
twins' GELU uses the polynomial erf of the Pallas kernels (|error| <
1.5e-7), the port the exact one; that is inside the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mumpy_tpu.ops.pallas.attn_ln_vjp import xla_attn_ln_reference
from mumpy_tpu.ops.pallas.ln_mlp_vjp import xla_ln_mlp_reference
from mumpy_tpu_torch.ops.attn_ln_train import attn_ln_train_plain
from mumpy_tpu_torch.ops.ln_mlp_train import ln_mlp_train_plain
from torch_cases import HEADS, attn_train_case, mlp_train_case, run_with_grads
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _close(got, ref, name):
    ref = np.asarray(ref, np.float32)
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), (name, err)


@pytest.mark.parametrize("shifted", [False, True])
def test_attn_ln_train_plain_matches_jax_vjp(shifted):
    x, mb, p, keep, cots = attn_train_case(81, shifted)
    (y, out), grads = run_with_grads(attn_ln_train_plain, (x, mb, p, keep), cots)
    jw = {"lns": p["ln_g"].numpy()[None], "lnb": p["ln_b"].numpy()[None],
          "wqkv": p["w_qkv"].numpy().T, "bqkv": p["b_qkv"].numpy()[None],
          "wproj": p["w_proj"].numpy().T, "bproj": p["b_proj"].numpy()[None]}
    r, n, _ = x.shape

    def f(xj, mbj, wj):
        return xla_attn_ln_reference(xj, mbj, wj, jnp.asarray(keep.numpy())[:, None],
                                     heads=HEADS, n=n, p_w=mb.shape[0])

    (jy, jout), vjp = jax.vjp(f, jnp.asarray(x.numpy()), jnp.asarray(mb.numpy()), jw)
    dx, dmb, dw = vjp(tuple(jnp.asarray(c.numpy()) for c in cots))
    _close(y, jy, "y")
    _close(out, jout, "out")
    _close(grads["x"], dx, "dx")
    _close(grads["mb"], dmb, "d(mask+bias)")
    for ours, theirs, t in (("ln_g", "lns", False), ("ln_b", "lnb", False),
                            ("w_qkv", "wqkv", True), ("b_qkv", "bqkv", False),
                            ("w_proj", "wproj", True), ("b_proj", "bproj", False)):
        ref = np.asarray(dw[theirs])
        _close(grads[ours], ref.T if t else ref[0], ours)


@pytest.mark.parametrize("rows", [48, 45])  # 45: not a multiple of 8
def test_ln_mlp_train_plain_matches_jax_vjp(rows):
    x, p, keep, cots = mlp_train_case(82, rows)
    (out,), grads = run_with_grads(ln_mlp_train_plain, (x, p, keep), cots)
    jw = {"lns": p["ln_g"].numpy()[None], "lnb": p["ln_b"].numpy()[None],
          "wfc1": p["w1"].numpy().T, "bfc1": p["b1"].numpy()[None],
          "wfc2": p["w2"].numpy().T, "bfc2": p["b2"].numpy()[None]}

    def f(xj, wj):
        return xla_ln_mlp_reference(xj, wj, jnp.asarray(keep.numpy())[:, None])

    jout, vjp = jax.vjp(f, jnp.asarray(x.numpy()), jw)
    dx, dw = vjp(jnp.asarray(cots[0].numpy()))
    _close(out, jout, "out")
    _close(grads["x"], dx, "dx")
    for ours, theirs, t in (("ln_g", "lns", False), ("ln_b", "lnb", False),
                            ("w1", "wfc1", True), ("b1", "bfc1", False),
                            ("w2", "wfc2", True), ("b2", "bfc2", False)):
        ref = np.asarray(dw[theirs])
        _close(grads[ours], ref.T if t else ref[0], ours)
