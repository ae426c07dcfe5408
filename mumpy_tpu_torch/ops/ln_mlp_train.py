"""Kernel ``ln_mlp_train``: ``x + keep * fc2(gelu(fc1(LN(x))))`` on 2-D rows,
differentiable, with a per-row stochastic-depth keep factor.

Replaces ``mumpy_tpu/ops/pallas/ln_mlp_vjp.py:fused_ln_mlp_train``: its
forward kernel ``_fwd_kernel`` and its backward kernel ``_bwd_kernel``, which
recomputes from ``x`` and spills h for the weight-gradient products.  It
carries the tails of the cross-view blocks and of the global-ViT layers on
the training path.  The port keeps that contract:

* forward, two launches, those of ``ln_mlp``: LN + fc1 + GELU, then fc2 with
  the row-scale epilogue ``out = x + keep[m] * f2`` (``csrc/gemm.cu``);
* backward, six launches, recomputing from ``x``: the LayerNorm rows (h and
  the row statistics, ``csrc/train_rows.cu``), ``f1 = h W1 + b1``,
  ``df2 = keep * dy``, ``df1 = (df2 W2^T) * gelu'(f1)`` (the GELU-backward
  epilogue, which reads f1), ``dh = df1 W1^T``, and the LayerNorm backward
  with ``dy`` added; then the weight and bias gradients of fc1 and fc2 and
  the LayerNorm scale and bias gradients (``csrc/wgrad.cu``), which the JAX
  package sums in XLA outside its kernel.  ``gelu(f1)``, which only the fc2
  weight gradient reads, comes from the GELU-backward epilogue, which reads
  f1 anyway.  ``swin_block_train`` runs this backward for its MLP half, with
  its keep2 per window of ``div`` rows.

As in ``attn_ln_train``, the transposed products read the torch weights as
stored; the forward builds (in, out) copies once per call.  Rows need not be a
multiple of 8 (the ViT tails have B*49*3): the GEMM masks its ragged M edge.
GELU is the exact erf form, as in serving; the Pallas kernels use a
polynomial erf (A&S 7.1.26, |error| < 1.5e-7).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

__all__ = ["ln_mlp_train", "ln_mlp_train_plain", "ln_mlp_weights"]


def ln_mlp_weights(norm, mlp):
    """The live parameters of a LayerNorm + Mlp, torch layouts."""
    return {"ln_g": norm.weight, "ln_b": norm.bias, "w1": mlp.fc1.weight, "b1": mlp.fc1.bias,
            "w2": mlp.fc2.weight, "b2": mlp.fc2.bias}


def ln_mlp_train_plain(x, p, keep):
    """Plain PyTorch version of the same function, differentiated by
    autograd.  ``x`` (rows, C), ``p`` from :func:`ln_mlp_weights`, ``keep``
    (rows,) f32."""
    h = F.layer_norm(x, (x.shape[-1],), p["ln_g"], p["ln_b"], 1e-5)
    f2 = F.linear(F.gelu(F.linear(h, p["w1"], p["b1"])), p["w2"], p["b2"])
    return x + keep.to(x.dtype)[:, None] * f2


class _LnMlpTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, ln_g, ln_b, w1, b1, w2, b2):
        w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
        g, _ = cuda_lib.gemm(x, w1_t, b1, ln=(ln_g, ln_b), gelu=True)
        _, out = cuda_lib.gemm(g, w2_t, b2, res=x, want_y=False, want_out=True,
                               row_scale=keep)
        ctx.save_for_backward(x, keep, ln_g, ln_b, w1, b1, w2, w1_t)
        return out

    @staticmethod
    def backward(ctx, dy):
        ln_mlp_train.backward_launches += 1
        return launch_ln_mlp_train_bwd(*ctx.saved_tensors, dy)


def launch_ln_mlp_train_bwd(x, keep, ln_g, ln_b, w1, b1, w2, w1_t, dy, div=1,
                            gelu_grad=True):
    """The backward's launches.  Returns the gradients of (x, keep, ln_g, ln_b,
    w1, b1, w2, b2); ``keep`` holds one factor per ``div`` rows.
    ``gelu_grad=False`` is the planted fault of the checks (gelu' replaced by
    1; gelu(f1) is then not computed and the fc2 weight gradient is zero)."""
    dy = dy.contiguous()
    h, mu, rstd = cuda_lib.ln_rows(x, ln_g, ln_b)
    f1, _ = cuda_lib.gemm(h, w1_t, b1)
    df2 = cuda_lib.scale_add_rows(None, dy, keep, div=div)
    g = torch.empty_like(f1) if gelu_grad else torch.zeros_like(f1)
    df1, _ = cuda_lib.gemm(df2, w2, gelu_grad_of=f1 if gelu_grad else None,
                           gelu_out=g if gelu_grad else None)
    dh, _ = cuda_lib.gemm(df1, w1)
    dx = cuda_lib.ln_bwd_rows(x, mu, rstd, ln_g, dh, dres=dy)
    return (dx, None, *cuda_lib.ln_param_grads(x, mu, rstd, ln_g, dh),
            *cuda_lib.weight_grads(df1, h), *cuda_lib.weight_grads(df2, g))


def ln_mlp_train(x, p, keep):
    """``x`` (rows, C) -> differentiable ``x + keep * Mlp(LN(x))``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    ``ln_mlp_train.launches`` counts forward launches,
    ``ln_mlp_train.backward_launches`` the backward's."""
    if x.device.type == "cpu":
        return ln_mlp_train_plain(x, p, keep)
    ln_mlp_train.launches += 1
    return launch_ln_mlp_train(x, p, keep)


def launch_ln_mlp_train(x, p, keep):
    """The kernel's forward launches, differentiable through its backward's."""
    return _LnMlpTrain.apply(cuda_lib.aligned(x), keep.float().contiguous(), p["ln_g"],
                             p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"])


ln_mlp_train.launches = 0
ln_mlp_train.backward_launches = 0
