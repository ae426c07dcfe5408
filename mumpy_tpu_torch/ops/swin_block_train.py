"""Kernel ``swin_block_train``: a whole Swin block on window tokens for
training, differentiable, with per-window stochastic-depth keep factors on
both residual branches.

    x2 = x  + keep1 * proj(MSA(LN1(x)) + mb)
    y  = x2 + keep2 * fc2(gelu(fc1(LN2(x2))))

Replaces ``mumpy_tpu/ops/pallas/swin_block_vjp.py:fused_block_train``: its
forward kernel ``_train_fwd_kernel`` and its backward kernels
``_train_bwd_kernel`` / ``_train_bwd_dw_kernel``, which recompute the block
from ``x`` and give dx, the score gradients and the weight gradients (spilled
operands or in-kernel sums).  The port keeps that contract:

* forward, five launches, saving only ``x``, the mask+bias, the keeps and
  the weights: the LN1 + qkv GEMM, the window-attention core (period-P
  mask+bias), the projection GEMM whose row-scale epilogue writes
  ``x2 = x + keep1[r] * proj`` (``csrc/gemm.cu``), the LN2 + fc1 GEMM with
  the GELU epilogue, and the fc2 GEMM whose epilogue writes
  ``y = x2 + keep2[r] * f2``;
* backward, recomputing the attention half once from ``x``: the LN1 rows
  (h1 and the row statistics, ``csrc/train_rows.cu``), the qkv GEMM, the
  attention core (o), the projection GEMM (x2); then ``ln_mlp_train``'s
  backward on x2 with keep2 per window (the LN2 rows, fc1, ``df2 = keep2 *
  dy``, the GELU-backward epilogue that also writes gelu(f1), ``dh2 = df1
  W1^T``, the LN2 backward with ``dy`` added: dx2); then
  ``attn_ln_train``'s backward from the recompute on dx2 (``dproj = keep1 *
  dx2``, ``do = dproj Wproj^T``, the attention backward, ``dh1 = dqkv
  Wqkv^T``, the LN1 backward with ``dx2`` added: dx).  Each half ends with
  its weight and bias gradients and LayerNorm scale and bias gradients, the
  row-split sums of ``csrc/wgrad.cu`` that ``_train_bwd_dw_kernel`` keeps in
  VMEM.

The mask+bias gradient leaves the ``Function`` per slot of the period,
through the padded (P, H, N, 64) term, and autograd carries it through
``pad_mask_bias``'s slice and ``rel_pos_bias``'s gather into the
relative-position table; the JAX package returns the row sum in slot 0, and
the two agree summed over P (the shift mask is a constant).  The shifted
block's roll and window partition stay outside, as the JAX package runs them
in XLA around its call.  As in ``attn_ln_train``, the products with
transposed weights read the torch weights as stored, (out, in); the forward
builds the (in, out) copies once per call and keeps them for the backward.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attn_ln import pad_mask_bias
from .attn_ln_train import _attention, attn_bwd_from, attn_ln_train_plain, attn_recompute
from .ln_mlp_train import launch_ln_mlp_train_bwd, ln_mlp_train_plain

__all__ = ["swin_block_train", "swin_block_train_plain", "swin_block_weights"]

_WEIGHTS = ("ln1_g", "ln1_b", "w_qkv", "b_qkv", "w_proj", "b_proj", "ln2_g", "ln2_b",
            "w1", "b1", "w2", "b2")


def swin_block_weights(params, heads):
    """The 12 live tensors of a block, in ``SwinBlock.train_params()`` order
    less the relative-position table, as the kernel's parameter dict."""
    return {**dict(zip(_WEIGHTS, params)), "heads": heads}


def swin_block_train_plain(x, mb, p, keep1, keep2):
    """Plain PyTorch version of the same function, differentiated by
    autograd.  ``x`` (R, N, C) windows, ``mb`` (P, H, N, N), ``p`` from
    :func:`swin_block_weights`, ``keep1`` / ``keep2`` (R,) f32."""
    r, n, c = x.shape
    attn = {"ln_g": p["ln1_g"], "ln_b": p["ln1_b"], "w_qkv": p["w_qkv"], "b_qkv": p["b_qkv"],
            "w_proj": p["w_proj"], "b_proj": p["b_proj"], "heads": p["heads"]}
    _, x2 = attn_ln_train_plain(x, mb, attn, keep1)
    mlp = {"ln_g": p["ln2_g"], "ln_b": p["ln2_b"], "w1": p["w1"], "b1": p["b1"],
           "w2": p["w2"], "b2": p["b2"]}
    y = ln_mlp_train_plain(x2.reshape(r * n, c), mlp, keep2.repeat_interleave(n))
    return y.reshape(r, n, c)


class _SwinBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mbp, keep1, keep2, *weights_and_heads):
        *weights, heads = weights_and_heads
        ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g, ln2_b, w1, b1, w2, b2 = weights
        r, n, c = x.shape
        wq_t, wp_t, w1_t, w2_t = (w.t().contiguous() for w in (w_qkv, w_proj, w1, w2))
        x2d = x.reshape(r * n, c)
        o = _attention(x2d, wq_t, b_qkv, mbp, r, n, heads, ln=(ln1_g, ln1_b))[1]
        _, x2 = cuda_lib.gemm(o, wp_t, b_proj, res=x2d, want_y=False, want_out=True,
                              row_scale=keep1, scale_div=n)
        g, _ = cuda_lib.gemm(x2, w1_t, b1, ln=(ln2_g, ln2_b), gelu=True)
        _, y = cuda_lib.gemm(g, w2_t, b2, res=x2, want_y=False, want_out=True,
                             row_scale=keep2, scale_div=n)
        ctx.save_for_backward(x, mbp, keep1, keep2, *weights, wq_t, wp_t, w1_t)
        ctx.heads = heads
        return y.reshape(r, n, c)

    @staticmethod
    def backward(ctx, dy):
        swin_block_train.backward_launches += 1
        grads = launch_swin_block_train_bwd(*ctx.saved_tensors, ctx.heads, dy)
        return (*grads, None)


def launch_swin_block_train_bwd(x, mbp, keep1, keep2, ln1_g, ln1_b, w_qkv, b_qkv, w_proj,
                                b_proj, ln2_g, ln2_b, w1, b1, w2, b2, wq_t, wp_t, w1_t, heads,
                                dy, rowsum=True, gelu_grad=True):
    """The backward's launches.  Returns the gradients of (x, mbp, keep1,
    keep2, ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g, ln2_b, w1, b1,
    w2, b2); ``rowsum=False`` and ``gelu_grad=False`` are planted faults of
    the checks (the softmax backward without its rowsum term, gelu'
    replaced by 1)."""
    r, n, c = x.shape
    x2d = x.reshape(r * n, c)
    rec = attn_recompute(x2d, ln1_g, ln1_b, wq_t, b_qkv, mbp, r, n, heads)
    _, x2 = cuda_lib.gemm(rec[4], wp_t, b_proj, res=x2d, want_y=False, want_out=True,
                          row_scale=keep1, scale_div=n)
    dx2, _, *mlp_grads = launch_ln_mlp_train_bwd(x2, keep2, ln2_g, ln2_b, w1, b1, w2, w1_t,
                                                 dy.reshape(r * n, c), div=n,
                                                 gelu_grad=gelu_grad)
    dx, dmbp, _, *attn_grads = attn_bwd_from(x2d, rec, mbp, keep1, ln1_g, w_qkv, w_proj, None,
                                             dx2, rowsum)
    return (dx, dmbp, None, None, *attn_grads, *mlp_grads)


def swin_block_train(x, mb, p, keep1, keep2):
    """``x`` (R, N, C) windows -> the differentiable block output ``y``.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    ``swin_block_train.launches`` counts forward launches,
    ``swin_block_train.backward_launches`` the backward's."""
    if x.device.type == "cpu":
        return swin_block_train_plain(x, mb, p, keep1, keep2)
    swin_block_train.launches += 1
    return launch_swin_block_train(x, mb, p, keep1, keep2)


def launch_swin_block_train(x, mb, p, keep1, keep2):
    """The kernel's forward launches, differentiable through its backward's."""
    return _SwinBlockTrain.apply(cuda_lib.aligned(x), pad_mask_bias(mb),
                                 keep1.float().contiguous(), keep2.float().contiguous(),
                                 *(p[k] for k in _WEIGHTS), p["heads"])


swin_block_train.launches = 0
swin_block_train.backward_launches = 0
