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

* forward, saving only ``x``, the mask+bias, the keeps and the weights: the
  LN1 + qkv GEMM, the window-attention core (period-P mask+bias), the
  projection GEMM whose row-scale epilogue writes ``x2 = x + keep1[r] *
  proj``, the LN2 + fc1 GEMM with the GELU epilogue, and the fc2 GEMM whose
  epilogue writes ``y = x2 + keep2[r] * f2``;
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
  row-split sums that ``_train_bwd_dw_kernel`` keeps in VMEM.

f32 composes these launches here (:func:`forward_sequence`,
:func:`backward_sequence`, the backward with ``attn_ln_train``'s and
``ln_mlp_train``'s halves): the SIMT loop of ``csrc/gemm.cu`` with its
LayerNorm prologue, ``csrc/wgrad.cu``'s sums.  bf16 launches the same
sequence from one C call each way (``csrc/swin_block_train.cu``; a
Python-composed sequence of some 30 launches costs more host time than its
kernels' device time): the wgmma GEMM of ``csrc/gemm_sm90.cu`` with the
LayerNorms as ``csrc/train_rows.cu``'s row kernel first and its TN form for
the weight gradients, the tensor-core attention cores.  On the CPU the model
of that C call runs the composed sequence, so the launch tests hold it.

The mask+bias gradient leaves the ``Function`` per slot of the period, in
the (P, H, N, N) term's dtype, and autograd carries it through
``rel_pos_bias``'s gather into the relative-position table; the JAX package
returns the row sum in slot 0, and the two agree summed over P (the shift
mask is a constant).  The shifted block's roll and window partition stay
outside, as the JAX package runs them in XLA around its call.  The input
gradients' products read the torch weights as stored, (out, in); the
forward's products take them as (in, out): in bf16 the wgmma GEMM reads the
weights in place through their transposed views, in f32 the forward builds
copies once per call and keeps them for the backward's recompute.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attn_ln_train import _attention, attn_bwd_from, attn_ln_train_plain, attn_recompute
from .counts import count_launch
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
    def forward(ctx, x, mb, keep1, keep2, *weights_and_heads):
        *weights, heads = weights_and_heads
        # (in, out) operands of the forward's and the recompute's products: bf16
        # reads the weights as stored (csrc/swin_block_train.cu), f32 takes
        # copies once per call and keeps them for the backward
        if x.dtype == torch.bfloat16:
            transposed = ()
            y = cuda_lib.swin_block_train_fwd(x, mb, keep1, keep2, weights, heads)
        else:
            transposed = tuple(weights[i].t().contiguous() for i in (2, 4, 8, 10))
            y = forward_sequence(x, mb, keep1, keep2, weights, transposed, heads)
        ctx.save_for_backward(x, mb, keep1, keep2, *weights, *transposed[:3])
        ctx.heads = heads
        return y

    @staticmethod
    def backward(ctx, dy):
        count_launch(swin_block_train, "backward_launches")
        x, mb, keep1, keep2, *rest = ctx.saved_tensors
        weights, transposed = rest[:12], rest[12:] or (None, None, None)  # f32 only
        grads = launch_swin_block_train_bwd(x, mb, keep1, keep2, *weights, *transposed,
                                            ctx.heads, dy)
        return (*grads, None)


def forward_sequence(x, mb, keep1, keep2, weights, transposed, heads):
    """The forward's launches, composed here: ``weights`` as in
    :data:`_WEIGHTS`, ``transposed`` the (in, out) operands of qkv, proj,
    fc1 and fc2 (copies, or in bf16 the weights' ``.t()`` views).  f32 runs
    this; bf16 runs the same sequence in one call of
    ``csrc/swin_block_train.cu`` (this is its model on the CPU)."""
    ln1_g, ln1_b, _, b_qkv, _, b_proj, ln2_g, ln2_b, _, b1, _, b2 = weights
    wq_t, wp_t, w1_t, w2_t = transposed
    r, n, c = x.shape
    x2d = x.reshape(r * n, c)
    gemm = cuda_lib.train_gemm
    o = _attention(x2d, wq_t, b_qkv, mb, r, n, heads, ln=(ln1_g, ln1_b), gemm=gemm)[1]
    _, x2 = gemm(o, wp_t, b_proj, res=x2d, want_y=False, want_out=True, row_scale=keep1,
                 scale_div=n)
    g, _ = gemm(x2, w1_t, b1, ln=(ln2_g, ln2_b), gelu=True)
    _, y = gemm(g, w2_t, b2, res=x2, want_y=False, want_out=True, row_scale=keep2, scale_div=n)
    return y.reshape(r, n, c)


def launch_swin_block_train_bwd(x, mb, keep1, keep2, ln1_g, ln1_b, w_qkv, b_qkv, w_proj,
                                b_proj, ln2_g, ln2_b, w1, b1, w2, b2, wq_t, wp_t, w1_t, heads,
                                dy, rowsum=True, gelu_grad=True, row_scale=True):
    """The backward's launches: in bf16 one call of csrc/swin_block_train.cu
    (which reads the weights as stored; ``wq_t``, ``wp_t``, ``w1_t`` serve
    f32), in f32 :func:`backward_sequence`.  Returns the gradients of (x, mb,
    keep1, keep2, ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g, ln2_b,
    w1, b1, w2, b2); ``rowsum=False``, ``gelu_grad=False`` and
    ``row_scale=False`` are planted faults of the checks (the softmax
    backward without its rowsum term, gelu' replaced by 1, and, in bf16, the
    recompute's projection GEMM ignoring its row scale keep1)."""
    weights = (ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g, ln2_b, w1, b1, w2, b2)
    if x.dtype == torch.bfloat16:
        dx, dmb, *grads = cuda_lib.swin_block_train_bwd(
            x, mb, keep1, keep2, weights, heads, dy, rowsum=rowsum, gelu_grad=gelu_grad,
            row_scale=row_scale)
        return (dx, dmb, None, None, *grads)
    return backward_sequence(x, mb, keep1, keep2, *weights, wq_t, wp_t, w1_t, heads, dy,
                             rowsum, gelu_grad, row_scale)


def backward_sequence(x, mb, keep1, keep2, ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g,
                      ln2_b, w1, b1, w2, b2, wq_t, wp_t, w1_t, heads, dy, rowsum=True,
                      gelu_grad=True, row_scale=True):
    """The backward's launches, composed here from the halves #8 shares with
    ``attn_ln_train`` and ``ln_mlp_train``: f32 runs this; bf16 runs the same
    sequence in one call of ``csrc/swin_block_train.cu`` (this is its model
    on the CPU).  Arguments and result as :func:`launch_swin_block_train_bwd`."""
    r, n, c = x.shape
    x2d = x.reshape(r * n, c)
    rec = attn_recompute(x2d, ln1_g, ln1_b, wq_t, b_qkv, mb, r, n, heads)
    _, x2 = cuda_lib.train_gemm(rec[4], wp_t, b_proj, res=x2d, want_y=False, want_out=True,
                                row_scale=keep1, scale_div=n, row_scale_on=row_scale)
    dx2, _, *mlp_grads = launch_ln_mlp_train_bwd(x2, keep2, ln2_g, ln2_b, w1, b1, w2, w1_t,
                                                 dy.reshape(r * n, c), div=n,
                                                 gelu_grad=gelu_grad)
    dx, dmb, _, *attn_grads = attn_bwd_from(x2d, rec, mb, keep1, ln1_g, w_qkv, w_proj, None,
                                            dx2, rowsum)
    return (dx, dmb, None, None, *attn_grads, *mlp_grads)


def swin_block_train(x, mb, p, keep1, keep2):
    """``x`` (R, N, C) windows -> the differentiable block output ``y``.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    ``swin_block_train.launches`` counts forward launches,
    ``swin_block_train.backward_launches`` the backward's."""
    if x.device.type == "cpu":
        return swin_block_train_plain(x, mb, p, keep1, keep2)
    count_launch(swin_block_train)
    return launch_swin_block_train(x, mb, p, keep1, keep2)


def launch_swin_block_train(x, mb, p, keep1, keep2):
    """The kernel's forward launches, differentiable through its backward's."""
    return _SwinBlockTrain.apply(cuda_lib.aligned(x), mb,
                                 keep1.float().contiguous(), keep2.float().contiguous(),
                                 *(p[k] for k in _WEIGHTS), p["heads"])


swin_block_train.launches = 0
swin_block_train.backward_launches = 0
