"""Kernel ``attn_ln_train``: the training attention half of the cross-view
blocks, differentiable, with a per-window stochastic-depth keep factor.

    y   = proj(MSA(LN(x)) + mb)
    out = x + keep * y

returns ``(y, out)``: ``y`` is the partner stream the next view's CVA reads
(before drop-path), ``out`` the residual stream.

Replaces ``mumpy_tpu/ops/pallas/attn_ln_vjp.py:fused_attn_ln_train``: its
forward kernel ``_fwd_kernel`` and its backward kernel ``_bwd_kernel``, which
recomputes the forward from ``x`` and spills h1, dqkv, o and dproj for the
weight-gradient products.  The port keeps that contract:

* forward, four launches: the LayerNorm rows, the qkv product, the
  window-attention core, and the projection whose epilogue writes ``y`` and
  ``x + keep[r] * y`` (the GEMM's row-scale epilogue);
* backward, recomputing from ``x`` only the LayerNorm rows (h1 and the row
  statistics, ``csrc/train_rows.cu``) and the qkv product; then ``dproj = dy
  + keep * dout``, ``do = dproj Wproj^T``, the attention backward
  (``csrc/window_attention_bwd.cu``: dqkv, the mask+bias gradient summed over
  windows, and the head outputs o = T(P) V from the P it forms anyway, which
  only the projection's weight gradient reads, so no forward core runs
  again), ``dh1 = dqkv Wqkv^T``, and the LayerNorm backward with the
  residual's ``dout`` added; then the weight and bias gradients of qkv and of
  the projection and the LayerNorm scale and bias gradients (row-split sums
  and their reduction, ``csrc/wgrad.cu``), which the JAX package sums in XLA
  outside its kernel.

In bf16 each direction is one call of ``csrc/swin_block_train.cu``
(``mumpy_attn_ln_train_fwd`` / ``_bwd``: a Python-composed sequence of some
20 launches cost more host time than its kernels' device time), every product
on the persistent wgmma GEMM of ``csrc/gemm_sm90.cu`` (its TN form for the
weight gradients) reading the torch weights as stored, and the backward is
the same function as ``swin_block_train``'s attention half (``attn_bwd``),
which runs it with dproj = keep1 * dx2 and the o of its own recompute.  f32
composes the same sequences here (:func:`forward_sequence`,
:func:`backward_sequence`, also the CPU model of the bf16 calls) on
``csrc/gemm.cu``'s SIMT GEMM with (in, out) copies of the weights, which the
``Function`` builds once per call and keeps for the backward's recompute.
The backward is two steps, :func:`attn_recompute` and :func:`attn_bwd_from`,
so that ``swin_block_train`` can recompute once (with o, which its x2
needs) and reuse the second.  The (P, H, N, N) mask+bias goes to the
attention core as it is, and its gradient leaves the ``Function`` in its
dtype, so autograd carries it through ``rel_pos_bias``'s gather into the
relative-position table.

On the card the products are bound by the tensor-core rate (bf16) or the FMA
rate (f32 SIMT); the bf16 attention backward by bytes, the f32 one by issuing
instructions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .counts import count_launch
from .ln_mlp_train import _operand

__all__ = ["attn_ln_train", "attn_ln_train_plain", "attn_ln_weights"]


def attn_ln_weights(norm, attn, heads):
    """The live parameters of a LayerNorm + window attention, torch layouts."""
    return {"ln_g": norm.weight, "ln_b": norm.bias, "w_qkv": attn.qkv.weight,
            "b_qkv": attn.qkv.bias, "w_proj": attn.proj.weight, "b_proj": attn.proj.bias,
            "heads": heads}


def attn_ln_train_plain(x, mb, p, keep):
    """Plain PyTorch version of the same function, differentiated by
    autograd.  ``x`` (R, N, C) windows, ``mb`` (P, H, N, N), ``p`` from
    :func:`attn_ln_weights`, ``keep`` (R,) f32."""
    r, n, c = x.shape
    heads = p["heads"]
    hd = c // heads
    h = F.layer_norm(x, (c,), p["ln_g"], p["ln_b"], 1e-5)
    q, k, v = F.linear(h, p["w_qkv"], p["b_qkv"]).reshape(r, n, 3, heads, hd).unbind(2)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) * hd**-0.5
    per = mb.shape[0]
    s = (s.reshape(r // per, per, heads, n, n) + mb).reshape(r, heads, n, n)
    a = torch.softmax(s.float(), dim=-1).to(v.dtype)
    o = torch.einsum("rhqk,rkhd->rqhd", a, v).reshape(r, n, c)
    y = F.linear(o, p["w_proj"], p["b_proj"])
    return y, x + keep.to(x.dtype)[:, None, None] * y


_WEIGHTS = ("ln_g", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")


class _AttnLnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj, heads):
        weights = (ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj)
        if x.dtype == torch.bfloat16:
            wq_t = None
            y, out = cuda_lib.attn_ln_train_fwd(x, mb, keep, weights, heads)
        else:
            wq_t = _operand(w_qkv, x.dtype)  # kept for the backward's recompute
            y, out = forward_sequence(x, mb, keep, *weights, heads, wq_t)
        ctx.save_for_backward(x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t)
        ctx.heads = heads
        return y, out

    @staticmethod
    def backward(ctx, dy, dout):
        count_launch(attn_ln_train, "backward_launches")
        x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t = ctx.saved_tensors
        grads = launch_attn_ln_train_bwd(x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj,
                                         wq_t, ctx.heads, dy, dout)
        return (*grads, None)


def _attention(x2, wq_t, b_qkv, mb, r, n, heads, ln=None, gemm=cuda_lib.gemm):
    """qkv = (LN(x2) or x2) Wqkv + b through ``gemm``, then the attention
    core: (qkv, o)."""
    qkv, _ = gemm(x2, wq_t, b_qkv, ln=ln)
    return qkv, cuda_lib.packed_window_attention(qkv, mb, r=r, n=n, heads=heads)


def forward_sequence(x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj, heads, wq_t=None):
    """The forward's launches, composed here: the f32 path, and the CPU model
    of the bf16 call (``mumpy_attn_ln_train_fwd``).  ``wq_t`` is qkv's (in,
    out) operand (None: from ``w_qkv``).  Returns ``(y, out)``."""
    r, n, c = x.shape
    x2 = x.reshape(r * n, c)
    wq_t = _operand(w_qkv, x.dtype) if wq_t is None else wq_t
    o = _attention(x2, wq_t, b_qkv, mb, r, n, heads, ln=(ln_g, ln_b),
                   gemm=cuda_lib.train_gemm)[1]
    y, out = cuda_lib.train_gemm(o, _operand(w_proj, x.dtype), b_proj, res=x2, want_out=True,
                                 row_scale=keep, scale_div=n)
    return y.reshape(r, n, c), out.reshape(r, n, c)


def launch_attn_ln_train_bwd(x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t, heads,
                             dy, dout, rowsum=True):
    """The backward's launches: in bf16 one call of csrc/swin_block_train.cu
    (which reads the weights as stored; ``wq_t``, qkv's (in, out) operand,
    serves f32 and may be None), in f32 :func:`backward_sequence`.  Returns
    the gradients of (x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj);
    ``rowsum=False`` is the planted fault of the checks (the softmax backward
    without its rowsum term)."""
    dy = None if dy is None else dy.contiguous()
    dout = torch.zeros_like(x) if dout is None else dout.contiguous()
    if x.dtype == torch.bfloat16:
        dx, dmb, *grads = cuda_lib.attn_ln_train_bwd(
            x, mb, keep, (ln_g, ln_b, w_qkv, b_qkv, w_proj, None), heads, dy, dout,
            rowsum=rowsum)
        return (dx, dmb, None, *grads)
    return backward_sequence(x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t, heads, dy,
                             dout, rowsum)


def backward_sequence(x, mb, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t, heads, dy, dout,
                      rowsum=True):
    """The backward's launches, composed here: the f32 path, and the CPU
    model of the bf16 call (``mumpy_attn_ln_train_bwd``): the recompute of
    h1 and qkv, then :func:`attn_bwd_from` with o from the attention
    backward.  Arguments and result as :func:`launch_attn_ln_train_bwd`."""
    r, n, c = x.shape
    x2 = x.reshape(r * n, c)
    dy2 = None if dy is None else dy.reshape(r * n, c)
    rec = attn_recompute(x2, ln_g, ln_b, _operand(w_qkv, x.dtype) if wq_t is None else wq_t,
                         b_qkv, mb, r, n, heads, with_o=False)
    return attn_bwd_from(x2, rec, mb, keep, ln_g, w_qkv, w_proj, dy2, dout.reshape(r * n, c),
                         rowsum)


def attn_recompute(x2, ln_g, ln_b, wq_t, b_qkv, mb, r, n, heads, with_o=True):
    """The backward's recompute from the (R*N, C) rows ``x2``: h1 = LN(x2)
    and its f32 row statistics, the packed qkv and, ``with_o``, the head
    outputs o from a forward attention core (else None: the attention
    backward forms them)."""
    h1, mu, rstd = cuda_lib.ln_rows(x2, ln_g, ln_b)
    if with_o:
        qkv, o = _attention(h1, wq_t, b_qkv, mb, r, n, heads, gemm=cuda_lib.train_gemm)
    else:
        (qkv, _), o = cuda_lib.train_gemm(h1, wq_t, b_qkv), None
    return h1, mu, rstd, qkv, o


def attn_bwd_from(x2, rec, mb, keep, ln_g, w_qkv, w_proj, dy, dout, rowsum=True):
    """The attention half's backward from its recompute ``rec``
    (:func:`attn_recompute`; with its o None the attention backward forms o)
    and the (R*N, C) cotangents of ``y`` (``dy``, may be None) and of ``out =
    x + keep * y`` (``dout``).  Returns the gradients of (x, mb, keep, ln_g,
    ln_b, w_qkv, b_qkv, w_proj, b_proj)."""
    h1, mu, rstd, qkv, o = rec
    rows, c = x2.shape
    heads, n = mb.shape[1], mb.shape[2]
    hd = c // heads
    dproj = cuda_lib.scale_add_rows(dy, dout, keep, div=n)
    do, _ = cuda_lib.train_gemm(dproj, w_proj)
    dqkv, dmb, *o_core = cuda_lib.window_attention_bwd(
        qkv, do, mb, r=rows // n, n=n, heads=heads, hd=hd, scale=hd**-0.5, rowsum=rowsum,
        want_o=o is None)
    o = o_core[0] if o is None else o
    dh1, _ = cuda_lib.train_gemm(dqkv, w_qkv)
    dx = cuda_lib.ln_bwd_rows(x2, mu, rstd, ln_g, dh1, dres=dout)
    return (dx.reshape(rows // n, n, c), dmb.to(mb.dtype), None,
            *cuda_lib.grad_sums((x2, mu, rstd, ln_g, dh1), (dqkv, h1), (dproj, o)))


def attn_ln_train(x, mb, p, keep):
    """``x`` (R, N, C) windows -> differentiable ``(y, x + keep * y)``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    ``attn_ln_train.launches`` counts forward launches,
    ``attn_ln_train.backward_launches`` the backward's."""
    if x.device.type == "cpu":
        return attn_ln_train_plain(x, mb, p, keep)
    count_launch(attn_ln_train)
    return launch_attn_ln_train(x, mb, p, keep)


def launch_attn_ln_train(x, mb, p, keep):
    """The kernel's forward launches, differentiable through its backward's."""
    return _AttnLnTrain.apply(cuda_lib.aligned(x), mb, keep.float().contiguous(),
                              p["ln_g"], p["ln_b"], p["w_qkv"], p["b_qkv"], p["w_proj"],
                              p["b_proj"], p["heads"])


attn_ln_train.launches = 0
attn_ln_train.backward_launches = 0
