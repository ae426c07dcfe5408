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

* forward, three launches, those of ``attn_ln``: the LN + qkv GEMM, the
  window-attention core, and the projection GEMM whose epilogue writes ``y``
  and ``x + keep[r] * y`` (the row-scale epilogue of ``csrc/gemm.cu``);
* backward, eight launches, recomputing from ``x``: the LayerNorm rows
  (h1 and the row statistics, ``csrc/train_rows.cu``), the qkv GEMM, the
  attention core again (o), ``dproj = dy + keep * dout``, ``do = dproj
  Wproj^T``, the attention backward (``csrc/window_attention_bwd.cu``: dqkv
  and the mask+bias gradient, summed over windows), ``dh1 = dqkv Wqkv^T``,
  and the LayerNorm backward with the residual's ``dout`` added; then the
  weight and bias gradients of qkv and of the projection and the LayerNorm
  scale and bias gradients (``csrc/wgrad.cu``: row-split sums and their
  reduction), which the JAX package sums in XLA outside its kernel.  The
  backward is two steps, :func:`attn_recompute` and :func:`attn_bwd_from`,
  so that ``swin_block_train`` can recompute once and reuse the second.

The products with transposed weights read the torch Linear weights as they
are stored, (out, in): the backward's ``do`` and ``dh1`` GEMMs need exactly
that layout.  Only the forward's products need (in, out) copies; the
``Function`` builds them once per call and keeps them for the backward's
recompute.  The mask+bias gradient leaves the ``Function`` through the padded
(P, H, N, 64) term, so autograd carries it through ``pad_mask_bias``'s slice
and ``rel_pos_bias``'s gather into the relative-position table.

On the card the products are bound by their tile loads (bf16 tensor cores)
or the FMA rate (f32 SIMT), the attention backward by issuing instructions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .attn_ln import pad_mask_bias

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


class _AttnLnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mbp, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj, heads):
        r, n, c = x.shape
        wq_t, wp_t = w_qkv.t().contiguous(), w_proj.t().contiguous()
        x2 = x.reshape(r * n, c)
        o = _attention(x2, wq_t, b_qkv, mbp, r, n, heads, ln=(ln_g, ln_b))[1]
        y, out = cuda_lib.gemm(o, wp_t, b_proj, res=x2, want_out=True, row_scale=keep,
                               scale_div=n)
        ctx.save_for_backward(x, mbp, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t)
        ctx.heads = heads
        return y.reshape(r, n, c), out.reshape(r, n, c)

    @staticmethod
    def backward(ctx, dy, dout):
        attn_ln_train.backward_launches += 1
        x, mbp, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t = ctx.saved_tensors
        grads = launch_attn_ln_train_bwd(x, mbp, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj,
                                         wq_t, ctx.heads, dy, dout)
        return (*grads, None)


def _attention(x2, wq_t, b_qkv, mbp, r, n, heads, ln=None):
    """qkv = (LN(x2) or x2) Wqkv + b, then the attention core: (qkv, o)."""
    c = wq_t.shape[0]
    hd = c // heads
    qkv, _ = cuda_lib.gemm(x2, wq_t, b_qkv, ln=ln)
    o = cuda_lib.window_attention(
        qkv, qkv, qkv, r=r, n=n, heads=heads, hd=hd, q_mod=r, ldq=3 * c, ldk=3 * c,
        ldv=3 * c, q_off=0, k_off=c, v_off=2 * c, mb=mbp, scale=hd**-0.5)
    return qkv, o


def launch_attn_ln_train_bwd(x, mbp, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, wq_t, heads,
                             dy, dout, rowsum=True):
    """The backward's launches.  Returns the gradients of (x, mbp, keep, ln_g,
    ln_b, w_qkv, b_qkv, w_proj, b_proj); ``rowsum=False`` is the planted fault
    of the checks (the softmax backward without its rowsum term)."""
    r, n, c = x.shape
    x2 = x.reshape(r * n, c)
    dy2 = None if dy is None else dy.reshape(r * n, c).contiguous()
    dout2 = (torch.zeros_like(x2) if dout is None else dout).reshape(r * n, c).contiguous()
    rec = attn_recompute(x2, ln_g, ln_b, wq_t, b_qkv, mbp, r, n, heads)
    return attn_bwd_from(x2, rec, mbp, keep, ln_g, w_qkv, w_proj, dy2, dout2, rowsum)


def attn_recompute(x2, ln_g, ln_b, wq_t, b_qkv, mbp, r, n, heads):
    """The backward's recompute from the (R*N, C) rows ``x2``: h1 = LN(x2)
    and its f32 row statistics, the packed qkv and the head outputs o."""
    h1, mu, rstd = cuda_lib.ln_rows(x2, ln_g, ln_b)
    qkv, o = _attention(h1, wq_t, b_qkv, mbp, r, n, heads)
    return h1, mu, rstd, qkv, o


def attn_bwd_from(x2, rec, mbp, keep, ln_g, w_qkv, w_proj, dy, dout, rowsum=True):
    """The attention half's backward from its recompute ``rec``
    (:func:`attn_recompute`) and the (R*N, C) cotangents of ``y`` (``dy``,
    may be None) and of ``out = x + keep * y`` (``dout``).  Returns the
    gradients of (x, mbp, keep, ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj)."""
    h1, mu, rstd, qkv, o = rec
    rows, c = x2.shape
    heads, n = mbp.shape[1], mbp.shape[2]
    hd = c // heads
    dproj = cuda_lib.scale_add_rows(dy, dout, keep, div=n)
    do, _ = cuda_lib.gemm(dproj, w_proj)
    dqkv, dmb = cuda_lib.window_attention_bwd(qkv, do, mbp, r=rows // n, n=n, heads=heads,
                                              hd=hd, scale=hd**-0.5, rowsum=rowsum)
    dh1, _ = cuda_lib.gemm(dqkv, w_qkv)
    dx = cuda_lib.ln_bwd_rows(x2, mu, rstd, ln_g, dh1, dres=dout)
    dmbp = torch.zeros_like(mbp)
    dmbp[..., :n] = dmb
    return (dx.reshape(rows // n, n, c), dmbp, None,
            *cuda_lib.ln_param_grads(x2, mu, rstd, ln_g, dh1),
            *cuda_lib.weight_grads(dqkv, h1), *cuda_lib.weight_grads(dproj, o))


def attn_ln_train(x, mb, p, keep):
    """``x`` (R, N, C) windows -> differentiable ``(y, x + keep * y)``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    ``attn_ln_train.launches`` counts forward launches,
    ``attn_ln_train.backward_launches`` the backward's."""
    if x.device.type == "cpu":
        return attn_ln_train_plain(x, mb, p, keep)
    attn_ln_train.launches += 1
    return launch_attn_ln_train(x, mb, p, keep)


def launch_attn_ln_train(x, mb, p, keep):
    """The kernel's forward launches, differentiable through its backward's."""
    return _AttnLnTrain.apply(cuda_lib.aligned(x), pad_mask_bias(mb), keep.float().contiguous(),
                              p["ln_g"], p["ln_b"], p["w_qkv"], p["b_qkv"], p["w_proj"],
                              p["b_proj"], p["heads"])


attn_ln_train.launches = 0
attn_ln_train.backward_launches = 0
