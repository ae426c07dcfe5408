"""Kernel ``cva``: the deformable cross-view attention core.

    q   = x1 @ Wq + bq                          (untiled query windows, B1)
    s   = per-group bilinear sample of x2 at (gy, gx), zero padding
    k,v = s @ Wk + bk, s @ Wv + bv              (R = ratio * B1 partner windows)
    o   = softmax(q[r % B1] k^T * hd^-0.5) v    per head
    out = (sum_t o[b*ratio + t]) @ Wproj        no proj_out bias

Replaces ``mumpy_tpu/ops/pallas/cva.py:fused_cva_prepared`` (Pallas
``_cva_kernel``).  Pre-fold row r pairs with query window ``r % B1``
(``jnp.tile`` order) while the fold sums ``ratio`` CONSECUTIVE rows
(``deformable.py:111-112``); with ratio 3 the two groupings differ, as in the
reference.  The caller adds the proj_out bias after the fold.

In bf16 it is one call of ``csrc/cva_sm90.cu`` (``cuda_lib.cva_fwd``): at
head width 32 and C <= 256 (the flagship's stages 0 and 1) one launch of the
fused core, which samples each partner window in shared memory, runs q, k|v,
the attention and the projection per head on wgmma and folds the ratio in
its registers, so s, k|v and o never reach device memory; wider, five
launches: the q and k|v products on the persistent wgmma GEMM of
``csrc/gemm_sm90.cu`` (weights read as torch stores them, ``w_q_rows`` and
``w_kv_rows``), the sampler (``csrc/cva_sample.cu``), the attention core
without an additive term (keys past N masked in-kernel) that also sums each
output window's ratio partner windows (``mumpy_window_attention_fold``), and
the projection on the persistent GEMM.  f32 composes five launches here
(:func:`cva_sequence`) on ``csrc/gemm.cu``'s SIMT loop, whose projection
prologue sums the ratio rows.  The fused core is bound by the tensor cores'
rate; the five launches by the sampler's and the core's bytes.  The
operands' ``sample_on``, ``fold_on`` and ``key_mask_on`` (bf16, default
True) plant the checks' faults: the bilinear weights ignored, only each
output window's first partner window, the pad keys unmasked (fused route).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .counts import count_launch
from .grid_sample import _axis_weights

__all__ = ["cva", "cva_plain", "cva_operands", "sample_plain"]


def cva_operands(w_q, b_q, w_k, b_k, w_v, b_v, w_proj, heads, groups, ws, live=False):
    """Kernel operands from the 1x1-conv weights ((C, C) after squeezing the
    kernel dims; torch (out, in) layout).  Weights are stored (in, out), with
    k and v side by side; without ``live`` also as torch stores them, q's
    (C, C) and k's and v's stacked (2C, C) (``w_q_rows``, ``w_kv_rows``: a
    head's columns are rows there), which the bf16 call reads.  ``live=True``
    keeps them in the autograd graph (the plain version's training
    operands); otherwise they are detached."""
    d = (lambda w: w) if live else (lambda w: w.detach())
    rows = lambda w: d(w).reshape(w.shape[0], -1)
    t = lambda w: rows(w).t()
    ops = {"w_q": t(w_q).contiguous(), "b_q": d(b_q).contiguous(),
           "w_kv": torch.cat([t(w_k), t(w_v)], dim=1).contiguous(),
           "b_kv": torch.cat([d(b_k), d(b_v)]).contiguous(),
           "w_proj": t(w_proj).contiguous(), "heads": heads, "groups": groups, "ws": ws}
    if not live:  # the weights as the bf16 call reads them
        ops.update(w_q_rows=rows(w_q).contiguous(),
                   w_kv_rows=torch.cat([rows(w_k), rows(w_v)]).contiguous())
    return ops


def sample_plain(x2, gy, gx, groups, ws):
    """x2 (R, N, C) partner windows, gy/gx (g, B1, N) -> (R, N, C) samples."""
    r, n, c = x2.shape
    ratio = r // gy.shape[1]
    wy = _axis_weights(gy.repeat(1, ratio, 1), ws)  # (g, R, N, ws)
    wx = _axis_weights(gx.repeat(1, ratio, 1), ws)
    xs = x2.reshape(r, ws, ws, groups, c // groups).float()
    s = torch.einsum("grny,grnx,ryxgc->rngc", wy, wx, xs)
    return s.reshape(r, n, c).to(x2.dtype)


def cva_plain(x1, x2, gy, gx, ops, drop=None):
    """Plain PyTorch version of the same function.  ``drop``, when given, is
    applied to the (R, H, N, N) probabilities (attention dropout in
    training, ``models/dropout.py``; the kernel serves only)."""
    b1, n, c = x1.shape
    r = x2.shape[0]
    ratio = r // b1
    heads = ops["heads"]
    hd = c // heads
    q = (x1 @ ops["w_q"] + ops["b_q"]).repeat(ratio, 1, 1)  # row r -> query r % B1
    kv = sample_plain(x2, gy, gx, ops["groups"], ops["ws"]) @ ops["w_kv"] + ops["b_kv"]
    k, v = kv[..., :c], kv[..., c:]
    s = torch.einsum("rqhd,rkhd->rhqk", q.reshape(r, n, heads, hd),
                     k.reshape(r, n, heads, hd)) * hd**-0.5
    a = torch.softmax(s.float(), dim=-1).to(v.dtype)
    if drop is not None:
        a = drop(a)
    o = torch.einsum("rhqk,rkhd->rqhd", a, v.reshape(r, n, heads, hd)).reshape(r, n, c)
    return o.reshape(b1, ratio, n, c).sum(dim=1) @ ops["w_proj"]


def cva(x1, x2, gy, gx, ops):
    """``x1`` (B1, N, C) queries, ``x2`` (ratio*B1, N, C) partner windows,
    ``gy``/``gx`` (groups, B1, N) f32 absolute sample coordinates -> the
    ratio-folded output (B1, N, C) without the proj_out bias.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if x1.device.type == "cpu":
        return cva_plain(x1, x2, gy, gx, ops)
    count_launch(cva)
    return launch_cva(x1, x2, gy, gx, ops)


FAULTS = ("sample_on", "fold_on", "key_mask_on")  # the bf16 call's planted-fault switches


def launch_cva(x1, x2, gy, gx, ops):
    """The kernel's launches: bf16 one call of ``csrc/cva_sm90.cu``, f32
    :func:`cva_sequence`."""
    if x2.shape[0] % x1.shape[0]:
        raise ValueError(f"partner windows {x2.shape[0]} are not a multiple of query windows "
                         f"{x1.shape[0]}")
    if x1.dtype == torch.bfloat16:
        return cuda_lib.cva_fwd(x1, x2, gy, gx, ops, **{k: ops.get(k, True) for k in FAULTS})
    return cva_sequence(x1, x2, gy, gx, ops)


def cva_sequence(x1, x2, gy, gx, ops):
    """Five launches from Python: q, sampling, k|v, attention, projection.
    f32 folds the ratio in the projection's prologue (``csrc/gemm.cu``'s
    SIMT loop); bf16 in the attention core (``mumpy_window_attention_fold``),
    the products on the persistent GEMM (the route the port took before the
    one C call, with the fold moved off ``gemm.cu``)."""
    b1, n, c = x1.shape
    r = x2.shape[0]
    heads = ops["heads"]
    hd = c // heads
    q, _ = cuda_lib.gemm(x1.reshape(b1 * n, c), ops["w_q"], ops["b_q"])
    s = cuda_lib.cva_sample(x2.reshape(r * n, c), gy, gx, b1=b1, n=n, groups=ops["groups"],
                            ws=ops["ws"], sample_on=ops.get("sample_on", True))
    kv, _ = cuda_lib.gemm(s, ops["w_kv"], ops["b_kv"])
    if x1.dtype == torch.bfloat16:
        o = cuda_lib.window_attention_fold(q, kv, r=r, n=n, heads=heads, q_mod=b1,
                                           fold=r // b1, fold_on=ops.get("fold_on", True))
        out, _ = cuda_lib.gemm(o, ops["w_proj"])
    else:
        o = cuda_lib.window_attention(
            q, kv, kv, r=r, n=n, heads=heads, hd=hd, q_mod=b1, ldq=c, ldk=2 * c,
            ldv=2 * c, k_off=0, v_off=c, mb=None, scale=hd**-0.5)
        out, _ = cuda_lib.gemm(o, ops["w_proj"], a_sum=r // b1, a_seg=n)
    return out.reshape(b1, n, c)


cva.launches = 0
