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

On the card it is five launches: the q GEMM, the sampler
(``csrc/cva_sample.cu``), one GEMM for k and v together, the attention core
without an additive term (keys past N masked in-kernel), and the projection
GEMM whose prologue sums the ratio rows, so the projection runs on B1 rows,
not R.  In bf16 the q and k/v GEMMs run on the persistent wgmma GEMM of
``csrc/gemm_sm90.cu`` and the folded projection on ``csrc/gemm.cu``'s wmma
loop (the one bf16 caller it keeps); f32 runs all three on ``csrc/gemm.cu``'s
SIMT loop.  The sampler and the attention core are bound by device-memory
bytes.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .grid_sample import _axis_weights

__all__ = ["cva", "cva_plain", "cva_operands", "sample_plain"]


def cva_operands(w_q, b_q, w_k, b_k, w_v, b_v, w_proj, heads, groups, ws, live=False):
    """Kernel operands from the 1x1-conv weights ((C, C) after squeezing the
    kernel dims; torch (out, in) layout).  Weights are stored (in, out), with
    k and v side by side.  ``live=True`` keeps them in the autograd graph (the
    plain version's training operands); otherwise they are detached."""
    d = (lambda w: w) if live else (lambda w: w.detach())
    t = lambda w: d(w).reshape(w.shape[0], -1).t()
    return {"w_q": t(w_q).contiguous(), "b_q": d(b_q).contiguous(),
            "w_kv": torch.cat([t(w_k), t(w_v)], dim=1).contiguous(),
            "b_kv": torch.cat([d(b_k), d(b_v)]).contiguous(),
            "w_proj": t(w_proj).contiguous(), "heads": heads, "groups": groups,
            "ws": ws}


def sample_plain(x2, gy, gx, groups, ws):
    """x2 (R, N, C) partner windows, gy/gx (g, B1, N) -> (R, N, C) samples."""
    r, n, c = x2.shape
    ratio = r // gy.shape[1]
    wy = _axis_weights(gy.repeat(1, ratio, 1), ws)  # (g, R, N, ws)
    wx = _axis_weights(gx.repeat(1, ratio, 1), ws)
    xs = x2.reshape(r, ws, ws, groups, c // groups).float()
    s = torch.einsum("grny,grnx,ryxgc->rngc", wy, wx, xs)
    return s.reshape(r, n, c).to(x2.dtype)


def cva_plain(x1, x2, gy, gx, ops):
    """Plain PyTorch version of the same function."""
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
    o = torch.einsum("rhqk,rkhd->rqhd", a, v.reshape(r, n, heads, hd)).reshape(r, n, c)
    return o.reshape(b1, ratio, n, c).sum(dim=1) @ ops["w_proj"]


def cva(x1, x2, gy, gx, ops):
    """``x1`` (B1, N, C) queries, ``x2`` (ratio*B1, N, C) partner windows,
    ``gy``/``gx`` (groups, B1, N) f32 absolute sample coordinates -> the
    ratio-folded output (B1, N, C) without the proj_out bias.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if x1.device.type == "cpu":
        return cva_plain(x1, x2, gy, gx, ops)
    cva.launches += 1
    return launch_cva(x1, x2, gy, gx, ops)


def launch_cva(x1, x2, gy, gx, ops):
    """The kernel's launches: q, sampling, k|v, attention, folded proj."""
    b1, n, c = x1.shape
    r = x2.shape[0]
    if r % b1:
        raise ValueError(f"partner windows {r} are not a multiple of query windows {b1}")
    heads = ops["heads"]
    hd = c // heads
    q, _ = cuda_lib.gemm(x1.reshape(b1 * n, c), ops["w_q"], ops["b_q"])
    s = cuda_lib.cva_sample(x2.reshape(r * n, c), gy, gx, b1=b1, n=n,
                            groups=ops["groups"], ws=ops["ws"])
    kv, _ = cuda_lib.gemm(s, ops["w_kv"], ops["b_kv"])
    o = cuda_lib.window_attention(
        q, kv, kv, r=r, n=n, heads=heads, hd=hd, q_mod=b1, ldq=c, ldk=2 * c,
        ldv=2 * c, k_off=0, v_off=c, mb=None, scale=hd**-0.5)
    out, _ = cuda_lib.gemm(o, ops["w_proj"], a_sum=r // b1, a_seg=n)
    return out.reshape(b1, n, c)


cva.launches = 0
