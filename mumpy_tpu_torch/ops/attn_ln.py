"""Kernel ``attn_ln``: ``y = proj(MSA(LN(x)) + mb)``, returning ``(y, x + y)``.

Replaces ``mumpy_tpu/ops/pallas/attn_ln.py:fused_attn_ln_prepared`` (Pallas
``_attn_kernel``), the attention half of the cross-view blocks; ``y`` is the
partner stream the next view's CVA consumes.  On the card it is three
launches (four in bf16): the GEMM with the LayerNorm prologue into packed
qkv (``cuda_lib.gemm``: in bf16 the row statistics, then the persistent
wgmma GEMM of ``csrc/gemm_sm90.cu``; in f32 ``csrc/gemm.cu``), the
window-attention core with the periodic additive mask+bias
(``csrc/window_attention.cu``), and the projection GEMM whose epilogue
writes both ``y`` and ``x + y``.  qkv (3C per token) and the head outputs
(C) round-trip device memory between launches; keeping them on chip needs
the launches fused, which is later work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

__all__ = ["attn_ln", "attn_ln_plain", "attn_ln_operands", "window_msa_plain"]


def attn_ln_operands(ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj, mask_bias, heads):
    """Kernel operands: weights stored (in, out), the (P, H, N, N) additive
    term in f32 (its period P in windows is its leading dim)."""
    return {"ln_g": ln_g.detach().contiguous(), "ln_b": ln_b.detach().contiguous(),
            "w_qkv": w_qkv.detach().t().contiguous(), "b_qkv": b_qkv.detach().contiguous(),
            "w_proj": w_proj.detach().t().contiguous(),
            "b_proj": b_proj.detach().contiguous(),
            "mb": mask_bias.detach().float().contiguous(), "heads": heads}


def window_msa_plain(h, ops):
    """Plain multi-head window attention with the periodic additive term:
    ``h`` (R, N, C) already normalised -> head outputs before proj (R, N, C)."""
    r, n, c = h.shape
    heads = ops["heads"]
    hd = c // heads
    qkv = (h @ ops["w_qkv"] + ops["b_qkv"]).reshape(r, n, 3, heads, hd)
    q, k, v = qkv.unbind(2)  # (R, N, H, hd)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) * hd**-0.5
    mb = ops["mb"]  # (P, H, N, N)
    p = mb.shape[0]
    s = (s.reshape(r // p, p, heads, n, n) + mb).reshape(r, heads, n, n)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("rhqk,rkhd->rqhd", a, v).reshape(r, n, c)


def attn_ln_plain(x, ops):
    """Plain PyTorch version of the same function."""
    c = x.shape[-1]
    h = F.layer_norm(x, (c,), ops["ln_g"], ops["ln_b"], 1e-5)
    y = window_msa_plain(h, ops) @ ops["w_proj"] + ops["b_proj"]
    return y, x + y


def attention_launches(x2, ops, r, n, a_map=None, ln_stats_on=True):
    """LN+qkv GEMM and the attention core; returns the (R*N, C) head outputs.
    With ``a_map`` the qkv GEMM reads its rows through that row map;
    ``ln_stats_on=False`` (bf16) plants the LayerNorm-statistics fault."""
    qkv, _ = cuda_lib.gemm(x2, ops["w_qkv"], ops["b_qkv"], ln=(ops["ln_g"], ops["ln_b"]),
                           a_map=a_map, ln_stats_on=ln_stats_on)
    return cuda_lib.packed_window_attention(qkv, ops["mb"], r=r, n=n, heads=ops["heads"])


def attn_ln(x, ops):
    """``x`` (R, N, C) windows -> ``(y, x + y)``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return attn_ln_plain(x, ops)
    attn_ln.launches += 1
    return launch_attn_ln(x, ops)


def launch_attn_ln(x, ops):
    """The kernel's launches: LN + qkv, attention, proj + residual."""
    r, n, c = x.shape
    x2 = x.reshape(r * n, c)
    o = attention_launches(x2, ops, r, n)
    y, out = cuda_lib.gemm(o, ops["w_proj"], ops["b_proj"], res=x2, want_out=True)
    return y.reshape(r, n, c), out.reshape(r, n, c)


attn_ln.launches = 0
