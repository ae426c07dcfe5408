"""Kernel ``attn_ln``: ``y = proj(MSA(LN(x)) + mb)``, returning ``(y, x + y)``.

Replaces ``mumpy_tpu/ops/pallas/attn_ln.py:fused_attn_ln_prepared`` (Pallas
``_attn_kernel``), the attention half of the cross-view blocks, which keeps
qkv and the head outputs in VMEM scratch; ``y`` is the partner stream the
next view's CVA consumes.  The half moves x in and y, x + y out (6C bytes a
token in bf16) and does 8C^2 + 4NC flops a token, so it is bound by its
bytes below C ~ 200 and by the tensor cores above.  In bf16 it is one call
of ``csrc/swin_pair.cu`` (``cuda_lib.attn_ln_fwd``): at C <= 256 (the
flagship's stages 0 and 1) one launch of ``csrc/attn_sm90.cu``, which
normalises each window's rows once in shared memory and keeps qkv and the
head outputs on chip, head by head, with the projection accumulated in
registers; at wider C four launches (``ln_rows``, the qkv product on the
persistent wgmma GEMM of ``csrc/gemm_sm90.cu`` with Wqkv read as torch
stores it, the window-attention core of ``csrc/window_attention.cu``, the
projection writing ``y`` and ``x + y``), where qkv (3C a token) and the head
outputs (C) round-trip device memory.  f32 composes those four here
(:func:`attn_sequence`, also the CPU model of the wide bf16 route) on
``csrc/gemm.cu``'s SIMT GEMM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .counts import count_launch

__all__ = ["attn_ln", "attn_ln_plain", "attn_ln_operands", "window_msa_plain"]


def attn_ln_operands(ln_g, ln_b, w_qkv, b_qkv, w_proj, b_proj, mask_bias, heads):
    """Kernel operands: weights stored (in, out), and the qkv weight also as
    torch stores it (``w_qkv_rows``, (3C, C), the parameter itself: a head's
    q, k and v columns are rows of it, which the fused bf16 kernel streams);
    the (P, H, N, N) additive term in f32 (its period P in windows is its
    leading dim)."""
    return {"ln_g": ln_g.detach().contiguous(), "ln_b": ln_b.detach().contiguous(),
            "w_qkv": w_qkv.detach().t().contiguous(), "w_qkv_rows": w_qkv.detach().contiguous(),
            "b_qkv": b_qkv.detach().contiguous(),
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
    count_launch(attn_ln)
    return launch_attn_ln(x, ops)


def launch_attn_ln(x, ops):
    """The kernel's launches: one C call in bf16 (``cuda_lib.attn_ln_fwd``),
    :func:`attn_sequence` in f32.  ``ops["ln_stats_on"] = False`` and
    ``ops["key_mask_on"] = False`` (bf16) plant the checks' faults: the
    LayerNorm with mean 0 and rstd 1; the pad keys unmasked in the fused
    kernel."""
    if x.dtype == torch.bfloat16:
        return cuda_lib.attn_ln_fwd(x, ops, ln_stats_on=ops.get("ln_stats_on", True),
                                    key_mask_on=ops.get("key_mask_on", True))
    r, n, c = x.shape
    y, out = attn_sequence(x.reshape(r * n, c), ops, r, n)
    return y.reshape(r, n, c), out.reshape(r, n, c)


def attn_sequence(x2, ops, r, n, ln_stats_on=True):
    """The four launches on the (R*N, C) rows ``x2``, composed here: LN +
    qkv, the attention core, the projection writing ``y`` and ``x + y``."""
    o = attention_launches(x2, ops, r, n, ln_stats_on=ln_stats_on)
    return cuda_lib.gemm(o, ops["w_proj"], ops["b_proj"], res=x2, want_out=True)


attn_ln.launches = 0
