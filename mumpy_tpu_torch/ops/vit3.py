"""Kernel ``vit3``: one layer of the global temporal ViT on n = 3 time-major
tokens.

    h  = LN1(x_i) @ Wqkv + bqkv                       i = 0, 1, 2
    o_i = sum_j softmax_j(q_i . k_j * hd^-0.5) v_j    per head
    y_i = x_i + o_i @ Wproj + bproj
    out_i = y_i + fc2(gelu(fc1(LN2(y_i))))

``x`` is (3, R, C): three slabs of R = B*49 rows, one per time slice.

Replaces ``mumpy_tpu/ops/pallas/vit3.py:fused_vit3_prepared`` (Pallas
``_vit3_kernel``), which holds the layer's weights in VMEM and its qkv slabs
in VMEM scratch, and unrolls the 3x3 attention with head reducer matmuls.
In bf16 the layer is one call of ``csrc/vit3_sm90.cu`` (``cuda_lib.vit3_fwd``)
and six launches: ``ln_rows``; at head width 64 (the flagship's 12 heads of
64) the fused qkv product and n = 3 attention, whose qkv never leaves the SM
(Wqkv read as torch stores it, ``w_qkv_rows``); the projection with the
residual on the persistent wgmma GEMM of ``csrc/gemm_sm90.cu``; the MLP tail
as ``ln_mlp``'s one call (``ln_rows`` and two products at C = 768).  At other
head widths the qkv GEMM and ``csrc/vit3_attention.cu`` (one warp per row and
head) take the fused kernel's place.  The products carry all but ~0.1% of
the flops, so the layer is bound by the tensor cores' rate; the 4C hidden
still round-trips device memory (a fused MLP does not fit C = 768).  f32
composes the same seven launches here (:func:`vit3_sequence`) on
``csrc/gemm.cu``'s SIMT GEMM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .counts import count_launch
from .ln_mlp import ln_mlp_operands, ln_mlp_plain

__all__ = ["vit3", "vit3_plain", "vit3_operands"]


def vit3_operands(ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g, ln2_b, w_fc1,
                  b_fc1, w_fc2, b_fc2, heads):
    """Kernel operands from the layer's torch tensors (Linear weights (out,
    in)); weights are stored (in, out), and the qkv weight also as torch
    stores it (``w_qkv_rows``, (3C, C), the parameter itself), which the bf16
    call reads."""
    return {"attn": {"ln_g": ln1_g.detach().contiguous(), "ln_b": ln1_b.detach().contiguous(),
                     "w_qkv": w_qkv.detach().t().contiguous(),
                     "w_qkv_rows": w_qkv.detach().contiguous(),
                     "b_qkv": b_qkv.detach().contiguous(),
                     "w_proj": w_proj.detach().t().contiguous(),
                     "b_proj": b_proj.detach().contiguous(), "heads": heads},
            "mlp": ln_mlp_operands(ln2_g, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2)}


def _check_time_major(x):
    if x.dim() != 3 or x.shape[0] != 3:
        raise ValueError(f"vit3 takes time-major (3, R, C) tokens, got {tuple(x.shape)}")


def vit3_plain(x, ops):
    """Plain PyTorch version of the same function."""
    _check_time_major(x)
    a = ops["attn"]
    _, r, c = x.shape
    heads = a["heads"]
    hd = c // heads
    h = F.layer_norm(x, (c,), a["ln_g"], a["ln_b"], 1e-5)
    qkv = (h @ a["w_qkv"] + a["b_qkv"]).reshape(3, r, 3, heads, hd)
    q, k, v = qkv.unbind(2)  # (3, R, H, hd)
    s = torch.einsum("irhd,jrhd->rhij", q.float() * hd**-0.5, k.float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rhij,jrhd->irhd", p, v.float()).reshape(3, r, c).to(x.dtype)
    y = x + (o @ a["w_proj"] + a["b_proj"])
    return ln_mlp_plain(y, ops["mlp"])


def vit3(x, ops):
    """``x`` (3, R, C) time-major tokens -> the layer's output, same layout.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return vit3_plain(x, ops)
    count_launch(vit3)
    return launch_vit3(x, ops)


def launch_vit3(x, ops):
    """The kernel's launches: bf16 one call of ``csrc/vit3_sm90.cu``, f32
    :func:`vit3_sequence`."""
    _check_time_major(x)
    if x.dtype == torch.bfloat16:
        return cuda_lib.vit3_fwd(x, ops)
    return vit3_sequence(x, ops)


def vit3_sequence(x, ops):
    """The layer as seven launches from Python: LN + qkv, the n = 3
    attention (``csrc/vit3_attention.cu``), proj + residual, LN + fc1 + GELU,
    fc2 + residual (the f32 route; in bf16 the route the port took before
    the one C call)."""
    _check_time_major(x)
    a, m = ops["attn"], ops["mlp"]
    _, r, c = x.shape
    x2 = x.reshape(3 * r, c)
    qkv, _ = cuda_lib.gemm(x2, a["w_qkv"], a["b_qkv"], ln=(a["ln_g"], a["ln_b"]))
    o = cuda_lib.vit3_attention(qkv.reshape(3, r, 3 * c), heads=a["heads"])
    _, y = cuda_lib.gemm(o.reshape(3 * r, c), a["w_proj"], a["b_proj"], res=x2,
                         want_y=False, want_out=True)
    h, _ = cuda_lib.gemm(y, m["w1"], m["b1"], ln=(m["ln_g"], m["ln_b"]), gelu=True)
    _, out = cuda_lib.gemm(h, m["w2"], m["b2"], res=y, want_y=False, want_out=True)
    return out.reshape(3, r, c)


vit3.launches = 0
