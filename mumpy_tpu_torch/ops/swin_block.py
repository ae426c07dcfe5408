"""Kernel ``swin_block``: a whole Swin block on window-major tokens.

    x = x + proj(window_msa(LN1(x)) + mb)
    x = x + fc2(gelu(fc1(LN2(x))))

Replaces ``mumpy_tpu/ops/pallas/swin_block.py:fused_swin_block_prepared``
(Pallas ``_block_kernel``), which runs the block in one launch with its
weights resident in VMEM.  An SM has 227 KB of shared memory, not 100 MB, so
the port keeps the contract and not the tiling: the LayerNorm + qkv GEMM, the
window-attention core, the projection GEMM with the residual, LN2 + fc1 +
GELU, fc2 with the residual.  The additive term has period P windows (P = 1
unshifted, nW shifted; the kernel reads window ``r % P``).  In bf16 the
block is one call of ``csrc/swin_pair.cu``: the attention half in four
launches (LN1 by ``ln_rows``, whose rows the qkv product on the persistent
wgmma GEMM of ``csrc/gemm_sm90.cu`` reads, the attention core of
``csrc/window_attention.cu``, the projection with the residual); the MLP
half at C <= 256 (stages 0 and 1 of the flagship) in one launch of the fused
MLP of ``csrc/mlp_sm90.cu``, which normalises each row tile once in shared
memory and keeps the 4C hidden on chip, and at wider C (stages 2 and 3) in
three (LN2, fc1 with GELU, fc2 with the residual).  f32 composes the two-
product sequence here (:func:`block_sequence`, also the CPU model of the
bf16 call) on ``csrc/gemm.cu``'s SIMT GEMM.  Other activations round-trip
device memory between the launches (qkv 3C and head outputs C per token,
and the 4C hidden on the three-launch MLP).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attn_ln import attention_launches, attn_ln_operands, attn_ln_plain
from .counts import count_launch
from .ln_mlp import ln_mlp_operands, ln_mlp_plain, mlp_sequence

__all__ = ["swin_block", "swin_block_plain", "swin_block_operands", "block_sequence"]


def swin_block_operands(ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj, ln2_g, ln2_b,
                        w_fc1, b_fc1, w_fc2, b_fc2, mask_bias, heads):
    """Kernel operands of both halves (torch Linear layouts in; see
    :func:`..attn_ln.attn_ln_operands` and :func:`..ln_mlp.ln_mlp_operands`)."""
    return {"attn": attn_ln_operands(ln1_g, ln1_b, w_qkv, b_qkv, w_proj, b_proj,
                                     mask_bias, heads),
            "mlp": ln_mlp_operands(ln2_g, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2)}


def swin_block_plain(x, ops):
    """Plain PyTorch version of the same function."""
    _, x = attn_ln_plain(x, ops["attn"])
    return ln_mlp_plain(x, ops["mlp"])


def swin_block(x, ops):
    """``x`` (R, N, C) windows -> the block's output windows.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return swin_block_plain(x, ops)
    count_launch(swin_block)
    return launch_swin_block(x, ops)


def launch_swin_block(x, ops):
    """The kernel's launches: one call in bf16, :func:`block_sequence` in f32.
    ``ops["ln_stats_on"] = False`` and ``ops["gelu_on"] = False`` (bf16)
    plant the checks' faults: every LayerNorm with mean 0 and rstd 1; GELU
    dropped from the fused MLP."""
    r, n, c = x.shape
    if x.dtype == torch.bfloat16:
        return cuda_lib.swin_blocks_fwd(x, [ops], ln_stats_on=ops.get("ln_stats_on", True),
                                        gelu_on=ops.get("gelu_on", True))
    return block_sequence(x.reshape(r * n, c), ops, r, n).reshape(r, n, c)


def block_sequence(x2, ops, r, n, row_map=None, ln_stats_on=True, gelu_on=True):
    """One block's launches on its (R*N, C) rows, composed here: attn_ln's
    (without y), then ln_mlp's, or in bf16 at the widths ``cuda_lib.
    fused_mlp`` takes the fused MLP (``cuda_lib.mlp_rows``).  With
    ``row_map`` the qkv GEMM gathers its rows through it and the projection
    GEMM scatters its rows (and reads its residual) through it, so the block
    runs on shifted windows while its input and output stay unshifted
    (``swin_pair``)."""
    a = ops["attn"]
    o = attention_launches(x2, a, r, n, a_map=row_map, ln_stats_on=ln_stats_on)
    _, x2 = cuda_lib.gemm(o, a["w_proj"], a["b_proj"], res=x2, want_y=False,
                          want_out=True, c_map=row_map)
    return mlp_sequence(x2, ops["mlp"], ln_stats_on=ln_stats_on, gelu_on=gelu_on)


swin_block.launches = 0
