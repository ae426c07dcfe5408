"""Kernel ``ln_mlp``: ``x + fc2(gelu(fc1(LN(x))))`` over rows.

Replaces ``mumpy_tpu/ops/pallas/ln_mlp.py:fused_ln_mlp`` (Pallas ``_kernel``),
the tail of the cross-view blocks and of the global-ViT layers.  On the card
it is two GEMMs (``cuda_lib.gemm``): LN prologue + bias + erf GELU into the
(rows, M) hidden tensor, then bias + residual.  In bf16 both run on the
persistent wgmma GEMM of ``csrc/gemm_sm90.cu``, the LayerNorm applied to its
landed A tiles from the row statistics of one ``csrc/train_rows.cu`` launch;
in f32 on ``csrc/gemm.cu``'s SIMT loop.  The hidden tensor makes one round
trip through device memory (4C per row each way); fusing it away, as the TPU
kernel does in VMEM, is later work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

__all__ = ["ln_mlp", "ln_mlp_plain", "ln_mlp_operands"]


def ln_mlp_operands(ln_g, ln_b, w1, b1, w2, b2):
    """Kernel operands from the LayerNorm and the two Linear layers' tensors
    (torch layout: ``w1`` is (M, C)).  Weights are stored (in, out)."""
    return {"ln_g": ln_g.detach().contiguous(), "ln_b": ln_b.detach().contiguous(),
            "w1": w1.detach().t().contiguous(), "b1": b1.detach().contiguous(),
            "w2": w2.detach().t().contiguous(), "b2": b2.detach().contiguous()}


def ln_mlp_plain(x, ops):
    """Plain PyTorch version of the same function."""
    c = x.shape[-1]
    h = F.layer_norm(x, (c,), ops["ln_g"], ops["ln_b"], 1e-5)
    h = F.gelu(h @ ops["w1"] + ops["b1"])
    return x + (h @ ops["w2"] + ops["b2"])


def ln_mlp(x, ops):
    """``x`` (..., C) -> ``x + Mlp(LN(x))``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return ln_mlp_plain(x, ops)
    ln_mlp.launches += 1
    return launch_ln_mlp(x, ops)


def launch_ln_mlp(x, ops):
    """The kernel's launches: LN + fc1 + GELU, then fc2 + residual."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    h, _ = cuda_lib.gemm(x2, ops["w1"], ops["b1"], ln=(ops["ln_g"], ops["ln_b"]),
                         gelu=True)
    _, out = cuda_lib.gemm(h, ops["w2"], ops["b2"], res=x2, want_y=False, want_out=True)
    return out.reshape(shape)


ln_mlp.launches = 0
