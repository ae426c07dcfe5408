"""Kernel ``ln_mlp``: ``x + fc2(gelu(fc1(LN(x))))`` over rows.

Replaces ``mumpy_tpu/ops/pallas/ln_mlp.py:fused_ln_mlp`` (Pallas ``_kernel``),
the tail of the cross-view blocks, which keeps the 4C hidden in VMEM.  The
tail moves x in and out (4C bytes a row in bf16) and does 16C^2 flops a row,
so it is bound by the tensor cores at every flagship width.  In bf16 it is
one call of ``csrc/swin_pair.cu`` (``cuda_lib.ln_mlp_fwd``): at C <= 256
(the flagship's stages 0 and 1) one launch of the fused MLP of
``csrc/mlp_sm90.cu``, which normalises each 128-row tile once in shared
memory and keeps the hidden on chip (as #1's MLP half runs); at wider C
three launches (``ln_rows``, fc1 with GELU and fc2 with the residual on the
persistent wgmma GEMM of ``csrc/gemm_sm90.cu``), where the hidden makes one
round trip through device memory.  f32 composes those three here
(:func:`mlp_sequence`, also the CPU model of the bf16 call) on
``csrc/gemm.cu``'s SIMT loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .counts import count_launch

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
    count_launch(ln_mlp)
    return launch_ln_mlp(x, ops)


def launch_ln_mlp(x, ops):
    """The kernel's launches: one C call in bf16 (``cuda_lib.ln_mlp_fwd``),
    :func:`mlp_sequence` in f32.  ``ops["ln_stats_on"] = False`` and
    ``ops["gelu_on"] = False`` (bf16) plant the checks' faults: the LayerNorm
    with mean 0 and rstd 1; GELU dropped from the fused MLP."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.dtype == torch.bfloat16:
        out = cuda_lib.ln_mlp_fwd(x2, ops, ln_stats_on=ops.get("ln_stats_on", True),
                                  gelu_on=ops.get("gelu_on", True))
    else:
        out = mlp_sequence(x2, ops)
    return out.reshape(shape)


def mlp_sequence(x2, ops, ln_stats_on=True, gelu_on=True):
    """The MLP half's launches on the rows ``x2``, composed here: in bf16 at
    the widths ``cuda_lib.fused_mlp`` takes the fused MLP, else LN + fc1 +
    GELU, then fc2 + residual."""
    if x2.dtype == torch.bfloat16 and cuda_lib.fused_mlp(x2.shape[1], ops["w1"].shape[1]):
        return cuda_lib.mlp_rows(x2, ops, ln_stats_on=ln_stats_on, gelu_on=gelu_on)
    h, _ = cuda_lib.gemm(x2, ops["w1"], ops["b1"], ln=(ops["ln_g"], ops["ln_b"]), gelu=True,
                         ln_stats_on=ln_stats_on)
    _, out = cuda_lib.gemm(h, ops["w2"], ops["b2"], res=x2, want_y=False, want_out=True)
    return out


ln_mlp.launches = 0
