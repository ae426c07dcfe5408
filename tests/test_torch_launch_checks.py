"""The kernels' launch sequences on the CPU, against a model of the C ABI.

``launch_*`` (the CUDA path of each kernel wrapper) only runs on the card.
Here ``cuda_lib``'s library is replaced by ``torch_cases.ModelLib``, a torch
model of what each C entry point of ``csrc/`` computes, reading and writing
the same raw buffers, so the shapes, row strides, column offsets, mask
period, ``q_mod``, fold indices and row maps the wrappers pass are checked
against the plain versions without a GPU.  The model is exact in f32 (1e-5);
in bf16 it rounds where the kernels round, and is held to the chip's
2e-2 * max(1, max|ref|).

This file: what the GEMM wrapper refuses before it launches.
"""

import pytest
import torch

from mumpy_tpu_torch.ops import cuda_lib, ln_mlp
from torch_cases import C, Draw, mlp_operands, mlp_weights, model_lib, t  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


def test_launch_checks_reject_bad_operands(model_lib):
    d = Draw(14)
    w = mlp_operands(mlp_weights(d))
    x = t(d(10, C))
    with pytest.raises(TypeError):
        ln_mlp.launch_ln_mlp(x.double(), w)
    with pytest.raises(ValueError, match="shape"):
        cuda_lib.gemm(x, w["w2"])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lib.gemm(t(d(C, 10)).t(), w["w1"])
    with pytest.raises(ValueError, match="n <= 64"):
        cuda_lib.window_attention(x, x, x, r=1, n=65, heads=1, hd=8, q_mod=1, ldq=8,
                                  ldk=8, ldv=8, scale=1.0)


def test_bf16_gemm_takes_tensor_core_shapes_only(model_lib):
    """The bf16 GEMM runs only on the tensor cores (the persistent wgmma
    GEMM): widths off a multiple of 8 and unaligned operands are refused;
    LayerNorm rows of any width are taken (the statistics come from one row
    pass, not from registers, since the wgmma GEMM replaced the wmma loop's
    limit of 1024)."""
    d = Draw(15)
    x, w = t(d(10, 20)).bfloat16(), t(d(20, 16)).bfloat16()
    with pytest.raises(ValueError, match="multiples of 8"):
        cuda_lib.gemm(x, w)
    g = torch.ones(1032, dtype=torch.bfloat16)
    y, _ = cuda_lib.gemm(torch.zeros(4, 1032, dtype=torch.bfloat16),
                         torch.zeros(1032, 8, dtype=torch.bfloat16), ln=(g, g))
    assert torch.equal(y, torch.zeros(4, 8, dtype=torch.bfloat16))
    buf = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cuda_lib.gemm(buf[1:].view(4, 16), torch.zeros(16, 8, dtype=torch.bfloat16))


def test_gemm_row_maps_are_checked(model_lib):
    """Row maps are int32 on the operands' device, of one period that divides
    M, and never combined with the CVA row fold."""
    x, w = torch.zeros(12, 8), torch.zeros(8, 8)
    good = torch.arange(6, dtype=torch.int32)
    y, _ = cuda_lib.gemm(x, w, a_map=good, c_map=good)
    assert y.shape == (12, 8)
    with pytest.raises(TypeError, match="int32"):
        cuda_lib.gemm(x, w, a_map=good.long())
    with pytest.raises(ValueError, match="multiple"):
        cuda_lib.gemm(x, w, a_map=torch.arange(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="differ"):
        cuda_lib.gemm(x, w, a_map=good, c_map=torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="fold"):
        cuda_lib.gemm(torch.zeros(24, 8), w, a_sum=2, a_seg=1, a_map=good)
