"""The kernels' launch sequences on the CPU, against a model of the C ABI.

``launch_*`` (the CUDA path of each kernel wrapper) only runs on the card.
Here ``cuda_lib``'s library is replaced by ``torch_cases.ModelLib``, a torch
model of what each C entry point of ``csrc/`` computes, reading and writing
the same raw buffers, so the shapes, row strides, column offsets, mask
period, ``q_mod``, fold indices and row maps the wrappers pass are checked
against the plain versions without a GPU.  The model is exact in f32 (1e-5);
in bf16 it rounds where the kernels round, and is held to the chip's
2e-2 * max(1, max|ref|).

This file: ``ln_mlp`` and ``cva``.
"""

import pytest
import torch

from chip_smoke import cast_ops
from mumpy_tpu_torch.ops import cva, ln_mlp
from torch_cases import (C, Draw, check_launches, cva_case, mlp_operands, mlp_weights,
                         model_lib, t)  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_mlp_launches(model_lib, dtype):
    d = Draw(12)
    w, x = mlp_weights(d), d(3, 37, C, std=1.0)
    check_launches(ln_mlp.launch_ln_mlp(t(x).to(dtype), cast_ops(mlp_operands(w), dtype)),
           ln_mlp.ln_mlp_plain(t(x), mlp_operands(w)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ratio", [1, 3])
def test_cva_launches(model_lib, dtype, ratio):
    _, (x1, x2, gy, gx), ops = cva_case(ratio, seed=13)
    got = cva.launch_cva(t(x1).to(dtype), t(x2).to(dtype), t(gy), t(gx), cast_ops(ops, dtype))
    check_launches(got, cva.cva_plain(t(x1), t(x2), t(gy), t(gx), ops), dtype)
