"""The kernels' launch sequences on the CPU, against a model of the C ABI.

``launch_*`` (the CUDA path of each kernel wrapper) only runs on the card.
Here ``cuda_lib``'s library is replaced by ``torch_cases.ModelLib``, a torch
model of what each C entry point of ``csrc/`` computes, reading and writing
the same raw buffers, so the shapes, row strides, column offsets, mask
period, ``q_mod``, fold indices and row maps the wrappers pass are checked
against the plain versions without a GPU.  The model is exact in f32 (1e-5);
in bf16 it rounds where the kernels round, and is held to the chip's
2e-2 * max(1, max|ref|).

This file: ``swin_block`` and ``attn_ln``, and the branch comparison of
``chip_smoke.py`` on them.
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, drop_mask_bias
from mumpy_tpu_torch.ops import attn_ln, swin_block
from torch_cases import (Draw, attn_operands, attn_weights, check_launches, mask_bias,
                         mlp_operands, mlp_weights, model_lib, t, windows)  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_and_attn_ln_launches(model_lib, dtype, shifted):
    d = Draw(11)
    a, m, mb, x = attn_weights(d), mlp_weights(d), mask_bias(d, shifted), windows(d)
    ops = {"attn": attn_operands(a, mb), "mlp": mlp_operands(m)}
    xd = t(x).to(dtype)
    check_launches(swin_block.launch_swin_block(xd, cast_ops(ops, dtype)),
           swin_block.swin_block_plain(t(x), ops), dtype)
    check_launches(attn_ln.launch_attn_ln(xd, cast_ops(ops["attn"], dtype)),
           attn_ln.attn_ln_plain(t(x), ops["attn"]), dtype)


@pytest.mark.parametrize("shifted", [False, True])
def test_branch_comparison_catches_dropped_mask_bias(model_lib, shifted):
    """chip_smoke.py's branch comparison, on the bf16 launch model at the
    flagship head width and window (hd 32, 49 tokens): the launches stay
    within BF16_BRANCH_TOL of the f32 plain version on the same bf16 inputs,
    and the same launches with the mask+bias zeroed land far above it."""
    c, heads, win, grid = 96, 3, 7, 14
    d = Draw(16)
    a, m = attn_weights(d, c), mlp_weights(d, c, 4 * c)
    mb, x = mask_bias(d, shifted, heads, win, grid), windows(d, c, win, grid)
    ops = cast_ops({"attn": attn_operands(a, mb, heads), "mlp": mlp_operands(m)},
                   torch.bfloat16)
    x16 = t(x).bfloat16()
    for name, launch, plain, kops in (
            ("swin_block", swin_block.launch_swin_block, swin_block.swin_block_plain, ops),
            ("attn_ln", attn_ln.launch_attn_ln, attn_ln.attn_ln_plain, ops["attn"])):
        ref16 = plain(x16.float(), cast_ops(kops, torch.float32))
        good = branch_error(name, x16.float(), launch(x16, kops), ref16)
        bad = branch_error(name, x16.float(), launch(x16, drop_mask_bias(kops)), ref16)
        assert good <= BF16_BRANCH_TOL / 2 and bad >= 3 * BF16_BRANCH_TOL, (name, good, bad)
