"""The CUDA kernels on the card, each against its plain PyTorch version (f32,
TF32 off): ``swin_block``, ``attn_ln``, ``ln_mlp`` and ``cva``.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device.  The card-test files import no JAX, so they run on a GPU machine
without it: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py``.
"""

import pytest

from mumpy_tpu_torch.ops import attn_ln, cva, ln_mlp, swin_block
from torch_cases import (C, Draw, assert_kernel_matches_plain, attn_operands,  # noqa: F401
                         attn_weights, cuda, cva_case, mask_bias, mlp_operands, mlp_weights,
                         t, windows)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_and_attn_ln_kernels_on_card(cuda, shifted):
    d = Draw(5)
    a, m, mb, x = attn_weights(d), mlp_weights(d), mask_bias(d, shifted), windows(d)
    ops = {"attn": attn_operands(a, mb), "mlp": mlp_operands(m)}
    assert_kernel_matches_plain(swin_block.swin_block, swin_block.swin_block_plain,
                                (t(x), ops), cuda)
    assert_kernel_matches_plain(attn_ln.attn_ln, attn_ln.attn_ln_plain,
                                (t(x), ops["attn"]), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [37, 300])
def test_ln_mlp_kernel_on_card(cuda, rows):
    d = Draw(6)
    w, x = mlp_weights(d), d(rows, C, std=1.0)
    assert_kernel_matches_plain(ln_mlp.ln_mlp, ln_mlp.ln_mlp_plain,
                                (t(x), mlp_operands(w)), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [1, 3])
def test_cva_kernel_on_card(cuda, ratio):
    _, args, ops = cva_case(ratio, seed=7)
    assert_kernel_matches_plain(cva.cva, cva.cva_plain,
                                tuple(t(a) for a in args) + (ops,), cuda)
