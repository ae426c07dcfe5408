"""The ``swin_pair`` and ``vit3`` kernels on the card against their plain
PyTorch versions: f32 (TF32 off) within 1e-4 * max(1, max|ref|), and bf16 as
``chip_smoke.py`` holds them, planted faults included.

Marked ``cuda``; skips where ``torch.cuda`` has no device.  Imports no JAX.
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, planted_faults
from mumpy_tpu_torch.ops import swin_pair, vit3
from torch_cases import (PAIR_GEOMETRIES, assert_kernel_matches_plain, cuda,  # noqa: F401
                         pair_case, t, to_dev, vit3_case)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(PAIR_GEOMETRIES))
def test_swin_pair_kernel_on_card(cuda, geometry):
    _, x, ops = pair_case(PAIR_GEOMETRIES[geometry], seed=41)
    assert_kernel_matches_plain(swin_pair.swin_pair, swin_pair.swin_pair_plain,
                                (t(x), ops), cuda)


@pytest.mark.cuda
def test_vit3_kernel_on_card(cuda):
    _, x, ops = vit3_case(seed=42)
    assert_kernel_matches_plain(vit3.vit3, vit3.vit3_plain, (t(x), ops), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["swin_pair", "vit3"])
def test_bf16_pair_and_vit3_on_card(cuda, name):
    """bf16 within 2e-2 * max(1, max|ref|) of the f32 plain version, the
    branch within BF16_BRANCH_TOL RMS of the f32 plain version on the same
    bf16 inputs, and every planted fault caught (hd 32 and hd 64)."""
    if name == "swin_pair":
        _, x, ops = pair_case(PAIR_GEOMETRIES["w7s3"], seed=43)
        kernel, plain = swin_pair.swin_pair, swin_pair.swin_pair_plain
    else:
        _, x, ops = vit3_case(seed=44, r=50, c=128, heads=2)
        kernel, plain = vit3.vit3, vit3.vit3_plain
    x, ops = to_dev(t(x), cuda), to_dev(ops, cuda)
    x16, ops16 = x.bfloat16(), cast_ops(ops, torch.bfloat16)
    ref = plain(x, ops)
    ref16 = plain(x16.float(), cast_ops(ops16, torch.float32))
    got = kernel(x16, ops16)
    torch.cuda.synchronize()
    assert (got.float() - ref).abs().max().item() <= 2e-2 * max(1.0, ref.abs().max().item())
    assert branch_error(name, x16.float(), got, ref16) <= BF16_BRANCH_TOL
    for label, bad, _ in planted_faults(name, ops16):
        assert branch_error(name, x16.float(), kernel(x16, bad), ref16) > BF16_BRANCH_TOL, label
