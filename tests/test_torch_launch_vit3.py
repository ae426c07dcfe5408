"""The ``vit3`` kernel's launch sequence on the CPU, against the model of the
C entry points (``torch_cases.ModelLib``): the LN + qkv GEMM over all three
time slices, the n = 3 attention's token / head offsets in the packed qkv,
and the projection and MLP GEMMs, held against ``vit3_plain``.  f32 exact to
1e-5; bf16 to 2e-2 * max(1, max|ref|)."""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, uniform_attention
from mumpy_tpu_torch.ops import cuda_lib, vit3
from torch_cases import check_launches, model_lib, t, vit3_case  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit3_launches(model_lib, dtype):
    _, x, ops = vit3_case()
    got = vit3.launch_vit3(t(x).to(dtype), cast_ops(ops, dtype))
    check_launches(got, vit3.vit3_plain(t(x), ops), dtype)


def test_vit3_with_zeroed_scores_is_caught(model_lib):
    """chip_smoke.py's planted fault for vit3, on the bf16 launch model at the
    flagship's head width (hd 64): uniform attention (scores zeroed) lands far
    above BF16_BRANCH_TOL, the true launches well below it."""
    _, x, ops = vit3_case(seed=32, r=24, c=128, heads=2)
    ops16, x16 = cast_ops(ops, torch.bfloat16), t(x).bfloat16()
    ref16 = vit3.vit3_plain(x16.float(), cast_ops(ops16, torch.float32))
    good = branch_error("vit3", x16.float(), vit3.launch_vit3(x16, ops16), ref16)
    bad = branch_error("vit3", x16.float(), vit3.launch_vit3(x16, uniform_attention(ops16)),
                       ref16)
    assert good <= BF16_BRANCH_TOL / 2 and bad >= 3 * BF16_BRANCH_TOL, (good, bad)


def test_vit3_refuses_other_layouts(model_lib):
    _, x, ops = vit3_case()
    with pytest.raises(ValueError, match="time-major"):
        vit3.launch_vit3(t(x).transpose(0, 1).contiguous(), ops)
    with pytest.raises(ValueError, match="hd = C / heads <= 128"):
        cuda_lib.vit3_attention(torch.zeros(3, 4, 3 * 258), heads=1)
