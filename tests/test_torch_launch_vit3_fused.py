"""#6 (``vit3``) in bf16 as one C call (``csrc/vit3_sm90.cu``:
``mumpy_vit3_fwd``), at head width 64 on the fused qkv product and n = 3
attention (``mumpy_vit3_qkv_attn``), on the CPU against the model of the C
ABI (``torch_cases.ModelLib``): bf16-valued inputs held to ``vit3_plain`` in
f32 within the chip's 2e-2 * max(1, max|ref|) and its branch bound, on a
row count that is not a whole number of the kernel's 64-row tiles; the
recorded call sequence of each route (fused; other head widths; f32); the
scores-zeroed fault; the refusals; and the library yardstick of
``chip_smoke.py`` (``torch._transformer_encoder_layer_fwd``) computing the
same function as ``vit3_plain``.  The card holds the kernel itself
(``tests/test_torch_cuda_vit3_cva.py``).
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, uniform_attention, vit3_library
from mumpy_tpu_torch.ops import cuda_lib, vit3
from torch_cases import model_lib, record_calls, t, vit3_case  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SEQUENCE = ("mumpy_vit3_fwd", "mumpy_vit3_qkv_attn", "mumpy_ln_rows", "mumpy_gemm_rows",
            "mumpy_gemm_sm90", "mumpy_gemm", "mumpy_vit3_attention", "mumpy_ln_mlp_fwd",
            "mumpy_mlp_rows")


def _case(seed, r, c, heads):
    """bf16 time-major tokens (3, r, c), bf16 operands, and the f32 plain
    version's output on the same values."""
    _, x, ops = vit3_case(seed=seed, r=r, c=c, heads=heads)
    x16, ops16 = t(x).bfloat16(), cast_ops(ops, torch.bfloat16)
    return x16, ops16, vit3.vit3_plain(x16.float(), cast_ops(ops16, torch.float32))


def _held(x, got, ref):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err
    assert branch_error("vit3", x.float(), got, ref) <= BF16_BRANCH_TOL / 2


def test_fused_route(model_lib, monkeypatch):
    """C = 128 (two heads of 64) on 70 rows a slab: one call, the fused
    kernel between the two ``ln_rows`` passes, the projection on the
    persistent GEMM and #4's call (its fused MLP at this width)."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    x, ops, ref = _case(201, 70, 128, 2)
    got = vit3.launch_vit3(x, ops)
    assert [name for name, _ in calls] == [
        "mumpy_vit3_fwd", "mumpy_ln_rows", "mumpy_vit3_qkv_attn", "mumpy_gemm_rows",
        "mumpy_ln_mlp_fwd", "mumpy_mlp_rows"]
    _held(x, got, ref)


def test_other_routes(model_lib, monkeypatch):
    """Head widths other than 64 take the qkv GEMM (Wqkv read as torch
    stores it) and vit3_attention.cu in the same call; C = 768 (the
    flagship's width, 12 heads of 64) runs #4's three launches; f32 composes
    the seven launches in Python."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    x, ops, ref = _case(202, 9, 96, 4)
    got = vit3.launch_vit3(x, ops)
    assert [name for name, _ in calls] == [
        "mumpy_vit3_fwd", "mumpy_ln_rows", "mumpy_gemm_rows", "mumpy_vit3_attention",
        "mumpy_gemm_rows", "mumpy_ln_mlp_fwd", "mumpy_mlp_rows"]
    assert calls[2][1][15] == 1  # b_kmajor: the (3C, C) rows
    _held(x, got, ref)
    calls.clear()
    x, ops, ref = _case(203, 5, 768, 12)
    _held(x, vit3.launch_vit3(x, ops), ref)
    assert [name for name, _ in calls] == [
        "mumpy_vit3_fwd", "mumpy_ln_rows", "mumpy_vit3_qkv_attn", "mumpy_gemm_rows",
        "mumpy_ln_mlp_fwd", "mumpy_ln_rows", "mumpy_gemm_sm90", "mumpy_gemm_sm90"]
    calls.clear()
    x, ops, _ = _case(204, 9, 96, 4)
    f32 = cast_ops(ops, torch.float32)
    got = vit3.launch_vit3(x.float(), f32)
    assert [name for name, _ in calls] == ["mumpy_gemm", "mumpy_vit3_attention", "mumpy_gemm",
                                           "mumpy_gemm", "mumpy_gemm"]
    assert (got - vit3.vit3_plain(x.float(), f32)).abs().max().item() <= 1e-5


def test_scores_zeroed_is_caught(model_lib):
    """chip_smoke.py's planted fault (the query projection zeroed in both
    layouts) on the fused route: far above the branch bound."""
    x, ops, ref = _case(205, 70, 128, 2)
    bad = vit3.launch_vit3(x, uniform_attention(ops))
    assert branch_error("vit3", x.float(), bad, ref) >= 3 * BF16_BRANCH_TOL


def test_refusals(model_lib):
    """The fused kernel takes a head width of 64 and (3, R, C) rows; the
    call takes bf16, a head width of at most 128 and widths that are
    multiples of 8."""
    x, ops, _ = _case(206, 6, 96, 4)
    a = ops["attn"]
    with pytest.raises(ValueError, match="head width of\\s+64"):
        cuda_lib.vit3_qkv_attn(x, a["w_qkv_rows"], a["b_qkv"], 4)
    wide, wide_ops, _ = _case(208, 2, 264, 2)  # a head width of 132
    with pytest.raises(ValueError, match="head width of at most 128"):
        cuda_lib.vit3_fwd(wide, wide_ops)
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_lib.vit3_fwd(x.float(), ops)
    assert cuda_lib.fused_vit3(768, 12) and not cuda_lib.fused_vit3(96, 4)


def test_library_yardstick_computes_the_layer():
    """``torch._transformer_encoder_layer_fwd`` on the port's operands (the
    token-major rows, the weights in torch's layout), f32 on the CPU, is
    ``vit3_plain`` within 1e-5: the yardstick times the same function."""
    _, x, ops = vit3_case(seed=207, r=20, c=64, heads=4)
    x = t(x)
    call, back = vit3_library(x, ops)
    with torch.inference_mode():
        got = back(call())
    ref = vit3.vit3_plain(x, ops)
    assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())
