"""#5 (``cva``) in bf16 as one C call (``csrc/cva_sm90.cu``: ``mumpy_cva_fwd``),
at head width 32 and C <= 256 one launch of the fused core
(``mumpy_cva_rows``), wider five launches with the ratio fold in the
attention core (``mumpy_window_attention_fold``), on the CPU against the
model of the C ABI (``torch_cases.ModelLib``): bf16-valued inputs held to
``cva_plain`` in f32 within the chip's 2e-2 * max(1, max|ref|) and its branch
bound, at C = 96 (ratio 3 and 1) and C = 192 on query-window counts that are
not whole numbers of the kernel's tiles (three windows at C <= 128, two
wider), C = 384 on the five launches; the recorded call sequence of each
route (and of f32's, whose projection prologue folds); the planted faults
(the bilinear weights ignored, the fold dropped, the pad keys unmasked); and
the refusals.  The card holds the kernels themselves
(``tests/test_torch_cuda_vit3_cva.py``).
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops
from mumpy_tpu_torch.ops import cuda_lib, cva
from torch_cases import cva_case, model_lib, record_calls, t  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SEQUENCE = ("mumpy_cva_fwd", "mumpy_cva_rows", "mumpy_gemm_rows", "mumpy_gemm_sm90",
            "mumpy_gemm", "mumpy_cva_sample", "mumpy_window_attention_fold",
            "mumpy_window_attention")


def _case(seed, ratio, c, heads, windows):
    """bf16 query and partner windows of 7 x 7 tokens (``windows`` query
    windows cut from cva_case's 8), f32 coordinates, bf16 operands, and the
    f32 plain version's output on the same values."""
    _, (x1, x2, gy, gx), ops = cva_case(ratio, seed=seed, c=c, heads=heads, win=7, grid=14)
    x1, x2 = t(x1[:windows]).bfloat16(), t(x2[:windows * ratio]).bfloat16()
    gy, gx = t(gy[:, :windows]), t(gx[:, :windows])
    ops16 = cast_ops(ops, torch.bfloat16)
    ref = cva.cva_plain(x1.float(), x2.float(), gy, gx, cast_ops(ops16, torch.float32))
    return (x1, x2, gy, gx), ops16, ref


def _held(x1, got, ref):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err
    assert branch_error("cva", x1.float(), got, ref) <= BF16_BRANCH_TOL / 2


@pytest.mark.parametrize("c, heads, ratio, windows", [(96, 3, 3, 5), (96, 3, 1, 7),
                                                      (192, 6, 3, 5)])
def test_fused_route(model_lib, monkeypatch, c, heads, ratio, windows):
    """At C <= 256 #5 is one call and one launch of the fused core."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    args, ops, ref = _case(211 + c + ratio, ratio, c, heads, windows)
    got = cva.launch_cva(*args, ops)
    assert [name for name, _ in calls] == ["mumpy_cva_fwd", "mumpy_cva_rows"]
    _held(args[0], got, ref)


def test_wide_and_f32_routes(model_lib, monkeypatch):
    """At C = 384 #5 is one call of five launches: q and k|v on the
    persistent GEMM reading the weights as torch stores them, the sampler,
    the attention core folding each output window's three partner windows,
    the projection; f32 composes five launches in Python, its projection
    prologue folding (csrc/gemm.cu)."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    args, ops, ref = _case(221, 3, 384, 12, 4)
    got = cva.launch_cva(*args, ops)
    assert [name for name, _ in calls] == [
        "mumpy_cva_fwd", "mumpy_gemm_rows", "mumpy_cva_sample", "mumpy_gemm_rows",
        "mumpy_window_attention_fold", "mumpy_window_attention", "mumpy_gemm_rows"]
    assert [a[15] for name, a in calls if name == "mumpy_gemm_rows"] == [1, 1, 0]  # b_kmajor
    _held(args[0], got, ref)
    calls.clear()
    f32 = cast_ops(ops, torch.float32)
    args32 = [a.float() for a in args]
    got = cva.launch_cva(*args32, f32)
    assert [name for name, _ in calls] == ["mumpy_gemm", "mumpy_cva_sample", "mumpy_gemm",
                                           "mumpy_window_attention", "mumpy_gemm"]
    assert calls[-1][1][16] == 3  # a_sum: the ratio fold
    assert (got - cva.cva_plain(*args32, f32)).abs().max().item() <= 1e-5 * max(
        1.0, got.abs().max().item())


def test_planted_faults(model_lib):
    """The bilinear weights ignored and the fold dropped (both routes) and
    the pad keys unmasked (the fused core) each land far above the branch
    bound."""
    for c, heads in ((96, 3), (384, 12)):
        args, ops, ref = _case(231 + c, 3, c, heads, 4)
        faults = ("sample_on", "fold_on") + (("key_mask_on",) if c <= 256 else ())
        for fault in faults:
            bad = cva.launch_cva(*args, {**ops, fault: False})
            assert branch_error("cva", args[0].float(), bad, ref) >= 3 * BF16_BRANCH_TOL, fault


def test_refusals(model_lib):
    """The fused core takes a head width of 32 and C <= 256; the call takes
    partner windows in whole multiples of the query windows, a head width of
    at most 32 and windows of at most 64 tokens; the bf16 GEMM takes no row
    fold (f32 alone keeps it)."""
    args, ops, _ = _case(241, 3, 384, 12, 4)
    with pytest.raises(ValueError, match="fused CVA core takes"):
        cuda_lib.cva_rows(*args, ops)
    x1, x2, gy, gx = args
    with pytest.raises(ValueError, match="whole multiples"):
        cuda_lib.cva_fwd(x1, x2[:-1], gy, gx, ops)
    a64, o64, _ = _case(242, 1, 192, 3, 2)  # a head width of 64
    with pytest.raises(ValueError, match="head width of at most 32"):
        cuda_lib.cva_fwd(*a64, o64)
    assert cuda_lib.fused_cva(49, 96, 3, 3, 7) and not cuda_lib.fused_cva(49, 384, 12, 3, 7)
    assert not cuda_lib.fused_cva(81, 96, 3, 3, 9)
    with pytest.raises(ValueError, match="f32 only"):
        cuda_lib.gemm(torch.zeros(24, 8, dtype=torch.bfloat16),
                      torch.zeros(8, 8, dtype=torch.bfloat16), a_sum=3, a_seg=1)
