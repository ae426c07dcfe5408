"""#3 (``attn_ln``) and #4 (``ln_mlp``) in bf16 as one C call each
(``csrc/swin_pair.cu``: ``mumpy_attn_ln_fwd``, ``mumpy_ln_mlp_fwd``), #3 at
C <= 256 on the fused attention half (``csrc/attn_sm90.cu``:
``mumpy_attn_rows``), on the CPU against the model of the C ABI
(``torch_cases.ModelLib``): bf16-valued inputs, held to ``attn_ln_plain`` /
``ln_mlp_plain`` in f32 within the chip's 2e-2 * max(1, max|ref|) and its
branch bound, at C = 96 (3 heads) on a window count that is not a whole
number of the kernel's tiles (three windows at C <= 128, two wider), C = 192
(6 heads) on 5 windows and C = 256 (8 heads) with a mask period of 4 on
the fused route, C = 384 on the four launches; the recorded call sequence of
each route; the planted faults (LayerNorm statistics ignored, pad keys
unmasked, GELU dropped) and the wrappers' refusals.  The card holds the
kernels themselves (``tests/test_torch_cuda_cross.py``).
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops
from mumpy_tpu_torch.ops import attn_ln, cuda_lib, ln_mlp
from torch_cases import (Draw, block_operands, block_weights, mask_bias, model_lib,  # noqa: F401
                         record_calls, t)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

WIN, GRID = 7, 14  # 49 tokens; a shifted mask+bias has a period of 4 windows
SEQUENCE = ("mumpy_attn_ln_fwd", "mumpy_attn_rows", "mumpy_ln_mlp_fwd", "mumpy_mlp_rows",
            "mumpy_ln_rows", "mumpy_gemm_sm90", "mumpy_gemm", "mumpy_window_attention")


def _case(c, heads, windows, shifted, seed):
    """bf16 windows (R, N, C) and bf16 ``attn_ln`` and ``ln_mlp`` operands of
    a cross-view block, the mask+bias in f32."""
    d = Draw(seed)
    ops = block_operands(block_weights(d, c, 4 * c), mask_bias(d, shifted, heads, WIN, GRID),
                         heads)
    x = t(d(windows, WIN * WIN, c, std=1.0)).bfloat16()
    return x, cast_ops(ops["attn"], torch.bfloat16), cast_ops(ops["mlp"], torch.bfloat16)


def _held(name, x, got, ref):
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        err = (g.float() - r).abs().max().item()
        assert err <= 2e-2 * max(1.0, r.abs().max().item()), (name, err)
    assert branch_error(name, x.float(), got, ref) <= BF16_BRANCH_TOL / 2, name


@pytest.mark.parametrize("c, heads, windows, shifted", [(96, 3, 9, False), (192, 6, 5, False),
                                                         (256, 8, 8, True)])
def test_attn_ln_fused_route(model_lib, monkeypatch, c, heads, windows, shifted):
    """At C <= 256 #3 is one call and one launch of the fused kernel."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    x, a, _ = _case(c, heads, windows, shifted, seed=80 + c)
    got = attn_ln.launch_attn_ln(x, a)
    assert [name for name, _ in calls] == ["mumpy_attn_ln_fwd", "mumpy_attn_rows"]
    _held("attn_ln", x, got, attn_ln.attn_ln_plain(x.float(), cast_ops(a, torch.float32)))


def test_wide_and_f32_routes(model_lib, monkeypatch):
    """At C = 384 #3 is one call of four launches (LN, qkv, the attention
    core, proj) and #4 one of three; f32 composes its launches in Python."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    x, a, m = _case(384, 12, 4, False, seed=83)
    got = attn_ln.launch_attn_ln(x, a)
    mlp = ln_mlp.launch_ln_mlp(x, m)
    assert [name for name, _ in calls] == [
        "mumpy_attn_ln_fwd", "mumpy_ln_rows", "mumpy_gemm_sm90", "mumpy_window_attention",
        "mumpy_gemm_sm90", "mumpy_ln_mlp_fwd", "mumpy_ln_rows", "mumpy_gemm_sm90",
        "mumpy_gemm_sm90"]
    a32, m32 = cast_ops(a, torch.float32), cast_ops(m, torch.float32)
    _held("attn_ln", x, got, attn_ln.attn_ln_plain(x.float(), a32))
    _held("ln_mlp", x, mlp, ln_mlp.ln_mlp_plain(x.float(), m32))
    calls.clear()
    attn_ln.launch_attn_ln(x.float(), a32)
    ln_mlp.launch_ln_mlp(x.float(), m32)
    assert [name for name, _ in calls] == ["mumpy_gemm", "mumpy_window_attention", "mumpy_gemm",
                                           "mumpy_gemm", "mumpy_gemm"]


def test_ln_mlp_fused_route(model_lib, monkeypatch):
    """At C <= 256 #4 is one call and one launch of the fused MLP, on the
    token rows of the cross-view block's (B, L, C) stream."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    x, _, m = _case(96, 3, 9, False, seed=84)
    x = x.reshape(3, 3 * WIN * WIN, 96)
    got = ln_mlp.launch_ln_mlp(x, m)
    assert [name for name, _ in calls] == ["mumpy_ln_mlp_fwd", "mumpy_mlp_rows"]
    _held("ln_mlp", x, got, ln_mlp.ln_mlp_plain(x.float(), cast_ops(m, torch.float32)))


def test_planted_faults(model_lib):
    """The LayerNorm statistics ignored (#3 on both routes, #4), the pad keys
    unmasked (#3's fused kernel) and GELU dropped (#4's fused MLP) each land
    far above the branch bound."""
    for c, heads in ((96, 3), (384, 12)):
        x, a, m = _case(c, heads, 5, False, seed=85)
        ref = attn_ln.attn_ln_plain(x.float(), cast_ops(a, torch.float32))
        faults = ["ln_stats_on"] + (["key_mask_on"] if c <= 256 else [])
        for fault in faults:
            bad = attn_ln.launch_attn_ln(x, {**a, fault: False})
            assert branch_error("attn_ln", x.float(), bad, ref) >= 3 * BF16_BRANCH_TOL, fault
        if c <= 256:
            ref = ln_mlp.ln_mlp_plain(x.float(), cast_ops(m, torch.float32))
            for fault in ("ln_stats_on", "gelu_on"):
                bad = ln_mlp.launch_ln_mlp(x, {**m, fault: False})
                assert branch_error("ln_mlp", x.float(), bad, ref) >= 3 * BF16_BRANCH_TOL, fault


def test_refusals(model_lib):
    """Shapes the kernels do not take raise before any launch: the fused
    half past C = 256 or at a head width other than 32, windows of more than
    64 tokens, widths that are not multiples of 8, f32 on the bf16 calls."""
    x, a, m = _case(384, 12, 2, False, seed=86)
    with pytest.raises(ValueError, match="fused attention half takes"):
        cuda_lib.attn_rows(x, a)
    x64, a64, _ = _case(64, 4, 2, False, seed=87)  # a head width of 16
    with pytest.raises(ValueError, match="fused attention half takes"):
        cuda_lib.attn_rows(x64, a64)
    x96, a96, m96 = _case(96, 3, 2, False, seed=88)
    assert cuda_lib.fused_attn(49, 256, 8) and not cuda_lib.fused_attn(81, 96, 3)
    with pytest.raises(ValueError, match="n <= 64"):
        cuda_lib.attn_ln_fwd(x96.reshape(1, 98, 96), a96)
    with pytest.raises(TypeError):
        cuda_lib.attn_ln_fwd(x96.float(), a96)
    with pytest.raises(ValueError, match="multiples of 8"):
        cuda_lib.ln_mlp_fwd(x96.reshape(-1, 96),
                            {**m96, "w1": m96["w1"][:, :380].contiguous(),
                             "b1": m96["b1"][:380], "w2": m96["w2"][:380]})
