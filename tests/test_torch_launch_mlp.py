"""#1's bf16 MLP half on the fused MLP (``csrc/mlp_sm90.cu``: ``mumpy_mlp_rows``)
inside the one-call block sequence (``csrc/swin_pair.cu``), on the CPU against
the model of the C ABI (``torch_cases.ModelLib``): bf16-valued inputs, held to
``swin_block_plain`` in f32 within the chip's 2e-2 * max(1, max|ref|) and its
branch bound, at C = 96 with the shift's mask period and C = 256 with a
hidden width that is not a whole number of 64-wide chunks, both on a ragged
row count; the planted faults (LayerNorm statistics ignored, GELU dropped),
the route by width and the wrapper's refusals.  The card holds the kernel
itself (``tests/test_torch_cuda_fused.py``).
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops
from mumpy_tpu_torch.ops import cuda_lib, swin_block
from torch_cases import (Draw, block_operands, block_weights, mask_bias, model_lib,  # noqa: F401
                         record_calls, t)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

WIN, GRID = 7, 14  # 8 windows of 49 tokens at batch 2: 392 rows, not whole 128-row tiles
SEQUENCE = ("mumpy_swin_blocks_fwd", "mumpy_ln_rows", "mumpy_gemm_rows", "mumpy_gemm_sm90",
            "mumpy_window_attention", "mumpy_mlp_rows")


def _block_case(c, heads, hidden, shifted, seed):
    """bf16 operands of one serving block and its windows (R, N, C)."""
    d = Draw(seed)
    w = block_weights(d, c, hidden)
    mb = mask_bias(d, shifted, heads, WIN, GRID)
    x = d(2 * (GRID // WIN) ** 2, WIN * WIN, c, std=1.0)
    return t(x).bfloat16(), cast_ops(block_operands(w, mb, heads), torch.bfloat16)


def _close(got, ref):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("c, heads, hidden, shifted", [(96, 3, 384, True), (256, 8, 992, False)])
def test_swin_block_runs_the_fused_mlp(model_lib, monkeypatch, c, heads, hidden, shifted):
    """The block in one call: LN1, qkv, attention and proj, then the MLP
    half in one fused launch; within the bounds of the f32 plain version on
    the same bf16 inputs."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    x, ops = _block_case(c, heads, hidden, shifted, seed=70 + c)
    got = swin_block.launch_swin_block(x, ops)
    # (the model takes the GEMM's entry without maps for a product without one)
    assert [name.replace("_sm90", "_rows") for name, _ in calls] == [
        "mumpy_swin_blocks_fwd", "mumpy_ln_rows", "mumpy_gemm_rows", "mumpy_window_attention",
        "mumpy_gemm_rows", "mumpy_mlp_rows"]
    ref = swin_block.swin_block_plain(x.float(), cast_ops(ops, torch.float32))
    _close(got, ref)
    assert branch_error("swin_block", x.float(), got, ref) <= BF16_BRANCH_TOL / 2


def test_fused_mlp_planted_faults(model_lib):
    """The LayerNorm statistics ignored and GELU dropped, each in the fused
    MLP, land far above the branch bound."""
    x, ops = _block_case(96, 3, 384, True, seed=72)
    ref = swin_block.swin_block_plain(x.float(), cast_ops(ops, torch.float32))
    for fault in ("ln_stats_on", "gelu_on"):
        bad = swin_block.launch_swin_block(x, {**ops, fault: False})
        assert branch_error("swin_block", x.float(), bad, ref) >= 3 * BF16_BRANCH_TOL, fault


def test_mlp_rows_matches_the_two_products(model_lib, monkeypatch):
    """``cuda_lib.mlp_rows`` against the two-product route it replaces
    (``ln_rows``, fc1 with GELU, fc2 with the residual) on 45 rows (ragged)
    at C = 96 with a hidden of 352 (5.5 chunks of 64)."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    d = Draw(73)
    w = block_weights(d, 96, 352)
    m = cast_ops(block_operands(w, mask_bias(d, False, 3), 3)["mlp"], torch.bfloat16)
    x = t(d(45, 96, std=1.0)).bfloat16()
    got = cuda_lib.mlp_rows(x, m)
    h, _ = cuda_lib.gemm(x, m["w1"], m["b1"], ln=(m["ln_g"], m["ln_b"]), gelu=True)
    _, ref = cuda_lib.gemm(h, m["w2"], m["b2"], res=x, want_y=False, want_out=True)
    assert [name for name, _ in calls] == ["mumpy_mlp_rows", "mumpy_ln_rows",
                                           "mumpy_gemm_sm90", "mumpy_gemm_sm90"]
    _close(got, ref.float())


def test_block_routes_by_width(model_lib, monkeypatch):
    """The fused MLP takes C <= 256 in multiples of 16; other widths (here
    C = 24, and #2's pairs and #1's stages 2 and 3 at 384-1024) keep LN2,
    fc1 and fc2 on the persistent GEMM."""
    calls = record_calls(monkeypatch, *SEQUENCE)
    for c, heads, fused in ((32, 1, True), (24, 3, False)):
        calls.clear()
        x, ops = _block_case(c, heads, 4 * c, False, seed=74)
        swin_block.launch_swin_block(x, ops)
        names = [name for name, _ in calls]
        assert ("mumpy_mlp_rows" in names) == fused
        assert names.count("mumpy_ln_rows") == (1 if fused else 2)
    assert cuda_lib.fused_mlp(256, 1024) and not cuda_lib.fused_mlp(384, 1536)


def test_mlp_rows_refusals(model_lib):
    """Widths the kernel does not take, and f32, raise before any launch."""
    d = Draw(75)
    for c, hidden in ((24, 96), (384, 1536), (96, 380)):
        m = cast_ops(block_operands(block_weights(d, c, hidden), mask_bias(d, False, 1), 1)["mlp"],
                     torch.bfloat16)
        with pytest.raises(ValueError, match="fused MLP takes"):
            cuda_lib.mlp_rows(t(d(8, c)).bfloat16(), m)
    m = block_operands(block_weights(d, 32, 128), mask_bias(d, False, 1), 1)["mlp"]
    with pytest.raises(TypeError):
        cuda_lib.mlp_rows(t(d(8, 32)), m)
