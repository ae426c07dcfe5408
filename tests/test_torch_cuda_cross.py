"""#3 (``attn_ln``) and #4 (``ln_mlp``) as one C call each
(``csrc/swin_pair.cu``), #3's fused attention half (``csrc/attn_sm90.cu``) at
C <= 256, on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  bf16 against the f32 plain version on the same
bf16-valued inputs (TF32 off), within the port's bf16 bound 2e-2 * max(1,
max|ref|) and its branch bound: #3 at its four C <= 256 flagship shapes
(batch 32) on the fused kernel, also against the four-launch route it
replaces; a window count that is not a whole number of the kernel's
three-window tiles, with a mask period of 2, and its planted faults; the
four-launch route at
C = 384; #4 on both routes with its faults.
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error
from torch_cases import cuda  # noqa: F401

# #3's C <= 256 instances at batch 32: (windows, tokens, C, heads)
ATTN_SHAPES = ((2048, 49, 96, 3), (6144, 49, 128, 4), (512, 49, 192, 6), (1536, 49, 256, 8))


def _bf16(g, *shape, scale=1.0, mean=0.0):
    return (mean + torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


def _attn_case(seed, r, n, c, heads, period=1):
    """bf16 windows and ``attn_ln`` operands (f32 mask+bias of period
    ``period``), and the f32 operands on the same values."""
    from mumpy_tpu_torch.ops.attn_ln import attn_ln_operands

    g = torch.Generator(device="cuda").manual_seed(seed)
    ops = attn_ln_operands(_bf16(g, c, mean=1.0, scale=0.1), _bf16(g, c, scale=0.1),
                           _bf16(g, 3 * c, c, scale=c**-0.5), _bf16(g, 3 * c, scale=0.1),
                           _bf16(g, c, c, scale=c**-0.5), _bf16(g, c, scale=0.1),
                           torch.randn(period, heads, n, n, generator=g, device="cuda"), heads)
    f32 = {k: v.float() if torch.is_tensor(v) else v for k, v in ops.items()}
    return _bf16(g, r, n, c), ops, f32


def _check(name, x, got, ref):
    for gt, rf in zip(got if isinstance(got, tuple) else (got,),
                      ref if isinstance(ref, tuple) else (ref,)):
        err = (gt.float() - rf).abs().max().item()
        assert err <= 2e-2 * max(1.0, rf.abs().max().item()), (name, err)
    assert branch_error(name, x.float(), got, ref) <= BF16_BRANCH_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(ATTN_SHAPES)))
def test_attn_ln_fused_flagship(cuda, shape):
    """#3 on the fused kernel, one launch, against the f32 plain version and
    against the four launches it replaces."""
    from mumpy_tpu_torch.ops import attn_ln, cuda_lib

    r, n, c, heads = ATTN_SHAPES[shape]
    x, ops, f32 = _attn_case(121 + shape, r, n, c, heads)
    assert cuda_lib.fused_attn(n, c, heads)
    got = attn_ln.launch_attn_ln(x, ops)
    four = attn_ln.attn_sequence(x.reshape(r * n, c), ops, r, n)
    ref = attn_ln.attn_ln_plain(x.float(), f32)
    torch.cuda.synchronize()
    _check("attn_ln", x, got, ref)
    for a, b in zip(got, four):
        assert (a.float() - b.reshape(a.shape).float()).abs().max().item() <= 2e-2 * max(
            1.0, b.float().abs().max().item())


@pytest.mark.cuda
def test_attn_ln_fused_ragged_and_faults(cuda):
    """40 windows at C = 96 (three-window tiles: the last holds one) with a
    mask period of 2 (read from device memory, not staged): within the
    bounds, and each planted fault (the LayerNorm statistics ignored, the pad
    keys unmasked, the mask+bias zeroed) far above the branch bound."""
    from mumpy_tpu_torch.ops import attn_ln

    x, ops, f32 = _attn_case(131, 40, 49, 96, 3, period=2)
    ref = attn_ln.attn_ln_plain(x.float(), f32)
    _check("attn_ln", x, attn_ln.launch_attn_ln(x, ops), ref)
    for label, bad in (("ln", {**ops, "ln_stats_on": False}),
                       ("keys", {**ops, "key_mask_on": False}),
                       ("mb", {**ops, "mb": torch.zeros_like(ops["mb"])})):
        err = branch_error("attn_ln", x.float(), attn_ln.launch_attn_ln(x, bad), ref)
        assert err >= 3 * BF16_BRANCH_TOL, (label, err)


@pytest.mark.cuda
def test_attn_ln_wide_route(cuda):
    """C = 384 (12 heads): the four launches from one C call, Wqkv read as
    torch stores it."""
    from mumpy_tpu_torch.ops import attn_ln, cuda_lib

    x, ops, f32 = _attn_case(141, 256, 49, 384, 12)
    assert not cuda_lib.fused_attn(49, 384, 12)
    _check("attn_ln", x, attn_ln.launch_attn_ln(x, ops), attn_ln.attn_ln_plain(x.float(), f32))


@pytest.mark.cuda
def test_ln_mlp_one_call(cuda):
    """#4 in one C call at C = 128 (the fused MLP) and C = 384 (three
    launches) on a ragged row count; GELU dropped and the LayerNorm
    statistics ignored caught on the fused route."""
    from mumpy_tpu_torch.ops import cuda_lib, ln_mlp
    from mumpy_tpu_torch.ops.ln_mlp import ln_mlp_operands

    for c in (128, 384):
        g = torch.Generator(device="cuda").manual_seed(151 + c)
        ops = ln_mlp_operands(_bf16(g, c, mean=1.0, scale=0.1), _bf16(g, c, scale=0.1),
                              _bf16(g, 4 * c, c, scale=c**-0.5), _bf16(g, 4 * c, scale=0.1),
                              _bf16(g, c, 4 * c, scale=(4 * c) ** -0.5), _bf16(g, c, scale=0.1))
        f32 = {k: v.float() for k, v in ops.items()}
        x = _bf16(g, 3, 1571, c, mean=0.5)
        ref = ln_mlp.ln_mlp_plain(x.float(), f32)
        _check("ln_mlp", x, ln_mlp.launch_ln_mlp(x, ops), ref)
        if cuda_lib.fused_mlp(c, 4 * c):
            for fault in ("gelu_on", "ln_stats_on"):
                bad = ln_mlp.launch_ln_mlp(x, {**ops, fault: False})
                assert branch_error("ln_mlp", x.float(), bad, ref) >= 3 * BF16_BRANCH_TOL, fault
