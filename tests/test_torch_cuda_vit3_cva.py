"""#6 (``vit3``) and #5 (``cva``) as one C call each (``csrc/vit3_sm90.cu``,
``csrc/cva_sm90.cu``), on the card: #6's fused qkv product and n = 3
attention at head width 64, #5's fused core at C <= 256.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  bf16 against the f32 plain version on the same
bf16-valued inputs (TF32 off), within the port's bf16 bound 2e-2 * max(1,
max|ref|) and its branch bound: #6 at the flagship layer (batch 32), also
against the seven launches it replaced; a row count that is not a whole
number of 64-row tiles, the other head widths' route and the scores-zeroed
fault; #5 at its four C <= 256 flagship instances (batch 32) on the fused
kernel, also against the five launches from Python; the five launches of
the one call at C = 384 and 768; and #5's planted faults on both routes.
"""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, uniform_attention
from torch_cases import cuda, cva_case, t, to_dev, vit3_case  # noqa: F401

# #5's C <= 256 instances at batch 32: (B1 query windows, ratio, C, heads, grid)
CVA_SHAPES = ((2048, 3, 96, 3, 224), (2048, 1, 96, 3, 224), (512, 3, 192, 6, 112),
              (512, 1, 192, 6, 112))


def _held(name, x, got, ref, bound=BF16_BRANCH_TOL):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (name, err)
    assert branch_error(name, x.float(), got, ref) <= bound, name


def _vit3(seed, r, c, heads):
    """bf16 tokens (3, r, c) and ``vit3`` operands on the card, and the f32
    plain version's output on the same values."""
    from mumpy_tpu_torch.ops import vit3

    _, x, ops = vit3_case(seed=seed, r=r, c=c, heads=heads)
    x, ops = to_dev((t(x).bfloat16(), cast_ops(ops, torch.bfloat16)), "cuda")
    return x, ops, vit3.vit3_plain(x.float(), cast_ops(ops, torch.float32))


def _cva(seed, ratio, c, heads, grid, groups=3):
    """bf16 windows, f32 coordinates and bf16 ``cva`` operands on the card,
    and the f32 plain version's output on the same values."""
    from mumpy_tpu_torch.ops import cva

    _, (x1, x2, gy, gx), ops = cva_case(ratio, seed=seed, groups=groups, c=c, heads=heads,
                                        win=7, grid=grid)
    x1, x2, gy, gx, ops = to_dev((t(x1).bfloat16(), t(x2).bfloat16(), t(gy), t(gx),
                                  cast_ops(ops, torch.bfloat16)), "cuda")
    return x1, x2, gy, gx, ops, cva.cva_plain(x1.float(), x2.float(), gy, gx,
                                               cast_ops(ops, torch.float32))


@pytest.mark.cuda
def test_vit3_fused_flagship(cuda):
    """The flagship layer (1568 rows a slab, C 768, 12 heads of 64, hidden
    3072) in one call, against the f32 plain version and the seven launches
    it replaced; the fused kernel's o against the qkv GEMM and
    vit3_attention.cu on the same normalised rows."""
    from mumpy_tpu_torch.ops import cuda_lib, vit3

    x, ops, ref = _vit3(161, 1568, 768, 12)
    assert cuda_lib.fused_vit3(768, 12)
    got = vit3.launch_vit3(x, ops)
    seven = vit3.vit3_sequence(x, ops)
    torch.cuda.synchronize()
    _held("vit3", x, got, ref)
    _held("vit3", x, seven, got.float())
    a = ops["attn"]
    h = cuda_lib.ln_rows(x.reshape(-1, 768), a["ln_g"], a["ln_b"])[0]
    o = cuda_lib.vit3_qkv_attn(h.reshape(3, 1568, 768), a["w_qkv_rows"], a["b_qkv"], 12)
    qkv, _ = cuda_lib.gemm(h, a["w_qkv"], a["b_qkv"])
    o_ref = cuda_lib.vit3_attention(qkv.reshape(3, 1568, 3 * 768), heads=12)
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2 * max(
        1.0, o_ref.float().abs().max().item())


@pytest.mark.cuda
def test_vit3_ragged_route_and_fault(cuda):
    """130 rows a slab (the last 64-row tile holds two) at C 128 (2 heads of
    64, fused) and at C 96 (4 heads of 24: the qkv GEMM and
    vit3_attention.cu); the scores zeroed far above the branch bound on the
    fused route."""
    from mumpy_tpu_torch.ops import cuda_lib, vit3

    for c, heads in ((128, 2), (96, 4)):
        x, ops, ref = _vit3(171 + c, 130, c, heads)
        assert cuda_lib.fused_vit3(c, heads) == (c == 128)
        _held("vit3", x, vit3.launch_vit3(x, ops), ref)
        if c == 128:
            bad = vit3.launch_vit3(x, uniform_attention(ops))
            assert branch_error("vit3", x.float(), bad, ref) >= 3 * BF16_BRANCH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(CVA_SHAPES)))
def test_cva_fused_flagship(cuda, shape):
    """#5 on the fused kernel, one launch, against the f32 plain version and
    the five launches from Python (the fold in the attention core)."""
    from mumpy_tpu_torch.ops import cuda_lib, cva

    b1, ratio, c, heads, grid = CVA_SHAPES[shape]
    x1, x2, gy, gx, ops, ref = _cva(181 + shape, ratio, c, heads, grid)
    assert x1.shape[0] == b1 and cuda_lib.fused_cva(49, c, heads, 3, 7)
    got = cva.launch_cva(x1, x2, gy, gx, ops)
    five = cva.cva_sequence(x1, x2, gy, gx, ops)
    torch.cuda.synchronize()
    _held("cva", x1, got, ref)
    _held("cva", x1, five, ref)


@pytest.mark.cuda
def test_cva_routes_and_faults(cuda):
    """The five launches of the one call at C 384 (ratio 3) and 768 (ratio
    1); the fused core's other instances, C 256 (4 groups: one consumer a
    block) and C 64 (2 groups); and #5's planted faults far above the branch
    bound: the bilinear weights ignored and the fold dropped on both routes,
    the pad keys unmasked on the fused one (at least twice the bound), on 41
    query windows at C 96 (three-window tiles: the last holds two)."""
    from mumpy_tpu_torch.ops import cuda_lib, cva

    for ratio, c, heads, windows, groups in ((3, 384, 12, 128, 3), (1, 768, 24, 32, 3),
                                             (3, 96, 3, 41, 3), (3, 256, 8, 9, 4),
                                             (1, 64, 2, 10, 2)):
        # cva_case's query windows: 2 images of (grid / 7)^2, 32 or 128, cut to `windows`
        x1, x2, gy, gx, ops, _ = _cva(191 + c, ratio, c, heads, 28 if windows == 32 else 56,
                                      groups)
        x1, x2 = x1[:windows].contiguous(), x2[:windows * ratio].contiguous()
        gy, gx = gy[:, :windows].contiguous(), gx[:, :windows].contiguous()
        ref = cva.cva_plain(x1.float(), x2.float(), gy, gx, cast_ops(ops, torch.float32))
        assert cuda_lib.fused_cva(49, c, heads, groups, 7) == (c <= 256)
        _held("cva", x1, cva.launch_cva(x1, x2, gy, gx, ops), ref)
        faults = ["sample_on"] + (["fold_on"] if ratio > 1 else []) + (
            ["key_mask_on"] if c <= 256 else [])
        for fault in faults:
            bad = cva.launch_cva(x1, x2, gy, gx, {**ops, fault: False})
            # the pad keys hold only the k and v biases (s is zero past N), so
            # unmasking them moves the branch least: 2.9-4.7x the bound here
            times = 2 if fault == "key_mask_on" else 3
            assert branch_error("cva", x1.float(), bad, ref) >= times * BF16_BRANCH_TOL, fault
