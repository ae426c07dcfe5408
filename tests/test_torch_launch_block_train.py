"""The whole-block training kernel's launch sequence on the CPU, forward and
backward, against a model of the C ABI (``torch_cases.ModelLib``, as in
``tests/test_torch_launch_train.py``) and the plain version's autograd.

``launch_swin_block_train`` is the CUDA path of ``swin_block_train``: its
``torch.autograd.Function`` calls the GEMM with the LayerNorm prologue, the
GELU and keep row-scale epilogues and the GELU-backward epilogue, the
window-attention core and its backward, the LayerNorm / scale-add row
kernels and the weight-gradient sums.  Here those calls run on the model, so
the strides, offsets, mask period, keep divisors and gradient layouts are
checked against autograd of the plain version, unshifted and shifted; the
row-split weight-gradient sums are also checked on one split and on two.  f32
within 1e-5 * max(1, max|ref|); bf16 against the f32 plain version on the
same bf16-valued inputs within the chip's 2e-2 * max(1, max|ref|).  Each
planted fault of ``chip_smoke.py`` lands far from the plain gradients.
"""

import pytest
import torch

from mumpy_tpu_torch.ops import cuda_lib
from mumpy_tpu_torch.ops import swin_block_train as sbt
from mumpy_tpu_torch.ops.attn_ln import pad_mask_bias
from mumpy_tpu_torch.ops.window import shifted_window_mask
from torch_cases import (GRID, WIN, block_train_case, model_lib, rounded,  # noqa: F401
                         run_with_grads)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_train_launches(model_lib, dtype, shifted):
    *args, cots = block_train_case(65, shifted)
    outs, grads = run_with_grads(sbt.launch_swin_block_train, args, cots, dtype)
    routs, rgrads = run_with_grads(sbt.swin_block_train_plain,
                                   [rounded(a, dtype) for a in args], cots)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert set(grads) == set(rgrads) and len(rgrads) == 14  # x, mb and the 12 weights
    for name, g, r in [("y", outs[0], routs[0])] + [(k, grads[k], rgrads[k]) for k in rgrads]:
        err = (g - r).abs().max().item()
        assert err <= tol * max(1.0, r.abs().max().item()), (name, err)


def test_planted_faults_move_the_gradients(model_lib):
    """The fault switches chip_smoke.py plants in the backward launches (the
    softmax backward's rowsum term dropped, gelu' replaced by 1) and its
    operand faults (keep2 ignored, the shift mask dropped from the
    mask+bias) each move dx far from the plain version's gradient."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    x, mb, p, keep1, keep2, (dy,) = block_train_case(66, shifted=True)
    xr = x.clone().requires_grad_()
    sbt.swin_block_train_plain(xr, mb, p, keep1, keep2).backward(dy)
    w = [p[k] for k in sbt._WEIGHTS]
    transposed = [p[k].t().contiguous() for k in ("w_qkv", "w_proj", "w1")]

    def dx(mbp=pad_mask_bias(mb), k2=keep2, **fault):
        return sbt.launch_swin_block_train_bwd(x, mbp, keep1, k2, *w, *transposed,
                                               p["heads"], dy, **fault)[0]

    assert rel(dx(), xr.grad) < 1e-5
    assert rel(dx(rowsum=False), xr.grad) > 0.05
    assert rel(dx(gelu_grad=False), xr.grad) > 0.05
    assert rel(dx(k2=torch.ones_like(keep2)), xr.grad) > 0.05
    # window 0 holds no wrapped rows, so its slot of the period is the bias alone
    assert not shifted_window_mask(GRID, GRID, WIN, WIN // 2)[0].any()
    assert rel(dx(mbp=pad_mask_bias(mb[:1].expand_as(mb).contiguous())), xr.grad) > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_grad_sums_over_row_splits(model_lib, dtype):
    """The weight, bias and LayerNorm parameter gradients of ``csrc/wgrad.cu``
    (``cuda_lib.weight_grads`` / ``ln_param_grads``) on 100 rows (one row
    split) and on 601 (two, the last one ragged), against torch on the same
    (rounded) inputs: f32 within 1e-5, bf16 within 2e-2 of max(1, max|ref|)."""
    g = torch.Generator().manual_seed(67)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for rows in (100, 601):
        d, a, x = (torch.randn(rows, w, generator=g).to(dtype) for w in (24, 72, 24))
        ln_g = torch.randn(24, generator=g).to(dtype)
        _, mu, rstd = cuda_lib.ln_rows(x, ln_g, torch.zeros_like(ln_g))
        df, af, xf = d.float(), a.float(), x.float()
        xhat = (xf - xf.mean(1, keepdim=True)) * torch.rsqrt(xf.var(1, unbiased=False,
                                                                   keepdim=True) + 1e-5)
        refs = (df.t() @ af, df.sum(0), (df * xhat).sum(0), df.sum(0))
        got = (*cuda_lib.weight_grads(d, a), *cuda_lib.ln_param_grads(x, mu, rstd, ln_g, d))
        for gv, r in zip(got, refs):
            assert gv.dtype == dtype
            assert (gv.float() - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())
