"""The training kernels on the card, forward and backward, each against the
autograd of its plain PyTorch version: ``attn_ln_train``, ``ln_mlp_train``
and ``swin_block_train``, and the weight-gradient sums all three run.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  f32 (TF32 off): outputs and every gradient
within 1e-4 * max(1, max|ref|); bf16: against the f32 plain version on the
same bf16-valued inputs within 2e-2 * max(1, max|ref|).  The cases are
``torch_cases``' (C 24, 3 heads, 16 tokens) and one at the flagship's
window and head width (49 tokens, hd 32).
"""

import pytest
import torch

from mumpy_tpu_torch.ops import attn_ln_train, ln_mlp_train, swin_block_train
from torch_cases import (attn_train_case, block_train_case, cuda,  # noqa: F401
                         mlp_train_case, rounded, run_with_grads, to_dev)


def _check(kernel, plain, args, cots, dtype, dev):
    args, cots = to_dev(tuple(args), dev), to_dev(tuple(cots), dev)
    before = (kernel.launches, kernel.backward_launches)
    outs, grads = run_with_grads(kernel, args, cots, dtype)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.backward_launches) == (before[0] + 1, before[1] + 1)
    routs, rgrads = run_with_grads(plain, [rounded(a, dtype) for a in args], cots)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert set(grads) == set(rgrads)
    for name, g, r in [("out", o, ro) for o, ro in zip(outs, routs)] + \
            [(k, grads[k], rgrads[k]) for k in rgrads]:
        err = (g - r).abs().max().item()
        assert err <= tol * max(1.0, r.abs().max().item()), (name, err)


DTYPES = (torch.float32, torch.bfloat16)  # looped inside a test: 7 items at most per file


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "shifted", "flagship"])
def test_attn_ln_train_on_card(cuda, case):
    if case == "flagship":  # stage 0: window 7, C 96, 3 heads of 32
        args = attn_train_case(71, False, c=96, heads=3, win=7, grid=14)
    else:
        args = attn_train_case(72, case == "shifted")
    *inputs, cots = args
    for dtype in DTYPES:
        _check(attn_ln_train.attn_ln_train, attn_ln_train.attn_ln_train_plain, inputs, cots,
               dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(45, 24), (588, 96)])
def test_ln_mlp_train_on_card(cuda, rows, c):
    *inputs, cots = mlp_train_case(73, rows, c=c, m=4 * c)
    for dtype in DTYPES:
        _check(ln_mlp_train.ln_mlp_train, ln_mlp_train.ln_mlp_train_plain, inputs, cots,
               dtype, cuda)


@pytest.mark.cuda
def test_swin_block_train_on_card(cuda):
    """Unshifted and shifted small cases, and one at the flagship's stage-0
    width and window (C 96, 3 heads of 32, 49 tokens, shifted: period 4)."""
    for args in (block_train_case(74, False), block_train_case(75, True),
                 block_train_case(76, True, c=96, heads=3, win=7, grid=14)):
        *inputs, cots = args
        for dtype in DTYPES:
            _check(swin_block_train.swin_block_train, swin_block_train.swin_block_train_plain,
                   inputs, cots, dtype, cuda)


@pytest.mark.cuda
def test_weight_grads_on_card(cuda):
    """``csrc/wgrad.cu`` at the flagship's stage-0 widths (C 96, qkv 288, MLP
    384) on 300 rows (one row split) and 1000 (three, the last ragged),
    against torch in f64 on the same values: f32 within 1e-5, bf16 within
    2e-2 of max(1, max|ref|)."""
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(77)
    for rows, o, i in ((300, 288, 96), (1000, 288, 96), (1000, 96, 384)):
        d, a = torch.randn(rows, o, generator=g), torch.randn(rows, i, generator=g)
        ln_g = torch.randn(o, generator=g)
        for dtype in DTYPES:
            dd, ad, gd = (t.to(cuda, dtype) for t in (d, a, ln_g))
            _, mu, rstd = cuda_lib.ln_rows(dd, gd, torch.zeros_like(gd))
            df, af = dd.double(), ad.double()
            xhat = (df - mu.double()[:, None]) * rstd.double()[:, None]
            refs = (df.t() @ af, df.sum(0), (df * xhat).sum(0), df.sum(0))
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            got = cuda_lib.grad_sums((dd, ad), (dd, mu, rstd, gd, dd))
            torch.cuda.synchronize()
            for gv, r in zip(got, refs):
                err = (gv.double() - r).abs().max().item()
                assert err <= tol * max(1.0, r.abs().max().item()), (rows, o, i, dtype, err)
