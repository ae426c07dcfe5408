"""The training kernels' weight, bias and LayerNorm-parameter gradients
(``cuda_lib.grad_sums``) on the CPU against a model of the C ABI
(``torch_cases.ModelLib``), and the block kernel's bf16 planted fault in its
GEMM.

``grad_sums`` takes the terms of one backward half: each (output gradient,
input) pair launches the TN GEMM (bf16: ``csrc/gemm_sm90.cu``; f32:
``csrc/wgrad.cu``) and each LayerNorm term ``col_sums``, all writing their
row splits' f32 partials into one shared workspace, which one launch of
``reduce_splits`` adds term by term in split order.  Here that runs on the
model on one split and on several (ragged) for every term together, against
torch on the same (rounded) inputs: f32 within 1e-5, bf16 within 2e-2 of
max(1, max|ref|).
"""

import pytest
import torch

from mumpy_tpu_torch.ops import cuda_lib
from mumpy_tpu_torch.ops import swin_block_train as sbt
from torch_cases import ModelLib, block_train_case, model_lib  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


def _terms(rows, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    d1, a1, d2, a2, x, dh = (torch.randn(rows, w, generator=g).to(dtype)
                             for w in (72, 24, 24, 96, 24, 24))
    ln_g = torch.randn(24, generator=g).to(dtype)
    _, mu, rstd = cuda_lib.ln_rows(x, ln_g, torch.zeros_like(ln_g))
    return (x, mu, rstd, ln_g, dh), (d1, a1), (d2, a2)


def _refs(ln, *linears):
    x, mu, rstd, _, dh = (t.float() for t in ln)
    xhat = (x - mu[:, None]) * rstd[:, None]
    out = [(dh * xhat).sum(0), dh.sum(0)]
    for d, a in linears:
        out += [d.float().t() @ a.float(), d.float().sum(0)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [100, 1601])
def test_grad_sums_of_a_backward_half(model_lib, monkeypatch, dtype, rows):
    """A LayerNorm term and two Linear terms in one call: on 100 rows every
    term is one split (no workspace, no reduce launch); on 1601 each splits,
    the last split ragged, and one reduce launch adds all three."""
    reduces = []
    fn = ModelLib.mumpy_reduce_splits
    monkeypatch.setattr(ModelLib, "mumpy_reduce_splits",
                        lambda self, *a: reduces.append(a[1]) or fn(self, *a))
    ln, lin1, lin2 = _terms(rows, dtype, 91)
    got = cuda_lib.grad_sums(ln, lin1, lin2)
    assert reduces == ([] if rows == 100 else [3])  # terms per reduce launch
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for gv, r in zip(got, _refs(ln, lin1, lin2)):
        assert gv.dtype == dtype and gv.shape == r.shape
        assert (gv.float() - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())


def test_grad_sums_refuses(model_lib):
    ln, lin1, _ = _terms(40, torch.float32, 92)
    with pytest.raises(ValueError, match="1 to 8 terms"):
        cuda_lib.grad_sums()
    with pytest.raises(ValueError, match="multiples of 8"):
        d, a = (t.to(torch.bfloat16) for t in lin1)
        cuda_lib.grad_sums((d[:, :20].contiguous(), a))
    with pytest.raises(ValueError, match="1 to 8 terms"):
        cuda_lib.grad_sums(*[ln] * 9)


def test_block_gemm_row_scale_fault_bf16(model_lib):
    """chip_smoke.py's new planted fault: the block's bf16 GEMM ignoring its
    row scale (keep1, in the backward's recompute of x2) moves dx and the
    weight gradients far from the kernel's own; the f32 path refuses it."""
    x, mb, p, keep1, keep2, (dy,) = block_train_case(94, shifted=True)
    x16, mb16, dy16 = (t.to(torch.bfloat16) for t in (x, mb, dy))
    p16 = {k: (v.to(torch.bfloat16) if torch.is_tensor(v) else v) for k, v in p.items()}
    w = [p16[k] for k in sbt._WEIGHTS]
    transposed = [p16[k].t() for k in ("w_qkv", "w_proj", "w1")]

    def grads(**fault):
        return sbt.launch_swin_block_train_bwd(x16, mb16, keep1, keep2, *w, *transposed,
                                               p16["heads"], dy16, **fault)

    good, bad = grads(), grads(row_scale=False)
    for i in (0, 12):  # dx and d(w1): the MLP half runs on the wrong x2
        rel = ((bad[i].float() - good[i].float()).norm() / good[i].float().norm()).item()
        assert rel > 0.05, i
    with pytest.raises(ValueError, match="bf16 path only"):
        sbt.launch_swin_block_train_bwd(x, mb, keep1, keep2, *(p[k] for k in sbt._WEIGHTS),
                                        *(p[k].t().contiguous() for k in ("w_qkv", "w_proj",
                                                                          "w1")),
                                        p["heads"], dy, row_scale=False)
