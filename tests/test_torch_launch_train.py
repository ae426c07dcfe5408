"""The training kernels' launch sequences on the CPU, forward and backward,
against a model of the C ABI (``torch_cases.ModelLib``, as in
``tests/test_torch_launch.py``) and the plain versions' autograd.

``launch_attn_ln_train`` / ``launch_ln_mlp_train`` are the CUDA paths of the
two wrappers: their ``torch.autograd.Function``s call the GEMM with the keep
row-scale and GELU-backward epilogues, the window-attention backward and the
LayerNorm / scale-add row kernels.  Here those calls run on the model, so the
strides, offsets, mask period, keep divisor and the torch-side weight-
gradient products are checked against autograd of the plain versions.  f32
within 1e-5 * max(1, max|ref|); bf16 against the f32 plain version on the
same bf16-valued inputs within the chip's 2e-2 * max(1, max|ref|).  Each
planted fault of ``chip_smoke.py`` lands far from the plain gradients.
"""

import pytest
import torch


from mumpy_tpu_torch.ops import attn_ln_train, ln_mlp_train
from torch_cases import (attn_train_case, mlp_train_case, model_lib,  # noqa: F401
                         record_calls, rounded, run_with_grads)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


def _close(got, ref, dtype):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= tol * max(1.0, r.abs().max().item())


def _check(kernel, plain, args, cots, dtype):
    outs, grads = run_with_grads(kernel, args, cots, dtype)
    # the reference: the f32 plain version on the same dtype-valued inputs
    routs, rgrads = run_with_grads(plain, [rounded(a, dtype) for a in args], cots)
    _close(outs, routs, dtype)
    assert set(grads) == set(rgrads)
    for k in rgrads:
        _close([grads[k]], [rgrads[k]], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_attn_ln_train_launches(model_lib, monkeypatch, dtype, shifted):
    """bf16 launches one C call each way; neither dtype's backward runs a
    forward attention core (its o comes from the attention backward)."""
    calls = record_calls(monkeypatch, "mumpy_attn_ln_train_fwd", "mumpy_attn_ln_train_bwd",
                         "mumpy_window_attention", "mumpy_window_attention_bwd")
    x, mb, p, keep, cots = attn_train_case(61, shifted)
    _check(attn_ln_train.launch_attn_ln_train, attn_ln_train.attn_ln_train_plain,
           (x, mb, p, keep), cots, dtype)
    names = [name for name, _ in calls if name.startswith("mumpy_attn")]
    assert names == (["mumpy_attn_ln_train_fwd", "mumpy_attn_ln_train_bwd"]
                     if dtype == torch.bfloat16 else [])
    # (name, whether it writes o): argument 4 of the backward core is o
    cores = [(name, name.endswith("_bwd") and a[4] is not None)
             for name, a in calls if "window_attention" in name]
    # the forward's core, then the backward's, which also gives o
    assert cores[:1] == [("mumpy_window_attention", False)]
    assert cores[1:] == [("mumpy_window_attention_bwd", True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_mlp_train_launches(model_lib, dtype):
    x, p, keep, cots = mlp_train_case(62, rows=45)  # not a multiple of 8
    _check(ln_mlp_train.launch_ln_mlp_train, ln_mlp_train.ln_mlp_train_plain,
           (x, p, keep), cots, dtype)


def test_planted_faults_move_the_gradients(model_lib):
    """The fault switches chip_smoke.py plants in the backward launches (the
    softmax backward's rowsum term dropped, gelu' replaced by 1), and the
    operand faults (mask+bias zeroed, keep ignored), each move dx far from
    the plain version's gradient."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    x, mb, p, keep, (dy, dout) = attn_train_case(63, shifted=False)
    xr = x.clone().requires_grad_()
    _, out = attn_ln_train.attn_ln_train_plain(xr, mb, p, keep)
    y, _ = attn_ln_train.attn_ln_train_plain(xr, mb, p, keep)
    torch.autograd.backward((y, out), (dy, dout))
    args = (p["ln_g"], p["ln_b"], p["w_qkv"], p["b_qkv"], p["w_proj"],
            p["w_qkv"].t().contiguous(), p["heads"], dy, dout)
    bwd = attn_ln_train.launch_attn_ln_train_bwd
    assert rel(bwd(x, mb, keep, *args)[0], xr.grad) < 1e-5
    assert rel(bwd(x, mb, keep, *args, rowsum=False)[0], xr.grad) > 0.05
    assert rel(bwd(x, torch.zeros_like(mb), keep, *args)[0], xr.grad) > 0.05
    assert rel(bwd(x, mb, torch.ones_like(keep), *args)[0], xr.grad) > 0.05

    x, p, keep, (dy,) = mlp_train_case(64, rows=40)
    xr = x.clone().requires_grad_()
    ln_mlp_train.ln_mlp_train_plain(xr, p, keep).backward(dy)
    args = (p["ln_g"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["w1"].t().contiguous(), dy)
    bwd = ln_mlp_train.launch_ln_mlp_train_bwd
    assert rel(bwd(x, keep, *args)[0], xr.grad) < 1e-5
    assert rel(bwd(x, keep, *args, gelu_grad=False)[0], xr.grad) > 0.05
    assert rel(bwd(x, torch.ones_like(keep), *args)[0], xr.grad) > 0.05
