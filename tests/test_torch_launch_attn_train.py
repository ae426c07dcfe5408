"""#9 (``attn_ln_train``) in bf16 as one C call each way
(``csrc/swin_block_train.cu``: ``mumpy_attn_ln_train_fwd`` / ``_bwd``), and
the attention backward's head outputs o (``csrc/window_attention_bwd.cu``)
that let its backward run no forward core, on the CPU against the model of
the C ABI (``torch_cases.ModelLib``): bf16-valued inputs, held to autograd of
``attn_ln_train_plain`` in f32 within the chip's 2e-2 * max(1, max|ref|),
unshifted and with the shift's mask period, on a ragged row count with keep
factors 0, 1 / (1 - 0.2) and 1; the planted faults and the refusals.  The
card holds the kernels themselves (``tests/test_torch_cuda_fused.py``).
"""

import pytest
import torch

from mumpy_tpu_torch.ops import attn_ln_train, cuda_lib
from torch_cases import (attn_train_case, model_lib, record_calls, rounded,  # noqa: F401
                         run_with_grads)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

WIN, GRID, C, HEADS = 7, 14, 96, 3  # 8 windows of 49 tokens: 392 rows; hd 32
BACKWARD = ["mumpy_attn_ln_train_bwd", "mumpy_ln_rows", "mumpy_gemm_sm90",
            "mumpy_scale_add_rows", "mumpy_gemm_sm90", "mumpy_window_attention_bwd",
            "mumpy_gemm_sm90", "mumpy_ln_bwd_rows", "mumpy_col_sums", "mumpy_gemm_sm90_tn",
            "mumpy_gemm_sm90_tn"]
ENTRIES = tuple(dict.fromkeys(["mumpy_attn_ln_train_fwd", "mumpy_window_attention", *BACKWARD]))


def _case(seed, shifted):
    return attn_train_case(seed, shifted, c=C, heads=HEADS, win=WIN, grid=GRID)


@pytest.mark.parametrize("shifted", [False, True])
def test_attn_ln_train_one_call_each_way(model_lib, monkeypatch, shifted):
    """Through the kernel's ``Function``: the forward one call (LN, qkv,
    attention, the projection's two outputs), the backward one call with no
    forward attention core (o from the backward's), y, out and every
    gradient against the plain version's autograd."""
    calls = record_calls(monkeypatch, *ENTRIES)
    x, mb, p, keep, cots = _case(76, shifted)
    args = (x, mb, p, keep)
    outs, grads = run_with_grads(attn_ln_train.launch_attn_ln_train, args, cots, torch.bfloat16)
    names = [name for name, _ in calls]
    assert names == ["mumpy_attn_ln_train_fwd", "mumpy_ln_rows", "mumpy_gemm_sm90",
                     "mumpy_window_attention", "mumpy_gemm_sm90", *BACKWARD]
    o_arg = next(a for name, a in calls if name == "mumpy_window_attention_bwd")[4]
    assert o_arg is not None  # the head outputs come from the backward's core
    routs, rgrads = run_with_grads(attn_ln_train.attn_ln_train_plain,
                                   [rounded(a, torch.bfloat16) for a in args], cots)
    assert set(grads) == set(rgrads) and len(rgrads) == 8  # x, mb and the six weights
    for name, g, r in [("y", outs[0], routs[0]), ("out", outs[1], routs[1])] + [
            (k, grads[k], rgrads[k]) for k in rgrads]:
        err = (g - r).abs().max().item()
        assert err <= 2e-2 * max(1.0, r.abs().max().item()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_core_gives_the_forward_outputs(model_lib, dtype):
    """``window_attention_bwd(..., want_o=True)`` returns the head outputs
    the forward core gives on the same packed qkv and mask+bias, beside dqkv
    and d(mb) unchanged."""
    g = torch.Generator().manual_seed(77)
    r, n = 8, WIN * WIN
    qkv = torch.randn(r * n, 3 * C, generator=g).to(dtype)
    do = torch.randn(r * n, C, generator=g).to(dtype)
    mb = torch.randn(4, HEADS, n, n, generator=g)
    kw = dict(r=r, n=n, heads=HEADS, hd=C // HEADS, scale=(C // HEADS) ** -0.5)
    dqkv, dmb, o = cuda_lib.window_attention_bwd(qkv, do, mb, want_o=True, **kw)
    ref_dqkv, ref_dmb = cuda_lib.window_attention_bwd(qkv, do, mb, **kw)
    assert torch.equal(dqkv, ref_dqkv) and torch.equal(dmb, ref_dmb)
    ref_o = cuda_lib.packed_window_attention(qkv, mb, r=r, n=n, heads=HEADS)
    assert o.shape == (r * n, C) and o.dtype == dtype
    assert (o.float() - ref_o.float()).abs().max().item() <= 1e-5


def test_attn_ln_train_planted_faults(model_lib):
    """On the bf16 call: the rowsum term dropped, the mask+bias zeroed and
    the keep factor ignored each move dx far from the plain gradient."""
    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    x, mb, p, keep, cots = _case(78, True)
    x, mb, p, dy, dout = (rounded(a, torch.bfloat16) for a in (x, mb, p, *cots))
    xr = x.clone().requires_grad_()
    y, out = attn_ln_train.attn_ln_train_plain(xr, mb, p, keep)
    torch.autograd.backward((y, out), (dy, dout))
    b16 = {k: v.bfloat16() if torch.is_tensor(v) else v for k, v in p.items()}

    def dx(m=mb, k=keep, **fault):
        return attn_ln_train.launch_attn_ln_train_bwd(
            x.bfloat16(), m.bfloat16(), k, b16["ln_g"], b16["ln_b"], b16["w_qkv"],
            b16["b_qkv"], b16["w_proj"], None, HEADS, dy.bfloat16(), dout.bfloat16(),
            **fault)[0]

    assert rel(dx(), xr.grad) < 2e-2
    assert rel(dx(rowsum=False), xr.grad) > 0.05
    assert rel(dx(m=torch.zeros_like(mb)), xr.grad) > 0.05
    assert rel(dx(k=torch.ones_like(keep)), xr.grad) > 0.05


def test_attn_ln_train_refusals(model_lib):
    """The bf16 calls refuse what the sequence does not take: a head wider
    than 32, a keep per row instead of per window, f32 operands."""
    x, mb, p, keep, (dy, dout) = _case(79, False)
    w = tuple(p[k].bfloat16() for k in attn_ln_train._WEIGHTS)
    xb, mbb = x.bfloat16(), mb.bfloat16()
    with pytest.raises(ValueError, match="head width"):
        cuda_lib.attn_ln_train_fwd(xb, mbb[:, :1], keep, w, 1)
    with pytest.raises(ValueError, match="shape"):
        cuda_lib.attn_ln_train_fwd(xb, mbb, keep.repeat(2), w, HEADS)
    with pytest.raises(TypeError):
        cuda_lib.attn_ln_train_bwd(x, mb, keep, tuple(p[k] for k in attn_ln_train._WEIGHTS),
                                   HEADS, dy, dout)
