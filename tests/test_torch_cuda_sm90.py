"""The Hopper kernels of the training path on the card: the wgmma GEMM
(``csrc/gemm_sm90.cu``) on every distinct product of the flagship's 48
``swin_block_train`` blocks, with the epilogue each product runs, and the
tensor-core window-attention cores (``csrc/window_attention.cu``,
``csrc/window_attention_bwd.cu``) on the flagship's windows.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  The GEMM is held against an f32 torch product
of the same bf16 inputs (TF32 off), the attention cores against their plain
version's autograd in f32 on the same bf16-valued inputs, each within the
bf16 bound of the port's checks, 2e-2 * max(1, max|ref|).
"""

import pytest
import torch
import torch.nn.functional as F

from mumpy_tpu_torch.configs import multiswin_config
from torch_cases import Draw, cuda, mask_bias  # noqa: F401

CLIPS = 12  # a training step: 6 clips x 2 inpainting streams


def _block_rows():
    """(rows, C) of every distinct swin_block_train call of a 12-clip step:
    each view's four stages, its temporal depth times the stage's tokens."""
    cfg = multiswin_config()
    return sorted({(CLIPS * v.temporal_dim * h * w, c) for v in cfg.views
                   for (h, w), c in zip(v.input_resolution, v.hidden_size)})


def _close(got, ref, what):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (what, err)


def _bf16(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("half", ["views12", "view3"])
def test_gemm_sm90_on_block_products(cuda, half):
    """The block's forward products (qkv + bias, proj + bias + keep row
    scale, fc1 + bias + GELU, fc2 + bias + keep row scale), the recompute's
    fc1 (bias) and the input-gradient products (do, dh1, df1 with the GELU
    backward and gelu(f1) out, dh) at each (rows, C) of the step."""
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator(device="cuda").manual_seed(81)
    shapes = [s for s in _block_rows() if (s[1] % 96 == 0) == (half == "views12")]
    assert len(shapes) == 4
    for rows, c in shapes:
        for k, n, epi in ((c, 3 * c, "bias"), (c, c, "keep"), (c, 4 * c, "gelu"),
                          (4 * c, c, "keep"), (c, c, "none"), (3 * c, c, "none"),
                          (c, 4 * c, "gelu_grad"), (4 * c, c, "none")):
            x, w, b = _bf16(g, rows, k), _bf16(g, k, n, scale=k**-0.5), _bf16(g, n)
            v = x.float() @ w.float()
            what = (rows, k, n, epi)
            if epi == "bias":
                _close(cuda_lib.gemm_sm90(x, w, b)[0], v + b.float(), what)
            elif epi == "none":
                _close(cuda_lib.gemm_sm90(x, w)[0], v, what)
            elif epi == "gelu":
                _close(cuda_lib.gemm_sm90(x, w, b, gelu=True)[0], F.gelu(v + b.float()), what)
            elif epi == "keep":  # one keep factor per 49-token window
                res = _bf16(g, rows, n)
                keep = torch.rand(rows // 49, generator=g, device="cuda") * 1.25
                _, out = cuda_lib.gemm_sm90(x, w, b, res=res, want_y=False, want_out=True,
                                            row_scale=keep, scale_div=49)
                _close(out, res.float() + keep.repeat_interleave(49)[:, None] * (v + b.float()),
                       what)
            else:
                f1 = _bf16(g, rows, n)
                gl = torch.empty_like(f1)
                y, _ = cuda_lib.gemm_sm90(x, w, gelu_grad_of=f1, gelu_out=gl)
                f = f1.float()
                grad = 0.5 * (1 + torch.erf(f * 0.5**0.5)) + f * torch.exp(-0.5 * f * f) / (
                    2 * torch.pi) ** 0.5
                _close(y, v * grad, what)
                _close(gl, F.gelu(f), what + ("gelu(f1)",))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gemm_sm90_weight_gradients(cuda):
    """The TN form through ``cuda_lib.grad_sums`` (row splits summed in
    split order by one reduce launch) on the block's four weight gradients
    at each (rows, C), as its backward's two halves take them."""
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator(device="cuda").manual_seed(82)
    for rows, c in _block_rows():
        for half in (((3 * c, c), (c, c)), ((4 * c, c), (c, 4 * c))):
            terms = [(_bf16(g, rows, o), _bf16(g, rows, i)) for o, i in half]
            got = cuda_lib.grad_sums(*terms)
            for (d, a), dw, db in zip(terms, got[::2], got[1::2]):
                what = (rows, d.shape[1], a.shape[1])
                _close(dw, d.float().t() @ a.float(), what + ("dW",))
                _close(db, d.float().sum(0), what + ("db",))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mb_dtype", [torch.float32, torch.bfloat16])
def test_attention_cores_on_flagship_windows(cuda, mb_dtype):
    """The bf16 tensor-core forward and backward (hd 32, 49 tokens) at each
    stage's heads, with the bias alone (P = 1) and with the shift mask
    (P = nW), the mask+bias in f32 or bf16: the output, d(qkv) and d(mb)."""
    from mumpy_tpu_torch.ops import window_attention as wa

    for c, heads, grid, shifted in ((96, 3, 14, True), (192, 6, 14, False),
                                    (384, 12, 14, True), (1024, 32, 7, False)):
        d = Draw(83 + c)
        nw = (grid // 7) ** 2
        qkv = torch.from_numpy(d(3 * nw, 49, 3 * c, std=1.0)).to(cuda, torch.bfloat16)
        mb = torch.from_numpy(mask_bias(d, shifted, heads, 7, grid)).to(cuda, mb_dtype)
        do = torch.from_numpy(d(3 * nw, 49, c, std=1.0)).to(cuda, torch.bfloat16)
        q, m = qkv.clone().requires_grad_(), mb.clone().requires_grad_()
        out = wa.window_attention(q, m, heads)
        out.backward(do)
        qr, mr = qkv.float().requires_grad_(), mb.float().requires_grad_()
        ref = wa.window_attention_plain(qr, mr, heads)
        ref.backward(do.float())
        torch.cuda.synchronize()
        assert m.grad.dtype == mb_dtype and m.grad.shape == mb.shape
        for name, got, r in (("out", out, ref), ("dqkv", q.grad, qr.grad),
                             ("dmb", m.grad, mr.grad)):
            _close(got, r.detach(), (c, heads, shifted, name))
