"""The bf16 training products on the wgmma GEMM (``csrc/gemm_sm90.cu``), on
the CPU against a model of its C ABI (``torch_cases.ModelLib``).

``cuda_lib.gemm_sm90`` launches the normal form (A (M, K) @ B (K, N) with the
bias, GELU, GELU-backward and residual / row-scale epilogues) and
``cuda_lib.train_gemm`` routes the training kernels' products: bf16 to it,
a LayerNorm first through ``ln_rows``, f32 to ``csrc/gemm.cu``.  Here those
launches run on the model, so the operands, shapes, epilogue switches, row
divisor and the planted fault (the row scale ignored) are checked against
torch on the same bf16-valued inputs within the chip's 2e-2 * max(1,
max|ref|); the wrapper's refusals are checked as well.  The card holds the
kernel itself (``tests/test_torch_cuda_sm90.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from mumpy_tpu_torch.ops import cuda_lib
from torch_cases import ModelLib, model_lib  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

M, K, N, DIV = 45, 24, 72, 7  # a ragged M and a keep divisor that does not divide it


def _operands(seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)

    return {"x": rnd(M, K), "w": rnd(K, N, scale=K**-0.5), "bias": rnd(N), "res": rnd(M, N),
            "aux": rnd(M, N), "scale": torch.rand(-(-M // DIV), generator=g) + 0.5}


def _close(got, ref):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("epilogue", ["bias_gelu", "gelu_grad", "residual", "row_scale"])
def test_gemm_sm90_epilogues(model_lib, epilogue):
    o = _operands(1)
    v = o["x"].float() @ o["w"].float()
    if epilogue == "bias_gelu":
        y, out = cuda_lib.gemm_sm90(o["x"], o["w"], o["bias"], gelu=True)
        _close(y, F.gelu(v + o["bias"].float()))
    elif epilogue == "gelu_grad":
        g = torch.empty_like(o["aux"])
        y, out = cuda_lib.gemm_sm90(o["x"], o["w"], gelu_grad_of=o["aux"], gelu_out=g)
        f1 = o["aux"].float()
        grad = 0.5 * (1 + torch.erf(f1 * 0.5**0.5)) + f1 * torch.exp(-0.5 * f1 * f1) / (
            2 * torch.pi) ** 0.5
        _close(y, v * grad)
        _close(g, F.gelu(f1))
    elif epilogue == "residual":  # y and out = res + T(y)
        y, out = cuda_lib.gemm_sm90(o["x"], o["w"], o["bias"], res=o["res"], want_out=True)
        _close(y, v + o["bias"].float())
        _close(out, o["res"].float() + (v + o["bias"].float()).to(torch.bfloat16).float())
    else:  # the stochastic-depth keep: out = res + s[m // DIV] * y
        y, out = cuda_lib.gemm_sm90(o["x"], o["w"], o["bias"], res=o["res"], want_y=False,
                                    want_out=True, row_scale=o["scale"], scale_div=DIV)
        assert y is None
        s = o["scale"].repeat_interleave(DIV)[:M, None]
        _close(out, o["res"].float() + s * (v + o["bias"].float()))
    assert (out is not None) == (epilogue in ("residual", "row_scale"))


def test_gemm_sm90_row_scale_fault(model_lib):
    """``row_scale_on=False``, the planted fault of the checks, drops the row
    scale from the residual epilogue: out = res + y."""
    o = _operands(2)
    kw = {"res": o["res"], "want_y": False, "want_out": True, "row_scale": o["scale"] * 0,
          "scale_div": DIV}
    _, good = cuda_lib.gemm_sm90(o["x"], o["w"], o["bias"], **kw)
    _, bad = cuda_lib.gemm_sm90(o["x"], o["w"], o["bias"], row_scale_on=False, **kw)
    assert torch.equal(good, o["res"])
    _close(bad, o["res"].float() + o["x"].float() @ o["w"].float() + o["bias"].float())


def test_gemm_sm90_refuses(model_lib):
    o = _operands(3)
    with pytest.raises(TypeError):  # bf16 only
        cuda_lib.gemm_sm90(o["x"].float(), o["w"])
    with pytest.raises(ValueError, match="multiples of 8"):
        cuda_lib.gemm_sm90(o["x"][:, :20].contiguous(), o["w"][:20].contiguous())
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(M * K + 1, dtype=torch.bfloat16)
        cuda_lib.gemm_sm90(flat[1:].view(M, K), o["w"])
    with pytest.raises(ValueError, match="gelu_out needs"):
        cuda_lib.gemm_sm90(o["x"], o["w"], gelu_out=torch.empty_like(o["res"]))


def test_train_gemm_routes_by_dtype(model_lib, monkeypatch):
    """bf16 runs ln_rows then the wgmma GEMM; f32 the gemm.cu loop with its
    LayerNorm prologue; both give LN(x) W + b."""
    calls = []
    for name in ("mumpy_gemm", "mumpy_gemm_sm90", "mumpy_ln_rows"):
        fn = getattr(ModelLib, name)
        monkeypatch.setattr(ModelLib, name,
                            lambda self, *a, fn=fn, name=name: calls.append(name) or fn(self, *a))
    o = _operands(4)
    ln = (torch.rand(K) + 0.5, torch.randn(K))
    for dtype, route in ((torch.bfloat16, ["mumpy_ln_rows", "mumpy_gemm_sm90"]),
                         (torch.float32, ["mumpy_gemm"])):
        calls.clear()
        x, w, b = (t.to(dtype) for t in (o["x"], o["w"], o["bias"]))
        y, _ = cuda_lib.train_gemm(x, w, b, ln=tuple(t.to(dtype) for t in ln))
        assert calls == route and y.dtype == dtype
        h = F.layer_norm(x.float(), (K,), *(t.to(dtype).float() for t in ln), 1e-5)
        _close(y, h.to(dtype).float() @ w.float() + b.float())
    with pytest.raises(ValueError, match="bf16 path only"):
        cuda_lib.train_gemm(o["x"].float(), o["w"].float(), row_scale_on=False)
