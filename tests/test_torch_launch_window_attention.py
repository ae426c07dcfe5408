"""The window-attention kernel's (#7) launches on the CPU, forward and
backward, against a model of the C ABI (``torch_cases.ModelLib``, as in
``tests/test_torch_launch.py``) and the plain version's autograd.

``launch_window_attention`` is the CUDA path of the wrapper: its
``torch.autograd.Function`` pads the mask+bias to (P, H, N, 64) f32 with its
key-pad columns at -1e30, launches the attention core on the packed qkv rows
(row stride 3C, k at column C, v at 2C, ``q_mod`` = R) and in the backward the
attention backward, whose d(mask+bias) leaves cut back to (P, H, N, N) in the
mask+bias's dtype.  Here those launches run on the model, so the padding,
``q_mod``, the row strides and column offsets, the mask period and d(mb)'s
shape and dtype are checked against autograd of ``window_attention_plain``:
f32 within 1e-5 * max(1, max|ref|); bf16 against the f32 plain version on the
same bf16-valued inputs within the chip's 2e-2 * max(1, max|ref|).
"""

import pytest
import torch

from mumpy_tpu_torch.ops import window_attention as wa
from torch_cases import C, HEADS, Draw, mask_bias, model_lib, t, windows  # noqa: F401
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


def _case(seed, shifted):
    """Packed qkv (8 windows, 16 tokens, 3C), a mask+bias of period 1 or nW
    and an output cotangent."""
    d = Draw(seed)
    qkv = t(windows(d, c=3 * C))
    return qkv, torch.from_numpy(mask_bias(d, shifted)), t(d(*qkv.shape[:2], C, std=1.0))


def _run(fn, qkv, mb, do, dtype, mb_dtype=None):
    """fn(qkv, mb) on leaves cast to ``dtype`` (mb to ``mb_dtype``); returns
    (out, d(qkv), d(mb)) in f32 and d(mb)'s dtype."""
    q = qkv.detach().to(dtype).clone().requires_grad_()
    m = mb.detach().to(mb_dtype or dtype).clone().requires_grad_()
    out = fn(q, m, HEADS)
    out.backward(do.to(dtype))
    return out.detach().float(), q.grad.float(), m.grad.float(), m.grad.dtype


def _close(got, ref, dtype):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got - ref).abs().max().item() <= tol * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_launches_match_plain(model_lib, dtype, shifted):
    qkv, mb, do = _case(81, shifted)
    before = wa.window_attention.backward_launches
    *got, gdt = _run(wa.launch_window_attention, qkv, mb, do, dtype)
    assert wa.window_attention.backward_launches == before + 1
    assert gdt == dtype  # d(mb) in the mask+bias's dtype
    # the reference: the f32 plain version on the same dtype-valued inputs
    ref = _run(wa.window_attention_plain, qkv.to(dtype).float(), mb.to(dtype).float(),
               do.to(dtype).float(), torch.float32)[:3]
    assert got[2].shape == mb.shape
    for g, r in zip(got, ref):
        _close(g, r, dtype)


def test_planted_faults_and_inference_mode(model_lib):
    """The mask+bias zeroed in the forward and the rowsum term dropped in the
    backward (``chip_smoke.py``'s planted faults) each land far from the
    plain version; the forward also launches under ``torch.inference_mode``
    (the serving path), with no graph."""
    qkv, mb, do = _case(82, shifted=True)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out, dqkv, dmb, _ = _run(wa.window_attention_plain, qkv, mb, do, torch.float32)
    with torch.inference_mode():
        served = wa.launch_window_attention(qkv, mb, HEADS)
        assert rel(wa.launch_window_attention(qkv, torch.zeros_like(mb), HEADS), out) > 0.1
    _close(served, out, torch.float32)
    bad, bad_dmb = wa.launch_window_attention_bwd(qkv, mb, do, HEADS,
                                                  rowsum=False)
    good, good_dmb = wa.launch_window_attention_bwd(qkv, mb, do, HEADS)
    _close(good, dqkv, torch.float32)
    _close(good_dmb, dmb, torch.float32)
    assert rel(bad, dqkv) > 0.1 and rel(bad_dmb, dmb) > 0.1


def test_wrapper_checks_its_arguments(model_lib):
    qkv = torch.zeros(4, 16, 24)
    with pytest.raises(ValueError, match="packed qkv"):
        wa.window_attention(qkv, torch.zeros(1, 5, 16, 16), 5)
    with pytest.raises(ValueError, match="mask"):
        wa.window_attention(qkv, torch.zeros(1, 2, 16, 15), 2)
    with pytest.raises(ValueError, match="period"):
        wa.window_attention(qkv, torch.zeros(3, 2, 16, 16), 2)
    with pytest.raises(ValueError, match="n <= 64"):  # the core's limits
        wa.launch_window_attention(torch.zeros(1, 65, 24), torch.zeros(1, 2, 65, 65), 2)
    with pytest.raises(ValueError, match="hd <= 32"):
        wa.launch_window_attention(torch.zeros(1, 4, 198), torch.zeros(1, 1, 4, 4), 1)
    with pytest.raises(TypeError):
        wa.launch_window_attention(qkv.double(), torch.zeros(1, 2, 16, 16), 2)


def test_strided_mask_bias(model_lib):
    """The core reads the (P, H, N, N) mask+bias through its strides: the
    model's relative-position bias is a permuted view and the shift-mask
    fault an expanded one; either gives what the same values give
    contiguous, output and gradients alike."""
    qkv, mb, do = _case(83, shifted=True)
    views = {"permuted": lambda m: m.permute(0, 1, 3, 2),
             "expanded": lambda m: m[:1].expand(mb.shape[0], -1, -1, -1)}
    for name, view in views.items():
        outs = []
        for contiguous in (False, True):
            q = qkv.clone().requires_grad_()
            m = mb.clone().requires_grad_()
            v = view(m)
            assert v.is_contiguous() == (name == "expanded" and mb.shape[0] == 1)
            out = wa.launch_window_attention(q, v.contiguous() if contiguous else v, HEADS)
            out.backward(do)
            outs.append((out.detach(), q.grad, m.grad))
        for g, r in zip(*outs):
            assert torch.equal(g, r), name
