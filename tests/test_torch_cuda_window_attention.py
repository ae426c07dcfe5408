"""The window-attention kernel (#7) on the card, forward and backward,
against the autograd of its plain PyTorch version.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  f32 (TF32 off): the output, d(qkv) and
d(mask+bias) within 1e-4 * max(1, max|ref|); bf16: against the f32 plain
version on the same bf16-valued inputs within 2e-2 * max(1, max|ref|).  The
cases are ``torch_cases``' (C 24, 3 heads, 16 tokens; mask+bias of period 1
and nW) and the flagship's stage-0 window (49 tokens, 3 heads of 32: the
bf16 tensor-core forward), with and without the shift mask.
"""

import pytest
import torch

from mumpy_tpu_torch.ops import window_attention as wa
from torch_cases import Draw, cuda, mask_bias, t, to_dev  # noqa: F401


def _case(seed, shifted, c, heads, win, grid):
    d = Draw(seed)
    nw = (grid // win) ** 2
    qkv = t(d(2 * nw, win * win, 3 * c, std=1.0))
    mb = torch.from_numpy(mask_bias(d, shifted, heads, win, grid))
    return qkv, mb, t(d(2 * nw, win * win, c, std=1.0))


def _run(fn, qkv, mb, do, heads, dtype):
    q = qkv.detach().to(dtype).clone().requires_grad_()
    m = mb.detach().to(dtype).clone().requires_grad_()
    out = fn(q, m, heads)
    out.backward(do.to(dtype))
    return out.detach().float(), q.grad.float(), m.grad.float()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["small", "small_shifted", "flagship", "flagship_shifted"])
def test_window_attention_on_card(cuda, case):
    if case.startswith("flagship"):  # stage 0: window 7, C 96, 3 heads of 32
        c, heads, win, grid = 96, 3, 7, 14
    else:
        c, heads, win, grid = 24, 3, 4, 8
    qkv, mb, do = to_dev(_case(91, case.endswith("shifted"), c, heads, win, grid), cuda)
    for dtype in (torch.float32, torch.bfloat16):
        before = (wa.window_attention.launches, wa.window_attention.backward_launches)
        got = _run(wa.window_attention, qkv, mb, do, heads, dtype)
        torch.cuda.synchronize()
        assert (wa.window_attention.launches,
                wa.window_attention.backward_launches) == (before[0] + 1, before[1] + 1)
        ref = _run(wa.window_attention_plain, qkv.to(dtype).float(), mb.to(dtype).float(),
                   do.to(dtype).float(), heads, torch.float32)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for name, g, r in zip(("out", "dqkv", "dmb"), got, ref):
            err = (g - r).abs().max().item()
            assert err <= tol * max(1.0, r.abs().max().item()), (name, dtype, err)
