"""The six launchers that raise a kernel's dynamic shared-memory limit
(``csrc/attn_sm90.cu``, ``cva_sm90.cu``, ``gemm_sm90.cu``'s two,
``mlp_sm90.cu``, ``vit3_sm90.cu``) on a second card in the same process:
each launch on ``cuda:0``, then on ``cuda:1`` (its current device), then on
``cuda:0`` again, on the same bf16 values, gives the same output, bit for
bit.  The attribute and the SM count are kept per device, so the second
card's first launch sets its own.

Every test here is marked ``cuda`` and skips with fewer than two cards; the
file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).
"""

import pytest
import torch

from chip_smoke import cast_ops
from torch_cases import cva_case, t, to_dev


def _bf16(g, *shape, scale=1.0, mean=0.0):
    return (mean + torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)


def _attn_rows(dev):
    from mumpy_tpu_torch.ops import cuda_lib
    from mumpy_tpu_torch.ops.attn_ln import attn_ln_operands

    g = torch.Generator().manual_seed(1)
    c, heads = 96, 3
    w = [_bf16(g, c, mean=1.0, scale=0.1), _bf16(g, c, scale=0.1),
         _bf16(g, 3 * c, c, scale=c**-0.5), _bf16(g, 3 * c, scale=0.1),
         _bf16(g, c, c, scale=c**-0.5), _bf16(g, c, scale=0.1), torch.randn(1, heads, 49, 49,
                                                                            generator=g)]
    x = _bf16(g, 40, 49, c)
    return cuda_lib.attn_rows(x.to(dev), attn_ln_operands(*to_dev(tuple(w), dev), heads))


def _cva_rows(dev):
    from mumpy_tpu_torch.ops import cuda_lib

    _, (x1, x2, gy, gx), ops = cva_case(3, seed=2, groups=3, c=96, heads=3, win=7, grid=28)
    args = to_dev((t(x1).bfloat16(), t(x2).bfloat16(), t(gy), t(gx),
                   cast_ops(ops, torch.bfloat16)), dev)
    return cuda_lib.cva_rows(*args)


def _gemm_rows(dev):
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(3)
    x, w, b = _bf16(g, 300, 96), _bf16(g, 96, 192, scale=96**-0.5), _bf16(g, 192)
    return cuda_lib.gemm_sm90(x.to(dev), w.to(dev), b.to(dev), gelu=True)


def _gemm_tn(dev):
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(4)
    return cuda_lib.grad_sums((_bf16(g, 1000, 96).to(dev), _bf16(g, 1000, 192).to(dev)))


def _mlp_rows(dev):
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(5)
    c, hidden = 96, 384
    m = {"ln_g": _bf16(g, c, mean=1.0, scale=0.1), "ln_b": _bf16(g, c, scale=0.1),
         "w1": _bf16(g, c, hidden, scale=c**-0.5), "b1": _bf16(g, hidden, scale=0.1),
         "w2": _bf16(g, hidden, c, scale=hidden**-0.5), "b2": _bf16(g, c, scale=0.1)}
    return cuda_lib.mlp_rows(_bf16(g, 300, c, mean=0.5).to(dev), to_dev(m, dev))


def _vit3_qkv_attn(dev):
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(6)
    c = 128
    h, w, b = _bf16(g, 3, 70, c), _bf16(g, 3 * c, c, scale=c**-0.5), _bf16(g, 3 * c, scale=0.1)
    return cuda_lib.vit3_qkv_attn(h.to(dev), w.to(dev), b.to(dev), c // 64)


LAUNCHERS = {"attn_rows": _attn_rows, "cva_rows": _cva_rows, "gemm_rows": _gemm_rows,
             "gemm_tn": _gemm_tn, "mlp_rows": _mlp_rows, "vit3_qkv_attn": _vit3_qkv_attn}


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _flat(out):
    return [o.float().cpu() for o in (out if isinstance(out, (tuple, list)) else (out,))
            if torch.is_tensor(o)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launch_on_the_second_card(two_cards, name):
    outs = []
    for dev in (*two_cards, two_cards[0]):
        with torch.cuda.device(dev):
            outs.append(_flat(LAUNCHERS[name](dev)))
            torch.cuda.synchronize(dev)
    for other in outs[1:]:
        assert len(other) == len(outs[0])
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b), name
