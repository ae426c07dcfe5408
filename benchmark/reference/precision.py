"""The control's precision: the step below the bf16 the cells serve and train
in.  ``fp8`` rounds a tensor to float8 e4m3 with one scale for the tensor (its
largest magnitude to e4m3's largest value), as an fp8 matrix product reads
its operands, and in the backward rounds the gradient to e5m2 the same way."""

from __future__ import annotations

import torch

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)
