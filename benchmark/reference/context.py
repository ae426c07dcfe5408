"""What a reference forward runs with: training or eval, the generator its
drop-path keeps come from, the rounding of its matrix products' operands,
and whether its training blocks are recomputed in the backward."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


class Ctx:
    """``train``: draw drop-path keeps (from ``generator``; without one the
    keeps are all ones, which is how the operations are counted on the meta
    device).  ``rnd``: a function applied to both operands of every matrix
    product (None: float32 as it is).  ``checkpoint``: recompute each block
    in the backward, so that a training step at the timed batch fits."""

    def __init__(self, train: bool = False, generator=None, rnd=None, checkpoint: bool = False):
        self.train, self.generator, self.rnd, self.checkpoint = train, generator, rnd, checkpoint

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.rnd is None else self.rnd(t)

    def keep(self, n: int, rate: float, device) -> torch.Tensor:
        """(n,) stochastic-depth factors: 0 with probability ``rate``, else
        1 / (1 - rate); all ones (and no draw) at rate 0 or in eval."""
        if not self.train or rate == 0.0 or self.generator is None:
            return torch.ones(n, device=device)
        keep = 1.0 - rate
        u = torch.rand(n, generator=self.generator, device=self.generator.device)
        return ((u < keep).float() / keep).to(device)

    # the matrix products, each operand through ``rnd``
    def linear(self, x, w, b=None):
        return F.linear(self.r(x), self.r(w), b)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *[self.r(o) for o in ops])

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.r(x), self.r(w), b, **kw)

    def run(self, fn, *args):
        """``fn(*args)``, recomputed in the backward when ``checkpoint``."""
        if self.checkpoint and self.train and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                     preserve_rng_state=False)
        return fn(*args)


@contextlib.contextmanager
def f32_only():
    """Matrix products and convolutions in float32, TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
