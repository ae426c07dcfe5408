"""Window-based deformable cross-view attention (CVA), counterpart of
``mumpy_tpu/models/deformable.py`` (``SwinDAttention``, ``CVAModule``).

Queries come from view i's windows; a grouped depthwise-conv offset branch
on the queries predicts per-group sample positions; the partner view's windows
are bilinearly sampled there and attended to.  The offset branch is plain
PyTorch; the sampling, k/v projections, attention, ratio fold and output
projection run through the ``cva`` kernel.  Reference quirks kept: queries
tiled ``ratio`` times in ``repeat`` order, the fold over ``ratio``
consecutive rows, the proj_out bias added after the fold, and the tanh bound
of the offsets.  In train mode the whole CVA runs by plain autograd on its
live parameters: the JAX package's CVA kernel is inference-only.  In the
``"attention"`` kernel set (``models/swin.py``) it runs that way in eval mode
too: the JAX package runs the CVA in XLA there, so its plain version is on
the card's path.  Parameter names follow the reference state_dict
(``proj_q``... as 1x1 convs, ``conv_offset.{0,1,3}``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cva import cva, cva_operands, cva_plain
from .swin import KernelSite, RowShard

__all__ = ["SwinDAttention", "CVAModule"]


def reference_points(h: int, w: int) -> np.ndarray:
    """Normalised (y, x) cell-centre grid in [-1, 1], shape (h, w, 2)."""
    ys = (np.linspace(0.5, h - 0.5, h) / h) * 2 - 1
    xs = (np.linspace(0.5, w - 0.5, w) / w) * 2 - 1
    return np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1).astype(np.float32)


class LayerNormProxy(nn.Module):
    """LayerNorm over the channels of an NCHW tensor."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SwinDAttention(KernelSite):
    """Deformable cross-attention between query windows (B1, N, C) and
    ``ratio`` times as many partner windows (ratio*B1, N, C)."""

    def __init__(self, dim: int, num_heads: int, n_groups: int = 3, window: int = 7,
                 offset_range_factor: float = 2.0):
        super().__init__()
        self.dim, self.num_heads, self.n_groups, self.window = dim, num_heads, n_groups, window
        self.offset_range_factor = offset_range_factor
        gc = dim // n_groups
        self.proj_q = nn.Conv2d(dim, dim, 1)
        self.proj_k = nn.Conv2d(dim, dim, 1)
        self.proj_v = nn.Conv2d(dim, dim, 1)
        self.proj_out = nn.Conv2d(dim, dim, 1)
        self.conv_offset = nn.Sequential(
            nn.Conv2d(gc, gc, 5, padding=2, groups=gc),
            LayerNormProxy(gc),
            nn.GELU(),
            nn.Conv2d(gc, 2, 1, bias=False),
        )

    def build_ops(self, live=False):
        return cva_operands(self.proj_q.weight, self.proj_q.bias, self.proj_k.weight,
                            self.proj_k.bias, self.proj_v.weight, self.proj_v.bias,
                            self.proj_out.weight, self.num_heads, self.n_groups,
                            self.window, live=live)

    def sample_positions(self, x1):
        """Offset branch on the untiled queries: (B1, N, C) -> per-group
        normalised (y, x) sample positions (B1*g, ws, ws, 2)."""
        ws, g = self.window, self.n_groups
        r, _, c = x1.shape
        gc = c // g
        q = F.linear(x1, self.proj_q.weight.reshape(c, c), self.proj_q.bias)
        q = q.reshape(r, ws, ws, g, gc).permute(0, 3, 4, 1, 2).reshape(r * g, gc, ws, ws)
        off = self.conv_offset(q).permute(0, 2, 3, 1)  # (r*g, ws, ws, 2)
        if self.offset_range_factor > 0:
            off = torch.tanh(off) * (self.offset_range_factor / ws)
        ref = torch.from_numpy(reference_points(ws, ws)).to(off)
        return off + ref

    def forward(self, x1, x2, shard: RowShard = None):
        """``shard``: this is one part of a split batch.  Partner window j of
        the whole batch pairs with query window j % B1 of the whole batch
        (the reference's ``repeat`` tiling), so with ratio > 1 a part's
        partner windows need other parts' queries.  The part gathers every
        part's queries and hands the call W of them, W = min(B1 of the batch,
        its partner windows), starting at its first partner window's query,
        so that partner window j of the part meets query j % W there as it
        met its query in the whole batch; its partner windows are padded
        with zeros to ratio * W.  The call then folds the same ratio rows in
        the same order as the whole batch's call: the part's outputs are the
        first ones, computed as the one-device call computes them."""
        b1, n, c = x1.shape
        ws, g = self.window, self.n_groups
        ratio = x2.shape[0] // b1
        part = shard is not None and shard.world > 1 and ratio > 1
        if part:
            everyone = shard.gather(x1)
            r = x2.shape[0]
            width = min(everyone.shape[0], r)
            first = shard.rank * r  # the part's first partner window in the batch
            x1 = everyone[(first + torch.arange(width, device=x1.device)) % everyone.shape[0]]
            x2 = torch.cat([x2, x2.new_zeros((ratio * width - r, n, c))])
            b1, mine = width, b1
        pos = self.sample_positions(x1).reshape(b1, g, n, 2).permute(1, 0, 2, 3).float()
        gy = ((pos[..., 0] + 1.0) * 0.5 * (ws - 1)).contiguous()  # absolute pixels
        gx = ((pos[..., 1] + 1.0) * 0.5 * (ws - 1)).contiguous()
        if self.training or self.kernel_set == "attention":
            out = cva_plain(x1, x2, gy, gx, self.build_ops(live=True))
        else:
            fn = cva if self.use_kernels else cva_plain
            out = fn(x1, x2, gy, gx, self.kernel_ops())
        if part:
            out = out[:mine]
        return out + self.proj_out.bias  # the bias follows the ratio fold


class CVAModule(nn.Module):
    """CVA residual wrapper: ``x1 + crossattn(x1, x2)``; in training
    ``x1 + keep * crossattn(x1, x2)`` with ``keep`` (B1,) one stochastic-depth
    factor per query window (the JAX package's drop-path inside CVAModule)."""

    def __init__(self, dim: int, num_heads: int, window: int = 7):
        super().__init__()
        self.crossattn = SwinDAttention(dim, num_heads, n_groups=3, window=window)

    def forward(self, x1, x2, keep=None, shard: RowShard = None):
        y = self.crossattn(x1, x2, shard)
        if keep is None:
            return x1 + y
        return x1 + keep.to(y.dtype)[:, None, None] * y
