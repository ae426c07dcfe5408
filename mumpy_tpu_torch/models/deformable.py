"""Window-based cross-view attention (CVA), counterpart of
``mumpy_tpu/models/deformable.py`` (``SwinDAttention``,
``CrossWindowAttention``, ``CVAModule``).  ``CVAModule`` runs the kind
``MumpyConfig.cva_kind`` names: the deformable one (the published model) or
the softmax window cross-attention (:class:`CrossWindowAttention`), which
runs plain PyTorch on every path, as the JAX package runs it in XLA.

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
(``proj_q``... as 1x1 convs, ``conv_offset.{0,1,3}``; ``qkv1``, ``qkv2``,
``proj``, ``relative_position_bias_table`` for the window kind).  In
training both kinds drop their attention probabilities at ``attn_drop``;
the deformable kind also its output at ``attn_drop``, the window kind its
output at ``proj_drop`` (0: the JAX package's ``CVAModule`` does not pass
it on).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cva import cva, cva_operands, cva_plain
from .dropout import NO_DROPS, Drops
from .swin import KernelSite, RowShard, rel_pos_bias

__all__ = ["gather_queries", "SwinDAttention", "CrossWindowAttention", "CVAModule"]


def reference_points(h: int, w: int) -> np.ndarray:
    """Normalised (y, x) cell-centre grid in [-1, 1], shape (h, w, 2)."""
    ys = (np.linspace(0.5, h - 0.5, h) / h) * 2 - 1
    xs = (np.linspace(0.5, w - 0.5, w) / w) * 2 - 1
    return np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1).astype(np.float32)


def gather_queries(x1, x2, shard: RowShard):
    """The query and partner windows one part of a split batch computes its
    outputs from.  Partner window j of the whole batch pairs with query
    window j % B1 of the whole batch (the reference's ``repeat`` tiling), so
    with ratio > 1 a part's partner windows need other parts' queries.  The
    part gathers every part's queries and takes W of them, W = min(B1 of the
    batch, its partner windows), starting at its first partner window's
    query, so that partner window j of the part meets query j % W there as
    it met its query in the whole batch; its partner windows are padded with
    zeros to ratio * W.  Folding the same ratio rows in the same order, the
    part's outputs are the first ones, computed as the one-device call
    computes them.  Returns (x1, x2, the part's first partner window's
    index in the batch, the part's own query count); with nothing to
    gather, (x1, x2, None, B1)."""
    b1, n, c = x1.shape
    ratio = x2.shape[0] // b1
    if shard is None or shard.world == 1 or ratio == 1:
        return x1, x2, None, b1
    everyone = shard.gather(x1)
    r = x2.shape[0]
    width = min(everyone.shape[0], r)
    first = shard.rank * r  # the part's first partner window in the batch
    x1 = everyone[(first + torch.arange(width, device=x1.device)) % everyone.shape[0]]
    x2 = torch.cat([x2, x2.new_zeros((ratio * width - r, n, c))])
    return x1, x2, first, b1


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

    def forward(self, x1, x2, shard: RowShard = None, drops: Drops = NO_DROPS,
                attn_drop: float = 0.0):
        """``shard``: this is one part of a split batch, whose queries are
        gathered (:func:`gather_queries`).  ``drops`` sites 0 and 1 drop the
        (ratio*B1, H, N, N) probabilities and the output at ``attn_drop``
        (training, on the plain version)."""
        ws, g, n = self.window, self.n_groups, x1.shape[1]
        x1, x2, first, mine = gather_queries(x1, x2, shard)
        b1 = x1.shape[0]
        pos = self.sample_positions(x1).reshape(b1, g, n, 2).permute(1, 0, 2, 3).float()
        gy = ((pos[..., 0] + 1.0) * 0.5 * (ws - 1)).contiguous()  # absolute pixels
        gx = ((pos[..., 1] + 1.0) * 0.5 * (ws - 1)).contiguous()
        if self.training or self.kernel_set == "attention":
            drop = None
            if drops.seeds is not None and attn_drop > 0:
                drop = lambda a: drops(0, a, attn_drop, self, "probs", row0=first)
            out = cva_plain(x1, x2, gy, gx, self.build_ops(live=True), drop)
        else:
            fn = cva if self.use_kernels else cva_plain
            out = fn(x1, x2, gy, gx, self.kernel_ops())
        # the bias follows the ratio fold
        return drops(1, out[:mine] + self.proj_out.bias, attn_drop, self, "out")


class CrossWindowAttention(nn.Module):
    """Softmax window cross-attention with a relative-position bias, the
    reference's non-deformable CVA (``mumpy_tpu/models/deformable.py:219-271``):
    q from the query windows (``qkv1``), k and v from the partner windows
    (``qkv2``); with ``ratio`` times as many partner windows the queries are
    tiled in ``repeat`` order (partner window j meets query j % B1) and the
    outputs of ``ratio`` consecutive partner windows are summed, then
    projected (``proj``, zero-initialised).  Plain PyTorch on every path (the
    JAX package runs it in XLA; no kernel); a part of a split batch gathers
    its queries as the deformable kind does."""

    def __init__(self, dim: int, num_heads: int, window: int = 7):
        super().__init__()
        self.num_heads, self.window = num_heads, window
        self.qkv1 = nn.Linear(dim, dim)
        self.qkv2 = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))

    def forward(self, x1, x2, shard: RowShard = None, drops: Drops = NO_DROPS,
                attn_drop: float = 0.0):
        """x1 (B1, N, C) query windows, x2 (ratio*B1, N, C) partner windows ->
        (B1, N, C).  ``drops`` site 0 drops the (ratio*B1, H, N, N)
        probabilities at ``attn_drop`` (training)."""
        n, c = x1.shape[1:]
        x1, x2, first, mine = gather_queries(x1, x2, shard)
        b1, r = x1.shape[0], x2.shape[0]
        ratio, heads = r // b1, self.num_heads
        hd = c // heads
        q = (self.qkv1(x1) * hd**-0.5).repeat(ratio, 1, 1)  # row j -> query j % B1
        k, v = self.qkv2(x2).reshape(r, n, 2, heads, hd).unbind(2)
        s = torch.einsum("rqhd,rkhd->rhqk", q.reshape(r, n, heads, hd), k).float()
        s = s + rel_pos_bias(self.relative_position_bias_table, self.window,
                             self.window).float()[None]
        a = torch.softmax(s, dim=-1).to(v.dtype)
        a = drops(0, a, attn_drop, self, "probs", row0=first)
        o = torch.einsum("rhqk,rkhd->rqhd", a, v).reshape(b1, ratio, n, c).sum(dim=1)
        return self.proj(o[:mine])


class CVAModule(nn.Module):
    """CVA residual wrapper: ``x1 + crossattn(x1, x2)``; in training
    ``x1 + keep * crossattn(x1, x2)`` with ``keep`` (B1,) one stochastic-depth
    factor per query window (the JAX package's drop-path inside CVAModule).
    ``kind`` picks :class:`SwinDAttention` or :class:`CrossWindowAttention`;
    ``drops`` (training) drops the attention's sites at ``attn_drop``."""

    def __init__(self, dim: int, num_heads: int, window: int = 7, kind: str = "deformable"):
        super().__init__()
        if kind == "deformable":
            self.crossattn = SwinDAttention(dim, num_heads, n_groups=3, window=window)
        elif kind == "window":
            self.crossattn = CrossWindowAttention(dim, num_heads, window=window)
        else:
            raise ValueError(f"unknown cva kind {kind!r}")

    def forward(self, x1, x2, keep=None, shard: RowShard = None, drops: Drops = NO_DROPS,
                attn_drop: float = 0.0):
        y = self.crossattn(x1, x2, shard, drops, attn_drop)
        if keep is None:
            return x1 + y
        return x1 + keep.to(y.dtype)[:, None, None] * y
