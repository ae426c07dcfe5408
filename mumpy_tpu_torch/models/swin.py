"""Swin building blocks (channels-last tokens), counterpart of
``mumpy_tpu/models/swin.py``.

Module and parameter names follow the original PyTorch reference's
state_dict (``norm1``, ``attn.qkv``, ``attn.relative_position_bias_table``,
``mlp.fc1``, ...), so ``mumpy_tpu/utils/weight_port.py:port_state_dicts``
maps this package's weights onto the JAX model unchanged.

In eval mode the blocks' attention and MLP go through the hand-written
serving kernels of :mod:`..ops`; :class:`KernelSite` holds each block's
kernel operands and the explicit choice between a kernel and its plain
version.  In train mode (``model.train()``) every block runs on its live
parameters, never on those operands, as the JAX package trains with its
default ``MUMPY_FUSED_TRAIN_SITES=block,cross,mlp``: the plain Swin blocks
through the ``swin_block_train`` kernel, the ViT layers' attention by plain
autograd and their MLP tails through the ``ln_mlp_train`` kernel.
Stochastic depth is a per-sample keep factor drawn from an explicit
``torch.Generator`` (:func:`drop_path_keep`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ln_mlp import ln_mlp_operands
from ..ops.ln_mlp_train import ln_mlp_train, ln_mlp_train_plain, ln_mlp_weights
from ..ops.swin_block import swin_block, swin_block_operands, swin_block_plain
from ..ops.swin_block_train import swin_block_train, swin_block_train_plain, swin_block_weights
from ..ops.swin_pair import shift_row_map, swin_pair, swin_pair_operands, swin_pair_plain
from ..ops.vit3 import vit3, vit3_operands, vit3_plain
from ..ops.window import partition_tokens, shifted_window_mask, unpartition_tokens

__all__ = ["relative_position_index", "rel_pos_bias", "drop_path_keep", "KernelSite",
           "Mlp", "WindowAttention", "SwinBlock", "PatchMerging", "VitBlock"]


def drop_path_keep(n: int, rate: float, generator, device) -> torch.Tensor:
    """(n,) f32 stochastic-depth keep factors, one per sample: 0 with
    probability ``rate``, else 1 / (1 - rate) (the JAX package's
    ``drop_path``, timm's ``DropPath``); all ones at rate 0.  Drawn on the
    generator's device, so one seed gives the same draws on any path."""
    if rate == 0.0:
        return torch.ones(n, device=device)
    if generator is None:
        raise ValueError(f"drop-path at rate {rate} needs a torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(n, generator=generator, device=generator.device)
    return ((u < keep).float() / keep).to(device)


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static (wh*ww, wh*ww) index into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int64)


def rel_pos_bias(table: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(table_size, H) bias table -> (H, n, n) additive bias."""
    n = wh * ww
    idx = torch.from_numpy(relative_position_index(wh, ww)).to(table.device)
    return table[idx.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)


class KernelSite(nn.Module):
    """A module whose forward runs one of the hand-written kernels.

    ``use_kernels`` selects the kernel wrapper (True) or the kernel's plain
    PyTorch version (False); it is set explicitly, by
    ``utils.serving.set_kernel_path``, never by a fallback.  ``prepare()``
    builds the kernel operands once (weight layouts, the padded mask+bias)
    from the parameters as they are then; a forward before it raises.
    """

    use_kernels = True

    def build_ops(self):
        raise NotImplementedError

    def prepare(self):
        self._ops = self.build_ops()

    def kernel_ops(self):
        ops = self.__dict__.get("_ops")
        if ops is None:
            raise RuntimeError(f"{type(self).__name__}: call "
                               "utils.serving.prepare_for_inference(model) first")
        return ops


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def mlp_tail_operands(norm: nn.LayerNorm, mlp: Mlp):
    return ln_mlp_operands(norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias,
                           mlp.fc2.weight, mlp.fc2.bias)


class WindowAttention(nn.Module):
    """W-MSA parameters: qkv, proj and the relative-position bias table.

    ``relative_position_index`` is a buffer only so that the state_dict has
    the reference's keys; its value is never read (a loaded checkpoint cannot
    change it) — the index is recomputed by :func:`relative_position_index`.
    """

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window, window).copy()))

    def bias(self) -> torch.Tensor:
        return rel_pos_bias(self.relative_position_bias_table, self.window, self.window)


def clamp_window(res, window: int, shift: int):
    """A window no smaller than the grid covers it whole and never shifts."""
    h, w = res
    if min(h, w) <= window:
        return min(h, w), 0
    return window, shift


class SwinBlock(KernelSite):
    """Standard Swin block over a (T*H, W) temporally folded grid; the whole
    block runs through the ``swin_block`` kernel on window-major tokens, or,
    when ``leads_pair`` (a shifted block followed by a plain one, set by the
    encoder), the two run together through ``swin_pair`` (:meth:`pair_forward`)."""

    leads_pair = False
    drop_path = 0.0  # stochastic-depth rate in training, set by the encoder

    def __init__(self, dim, input_resolution, num_heads, window_size=7, shift_size=0,
                 mlp_ratio=4.0, temporal_dim=1):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.temporal_dim = temporal_dim
        self.window, self.shift = clamp_window(input_resolution, window_size, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, self.window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def grid(self):
        h, w = self.input_resolution
        return self.temporal_dim * h, w

    def mask_bias(self, table=None):
        """The (P, H, n, n) additive term: the relative-position bias, plus the
        shift mask (period nW) when the window shifts."""
        bias = rel_pos_bias(self.attn.relative_position_bias_table if table is None else table,
                            self.window, self.window)
        if self.shift > 0:
            mask = shifted_window_mask(*self.grid(), self.window, self.shift)
            return mask.to(bias)[:, None] + bias[None]  # (nW, H, n, n)
        return bias[None]  # (1, H, n, n)

    def build_ops(self):
        mb = self.mask_bias().detach()
        a, m = self.attn, self.mlp
        ops = swin_block_operands(
            self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight,
            a.proj.bias, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
            m.fc2.weight, m.fc2.bias, mb, a.num_heads)
        if self.leads_pair:  # the shift's row map, in the pair's GEMMs
            ops["shift_map"] = shift_row_map(*self.grid(), self.window,
                                             self.shift).to(mb.device)
        return ops

    def train_params(self):
        """The live parameters the training forward reads, in a fixed order
        (so a recomputed pair reads the tensors of its forward): the 12 of
        ``swin_block_weights``, then the relative-position table."""
        a, m = self.attn, self.mlp
        return [self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight,
                a.proj.bias, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                m.fc2.weight, m.fc2.bias, a.relative_position_bias_table]

    def train_forward(self, x, keep_attn, keep_mlp, *params):
        """Training: the block through the ``swin_block_train`` kernel (or its
        plain version) on ``params`` (default: its live parameters), on its
        (rolled) windows.  ``keep_attn`` / ``keep_mlp`` (B,) are the two
        residual branches' per-sample keep factors, repeated over the
        sample's windows."""
        *weights, table = params or self.train_params()
        gh, gw = self.grid()
        nw = (gh // self.window) * (gw // self.window)
        wins = partition_tokens(x, gh, gw, self.window, self.shift)
        fn = swin_block_train if self.use_kernels else swin_block_train_plain
        wins = fn(wins, self.mask_bias(table), swin_block_weights(weights, self.attn.num_heads),
                  keep_attn.repeat_interleave(nw), keep_mlp.repeat_interleave(nw))
        return unpartition_tokens(wins, gh, gw, self.window, self.shift)

    def forward(self, x):
        gh, gw = self.grid()
        wins = partition_tokens(x, gh, gw, self.window, self.shift)
        fn = swin_block if self.use_kernels else swin_block_plain
        wins = fn(wins, self.kernel_ops())
        return unpartition_tokens(wins, gh, gw, self.window, self.shift)

    def pair_forward(self, plain: "SwinBlock", wins):
        """This shifted block, then the unshifted ``plain`` block, on unshifted
        window-major tokens (B*nW, window^2, C) through ``swin_pair``."""
        ops = self.kernel_ops()
        pair = swin_pair_operands(ops, plain.kernel_ops(), ops["shift_map"],
                                  (*self.grid(), self.window, self.shift))
        return (swin_pair if self.use_kernels else swin_pair_plain)(wins, pair)


class PatchMerging(nn.Module):
    """2x2 patch merging over a (possibly temporally folded) grid."""

    def __init__(self, dim: int, grid_hw):
        super().__init__()
        self.grid_hw = tuple(grid_hw)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        gh, gw = self.grid_hw
        b, _, c = x.shape
        xs = x.reshape(b, gh // 2, 2, gw // 2, 2, c)
        # torch concat order: x0=(0,0) x1=(1,0) x2=(0,1) x3=(1,1)
        xs = torch.cat([xs[:, :, 0, :, 0], xs[:, :, 1, :, 0],
                        xs[:, :, 0, :, 1], xs[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(xs.reshape(b, (gh // 2) * (gw // 2), 4 * c)))


class VitAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class VitBlock(KernelSite):
    """Pre-LN ViT block on time-major tokens (3, R, C): the global temporal
    ViT attends over n = 3 time slices for each of its R = B*49 rows.  The
    whole layer runs through the ``vit3`` kernel."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = VitAttention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, mlp_dim)

    def build_ops(self):
        a, m = self.attn, self.mlp
        return vit3_operands(self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
                             a.proj.weight, a.proj.bias, self.norm2.weight,
                             self.norm2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight,
                             m.fc2.bias, self.num_heads)

    def forward(self, x):
        return (vit3 if self.use_kernels else vit3_plain)(x, self.kernel_ops())

    def train_forward(self, x, keep_attn, keep_mlp):
        """Training on time-major tokens (3, R, C).  The JAX package trains the
        ViT token-major, (R, 3, C), so drop-path draws one keep per (clip,
        token) row r, shared by its three time slices: ``keep_attn`` /
        ``keep_mlp`` are (R,).  The attention half runs by plain autograd (the
        JAX package has no training kernel for it), the tail through the
        ``ln_mlp_train`` kernel on the 3R rows."""
        _, r, c = x.shape
        heads = self.num_heads
        hd = c // heads
        h = F.layer_norm(x, (c,), self.norm1.weight, self.norm1.bias, 1e-5)
        q, k, v = self.attn.qkv(h).reshape(3, r, 3, heads, hd).unbind(2)
        s = torch.einsum("irhd,jrhd->rhij", q.float() * hd**-0.5, k.float())
        o = torch.einsum("rhij,jrhd->irhd", torch.softmax(s, dim=-1), v.float())
        y = self.attn.proj(o.reshape(3, r, c).to(x.dtype))
        x = x + keep_attn.to(x.dtype)[None, :, None] * y
        tail = ln_mlp_train if self.use_kernels else ln_mlp_train_plain
        out = tail(x.reshape(3 * r, c), ln_mlp_weights(self.norm2, self.mlp),
                   keep_mlp.repeat(3))  # time-major rows t * R + r take keep[r]
        return out.reshape(3, r, c)
