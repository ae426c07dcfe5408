"""Swin building blocks (channels-last tokens), counterpart of
``mumpy_tpu/models/swin.py``.

Module and parameter names follow the original PyTorch reference's
state_dict (``norm1``, ``attn.qkv``, ``attn.relative_position_bias_table``,
``mlp.fc1``, ...), so ``mumpy_tpu/utils/weight_port.py:port_state_dicts``
maps this package's weights onto the JAX model unchanged.

The blocks run at inference only.  Their attention and MLP go through the
hand-written kernels of :mod:`..ops`; :class:`KernelSite` holds each block's
kernel operands and the explicit choice between a kernel and its plain
version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..ops.ln_mlp import ln_mlp_operands
from ..ops.swin_block import swin_block, swin_block_operands, swin_block_plain
from ..ops.swin_pair import shift_row_map, swin_pair, swin_pair_operands, swin_pair_plain
from ..ops.vit3 import vit3, vit3_operands, vit3_plain
from ..ops.window import partition_tokens, shifted_window_mask, unpartition_tokens

__all__ = ["relative_position_index", "rel_pos_bias", "KernelSite", "Mlp",
           "WindowAttention", "SwinBlock", "PatchMerging", "VitBlock"]


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

    def build_ops(self):
        bias = self.attn.bias().detach()
        if self.shift > 0:
            mask = shifted_window_mask(*self.grid(), self.window, self.shift)
            mb = mask.to(bias)[:, None] + bias[None]  # (nW, H, n, n)
        else:
            mb = bias[None]  # (1, H, n, n)
        a, m = self.attn, self.mlp
        ops = swin_block_operands(
            self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight,
            a.proj.bias, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
            m.fc2.weight, m.fc2.bias, mb, a.num_heads)
        if self.leads_pair:  # the shift's row map, in the pair's GEMMs
            ops["shift_map"] = shift_row_map(*self.grid(), self.window,
                                             self.shift).to(bias.device)
        return ops

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
