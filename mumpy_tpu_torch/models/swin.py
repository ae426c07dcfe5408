"""Swin building blocks (channels-last tokens), counterpart of
``mumpy_tpu/models/swin.py``.

Module and parameter names follow the original PyTorch reference's
state_dict (``norm1``, ``attn.qkv``, ``attn.relative_position_bias_table``,
``mlp.fc1``, ...), so ``mumpy_tpu/utils/weight_port.py:port_state_dicts``
maps this package's weights onto the JAX model unchanged.

Each :class:`KernelSite` runs one of two kernel sets, chosen explicitly
(``utils.serving.set_kernel_path``):

* ``"blocks"``, the JAX package's default: in eval mode the blocks'
  attention and MLP go through the hand-written whole-block serving kernels
  of :mod:`..ops`, on operands the site builds once; in train mode
  (``model.train()``) every block runs on its live parameters, as the JAX
  package trains with its default ``MUMPY_FUSED_TRAIN_SITES=block,cross,mlp``:
  the plain Swin blocks through the ``swin_block_train`` kernel, the ViT
  layers' attention by plain autograd and their MLP tails through the
  ``ln_mlp_train`` kernel;
* ``"attention"``, the JAX package's per-op configuration
  (``MUMPY_FUSED_BLOCK=off MUMPY_PALLAS=on``): every layer runs op by op on
  its live parameters, in eval and in train mode alike, and only the
  window-attention core of the 60 Swin attentions goes through a kernel
  (``window_attention``, differentiable); LayerNorm, Linear, GELU, the ViT
  and the MLP tails are plain PyTorch, as the JAX package runs them in XLA
  there.

Stochastic depth is a per-sample keep factor drawn from an explicit
``torch.Generator`` (:func:`drop_path_keep`); a model that runs one part
of a split batch takes a :class:`RowShard` in its place.  Dropout
(``drop``, ``attn_drop``; ``models/dropout.py``) sits at the JAX package's
sites: the attention probabilities and the projection output of every
window attention, the MLP's hidden after GELU and its output, and in the ViT
its attention probabilities and projection output, all at ``drop`` there.
At a rate above 0 the training path leaves exactly the kernels the JAX
package's ``train_supported`` gates leave: a Swin block's ``swin_block_train``
at ``drop`` or ``attn_drop`` above 0 (the block then runs op by op, as
:meth:`SwinBlock.op_forward`), an MLP tail's ``ln_mlp_train`` at ``drop``
above 0, and the per-op set's ``window_attention`` at ``attn_drop`` above 0.
Eval mode has no dropout and runs the serving kernels as at rate 0.
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
from ..ops.window_attention import window_attention, window_attention_plain
from .dropout import NO_DROPS, Drops

__all__ = ["relative_position_index", "rel_pos_bias", "RowShard", "as_shard", "drop_path_keep",
           "KERNEL_SETS", "KernelSite", "Mlp", "WindowAttention", "window_attend", "mlp_branch",
           "SwinBlock", "PatchMerging", "VitBlock"]

KERNEL_SETS = ("blocks", "attention")


class RowShard:
    """One of ``world`` contiguous parts of a batch, part ``rank``: a rank of
    a data-parallel step, or a replica of the split serving forward.  The
    model takes it in place of its ``generator``.

    * Drop-path: every draw is the whole batch's, ``n * world`` values from
      the shared ``generator``, of which the part keeps its contiguous ``n``.
      Each drawn tensor is row-major (a clip's keeps before the next clip's,
      its windows or tokens inside), so the part's rows are one slice, and
      the parts together take exactly the keeps of the whole batch, as the
      JAX package's sharded step draws over the global batch.
    * The cross-view attention: ``gather(x)`` returns every part's ``x``,
      concatenated in part order (differentiable), for the one operation
      whose rows reach across clips (``models/deformable.py``)."""

    def __init__(self, world: int, rank: int, gather, generator: torch.Generator = None):
        self.world, self.rank, self.gather, self.generator = world, rank, gather, generator

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def rand(self, n: int) -> torch.Tensor:
        u = torch.rand(n * self.world, generator=self.generator, device=self.device)
        return u[self.rank * n:(self.rank + 1) * n]


def as_shard(generator):
    """The :class:`RowShard` a model was handed as its ``generator``, or None
    (a ``torch.Generator``, or nothing: the whole batch)."""
    return generator if isinstance(generator, RowShard) else None


def drop_path_keep(n: int, rate: float, generator, device) -> torch.Tensor:
    """(n,) f32 stochastic-depth keep factors, one per sample: 0 with
    probability ``rate``, else 1 / (1 - rate) (the JAX package's
    ``drop_path``, timm's ``DropPath``); all ones at rate 0.  Drawn on the
    generator's device, so one seed gives the same draws on any path; a
    :class:`RowShard` gives its part's rows of the whole batch's draw."""
    if rate == 0.0:
        return torch.ones(n, device=device)
    shard = isinstance(generator, RowShard)
    if (generator.generator if shard else generator) is None:
        raise ValueError(f"drop-path at rate {rate} needs a torch.Generator")
    keep = 1.0 - rate
    if shard:
        u = generator.rand(n)
    else:
        u = torch.rand(n, generator=generator, device=generator.device)
    return ((u < keep).float() / keep).to(device)


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

    ``kernel_set`` picks the kernels (``"blocks"`` or ``"attention"``, see
    the module docstring) and ``use_kernels`` the kernel wrappers (True) or
    the kernels' plain PyTorch versions (False); both are set explicitly, by
    ``utils.serving.set_kernel_path``, never by a fallback.  ``prepare()``
    builds the ``"blocks"`` set's kernel operands once (weight layouts, the
    padded mask+bias) from the parameters as they are then; a forward of
    that set before it raises.  The ``"attention"`` set has no operands.
    """

    use_kernels = True
    kernel_set = "blocks"

    @property
    def block_kernels(self) -> bool:
        """Whether this site launches the ``"blocks"`` set's kernels."""
        return self.use_kernels and self.kernel_set == "blocks"

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

    def params(self):
        """The live (w_qkv, b_qkv, w_proj, b_proj), torch layouts."""
        return self.qkv.weight, self.qkv.bias, self.proj.weight, self.proj.bias

    def forward(self, x, mb, use_kernel: bool = True, params=None, drops: Drops = NO_DROPS,
                attn_drop: float = 0.0, proj_drop: float = 0.0):
        """Counterpart of the JAX package's ``WindowAttention`` on its per-op
        path, on windows ``x`` (B*nW, N, C) with the additive term ``mb``
        (P, H, N, N): the qkv Linear, the ``window_attention`` kernel (or,
        with ``use_kernel`` False, its plain version) on the packed qkv, the
        proj Linear; on ``params`` = (w_qkv, b_qkv, w_proj, b_proj), by
        default the live ones.  ``drops`` sites 0 and 1 drop the (B*nW, H,
        N, N) probabilities at ``attn_drop`` (on the plain version: the
        kernel has no dropout) and the output at ``proj_drop``."""
        w_qkv, b_qkv, w_proj, b_proj = params or self.params()
        qkv = F.linear(x, w_qkv, b_qkv)
        if drops.seeds is not None and attn_drop > 0:
            o = window_attention_plain(qkv, mb, self.num_heads,
                                       lambda a: drops(0, a, attn_drop, self, "probs"))
        else:
            o = (window_attention if use_kernel else window_attention_plain)(
                qkv, mb, self.num_heads)
        return drops(1, F.linear(o, w_proj, b_proj), proj_drop, self, "out")


def window_attend(attn: WindowAttention, x, grid_hw, window: int, shift: int, mb,
                  use_kernel: bool, params=None, drops: Drops = NO_DROPS,
                  attn_drop: float = 0.0, proj_drop: float = 0.0):
    """Counterpart of the JAX package's ``window_attend``: ``attn`` on the
    (shifted) windows of image tokens (B, L, C) over the folded ``grid_hw``,
    taken from the ``roll(-shift)`` layout and put back; ``mb`` is the
    (P, H, N, N) mask+bias of that layout."""
    gh, gw = grid_hw
    wins = attn(partition_tokens(x, gh, gw, window, shift), mb, use_kernel, params, drops,
                attn_drop, proj_drop)
    return unpartition_tokens(wins, gh, gw, window, shift)


def mlp_branch(x, ln_g, ln_b, w1, b1, w2, b2, drops: Drops = NO_DROPS, rate: float = 0.0,
               mlp=None):
    """``fc2(gelu(fc1(LN x)))`` on tokens (rows first), with ``drops`` sites
    0 and 1 on the hidden after GELU and on the output (the JAX package's
    ``Mlp``)."""
    c = x.shape[-1]
    h = F.gelu(F.linear(F.layer_norm(x, (c,), ln_g, ln_b, 1e-5), w1, b1))
    y = F.linear(drops(0, h, rate, mlp, "act"), w2, b2)
    return drops(1, y, rate, mlp, "out")


def scale_rows(y, keep):
    """``y`` (B, L, C) times its sample's keep factor (``keep`` (B,), or None: 1)."""
    return y if keep is None else keep.to(y.dtype)[:, None, None] * y


def clamp_window(res, window: int, shift: int):
    """A window no smaller than the grid covers it whole and never shifts."""
    h, w = res
    if min(h, w) <= window:
        return min(h, w), 0
    return window, shift


class SwinBlock(KernelSite):
    """Standard Swin block over a (T*H, W) temporally folded grid.  In the
    ``"blocks"`` set the whole block runs through the ``swin_block`` kernel
    on window-major tokens, or, when ``leads_pair`` (a shifted block followed
    by a plain one, set by the encoder), the two run together through
    ``swin_pair`` (:meth:`pair_forward`); in the ``"attention"`` set it runs
    op by op (:meth:`op_forward`)."""

    leads_pair = False
    drop_path = 0.0  # stochastic-depth rate in training, set by the encoder
    drop = attn_drop = 0.0  # dropout rates in training, set by the encoder
    N_DROPS = 4  # dropout sites: attention probabilities and output, MLP hidden and output

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

    @property
    def dropping(self) -> bool:
        """Whether a dropout rate is above 0: the JAX package's block
        training kernel refuses the block then, and it trains op by op."""
        return self.drop > 0 or self.attn_drop > 0

    def draw_drops(self, generator, device) -> Drops:
        """The dropout seeds of one training forward (none at rates 0)."""
        return Drops.draw(self.N_DROPS, self.dropping, generator, device)

    def train_params(self):
        """The live parameters the training forward reads, in a fixed order
        (so a recomputed pair reads the tensors of its forward): the 12 of
        ``swin_block_weights``, then the relative-position table."""
        a, m = self.attn, self.mlp
        return [self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias, a.proj.weight,
                a.proj.bias, self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
                m.fc2.weight, m.fc2.bias, a.relative_position_bias_table]

    def train_forward(self, x, keep_attn, keep_mlp, *params, drops: Drops = NO_DROPS):
        """Training: the block through the ``swin_block_train`` kernel (or its
        plain version) on ``params`` (default: its live parameters), on its
        (rolled) windows; in the ``"attention"`` set, or at a dropout rate
        above 0 (``drops``, :meth:`draw_drops`), :meth:`op_forward`.
        ``keep_attn`` / ``keep_mlp`` (B,) are the two residual branches'
        per-sample keep factors, repeated over the sample's windows."""
        if self.kernel_set == "attention" or self.dropping:
            return self.op_forward(x, keep_attn, keep_mlp, *params, drops=drops)
        *weights, table = params or self.train_params()
        gh, gw = self.grid()
        nw = (gh // self.window) * (gw // self.window)
        wins = partition_tokens(x, gh, gw, self.window, self.shift)
        fn = swin_block_train if self.use_kernels else swin_block_train_plain
        wins = fn(wins, self.mask_bias(table), swin_block_weights(weights, self.attn.num_heads),
                  keep_attn.repeat_interleave(nw), keep_mlp.repeat_interleave(nw))
        return unpartition_tokens(wins, gh, gw, self.window, self.shift)

    def op_forward(self, x, keep_attn=None, keep_mlp=None, *params, drops: Drops = NO_DROPS):
        """The block op by op, the ``"attention"`` set (the JAX package's
        ``SwinBlock`` with its fused branches off), and the training path at
        a dropout rate above 0 (the JAX package's XLA path): norm1, the
        (shifted-)window attention with the shift's mask+bias, its core
        through ``window_attention`` in the ``"attention"`` set, the
        residual, norm2, the Mlp, the residual.  The same code serves (eval
        mode, no keeps) and trains by autograd, on ``params`` in
        :meth:`train_params` order (default: the live ones), ``keep_attn`` /
        ``keep_mlp`` (B,) scaling the two residual branches and ``drops``
        dropping at the block's four sites."""
        n1g, n1b, wq, bq, wp, bp, n2g, n2b, w1, b1, w2, b2, table = \
            params or self.train_params()
        c = x.shape[-1]
        y = window_attend(self.attn, F.layer_norm(x, (c,), n1g, n1b, 1e-5), self.grid(),
                          self.window, self.shift, self.mask_bias(table),
                          self.use_kernels and self.kernel_set == "attention",
                          (wq, bq, wp, bp), drops, self.attn_drop, self.drop)
        x = x + scale_rows(y, keep_attn)
        y = mlp_branch(x, n2g, n2b, w1, b1, w2, b2, drops.at(2), self.drop, self.mlp)
        return x + scale_rows(y, keep_mlp)

    def forward(self, x):
        if self.kernel_set == "attention":
            return self.op_forward(x)
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

    drop = 0.0  # the dropout rate in training, set by the encoder
    N_DROPS = 4  # attention probabilities and output, MLP hidden and output

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
        if self.kernel_set == "attention":  # the plain layer on live parameters
            ones = torch.ones(x.shape[1], device=x.device)
            return self.train_forward(x, ones, ones)
        return (vit3 if self.use_kernels else vit3_plain)(x, self.kernel_ops())

    def train_forward(self, x, keep_attn, keep_mlp, drops: Drops = NO_DROPS):
        """Training on time-major tokens (3, R, C).  The JAX package trains the
        ViT token-major, (R, 3, C), so drop-path draws one keep per (clip,
        token) row r, shared by its three time slices: ``keep_attn`` /
        ``keep_mlp`` are (R,).  The attention half runs by plain autograd (the
        JAX package has no training kernel for it), the tail through the
        ``ln_mlp_train`` kernel on the 3R rows, or, at ``drop`` above 0, by
        plain autograd with its dropout.  Dropout (``drops``, all four sites
        at ``drop``) sees the token-major layout: the probabilities as
        (R, 3, H, 3), the rest as (R, 3, width).  In the ``"attention"`` set
        the tail is plain too and this is also the eval forward (keeps of 1):
        the JAX package runs the whole layer in XLA there, so this is the one
        place where a plain version is on the card's path."""
        _, r, c = x.shape
        heads = self.num_heads
        hd = c // heads
        rate = self.drop
        h = F.layer_norm(x, (c,), self.norm1.weight, self.norm1.bias, 1e-5)
        q, k, v = self.attn.qkv(h).reshape(3, r, 3, heads, hd).unbind(2)
        s = torch.einsum("irhd,jrhd->rhij", q.float() * hd**-0.5, k.float())
        a = torch.softmax(s, dim=-1)
        if drops.seeds is not None:  # (R, H, i, j) as the JAX package's (R, i, H, j)
            a = drops(0, a.permute(0, 2, 1, 3), rate, self.attn, "probs").permute(0, 2, 1, 3)
        o = torch.einsum("rhij,jrhd->irhd", a, v.float())
        y = self.attn.proj(o.reshape(3, r, c).to(x.dtype))
        y = drops(1, y.transpose(0, 1), rate, self.attn, "out").transpose(0, 1)
        x = x + keep_attn.to(x.dtype)[None, :, None] * y
        if drops.seeds is not None and rate > 0:  # the JAX package's Mlp, token-major
            t = x.transpose(0, 1)
            y = mlp_branch(t, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                           self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                           drops.at(2), rate, self.mlp)
            return (t + keep_mlp.to(x.dtype)[:, None, None] * y).transpose(0, 1)
        tail = ln_mlp_train if self.block_kernels else ln_mlp_train_plain
        out = tail(x.reshape(3 * r, c), ln_mlp_weights(self.norm2, self.mlp),
                   keep_mlp.repeat(3))  # time-major rows t * R + r take keep[r]
        return out.reshape(3, r, c)
