"""Multilateral temporal-view pyramid encoder, counterpart of
``mumpy_tpu/models/encoder.py``.

Module names follow the reference state_dict: ``tokenize.project{v}`` /
``tokenize.norm{v}``, ``layers.layers.{s}.blocks.{i}.block{v}``,
``layers.layers.{s}.downsample.downsample{v}``, ``globalembedding``,
``globalblocks.blocks.{i}``.  At block 0 of a stage the cross-view chain
runs view3 -> view2 -> view1; then each view's plain Swin blocks 1..d-1
alternate shifted / unshifted, every view shifting by view 1's window.  They
execute as the JAX package's ``ThreeViewStages`` groups them: (shifted i,
plain i+1) pairs through the ``swin_pair`` kernel on a window-major carry,
partitioned once before the pairs and unpartitioned once after, and a lone
last block through ``swin_block``.  Pairs run only where the window really
shifts (the clamp to a small grid sets the shift to 0).  The grouping is how
the blocks execute, not how they are named.  The global ViT runs time-major,
on a (3, B*49, C) carry, through the ``vit3`` kernel.

In train mode (``model.train()``) the encoder follows the JAX package's
training path with its default ``MUMPY_FUSED_TRAIN_SITES=block,cross,mlp``:
each cross-view block's attention half through the ``attn_ln_train`` kernel
and its tail through ``ln_mlp_train``; the plain blocks one by one through
the ``swin_block_train`` kernel, whose backward recomputes each block from
its input (on the plain path, by plain autograd with each (shifted, plain)
pair recomputed in the backward, ``torch.utils.checkpoint``, the JAX
package's scan remat); the ViT with its tails through ``ln_mlp_train``.
Drop-path follows the JAX schedule: ``dpr = linspace(0, rate, sum(view-3
depths))`` for all three views, ``dpr[base]`` for the cross block of a stage
and ``dpr[base + i]`` for its plain block i, ``linspace(0, rate, layers)``
for the ViT.  Every keep factor is drawn from
the ``generator`` the forward is given.  A forward on one part of a split
batch (a data-parallel rank, a serving replica) is given a
``swin.RowShard`` instead: the part's rows of the whole batch's keeps, and
the other parts' query windows for the cross-view attention, whose ratio
tiling reaches across clips (``deformable.py``).

In the ``"attention"`` kernel set (the JAX package's ``MUMPY_FUSED_BLOCK=off
MUMPY_PALLAS=on``; ``models/swin.py``) the encoder runs op by op on live
parameters in eval and in train mode: every plain block one by one
(``SwinBlock.op_forward``, no pairs, as the JAX package's stage-2 pairs are
off there), the cross-view blocks' attention half through the same
``window_attend``, and only the window-attention core through a kernel.
Training keeps the JAX package's remat of the scanned pair bodies on both
paths of that set: each (shifted, plain) pair under ``torch.utils.checkpoint``,
whole (``remat_policy="full"``) or keeping its matrix products' outputs
(``"dots"``).  Dropout (``drop_rate``, ``attn_drop_rate``; ``dropout.py``)
turns the training kernels off where the JAX package's gates do
(``swin.py``), and the plain blocks' pairs are then recomputed on both sets.
``cva_kind="window"`` puts the window cross-attention in every cross-view
block's CVA (``deformable.py``): no ``cva`` kernel then.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs import MumpyConfig
from ..ops.attn_ln import attn_ln, attn_ln_operands, attn_ln_plain
from ..ops.dct import faf
from ..ops.attn_ln_train import attn_ln_train, attn_ln_train_plain, attn_ln_weights
from ..ops.ln_mlp import ln_mlp, ln_mlp_plain
from ..ops.ln_mlp_train import ln_mlp_train, ln_mlp_train_plain, ln_mlp_weights
from ..ops.window import partition_tokens, unpartition_tokens
from .deformable import CVAModule
from .dropout import Drops
from .swin import (KernelSite, Mlp, PatchMerging, SwinBlock, VitBlock, WindowAttention,
                   as_shard, clamp_window, drop_path_keep, mlp_branch, mlp_tail_operands,
                   scale_rows, window_attend)

__all__ = ["patch_tokens", "PatchEmbed", "PatchEmbed3D", "CrossSwinBlock", "ThreeViewStages",
           "dots_policy", "train_plain_blocks", "merge_views_along_channel_axis",
           "GlobalVitBody", "MumpyEncoder"]


def patch_tokens(clip: torch.Tensor, proj: nn.Conv3d, norm: nn.LayerNorm, patch) -> torch.Tensor:
    """A Conv3d(kernel = stride = (t, p, p)) tokenizer and its LayerNorm, run
    as patch extraction + one matmul (valid stride: frames beyond
    ``(T // t) * t`` are dropped): clip (B, T, H, W, 3) -> (B, T' * h * w, C)."""
    ph, pw, pt = patch
    b, t, h, w, c = clip.shape
    to = t // pt
    x = clip[:, : to * pt].reshape(b, to, pt, h // ph, ph, w // pw, pw, c)
    # flatten patch dims in the Conv3d weight order (c_in, t, ph, pw)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, to * (h // ph) * (w // pw), -1)
    x = x @ proj.weight.reshape(proj.weight.shape[0], -1).t() + proj.bias
    return norm(x)


def _conv3d(hidden: int, patch) -> nn.Conv3d:
    ph, pw, pt = patch
    return nn.Conv3d(3, hidden, (pt, ph, pw), stride=(pt, ph, pw))


class PatchEmbed(nn.Module):
    """One view's tokenizer, ``proj`` + ``norm`` (the single-view baseline's
    ``patch_embed``), for ``hidden`` channels and ``patch`` = (ph, pw, pt)."""

    def __init__(self, hidden: int, patch):
        super().__init__()
        self.patch = tuple(patch)
        self.proj = _conv3d(hidden, patch)
        self.norm = nn.LayerNorm(hidden, eps=1e-5)

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        return patch_tokens(clip, self.proj, self.norm, self.patch)


class PatchEmbed3D(nn.Module):
    """The three views' tokenizers (``project{v}``, ``norm{v}``), one per
    (hidden, patch) of ``views`` (so view 2, of temporal patch 2, sees frames
    0 and 1 only)."""

    def __init__(self, views):
        super().__init__()
        self.patches = []
        for v, (hidden, patch) in enumerate(views, start=1):
            self.patches.append(tuple(patch))
            setattr(self, f"project{v}", _conv3d(hidden, patch))
            setattr(self, f"norm{v}", nn.LayerNorm(hidden, eps=1e-5))

    def embed(self, v: int, clip: torch.Tensor) -> torch.Tensor:
        """clip (B, T, H, W, 3) -> view ``v``'s tokens (B, T' * h * w, C)."""
        return patch_tokens(clip, getattr(self, f"project{v}"), getattr(self, f"norm{v}"),
                            self.patches[v - 1])


class CrossSwinBlock(KernelSite):
    """W-MSA + deformable cross-view attention + MLP, block 0 of every stage.

    Returns ``(x1_new, out)`` where ``out`` is the pre-residual W-MSA output,
    the partner stream of the next view.  In the ``"blocks"`` set the
    attention half runs through the ``attn_ln`` kernel, the tail through
    ``ln_mlp``; in the ``"attention"`` set both run op by op on live
    parameters (:meth:`train_forward`).  Reference quirks kept:
    the CVA output is added in window-major order without a window reverse,
    on top of the CVA's own residual (a double residual).  ``drop_path`` is
    the block's stochastic-depth rate in training, ``drop`` / ``attn_drop``
    its dropout rates; ``cva_kind`` the kind of its CVA."""

    drop_path = 0.0
    drop = attn_drop = 0.0
    # dropout sites: attention probabilities and output, the CVA's two, MLP hidden and output
    N_DROPS = 6

    def __init__(self, dim1, dim2, input_resolution, num_heads, window_size=7,
                 mlp_ratio=4.0, last_view=False, cva_kind="deformable"):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.window, _ = clamp_window(input_resolution, window_size, 0)
        self.last_view = last_view
        self.norm1 = nn.LayerNorm(dim1, eps=1e-5)
        self.attn = WindowAttention(dim1, self.window, num_heads)
        self.norm2 = nn.LayerNorm(dim1, eps=1e-5)
        self.mlp = Mlp(dim1, int(dim1 * mlp_ratio))
        if not last_view:
            self.pre = nn.Linear(dim2, dim1)
            self.cva = CVAModule(dim1, num_heads, window=self.window, kind=cva_kind)

    def build_ops(self):
        a = self.attn
        return {"attn": attn_ln_operands(self.norm1.weight, self.norm1.bias, a.qkv.weight,
                                         a.qkv.bias, a.proj.weight, a.proj.bias,
                                         a.bias().detach()[None], a.num_heads),
                "mlp": mlp_tail_operands(self.norm2, self.mlp)}

    def forward(self, x1, x2=None, generator=None):
        if self.training or self.kernel_set == "attention":
            return self.train_forward(x1, x2, generator)
        h, w = self.input_resolution
        win = self.window
        b1, l1, c1 = x1.shape
        gh1 = (l1 // (h * w)) * h
        ops = self.kernel_ops()
        x1w = partition_tokens(x1, gh1, w, win, 0)
        yw, x1w = (attn_ln if self.use_kernels else attn_ln_plain)(x1w, ops["attn"])
        out = unpartition_tokens(yw, gh1, w, win, 0)
        x1i = unpartition_tokens(x1w, gh1, w, win, 0)
        if not self.last_view:
            gh2 = (x2.shape[1] // (h * w)) * h
            x2w = self.pre(partition_tokens(x2, gh2, w, win, 0))
            x1i = x1i + self.cva(x1w, x2w, shard=as_shard(generator)).reshape(b1, l1, c1)
        return (ln_mlp if self.use_kernels else ln_mlp_plain)(x1i, ops["mlp"]), out

    def train_forward(self, x1, x2, generator):
        """Training on live parameters, and the ``"attention"`` set's eval
        forward (drop-path only in training).  Drop-path draws one keep per
        sample for each residual branch (attention, CVA, MLP), repeated over
        the sample's windows or tokens, sample-major; the CVA's own residual
        draws one per window.  The partner stream ``out`` is the attention
        branch before drop-path.  The ``"blocks"`` set runs the attention half
        through the ``attn_ln_train`` kernel and the tail through
        ``ln_mlp_train``; the ``"attention"`` set runs the JAX package's per-op
        branch, LayerNorm and :func:`window_attend` (its core through the
        ``window_attention`` kernel), and the tail's plain version, since the
        JAX package runs the tail in XLA there.  At a dropout rate above 0
        (training) the attention half runs that per-op branch in both sets,
        on the plain core in the ``"blocks"`` set (the JAX package's
        ``attn_ln`` training kernel refuses dropout) and at ``attn_drop``
        above 0 in both, and the tail by plain autograd at ``drop`` above 0;
        the block's six sites drop as the JAX package's do."""
        h, w = self.input_resolution
        win = self.window
        b1, l1, c1 = x1.shape
        gh1 = (l1 // (h * w)) * h
        nw = (gh1 // win) * (w // win)
        rate, dev = (self.drop_path if self.training else 0.0), x1.device
        keep = drop_path_keep(b1, rate, generator, dev)
        dropping = self.training and (self.drop > 0 or self.attn_drop > 0)
        drops = Drops.draw(self.N_DROPS, dropping, generator, dev)
        if self.kernel_set == "attention" or dropping:
            y = window_attend(self.attn, self.norm1(x1), (gh1, w), win, 0,
                              self.attn.bias()[None],
                              self.use_kernels and self.kernel_set == "attention", None,
                              drops, self.attn_drop, self.drop)
            out, x1i = y, x1 + scale_rows(y, keep)
            x1w = partition_tokens(x1i, gh1, w, win, 0)
        else:
            attn = attn_ln_train if self.use_kernels else attn_ln_train_plain
            yw, x1w = attn(partition_tokens(x1, gh1, w, win, 0), self.attn.bias()[None],
                           attn_ln_weights(self.norm1, self.attn, self.attn.num_heads),
                           keep.repeat_interleave(nw))
            out = unpartition_tokens(yw, gh1, w, win, 0)
            x1i = unpartition_tokens(x1w, gh1, w, win, 0)
        if not self.last_view:
            gh2 = (x2.shape[1] // (h * w)) * h
            x2w = self.pre(partition_tokens(x2, gh2, w, win, 0))
            cw = self.cva(x1w, x2w, drop_path_keep(b1 * nw, rate, generator, dev),
                          as_shard(generator), drops.at(2), self.attn_drop)
            keep = drop_path_keep(b1, rate, generator, dev)
            x1i = x1i + keep.to(cw.dtype)[:, None, None] * cw.reshape(b1, l1, c1)
        keep = drop_path_keep(b1, rate, generator, dev)
        if dropping and self.drop > 0:
            y = mlp_branch(x1i, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                           self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                           drops.at(4), self.drop, self.mlp)
            return x1i + scale_rows(y, keep), out
        keep = keep.repeat_interleave(l1)
        tail = ln_mlp_train if self.block_kernels else ln_mlp_train_plain
        x1o = tail(x1i.reshape(b1 * l1, c1), ln_mlp_weights(self.norm2, self.mlp), keep)
        return x1o.reshape(b1, l1, c1), out


class BlockGroup(nn.Module):
    """Block ``i`` of a stage for each view that is that deep (``block{v}``)."""

    def __init__(self, blocks):
        super().__init__()
        for v, blk in blocks.items():
            setattr(self, f"block{v}", blk)


class Downsample(nn.Module):
    def __init__(self, merges):
        super().__init__()
        for v, m in enumerate(merges, start=1):
            setattr(self, f"downsample{v}", m)


class Stage(nn.Module):
    def __init__(self, blocks: List[BlockGroup], downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class ThreeViewStages(nn.Module):
    """The 4-stage cross-view pyramid.  Returns the final view tokens and, per
    stage, the three views' tokens after the stage's last block (before
    patch merging) for the decoder's skip path."""

    def __init__(self, cfg: MumpyConfig):
        super().__init__()
        self.remat, self.remat_policy = cfg.remat, cfg.remat_policy
        vcfgs = cfg.views
        max_depths = vcfgs[2].depths
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(max_depths))
        shift = vcfgs[0].window_size // 2  # every view shifts by view 1's window
        stages = []
        for s in range(4):
            base = sum(max_depths[:s])
            res = vcfgs[0].input_resolution[s]
            groups = []
            for i in range(max_depths[s]):
                blocks = {}
                for v, vc in enumerate(vcfgs, start=1):
                    if i >= vc.depths[s]:
                        continue
                    if i == 0:
                        dim2 = vcfgs[v].hidden_size[s] if v < 3 else None
                        blocks[v] = CrossSwinBlock(
                            vc.hidden_size[s], dim2, res, vc.num_heads[s],
                            window_size=vc.window_size, last_view=v == 3,
                            cva_kind=cfg.cva_kind)
                    else:
                        blocks[v] = SwinBlock(
                            vc.hidden_size[s], res, vc.num_heads[s],
                            window_size=vc.window_size, shift_size=shift if i % 2 else 0,
                            temporal_dim=vc.temporal_dim)
                    blocks[v].drop_path = float(dpr[base + i])
                    blocks[v].drop, blocks[v].attn_drop = cfg.drop_rate, cfg.attn_drop_rate
                groups.append(BlockGroup(blocks))
            for v in range(1, 4):
                pair_plain_blocks([getattr(g, f"block{v}") for g in groups[1:]
                                   if hasattr(g, f"block{v}")])
            down = None
            if s < 3:
                down = Downsample([PatchMerging(vc.hidden_size[s],
                                                (vc.temporal_dim * res[0], res[1]))
                                   for vc in vcfgs])
            stages.append(Stage(groups, down))
        self.layers = nn.ModuleList(stages)

    def forward(self, views: List[torch.Tensor], generator=None):
        x = list(views)
        stage_outputs = []
        for stage in self.layers:
            first = stage.blocks[0]
            x[2], out2 = first.block3(x[2], generator=generator)
            x[1], out1 = first.block2(x[1], out2, generator=generator)
            x[0], _ = first.block1(x[0], out1, generator=generator)
            for v in range(3):
                plain = [getattr(g, f"block{v + 1}") for g in stage.blocks[1:]
                         if hasattr(g, f"block{v + 1}")]
                if self.training:
                    x[v] = train_plain_blocks(plain, x[v], generator, self.remat,
                                              self.remat_policy)
                else:
                    x[v] = run_plain_blocks(plain, x[v])
            stage_outputs.append(list(x))
            if hasattr(stage, "downsample"):
                x = [getattr(stage.downsample, f"downsample{v + 1}")(x[v]) for v in range(3)]
        return x, stage_outputs


def pair_plain_blocks(blocks: List[SwinBlock]) -> None:
    """Group one view's plain blocks 1..d-1 of a stage as the JAX package's
    ``ThreeViewStages`` does: (shifted i, plain i+1) pairs and, for an odd
    count, a lone last block.  Pairs form only where the window really shifts
    (a window clamped to the whole grid does not)."""
    if blocks and blocks[0].shift > 0:
        for head in blocks[0:len(blocks) // 2 * 2:2]:
            head.leads_pair = True


def run_plain_blocks(blocks: List[SwinBlock], x: torch.Tensor) -> torch.Tensor:
    """One view's plain blocks of a stage on image tokens (B, L, C): the pairs
    on a window-major carry, partitioned once and unpartitioned once, then
    the lone blocks.  The ``"attention"`` set has no pairs: its blocks run
    one by one."""
    n_pairs = sum(blk.leads_pair and blk.kernel_set == "blocks" for blk in blocks)
    if n_pairs:
        head = blocks[0]
        (gh, gw), win = head.grid(), head.window
        wins = partition_tokens(x, gh, gw, win, 0)
        for i in range(n_pairs):
            wins = blocks[2 * i].pair_forward(blocks[2 * i + 1], wins)
        x = unpartition_tokens(wins, gh, gw, win, 0)
    for blk in blocks[2 * n_pairs:]:
        x = blk(x)
    return x


def _pair_forward(first, second, x, ka0, km0, ka1, km1, d0, d1, *params):
    """Two consecutive plain blocks on the parameters they are handed."""
    half = len(params) // 2
    x = first.train_forward(x, ka0, km0, *params[:half], drops=d0)
    return second.train_forward(x, ka1, km1, *params[half:], drops=d1)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The remat policy ``"dots"`` (the JAX package's
    ``dots_with_no_batch_dims_saveable``): keep the outputs of the matrix
    products without batch dims (``aten.mm``, ``aten.addmm``: every Linear),
    recompute the rest, the batched attention products among them."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


def train_plain_blocks(blocks: List[SwinBlock], x: torch.Tensor, generator,
                       remat: bool, policy: str = "full") -> torch.Tensor:
    """One view's plain blocks 1..d-1 of a stage in training, as the JAX
    package's scanned stack runs them: (block i, block i+1) pairs, then a
    lone last block.  Each pair is recomputed in the backward when
    ``remat``, whole (``policy`` ``"full"``) or all but its matrix products'
    outputs (``"dots"``, :func:`dots_policy`), except where the
    ``"blocks"`` set's kernel runs, as the JAX package drops the scan's
    remat for the stacks its block kernel owns (``kernel_owns_memory``):
    the kernel's backward recomputes the block from its input.  At a
    dropout rate above 0 no block kernel runs, so the pairs are
    recomputed.  Keep factors and dropout seeds are drawn before the
    checkpoint and the pair is handed its parameters, so the recompute reads
    the tensors the forward read (the bf16 casts of a mixed-precision step
    included) and drops what it dropped."""
    b = x.shape[0]
    keeps = [(drop_path_keep(b, blk.drop_path, generator, x.device),
              drop_path_keep(b, blk.drop_path, generator, x.device)) for blk in blocks]
    drops = [blk.draw_drops(generator, x.device) for blk in blocks]
    n_pairs = len(blocks) // 2
    remat = remat and not (blocks and blocks[0].block_kernels and not blocks[0].dropping)
    extra = {"context_fn": _dots_context} if policy == "dots" else {}
    for i in range(n_pairs):
        first, second = blocks[2 * i], blocks[2 * i + 1]
        args = (x, *keeps[2 * i], *keeps[2 * i + 1], drops[2 * i], drops[2 * i + 1],
                *first.train_params(), *second.train_params())
        if remat:
            x = checkpoint(_pair_forward, first, second, *args, use_reentrant=False,
                           preserve_rng_state=False, **extra)
        else:
            x = _pair_forward(first, second, *args)
    for blk, keep, d in zip(blocks[2 * n_pairs:], keeps[2 * n_pairs:], drops[2 * n_pairs:]):
        x = blk.train_forward(x, *keep, drops=d)
    return x


class GlobalVitBody(nn.Module):
    """The global temporal ViT's layers (``globalblocks.blocks.{i}``)."""

    def __init__(self, cfg: MumpyConfig):
        super().__init__()
        ge = cfg.global_encoder
        self.blocks = nn.ModuleList(
            VitBlock(ge.hidden_size, ge.num_heads, ge.mlp_dim) for _ in range(ge.num_layers))
        for blk in self.blocks:
            blk.drop = cfg.drop_rate
        self.drop_path = [float(r) for r in
                          np.linspace(0.0, cfg.drop_path_rate, ge.num_layers)]

    def forward(self, x, generator=None):
        for blk, rate in zip(self.blocks, self.drop_path):
            if self.training:  # one keep per (clip, token) row: see VitBlock.train_forward
                r = x.shape[1]
                x = blk.train_forward(x, drop_path_keep(r, rate, generator, x.device),
                                      drop_path_keep(r, rate, generator, x.device),
                                      Drops.draw(blk.N_DROPS, blk.drop > 0, generator, x.device))
            else:
                x = blk(x)
        return x


def merge_views_along_channel_axis(tokens: List[torch.Tensor],
                                   temporal_dims: Tuple[int, ...]) -> torch.Tensor:
    """(B, T_i * n, C_i) views -> (B, maxT, n, sum C_i), each view tiled to maxT
    along time."""
    max_t = max(temporal_dims)
    xs = []
    for t_dim, x in zip(temporal_dims, tokens):
        b, l, c = x.shape
        x = x.reshape(b, t_dim, l // t_dim, c)
        xs.append(x.repeat(1, max_t // t_dim, 1, 1))
    return torch.cat(xs, dim=-1)


class MumpyEncoder(nn.Module):
    """FAF + tokenizers + stages + global temporal ViT.

    clip (B, T, H, W, 3) -> feats (B, 7, 7, T*768), per-stage view tokens,
    ffinfo (B, H, W, 9)."""

    def __init__(self, cfg: MumpyConfig):
        super().__init__()
        self.cfg = cfg
        self.tokenize = PatchEmbed3D([(vc.hidden_size[0], vc.patch_size) for vc in cfg.views])
        self.layers = ThreeViewStages(cfg)
        merged_c = sum(v.hidden_size[-1] for v in cfg.views)
        self.globalembedding = nn.Linear(merged_c, cfg.global_encoder.hidden_size)
        self.globalblocks = GlobalVitBody(cfg)

    def forward(self, clip, generator=None):
        cfg = self.cfg
        ffinfo = faf(clip[:, 1])  # frequency branch on the centre frame
        views = [self.tokenize.embed(v, clip) for v in (1, 2, 3)]
        x, stage_outputs = self.layers(views, generator)
        merged = self.globalembedding(
            merge_views_along_channel_axis(x, cfg.input_token_temporal_dims))
        b, t, n, c = merged.shape
        # the ViT attends over time for each spatial token: time-major slabs
        # (t, B*n, C), each layer through the n = 3 vit3 kernel
        g = self.globalblocks(merged.transpose(0, 1).reshape(t, b * n, c), generator)
        feats = torch.cat(list(g), dim=-1)  # temporal slices concatenated along channels
        feats = feats.reshape(b, n, t * c)
        side = cfg.views[0].input_resolution[-1][0]
        return feats.reshape(b, side, side, t * c), stage_outputs, ffinfo

