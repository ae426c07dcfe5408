"""The single-view Swin baseline, the ablation model, counterpart of
``mumpy_tpu/models/baseline.py``.

``BaselineModel`` is one Swin pyramid over the three-frame clip (the
tokenizer's temporal patch is the clip's length, so one temporal token) and
a progressive decoder: five conv3x3 + GroupNorm(32) + ReLU + 2x bilinear
stages and a final conv3x3.  Its 24 Swin blocks (Swin-B: embed 128, depths
(2, 2, 18, 2), heads (4, 8, 16, 32), window 7) are the port's
:class:`~.swin.SwinBlock` s, run one by one as the JAX package runs them
(no pairs, no remat): in eval mode each through the ``swin_block`` kernel
(after ``utils.serving.prepare_for_inference``), in train mode each through
the ``swin_block_train`` kernel with per-sample drop-path keeps from the
forward's ``generator``, or op by op at a dropout rate above 0, as the JAX
package's gates send it.  The decoder is plain PyTorch (cuDNN), as the JAX
package runs it in XLA.  ``utils.serving.make_serving_forward`` serves it on
one device or split over several (no operation reads across clips).

State_dict names follow the reference's single-view Swin
(``encoder.patch_embed.proj``, ``encoder.layers.{s}.blocks.{i}.attn.qkv``,
``encoder.layers.{s}.downsample.reduction``, ``encoder.norm``) and decoder
(``decoder.decoder_{i}.0``, ``decoder.final_out``);
``utils.weight_port.from_jax_baseline_params`` maps the JAX package's tree
onto them.  No CLI trains or serves it, in the JAX package or here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .decoder import ConvGNReLUUp, conv
from .dropout import Drops
from .encoder import PatchEmbed, Stage
from .swin import PatchMerging, SwinBlock, drop_path_keep

__all__ = ["BaselineConfig", "tiny_baseline_config", "BaselineEncoder", "BaselineDecoder",
           "BaselineModel", "create_baseline"]


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    """The reference baseline's hyperparameters, value for value."""

    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    patch: Tuple[int, int, int] = (4, 4, 3)  # (ph, pw, pt)
    image_size: int = 224
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    decoder_features: Tuple[int, ...] = (256, 256, 256, 256, 256)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


def tiny_baseline_config(image_size: int = 32) -> BaselineConfig:
    """The baseline at test size: the 8/4/2/1 pyramid at 32, window 4."""
    return BaselineConfig(embed_dim=16, depths=(2, 2, 4, 2), num_heads=(2, 2, 4, 4),
                          window_size=4, image_size=image_size, drop_path_rate=0.0,
                          decoder_features=(32, 32, 32, 32, 32))


class BaselineEncoder(nn.Module):
    """clip (B, T, H, W, 3) -> features (B, H/32, W/32, 8 * embed_dim)."""

    def __init__(self, cfg: BaselineConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch)
        res = cfg.image_size // cfg.patch[0]
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))
        stages = []
        for s, depth in enumerate(cfg.depths):
            dim = cfg.embed_dim * 2**s
            blocks = []
            for i in range(depth):
                blk = SwinBlock(dim, (res, res), cfg.num_heads[s], window_size=cfg.window_size,
                                shift_size=0 if i % 2 == 0 else cfg.window_size // 2)
                blk.drop_path = float(dpr[sum(cfg.depths[:s]) + i])
                blk.drop, blk.attn_drop = cfg.drop_rate, cfg.attn_drop_rate
                blocks.append(blk)
            down = PatchMerging(dim, (res, res)) if s < len(cfg.depths) - 1 else None
            stages.append(Stage(blocks, down))
            if down is not None:
                res //= 2
        self.layers = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(cfg.num_features, eps=1e-5)
        self.side = res

    def forward(self, clip: torch.Tensor, generator=None) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed(clip)  # one temporal token: (B, h * w, C)
        b = x.shape[0]
        if self.training:
            x = Drops.draw(1, cfg.drop_rate > 0, generator, x.device)(
                0, x, cfg.drop_rate, self.patch_embed, "out")
        for stage in self.layers:
            for blk in stage.blocks:
                if self.training:
                    keeps = (drop_path_keep(b, blk.drop_path, generator, x.device),
                             drop_path_keep(b, blk.drop_path, generator, x.device))
                    x = blk.train_forward(x, *keeps, drops=blk.draw_drops(generator, x.device))
                else:
                    x = blk(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        x = self.norm(x)
        return x.reshape(b, self.side, self.side, x.shape[-1])


class BaselineDecoder(nn.Module):
    """Five conv3x3 + GroupNorm(32) + ReLU + 2x bilinear stages
    (``decoder_{i}``, align_corners=True) and a conv3x3 to one channel
    (``final_out``): features (B, h, w, C) -> logits (B, 32h, 32w, 1)."""

    def __init__(self, in_ch: int, features: Tuple[int, ...] = (256, 256, 256, 256, 256)):
        super().__init__()
        for i, f in enumerate(features, start=1):
            setattr(self, f"decoder_{i}", ConvGNReLUUp(in_ch, f, groups=32))
            in_ch = f
        self.n = len(features)
        self.final_out = nn.Conv2d(in_ch, 1, 3, padding=1)

    def forward(self, x):
        for i in range(1, self.n + 1):
            x = getattr(self, f"decoder_{i}")(x)
        return conv(self.final_out, x)


class BaselineModel(nn.Module):
    """Single-view encoder + progressive decoder: clip (B, T, H, W, 3) ->
    logits (B, H, W, 1).  Eval mode serves through the ``swin_block`` kernel
    (after ``utils.serving.prepare_for_inference``); train mode trains through
    ``swin_block_train``, its keeps and dropout seeds drawn from the
    ``generator`` given to :meth:`forward` (a ``swin.RowShard`` on a part of a
    split batch)."""

    def __init__(self, cfg: BaselineConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = BaselineEncoder(cfg)
        self.decoder = BaselineDecoder(cfg.num_features, cfg.decoder_features)

    def forward(self, clip: torch.Tensor, generator=None) -> torch.Tensor:
        return self.decoder(self.encoder(clip, generator))


def create_baseline(cfg: BaselineConfig = None) -> BaselineModel:
    """The baseline at ``cfg``, by default the reference's."""
    return BaselineModel(cfg or BaselineConfig())
