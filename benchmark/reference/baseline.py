"""The single-view Swin baseline, plainly: a Conv3d tokenizer over the whole
3-frame clip (one temporal token), Swin-B (embed 128, depths (2, 2, 18, 2),
heads (4, 8, 16, 32), window 7, odd blocks shifted by 3 where the grid is
larger than the window), a final LayerNorm, then five conv3x3 + GroupNorm(32)
+ ReLU + 2x bilinear (align_corners) stages and a conv3x3 to one logit.
Drop-path keeps: two per block, drawn block by block before it runs."""

from __future__ import annotations

import functools

import numpy as np

from .context import Ctx
from .layers import conv, conv_gn_relu_up, layer_norm, patch_merge, patch_tokens, swin_block


def forward(ctx: Ctx, P, cfg, clip):
    """clip (B, 3, H, W, 3) -> logits (B, H, W, 1)."""
    if cfg["drop_rate"] or cfg["attn_drop_rate"]:
        raise ValueError("the reference has no dropout")
    b, dev = clip.shape[0], clip.device
    x = patch_tokens(ctx, P, "encoder.patch_embed.proj.", "encoder.patch_embed.norm.", clip,
                     cfg["patch"])
    res = cfg["image_size"] // cfg["patch"][0]
    dpr = [float(r) for r in np.linspace(0.0, cfg["drop_path_rate"], sum(cfg["depths"]))]
    ws = cfg["window_size"]
    for s, depth in enumerate(cfg["depths"]):
        win = min(res, ws)
        for i in range(depth):
            rate = dpr[sum(cfg["depths"][:s]) + i]
            ka, km = ctx.keep(b, rate, dev), ctx.keep(b, rate, dev)
            shift = ws // 2 if (i % 2 and res > ws) else 0
            block = functools.partial(swin_block, ctx, P, f"encoder.layers.{s}.blocks.{i}.",
                                      (res, res), win, shift, cfg["num_heads"][s])
            x = ctx.run(block, x, ka, km)
        if s < len(cfg["depths"]) - 1:
            x = patch_merge(ctx, P, f"encoder.layers.{s}.downsample.", x, (res, res))
            res //= 2
    x = layer_norm(x, P, "encoder.norm.")
    x = x.reshape(b, res, res, x.shape[-1])
    for i in range(1, len(cfg["decoder_features"]) + 1):
        x = conv_gn_relu_up(ctx, P, f"decoder.decoder_{i}.", x, 32)
    return conv(ctx, P, "decoder.final_out.", x, 1)
