"""Multi-pyramid decoder with frequency gating, counterpart of
``mumpy_tpu/models/decoder.py`` (plain PyTorch, no kernels).

Tensors are channels-last (B, H, W, C) between layers, as in the JAX package;
each convolution and GroupNorm runs on the NCHW view ``x.permute(0, 3, 1, 2)``
of that memory (channels_last strides, no copy).  Module names follow the
reference state_dict (``rgb_decoder_{s}.0``, ``decoder_frequency_{i}.1``,
``gcm{g}.conv_l1``, ``seb{i}.conv``, ``decoder_{i}.0``, ``final_out``).
Bilinear upsampling uses ``align_corners=True`` in the main chain and
``False`` for SEB and the skip upsamples, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import MumpyConfig
from ..ops.pixel import avg_pool_2d, dap_pool, pixel_shuffle
from ..ops.resize import upsample_2d
from .encoder import merge_views_along_channel_axis

__all__ = ["TemporalSqueeze", "FreqGate", "GlobalConvModule", "SEB", "ConvGNReLUUp",
           "MumpyDecoder"]


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW layer (conv, GroupNorm) to a channels-last tensor."""
    return nhwc(layer(nchw(x)))


class TemporalSqueeze(nn.Sequential):
    """Conv3d(kernel = stride = (T, 1, 1)) + GroupNorm(16) + ReLU over the
    views merged along channels and tiled to T along time."""

    def __init__(self, in_ch: int, out_ch: int, t: int, height: int):
        super().__init__(nn.Conv3d(in_ch, out_ch, (t, 1, 1)), nn.GroupNorm(16, out_ch))
        self.height = height

    def forward(self, views, temporal_dims):
        x = merge_views_along_channel_axis(views, temporal_dims)  # (B, T, n, C)
        b, _, n, _ = x.shape
        w = self[0].weight[..., 0, 0]  # (O, C, T)
        y = torch.einsum("btnc,oct->bno", x, w) + self[0].bias
        y = y.reshape(b, self.height, n // self.height, -1)
        return F.relu(conv(self[1], y))


class FreqGate(nn.Sequential):
    """AvgPool2 + conv3x3 + GroupNorm + Sigmoid."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 8):
        super().__init__(nn.AvgPool2d(2), nn.Conv2d(in_ch, out_ch, 3, padding=1),
                         nn.GroupNorm(groups, out_ch))

    def forward(self, x):
        return torch.sigmoid(conv(self[2], conv(self[1], avg_pool_2d(x, 2))))


class GlobalConvModule(nn.Module):
    """Separable large-kernel conv pair: (k,1)->(1,k) plus (1,k)->(k,1)."""

    def __init__(self, in_ch: int, out_ch: int, k: int):
        super().__init__()
        p = k // 2
        self.conv_l1 = nn.Conv2d(in_ch, out_ch, (k, 1), padding=(p, 0))
        self.conv_l2 = nn.Conv2d(out_ch, out_ch, (1, k), padding=(0, p))
        self.conv_r1 = nn.Conv2d(in_ch, out_ch, (1, k), padding=(0, p))
        self.conv_r2 = nn.Conv2d(out_ch, out_ch, (k, 1), padding=(p, 0))

    def forward(self, x):
        x = nchw(x)
        return nhwc(self.conv_l2(self.conv_l1(x)) + self.conv_r2(self.conv_r1(x)))


class SEB(nn.Module):
    """Semantic enhancement: ``x1 * upsample(conv(x2))``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)

    def forward(self, x1, x2):
        return x1 * upsample_2d(conv(self.conv, x2), 2, align_corners=False)


class ConvGNReLUUp(nn.Sequential):
    """conv3x3 + GroupNorm(``groups``: 8 in the flagship, 32 in the
    baseline) + ReLU + 2x bilinear (align_corners=True)."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 8):
        super().__init__(nn.Conv2d(in_ch, out_ch, 3, padding=1), nn.GroupNorm(groups, out_ch))

    def forward(self, x):
        x = F.relu(conv(self[1], conv(self[0], x)))
        return upsample_2d(x, 2, align_corners=True)


class MumpyDecoder(nn.Module):
    """Fuses the 4-scale view pyramid, the global features and the frequency
    gates into a full-resolution logit map (B, H, W, 1)."""

    def __init__(self, cfg: MumpyConfig):
        super().__init__()
        self.cfg = cfg
        nc, k2 = cfg.decoder_num_classes, cfg.decoder_dap_k ** 2
        feats = cfg.decoder_features
        ks = cfg.decoder_kernel_size
        t = max(cfg.input_token_temporal_dims)
        for s in range(4):
            setattr(self, f"rgb_decoder_{s + 1}", TemporalSqueeze(
                cfg.merged_channels[s], feats[s], t, cfg.stage_shapes[s]))
        freq_io = [(9, nc * k2), (nc * k2, nc * k2), (nc * k2, nc * k2), (nc * k2, nc),
                   (nc, nc * k2)]
        for i, (ci, co) in enumerate(freq_io):
            setattr(self, f"decoder_frequency_{i}", FreqGate(ci, co, 4 if i == 3 else 8))
        gcm_io = [(feats[-1] + cfg.encoder_out_channels, nc * 4), (feats[-2], nc),
                  (feats[-3], nc * k2), (feats[-4], nc * k2)]
        for g, (ci, co) in enumerate(gcm_io, start=1):
            setattr(self, f"gcm{g}", GlobalConvModule(ci, co, ks))
        seb_io = [(feats[-1], feats[-2]), (feats[-2] + feats[-1], feats[-3]),
                  (feats[-3] + feats[-2] + feats[-1], feats[-4])]
        for i, (ci, co) in enumerate(seb_io, start=1):
            setattr(self, f"seb{i}", SEB(ci, co))
        for i, ci in enumerate((nc, nc * k2, nc * k2, nc * k2), start=2):
            setattr(self, f"decoder_{i}", ConvGNReLUUp(ci, nc * k2))
        self.final_out = nn.Conv2d(nc, 1, 3, padding=1)

    def forward(self, x, view_x, ffinfo):
        cfg = self.cfg
        tdims = cfg.input_token_temporal_dims
        rgb1, rgb2, rgb3, rgb4 = (getattr(self, f"rgb_decoder_{s + 1}")(view_x[s], tdims)
                                  for s in range(4))
        freq = []
        f = ffinfo
        for i in range(5):
            f = getattr(self, f"decoder_frequency_{i}")(f)
            freq.append(f)
        freq0, freq1, freq2, freq3, freq4 = freq

        gcn0 = self.gcm1(torch.cat([rgb4, x], dim=-1))
        out1 = pixel_shuffle(gcn0 * freq4, 2)
        gcn1 = self.gcm2(self.seb1(rgb3, rgb4))
        seb2 = self.seb2(rgb2, torch.cat([rgb3, upsample_2d(rgb4, 2)], dim=-1))
        gcn2 = self.gcm3(seb2)
        seb3 = self.seb3(rgb1, torch.cat([rgb2, upsample_2d(rgb3, 2),
                                          upsample_2d(rgb4, 4)], dim=-1))
        gcn3 = self.gcm4(seb3)

        y = self.decoder_2(gcn1 * freq3 + out1)
        y = self.decoder_3(y + gcn2 * freq2)
        y = self.decoder_4(y + gcn3 * freq1)
        y = self.decoder_5(y * freq0)
        y = dap_pool(y, cfg.decoder_dap_k)
        return conv(self.final_out, y)
