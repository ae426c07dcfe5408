"""Model configurations of the port: the fields of
``mumpy_tpu/configs/model_config.py`` that serving and training read, value
for value, as frozen dataclasses.  The port has no scan, so the JAX
package's ``train_scan_unroll`` (a TPU scan option) has no counterpart;
every other field is here.  Dropout rates above 0 turn off the training
kernels that the JAX package turns off at them (``models/dropout.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

__all__ = ["ViewConfig", "GlobalEncoderConfig", "MumpyConfig", "multiswin_config",
           "mid_config", "tiny_config", "CVA_KINDS", "REMAT_POLICIES"]

CVA_KINDS = ("deformable", "window")
REMAT_POLICIES = ("full", "dots")


@dataclasses.dataclass(frozen=True)
class ViewConfig:
    """One temporal view of the multilateral encoder."""

    hidden_size: Tuple[int, int, int, int]
    patch_size: Tuple[int, int, int]  # (ph, pw, pt)
    depths: Tuple[int, int, int, int]
    num_heads: Tuple[int, int, int, int]
    mlp_dim: int
    num_frames: int
    input_resolution: Tuple[Tuple[int, int], ...]
    temporal_dim: int  # temporal tokens after patchify
    window_size: int = 7


@dataclasses.dataclass(frozen=True)
class GlobalEncoderConfig:
    """Global temporal ViT over per-token temporal slices."""

    num_heads: int = 12
    mlp_dim: int = 3072
    num_layers: int = 12
    hidden_size: int = 768
    num_frames: int = 3


@dataclasses.dataclass(frozen=True)
class MumpyConfig:
    views: Tuple[ViewConfig, ...]
    global_encoder: GlobalEncoderConfig
    input_token_temporal_dims: Tuple[int, ...] = (1, 1, 3)
    image_size: int = 224
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.2
    # the cross-view attention: "deformable" (the published model) or
    # "window" (softmax window cross-attention, ``models/deformable.py``)
    cva_kind: str = "deformable"
    # recompute each plain-block pair in the backward (torch.utils.checkpoint),
    # as the JAX package remats its scanned pair bodies: "full" recomputes
    # everything, "dots" keeps the outputs of the matrix products without
    # batch dims and recomputes the rest
    remat: bool = True
    remat_policy: str = "full"
    decoder_num_classes: int = 32
    decoder_dap_k: int = 2
    decoder_features: Tuple[int, ...] = (256, 256, 256, 256, 256)
    decoder_kernel_size: int = 7

    def __post_init__(self):
        if self.cva_kind not in CVA_KINDS:
            raise ValueError(f"cva_kind must be one of {CVA_KINDS}, got {self.cva_kind!r}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {self.remat_policy!r}")

    @property
    def stage_shapes(self) -> Sequence[int]:
        return [r[0] for r in self.views[0].input_resolution]

    @property
    def merged_channels(self) -> Sequence[int]:
        """Per-stage channel count after merging the three views."""
        return [sum(v.hidden_size[s] for v in self.views) for s in range(4)]

    @property
    def encoder_out_channels(self) -> int:
        return self.global_encoder.hidden_size * self.global_encoder.num_frames


def _resolutions(image_size: int):
    return tuple((image_size // 4 // (2**s), image_size // 4 // (2**s)) for s in range(4))


def multiswin_config(image_size: int = 224, drop_path_rate: float = 0.2) -> MumpyConfig:
    """The published three-view architecture: temporal patchify strides
    (3, 2, 1) over a 3-frame clip, the 56/28/14/7 pyramid at 224^2."""
    res = _resolutions(image_size)
    views = (
        ViewConfig((96, 192, 384, 768), (4, 4, 3), (2, 2, 6, 2), (3, 6, 12, 24),
                   768, 1, res, 1),
        ViewConfig((96, 192, 384, 768), (4, 4, 2), (2, 2, 18, 2), (3, 6, 12, 24),
                   1536, 1, res, 1),
        ViewConfig((128, 256, 512, 1024), (4, 4, 1), (2, 2, 18, 2), (4, 8, 16, 32),
                   3072, 3, res, 3),
    )
    return MumpyConfig(views=views, global_encoder=GlobalEncoderConfig(),
                       image_size=image_size, drop_path_rate=drop_path_rate)


def mid_config(image_size: int = 64) -> MumpyConfig:
    """The flagship's widths, depths and heads on a smaller grid: window 4
    divides the 16/8/4/2 pyramid of 64^2; drop-path 0."""
    res = _resolutions(image_size)
    views = (
        ViewConfig((96, 192, 384, 768), (4, 4, 3), (2, 2, 6, 2), (3, 6, 12, 24),
                   768, 1, res, 1, window_size=4),
        ViewConfig((96, 192, 384, 768), (4, 4, 2), (2, 2, 18, 2), (3, 6, 12, 24),
                   1536, 1, res, 1, window_size=4),
        ViewConfig((128, 256, 512, 1024), (4, 4, 1), (2, 2, 18, 2), (4, 8, 16, 32),
                   3072, 3, res, 3, window_size=4),
    )
    return MumpyConfig(views=views, global_encoder=GlobalEncoderConfig(),
                       image_size=image_size, drop_path_rate=0.0)


def tiny_config(image_size: int = 32) -> MumpyConfig:
    """The same topology at test size: window 4, narrow widths, stage-3
    depth 4, a 2-layer global ViT at 32."""
    res = _resolutions(image_size)
    views = (
        ViewConfig((12, 24, 48, 96), (4, 4, 3), (1, 1, 4, 1), (3, 3, 6, 6),
                   48, 1, res, 1, window_size=4),
        ViewConfig((12, 24, 48, 96), (4, 4, 2), (1, 1, 4, 1), (3, 3, 6, 6),
                   96, 1, res, 1, window_size=4),
        ViewConfig((24, 48, 96, 192), (4, 4, 1), (1, 1, 4, 1), (6, 6, 12, 12),
                   192, 3, res, 3, window_size=4),
    )
    ge = GlobalEncoderConfig(num_heads=4, mlp_dim=64, num_layers=2, hidden_size=32)
    return MumpyConfig(views=views, global_encoder=ge, image_size=image_size,
                       drop_path_rate=0.0, decoder_num_classes=8)
