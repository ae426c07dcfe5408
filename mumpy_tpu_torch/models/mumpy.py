"""The full Mumpy model: encoder + decoder, counterpart of
``mumpy_tpu/models/mumpy.py``.  ``encoder`` and ``decoder`` hold the reference's
two state_dicts (``encoder_{e}.pt`` / ``decoder_{e}.pt``) under their own
names."""

from __future__ import annotations

import torch
from torch import nn

from ..configs import MumpyConfig
from .decoder import MumpyDecoder
from .encoder import MumpyEncoder

__all__ = ["Mumpy"]


class Mumpy(nn.Module):
    """Eval mode serves through the serving kernels (after
    ``utils.serving.prepare_for_inference``); train mode (``model.train()``)
    runs the training path on the live parameters, its drop-path keep
    factors and dropout seeds drawn from the ``generator`` given to
    :meth:`forward`."""

    def __init__(self, cfg: MumpyConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = MumpyEncoder(cfg)
        self.decoder = MumpyDecoder(cfg)

    def forward(self, clip: torch.Tensor, generator=None) -> torch.Tensor:
        """clip (B, T, H, W, 3) normalised frames -> logits (B, H, W, 1)."""
        feats, view_x, ffinfo = self.encoder(clip, generator)
        return self.decoder(feats, view_x, ffinfo)
