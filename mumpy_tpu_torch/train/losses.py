"""Training losses: soft-IoU + focal, counterpart of
``mumpy_tpu/train/losses.py``.  Both take targets and logits flattened per
sample, (B, N); the trainer passes f32 logits."""

from __future__ import annotations

import torch

__all__ = ["soft_iou_loss", "focal_loss", "total_loss"]


def soft_iou_loss(targets: torch.Tensor, logits: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """1 - soft IoU of the sigmoided logits, averaged over the batch."""
    out = torch.sigmoid(logits)
    num = (out * targets).sum(-1)
    den = (out + targets - out * targets).sum(-1) + eps
    return (1.0 - num / den).mean()


def focal_loss(targets: torch.Tensor, logits: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal-modulated BCE with logits; the reference's class weights are
    [1, 1], so none are applied."""
    bce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    pt = torch.exp(-bce)
    return ((1.0 - pt) ** gamma * bce).mean()


def total_loss(targets: torch.Tensor, logits: torch.Tensor):
    """Mean soft IoU + mean focal: returns (loss, (iou_term, focal_term))."""
    iou = soft_iou_loss(targets, logits)
    foc = focal_loss(targets, logits)
    return iou + foc, (iou, foc)
