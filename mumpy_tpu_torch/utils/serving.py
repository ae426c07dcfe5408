"""Serving: kernel operands built once, and the clip -> probability forward.

Counterpart of ``mumpy_tpu/utils/serving.py`` on one device.  Activations run
in the parameter dtype: with ``dtype=torch.bfloat16`` the parameters are cast
(as ``test.py --bf16`` casts the JAX params) and the clip is cast to bf16 at
entry, so every kernel reads and writes bf16 and accumulates in f32.  The
probabilities are returned in f32.
"""

from __future__ import annotations

import torch

from ..models.swin import KernelSite

__all__ = ["set_kernel_path", "prepare_for_inference", "make_serving_forward"]


def set_kernel_path(model: torch.nn.Module, use_kernels: bool) -> None:
    """Route every kernel site of ``model`` through its CUDA kernel (True) or
    through the kernel's plain PyTorch version (False)."""
    for m in model.modules():
        if isinstance(m, KernelSite):
            m.use_kernels = use_kernels


def prepare_for_inference(model: torch.nn.Module) -> torch.nn.Module:
    """Eval mode, and every kernel site's operands built once from the current
    parameters: the weight layouts, the additive mask+bias with its key-pad
    columns at -1e30, the row map of each shifted block (which a stage-2 pair
    led by that block runs through), and the ViT layers' vit3 operands.  Call
    again after moving or casting the model."""
    model.eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, KernelSite):
                m.prepare()
    return model


def make_serving_forward(model: torch.nn.Module, device, dtype=torch.float32,
                         use_kernels: bool = True):
    """Move and cast ``model``, prepare its kernel operands, and return
    ``forward(clip) -> sigmoid(logits)`` (f32, (B, H, W, 1)) under
    ``torch.inference_mode()``.  ``use_kernels`` picks the kernel path or the
    plain path explicitly."""
    model.to(device=device, dtype=dtype)
    set_kernel_path(model, use_kernels)
    prepare_for_inference(model)

    def forward(clip: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            clip = torch.as_tensor(clip).to(device=device, dtype=dtype)
            return torch.sigmoid(model(clip).float())

    return forward
