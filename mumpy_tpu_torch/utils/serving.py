"""Serving: kernel operands built once, and the clip -> probability forward.

Counterpart of ``mumpy_tpu/utils/serving.py`` on one device.  Activations run
in the parameter dtype: with ``dtype=torch.bfloat16`` the parameters are cast
(as ``test.py --bf16`` casts the JAX params) and the clip is cast to bf16 at
entry, so every kernel reads and writes bf16 and accumulates in f32.  The
probabilities are returned in f32.

The kernel set is an explicit argument: ``"blocks"`` (the JAX package's
default, the whole-block kernels on operands built once) or ``"attention"``
(its ``MUMPY_FUSED_BLOCK=off MUMPY_PALLAS=on``: every layer op by op on live
parameters, only the window-attention core through a kernel, nothing to
prepare); see ``models/swin.py``.
"""

from __future__ import annotations

import torch

from ..models.swin import KERNEL_SETS, KernelSite

__all__ = ["set_kernel_path", "prepare_for_inference", "release_inference_operands",
           "make_serving_forward"]


def set_kernel_path(model: torch.nn.Module, use_kernels: bool,
                    kernel_set: str = "blocks") -> None:
    """Route every kernel site of ``model`` through the CUDA kernels of
    ``kernel_set`` (``"blocks"`` or ``"attention"``) with ``use_kernels``
    True, or through those kernels' plain PyTorch versions with False."""
    if kernel_set not in KERNEL_SETS:
        raise ValueError(f"kernel_set must be one of {KERNEL_SETS}, got {kernel_set!r}")
    for m in model.modules():
        if isinstance(m, KernelSite):
            m.use_kernels = use_kernels
            m.kernel_set = kernel_set


def prepare_for_inference(model: torch.nn.Module) -> torch.nn.Module:
    """Eval mode, and every kernel site's operands built once from the current
    parameters: the weight layouts, the additive mask+bias with its key-pad
    columns at -1e30, the row map of each shifted block (which a stage-2 pair
    led by that block runs through), and the ViT layers' vit3 operands.  Call
    again after moving or casting the model.  The ``"attention"`` set reads
    its live parameters and has nothing to build (as the JAX package's
    ``prepare_for_inference`` on its per-op path)."""
    model.eval()
    release_inference_operands(model)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, KernelSite) and m.kernel_set == "blocks":
                m.prepare()
    return model


def release_inference_operands(model: torch.nn.Module) -> None:
    """Drop every kernel site's operands (a later eval forward needs
    :func:`prepare_for_inference` again); the trainer's val pass builds them
    from the parameters of the moment and frees them after."""
    for m in model.modules():
        if isinstance(m, KernelSite):
            m.__dict__.pop("_ops", None)


def make_serving_forward(model: torch.nn.Module, device, dtype=torch.float32,
                         use_kernels: bool = True, kernel_set: str = "blocks"):
    """Move and cast ``model``, prepare its kernel operands, and return
    ``forward(clip) -> sigmoid(logits)`` (f32, (B, H, W, 1)) under
    ``torch.inference_mode()``.  ``kernel_set`` and ``use_kernels`` pick the
    kernels and the kernel path or the plain path explicitly."""
    model.to(device=device, dtype=dtype)
    set_kernel_path(model, use_kernels, kernel_set)
    prepare_for_inference(model)

    def forward(clip: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            clip = torch.as_tensor(clip).to(device=device, dtype=dtype)
            return torch.sigmoid(model(clip).float())

    return forward
