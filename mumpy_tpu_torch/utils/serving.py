"""Serving: kernel operands built once, and the clip -> probability forward.

Counterpart of ``mumpy_tpu/utils/serving.py``, on one device or split over
several: as the JAX package's ``shard_map`` splits a batch over its mesh,
each device holds a replica of the model and runs a contiguous slice of the
batch, from a host thread of its own (one process, as JAX serves from one).
One operation reads across clips: the view-2 <- view-3 cross-view attention
pairs partner window j of the batch with query window j % B1 of the batch
(the reference's ``repeat`` tiling).  There the replicas hand each other
their query windows, so that the split computes the one-device forward's
function (``shard_map``, which does not, gives each device's slice a
forward of its own).  Activations run
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

import concurrent.futures
import contextlib
import copy
import functools
import threading
from typing import Sequence

import torch

from ..models.swin import KERNEL_SETS, KernelSite, RowShard

__all__ = ["set_kernel_path", "prepare_for_inference", "release_inference_operands",
           "make_serving_forward", "SplitForward"]


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
    kernels and the kernel path or the plain path explicitly.  ``device`` is
    one device, or a list of them to split each batch over (a
    :class:`SplitForward`, whose ``close()`` stops its threads; a list of one
    is the one-device forward)."""
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            return SplitForward(model, device, dtype, use_kernels, kernel_set)
        device = device[0]
    model.to(device=device, dtype=dtype)
    set_kernel_path(model, use_kernels, kernel_set)
    prepare_for_inference(model)

    def forward(clip: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            clip = torch.as_tensor(clip).to(device=device, dtype=dtype)
            return torch.sigmoid(model(clip).float())

    return forward


class _Exchange:
    """Rows handed between the replicas' threads: each posts its part, waits
    for the others, and copies every part to its own device, in part order.
    A thread that fails breaks the barrier, and the others raise at it."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.parts = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def gather(self, i: int, x: torch.Tensor) -> torch.Tensor:
        self.parts[i] = x
        self.barrier.wait()
        everyone = torch.cat([part.to(x.device) for part in self.parts])
        self.barrier.wait()  # every part is copied before a slot is posted again
        return everyone


class SplitForward:
    """The serving forward split over ``devices``: one replica of the model
    on each (moved, cast and prepared there; ``model`` itself becomes the
    first), and one persistent host thread per device.  A batch of B clips
    (B a multiple of the device count) is cut into contiguous slices, as
    ``shard_map`` cuts it; each thread enters ``torch.cuda.device`` of its
    card and ``torch.inference_mode()`` itself (both are per thread), so the
    kernels launch on that card's current stream, and the probabilities are
    gathered in batch order on the first device.  Each replica runs its
    slice as part i of a :class:`RowShard`, whose ``gather`` hands the
    cross-view attention's query windows between the threads.  A device may
    appear twice (two replicas on one card, in two threads)."""

    def __init__(self, model: torch.nn.Module, devices: Sequence, dtype=torch.float32,
                 use_kernels: bool = True, kernel_set: str = "blocks"):
        self.devices = [torch.device(d) for d in devices]
        self.dtype = dtype
        release_inference_operands(model)
        self.replicas = [model] + [copy.deepcopy(model) for _ in self.devices[1:]]
        for replica, dev in zip(self.replicas, self.devices):
            replica.to(device=dev, dtype=dtype)
            set_kernel_path(replica, use_kernels, kernel_set)
            prepare_for_inference(replica)
        self.exchange = _Exchange(len(self.devices))
        self.threads = [concurrent.futures.ThreadPoolExecutor(1, f"serve-{i}-{dev}")
                        for i, dev in enumerate(self.devices)]

    def _run(self, i: int, clip: torch.Tensor) -> torch.Tensor:
        dev = self.devices[i]
        part = RowShard(len(self.devices), i, functools.partial(self.exchange.gather, i))
        on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        try:
            with on_card, torch.inference_mode():
                x = clip.to(device=dev, dtype=self.dtype)
                return torch.sigmoid(self.replicas[i](x, part).float())
        except BaseException:
            self.exchange.barrier.abort()  # release the replicas waiting for this one
            raise

    def __call__(self, clip: torch.Tensor) -> torch.Tensor:
        clip = torch.as_tensor(clip)
        n = len(self.devices)
        if clip.shape[0] % n:
            raise ValueError(f"a batch of {clip.shape[0]} does not split over {n} devices")
        k = clip.shape[0] // n
        futures = [pool.submit(self._run, i, clip[i * k:(i + 1) * k])
                   for i, pool in enumerate(self.threads)]
        concurrent.futures.wait(futures)
        errors = [f.exception() for f in futures if f.exception() is not None]
        if errors:
            self.exchange.barrier.reset()
            # the failure itself, not a replica released from the barrier by it
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        with torch.inference_mode():
            return torch.cat([f.result().to(self.devices[0]) for f in futures])

    def close(self) -> None:
        for pool in self.threads:
            pool.shutdown(wait=True)
