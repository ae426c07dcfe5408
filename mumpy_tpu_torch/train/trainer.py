"""Training loop and steps, counterpart of ``mumpy_tpu/train/trainer.py``: the train
and val steps and the reference's epoch loop.

* ``train_step``: the loss (mean soft IoU + mean focal, on f32 logits
  flattened per sample) of one batch through the model in train mode, its
  backward and one optimizer step.  With ``compute_dtype=torch.bfloat16`` the
  f32 master parameters are cast to bf16 for the forward and backward, as the
  JAX package does (``torch.func.functional_call`` with the cast tensors:
  every parameter and the clip are bf16, unlike ``torch.autocast``, which
  casts only some operations); the cast is differentiable, so the gradients
  reach the f32 parameters.
* ``val_step``: the loss in eval mode through the serving kernels, whose
  operands are built from the (cast) parameters for the pass and dropped
  after it.
* ``train_loop``: per-epoch train and val passes, smoothed val metric,
  best-checkpoint saves (``mumpy_tpu_torch.serve`` serves the latest
  checkpoint, or one by epoch), patience with a best-checkpoint reload that
  fires at most once, forced saves at ``max_epoch // 2 - 1`` and
  ``max_epoch - 1``, and scalars every ``print_every`` steps.

uint8 batches are normalised on the device.  Drop-path draws come from one
``torch.Generator`` on the model's device, seeded from ``TrainLoopConfig.seed``.

Data parallel (``TrainState.dist`` from ``parallel.init_from_env`` under
``torchrun``): each rank steps on its rows of the global batch; the
drop-path keeps are the global batch's, each rank keeping its rows
(``models.swin.RowShard``; the cross-view attention also reads the other
ranks' query windows); ``train_step`` averages the gradients
over the ranks between the backward and the optimizer step (the parameters
are cast for the forward by ``functional_call``, which a DDP wrapper's
forward and reducer would not see); the loss terms are averaged over the
ranks when they are fetched (every ``print_every`` steps), the val metric
before the best, patience and reload decisions, so every rank takes the
same branch; only rank 0 writes checkpoints, ``metrics.jsonl`` and
TensorBoard, and every rank waits for its writes at a barrier before it
reads a checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from ..data import MEAN, STD
from ..models.swin import RowShard
from ..parallel.dist import (Dist, all_reduce_mean, broadcast_object, broadcast_tensors,
                              gather_rows)
from ..utils.serving import prepare_for_inference, release_inference_operands
from . import checkpoint as ckpt_lib
from .losses import total_loss
from .optim import Optimizer

__all__ = ["TrainLoopConfig", "TrainState", "train_step", "val_step", "MetricsWriter",
           "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    model_name: str = "mumpy"
    results_dir: str = "results"
    max_epoch: int = 100
    accumulation_steps: int = 1
    patience: int = 15
    min_delta: float = 0.0
    best_val_loss: float = 1000.0
    smooth_curves: bool = True
    patience_reload: bool = True  # off with -finetune_after -1
    compute_dtype: str = "f32"  # "f32" or "bf16" (f32 master parameters)
    print_every: int = 10
    image_every: int = 200  # prediction / mask grids to TensorBoard
    seed: int = 282845927


class TrainState:
    """The model (f32 master parameters), its optimizer, the step count and
    the process's place in a data-parallel run (``dist``; default: one
    process)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, step: int = 0,
                 dist: Dist = Dist()):
        self.model, self.optimizer, self.step, self.dist = model, optimizer, step, dist

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])

    def broadcast(self) -> None:
        """Rank 0's parameters, buffers, optimizer state and counts on every
        rank (after a load).  Raises where a rank's state is laid out
        otherwise than rank 0's."""
        opt = self.optimizer
        named = sorted(self.model.state_dict().items())
        named += sorted((f"acc.{n}", t) for n, t in opt.acc.items())
        named += sorted((f"buffers.{n}.{k}", t) for n, b in opt.buffers.items()
                        for k, t in b.items())
        layout = [(n, tuple(t.shape), str(t.dtype)) for n, t in named]
        if broadcast_object(layout, self.dist) != layout:
            raise RuntimeError(f"rank {self.dist.rank}'s training state differs in layout "
                               "from rank 0's")
        broadcast_tensors([t for _, t in named], self.dist)
        self.step, opt.count, opt.mini_step = broadcast_object(
            (self.step, opt.count, opt.mini_step), self.dist)


class _EvalForward(torch.nn.Module):
    """Eval forward that first builds the serving kernels' operands from the
    parameters it runs with (under ``functional_call``, the cast ones)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, clip, generator=None):
        prepare_for_inference(self.model)
        return self.model(clip, generator)


def _device_batch(batch: dict, device, compute_dtype):
    image = torch.as_tensor(batch["image"]).to(device, non_blocking=True)
    if image.dtype == torch.uint8:  # normalised here, on the device
        mean = torch.tensor(MEAN, device=device)
        std = torch.tensor(STD, device=device)
        image = (image.float() / 255.0 - mean) / std
    if compute_dtype is not None:
        image = image.to(compute_dtype)
    return image, torch.as_tensor(batch["mask"]).to(device, non_blocking=True).float()


def _loss_for_batch(model, batch, generator, train: bool, compute_dtype=None):
    image, mask = _device_batch(batch, next(model.parameters()).device, compute_dtype)
    params = {n: p if compute_dtype is None or not p.is_floating_point() else p.to(compute_dtype)
              for n, p in model.named_parameters()}
    if train:
        model.train()
        logits = functional_call(model, params, (image,), {"generator": generator})
    else:
        logits = functional_call(_EvalForward(model), {f"model.{n}": p for n, p in params.items()},
                                 (image,), {"generator": generator})
        release_inference_operands(model)
    logits = logits.float()
    b = logits.shape[0]
    loss, (iou, foc) = total_loss(mask.reshape(b, -1), logits.reshape(b, -1))
    return loss, (iou, foc, logits)


def _part_of_batch(dist: Dist, generator):
    """What the model draws from and gathers through: under data
    parallelism this rank's part of the global batch, else ``generator``."""
    if dist.world == 1:
        return generator
    return RowShard(dist.world, dist.rank, lambda x: gather_rows(x, dist), generator)


def train_step(state: TrainState, batch: dict, generator: torch.Generator,
               compute_dtype=None) -> dict:
    """One optimization step on ``batch`` ({"image": (kB, T, H, W, 3), "mask":
    (kB, H*W)}: under data parallelism this rank's rows of the global
    batch); returns this batch's loss terms and sigmoid predictions, on the
    device.  The gradients are averaged over the ranks before the update."""
    generator = _part_of_batch(state.dist, generator)
    state.optimizer.zero_grad()
    loss, (iou, foc, logits) = _loss_for_batch(state.model, batch, generator, True,
                                               compute_dtype)
    loss.backward()
    all_reduce_mean([p.grad for p in state.model.parameters() if p.grad is not None],
                    state.dist)
    state.optimizer.step()
    state.step += 1
    return {"total": loss.detach(), "iou": iou.detach(), "focal": foc.detach(),
            "preds": torch.sigmoid(logits.detach())[..., 0]}


@torch.no_grad()
def val_step(state: TrainState, batch: dict, compute_dtype=None) -> dict:
    loss, (iou, foc, _) = _loss_for_batch(state.model, batch, _part_of_batch(state.dist, None),
                                          False, compute_dtype)
    return {"total": loss, "iou": iou, "focal": foc}


class MetricsWriter:
    """JSONL metrics plus optional TensorBoard scalars and image grids
    (``tensorboardX``, when installed), as the JAX package writes them."""

    def __init__(self, model_dir: str, use_tensorboard: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self.tb = SummaryWriter(model_dir)
            except Exception:
                self.tb = None

    def write(self, step: int, split: str, scalars: dict):
        rec = {"step": step, "split": split, **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{split}/{k}", float(v), step)

    def write_image_grid(self, tag: str, images, step: int, nrow: int = 8, padding: int = 2):
        """(B, H, W) images tiled into one grid, each min-max scaled to [0, 1]
        (``make_grid(normalize=True, scale_each=True)``)."""
        if self.tb is None:
            return
        imgs = np.asarray(images, dtype=np.float32)
        b, h, w = imgs.shape
        lo = imgs.min(axis=(1, 2), keepdims=True)
        hi = imgs.max(axis=(1, 2), keepdims=True)
        imgs = (imgs - lo) / np.maximum(hi - lo, 1e-5)
        ncol = min(nrow, b)
        nr = -(-b // ncol)
        grid = np.zeros((nr * (h + padding) + padding, ncol * (w + padding) + padding),
                        np.float32)
        for i in range(b):
            r, c = divmod(i, ncol)
            y0, x0 = padding + r * (h + padding), padding + c * (w + padding)
            grid[y0:y0 + h, x0:x0 + w] = imgs[i]
        self.tb.add_image(tag, grid[None], step)

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


class _NoWriter:
    """The writer of a rank other than 0: it writes nothing."""

    tb = None

    def write(self, *args, **kwargs):
        pass

    def write_image_grid(self, *args, **kwargs):
        pass

    def close(self):
        pass


def train_loop(state: TrainState, loaders: dict, loop_cfg: TrainLoopConfig,
               max_steps_per_epoch: Optional[int] = None) -> TrainState:
    """The reference's epoch loop.  ``loaders`` maps "train" / "val" to a
    callable returning an iterator of host batches (this rank's rows)."""
    cdtype = torch.bfloat16 if loop_cfg.compute_dtype == "bf16" else None
    model_dir = os.path.join(loop_cfg.results_dir, loop_cfg.model_name)
    dist = getattr(state, "dist", Dist())  # a state with no dist trains in one process
    writer = MetricsWriter(model_dir) if dist.is_main else _NoWriter()
    say = print if dist.is_main else (lambda *args, **kwargs: None)
    generator = torch.Generator(device=state.device).manual_seed(loop_cfg.seed)
    saver = ckpt_lib.AsyncSaver()

    def save(e):  # every rank holds the same state: rank 0 writes it
        if dist.is_main:
            saver.save(model_dir, state.state_dict(), e, extra={"best_val_loss": best_val_loss})

    def sync():  # rank 0's writes done, on every rank: any rank may read them
        saver.wait()
        dist.barrier()

    best_val_loss = loop_cfg.best_val_loss
    acc_patience = 0
    reload_fired = False  # the reference reloads the best checkpoint at most once
    mt_val = -1.0
    tstep = 0
    t0 = time.time()
    for e in range(loop_cfg.max_epoch):
        epoch_losses = {"train": [], "val": []}
        mt = None  # the val metric that drives best / patience
        te0 = time.time()
        epoch_clips = 0
        for split in ("train", "val"):
            pending = []  # (step, {name: device scalar}), fetched every print_every

            def flush():
                """Fetch the pending loss terms, averaged over the ranks (one
                collective for the lot)."""
                if not pending:
                    return
                names = list(pending[0][1])
                terms = torch.stack([torch.stack([torch.as_tensor(sc[k]).float() for k in names])
                                     for _, sc in pending])
                all_reduce_mean([terms], dist)
                for (ts, _), row in zip(pending, terms.tolist()):
                    sc = dict(zip(names, row))
                    if split == "train":
                        writer.write(ts, "train", sc)
                        writer.write(ts, "lr", state.optimizer.lrs(ts))
                    epoch_losses[split].append(sc["total"])
                pending.clear()

            try:
                for i, batch in enumerate(loaders[split]()):
                    if max_steps_per_epoch and i >= max_steps_per_epoch:
                        break
                    if split == "train":
                        epoch_clips += int(batch["image"].shape[0]) * dist.world
                        m = train_step(state, batch, generator, cdtype)
                        preds = m.pop("preds", None)
                        pending.append((tstep, m))
                        if (preds is not None and writer.tb is not None
                                and tstep % loop_cfg.image_every == 0):
                            hw = int(np.sqrt(np.asarray(batch["mask"]).shape[-1]))
                            writer.write_image_grid("prediction", preds.float().cpu().numpy(),
                                                    tstep)
                            writer.write_image_grid(
                                "masks", np.asarray(batch["mask"]).reshape(-1, hw, hw), tstep)
                        tstep += 1
                    else:
                        pending.append((i, val_step(state, batch, cdtype)))
                    if (i + 1) % loop_cfg.print_every == 0:
                        flush()
                        say(f"epoch {e} {split} iter {i}: total "
                              f"{np.mean(epoch_losses[split]):.4f} ({time.time() - t0:.1f}s)",
                              flush=True)
            finally:
                flush()
            if not epoch_losses[split]:
                if split == "val":
                    say(f"Epoch {e}: val loader produced no batches — skipping "
                          "best/patience bookkeeping this epoch")
                continue
            if split == "val":
                m_now = float(np.mean(epoch_losses["val"]))
                if loop_cfg.smooth_curves:
                    mt = m_now if mt_val < 0 else 0.9 * mt_val + 0.1 * m_now
                    mt_val = mt
                else:
                    mt = m_now
                split_mean = mt
            else:
                split_mean = float(np.mean(epoch_losses[split]))
            writer.write(e, f"epoch_{split}", {"total": split_mean})
            say(f"Epoch {e}: total {split_mean:.4f} ({split})", flush=True)
            if split == "train" and epoch_clips:
                dt = time.time() - te0
                say(f"Epoch {e}: train wall {dt:.1f}s, "
                      f"{epoch_clips / dt:.1f} stream-clips/s end-to-end", flush=True)
                writer.write(e, "epoch_wall", {"seconds": dt, "clips_per_s": epoch_clips / dt})

        if mt is None:
            continue
        if mt < best_val_loss - loop_cfg.min_delta:
            best_val_loss = mt
            save(e)
            acc_patience = 0
        else:
            acc_patience += 1
            if (acc_patience > loop_cfg.patience and loop_cfg.patience_reload
                    and not reload_fired):
                reload_fired = True
                sync()  # rank 0's best save may still be writing
                restored = ckpt_lib.load_latest(model_dir)
                if restored is not None:
                    state.load_state_dict(restored)
                acc_patience = 0
                best_val_loss = 1000.0
                mt_val = -1.0
        if e == loop_cfg.max_epoch // 2 - 1 or e == loop_cfg.max_epoch - 1:
            save(e)

    sync()
    writer.close()
    return state
