"""Epoch-tagged checkpoints, counterpart of ``mumpy_tpu/train/checkpoint.py``.

One torch ``.pt`` file per epoch, ``<model_dir>/ckpt_<epoch>.pt``, holds the
model's state_dict, the optimizer's state, the step, the epoch and an
``extra`` record; ``meta_<epoch>.json`` is written after it, so a meta file
implies a complete checkpoint.  The file is written under a temporary name
and renamed, so a reader never sees half of one.

:class:`AsyncSaver` takes CPU copies of the state on the caller's thread
(before the next step changes the parameters) and writes them on one
background thread; at most one save is in flight.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Optional

import torch

__all__ = ["save", "available_epochs", "load_epoch", "load_latest", "AsyncSaver",
           "snapshot"]


def _ckpt_path(model_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(model_dir), f"ckpt_{epoch}.pt")


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def snapshot(state: dict) -> dict:
    """CPU copies of every tensor in a (nested) state."""
    if isinstance(state, dict):
        return {k: snapshot(v) for k, v in state.items()}
    if torch.is_tensor(state):
        return state.detach().to("cpu", copy=True)
    return state


def _write(model_dir: str, state: dict, epoch: int, extra: Optional[dict]) -> None:
    os.makedirs(model_dir, exist_ok=True)
    _atomic_save({**state, "epoch": epoch, "extra": extra or {}},
                 _ckpt_path(model_dir, epoch))
    with open(os.path.join(model_dir, f"meta_{epoch}.json"), "w") as f:
        json.dump({"epoch": epoch, **(extra or {})}, f)


def save(model_dir: str, state: dict, epoch: int, extra: Optional[dict] = None) -> None:
    """Synchronous save of ``state`` ({"model", "optimizer", "step"})."""
    _write(model_dir, snapshot(state), epoch, extra)


class AsyncSaver:
    """Checkpoint saves that overlap training.  ``save`` copies the state to
    the host and returns; the file is written on a background thread.  A
    second ``save`` first waits for the previous one; an error on the thread
    is raised at the next ``save`` or ``wait``.  Call :meth:`wait` before
    reading checkpoints back."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def save(self, model_dir: str, state: dict, epoch: int, extra: Optional[dict] = None) -> None:
        self.wait()
        snap = snapshot(state)

        def run():
            try:
                _write(model_dir, snap, epoch, extra)
            except BaseException as e:  # raised at the next save / wait
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True, name=f"ckpt-save-{epoch}")
        self._thread.start()

    def wait(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("checkpoint save failed") from exc


def available_epochs(model_dir: str):
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(model_dir)
                  if (m := re.fullmatch(r"ckpt_(\d+)\.pt", name)))


def load_epoch(model_dir: str, epoch: int) -> dict:
    return torch.load(_ckpt_path(model_dir, epoch), map_location="cpu", weights_only=True)


def load_latest(model_dir: str) -> Optional[dict]:
    eps = available_epochs(model_dir)
    return load_epoch(model_dir, eps[-1]) if eps else None
