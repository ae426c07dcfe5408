"""The reference's three optimizer groups with optax's semantics, counterpart
of ``mumpy_tpu/train/optim.py``.

Parameters split by name into encoder / decoder / CVA groups (``"cva"`` in a
dotted part of the name, else ``decoder.`` first, else encoder), each with
its own optimizer kind, learning rate and per-update polynomial schedule.
The updates follow the optax transforms the JAX package chains, not torch's
own optimizers, because the JAX package is the reference:

* ``sgd``: ``add_decayed_weights(wd)`` then ``sgd(lr, momentum)`` — the
  decay is added to the gradient before the momentum trace (as torch SGD's
  ``weight_decay``), the trace starts at 0;
* ``adam``: ``adamw(lr, weight_decay=wd)`` — bias-corrected moments, eps
  outside the square root, the decay added to the update;
* ``rmsprop``: ``add_decayed_weights(wd)`` then ``rmsprop(lr, decay=0.99,
  eps=1e-8)`` — nu starts at 0 and eps sits inside the square root, which
  torch's ``RMSprop`` does not do.

Accumulation follows ``optax.MultiSteps``: the running mean of k gradients,
one update every k steps; the schedules count updates.  Only the encoder
group uses ``weight_decay_cnn``; decoder and CVA use ``weight_decay``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

__all__ = ["OptimConfig", "polynomial_schedule", "param_label", "label_params",
           "Optimizer"]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optim: str = "sgd"  # decoder group (-optim)
    optim_cnn: str = "sgd"  # encoder and CVA groups (-optim_cnn)
    lr: float = 1e-2  # decoder
    lr_cnn: float = 1e-3  # encoder
    lr_cva: float = 1e-2  # CVA
    weight_decay: float = 1e-4
    weight_decay_cnn: float = 1e-4
    momentum: float = 0.9
    min_lr: float = 1e-5
    poly_power: float = 0.9
    accumulation_steps: int = 1


def polynomial_schedule(base_lr: float, min_lr: float, power: float, iter_max: int):
    """count -> (base - min) * clip(1 - count / iter_max, 0, 1)^power + min."""

    def schedule(count: int) -> float:
        frac = min(max(1.0 - count / iter_max, 0.0), 1.0)
        return (base_lr - min_lr) * frac**power + min_lr

    return schedule


def param_label(name: str) -> str:
    if any("cva" in part for part in name.split(".")):
        return "cva"
    return "dec" if name.startswith("decoder.") else "enc"


def label_params(names: Iterable[str]) -> Dict[str, str]:
    """enc / dec / cva label of each parameter name."""
    return {n: param_label(n) for n in names}


_GROUP_LR = {"enc": "lr_cnn", "dec": "lr", "cva": "lr_cva"}
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_RMS_DECAY, _RMS_EPS = 0.99, 1e-8


class Optimizer:
    """Updates the named parameters in place from their ``.grad``.

    ``step()`` returns True when it applied an update (every
    ``accumulation_steps`` calls).  Each group's update runs as multi-tensor
    (``torch._foreach_*``) operations over the group's parameters: the step
    is bound by launching one small operation per parameter otherwise (the
    flagship has 1177 tensors).  Buffers are f32 and live on the parameters'
    device; ``state_dict()`` / ``load_state_dict()`` carry them, the update
    count and the accumulation state through a checkpoint."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 cfg: OptimConfig, iter_max: int):
        self.params = dict(named_params)
        self.labels = label_params(self.params)
        self.cfg = cfg
        self.schedules = {g: polynomial_schedule(getattr(cfg, attr), cfg.min_lr,
                                                 cfg.poly_power, iter_max)
                          for g, attr in _GROUP_LR.items()}
        for g in ("enc", "dec", "cva"):
            if self.kind(g) not in ("sgd", "adam", "rmsprop"):
                raise ValueError(f"unknown optimizer {self.kind(g)}")
        self.count = 0  # updates applied: the schedules' count
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = {}
        self.buffers: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in self.params}

    def kind(self, group: str) -> str:
        return self.cfg.optim if group == "dec" else self.cfg.optim_cnn

    def decay(self, group: str) -> float:
        return self.cfg.weight_decay_cnn if group == "enc" else self.cfg.weight_decay

    def lrs(self, count=None) -> Dict[str, float]:
        """Each group's learning rate at update ``count`` (default: the next)."""
        c = self.count if count is None else count
        return {g: s(c) for g, s in self.schedules.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        grads = {n: p.grad.float() for n, p in self.params.items() if p.grad is not None}
        k = self.cfg.accumulation_steps
        if k > 1:  # optax.MultiSteps: running mean, one update every k
            if not self.acc:
                self.acc = {n: g.clone() for n, g in grads.items()}
            else:
                names = list(self.acc)
                acc = [self.acc[n] for n in names]
                delta = torch._foreach_sub([grads[n] for n in names], acc)
                torch._foreach_div_(delta, self.mini_step + 1)
                torch._foreach_add_(acc, delta)
            self.mini_step += 1
            if self.mini_step < k:
                return False
            grads, self.acc, self.mini_step = self.acc, {}, 0
        lrs = self.lrs()
        for group in ("enc", "dec", "cva"):
            names = [n for n in grads if self.labels[n] == group]
            if names:
                self._update(self.kind(group), names, [grads[n] for n in names],
                             lrs[group], self.decay(group))
        self.count += 1
        return True

    def _buffer(self, names, key, like):
        """The named buffers of ``names``, created as zeros where missing."""
        for n, g in zip(names, like):
            if key not in self.buffers[n]:
                self.buffers[n][key] = torch.zeros_like(g)
        return [self.buffers[n][key] for n in names]

    def _update(self, kind, names, g, lr, wd):
        params = [self.params[n] for n in names]
        p32 = [p.float() for p in params]
        if kind == "adam":
            mu, nu = self._buffer(names, "mu", g), self._buffer(names, "nu", g)
            torch._foreach_mul_(mu, _ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1 - _ADAM_B1)
            torch._foreach_mul_(nu, _ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1 - _ADAM_B2)
            den = torch._foreach_div(nu, 1 - _ADAM_B2 ** (self.count + 1))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, _ADAM_EPS)
            update = torch._foreach_div(mu, 1 - _ADAM_B1 ** (self.count + 1))
            torch._foreach_div_(update, den)
            torch._foreach_add_(update, p32, alpha=wd)
        else:
            g = torch._foreach_add(g, p32, alpha=wd)  # add_decayed_weights
            if kind == "sgd":
                if "trace" not in self.buffers[names[0]]:  # the trace starts at 0
                    for n, t in zip(names, g):
                        self.buffers[n]["trace"] = t
                else:
                    trace = [self.buffers[n]["trace"] for n in names]
                    torch._foreach_mul_(trace, self.cfg.momentum)
                    torch._foreach_add_(trace, g)
                update = [self.buffers[n]["trace"] for n in names]
            else:  # rmsprop: eps inside the square root, nu from 0
                nu = self._buffer(names, "nu", g)
                torch._foreach_mul_(nu, _RMS_DECAY)
                torch._foreach_addcmul_(nu, g, g, value=1 - _RMS_DECAY)
                update = torch._foreach_add(nu, _RMS_EPS)
                torch._foreach_rsqrt_(update)
                torch._foreach_mul_(update, g)
        update = torch._foreach_mul(update, lr)
        torch._foreach_sub_(params, [u.to(p.dtype) for u, p in zip(update, params)])

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "acc": dict(self.acc),
                "buffers": {n: dict(b) for n, b in self.buffers.items()}}

    def load_state_dict(self, sd: dict) -> None:
        def dev(name, t):
            return t.to(self.params[name].device)

        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        self.acc = {n: dev(n, t) for n, t in sd["acc"].items()}
        self.buffers = {n: {k: dev(n, t) for k, t in sd["buffers"].get(n, {}).items()}
                        for n in self.params}
