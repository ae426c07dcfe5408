"""The training side of the reference: the loss, the recipe's SGD, and the
first steps of a training run with the numbers the benchmark compares.

Loss: mean soft IoU of sigmoid(logits) (eps 1e-6) plus mean focal BCE
(gamma 2), on float32 logits flattened per clip.  SGD, per parameter group
(``cva`` where a dotted part of the name holds "cva", else ``dec`` for the
decoder, else ``enc``): ``g' = g + wd * p`` (wd: ``weight_decay_cnn`` for
``enc``, ``weight_decay`` for the others), a momentum trace that starts at
``g'``, ``p -= lr * trace``, lr on the polynomial schedule
``(base - min) * clip(1 - count / iter_max, 0, 1) ** power + min``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import baseline, mumpy
from .context import Ctx

FORWARDS = {"mumpy": mumpy.forward, "swin_baseline": baseline.forward}


def forward(ctx: Ctx, P, cfg, clip):
    return FORWARDS[cfg["model"]](ctx, P, cfg, clip)


def total_loss(targets, logits):
    out = torch.sigmoid(logits)
    num = (out * targets).sum(-1)
    den = (out + targets - out * targets).sum(-1) + 1e-6
    iou = (1.0 - num / den).mean()
    bce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    focal = ((1.0 - torch.exp(-bce)) ** 2.0 * bce).mean()
    return iou + focal


def group(name: str) -> str:
    if any("cva" in part for part in name.split(".")):
        return "cva"
    return "dec" if name.startswith("decoder.") else "enc"


def lr_at(recipe: dict, grp: str, count: int) -> float:
    base = recipe[{"enc": "lr_cnn", "dec": "lr", "cva": "lr_cva"}[grp]]
    frac = min(max(1.0 - count / recipe["iter_max"], 0.0), 1.0)
    return (base - recipe["min_lr"]) * frac ** recipe["poly_power"] + recipe["min_lr"]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: the float32 L2 norm of the tensor}."""
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).tolist()
    return dict(zip(names, norms))


def first_steps(cfg: dict, P: Dict[str, torch.Tensor], batches: List[dict], recipe: dict,
                generator: torch.Generator, rnd=None, dtype=torch.float32) -> dict:
    """SGD steps of the reference from the float32 weights ``P`` (updated in
    place), one a batch of ``batches`` ({"image": (B, 3, H, W, 3), "mask":
    (B, H*W)}), the keeps drawn from ``generator``; the forward and backward
    on ``P`` and the clips cast to ``dtype`` (the control's bfloat16).
    Returns the loss of each step, each leaf's norm of the decayed gradient
    as the optimizer takes it in the first step (``grad``) and of the raw
    gradient (``raw_grad``), the change of each leaf over all the steps
    (``delta``) and its norm (``change``), and the first step's
    predictions, sigmoid of its logits (``preds``, (B, H, W)).  Each block
    is recomputed in the backward, so that a step at the timed batch fits."""
    if recipe["optim"] != "sgd":
        raise ValueError("the reference has the recipe's SGD only")
    for p in P.values():
        p.requires_grad_(True)
    p0 = {n: p.detach().clone() for n, p in P.items()}
    trace: Dict[str, torch.Tensor] = {}
    out = {"loss": []}
    ctx = Ctx(train=True, generator=generator, rnd=rnd, checkpoint=True)
    for count, batch in enumerate(batches):
        for p in P.values():
            p.grad = None
        Pc = P if dtype == torch.float32 else {n: p.to(dtype) for n, p in P.items()}
        logits = forward(ctx, Pc, cfg, batch["image"].to(dtype)).float()
        b = logits.shape[0]
        loss = total_loss(batch["mask"].float().reshape(b, -1), logits.reshape(b, -1))
        loss.backward()
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            for n, p in P.items():
                grp = group(n)
                wd = recipe["weight_decay_cnn"] if grp == "enc" else recipe["weight_decay"]
                g = p.grad + wd * p
                trace[n] = g if count == 0 else recipe["momentum"] * trace[n] + g
                p -= lr_at(recipe, grp, count) * trace[n]
            if count == 0:
                out["preds"] = torch.sigmoid(logits.detach())[..., 0]
                out["grad"] = leaf_norms(trace)
                out["raw_grad"] = leaf_norms({n: p.grad for n, p in P.items()})
        del logits, loss, Pc
    with torch.no_grad():
        out["delta"] = {n: P[n].detach() - p0[n] for n in P}
        out["change"] = leaf_norms(out["delta"])
    for p in P.values():
        p.grad = None
        p.requires_grad_(False)
    return out
