"""The numbers that decide ``correct``, each held to its limit.

Serving (``prob_gap``): the largest |p - p_ref| over every pixel of the
sampled batches that the timed path served, p_ref the reference's float32
probabilities for the same clips.

Training, over the first steps, which go through the window's own call:

* ``pred_gap``: the largest |p - p_ref| over the first step's predictions
  (the sigmoid of its logits, which ``train_step`` returns);
* ``loss_gap``: the largest |L - L_ref| / L_ref over the steps;
* ``first_loss_gap``: the same of the first step alone, which starts from
  the same weights on both sides, so rounding has not yet compounded (a
  loss taken over part of the batch shows here);
* ``grad_gap``: the worst leaf's | |g| - |g_ref| | over max(|g_ref|, the
  median leaf's |g_ref|), g the decayed gradient as the optimizer took it in
  the first step (read from its momentum trace);
* ``change_gap``: the same for each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (a gradient nought to rounding, such as a key's bias under
  softmax, moves its leaf by round-off alone);
* ``change_diff``: |D - D_ref| / |D_ref| over those leaves together, D the
  whole model's change over the steps.  A gap of norms cannot see a step
  that moves each leaf as far in another direction, as one taken on half
  the batch does; this number sees the direction.

A gap of norms moves only at second order under rounding that scatters each
element, so the gradient numbers separate a bf16 step from an fp8 one by
2-3x at most; the predictions separate them further.

A cell's file limits the numbers that separate its sound runs from its
control and faults; the others are printed with no limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from reference.train import leaf_norms  # noqa: F401  (the one copy, shared with the loops)


def prob_gap(pairs) -> float:
    """``pairs``: (served probabilities, reference probabilities) per batch."""
    return max(float((p.float() - r.float()).abs().max()) for p, r in pairs)


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    floor = statistics.median(ref[n] for n in names)
    return max(abs(got[n] - ref[n]) / max(ref[n], floor) for n in names)


def _moving(ref: dict) -> List[str]:
    raw_median = statistics.median(ref["raw_grad"].values())
    return [n for n in sorted(ref["grad"]) if ref["raw_grad"][n] >= 1e-3 * raw_median]


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    names, moving = sorted(ref["grad"]), _moving(ref)
    return {
        "pred_gap": pred_gap(got["preds"], ref["preds"]),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
        "first_loss_gap": abs(got["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad_gap": _leaf_gap(got["grad"], ref["grad"], names),
        "change_gap": _leaf_gap(got["change"], ref["change"], moving),
        "change_diff": change_diff(got["delta"], ref["delta"], moving),
        "leaves_left_out": float(len(names) - len(moving)),
    }


def change_diff(got: dict, ref: dict, names: List[str]) -> float:
    """|D - D_ref| / |D_ref| over the leaves ``names`` taken together, each
    side's changes {name: tensor} on any device."""
    diff = total = 0.0
    for n in names:
        r = ref[n].float()
        diff += float((got[n].to(r.device).float() - r).pow(2).sum())
        total += float(r.pow(2).sum())
    return math.sqrt(diff / total)


def pred_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |p - p_ref| over the first step's predictions; predictions
    missing for any clip count as a gap of 1."""
    if got.shape != ref.shape:
        return 1.0
    return float((got.to(ref.device).float() - ref.float()).abs().max())


def worst_leaves(got: dict, ref: dict, k: int = 5) -> Dict[str, list]:
    """The ``k`` leaves with the largest gaps of gradient and change norms."""
    out = {}
    for key in ("grad", "change"):
        names = sorted(ref[key]) if key == "grad" else _moving(ref)
        floor = statistics.median(ref[key][n] for n in names)
        gaps = sorted(((abs(got[key][n] - ref[key][n]) / max(ref[key][n], floor), n,
                        got[key][n], ref[key][n]) for n in names), reverse=True)
        out[key] = [[round(g, 5), n, a, b] for g, n, a, b in gaps[:k]]
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limited number; a number without
    a limit is reported with none."""
    return {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}


def is_correct(checks: Dict[str, dict]) -> bool:
    return all(c["limit"] is None or (c["value"] == c["value"] and c["value"] <= c["limit"])
               for c in checks.values())
