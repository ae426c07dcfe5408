"""Faults planted under the timed path, to show that ``correct`` catches them,
and the control: the reference in the next precision below the cell's (fp8
products in a bf16 computation) put in the program's place.  Each fault
wraps an entry of ``program``, or the loss the port's training step calls,
and is undone on exit:

* ``answer_altered`` (serving): the first clip of every batch gets 1 - p;
* ``half_batch`` (training): each step runs its forward on the whole batch
  and takes the loss over the first half of its rows, the mean over the
  rest; its predictions keep every row;
* ``state_unchanged`` (training): each step computes its loss and
  gradients, and leaves the parameters as they were.
"""

from __future__ import annotations

import contextlib

import torch

import compare
import loops
import program
import traffic
from reference import train as ref_train
from reference import weights as ref_weights
from reference.context import Ctx, f32_only
from reference.precision import fp8


@contextlib.contextmanager
def _patched(name, make):
    original = getattr(program, name)
    setattr(program, name, make(original))
    try:
        yield
    finally:
        setattr(program, name, original)


def answer_altered():
    def make(serving_forward):
        def wrapped(*args, **kwargs):
            fwd = serving_forward(*args, **kwargs)

            def altered(clip):
                p = fwd(clip).clone()
                p[0] = 1.0 - p[0]
                return p
            return altered
        return wrapped
    return _patched("serving_forward", make)


@contextlib.contextmanager
def half_batch():
    from mumpy_tpu_torch.train import trainer

    original = trainer.total_loss

    def halved(targets, logits):
        half = logits.shape[0] // 2
        return original(targets[:half], logits[:half])

    trainer.total_loss = halved
    try:
        yield
    finally:
        trainer.total_loss = original


def state_unchanged():
    def make(train_step):
        def wrapped(state, batch, generator, dtype):
            params = program.parameters(state)
            saved = {n: p.detach().clone() for n, p in params.items()}
            out = train_step(state, batch, generator, dtype)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])
            return out
        return wrapped
    return _patched("train_step", make)


FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch,
          "state_unchanged": state_unchanged}


def serve_control(cell, cfg, mix, seed, device) -> dict:
    """The control's numbers: the reference in the program's place, computed
    in the cell's type (bf16) with every product's operands rounded to fp8,
    held against the float32 reference on the pool the cell serves."""
    dtype = getattr(torch, cell["dtype"])
    wseed = traffic.sub_seed(seed, traffic.WEIGHTS)
    with f32_only(), torch.no_grad():
        low = ref_weights.draw(cfg, wseed, device, dtype)
        P = {k: v.float() for k, v in low.items()}
        pool = traffic.serve_pool(mix, cfg["image_size"], seed, device, dtype)
        pairs = []
        for clip in pool:
            got = ref_train.forward(Ctx(rnd=fp8), low, cfg, clip)
            pairs.append((torch.sigmoid(got.float()),
                          torch.sigmoid(ref_train.forward(Ctx(), P, cfg, clip.float()))))
    return {"prob_gap": compare.prob_gap(pairs)}


def train_control(cell, cfg, mix, seed, device):
    """As :func:`serve_control`, over the training cell's first steps (float32
    master weights, the forward and backward in the cell's type).  Returns
    (the control's readings, the reference's)."""
    wseed = traffic.sub_seed(seed, traffic.WEIGHTS)
    kseed = traffic.sub_seed(seed, traffic.KEEPS)
    out = []
    with f32_only():
        for rnd, dtype in ((fp8, getattr(torch, cell["dtype"])),
                           (None, torch.float32)):
            P = {k: v.detach() for k, v in
                 ref_weights.draw(cfg, wseed, device, torch.float32).items()}
            batches = traffic.train_pool(mix, cfg["image_size"], seed, device,
                                         count=loops.FIRST_STEPS)
            out.append(ref_train.first_steps(cfg, P, batches, cell["recipe"],
                                             torch.Generator(device=device).manual_seed(kseed),
                                             rnd=rnd, dtype=dtype))
            del P, batches
    return tuple(out)
