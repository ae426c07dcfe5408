"""Remat policy ``"dots"`` and the window cross-view attention
(``cva_kind="window"``) in the port, on the CPU.

* ``"dots"`` (``models/encoder.py:dots_policy``, the JAX package's
  ``dots_with_no_batch_dims_saveable``): on the plain path of
  ``tiny_config(32)`` its loss and gradients equal those of ``"full"`` and of
  no remat (1e-6), and a training forward keeps more bytes for the backward
  than ``"full"`` and fewer than no remat: the bytes the autograd graph
  saves, counted by ``torch.autograd.graph.saved_tensors_hooks``, plus the
  products' outputs the policy keeps.
* ``CrossWindowAttention`` against the JAX package's at ratio 1 and 3 (1e-5),
  on its parameters carried across by ``utils/weight_port.py``'s key map, and
  the window-kind ``tiny_config(32)`` eval logits against the JAX model's
  (1e-4 * max(1, max|logit|)), both from ``tests/golden/jax_window_cva.npz``
  (``tests/make_jax_baseline_golden.py``); the window-kind forward split over
  two CPU replicas equals the one-device forward (1e-6): its ratio-3
  queries are gathered across the replicas.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models import encoder
from mumpy_tpu_torch.models.deformable import CrossWindowAttention, SwinDAttention
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train.trainer import _loss_for_batch
from mumpy_tpu_torch.utils import weight_port
from mumpy_tpu_torch.utils.serving import make_serving_forward, set_kernel_path
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = np.load(Path(__file__).resolve().parent / "golden" / "jax_window_cva.npz")
# the golden writer's seeds and sizes (tests/make_jax_baseline_golden.py)
SIZE, BATCH, WEIGHT_SEED, CLIP_SEED = 32, 2, 3, 11
WINDOW_CFG = dataclasses.replace(tiny_config(SIZE), cva_kind="window")


def clip(rows=BATCH):
    return torch.from_numpy(np.random.default_rng(CLIP_SEED).standard_normal(
        (rows, 3, SIZE, SIZE, 3)).astype(np.float32))


def train_run(policy, remat=True):
    """Loss, gradients and the bytes kept for the backward of one
    plain-path training step at remat ``policy``."""
    model = Mumpy(dataclasses.replace(tiny_config(SIZE), remat=remat, remat_policy=policy,
                                      drop_path_rate=0.2))
    model.load_state_dict(weight_port.random_state_dict(model, 4, fan_in=True))
    set_kernel_path(model, False)
    rng = np.random.default_rng(6)
    b = {"image": clip(4), "mask": torch.from_numpy(
        (rng.random((4, SIZE * SIZE)) < 0.3).astype(np.float32))}
    kept, policy_fn = [0], encoder.dots_policy

    def counting(ctx, op, *args, **kwargs):
        decision = policy_fn(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and \
                not ctx.is_recompute:
            a, w = args[-2], args[-1]  # mm(a, w), addmm(bias, a, w)
            kept[0] += a.shape[0] * w.shape[1] * a.element_size()
        return decision

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    encoder.dots_policy = counting
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = _loss_for_batch(model, b, torch.Generator().manual_seed(0), True)
        loss.backward()
    finally:
        encoder.dots_policy = policy_fn
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}, kept[0]


@pytest.fixture(scope="module")
def runs():
    return {name: train_run(*args) for name, args in
            (("none", ("full", False)), ("full", ("full",)), ("dots", ("dots",)))}


def test_dots_gradients_equal_full_and_none(runs):
    loss0, g0, _ = runs["none"]
    for name in ("full", "dots"):
        loss, g, _ = runs[name]
        assert abs(loss - loss0) <= 1e-6 * max(1.0, abs(loss0)), name
        bad = [n for n in g0 if (g[n] - g0[n]).abs().max() > 1e-6 * max(1.0, g0[n].abs().max())]
        assert not bad, (name, bad[:5])


def test_dots_keeps_more_than_full_and_less_than_none(runs):
    none, full, dots = (runs[k][2] for k in ("none", "full", "dots"))
    assert full < dots < none, (full, dots, none)


def cwa_state_dict(prefix, mod):
    """The port's CrossWindowAttention weights from the golden's JAX tree, by
    the weight port's key map of ``cva.crossattn.*``."""
    tree = {}
    for key in GOLDEN.files:
        if key.startswith(prefix):
            node, *path = key[len(prefix):].split("/")
            tree.setdefault(node, {}) if path else None
            if path:
                tree[node][path[0]] = GOLDEN[key]
            else:
                tree[node] = GOLDEN[key]

    def path(key):
        sub, leaf = weight_port._block_path("cva.crossattn." + key)
        return sub[2:], leaf, None

    return weight_port._state_dict_from_tree(tree, mod.state_dict(), path)


@pytest.mark.parametrize("ratio", [1, 3])
def test_cross_window_attention_matches_jax(ratio):
    p = f"r{ratio}/"
    x1 = torch.from_numpy(GOLDEN[p + "x1"])
    mod = CrossWindowAttention(x1.shape[-1], 3, window=4)
    mod.load_state_dict(cwa_state_dict(p + "param/", mod))
    with torch.no_grad():
        out = mod(x1, torch.from_numpy(GOLDEN[p + "x2"]))
    ref = torch.from_numpy(GOLDEN[p + "out"])
    assert (out - ref).abs().max() <= 1e-5 * max(1.0, ref.abs().max())


def test_window_kind_logits_match_jax():
    model = Mumpy(WINDOW_CFG)
    model.load_state_dict(weight_port.random_state_dict(model, seed=WEIGHT_SEED, std=0.2))
    fwd = make_serving_forward(model, "cpu")
    with torch.inference_mode():
        logits = model(clip())
    ref = torch.from_numpy(GOLDEN["tiny32/logits"])
    assert (logits - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max())
    # every CVA is the window kind: no cva kernel site
    assert not any(isinstance(m, SwinDAttention) for m in model.modules())
    assert sum(isinstance(m, CrossWindowAttention) for m in model.modules()) == 8
    del fwd


def test_window_kind_split_equals_one_device():
    model = Mumpy(WINDOW_CFG)
    model.load_state_dict(weight_port.random_state_dict(model, seed=WEIGHT_SEED, std=0.2))
    x = clip(4)
    one = make_serving_forward(model, "cpu")(x)
    split = make_serving_forward(model, ["cpu", "cpu"])
    try:
        two = split(x)
    finally:
        split.close()
    assert (two - one).abs().max() <= 1e-6
