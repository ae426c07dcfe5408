"""The port's ``"attention"`` kernel set (the JAX package's per-op
configuration ``MUMPY_FUSED_BLOCK=off MUMPY_PALLAS=on``: every layer op by
op, only the window-attention core, #7, through a kernel) on the CPU.

* Against the JAX package, from ``tests/golden/jax_attention_set_tiny32.npz``
  (written by ``tests/make_jax_window_attention_golden.py``: the JAX model at
  ``tiny_config(32)`` with the whole-block and training kernels off and #7
  in Pallas interpret mode, on the port's seeded weights carried across by
  ``port_state_dicts``), so that no JAX is compiled here: the eval logits
  within 1e-4 * max(1, max|logit|), the training loss within 1e-5 relative
  and the gradient of every ``attn.qkv``, ``attn.proj`` and
  ``relative_position_bias_table`` parameter within 1e-4 * max(1, max|g|).
* Against the port's ``"blocks"`` set on its plain path, at
  ``tiny_config(128)``, where stage 2 has a shifted window (at 32 every
  window covers its whole grid): the same logits, loss and gradients.
* The CLIs: ``serve`` and ``train`` with ``-kernel_set attention -device cpu``.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mumpy_tpu_torch import serve
from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train import __main__ as train_cli
from mumpy_tpu_torch.train.trainer import _loss_for_batch
from mumpy_tpu_torch.utils.serving import (make_serving_forward, prepare_for_inference,
                                           set_kernel_path)
from mumpy_tpu_torch.utils.weight_port import random_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = np.load(Path(__file__).resolve().parent / "golden" / "jax_attention_set_tiny32.npz")
# the golden writer's seeds (tests/make_jax_window_attention_golden.py)
SIZE, BATCH, WEIGHT_SEED, CLIP_SEED, MASK_SEED = 32, 2, 3, 11, 12


def _inputs(size):
    model = Mumpy(tiny_config(size))
    model.load_state_dict(random_state_dict(model, seed=WEIGHT_SEED, std=0.2))
    clip = np.random.default_rng(CLIP_SEED).standard_normal(
        (BATCH, 3, size, size, 3)).astype(np.float32)
    mask = (np.random.default_rng(MASK_SEED).random((BATCH, size * size)) < 0.3).astype(
        np.float32)
    return model, clip, mask


def _logits(model, clip, kernel_set):
    set_kernel_path(model, True, kernel_set)
    with torch.inference_mode():
        return prepare_for_inference(model)(torch.from_numpy(clip))


def _loss_and_grads(model, clip, mask, kernel_set):
    set_kernel_path(model, True, kernel_set)
    model.zero_grad(set_to_none=True)
    loss, _ = _loss_for_batch(model, {"image": clip, "mask": mask}, None, True)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _close(got, ref, tol):
    ref = torch.as_tensor(ref)
    err = (got - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), err


def test_logits_match_jax():
    model, clip, _ = _inputs(SIZE)
    logits = _logits(model, clip, "attention")
    assert model.encoder.layers.layers[0].blocks[0].block1.__dict__.get("_ops") is None
    assert logits.shape == GOLDEN["logits"].shape
    _close(logits, GOLDEN["logits"], 1e-4)


def test_loss_and_attention_gradients_match_jax():
    model, clip, mask = _inputs(SIZE)
    loss, grads = _loss_and_grads(model, clip, mask, "attention")
    assert abs(loss - float(GOLDEN["loss"])) <= 1e-5 * abs(float(GOLDEN["loss"]))
    keys = [k[len("grad/"):] for k in GOLDEN.files if k.startswith("grad/")]
    # qkv and proj weights and biases and the table of the 12 cross and 9 plain
    # blocks, and the two ViT layers' qkv and proj
    assert len(keys) == 5 * 21 + 4 * 2
    for k in keys:
        _close(grads[k], GOLDEN[f"grad/{k}"], 1e-4)


def test_attention_set_equals_blocks_set_with_shifts():
    model, clip, mask = _inputs(128)
    _close(_logits(model, clip, "attention"), _logits(model, clip, "blocks"), 1e-5)
    loss_a, grads_a = _loss_and_grads(model, clip, mask, "attention")
    loss_b, grads_b = _loss_and_grads(model, clip, mask, "blocks")
    assert abs(loss_a - loss_b) <= 1e-6 * abs(loss_b)
    for k, g in grads_b.items():
        _close(grads_a[k], g, 1e-5)


def test_kernel_set_is_explicit():
    model = Mumpy(tiny_config(SIZE))
    with pytest.raises(ValueError, match="kernel_set"):
        set_kernel_path(model, True, "pairs")
    make_serving_forward(model, "cpu", kernel_set="attention")
    assert not any("_ops" in m.__dict__ for m in model.modules())
    make_serving_forward(model, "cpu")  # back to the blocks set: operands built
    assert "_ops" in model.encoder.globalblocks.blocks[0].__dict__


def test_clis_run_the_attention_set_on_cpu(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for name, n in {"bear": 4, "boat": 3}.items():
        for sub in ("vi", "cp", "annot"):
            os.makedirs(tmp_path / sub / name)
        for i in range(n):
            for sub in ("vi", "cp"):
                Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                    tmp_path / sub / name / f"{i:05d}.png")
            Image.fromarray(np.full((32, 32), 255 * (i % 2), np.uint8)).save(
                tmp_path / "annot" / name / f"{i:05d}.png")
    common = ["--tiny", "-imsize", "32", "-dataset", "davis", "-model_name", "run",
              "-results_dir", str(tmp_path / "res"), "-seq_dir", str(tmp_path / "vi"),
              "-kernel_set", "attention", "-device", "cpu"]
    train_cli.main(common + ["-seq_dir2", str(tmp_path / "cp"), "-annot_dir",
                             str(tmp_path / "annot"), "-batch_size", "2", "-max_epoch", "1",
                             "-max_steps_per_epoch", "1"])
    assert "per step, kernel set attention" in capsys.readouterr().out
    serve.main(common + ["-batch_size", "4"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint" in out and "kernel set attention" in out
    assert len(os.listdir(tmp_path / "res" / "run" / "masks_davis" / "bear")) == 4
