"""The port's checkpoints, epoch loop and train CLI on the CPU.

* ``checkpoint``: epoch-tagged ``.pt`` files with their meta records,
  ``load_epoch`` / ``load_latest`` / ``available_epochs``, and ``AsyncSaver``
  writing host copies taken before the parameters change.
* ``train_loop`` with stubbed steps and checkpoint calls (as
  ``tests/test_train_loop.py`` holds the JAX loop): best saves and forced
  saves, the patience reload of the best checkpoint, which fires at most
  once, and its gate (``-finetune_after -1``).
* The CLI: ``python -m mumpy_tpu_torch.train --tiny -imsize 32 -device cpu``,
  warm-started from a reference-style checkpoint (``-pretrained``), takes
  two epochs on synthetic clips (two inpainting streams), writes
  checkpoints and metrics, and ``python -m mumpy_tpu_torch.serve`` then
  serves the latest checkpoint's weights; without
  ``-device cpu`` and with no card the train CLI refuses to run.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mumpy_tpu_torch import serve
from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train import __main__ as train_cli
from mumpy_tpu_torch.train import checkpoint as ckpt
from mumpy_tpu_torch.train import trainer as trainer_mod
from mumpy_tpu_torch.train.optim import OptimConfig, Optimizer
from mumpy_tpu_torch.train.trainer import TrainLoopConfig, TrainState, train_loop
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


def _state(seed):
    torch.manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    opt = Optimizer(model.named_parameters(), OptimConfig(), iter_max=10)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    return TrainState(model, opt, step=7)


def test_checkpoints_save_and_load(tmp_path):
    assert ckpt.load_latest(str(tmp_path)) is None
    a, b = _state(0), _state(1)
    ckpt.save(str(tmp_path), a.state_dict(), 3, extra={"best_val_loss": 0.5})
    ckpt.save(str(tmp_path), b.state_dict(), 10)
    assert ckpt.available_epochs(str(tmp_path)) == [3, 10]
    assert json.load(open(tmp_path / "meta_3.json")) == {"epoch": 3, "best_val_loss": 0.5}
    latest, first = ckpt.load_latest(str(tmp_path)), ckpt.load_epoch(str(tmp_path), 3)
    assert latest["epoch"] == 10 and first["extra"] == {"best_val_loss": 0.5}
    c = _state(2)
    c.load_state_dict(first)
    assert c.step == 7 and c.optimizer.count == 1
    for k, v in a.model.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v)
    assert torch.equal(c.optimizer.buffers["weight"]["trace"],
                       a.optimizer.buffers["weight"]["trace"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt_10.pt", "ckpt_3.pt", "meta_10.json",
                                            "meta_3.json"]


def test_async_saver_writes_the_state_of_the_call(tmp_path):
    state = _state(0)
    before = state.model.weight.detach().clone()
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), state.state_dict(), 0)
    with torch.no_grad():
        state.model.weight.add_(1.0)  # the next step, while the save may be in flight
    saver.wait()
    assert torch.equal(ckpt.load_epoch(str(tmp_path), 0)["model"]["weight"], before)
    saver.save(str(tmp_path / "missing" / "\0bad"), state.state_dict(), 1)
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        saver.wait()


class FakeState:
    device = torch.device("cpu")
    optimizer = Optimizer([], OptimConfig(), iter_max=10)  # learning-rate telemetry

    def __init__(self, tag):
        self.tag = tag

    def state_dict(self):
        return {"tag": self.tag}

    def load_state_dict(self, sd):
        self.tag = sd["tag"]


def _run_loop(monkeypatch, tmp_path, val_losses, **loop_kwargs):
    events, epoch = [], {"i": -1}
    monkeypatch.setattr(trainer_mod, "train_step", lambda s, b, g, d=None: {
        "total": torch.tensor(0.5), "iou": 0.2, "focal": 0.3})
    monkeypatch.setattr(trainer_mod, "val_step", lambda s, b, d=None: {
        "total": torch.tensor(val_losses[epoch["i"]]), "iou": 0.2, "focal": 0.3})

    class Saver:
        def save(self, d, state, e, extra=None):
            events.append(("save", e, round(float(extra["best_val_loss"]), 6)))

        def wait(self):
            pass

    monkeypatch.setattr(trainer_mod.ckpt_lib, "AsyncSaver", Saver)
    monkeypatch.setattr(trainer_mod.ckpt_lib, "load_latest",
                        lambda d: events.append(("reload",)) or {"tag": "best"})

    def one_batch():
        yield {"image": np.zeros((1,)), "mask": np.zeros((1,))}

    def train_loader():  # called once per epoch, before val
        epoch["i"] += 1
        return one_batch()

    cfg = TrainLoopConfig(model_name="loop", results_dir=str(tmp_path),
                          max_epoch=len(val_losses), patience=1, smooth_curves=False,
                          **loop_kwargs)
    out = train_loop(FakeState("init"), {"train": train_loader, "val": one_batch}, cfg)
    return events, out


@pytest.mark.parametrize("scenario", ["best_and_forced", "reload", "reload_once", "no_reload"])
def test_loop_bookkeeping(monkeypatch, tmp_path, scenario):
    if scenario == "best_and_forced":
        # improving every epoch: best saves plus the forced saves at
        # max_epoch / 2 - 1 and max_epoch - 1
        events, _ = _run_loop(monkeypatch, tmp_path, [0.9, 0.8, 0.7, 0.6])
        assert events == [("save", 0, 0.9), ("save", 1, 0.8), ("save", 1, 0.8),
                          ("save", 2, 0.7), ("save", 3, 0.6), ("save", 3, 0.6)]
    elif scenario == "reload":
        events, out = _run_loop(monkeypatch, tmp_path, [0.5, 0.9, 0.9, 0.9])
        assert ("reload",) in events and out.tag == "best"
    elif scenario == "reload_once":
        events, _ = _run_loop(monkeypatch, tmp_path, [0.5, 0.9, 0.9, 0.9, 0.9, 0.9])
        assert events.count(("reload",)) == 1
    else:
        events, out = _run_loop(monkeypatch, tmp_path, [0.5, 0.9, 0.9, 0.9],
                                patience_reload=False)
        assert ("reload",) not in events and out.tag == "init"


def test_train_cli_then_serve(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(0)
    for name, n in {"bear": 5, "boat": 4}.items():
        for sub in ("vi", "cp", "annot"):
            os.makedirs(tmp_path / sub / name)
        for i in range(n):
            for sub in ("vi", "cp"):
                Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                    tmp_path / sub / name / f"{i:05d}.png")
            m = np.zeros((32, 32), np.uint8)
            m[8:16, 8:24] = 255
            Image.fromarray(m).save(tmp_path / "annot" / name / f"{i:05d}.png")
    args = ["--tiny", "-imsize", "32", "-dataset", "davis", "-model_name", "run",
            "-results_dir", str(tmp_path / "res"), "-seq_dir", str(tmp_path / "vi"),
            "-seq_dir2", str(tmp_path / "cp"), "-annot_dir", str(tmp_path / "annot"),
            "-batch_size", "2", "-max_epoch", "2", "-print_every", "1",
            "-max_steps_per_epoch", "2"]
    # a reference-style warm start: {"encoder", "decoder"} state_dicts, by name
    ref = Mumpy(tiny_config(32))
    torch.save({"encoder": ref.encoder.state_dict(), "decoder": ref.decoder.state_dict()},
               tmp_path / "ref.pth")
    train_cli.main(args + ["-device", "cpu", "-pretrained", str(tmp_path / "ref.pth")])
    out = capsys.readouterr().out
    n_params = len([k for k in ref.state_dict() if not k.endswith("_index")])
    assert f"Warm start: {n_params} tensors" in out
    assert "Training on cpu in f32, 2 clips x 2 streams per step" in out
    run = tmp_path / "res" / "run"
    assert {"ckpt_0.pt", "ckpt_1.pt", "metrics.jsonl"} <= set(os.listdir(run))
    assert not any(name.startswith("weights") for name in os.listdir(run))
    records = [json.loads(line) for line in open(run / "metrics.jsonl")]
    train = [r["total"] for r in records if r["split"] == "train"]
    assert len(train) == 4 and np.isfinite(train).all()
    serve.main(["--tiny", "-imsize", "32", "-dataset", "davis", "-seq_dir",
                str(tmp_path / "vi"), "-results_dir", str(tmp_path / "res"), "-model_name",
                "run", "-batch_size", "4", "-device", "cpu"])
    assert f"Loaded checkpoint of epoch 1 from {run}" in capsys.readouterr().out
    assert len(os.listdir(run / "masks_davis" / "bear")) == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        train_cli.main(args)
