"""The port's serving CLI (``python -m mumpy_tpu_torch.serve``) on synthetic
PNG clips: with ``-device cpu`` it writes
``masks_<dataset>/<seq>/{frame:04d}_instance_00.png`` for every frame, which
``mumpy_tpu.utils.metrics.evaluate_dirs`` (the scorer behind ``measure.py``)
pairs with the ground truth; without it, on a machine with no card, it
refuses to serve."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu.utils.metrics import evaluate_dirs
from mumpy_tpu_torch import serve
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train import checkpoint as ckpt
from mumpy_tpu_torch.utils.weight_port import random_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SEQS = {"bear": 5, "boat": 4}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for name, n in SEQS.items():
        for sub in ("vi", "annot"):
            os.makedirs(root / sub / name)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                root / "vi" / name / f"{i:05d}.png")
            m = np.zeros((32, 32), np.uint8)
            m[8:16, 8:24] = 255
            Image.fromarray(m).save(root / "annot" / name / f"{i:05d}.png")
    return root


def _serve(data, results, *extra, device=("-device", "cpu")):
    serve.main(["--tiny", "-imsize", "32", "-dataset", "davis", "-seq_dir", str(data / "vi"),
                "-results_dir", str(results), "-model_name", "run", "-batch_size", "4",
                *device, *extra])
    return results / "run" / "masks_davis"


def test_serve_writes_scoreable_masks(data, tmp_path, capsys):
    out = _serve(data, tmp_path)
    assert "no checkpoint found; using random init" in capsys.readouterr().out
    for name, n in SEQS.items():
        files = sorted(os.listdir(out / name))
        assert files == [f"{i:04d}_instance_00.png" for i in range(n)]
        mask = np.asarray(Image.open(out / name / files[0]))
        assert mask.shape == (32, 32) and set(np.unique(mask)) <= {0, 255}
    _, _, scored = evaluate_dirs(str(out), str(data / "annot"))
    assert scored == sum(SEQS.values())


def test_serve_loads_torch_checkpoint(data, tmp_path, capsys):
    model = Mumpy(tiny_config(32))
    ckpt.save(str(tmp_path / "run"), {"model": random_state_dict(model, seed=5)}, 2)
    out = _serve(data, tmp_path, "--bf16")
    assert "Loaded checkpoint of epoch 2" in capsys.readouterr().out
    assert len(os.listdir(out / "boat")) == SEQS["boat"]


def test_serve_needs_a_card_unless_asked_for_the_cpu(data, tmp_path, monkeypatch):
    """The default device is the GPU: with no card visible the CLI exits
    non-zero with a message rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        _serve(data, tmp_path, device=())
    assert exc.value.code not in (0, None) and "-device cpu" in str(exc.value.code)
    assert not (tmp_path / "run").exists()
