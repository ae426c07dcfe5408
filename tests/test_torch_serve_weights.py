"""Which weights the port's serving CLI (``python -m mumpy_tpu_torch.serve``)
serves, on the CPU at ``tiny_config(32)``, as ``test.py`` chooses them: the
``["model"]`` weights of the train CLI's checkpoint ``ckpt_<e>.pt`` of epoch
``-test_epoch`` (an epoch with none is an error), by default of the latest
epoch, and with no checkpoint the JAX package's initialisation from seed 0
(``jax_init_state_dict``); and the clips of the split ``-eval_split`` names.
The forward is replaced by one that
records the model it is given and returns empty masks: ``test_torch_serve.py``
serves for real.
"""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from mumpy_tpu_torch import serve
from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train import checkpoint as ckpt
from mumpy_tpu_torch.utils.weight_port import jax_init_state_dict, random_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SEQS = {"bear": ("val", 3), "boat": ("train", 2)}  # name: (db-info set, frames)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two sequences of 32^2 frames and a DAVIS db-info yaml that puts one in
    the val set (the test split) and one in the train set."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for name, (_, n) in SEQS.items():
        os.makedirs(root / "vi" / name)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                root / "vi" / name / f"{i:05d}.png")
    with open(root / "db.yaml", "w") as f:
        yaml.safe_dump({"sequences": [{"name": name, "set": tag, "year": 2016}
                                      for name, (tag, _) in SEQS.items()]}, f)
    return root


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """A run directory with the checkpoints of epochs 0 and 1, whose model
    weights differ."""
    run = tmp_path_factory.mktemp("res") / "run"
    model = Mumpy(tiny_config(32))
    sds = []
    for epoch in (0, 1):
        sd = random_state_dict(model, seed=10 + epoch)
        ckpt.save(str(run), {"model": sd, "optimizer": {}, "step": epoch}, epoch)
        sds.append(sd)
    return run, sds


def _serve(monkeypatch, clips, results, *extra):
    """Run the CLI with a recording forward; return the served state_dict and
    the sequences it wrote masks for."""
    served = {}

    def forward_of(model, device, dtype, kernel_set):
        served.update(model.state_dict())
        return lambda clip: torch.zeros(clip.shape[0], 32, 32, 1)

    monkeypatch.setattr(serve, "make_serving_forward", forward_of)
    serve.main(["--tiny", "-imsize", "32", "-dataset", "davis", "-seq_dir", str(clips / "vi"),
                "-db_info", str(clips / "db.yaml"), "-results_dir", str(results),
                "-model_name", "run", "-batch_size", "2", "-device", "cpu", *extra])
    return served, sorted(os.listdir(results / "run" / "masks_davis"))


def _same(served, sd):
    assert served.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(served[k], v), k


@pytest.mark.parametrize("flags, epoch", [(("-test_epoch", "0"), 0), ((), 1)])
def test_serves_the_checkpoint_of_the_epoch(monkeypatch, capsys, clips, epochs, flags, epoch):
    """``-test_epoch 0`` serves epoch 0's weights; the default, the latest
    epoch's (1)."""
    run, sds = epochs
    served, _ = _serve(monkeypatch, clips, run.parent, *flags)
    assert f"Loaded checkpoint of epoch {epoch}" in capsys.readouterr().out
    _same(served, sds[epoch])


def test_missing_epoch_is_an_error(monkeypatch, clips, epochs):
    """An epoch the run directory has no checkpoint of is an error, as in
    ``test.py``, not a silent fall back to another epoch or to the
    initialisation."""
    run, _ = epochs
    with pytest.raises(FileNotFoundError):
        _serve(monkeypatch, clips, run.parent, "-test_epoch", "5")


def test_serves_jax_init_without_a_checkpoint(monkeypatch, capsys, clips, tmp_path):
    """An empty run directory serves ``jax_init_state_dict(seed=0)``'s
    weights, with a warning."""
    served, _ = _serve(monkeypatch, clips, tmp_path)
    assert "no checkpoint found" in capsys.readouterr().out
    _same(served, jax_init_state_dict(Mumpy(tiny_config(32)), seed=0))


@pytest.mark.parametrize("split, seqs", [(None, ["bear"]), ("train", ["boat"]),
                                         ("train-val", ["bear", "boat"])])
def test_eval_split_picks_the_clips(monkeypatch, clips, tmp_path, split, seqs):
    """The default split, test, reads the val set's sequences; ``-eval_split``
    picks another split's."""
    extra = () if split is None else ("-eval_split", split)
    _, written = _serve(monkeypatch, clips, tmp_path, *extra)
    assert written == seqs
    for name in seqs:
        assert len(os.listdir(tmp_path / "run" / "masks_davis" / name)) == SEQS[name][1]
