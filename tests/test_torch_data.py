"""The port's evaluation clips (``mumpy_tpu_torch/data.py``) against the JAX
package's ``ClipDataset`` / ``DataLoader`` on synthetic PNG sequences: the
same clip index (edge clamping, ``frame_``-prefixed names), the same
normalised frames and the same test batches, exactly."""

import os

import numpy as np
import pytest
from PIL import Image

from mumpy_tpu.configs.data_config import davis_config as jax_davis_config
from mumpy_tpu.data.dataset import ClipDataset, DataLoader
from mumpy_tpu.data.dataset import normalize as jax_normalize
from mumpy_tpu_torch import data
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SEQS = {"bear": ("{:05d}.png", 5), "car": ("frame_{:05d}.png", 1), "dog": ("{:05d}.png", 2)}
SIZE = 24


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(3)
    for name, (pattern, n) in SEQS.items():
        for sub in ("vi", "annot"):
            os.makedirs(root / sub / name)
        for i in range(n):
            frame = pattern.format(10 + i)
            # frames of another size than the model's: the resize is held too
            Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)).save(
                root / "vi" / name / frame)
            Image.fromarray(np.zeros((30, 40), np.uint8)).save(
                root / "annot" / name / (os.path.splitext(frame)[0] + ".png"))
    return root


def _both(root):
    ours = data.EvalClips(data.davis_config(sequences=str(root / "vi"),
                                            input_res=(SIZE, SIZE)))
    ref = ClipDataset(jax_davis_config(sequences=str(root / "vi"), sequences2=None,
                                       annotations=str(root / "annot"),
                                       input_res=(SIZE, SIZE)), "test")
    return ours, ref


def test_clip_index_matches_jax(root):
    ours, ref = _both(root)
    assert [(c.seq_name, c.frame_files, c.starting_frame) for c in ours.clips] == \
           [(c.seq_name, c.frame_files, c.starting_frame) for c in ref.clips]
    assert len(ours) == sum(n for _, n in SEQS.values())


def test_loaded_clips_match_jax(root):
    ours, ref = _both(root)
    for i in range(len(ref)):
        streams, _, name, frame = ref.load_clip(i)
        np.testing.assert_array_equal(ours.load(i), streams[0])
        assert (ours.clips[i].seq_name, ours.clips[i].starting_frame) == (name, frame)


def test_batches_match_jax_loader(root):
    ours, ref = _both(root)
    loader = DataLoader(ref, batch_size=3, shuffle=False, drop_last=False)
    got = list(ours.batches(3))
    want = list(loader)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        assert g["seq_name"] == w["seq_name"]
        assert g["starting_frame"] == w["starting_frame"]


def test_normalize_matches_jax():
    frames = np.random.default_rng(4).integers(0, 256, (3, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(data.normalize(frames), jax_normalize(frames))
