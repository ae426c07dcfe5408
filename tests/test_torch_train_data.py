"""The port's train split (``mumpy_tpu_torch/data.py``) and augmentation
(``mumpy_tpu_torch/augment.py``) against the JAX package's
``mumpy_tpu/data/dataset.py`` and ``augment.py``, on the same seeds.

Two inpainting streams of synthetic PNG clips with annotations: the port's
seeded shuffling loader (``drop_last``, per-sample augmentation seeds drawn
up front) gives the JAX loader's batches exactly, over two epochs, with the
single and the double augmentation, normalised on the host or as uint8; the
augmentations alone agree draw for draw; ``binarize_mask`` and
``multilateral_collate`` agree."""

import os

import numpy as np
import pytest
from PIL import Image

from mumpy_tpu.configs.data_config import davis_config as jax_davis_config
from mumpy_tpu.data import augment as jaug
from mumpy_tpu.data import dataset as jds
from mumpy_tpu_torch import augment, data
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SIZE = 16


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_clips")
    rng = np.random.default_rng(7)
    for name, n in {"bear": 5, "car": 3, "dog": 4}.items():
        for sub in ("vi", "cp", "annot"):
            os.makedirs(root / sub / name)
        for i in range(n):
            for sub in ("vi", "cp"):
                Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
                    root / sub / name / f"{i:05d}.png")
            m = np.zeros((20, 24), np.uint8)
            m[4 + i: 12, 6: 18 - i] = 200
            Image.fromarray(m).save(root / "annot" / name / f"{i:05d}.png")
    return root


@pytest.mark.parametrize("single,raw", [(True, False), (False, True)])
def test_train_batches_match_jax(root, single, raw):
    kw = dict(sequences=str(root / "vi"), sequences2=str(root / "cp"),
              annotations=str(root / "annot"), input_res=(SIZE, SIZE), single_augment=single)
    ours = data.DataLoader(data.TrainClips(data.davis_config(**kw), "train"), 3, shuffle=True,
                           drop_last=True, seed=11, normalize_on_host=not raw)
    ref = jds.DataLoader(jds.ClipDataset(jax_davis_config(**kw), "train"), 3, shuffle=True,
                         drop_last=True, seed=11, num_workers=0, normalize_on_host=not raw)
    assert len(ours) == len(ref) == 4
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g["image"].dtype == w["image"].dtype
            assert g["image"].shape == (6, 3, SIZE, SIZE, 3)
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["mask"], w["mask"])


def test_augmentations_match_jax():
    rng = np.random.default_rng(3)
    frames = [[rng.integers(0, 255, (12, 12, 3), dtype=np.uint8) for _ in range(3)]
              for _ in range(2)]
    mask = np.zeros((12, 12), np.float32)
    mask[3:7, 2:9] = 1.0
    for fn, ref in ((augment.clip_augment, jaug.clip_augment),
                    (augment.double_clip_augment, jaug.double_clip_augment)):
        for seed in range(40):
            (s1, m1), (s2, m2) = (f([list(x) for x in frames], mask.copy(),
                                    np.random.default_rng(seed)) for f in (fn, ref))
            np.testing.assert_array_equal(m1, m2)
            for a, b in zip(s1, s2):
                np.testing.assert_array_equal(np.stack(a), np.stack(b))


def test_binarize_and_collate_match_jax():
    annot = np.array([[0, 3], [200, 0]], np.float32)
    np.testing.assert_array_equal(data.binarize_mask(annot), jds.binarize_mask(annot))
    rng = np.random.default_rng(4)
    samples = [([rng.standard_normal((3, 4, 4, 3)).astype(np.float32) for _ in range(3)],
                rng.random(16).astype(np.float32), "s", i) for i in range(2)]
    got, want = data.multilateral_collate(samples), jds.multilateral_collate(samples)
    assert got["image"].shape == (6, 3, 4, 4, 3) and got["mask"].shape == (6, 16)
    for k in ("image", "mask"):
        np.testing.assert_array_equal(got[k], want[k])
