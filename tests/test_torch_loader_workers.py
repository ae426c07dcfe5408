"""The port's training loader with worker processes and rank shards
(``mumpy_tpu_torch/data.py:DataLoader``), on synthetic clips of two
inpainting streams.

Over two epochs, the loader with 2 spawned workers gives the batches of the
loader with none, bit for bit, and both equal the JAX package's
``mumpy_tpu.data.dataset.DataLoader(num_workers=2)`` on the same seed (uint8
frames, as the train CLI asks, and host-normalised f32).  For 2 and 3
ranks, the rank shards put together are the global batch's rows (stream-
major), and a rank reads only the clips and streams its rows hold.  The
worker pools are closed at the end and their processes are gone."""

import os

import numpy as np
import pytest
from PIL import Image

from mumpy_tpu.configs.data_config import davis_config as jax_davis_config
from mumpy_tpu.data import dataset as jds
from mumpy_tpu_torch import data
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

SIZE, CLIPS, SEED = 16, 3, 11


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader_clips")
    rng = np.random.default_rng(9)
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
    return dict(sequences=str(root / "vi"), sequences2=str(root / "cp"),
                annotations=str(root / "annot"), input_res=(SIZE, SIZE))


def epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["image"].dtype == w["image"].dtype
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["mask"], w["mask"])


@pytest.mark.parametrize("on_host", [False, True])
def test_workers_give_the_same_batches(clips, on_host):
    ds = data.TrainClips(data.davis_config(**clips), "train")
    kw = dict(shuffle=True, drop_last=True, seed=SEED, normalize_on_host=on_host)
    serial = epochs(data.DataLoader(ds, CLIPS, **kw))
    pooled = data.DataLoader(ds, CLIPS, num_workers=2, **kw)
    ref = jds.DataLoader(jds.ClipDataset(jax_davis_config(**clips), "train"), CLIPS,
                         num_workers=2, **kw)
    try:
        got, want = epochs(pooled), epochs(ref)
        workers = pooled._pool._pool
        assert len(workers) == 2 and all(w.is_alive() for w in workers)
    finally:
        pooled.close()
        ref.close()
    assert pooled._pool is None
    for w in workers:
        w.join(timeout=30)
        assert not w.is_alive()
    for g, s, w in zip(got, serial, want):
        assert len(g) == 4 and g[0]["image"].shape == (2 * CLIPS, 3, SIZE, SIZE, 3)
        assert_same(g, s)
        assert_same(g, w)


def test_rank_shards_make_the_global_batch(clips, monkeypatch):
    ds = data.TrainClips(data.davis_config(**clips), "train")
    kw = dict(shuffle=True, drop_last=True, seed=SEED, normalize_on_host=False)
    whole = epochs(data.DataLoader(ds, CLIPS, **kw))
    read = []
    load = data.load_frame
    monkeypatch.setattr(data, "load_frame", lambda path, size: (read.append(path),
                                                                 load(path, size))[1])
    for world in (2, 3):
        shards = []
        for rank in range(world):
            read.clear()
            shards.append(epochs(data.DataLoader(ds, CLIPS, rank=rank, world=world, **kw)))
            streams = {p.split(os.sep)[-3] for p in read}
            if world == 2:  # 6 stream-major rows: rank 0 holds stream vi, rank 1 stream cp
                assert streams == {("vi", "cp")[rank]}
            # each row's clip reads its 3 frames, once for each stream it needs
            assert len(read) == 2 * 4 * 3 * (2 * CLIPS // world)
        for e, epoch in enumerate(whole):
            for b, batch in enumerate(epoch):
                parts = [shards[r][e][b] for r in range(world)]
                assert all(p["image"].shape[0] == 2 * CLIPS // world for p in parts)
                for key in ("image", "mask"):
                    np.testing.assert_array_equal(
                        np.concatenate([p[key] for p in parts]), batch[key])
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        data.DataLoader(ds, CLIPS, rank=0, world=4, **kw)
