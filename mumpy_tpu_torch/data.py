"""Evaluation clips for the serving CLI: the port's own copy of the parts of
``mumpy_tpu/configs/data_config.py`` and ``mumpy_tpu/data/dataset.py`` that
read a test split, with no augmentation, no LMDB index and no worker pool.

* one clip per frame: a centred window of ``length_clip`` frame indices,
  clamped at the sequence edges;
* the frames of the primary inpainting stream, resized to ``input_res`` and
  normalised with the reference's mean / std, channels-last float32;
* the sequences are the sub-directories of the stream root (the JAX
  package's membership rule when no db-info yaml is present, and it ships
  none).

PIL is imported only when a frame is read.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["MEAN", "STD", "DataConfig", "davis_config", "youtubevos_config", "Clip",
           "list_frames", "build_clips", "load_frame", "normalize", "EvalClips"]

# normalisation constants of the reference (``train.py:49-55``, ``test.py:23-24``)
MEAN = (0.4776, 0.479, 0.4465)
STD = (0.230, 0.2085, 0.2324)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "davis"  # 'davis' | 'youtubevos'
    sequences: str = "/databases/DAVIS_2016_vi/JPEGImages/480p"  # primary stream root
    length_clip: int = 3
    input_res: Tuple[int, int] = (224, 224)
    frame_ext: str = "png"  # davis frames are .png, youtube .jpg


def davis_config(**overrides) -> DataConfig:
    return DataConfig(**{"dataset": "davis", "frame_ext": "png", **overrides})


def youtubevos_config(**overrides) -> DataConfig:
    return DataConfig(**{"dataset": "youtubevos", "frame_ext": "jpg", **overrides})


@dataclasses.dataclass(frozen=True)
class Clip:
    seq_name: str
    frame_files: Tuple[str, ...]  # basenames of the clip's frames
    starting_frame: int  # centre-frame number, which names the output mask


def list_frames(seq_dir: str, ext: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(seq_dir, f"*.{ext}")))
    if not files:  # tolerate mixed extensions
        files = sorted(f for e in ("png", "jpg")
                       for f in glob.glob(os.path.join(seq_dir, f"*.{e}")))
    return files


def build_clips(cfg: DataConfig) -> List[Clip]:
    """Sliding centred windows with edge clamping, every sequence of the root."""
    root = cfg.sequences
    names = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))) \
        if os.path.isdir(root) else []
    k = cfg.length_clip // 2
    clips = []
    for name in names:
        basenames = [os.path.basename(f)
                     for f in list_frames(os.path.join(root, name), cfg.frame_ext)]
        n = len(basenames)
        for idx in range(n):
            ids = [max(0, min(n - 1, i)) for i in range(idx - k, idx + k + 1)]
            centre = basenames[ids[cfg.length_clip // 2]]
            frame_no = int(os.path.splitext(centre)[0].replace("frame_", ""))
            clips.append(Clip(name, tuple(basenames[i] for i in ids), frame_no))
    return clips


def load_frame(path: str, size: Tuple[int, int]) -> np.ndarray:
    """One frame as uint8 (H, W, 3), resized as the JAX pipeline resizes it."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB").resize(size), dtype=np.uint8)


def normalize(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 channels-last frames -> normalised float32."""
    x = frames_u8.astype(np.float32) / 255.0
    return (x - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)


class EvalClips:
    """The clips of a test split and their normalised frames."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.clips = build_clips(cfg)

    def __len__(self) -> int:
        return len(self.clips)

    def load(self, i: int) -> np.ndarray:
        """Clip ``i`` as normalised float32 (T, H, W, 3)."""
        clip = self.clips[i]
        seq_dir = os.path.join(self.cfg.sequences, clip.seq_name)
        return normalize(np.stack([load_frame(os.path.join(seq_dir, f), self.cfg.input_res)
                                   for f in clip.frame_files]))

    def batches(self, batch_size: int) -> Iterator[Dict]:
        """Batches in clip order, the last one short: ``image`` (b, T, H, W, 3),
        ``seq_name`` and ``starting_frame`` lists."""
        for s in range(0, len(self.clips), batch_size):
            idx = range(s, min(s + batch_size, len(self.clips)))
            yield {"image": np.stack([self.load(i) for i in idx]),
                   "seq_name": [self.clips[i].seq_name for i in idx],
                   "starting_frame": [self.clips[i].starting_frame for i in idx]}
