"""Clips for the serving and training CLIs: the port's own copy of the parts
of ``mumpy_tpu/configs/data_config.py``, ``mumpy_tpu/data/db.py`` and
``mumpy_tpu/data/dataset.py`` that read a test or a train split, with no
LMDB index.

* one clip per frame: a centred window of ``length_clip`` frame indices,
  clamped at the sequence edges;
* the frames resized to ``input_res`` and normalised with the reference's
  mean / std, channels-last float32 (or uint8, normalised later);
* each split's sequences come from a db-info yaml (``db_info``), as in the
  JAX package: ``train`` and ``val`` keep the sequences of that set whose
  directory exists under the stream root, ``test`` reads the ``val`` set,
  ``train-val`` both; a DAVIS record newer than ``year`` is left out.  With
  no yaml (the default: the package ships none) every sub-directory of the
  stream root is a sequence of every split;
* a train split reads one to three inpainting streams (the same frames from
  other inpainting methods) and the centre frame's annotation, binarised;
  ``multilateral_collate`` concatenates the streams along the batch and
  repeats the masks; :class:`DataLoader` shuffles from a seed, drops the last
  short batch and draws each sample's augmentation seed up front, as the
  JAX package's loader does, so the two give the same batches, assembled in
  this process or in a persistent pool of worker processes;
* in a data-parallel run each rank's loader assembles only its rows of the
  global (stream-major) batch: the clips and streams those rows need.

PIL is imported only when a frame is read.
"""

from __future__ import annotations

import dataclasses
import glob
import itertools
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .augment import clip_augment, double_clip_augment

__all__ = ["MEAN", "STD", "DataConfig", "davis_config", "youtubevos_config", "Clip",
           "read_sequences", "list_frames", "build_clips", "load_frame", "normalize",
           "EvalClips", "binarize_mask", "TrainClips", "multilateral_collate", "assemble_rows",
           "DataLoader"]

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
    db_info: Optional[str] = None  # yaml of sequence membership; None: scan the root
    # training: the other inpainting streams, the annotations and the loader
    sequences2: Optional[str] = None
    sequences3: Optional[str] = None
    annotations: str = "/databases/DAVIS_2016_vi/Annotations/480p"
    year: str = "2016"
    batch_size: int = 6
    augment: bool = True
    single_augment: bool = True
    seed: int = 282845927


def davis_config(**overrides) -> DataConfig:
    return DataConfig(**{"dataset": "davis", "frame_ext": "png", **overrides})


def youtubevos_config(**overrides) -> DataConfig:
    return DataConfig(**{"dataset": "youtubevos", "frame_ext": "jpg", **overrides})


@dataclasses.dataclass(frozen=True)
class Clip:
    seq_name: str
    frame_files: Tuple[str, ...]  # basenames of the clip's frames
    starting_frame: int  # centre-frame number, which names the output mask


def _split_keeps(tag: str, split: str) -> bool:
    """Whether a record of set ``tag`` belongs to ``split``."""
    if split == "train-val":
        return tag in ("train", "val")
    return tag == ("val" if split == "test" else split)


def read_sequences(dataset: str, root: str, db_info: Optional[str], year: Optional[str],
                   split: str) -> List[str]:
    """The names of a split's sequences (``mumpy_tpu/data/db.py:read_sequences``):
    from the db-info yaml when it exists, else every sub-directory of
    ``root``.  DAVIS yamls list ``sequences`` records (``name``, ``set``,
    ``year``), YouTube-VOS yamls ``video_name`` records with no year filter;
    ``train`` and ``val`` also need the sequence's directory."""
    if db_info is None or not os.path.exists(db_info):
        return sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d))) if os.path.isdir(root) else []
    import yaml

    with open(db_info) as f:
        recs = yaml.safe_load(f)
    youtube = "youtube" in dataset
    key = "video_name" if youtube else "name"
    names = []
    for r in recs if youtube else recs["sequences"]:
        if not youtube and year is not None and int(r.get("year", year)) > int(year):
            continue
        tag = r.get("set", "train")
        if _split_keeps(tag, split) and (split in ("test", "train-val") or os.path.isdir(
                os.path.join(root, r[key]))):
            names.append(r[key])
    return names


def list_frames(seq_dir: str, ext: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(seq_dir, f"*.{ext}")))
    if not files:  # tolerate mixed extensions
        files = sorted(f for e in ("png", "jpg")
                       for f in glob.glob(os.path.join(seq_dir, f"*.{e}")))
    return files


def build_clips(cfg: DataConfig, split: str) -> List[Clip]:
    """Sliding centred windows with edge clamping over the split's sequences."""
    root = cfg.sequences
    names = read_sequences(cfg.dataset, root, cfg.db_info, cfg.year, split)
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

    def __init__(self, cfg: DataConfig, split: str = "test"):
        self.cfg = cfg
        self.clips = build_clips(cfg, split)

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


# ---- the train split ----

def load_annot(path: str, size: Tuple[int, int]) -> np.ndarray:
    """The annotation as float32 (H, W), resized as the JAX pipeline does."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L").resize(size), dtype=np.uint8).astype(
        np.float32)


def binarize_mask(annot: np.ndarray) -> np.ndarray:
    """annot / max > 0 -> {0, 1} float32."""
    m = annot / max(float(annot.max()), 1e-8)
    return (m > 0).astype(np.float32)


class TrainClips:
    """The clips of a train (or val) split over one to three inpainting
    streams, with their centre-frame masks."""

    def __init__(self, cfg: DataConfig, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.clips = build_clips(cfg, split)
        self.stream_roots = [r for r in (cfg.sequences, cfg.sequences2, cfg.sequences3) if r]

    def __len__(self) -> int:
        return len(self.clips)

    def load_clip(self, i: int, rng: Optional[np.random.Generator] = None,
                  raw: bool = False, streams: Optional[Sequence[int]] = None):
        """(streams: [S] (T, H, W, 3), mask (H*W,) f32, seq_name,
        starting_frame); streams normalised f32, or uint8 with ``raw``.  A
        train split with ``augment`` applies one clip-consistent augmentation
        drawn from ``rng`` to every frame of every stream and to the mask.
        ``streams`` (default all) names the streams to read; the others are
        None.  The augmentation's draws depend on the mask and the frame
        size only, so a stream comes out the same whichever others are read."""
        cfg, clip = self.cfg, self.clips[i]
        res = cfg.input_res
        wanted = range(len(self.stream_roots)) if streams is None else sorted(set(streams))
        frames = [[load_frame(os.path.join(self.stream_roots[j], clip.seq_name, f), res)
                   for f in clip.frame_files] for j in wanted]
        centre = clip.frame_files[cfg.length_clip // 2]
        annot = load_annot(os.path.join(cfg.annotations, clip.seq_name,
                                        os.path.splitext(centre)[0] + ".png"), res)
        if self.split == "train" and cfg.augment and rng is not None:
            aug = clip_augment if cfg.single_augment else double_clip_augment
            frames, annot = aug(frames, annot, rng)
        stacked = [None] * len(self.stream_roots)
        for j, f in zip(wanted, frames):
            stacked[j] = np.stack(f, axis=0) if raw else normalize(np.stack(f, axis=0))
        return stacked, binarize_mask(annot).reshape(-1), clip.seq_name, clip.starting_frame


def multilateral_collate(samples: Sequence, rows: Optional[Sequence[int]] = None
                         ) -> Dict[str, np.ndarray]:
    """Streams concatenated along the batch, masks repeated per stream:
    images (S*B, T, H, W, 3) (uint8 kept), masks (S*B, H*W) f32.  Row r of
    that stream-major batch is stream r // B of clip r % B; ``rows`` (default
    all) keeps those rows, in their order."""
    b = len(samples)
    if rows is None:
        rows = range(len(samples[0][0]) * b)
    images = np.stack([samples[r % b][0][r // b] for r in rows], axis=0)
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    masks = np.stack([samples[r % b][1] for r in rows], axis=0)
    return {"image": images, "mask": masks.astype(np.float32)}


def assemble_rows(ds: TrainClips, idx, seeds, rows: Optional[Sequence[int]] = None,
                  raw: bool = False) -> Dict[str, np.ndarray]:
    """The batch of clips ``idx`` (augmented from ``seeds``), or its
    ``rows``: only the clips and streams those rows hold are read (the
    others' samples are None)."""
    b, n_streams = len(idx), len(ds.stream_roots)
    rows = range(n_streams * b) if rows is None else rows
    need: Dict[int, List[int]] = {}
    for r in rows:
        need.setdefault(r % b, []).append(r // b)
    samples = [ds.load_clip(int(i), np.random.default_rng(int(s)), raw=raw, streams=need[c])
               if c in need else None for c, (i, s) in enumerate(zip(idx, seeds))]
    return multilateral_collate(samples, rows)


_WORKER_DS: Optional[TrainClips] = None


def _worker_init(ds: TrainClips) -> None:
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_assemble(args) -> Dict[str, np.ndarray]:
    idx, seeds, rows = args
    return assemble_rows(_WORKER_DS, idx, seeds, rows, raw=True)


class DataLoader:
    """Seeded shuffling batches of a :class:`TrainClips`, the last short one
    dropped (``drop_last``).  Epoch e shuffles with ``default_rng(seed + e)``
    and draws every sample's augmentation seed from it up front, so the
    batches are the same, bit for bit, for any worker count.

    * ``num_workers`` 0 assembles each batch in this process; more keeps a
      persistent pool of that many ``spawn`` worker processes (PIL and numpy
      hold the interpreter lock for most of a decode, so threads would not
      overlap them) with up to ``prefetch`` batches in flight, as the JAX
      package's loader does.  Workers ship uint8 frames, normalised here when
      ``normalize_on_host``; :meth:`close` stops the pool.
    * ``normalize_on_host=False`` yields uint8 frames, which the trainer
      normalises on the device (4x fewer bytes to copy).
    * ``rank`` of ``world``: ``batch_size`` is the global clip count, and
      each batch holds only this rank's rows of the global stream-major
      batch (``parallel.row_shard``; ``world`` must divide its S x B rows).
    """

    def __init__(self, dataset: TrainClips, batch_size: int, shuffle: bool, drop_last: bool,
                 seed: int = 0, normalize_on_host: bool = True, num_workers: int = 0,
                 prefetch: int = 4, rank: int = 0, world: int = 1):
        from .parallel.dist import row_shard  # here: the workers import this module, not torch

        if world > 1 and not drop_last:
            raise ValueError("a data-parallel loader drops the short last batch (drop_last)")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.normalize_on_host = normalize_on_host
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.rows = row_shard(len(dataset.stream_roots) * batch_size, world, rank)
        self._epoch = 0
        self._pool = None

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self, rng: np.random.Generator):
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        bs = self.batch_size
        end = len(order) - (len(order) % bs) if self.drop_last else len(order)
        return [order[s: s + bs] for s in range(0, end, bs)
                if not (self.drop_last and len(order[s: s + bs]) < bs)]

    def _rows(self, idx):
        """This rank's rows of a batch of ``len(idx)`` clips (all of a
        short last batch's, which only ``drop_last=False`` yields)."""
        return self.rows if len(idx) == self.batch_size else None

    def _pool_of_workers(self):
        if self._pool is None:
            import multiprocessing as mp

            self._pool = mp.get_context("spawn").Pool(
                self.num_workers, initializer=_worker_init, initargs=(self.ds,))
        return self._pool

    def close(self) -> None:
        """Stop the worker pool (a later epoch starts a new one)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        batches = self._batch_indices(rng)
        seeds = [rng.integers(0, 2**63, size=len(idx)) for idx in batches]
        if self.num_workers <= 0:
            for idx, sd in zip(batches, seeds):
                yield assemble_rows(self.ds, idx, sd, self._rows(idx),
                                    raw=not self.normalize_on_host)
            return
        pool = self._pool_of_workers()
        jobs = iter([(idx, sd, self._rows(idx)) for idx, sd in zip(batches, seeds)])
        pending = [pool.apply_async(_worker_assemble, (job,))
                   for job in itertools.islice(jobs, self.prefetch)]
        while pending:
            batch = pending.pop(0).get()
            job = next(jobs, None)
            if job is not None:
                pending.append(pool.apply_async(_worker_assemble, (job,)))
            if self.normalize_on_host:
                batch["image"] = normalize(batch["image"])
            yield batch
