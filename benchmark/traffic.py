"""The one traffic generator: it reads a mix (a file of ``mixes/``) and makes a
pool of distinct batches on the device from the run's seed.

A mix's keys:

* ``kind``: ``serve`` (clips in, probabilities out) or ``train`` (clips and
  their masks, one optimizer step a batch), both driven in a closed loop
  (the next batch goes in when the last one is done);
* ``batch``: clips a batch; ``pool``: distinct batches, cycled in order;
* ``frames``: frames a clip; clips are normalised frames, N(0, 1);
* ``mask`` (train): ``rectangles`` a clip, each with its side drawn from
  [``side_min``, ``side_max``) of the image and its corner from
  [0, ``corner_max``) of it.

Every seed gives the same sizes and the same number of batches: only the
values change.
"""

from __future__ import annotations

from typing import List

import torch


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run's seed (weights, traffic,
    drop-path keeps, sampling)."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2**63 - 1)


WEIGHTS, TRAFFIC, KEEPS, SAMPLE = 0, 1, 2, 3


def _clips(gen, n, frames, size, device, dtype):
    return torch.randn(n, frames, size, size, 3, generator=gen, device=device).to(dtype)


def serve_pool(mix: dict, image_size: int, seed: int, device, dtype) -> List[torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, TRAFFIC))
    return [_clips(gen, mix["batch"], mix["frames"], image_size, device, dtype)
            for _ in range(mix["pool"])]


def rectangle_masks(gen, n, size, spec: dict, device) -> torch.Tensor:
    """(n, size * size) float masks, ``spec["rectangles"]`` seeded rectangles a clip."""
    lo, hi = int(size * spec["side_min"]), int(size * spec["side_max"])
    corner = int(size * spec["corner_max"])
    k = spec["rectangles"]
    y0, x0 = torch.randint(0, corner, (2, n, k), generator=gen, device=device)
    h, w = torch.randint(lo, hi, (2, n, k), generator=gen, device=device)
    ys = torch.arange(size, device=device)[None, None, :, None]
    xs = torch.arange(size, device=device)[None, None, None, :]
    inside = ((ys >= y0[..., None, None]) & (ys < (y0 + h)[..., None, None])
              & (xs >= x0[..., None, None]) & (xs < (x0 + w)[..., None, None]))
    return inside.any(dim=1).float().reshape(n, size * size)


def train_pool(mix: dict, image_size: int, seed: int, device, count=None) -> List[dict]:
    """The pool's batches, or its first ``count`` (the same ones)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, TRAFFIC))
    pool = []
    for _ in range(mix["pool"] if count is None else count):
        clip = _clips(gen, mix["batch"], mix["frames"], image_size, device, torch.float32)
        mask = rectangle_masks(gen, mix["batch"], image_size, mix["mask"], device)
        pool.append({"image": clip, "mask": mask})
    return pool
