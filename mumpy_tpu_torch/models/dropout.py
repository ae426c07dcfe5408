"""Dropout of the port: the JAX package's ``nn.Dropout`` sites, with masks
that a recompute replays and that a split batch draws row by row.

A site keeps each element with probability ``1 - rate`` and scales it by
``1 / (1 - rate)`` (flax's ``Dropout``, torch's ``F.dropout``).  Its mask is
not drawn from a random stream at the site: each module draws one seed per
site from the forward's ``generator`` (:func:`draw_seeds`, before a remat
checkpoint, as the drop-path keeps are drawn), and the mask is a hash of that
seed and each element's index in the whole batch (:func:`dropout`).  So

* a recomputed pair (``torch.utils.checkpoint``) draws the masks its forward
  drew, as ``nn.remat`` replays the JAX package's rng;
* a part of a split batch (a data-parallel rank, ``swin.RowShard``) draws
  the seed every part draws and hashes its own rows' indices: W ranks drop
  what the one-process step drops, with no rank drawing the whole batch's
  mask;
* the CPU and the card draw the same masks from one seed (integer ops only).

Each tensor a site drops is laid out as the JAX package lays it out, rows
(samples, windows or tokens of the batch) first, so that the element index
of a part is its index in the whole batch; a module whose own layout
differs permutes a view to that layout around the call.  Dropout runs in
training only; eval is unchanged.  :func:`record_sites` lists the sites a
forward calls, with their rates, shapes and kept shares (the tests hold
the list against the JAX package's).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["draw_seeds", "keep_mask", "dropout", "record_sites", "Drops", "NO_DROPS"]

_M32 = 0xFFFFFFFF
_RECORD = None  # the list :func:`record_sites` fills, or None


def draw_seeds(n: int, generator, device) -> torch.Tensor:
    """(n,) int64 seeds in [0, 2^31) from ``generator`` (a ``torch.Generator``
    or a ``swin.RowShard``, whose parts draw the same seeds), on ``device``."""
    gen = getattr(generator, "generator", generator)
    if gen is None:
        raise ValueError("dropout at a rate above 0 needs a torch.Generator")
    seeds = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=gen.device)
    return seeds.to(device)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) on int64 values in
    [0, 2^32); every product stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x6A09E667) & _M32
    return x ^ (x >> 16)


def keep_mask(shape, rate: float, seed: torch.Tensor, row0: int, device) -> torch.Tensor:
    """Bool mask of ``shape`` (rows first): element e of the rows from
    ``row0`` on is kept when the hash of (seed, its index in the whole
    batch) falls below ``1 - rate``."""
    per_row = 1
    for d in shape[1:]:
        per_row *= d
    n = shape[0] * per_row
    idx = torch.arange(n, device=device, dtype=torch.int64) + row0 * per_row
    s = seed.to(device=device, dtype=torch.int64)
    h = _mix((idx & _M32) ^ _mix(s))
    h = _mix(h ^ _mix(s ^ 0x5BD1E995))
    u = (h >> 8).to(torch.float32) * (1.0 / 2**24)
    return (u < 1.0 - rate).reshape(shape)


def dropout(x: torch.Tensor, rate: float, seed: torch.Tensor, row0: int = 0,
            site=None) -> torch.Tensor:
    """``x`` (rows first) with each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``; ``row0`` is the index of x's first row
    in the whole batch.  ``site`` = (module, name) names the site for
    :func:`record_sites`.  The identity at rate 0."""
    if rate == 0.0:
        return x
    keep = keep_mask(tuple(x.shape), rate, seed, row0, x.device)
    if _RECORD is not None:
        _RECORD.append((site, float(rate), tuple(x.shape), keep.float().mean().item()))
    return x * (keep.to(x.dtype) * (1.0 / (1.0 - rate)))


@contextlib.contextmanager
def record_sites():
    """Collect ``(site, rate, shape, kept share)`` of every dropout a forward
    applies (the share read back from the device: for tests)."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


class Drops:
    """The dropout of one module's forward: its seeds (or None, when no site
    drops) and the part of a split batch it runs (``part`` of ``world``
    equal parts; the rows of a tensor start at ``part * rows`` in the whole
    batch).  ``drops(i, x, rate, module, name)`` applies site ``i``."""

    def __init__(self, seeds, part: int = 0):
        self.seeds, self.part = seeds, part

    @classmethod
    def draw(cls, n: int, active: bool, generator, device) -> "Drops":
        """``n`` seeds when ``active`` (training with a rate above 0), none
        otherwise (no draw: the generator's stream is as without dropout)."""
        if not active:
            return cls(None)
        return cls(draw_seeds(n, generator, device), getattr(generator, "rank", 0))

    def at(self, i: int) -> "Drops":
        """The sites from ``i`` on, numbered from 0 (a sub-module's)."""
        return self if self.seeds is None else Drops(self.seeds[i:], self.part)

    def __call__(self, i: int, x: torch.Tensor, rate: float, module=None, name: str = "",
                 row0: int = None):
        """Site ``i`` on ``x``, whose first row is row ``row0`` of the whole
        batch (default: this part's first, ``part * rows``)."""
        if self.seeds is None or rate == 0.0:
            return x
        if row0 is None:
            row0 = self.part * x.shape[0]
        return dropout(x, rate, self.seeds[i], row0, (module, name))


NO_DROPS = Drops(None)
