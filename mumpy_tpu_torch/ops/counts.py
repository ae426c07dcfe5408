"""The kernels' launch counters: ``<wrapper>.launches`` (and
``.backward_launches`` on a differentiable kernel) add one where the wrapper
launches its kernel.  Callers read them and set them to 0 as plain
attributes; the increment goes through :func:`count_launch`, under one lock,
so that two serving threads launching at once lose no count."""

from __future__ import annotations

import threading

__all__ = ["count_launch"]

_LOCK = threading.Lock()


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to ``fn.<attr>`` (a read-modify-write, held under the lock)."""
    with _LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)
