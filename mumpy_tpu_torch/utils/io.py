"""Palette-preserving indexed-PNG mask IO, the port's copy of
``mumpy_tpu/utils/io.py`` (the reference's ``utils/io_aux.py``).

DAVIS / YouTube-VOS annotations are paletted PNGs whose pixel values are
label indices; reading them through ``convert("RGB")`` would destroy them.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

__all__ = ["imread_indexed", "imwrite_indexed", "default_palette"]


def imread_indexed(filename: str):
    """Read an indexed image: (labels uint8 (H, W), palette (256, 3) or None)."""
    im = Image.open(filename)
    annotation = np.atleast_3d(np.asarray(im))[..., 0]
    palette = im.getpalette()
    return annotation, (
        np.asarray(palette, dtype=np.uint8).reshape(-1, 3) if palette else None)


def imwrite_indexed(filename: str, array: np.ndarray, palette=None):
    """Save a label map as an indexed PNG with ``palette`` (default: DAVIS's)."""
    if array.ndim != 2:
        raise ValueError("saving indexed PNGs requires a 2D label array")
    im = Image.fromarray(array.astype(np.uint8), mode="P")
    pal = palette if palette is not None else default_palette()
    im.putpalette(np.asarray(pal, dtype=np.uint8).reshape(-1).tolist())
    im.save(filename, format="PNG")


def default_palette() -> np.ndarray:
    """The standard DAVIS 256-colour palette: colour i spreads the bits of i
    over r, g and b, high bit first (the reference's
    ``configs/davis/palette.txt``)."""
    palette = np.zeros((256, 3), dtype=np.uint8)
    for i in range(256):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        palette[i] = (r, g, b)
    return palette
