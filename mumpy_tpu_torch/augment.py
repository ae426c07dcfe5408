"""Clip-consistent augmentation (active reference ops only): the port's own
copy of ``mumpy_tpu/data/augment.py`` (numpy and PIL, no JAX), held against
it draw for draw by ``tests/test_torch_train_data.py``.

The reference's RandAugment draws ONE op per clip from
{Identity x4, HFlip, VFlip, PsccAug} (``utils/randaugment.py:542-576``, list at
``:634-654``) and applies it to every frame of every inpainting stream plus the
center-frame mask (``universaldataset.py:100-120``).  PsccAug picks one of 8
rot90/flip combinations — the reference's ``np.random.randint(0, 7)`` never selects
variant 7 (``randaugment.py:516``); that quirk is preserved.

Pure numpy on host-side uint8 frames; geometry-only ops so mask semantics are exact.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["clip_augment", "double_clip_augment"]


def _pscc(arr: np.ndarray, variant: int) -> np.ndarray:
    """PIL rotate is counter-clockwise; np.rot90 matches it for HWC arrays when
    applied with k on the (0, 1) axes after a vertical flip of coordinates —
    verified against PIL by the JAX package's data tests."""
    if variant == 0:
        return arr
    if variant in (1, 2, 3):
        return np.rot90(arr, k=variant, axes=(0, 1))
    if variant == 4:
        return arr[::-1]
    # 5/6/7: rotate then FLIP_TOP_BOTTOM
    return np.rot90(arr, k=variant - 4, axes=(0, 1))[::-1]


def clip_augment(
    streams: List[List[np.ndarray]], mask: np.ndarray, rng: np.random.Generator
) -> Tuple[List[List[np.ndarray]], np.ndarray]:
    """Apply one clip-consistent geometric op to all frames + mask."""
    op = rng.integers(0, 7)  # 0-3 identity, 4 hflip, 5 vflip, 6 pscc
    if op <= 3:
        return streams, mask
    if op == 4:  # horizontal flip (left-right)
        f = lambda a: np.ascontiguousarray(a[:, ::-1])
    elif op == 5:  # vertical flip (top-bottom)
        f = lambda a: np.ascontiguousarray(a[::-1])
    else:
        variant = int(rng.integers(0, 7))  # reference randint(0, 7) excl. 7
        f = lambda a: np.ascontiguousarray(_pscc(a, variant))
    streams = [[f(fr) for fr in frames] for frames in streams]
    return streams, f(mask)


# ---------------------------------------------------------------------------
# DoubleAugmentStrategy — adds one shape-changing op per clip
# (``utils/randaugment.py:606-631``): a crop / rotate / scale-crop drawn after
# the non-shape op.  Outputs are resized back to the clip's resolution so batch
# shapes stay static (the reference resizes in its transform chain).
# ---------------------------------------------------------------------------


def _mask_bbox(mask: np.ndarray):
    """Tight bbox of the positive mask region +/-1 (``randaugment.py:194-202``)."""
    rows = np.where(np.any(mask, axis=1))[0]
    cols = np.where(np.any(mask, axis=0))[0]
    if len(rows) == 0 or len(cols) == 0:
        return None
    return cols[0] - 1, rows[0] - 1, cols[-1] + 1, rows[-1] + 1  # l, t, r, b


def _crop_all(streams, mask, box):
    l, t, r, b = box
    f = lambda a: np.ascontiguousarray(a[t:b, l:r])
    return [[f(fr) for fr in fs] for fs in streams], f(mask)


def _rot_crop_box(w: int, h: int, angle_deg: float):
    """Largest axis-aligned rect inside a rotated image (``randaugment.py``'s
    ``rotate_image(crop=True)`` math)."""
    angle = angle_deg % 180
    if angle > 90:
        angle = 180 - angle
    theta = np.deg2rad(angle)
    hw = h / w
    numerator = np.cos(theta) + np.sin(theta) * np.tan(theta)
    r = hw if h > w else 1 / hw
    mult = numerator / (r * np.tan(theta) + 1) if theta > 0 else 1.0
    wc, hc = int(mult * w), int(mult * h)
    x0, y0 = (w - wc) // 2, (h - hc) // 2
    return x0, y0, x0 + wc, y0 + hc


def _resize_back(streams, mask, size):
    from PIL import Image

    w, h = size
    rs = lambda a, rl: np.asarray(
        Image.fromarray(a).resize((w, h), rl), dtype=a.dtype
    )
    streams = [[rs(fr, Image.BILINEAR) for fr in fs] for fs in streams]
    return streams, rs(mask.astype(np.uint8), Image.NEAREST).astype(mask.dtype)


def _apply_geom(streams, mask, f):
    return [[f(fr) for fr in fs] for fs in streams], f(mask)


def double_clip_augment(
    streams: List[List[np.ndarray]], mask: np.ndarray, rng: np.random.Generator
) -> Tuple[List[List[np.ndarray]], np.ndarray]:
    """One non-shape op + one shape-changing op, clip-consistent, shape-restoring.

    Matches the reference ``DoubleAugmentStrategy`` (``randaugment.py:627-631``):
    the first op is drawn from the none-shape list {HFlip, VFlip, PsccAug}
    (``:578-602``, always non-identity), the second from the 4-op shape list
    {RandomCrop, RandomRotate, OriginalRandomCrop, RandomScaleCrop} (``:606-613``).
    """
    from PIL import Image

    h, w = mask.shape[:2]

    # ---- non-shape op: HFlip / VFlip / Pscc (``none_shape_change_augment_list``)
    ns = int(rng.integers(0, 3))
    if ns == 0:
        f = lambda a: np.ascontiguousarray(a[:, ::-1])
    elif ns == 1:
        f = lambda a: np.ascontiguousarray(a[::-1])
    else:
        variant = int(rng.integers(0, 7))
        f = lambda a: np.ascontiguousarray(_pscc(a, variant))
    streams, mask = _apply_geom(streams, mask, f)

    # ---- shape-changing op (``shape_change_augment_list``)
    op = int(rng.integers(0, 4))
    if op == 0:
        # mask-preserving random crop (``randaugment.py:291-310``)
        box = _mask_bbox(mask)
        if box is not None:
            l, t, r, b = box
            cl = int(rng.integers(0, l - 1)) if l > 1 else 0
            cr = int(rng.integers(r + 1, w - 1)) if r + 1 < w - 1 else w - 1
            ct = int(rng.integers(0, t - 1)) if t > 1 else 0
            cb = int(rng.integers(b + 1, h - 1)) if b + 1 < h - 1 else h - 1
            streams, mask = _crop_all(streams, mask, (cl, ct, cr, cb))
        else:
            op = 1  # fall through to plain random crop (``:294-295``)
    if op == 1:
        # plain random crop of a random size (``randaugment.py:263-288``,
        # v ~ U[20, 220] on 224^2 inputs, scaled to the working resolution)
        cs = max(4, int(rng.uniform(20, 220) / 224 * min(w, h)))
        l = int(rng.integers(0, w - cs + 1))
        t = int(rng.integers(0, h - cs + 1))
        streams, mask = _crop_all(streams, mask, (l, t, l + cs, t + cs))
    elif op == 2:
        # rotate + largest-inscribed-rect crop (``randaugment.py:433-465``)
        angle = float(rng.uniform(0, 180))
        rot = lambda a: np.asarray(
            Image.fromarray(a).rotate(-angle, resample=Image.BILINEAR)
        )
        streams, mask = _apply_geom(streams, mask.astype(np.uint8), rot)
        mask = mask.astype(np.float32)
        streams, mask = _crop_all(streams, mask, _rot_crop_box(w, h, angle))
    elif op == 3:
        # random scale + pad + mask-aware corner crop (``randaugment.py:398-424``)
        short = int(rng.integers(max(4, h // 2), 2 * h + 1))
        ow, oh = (short, int(h * short / w)) if h > w else (int(w * short / h), short)
        rs = lambda a, rl: np.asarray(Image.fromarray(a).resize((ow, oh), rl))
        streams, _ = _apply_geom(streams, mask.astype(np.uint8),
                                 lambda a: rs(a, Image.BICUBIC))
        mask = rs(mask.astype(np.uint8), Image.NEAREST).astype(np.float32)
        if oh < h or ow < w:  # pad up to the original frame (``:413-418``)
            ph, pw = max(0, h - oh), max(0, w - ow)
            pad = lambda a: np.pad(a, ((0, ph), (0, pw)) + ((0, 0),) * (a.ndim - 2))
            streams, mask = _apply_geom(streams, mask, pad)
        box = _mask_bbox(mask)
        if box is not None:  # CornerCrop (``randaugment.py:377-395``)
            hh, ww = mask.shape[:2]
            l, t, r, b = box
            cl = int(rng.integers(0, l - 1)) if l > 1 else 0
            cr = int(rng.integers(r + 1, ww - 1)) if r + 1 < ww - 1 else ww - 1
            ct = int(rng.integers(0, t - 1)) if t > 1 else 0
            cb = int(rng.integers(b + 1, hh - 1)) if b + 1 < hh - 1 else hh - 1
            streams, mask = _crop_all(streams, mask, (cl, ct, cr, cb))
    return _resize_back(streams, mask, (w, h))
