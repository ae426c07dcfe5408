"""Operations and bytes of the model's kernel sites, from the configuration and
the batch alone.

A site is a place in the model's forward where one kind of work happens,
whatever implements it: a Swin block, a (shifted, plain) block pair, a
cross-view block's attention half (``attn_ln``) or MLP tail (``ln_mlp``), a
deformable cross-view attention core (``cva``), a global-ViT layer
(``vit3``).  The formulas count the matrix products and attention of each
site (two operations a multiply-add) and, for the bytes, each input read
once and each output written once in the served type: activations and
weights at 2 bytes (bf16), the additive mask+bias and the sample positions
at 4.  Because they are keyed by site and shape and not by the kernel that
runs the site, a later change of kernel leaves the numerator of a roofline
unchanged.

``site_bound_s`` is the least time the chip could take for one site:
max(flops / peak flops, bytes / peak bytes), from ``peaks.py``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, Tuple

from peaks import H100

ACT = 2  # bytes of a bf16 activation or weight
F32 = 4

N_TOKENS = 49  # tokens of a 7 x 7 window


def _block_flops(rows: int, n: int, c: int, m: int) -> int:
    """A Swin block on ``rows`` tokens in windows of ``n``: qkv, proj, fc1, fc2,
    and QK^T and PV."""
    return 2 * rows * (4 * c * c + 2 * c * m) + 4 * rows * n * c


def _block_weight_bytes(c: int, m: int, heads: int, n: int, period: int) -> int:
    weights = (4 * c * c + 2 * c * m) * ACT + (9 * c + m) * ACT  # matrices, biases, LNs
    return weights + period * heads * n * n * F32  # the (P, H, N, N) mask+bias


def sites(kind: str, cfg: dict, batch: int) -> Iterator[Tuple[str, int, int]]:
    """(site kind, flops, bytes) of every kernel site of one serving forward
    of ``batch`` clips of the configuration ``cfg`` (a file of ``configs/``)."""
    if kind == "mumpy":
        yield from _mumpy_sites(cfg, batch)
    elif kind == "swin_baseline":
        yield from _baseline_sites(cfg, batch)
    else:
        raise ValueError(f"no site formulas for model kind {kind!r}")


def _grid(image_size: int, s: int) -> int:
    return image_size // 4 // 2**s


def _mumpy_sites(cfg: dict, b: int):
    views = cfg["views"]
    ws = views[0]["window_size"]
    for s in range(4):
        g = _grid(cfg["image_size"], s)
        win = min(g, ws)
        n = win * win
        shifts = g > ws  # a window no smaller than the grid never shifts
        for v, vc in enumerate(views):
            c, heads, t = vc["hidden_size"][s], vc["num_heads"][s], vc["temporal_dim"]
            m = int(4 * c)  # the blocks' MLP ratio is 4
            rows = b * t * g * g
            xb = rows * c * ACT
            nw = rows // n
            # block 0: the cross-view block's attention half, CVA, MLP tail
            flops = 8 * rows * c * c + 4 * rows * n * c
            yield "attn_ln", flops, xb + (4 * c * c + 6 * c) * ACT + heads * n * n * F32 + 2 * xb
            if v < 2:  # view v attends to view v + 1
                t2 = views[v + 1]["temporal_dim"]
                b1, r = nw, nw * t2 // t
                flops = 4 * b1 * n * c * c + 4 * r * n * c * c + 4 * r * n * n * c
                nbytes = (b1 + r) * n * c * ACT + 2 * 3 * b1 * n * F32 + 4 * c * c * ACT \
                    + 3 * c * ACT + b1 * n * c * ACT
                yield "cva", flops, nbytes
            yield "ln_mlp", 4 * rows * c * m, 2 * xb + (2 * c * m + 3 * c + m) * ACT
            # blocks 1..d-1: (shifted, plain) pairs where the window shifts, then lone blocks
            plain = vc["depths"][s] - 1
            pairs = plain // 2 if shifts else 0
            for _ in range(pairs):
                yield ("swin_pair", 2 * _block_flops(rows, n, c, m),
                       2 * xb + 2 * _block_weight_bytes(c, m, heads, n, nw // b) + rows * 4)
            for i in range(plain - 2 * pairs):
                period = nw // b if (shifts and (2 * pairs + i) % 2 == 0) else 1
                yield ("swin_block", _block_flops(rows, n, c, m),
                       2 * xb + _block_weight_bytes(c, m, heads, n, period))
    ge = cfg["global_encoder"]
    side = _grid(cfg["image_size"], 3)
    rows = 3 * b * side * side  # time-major (3, B * 49, C)
    c, m = ge["hidden_size"], ge["mlp_dim"]
    for _ in range(ge["num_layers"]):
        yield ("vit3", 2 * rows * (4 * c * c + 2 * c * m) + 12 * rows * c,
               2 * rows * c * ACT + (4 * c * c + 2 * c * m + 9 * c + m) * ACT)


def _baseline_sites(cfg: dict, b: int):
    ws = cfg["window_size"]
    for s, depth in enumerate(cfg["depths"]):
        g = cfg["image_size"] // cfg["patch"][0] // 2**s
        win = min(g, ws)
        n = win * win
        c, heads = cfg["embed_dim"] * 2**s, cfg["num_heads"][s]
        rows = b * g * g
        nw = rows // n
        for i in range(depth):
            period = nw // b if (g > ws and i % 2) else 1
            yield ("swin_block", _block_flops(rows, n, c, 4 * c),
                   2 * rows * c * ACT + _block_weight_bytes(c, 4 * c, heads, n, period))


def site_bound_s(flops: int, nbytes: int, peaks=H100) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def bound_by_kind(kind: str, cfg: dict, batch: int, peaks=H100) -> Dict[str, float]:
    """{site kind: seconds}: the sum of the sites' bounds, per kind."""
    out = Counter()
    for site, flops, nbytes in sites(kind, cfg, batch):
        out[site] += site_bound_s(flops, nbytes, peaks)
    return dict(out)


def count_by_kind(kind: str, cfg: dict, batch: int) -> Dict[str, int]:
    return dict(Counter(site for site, _, _ in sites(kind, cfg, batch)))
