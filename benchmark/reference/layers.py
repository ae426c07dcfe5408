"""Plain building blocks of both models, on channels-last tensors and a
parameter dict ``P`` keyed by the reference state_dict's names.

Windows: a (B, gh * gw, C) token grid is rolled by ``-shift`` and cut into
row-major windows of ``win * win`` tokens; the shifted windows' mask adds
-100 between tokens of different regions.  A Swin block is
``x + keep_a * proj(MSA(LN1 x) + mask+bias)`` then ``x + keep_m * fc2(gelu(fc1(LN2 x)))``
(exact GELU), its attention scaled by ``head_dim ** -0.5``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .context import Ctx

EPS = 1e-5


def layer_norm(x, P, pre):
    return F.layer_norm(x, (x.shape[-1],), P[pre + "weight"], P[pre + "bias"], EPS)


def partition(x, gh, gw, win, shift):
    """(B, gh*gw, C) -> (B*nW, win*win, C) windows of the ``roll(-shift)`` grid."""
    b, _, c = x.shape
    xs = x.reshape(b, gh, gw, c)
    if shift:
        xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
    xs = xs.reshape(b, gh // win, win, gw // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(-1, win * win, c)


def unpartition(w, gh, gw, win, shift):
    c = w.shape[-1]
    b = w.shape[0] // ((gh // win) * (gw // win))
    xs = w.reshape(b, gh // win, gw // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(b, gh, gw, c)
    if shift:
        xs = torch.roll(xs, (shift, shift), dims=(1, 2))
    return xs.reshape(b, gh * gw, c)


@functools.lru_cache(maxsize=None)
def _rel_index(win: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1).astype(np.int64)


def rel_bias(table, win):
    """(table_size, H) -> (H, N, N)."""
    n = win * win
    idx = torch.from_numpy(_rel_index(win)).to(table.device).reshape(-1)
    return table[idx].reshape(n, n, -1).permute(2, 0, 1)


@functools.lru_cache(maxsize=None)
def _shift_mask(gh: int, gw: int, win: int, shift: int) -> np.ndarray:
    img = np.zeros((gh, gw), dtype=np.int32)
    cuts = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    region = 0
    for hs in cuts:
        for ws in cuts:
            img[hs, ws] = region
            region += 1
    img = img.reshape(gh // win, win, gw // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    return np.where(img[:, None, :] != img[:, :, None], -100.0, 0.0).astype(np.float32)


def mask_bias(table, win, grid=None, shift=0):
    """The (P, H, N, N) additive term: the bias, plus the shift mask (period
    nW of one clip's grid) when the window shifts."""
    bias = rel_bias(table, win)
    if shift:
        mask = torch.from_numpy(_shift_mask(grid[0], grid[1], win, shift)).to(bias)
        return mask[:, None] + bias[None]
    return bias[None]


def window_msa(ctx: Ctx, P, pre, wins, heads, mb):
    """proj(softmax(q k^T * hd^-0.5 + mb) v) on windows (R, N, C); ``pre`` is
    the ``attn.`` prefix."""
    r, n, c = wins.shape
    hd = c // heads
    qkv = ctx.linear(wins, P[pre + "qkv.weight"], P[pre + "qkv.bias"]).reshape(r, n, 3, heads, hd)
    q, k, v = qkv.unbind(2)
    s = ctx.einsum("rqhd,rkhd->rhqk", q, k) * hd**-0.5
    p = mb.shape[0]
    s = (s.reshape(r // p, p, heads, n, n) + mb).reshape(r, heads, n, n)
    a = torch.softmax(s, dim=-1)
    o = ctx.einsum("rhqk,rkhd->rqhd", a, v).reshape(r, n, c)
    return ctx.linear(o, P[pre + "proj.weight"], P[pre + "proj.bias"])


def mlp(ctx: Ctx, P, pre, x):
    """fc2(gelu(fc1(x))), ``pre`` the ``mlp.`` prefix."""
    h = F.gelu(ctx.linear(x, P[pre + "fc1.weight"], P[pre + "fc1.bias"]))
    return ctx.linear(h, P[pre + "fc2.weight"], P[pre + "fc2.bias"])


def scale_rows(y, keep):
    return keep.to(y.dtype)[:, None, None] * y


def swin_block(ctx: Ctx, P, pre, grid, win, shift, heads, x, keep_a, keep_m):
    """One Swin block on image tokens (B, gh*gw, C)."""
    gh, gw = grid
    mb = mask_bias(P[pre + "attn.relative_position_bias_table"], win, grid, shift)
    wins = partition(layer_norm(x, P, pre + "norm1."), gh, gw, win, shift)
    y = unpartition(window_msa(ctx, P, pre + "attn.", wins, heads, mb), gh, gw, win, shift)
    x = x + scale_rows(y, keep_a)
    return x + scale_rows(mlp(ctx, P, pre + "mlp.", layer_norm(x, P, pre + "norm2.")), keep_m)


def patch_merge(ctx: Ctx, P, pre, x, grid):
    gh, gw = grid
    b, _, c = x.shape
    xs = x.reshape(b, gh // 2, 2, gw // 2, 2, c)
    xs = torch.cat([xs[:, :, 0, :, 0], xs[:, :, 1, :, 0], xs[:, :, 0, :, 1], xs[:, :, 1, :, 1]],
                   dim=-1).reshape(b, (gh // 2) * (gw // 2), 4 * c)
    return ctx.linear(layer_norm(xs, P, pre + "norm."), P[pre + "reduction.weight"])


def patch_tokens(ctx: Ctx, P, proj, norm, clip, patch):
    """Conv3d(kernel = stride = (pt, ph, pw)) and LayerNorm: clip
    (B, T, H, W, 3) -> (B, T' * h * w, C), frames past ``(T // pt) * pt`` dropped."""
    ph, pw, pt = patch
    b, t, h, w, c = clip.shape
    to = t // pt
    x = clip[:, : to * pt].reshape(b, to, pt, h // ph, ph, w // pw, pw, c)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, to * (h // ph) * (w // pw), -1)
    wgt = P[proj + "weight"]
    x = ctx.linear(x, wgt.reshape(wgt.shape[0], -1), P[proj + "bias"])
    return layer_norm(x, P, norm)


# --- channels-last image ops ---------------------------------------------------------


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv(ctx: Ctx, P, pre, x, padding):
    """A Conv2d of ``pre`` on a channels-last tensor."""
    return nhwc(ctx.conv2d(nchw(x), P[pre + "weight"], P.get(pre + "bias"), padding=padding))


def group_norm(P, pre, x, groups):
    return nhwc(F.group_norm(nchw(x), groups, P[pre + "weight"], P[pre + "bias"], EPS))


@functools.lru_cache(maxsize=None)
def _interp(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out, in) 1-D bilinear operator with torch ``nn.Upsample``'s source
    index (a negative overhang clamped to 0)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.astype(np.float32)
    for o in range(out_size):
        if align_corners:
            src = o * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = max((o + 0.5) * in_size / out_size - 0.5, 0.0)
        i0 = min(int(np.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        m[o, i0] += 1.0 - (src - i0)
        m[o, i1] += src - i0
    return m.astype(np.float32)


def upsample(ctx: Ctx, x, scale, align_corners=False):
    _, h, w, _ = x.shape
    mh = torch.from_numpy(_interp(h, h * scale, align_corners)).to(x)
    mw = torch.from_numpy(_interp(w, w * scale, align_corners)).to(x)
    y = ctx.einsum("oh,bhwc->bowc", mh, x)
    return ctx.einsum("ow,bhwc->bhoc", mw, y)


def conv_gn_relu_up(ctx: Ctx, P, pre, x, groups):
    x = F.relu(group_norm(P, pre + "1.", conv(ctx, P, pre + "0.", x, 1), groups))
    return upsample(ctx, x, 2, align_corners=True)
