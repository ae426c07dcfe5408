"""The Mumpy flagship, plainly: the DCT frequency branch, three temporal-view
Swin pyramids with cross-view blocks and the deformable cross-view attention
(CVA), the global temporal ViT and the multi-pyramid decoder.

Equations, per stage s of the 4-stage pyramid (grids 56/28/14/7 at 224^2):

* block 0 of each view, from view 3 down to view 1 (``cross_block``):
  ``y = proj(MSA(LN1 x) + bias)`` on unshifted windows; ``out = y`` is the next
  view's partner stream; ``x1 = x + keep_a * y``; below view 3 the CVA adds
  ``x1w + keep_c * CVA(x1w, pre(partner windows))``, window-major, onto the
  image-major ``x1`` without a window reverse (the reference's order), times
  a second keep; then ``x1 + keep_m * MLP(LN2 x1)``;
* blocks 1..d-1: Swin blocks, odd ones shifted by view 1's half window;
* the CVA pairs partner window j of the batch with query window j % B1 and
  sums ``ratio`` consecutive partner windows' outputs (view 2 <- view 3 has
  ratio 3, and so reads across clips: the batch is never split);
* 2x2 patch merging between stages.

Then the views' last tokens, tiled to 3 time steps and concatenated, a Linear
to 768, 12 pre-LN ViT layers attending over the 3 time steps of each token,
and the decoder.  Drop-path keeps are drawn in the order the measured model
draws them, so one seed gives both the same keeps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .context import Ctx
from .layers import (conv, conv_gn_relu_up, group_norm, layer_norm, mlp, partition,
                     patch_merge, patch_tokens, rel_bias, scale_rows, swin_block, unpartition,
                     upsample, window_msa)
from .weights import decoder_io

# --- the DCT frequency branch -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dct(size: int) -> np.ndarray:
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]
    m = np.sqrt(2.0 / size) * np.cos((j + 0.5) * np.pi * i / size)
    m[0, :] = np.sqrt(1.0 / size)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bands(size: int) -> np.ndarray:
    """Low [0, size // 2.82], mid [size // 2.82, size // 2], high [size, 2 size]
    on i + j (the low/mid boundary in both)."""
    bounds = [(0.0, size // 2.82), (size // 2.82, size // 2), (float(size), 2.0 * size)]
    s = np.arange(size)[:, None] + np.arange(size)[None, :]
    return np.stack([((s >= lo) & (s <= hi)).astype(np.float32) for lo, hi in bounds])


def faf(ctx: Ctx, x):
    """(B, H, W, C) frame -> (B, H, W, 3C): each band's inverse DCT, band-major."""
    size = x.shape[-2]
    d = torch.from_numpy(_dct(size)).to(x)
    masks = torch.from_numpy(_bands(size)).to(x)
    f = ctx.einsum("ih,...hwc->...iwc", d, x)
    f = ctx.einsum("jw,...iwc->...ijc", d, f)
    banded = f[..., None, :, :, :] * masks[:, :, :, None]
    y = ctx.einsum("ih,...iwc->...hwc", d, banded)
    y = ctx.einsum("jw,...hjc->...hwc", d, y)
    y = torch.movedim(y, -4, -2)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])


# --- the deformable cross-view attention ---------------------------------------------


def _reference_points(ws: int) -> np.ndarray:
    c = (np.linspace(0.5, ws - 0.5, ws) / ws) * 2 - 1
    return np.stack(np.meshgrid(c, c, indexing="ij"), axis=-1).astype(np.float32)


def _axis_weights(coord, size):
    """(..., N) absolute coordinates -> (..., N, size) bilinear weights with
    zero padding outside [0, size - 1]."""
    idx = torch.arange(size, dtype=coord.dtype, device=coord.device)
    i0 = torch.floor(coord)
    frac = (coord - i0)[..., None]
    d0 = idx - i0[..., None]
    zero = torch.zeros((), dtype=coord.dtype, device=coord.device)
    return torch.where(d0 == 0, 1.0 - frac, torch.where(d0 == 1, frac, zero))


def cva(ctx: Ctx, P, pre, x1, x2, heads, ws, groups=3, offset_range=2.0):
    """Query windows ``x1`` (B1, N, C), partner windows ``x2`` (ratio*B1, N, C)
    -> (B1, N, C): offsets from a grouped depthwise conv on q, the partner
    windows sampled bilinearly there per group, attention of q (tiled in
    ``repeat`` order) over the samples' k and v, the ratio fold over
    consecutive rows, the output projection and its bias."""
    b1, n, c = x1.shape
    r = x2.shape[0]
    ratio = r // b1
    hd, gc = c // heads, c // groups
    wq = P[pre + "proj_q.weight"].reshape(c, c)
    q = ctx.linear(x1, wq, P[pre + "proj_q.bias"])
    # sample positions: conv_offset on each group's q, tanh-bounded, plus the cell centres
    qg = q.reshape(b1, ws, ws, groups, gc).permute(0, 3, 4, 1, 2).reshape(b1 * groups, gc, ws, ws)
    off = ctx.conv2d(qg, P[pre + "conv_offset.0.weight"], P[pre + "conv_offset.0.bias"],
                     padding=2, groups=gc)
    off = layer_norm(off.permute(0, 2, 3, 1), P, pre + "conv_offset.1.norm.")
    off = F.gelu(off).permute(0, 3, 1, 2)
    off = ctx.conv2d(off, P[pre + "conv_offset.3.weight"]).permute(0, 2, 3, 1)
    pos = torch.tanh(off) * (offset_range / ws) + torch.from_numpy(_reference_points(ws)).to(off)
    pos = pos.reshape(b1, groups, n, 2).permute(1, 0, 2, 3).float()
    gy = (pos[..., 0] + 1.0) * 0.5 * (ws - 1)
    gx = (pos[..., 1] + 1.0) * 0.5 * (ws - 1)
    wy = _axis_weights(gy.repeat(1, ratio, 1), ws)  # (g, R, N, ws)
    wx = _axis_weights(gx.repeat(1, ratio, 1), ws)
    xs = x2.reshape(r, ws, ws, groups, gc).float()  # the samples in float32, then x2's type
    smp = ctx.einsum("grny,grnx,ryxgc->rngc", wy, wx, xs).reshape(r, n, c).to(x2.dtype)
    k = ctx.linear(smp, P[pre + "proj_k.weight"].reshape(c, c), P[pre + "proj_k.bias"])
    v = ctx.linear(smp, P[pre + "proj_v.weight"].reshape(c, c), P[pre + "proj_v.bias"])
    qt = q.repeat(ratio, 1, 1)  # row j meets query j % B1
    s = ctx.einsum("rqhd,rkhd->rhqk", qt.reshape(r, n, heads, hd), k.reshape(r, n, heads, hd))
    a = torch.softmax(s * hd**-0.5, dim=-1)
    o = ctx.einsum("rhqk,rkhd->rqhd", a, v.reshape(r, n, heads, hd)).reshape(r, n, c)
    o = o.reshape(b1, ratio, n, c).sum(dim=1)
    return ctx.linear(o, P[pre + "proj_out.weight"].reshape(c, c), P[pre + "proj_out.bias"])


# --- the encoder ---------------------------------------------------------------------


def cross_block(ctx: Ctx, P, pre, res, win, heads, x1, x2, keeps):
    """Block 0 of a view: returns (x1 new, the attention branch ``out``)."""
    h, w = res
    b1, l1, c1 = x1.shape
    gh = (l1 // (h * w)) * h
    mb = rel_bias(P[pre + "attn.relative_position_bias_table"], win)[None]
    x1w = partition(x1, gh, w, win, 0)
    yw = window_msa(ctx, P, pre + "attn.", partition(layer_norm(x1, P, pre + "norm1."),
                                                     gh, w, win, 0), heads, mb)
    nw = x1w.shape[0] // b1
    x1w = x1w + keeps["attn"].repeat_interleave(nw).to(yw.dtype)[:, None, None] * yw
    out = unpartition(yw, gh, w, win, 0)
    x1i = unpartition(x1w, gh, w, win, 0)
    if x2 is not None:
        gh2 = (x2.shape[1] // (h * w)) * h
        x2w = ctx.linear(partition(x2, gh2, w, win, 0), P[pre + "pre.weight"], P[pre + "pre.bias"])
        y = cva(ctx, P, pre + "cva.crossattn.", x1w, x2w, heads, win)
        cw = x1w + keeps["cva"].to(y.dtype)[:, None, None] * y
        x1i = x1i + scale_rows(cw.reshape(b1, l1, c1), keeps["cva_res"])
    y = mlp(ctx, P, pre + "mlp.", layer_norm(x1i, P, pre + "norm2."))
    return x1i + scale_rows(y, keeps["mlp"]), out


def _cross_keeps(ctx: Ctx, b1, nw, rate, last, device):
    """The cross block's keeps in the order the model draws them."""
    keeps = {"attn": ctx.keep(b1, rate, device)}
    if not last:
        keeps["cva"] = ctx.keep(b1 * nw, rate, device)
        keeps["cva_res"] = ctx.keep(b1, rate, device)
    keeps["mlp"] = ctx.keep(b1, rate, device)
    return keeps


def _dpr(rate: float, n: int):
    return [float(r) for r in np.linspace(0.0, rate, n)]


def encoder(ctx: Ctx, P, cfg, clip):
    if cfg["drop_rate"] or cfg["attn_drop_rate"]:
        raise ValueError("the reference has no dropout")
    views_cfg = cfg["views"]
    dev = clip.device
    ffinfo = faf(ctx, clip[:, 1])
    x = [patch_tokens(ctx, P, f"encoder.tokenize.project{v}.", f"encoder.tokenize.norm{v}.",
                      clip, vc["patch_size"]) for v, vc in enumerate(views_cfg, start=1)]
    max_depths = views_cfg[2]["depths"]
    dpr = _dpr(cfg["drop_path_rate"], sum(max_depths))
    shift_of_view1 = views_cfg[0]["window_size"] // 2
    stage_outputs = []
    b = clip.shape[0]
    for s in range(4):
        base = sum(max_depths[:s])
        res = tuple(views_cfg[0]["input_resolution"][s])
        pre = f"encoder.layers.layers.{s}.blocks."
        out = None
        for v in (2, 1, 0):  # block 0: view 3 -> view 2 -> view 1
            vc = views_cfg[v]
            win = min(res[0], vc["window_size"])
            nw = vc["temporal_dim"] * (res[0] // win) * (res[1] // win)
            keeps = _cross_keeps(ctx, b, nw, dpr[base], v == 2, dev)
            block = functools.partial(cross_block, ctx, P, f"{pre}0.block{v + 1}.", res, win,
                                      vc["num_heads"][s])
            x[v], out = ctx.run(block, x[v], out, keeps)
        for v, vc in enumerate(views_cfg):
            win = min(res[0], vc["window_size"])
            grid = (vc["temporal_dim"] * res[0], res[1])
            shift = shift_of_view1 if res[0] > vc["window_size"] else 0
            depth = vc["depths"][s]
            keeps = [(ctx.keep(b, dpr[base + i], dev), ctx.keep(b, dpr[base + i], dev))
                     for i in range(1, depth)]
            for i in range(1, depth):
                block = functools.partial(swin_block, ctx, P, f"{pre}{i}.block{v + 1}.", grid, win,
                                          shift if i % 2 else 0, vc["num_heads"][s])
                x[v] = ctx.run(block, x[v], *keeps[i - 1])
        stage_outputs.append(list(x))
        if s < 3:
            x = [patch_merge(ctx, P, f"encoder.layers.layers.{s}.downsample.downsample{v + 1}.",
                             x[v], (vc["temporal_dim"] * res[0], res[1]))
                 for v, vc in enumerate(views_cfg)]
    merged = ctx.linear(merge_views(x, cfg["input_token_temporal_dims"]),
                        P["encoder.globalembedding.weight"], P["encoder.globalembedding.bias"])
    bm, t, n, c = merged.shape
    g = merged.transpose(0, 1).reshape(t, bm * n, c)
    ge = cfg["global_encoder"]
    for i, rate in enumerate(_dpr(cfg["drop_path_rate"], ge["num_layers"])):
        r = g.shape[1]
        ka, km = ctx.keep(r, rate, dev), ctx.keep(r, rate, dev)
        layer = functools.partial(vit_layer, ctx, P, f"encoder.globalblocks.blocks.{i}.",
                                  ge["num_heads"])
        g = ctx.run(layer, g, ka, km)
    feats = torch.cat(list(g), dim=-1).reshape(bm, n, t * c)
    side = views_cfg[0]["input_resolution"][-1][0]
    return feats.reshape(bm, side, side, t * c), stage_outputs, ffinfo


def vit_layer(ctx: Ctx, P, pre, heads, x, keep_a, keep_m):
    """A pre-LN ViT layer on time-major tokens (3, R, C), attending over time."""
    _, r, c = x.shape
    hd = c // heads
    h = layer_norm(x, P, pre + "norm1.")
    qkv = ctx.linear(h, P[pre + "attn.qkv.weight"], P[pre + "attn.qkv.bias"])
    q, k, v = qkv.reshape(3, r, 3, heads, hd).unbind(2)
    s = ctx.einsum("irhd,jrhd->rhij", q * hd**-0.5, k)
    o = ctx.einsum("rhij,jrhd->irhd", torch.softmax(s, dim=-1), v).reshape(3, r, c)
    y = ctx.linear(o, P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"])
    x = x + keep_a.to(y.dtype)[None, :, None] * y
    y = mlp(ctx, P, pre + "mlp.", layer_norm(x, P, pre + "norm2."))
    return x + keep_m.to(y.dtype)[None, :, None] * y


def merge_views(tokens, temporal_dims):
    """(B, T_i * n, C_i) views -> (B, maxT, n, sum C_i), each tiled along time."""
    max_t = max(temporal_dims)
    xs = []
    for t_dim, x in zip(temporal_dims, tokens):
        b, l, c = x.shape
        xs.append(x.reshape(b, t_dim, l // t_dim, c).repeat(1, max_t // t_dim, 1, 1))
    return torch.cat(xs, dim=-1)


# --- the decoder ---------------------------------------------------------------------


def _avg_pool(x, k):
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


def _pixel_shuffle(x, r):
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def _gcm(ctx: Ctx, P, pre, x, k):
    p = k // 2
    left = conv(ctx, P, pre + "conv_l2.", conv(ctx, P, pre + "conv_l1.", x, (p, 0)), (0, p))
    right = conv(ctx, P, pre + "conv_r2.", conv(ctx, P, pre + "conv_r1.", x, (0, p)), (p, 0))
    return left + right


def decoder(ctx: Ctx, P, cfg, feats, view_x, ffinfo):
    tdims = cfg["input_token_temporal_dims"]
    io = decoder_io(cfg)
    rgb = []
    for s in range(4):
        xm = merge_views(view_x[s], tdims)
        wgt = P[f"decoder.rgb_decoder_{s + 1}.0.weight"][..., 0, 0]  # (O, C, T)
        y = ctx.einsum("btnc,oct->bno", xm, wgt) + P[f"decoder.rgb_decoder_{s + 1}.0.bias"]
        height = cfg["views"][0]["input_resolution"][s][0]
        y = y.reshape(y.shape[0], height, y.shape[1] // height, -1)
        rgb.append(F.relu(group_norm(P, f"decoder.rgb_decoder_{s + 1}.1.", y, 16)))
    rgb1, rgb2, rgb3, rgb4 = rgb
    freq, f = [], ffinfo
    for i in range(5):
        pre = f"decoder.decoder_frequency_{i}."
        f = torch.sigmoid(group_norm(P, pre + "2.", conv(ctx, P, pre + "1.", _avg_pool(f, 2), 1),
                                     io["freq_groups"][i]))
        freq.append(f)
    freq0, freq1, freq2, freq3, freq4 = freq
    k = cfg["decoder_kernel_size"]

    def seb(i, x1, x2):
        return x1 * upsample(ctx, conv(ctx, P, f"decoder.seb{i}.conv.", x2, 1), 2)

    gcn0 = _gcm(ctx, P, "decoder.gcm1.", torch.cat([rgb4, feats], dim=-1), k)
    out1 = _pixel_shuffle(gcn0 * freq4, 2)
    gcn1 = _gcm(ctx, P, "decoder.gcm2.", seb(1, rgb3, rgb4), k)
    gcn2 = _gcm(ctx, P, "decoder.gcm3.",
                seb(2, rgb2, torch.cat([rgb3, upsample(ctx, rgb4, 2)], dim=-1)), k)
    gcn3 = _gcm(ctx, P, "decoder.gcm4.",
                seb(3, rgb1, torch.cat([rgb2, upsample(ctx, rgb3, 2), upsample(ctx, rgb4, 4)],
                                       dim=-1)), k)
    y = conv_gn_relu_up(ctx, P, "decoder.decoder_2.", gcn1 * freq3 + out1, 8)
    y = conv_gn_relu_up(ctx, P, "decoder.decoder_3.", y + gcn2 * freq2, 8)
    y = conv_gn_relu_up(ctx, P, "decoder.decoder_4.", y + gcn3 * freq1, 8)
    y = conv_gn_relu_up(ctx, P, "decoder.decoder_5.", y * freq0, 8)
    kk = cfg["decoder_dap_k"]
    y = y.reshape(*y.shape[:-1], y.shape[-1] // (kk * kk), kk * kk).mean(dim=-1)
    return conv(ctx, P, "decoder.final_out.", y, 1)


def forward(ctx: Ctx, P, cfg, clip):
    """clip (B, 3, H, W, 3) normalised frames -> logits (B, H, W, 1)."""
    feats, view_x, ffinfo = encoder(ctx, P, cfg, clip)
    return decoder(ctx, P, cfg, feats, view_x, ffinfo)
