"""Every parameter of a model, by name and shape, and the seeded rule that
draws them on the device.

The rule is the fan-in-scaled normal: matrices and convolution kernels from
N(0, 1 / fan_in) (torch layouts, (out, in, ...)), the relative-position bias
tables from N(0, 1), LayerNorm and GroupNorm scales from 1 + N(0, 0.02),
every other vector from N(0, 0.02).  At any width every attention score,
mask+bias term and residual branch is then of order one, and no branch (the
cross-view attention's output projection among them) starts at zero beside
the residual stream it is added to.  All values come from one
``torch.randn`` of the seed's generator on the device, in the order of
:func:`spec`, so the benchmark draws the same weights for the program and
for the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MAT, TABLE, NORM, VEC = "mat", "table", "norm", "vec"

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _ln(spec: Spec, pre: str, c: int) -> None:
    spec += [(pre + "weight", (c,), NORM), (pre + "bias", (c,), VEC)]


def _gn(spec: Spec, pre: str, c: int) -> None:
    _ln(spec, pre, c)


def _lin(spec: Spec, pre: str, din: int, dout: int, bias: bool = True) -> None:
    spec.append((pre + "weight", (dout, din), MAT))
    if bias:
        spec.append((pre + "bias", (dout,), VEC))


def _conv(spec: Spec, pre: str, shape, bias: bool = True) -> None:
    spec.append((pre + "weight", tuple(shape), MAT))
    if bias:
        spec.append((pre + "bias", (shape[0],), VEC))


def _window(res: int, ws: int) -> int:
    return min(res, ws)


def _swin_block(spec: Spec, pre: str, c: int, heads: int, win: int) -> None:
    _ln(spec, pre + "norm1.", c)
    spec.append((pre + "attn.relative_position_bias_table", ((2 * win - 1) ** 2, heads), TABLE))
    _lin(spec, pre + "attn.qkv.", c, 3 * c)
    _lin(spec, pre + "attn.proj.", c, c)
    _ln(spec, pre + "norm2.", c)
    _lin(spec, pre + "mlp.fc1.", c, 4 * c)
    _lin(spec, pre + "mlp.fc2.", 4 * c, c)


def _cva(spec: Spec, pre: str, c: int) -> None:
    for p in ("proj_q", "proj_k", "proj_v", "proj_out"):
        _conv(spec, f"{pre}{p}.", (c, c, 1, 1))
    gc = c // 3
    _conv(spec, pre + "conv_offset.0.", (gc, 1, 5, 5))
    _ln(spec, pre + "conv_offset.1.norm.", gc)
    _conv(spec, pre + "conv_offset.3.", (2, gc, 1, 1), bias=False)


def mumpy_spec(cfg: dict) -> Spec:
    """The flagship's parameters (``configs/mumpy-flagship.json`` layout)."""
    if cfg.get("cva_kind", "deformable") != "deformable":
        raise ValueError("the reference has the deformable cross-view attention only")
    spec: Spec = []
    views = cfg["views"]
    for v, vc in enumerate(views, start=1):
        ph, pw, pt = vc["patch_size"]
        _conv(spec, f"encoder.tokenize.project{v}.", (vc["hidden_size"][0], 3, pt, ph, pw))
        _ln(spec, f"encoder.tokenize.norm{v}.", vc["hidden_size"][0])
    for s in range(4):
        res = views[0]["input_resolution"][s][0]
        for i in range(views[2]["depths"][s]):
            for v, vc in enumerate(views, start=1):
                if i >= vc["depths"][s]:
                    continue
                c, heads = vc["hidden_size"][s], vc["num_heads"][s]
                pre = f"encoder.layers.layers.{s}.blocks.{i}.block{v}."
                _swin_block(spec, pre, c, heads, _window(res, vc["window_size"]))
                if i == 0 and v < 3:
                    _lin(spec, pre + "pre.", views[v]["hidden_size"][s], c)
                    _cva(spec, pre + "cva.crossattn.", c)
        if s < 3:
            for v, vc in enumerate(views, start=1):
                c = vc["hidden_size"][s]
                pre = f"encoder.layers.layers.{s}.downsample.downsample{v}."
                _ln(spec, pre + "norm.", 4 * c)
                _lin(spec, pre + "reduction.", 4 * c, 2 * c, bias=False)
    ge = cfg["global_encoder"]
    _lin(spec, "encoder.globalembedding.", sum(vc["hidden_size"][3] for vc in views),
         ge["hidden_size"])
    for i in range(ge["num_layers"]):
        pre = f"encoder.globalblocks.blocks.{i}."
        c = ge["hidden_size"]
        _ln(spec, pre + "norm1.", c)
        _lin(spec, pre + "attn.qkv.", c, 3 * c)
        _lin(spec, pre + "attn.proj.", c, c)
        _ln(spec, pre + "norm2.", c)
        _lin(spec, pre + "mlp.fc1.", c, ge["mlp_dim"])
        _lin(spec, pre + "mlp.fc2.", ge["mlp_dim"], c)
    _decoder_spec(spec, cfg)
    return spec


def decoder_io(cfg: dict):
    """The flagship decoder's channel plan."""
    nc, k2 = cfg["decoder_num_classes"], cfg["decoder_dap_k"] ** 2
    feats = cfg["decoder_features"]
    enc_out = cfg["global_encoder"]["hidden_size"] * cfg["global_encoder"]["num_frames"]
    return {
        "freq": [(9, nc * k2), (nc * k2, nc * k2), (nc * k2, nc * k2), (nc * k2, nc),
                 (nc, nc * k2)],
        "freq_groups": [8, 8, 8, 4, 8],
        "gcm": [(feats[-1] + enc_out, nc * 4), (feats[-2], nc), (feats[-3], nc * k2),
                (feats[-4], nc * k2)],
        "seb": [(feats[-1], feats[-2]), (feats[-2] + feats[-1], feats[-3]),
                (feats[-3] + feats[-2] + feats[-1], feats[-4])],
        "up": [(nc, nc * k2), (nc * k2, nc * k2), (nc * k2, nc * k2), (nc * k2, nc * k2)],
        "nc": nc,
    }


def _decoder_spec(spec: Spec, cfg: dict) -> None:
    views = cfg["views"]
    feats = cfg["decoder_features"]
    t = max(cfg["input_token_temporal_dims"])
    ks = cfg["decoder_kernel_size"]
    for s in range(4):
        merged = sum(vc["hidden_size"][s] for vc in views)
        _conv(spec, f"decoder.rgb_decoder_{s + 1}.0.", (feats[s], merged, t, 1, 1))
        _gn(spec, f"decoder.rgb_decoder_{s + 1}.1.", feats[s])
    io = decoder_io(cfg)
    for i, (ci, co) in enumerate(io["freq"]):
        _conv(spec, f"decoder.decoder_frequency_{i}.1.", (co, ci, 3, 3))
        _gn(spec, f"decoder.decoder_frequency_{i}.2.", co)
    for g, (ci, co) in enumerate(io["gcm"], start=1):
        pre = f"decoder.gcm{g}."
        _conv(spec, pre + "conv_l1.", (co, ci, ks, 1))
        _conv(spec, pre + "conv_l2.", (co, co, 1, ks))
        _conv(spec, pre + "conv_r1.", (co, ci, 1, ks))
        _conv(spec, pre + "conv_r2.", (co, co, ks, 1))
    for i, (ci, co) in enumerate(io["seb"], start=1):
        _conv(spec, f"decoder.seb{i}.conv.", (co, ci, 3, 3))
    for i, (ci, co) in enumerate(io["up"], start=2):
        _conv(spec, f"decoder.decoder_{i}.0.", (co, ci, 3, 3))
        _gn(spec, f"decoder.decoder_{i}.1.", co)
    _conv(spec, "decoder.final_out.", (1, io["nc"], 3, 3))


def baseline_spec(cfg: dict) -> Spec:
    """The single-view baseline's parameters (``configs/swin-baseline.json``)."""
    spec: Spec = []
    ph, pw, pt = cfg["patch"]
    e = cfg["embed_dim"]
    _conv(spec, "encoder.patch_embed.proj.", (e, 3, pt, ph, pw))
    _ln(spec, "encoder.patch_embed.norm.", e)
    res = cfg["image_size"] // ph
    for s, depth in enumerate(cfg["depths"]):
        c = e * 2**s
        for i in range(depth):
            _swin_block(spec, f"encoder.layers.{s}.blocks.{i}.", c, cfg["num_heads"][s],
                        _window(res, cfg["window_size"]))
        if s < len(cfg["depths"]) - 1:
            _ln(spec, f"encoder.layers.{s}.downsample.norm.", 4 * c)
            _lin(spec, f"encoder.layers.{s}.downsample.reduction.", 4 * c, 2 * c, bias=False)
            res //= 2
    nf = e * 2 ** (len(cfg["depths"]) - 1)
    _ln(spec, "encoder.norm.", nf)
    cin = nf
    for i, f in enumerate(cfg["decoder_features"], start=1):
        _conv(spec, f"decoder.decoder_{i}.0.", (f, cin, 3, 3))
        _gn(spec, f"decoder.decoder_{i}.1.", f)
        cin = f
    _conv(spec, "decoder.final_out.", (1, cin, 3, 3))
    return spec


def spec(cfg: dict) -> Spec:
    kinds = {"mumpy": mumpy_spec, "swin_baseline": baseline_spec}
    return kinds[cfg["model"]](cfg)


def _scale(shape, kind: str) -> float:
    if kind == MAT:
        numel = 1
        for d in shape:
            numel *= d
        return (shape[0] / numel) ** 0.5
    return 1.0 if kind == TABLE else 0.02


def draw(cfg: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every parameter of ``cfg``'s model, drawn from
    ``seed`` in one ``torch.randn`` on ``device`` in ``dtype``, the type the
    cell serves or trains its master weights in.  The same call on the same
    device gives the same bits."""
    entries = spec(cfg)
    total = sum(_numel(shape) for _, shape, _ in entries)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, kind in entries:
        n = _numel(shape)
        t = flat[off:off + n].view(shape).mul_(_scale(shape, kind))
        if kind == NORM:
            t.add_(1.0)
        out[name] = t
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
