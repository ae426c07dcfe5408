"""Weights between the JAX package and the port.

:func:`from_jax_params` maps a ``mumpy_tpu`` parameter tree (nested dicts of
numpy arrays, as ``model.init(...)["params"]`` or a restored checkpoint gives
it) to the state_dict of :class:`..models.mumpy.Mumpy`.  It is the inverse of
``mumpy_tpu/utils/weight_port.py:port_state_dicts``, whose layout flips it
undoes:

* Linear ``weight`` (out, in) <- Dense ``kernel`` (in, out);
* Conv2d (O, I, kh, kw) <- Conv (kh, kw, I, O); a 1x1 conv <- a Dense kernel;
* the tokenizer Conv3d (O, 3, t, ph, pw) <- Dense ((3, t, ph, pw) flat, O);
* the decoder's temporal Conv3d (O, C, T, 1, 1) <- Dense ((T, C) flat, O);
* LayerNorm / GroupNorm ``weight`` <- ``scale``;
* the scanned stacks (plain block pairs, global-ViT layers) are sliced along
  their leading axis;
* ``relative_position_index`` is computed, never read from a tree.

:func:`from_jax_baseline_params` does the same for the single-view
baseline (``mumpy_tpu/models/baseline.py``) and
:class:`..models.baseline.BaselineModel`.

:func:`random_state_dict` draws every parameter of a model from a seeded
normal distribution (numpy), so the port and the JAX package can be fed the
same non-trivial weights.  :func:`jax_init_state_dict` initialises a model
by the JAX package's rule for each parameter (flax's initialisers, as
``create_train_state`` draws them): the train CLI starts from it.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..configs import MumpyConfig

__all__ = ["from_jax_params", "from_jax_baseline_params", "random_state_dict",
           "jax_init_rule", "draw_init", "jax_init_state_dict"]


def _plain_block_slot(stage: int, view: int, i: int, depth: int):
    """(module, sub-module or None, stack index) of plain block ``i`` (1..d-1)
    in the JAX package's scanned layout: (shifted, plain) pairs plus a
    trailing shifted block when the count is odd."""
    n_plain = depth - 1
    j = i - 1
    if n_plain % 2 and j == n_plain - 1:
        return f"stage{stage}_last_view{view}", None, None
    return f"stage{stage}_pairs_view{view}", ("shifted", "plain")[j % 2], j // 2


def _leaf(name: str, torch_shape) -> str:
    if name == "weight":
        return "scale" if len(torch_shape) == 1 else "kernel"
    return name


def _block_path(rest: str):
    """A Swin / cross / ViT block's sub-key -> its JAX sub-path."""
    parts = rest.split(".")
    if parts[0] == "cva":  # cva.crossattn.<...>; the window kind's bias table sits there
        names = {"conv_offset.0": "offset_dwconv", "conv_offset.1.norm": "offset_norm",
                 "conv_offset.3": "offset_proj"}
        mod = ".".join(parts[2:-1])
        return ("cva", "crossattn") + ((names.get(mod, mod),) if mod else ()), parts[-1]
    return tuple(parts[:-1]), parts[-1]


def _jax_path(key: str, cfg: MumpyConfig):
    """Torch state_dict key of :class:`Mumpy` -> (JAX path prefix, leaf name,
    stack index or None)."""
    m = re.fullmatch(r"encoder\.(.*)", key)
    if m is None:
        m = re.fullmatch(r"decoder\.(.*)\.(weight|bias)", key)
        mod = m.group(1)
        mod = re.sub(r"^rgb_decoder_(\d)\.0$", r"rgb_decoder_\1.proj", mod)
        mod = re.sub(r"^rgb_decoder_(\d)\.1$", r"rgb_decoder_\1.gn", mod)
        mod = re.sub(r"^decoder_frequency_(\d)\.1$", r"decoder_frequency_\1.conv", mod)
        mod = re.sub(r"^decoder_frequency_(\d)\.2$", r"decoder_frequency_\1.gn", mod)
        mod = re.sub(r"^decoder_(\d)\.0$", r"decoder_\1.conv", mod)
        mod = re.sub(r"^decoder_(\d)\.1$", r"decoder_\1.gn", mod)
        return ("decoder",) + tuple(mod.split(".")), m.group(2), None
    k = m.group(1)
    m = re.fullmatch(r"tokenize\.(project|norm)(\d)\.(\w+)", k)
    if m:
        return (("encoder", f"tokenize_view{m.group(2)}",
                 "proj" if m.group(1) == "project" else "norm"), m.group(3), None)
    m = re.fullmatch(r"globalembedding\.(\w+)", k)
    if m:
        return ("encoder", "globalembedding"), m.group(1), None
    m = re.fullmatch(r"globalblocks\.blocks\.(\d+)\.(.*)", k)
    if m:
        sub, leaf = _block_path(m.group(2).replace("attn.", ""))
        return ("encoder", "global_blocks", "block") + sub, leaf, int(m.group(1))
    m = re.fullmatch(r"layers\.layers\.(\d)\.downsample\.downsample(\d)\.(\w+)\.(\w+)", k)
    if m:
        return (("encoder", "stages", f"stage{m.group(1)}_merge_view{m.group(2)}",
                 m.group(3)), m.group(4), None)
    m = re.fullmatch(r"layers\.layers\.(\d)\.blocks\.(\d+)\.block(\d)\.(.*)", k)
    s, i, v = int(m.group(1)), int(m.group(2)), int(m.group(3))
    sub, leaf = _block_path(m.group(4))
    if i == 0:
        return ("encoder", "stages", f"stage{s}_cross_view{v}") + sub, leaf, None
    mod, pair_sub, idx = _plain_block_slot(s, v, i, cfg.views[v - 1].depths[s])
    base = ("encoder", "stages", mod) + ((pair_sub,) if pair_sub else ())
    return base + sub, leaf, idx


def _convert(key: str, a: np.ndarray, shape) -> np.ndarray:
    """JAX-layout array -> the torch parameter of ``shape``."""
    shape = tuple(shape)
    if key.endswith("relative_position_bias_table"):
        return a
    if len(shape) == 5 and key.startswith("decoder.rgb_decoder_"):
        o, c, t = shape[:3]
        return a.reshape(t, c, o).transpose(2, 1, 0).reshape(shape)
    if len(shape) == 4 and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if len(shape) >= 2:
        return a.T.reshape(shape)  # Linear, 1x1 conv, tokenizer Conv3d
    return a.reshape(shape)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _state_dict_from_tree(params: Dict, template: Dict, jax_path) -> Dict[str, torch.Tensor]:
    """The state_dict of ``template``'s keys and shapes from the JAX tree
    ``params``, key by key through ``jax_path(key)`` -> (JAX path prefix,
    leaf, stack index or None); raises on a parameter missing on either
    side."""
    from ..models.swin import relative_position_index

    flat = {path: np.asarray(v) for path, v in _flatten(dict(params))}
    out = {}
    used = set()
    for key, t in template.items():
        if key.endswith("relative_position_index"):
            w = int(round(np.sqrt(t.shape[0])))
            out[key] = torch.from_numpy(relative_position_index(w, w).copy())
            continue
        prefix, leaf, idx = jax_path(key)
        path = prefix + (_leaf(leaf, t.shape),)
        if path not in flat:
            raise KeyError(f"{key}: JAX parameter {'/'.join(path)} not found")
        a = flat[path] if idx is None else flat[path][idx]
        out[key] = torch.from_numpy(np.ascontiguousarray(
            _convert(key, a, t.shape), dtype=np.float32))
        used.add(path)
    unused = set(flat) - used
    if unused:
        raise KeyError(f"JAX parameters with no port counterpart: {sorted(unused)[:5]}")
    return out


def from_jax_params(params: Dict, cfg: MumpyConfig) -> Dict[str, torch.Tensor]:
    """``mumpy_tpu`` Mumpy params -> state_dict of ``Mumpy(cfg)`` (either CVA
    kind)."""
    from ..models.mumpy import Mumpy

    with torch.device("meta"):
        template = Mumpy(cfg).state_dict()
    return _state_dict_from_tree(params, template, lambda key: _jax_path(key, cfg))


def _baseline_path(key: str):
    """Torch state_dict key of :class:`BaselineModel` -> (JAX path prefix,
    leaf, None): ``encoder.patch_embed.{proj,norm}``,
    ``encoder.layers.{s}.blocks.{i}`` <- ``encoder/stage{s}_block{i}``,
    ``encoder.layers.{s}.downsample`` <- ``encoder/stage{s}_merge``,
    ``encoder.norm``, ``decoder.decoder_{i}.{0,1}`` <- ``decoder/decoder_{i}/
    {conv,gn}``, ``decoder.final_out``."""
    *mods, leaf = key.split(".")
    m = re.fullmatch(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.(.*)", ".".join(mods))
    if m:
        sub, _ = _block_path(m.group(3) + "." + leaf)
        return ("encoder", f"stage{m.group(1)}_block{m.group(2)}") + sub, leaf, None
    mod = ".".join(mods)
    mod = re.sub(r"^encoder\.layers\.(\d+)\.downsample", r"encoder.stage\1_merge", mod)
    mod = re.sub(r"^decoder\.decoder_(\d)\.0$", r"decoder.decoder_\1.conv", mod)
    mod = re.sub(r"^decoder\.decoder_(\d)\.1$", r"decoder.decoder_\1.gn", mod)
    return tuple(mod.split(".")), leaf, None


def from_jax_baseline_params(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """``mumpy_tpu`` BaselineModel params (numpy) -> state_dict of
    ``BaselineModel(cfg)``, with no parameter missing or left over."""
    from ..models.baseline import BaselineModel

    with torch.device("meta"):
        template = BaselineModel(cfg).state_dict()
    return _state_dict_from_tree(params, template, _baseline_path)


def random_state_dict(model: torch.nn.Module, seed: int, std: float = 0.02,
                      fan_in: bool = False):
    """Every parameter drawn from N(0, std) with numpy's ``default_rng(seed)``
    (norm scales from N(1, std)), in state_dict order; buffers are kept.

    ``fan_in=True`` draws the matrices and convolution kernels from
    N(0, 1/fan_in) instead, and the relative-position bias tables from
    N(0, 1): at any width every attention score, mask+bias term and residual
    branch is then of order one, so no branch vanishes beside the residual
    stream it is added to."""
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    params = dict(model.named_parameters())
    norms = {f"{name}.weight" for name, mod in model.named_modules()
             if isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm))}
    out = {}
    for key, t in sd.items():
        if key not in params:
            out[key] = t
            continue
        scale = std
        if fan_in and key.endswith("relative_position_bias_table"):
            scale = 1.0
        elif fan_in and t.dim() >= 2:
            scale = (t.shape[0] / t.numel()) ** 0.5  # torch layouts: (out, in, ...)
        a = rng.standard_normal(tuple(t.shape), dtype=np.float32) * scale
        if key in norms:
            a += 1.0
        out[key] = torch.from_numpy(a)
    return out


def jax_init_rule(name: str, module: torch.nn.Module, shape) -> tuple:
    """The JAX package's initialiser of the port's parameter ``name`` (a
    state_dict key) of ``module``, as ``("zeros",)``, ``("ones",)`` or
    ``("trunc", std)``: a normal of that std truncated at two stds.

    * every bias, and the CVA's ``proj_out`` kernel (``deformable.py:113-115``)
      or, of the window kind, ``proj`` kernel (``:270``), so every CVA branch
      starts at 0: zeros;
    * LayerNorm and GroupNorm scales: ones;
    * the decoder's 2-D convolutions: flax's default ``lecun_normal``, a
      truncated normal of std 1 / sqrt(fan_in) after truncation (the
      untruncated std divided by 0.87962566103423978);
    * every other kernel and the relative-position tables:
      ``truncated_normal(0.02)`` (``models/swin.py:208``, ``:316-320``).
    """
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or name.endswith(("cva.crossattn.proj_out.weight",
                                        "cva.crossattn.proj.weight")):
        return ("zeros",)
    if isinstance(module, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
        return ("ones",)
    if name.startswith("decoder.") and isinstance(module, torch.nn.Conv2d):
        fan_in = int(np.prod(shape[1:]))
        return ("trunc", fan_in ** -0.5 / 0.87962566103423978)
    return ("trunc", 0.02)


def draw_init(rule: tuple, shape, generator: torch.Generator) -> torch.Tensor:
    """One f32 tensor drawn by ``rule`` (:func:`jax_init_rule`)."""
    if rule[0] == "zeros":
        return torch.zeros(shape)
    if rule[0] == "ones":
        return torch.ones(shape)
    std = rule[1]
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                       generator=generator)


def jax_init_state_dict(model: torch.nn.Module, seed: int):
    """A state_dict of ``model`` with every parameter drawn by the JAX
    package's rule for it (:func:`jax_init_rule`) from one seeded
    ``torch.Generator``, in state_dict order; buffers are kept.  The draws
    follow JAX's distributions, not its random stream."""
    gen = torch.Generator().manual_seed(seed)
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    out = {}
    for key, t in model.state_dict().items():
        if key not in params:
            out[key] = t
            continue
        mod = modules[key.rsplit(".", 1)[0]]
        out[key] = draw_init(jax_init_rule(key, mod, tuple(t.shape)), tuple(t.shape), gen)
    return out


def load_pretrained(model: torch.nn.Module, path: str, min_matched_frac: float = 0.5) -> int:
    """strict=False warm start of a :class:`..models.mumpy.Mumpy` from a
    torch checkpoint of the reference (the counterpart of
    ``mumpy_tpu/utils/weight_port.py:load_pretrained``): a raw encoder
    state_dict, an {"encoder", "decoder"} pair, or either nested under
    "state_dict" / "model".  The port's modules carry the reference's
    state_dict names, so keys copy over by name; ``module.`` prefixes are
    stripped and the recomputed buffers (``relative_position_index``,
    ``attn_mask``) skipped.  Raises when fewer than ``min_matched_frac`` of
    the checkpoint's parameters match by name and shape.  Returns the number
    copied."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "encoder" in blob and "decoder" in blob:
        parts = {"encoder": blob["encoder"], "decoder": blob["decoder"]}
    else:
        sd = blob.get("state_dict", blob.get("model", blob)) if isinstance(blob, dict) else blob
        parts = {"encoder": sd, "decoder": {}}
    own = model.state_dict()
    new, mappable = {}, 0
    for prefix, sd in parts.items():
        for key, value in sd.items():
            key = key[len("module."):] if key.startswith("module.") else key
            if key.endswith(("relative_position_index", "attn_mask")):
                continue
            mappable += 1
            name = f"{prefix}.{key}"
            if name in own and tuple(own[name].shape) == tuple(value.shape):
                new[name] = torch.as_tensor(value).to(own[name].dtype)
    if mappable and len(new) < min_matched_frac * mappable:
        raise ValueError(f"load_pretrained({path!r}): only {len(new)} of {mappable} "
                         "parameters match the model by name and shape")
    model.load_state_dict({**own, **new})
    return len(new)
