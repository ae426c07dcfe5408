"""Write the JAX package's results that ``tests/test_torch_baseline.py``,
``tests/test_torch_dropout.py`` and ``tests/test_torch_remat_window_cva.py``
hold the port to, so that none of them compiles JAX:

* ``tests/golden/jax_baseline.npz``: the baseline ablation model
  (``mumpy_tpu/models/baseline.py``) at ``BASE_CFG``, ``tiny_baseline_config``'s
  topology at half its widths; its parameters (numpy, seeded at unit-order
  scales: kernels at 1/sqrt(fan-in), norm scales about 1, biases 0.1, the
  relative-position tables at 1), a seeded clip and masks, the eval logits
  with the whole-block kernel #1 in Pallas interpret mode, and the loss and
  the gradient of every parameter of one training step (the trainer's
  ``_loss_for_batch``, training kernels off: the XLA path, drop-path 0);
* ``tests/golden/jax_window_cva.npz``: ``CrossWindowAttention`` on seeded
  inputs and parameters at ratio 1 and 3, and ``tiny_config(32)``'s eval
  logits with ``cva_kind="window"`` on the port's
  ``random_state_dict(seed=3, std=0.2)`` weights carried across by
  ``port_state_dicts`` (the window CVA's parameters, which it does not map,
  set here);
* ``tests/golden/jax_dropout_sites.json``: the dropout sites a training
  forward of ``tiny_config(32)`` at ``drop_rate = attn_drop_rate = 0.1`` calls
  at batch 2, each with its module path, rate and shape, recorded by wrapping
  ``flax.linen.Dropout.__call__`` here.  A scanned stack (the stage-2 pairs,
  the ViT layers) traces its body once, so its sites are listed once.

The reference does not change, so the files are written once:

    JAX_PLATFORMS=cpu python tests/make_jax_baseline_golden.py
"""

import dataclasses
import functools
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mumpy_tpu.configs.model_config as jcfg  # noqa: E402
import mumpy_tpu.utils.weight_port as jwp  # noqa: E402
import mumpy_tpu_torch.configs as pcfg  # noqa: E402
from mumpy_tpu.models.baseline import BaselineConfig, BaselineModel  # noqa: E402
from mumpy_tpu.models.deformable import CrossWindowAttention  # noqa: E402
from mumpy_tpu.models.mumpy import Mumpy as JaxMumpy  # noqa: E402
from mumpy_tpu.ops.pallas import swin_block, swin_block_vjp  # noqa: E402
from mumpy_tpu.train.trainer import _loss_for_batch  # noqa: E402
from mumpy_tpu_torch.models.mumpy import Mumpy  # noqa: E402
from mumpy_tpu_torch.utils.weight_port import random_state_dict  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"
BASE_CFG = dict(embed_dim=8, depths=(2, 2, 4, 2), num_heads=(2, 2, 2, 2), window_size=4,
                image_size=32, drop_path_rate=0.0, decoder_features=(32, 32, 32, 32, 32))
SIZE, BATCH, PARAM_SEED, CLIP_SEED, MASK_SEED, WEIGHT_SEED = 32, 2, 5, 11, 12, 3
# CrossWindowAttention cases: dim, heads, window, query windows
CWA = dict(dim=24, heads=3, window=4, b1=4)
DROP = 0.1


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def seeded_params(template, seed):
    """Every leaf of ``template`` drawn at a unit-order scale (see the module
    docstring), f32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, v in _flat(template):
        shape, leaf = tuple(v.shape), path[-1]
        if leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias":
            a = 0.1 * rng.standard_normal(shape)
        elif leaf == "relative_position_bias_table":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        out[path] = a.astype(np.float32)
    return _unflat(out)


def inputs(size=SIZE):
    clip = np.random.default_rng(CLIP_SEED).standard_normal(
        (BATCH, 3, size, size, 3)).astype(np.float32)
    mask = (np.random.default_rng(MASK_SEED).random((BATCH, size * size)) < 0.3).astype(
        np.float32)
    return clip, mask


def write_baseline_golden():
    model = BaselineModel(BaselineConfig(**BASE_CFG))
    clip, mask = inputs()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(clip)))
    params = seeded_params(shapes["params"], PARAM_SEED)
    swin_block.set_mode("interpret")
    logits = model.apply({"params": params}, jnp.asarray(clip))
    swin_block.set_mode("off")
    swin_block_vjp.set_train_mode("off")
    batch = {"image": jnp.asarray(clip), "mask": jnp.asarray(mask)}
    loss_fn = lambda p: _loss_for_batch(model.apply, p, batch, jax.random.PRNGKey(0),
                                        False)[0]
    loss, grads = jax.value_and_grad(loss_fn)(params)
    out = {"clip": clip, "mask": mask, "logits": np.asarray(logits, np.float32),
           "loss": np.float32(loss)}
    out.update({"param/" + "/".join(p): np.asarray(v) for p, v in _flat(params)})
    out.update({"grad/" + "/".join(p): np.asarray(v, np.float32)
                for p, v in _flat(jax.device_get(grads))})
    path = GOLDEN / "jax_baseline.npz"
    np.savez_compressed(path, **out)
    print(f"baseline: {len(list(_flat(params)))} parameters -> {path}")


def port_params(model, cfg, template):
    """The port model's weights on the JAX tree ``template`` (the window CVA's,
    which ``port_state_dicts`` does not map, by hand)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.") and ".cva." not in k}
    dec = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    orig = jwp.encoder_key_map
    jwp.encoder_key_map = functools.partial(
        orig, view_depths=tuple(v.depths for v in cfg.views))
    try:
        params, _ = jwp.port_state_dicts(enc, dec, template, allow_missing=True)
    finally:
        jwp.encoder_key_map = orig
    flat = dict(_flat(jax.tree_util.tree_map(np.asarray, params)))
    for key, v in sd.items():
        if ".cva.crossattn." not in key:
            continue
        s, v_, rest = key.split(".")[3], key.split(".")[6][-1], key.split(".cva.crossattn.")[1]
        base = ("encoder", "stages", f"stage{s}_cross_view{v_}", "cva", "crossattn")
        if rest == "relative_position_bias_table":
            flat[base + (rest,)] = v
        else:
            mod, leaf = rest.split(".")
            flat[base + (mod, "kernel" if leaf == "weight" else "bias")] = \
                v.T if leaf == "weight" else v
    return _unflat(flat)


def write_window_golden():
    out = {}
    rng = np.random.default_rng(21)
    c, h, win, b1 = CWA["dim"], CWA["heads"], CWA["window"], CWA["b1"]
    n = win * win
    for ratio in (1, 3):
        mod = CrossWindowAttention(c, h, window=win)
        x1 = rng.standard_normal((b1, n, c)).astype(np.float32)
        x2 = rng.standard_normal((ratio * b1, n, c)).astype(np.float32)
        shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), x1, x2))
        params = seeded_params(shapes["params"], 30 + ratio)
        y = mod.apply({"params": params}, x1, x2)
        out.update({f"r{ratio}/x1": x1, f"r{ratio}/x2": x2, f"r{ratio}/out": np.asarray(y)})
        out.update({f"r{ratio}/param/" + "/".join(p): v for p, v in _flat(params)})

    swin_block.set_mode("off")
    cfg = dataclasses.replace(jcfg.tiny_config(SIZE), cva_kind="window")
    model = Mumpy(dataclasses.replace(pcfg.tiny_config(SIZE), cva_kind="window"))
    model.load_state_dict(random_state_dict(model, seed=WEIGHT_SEED, std=0.2))
    clip, _ = inputs()
    jmodel = JaxMumpy(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clip)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    params = port_params(model, cfg, template)
    out["tiny32/logits"] = np.asarray(jmodel.apply({"params": params}, jnp.asarray(clip)),
                                      np.float32)
    path = GOLDEN / "jax_window_cva.npz"
    np.savez_compressed(path, **out)
    print(f"window CVA -> {path}")


def write_dropout_sites():
    sites = []
    orig = fnn.Dropout.__call__

    def recording(self, inputs, deterministic=None, rng=None):
        sites.append(("/".join(self.path), float(self.rate), list(inputs.shape)))
        return orig(self, inputs, deterministic=deterministic, rng=rng)

    swin_block_vjp.set_train_mode("off")
    cfg = dataclasses.replace(jcfg.tiny_config(SIZE), drop_rate=DROP, attn_drop_rate=DROP)
    model = JaxMumpy(cfg)
    clip, _ = inputs()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(clip)))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    fnn.Dropout.__call__ = recording
    try:
        jax.eval_shape(lambda p: model.apply({"params": p}, jnp.asarray(clip),
                                             deterministic=False,
                                             rngs={"dropout": jax.random.PRNGKey(1)}), params)
    finally:
        fnn.Dropout.__call__ = orig
    unique = sorted({(p, r, tuple(s)) for p, r, s in sites})
    path = GOLDEN / "jax_dropout_sites.json"
    path.write_text(json.dumps({"batch": BATCH, "size": SIZE, "rate": DROP,
                                "sites": [[p, r, list(s)] for p, r, s in unique]}, indent=0))
    print(f"{len(unique)} dropout sites ({len(sites)} calls) -> {path}")


if __name__ == "__main__":
    GOLDEN.mkdir(exist_ok=True)
    write_dropout_sites()
    write_window_golden()
    write_baseline_golden()
