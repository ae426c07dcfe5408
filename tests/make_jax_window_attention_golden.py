"""Write the JAX package's window attention (#7) results that
``tests/test_torch_window_attention.py`` and ``tests/test_torch_attention_set.py``
hold the port to, so that neither test compiles JAX:

* ``tests/golden/jax_window_attention.npz``, the op: for each case of
  ``CASES``, seeded f32 inputs q, k, v (rows R = windows * heads, heads
  fastest), the periodic bias (P rows, the shift mask added where there is
  one), the head count and an output cotangent g; the output of ``fused_window_attention``
  in Pallas interpret mode; and dq, dk, dv, dbias of
  ``jax.vjp(window_attention_ad)`` under ``window_attention.set_mode("interpret")``.
* ``tests/golden/jax_attention_set_tiny32.npz``, the slice: ``tiny_config(32)``
  with ``swin_block.set_mode("off")`` (no whole-block kernels),
  ``swin_block_vjp.set_train_mode("off")`` (no training kernels) and
  ``window_attention.set_mode("interpret")``, the JAX package's
  ``MUMPY_FUSED_BLOCK=off MUMPY_PALLAS=on`` on the CPU, on the weights
  ``random_state_dict(seed=3, std=0.2)`` of the port carried across by
  ``mumpy_tpu/utils/weight_port.py:port_state_dicts``: the eval logits of
  ``CLIP_SEED``'s clip, and the training loss of that clip and
  ``MASK_SEED``'s masks with the gradient of every ``attn.qkv``,
  ``attn.proj`` and ``relative_position_bias_table`` parameter (the ones
  that flow through #7), in the port's layout (``from_jax_params``).

The reference does not change, so the files are written once:

    JAX_PLATFORMS=cpu python tests/make_jax_window_attention_golden.py
"""

import functools
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mumpy_tpu.configs.model_config as jcfg  # noqa: E402
import mumpy_tpu.utils.weight_port as jwp  # noqa: E402
import mumpy_tpu_torch.configs as pcfg  # noqa: E402
from mumpy_tpu.models.mumpy import Mumpy as JaxMumpy  # noqa: E402
from mumpy_tpu.ops.pallas import swin_block, swin_block_vjp, window_attention  # noqa: E402
from mumpy_tpu.ops.window import shifted_window_mask  # noqa: E402
from mumpy_tpu.train.trainer import _loss_for_batch  # noqa: E402
from mumpy_tpu_torch.models.mumpy import Mumpy  # noqa: E402
from mumpy_tpu_torch.utils.weight_port import from_jax_params, random_state_dict  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"
# name -> (windows, heads, head width, window side, shifted grid side or 0)
CASES = {"bias_n49": (4, 3, 8, 7, 0), "mask_n16": (8, 2, 8, 4, 8), "mask_n9": (8, 2, 4, 3, 6)}
SIZE, BATCH, WEIGHT_SEED, CLIP_SEED, MASK_SEED = 32, 2, 3, 11, 12
GRAD_KEYS = ("attn.qkv.", "attn.proj.", "relative_position_bias_table")


def op_case(name):
    """Seeded inputs of one case: q, k, v (R, N, D), bias (P, N, N), g."""
    windows, heads, d, win, grid = CASES[name]
    n = win * win
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, g = (rng.standard_normal((windows * heads, n, d)).astype(np.float32)
                  for _ in range(4))
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    if grid:  # the shift mask of a (grid, grid) image, batch windows // nW
        mask = np.asarray(shifted_window_mask(grid, grid, win, win // 2))
        bias = (mask[:, None] + bias[None]).reshape(-1, n, n)
    return q, k, v, bias, g


def write_op_golden():
    window_attention.set_mode("interpret")
    out = {}
    for name in CASES:
        q, k, v, bias, g = op_case(name)
        o = window_attention.fused_window_attention(q, k, v, bias, interpret=True)
        _, vjp = jax.vjp(window_attention.window_attention_ad, q, k, v, bias)
        grads = vjp(jnp.asarray(g))
        for key, val in zip(("q", "k", "v", "bias", "g", "out", "dq", "dk", "dv", "dbias"),
                            (q, k, v, bias, g, o, *grads)):
            out[f"{name}/{key}"] = np.asarray(val, np.float32)
        out[f"{name}/heads"] = np.int64(CASES[name][1])
    path = GOLDEN / "jax_window_attention.npz"
    np.savez_compressed(path, **out)
    print(f"{len(CASES)} cases -> {path}")


def slice_inputs():
    """The port's model on its seeded weights, the clip and the masks."""
    model = Mumpy(pcfg.tiny_config(SIZE))
    model.load_state_dict(random_state_dict(model, seed=WEIGHT_SEED, std=0.2))
    clip = np.random.default_rng(CLIP_SEED).standard_normal(
        (BATCH, 3, SIZE, SIZE, 3)).astype(np.float32)
    mask = (np.random.default_rng(MASK_SEED).random((BATCH, SIZE * SIZE)) < 0.3).astype(
        np.float32)
    return model, clip, mask


def write_slice_golden():
    swin_block.set_mode("off")
    swin_block_vjp.set_train_mode("off")
    window_attention.set_mode("interpret")
    cfg = jcfg.tiny_config(SIZE)
    model, clip, mask = slice_inputs()
    jmodel = JaxMumpy(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clip)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    enc = {k: v.detach().numpy() for k, v in model.encoder.state_dict().items()}
    dec = {k: v.detach().numpy() for k, v in model.decoder.state_dict().items()}
    orig = jwp.encoder_key_map
    jwp.encoder_key_map = functools.partial(
        orig, view_depths=tuple(v.depths for v in cfg.views))
    try:
        params, _ = jwp.port_state_dicts(enc, dec, template, allow_missing=False)
    finally:
        jwp.encoder_key_map = orig

    logits = jax.jit(lambda p, c: jmodel.apply({"params": p}, c))(params, jnp.asarray(clip))
    batch = {"image": jnp.asarray(clip), "mask": jnp.asarray(mask)}
    loss_fn = lambda p: _loss_for_batch(jmodel.apply, p, batch, jax.random.PRNGKey(0),
                                        False)[0]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = from_jax_params(jax.device_get(grads), pcfg.tiny_config(SIZE))
    out = {"logits": np.asarray(logits, np.float32), "loss": np.float32(loss)}
    out.update({f"grad/{k}": v.numpy() for k, v in grads.items()
                if any(s in k for s in GRAD_KEYS)})
    path = GOLDEN / "jax_attention_set_tiny32.npz"
    np.savez_compressed(path, **out)
    print(f"{len(out) - 2} gradients -> {path}")


if __name__ == "__main__":
    GOLDEN.mkdir(exist_ok=True)
    write_op_golden()
    write_slice_golden()
