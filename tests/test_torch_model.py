"""The port's whole serving model against the JAX package at ``tiny_config(128)``.

At 128^2 stage 2 is an 8x8 grid with window 4 and shift 2, so each view runs
one shifted (shifted, plain) pair through the ``swin_pair`` site and a lone
last block, and the global ViT runs time-major through ``vit3`` on t = 3.

* ``from_jax_params`` inverts ``mumpy_tpu/utils/weight_port.py:port_state_dicts``
  exactly.
* Logits: every parameter drawn from a seeded N(0, 0.2) (proj_out included,
  so the cross-view attention contributes), the same clip through both
  models in f32 — the port on its plain versions (CPU), JAX on its XLA path —
  within 1e-4 * max(1, max|logit|).  One JAX compile for the file.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mumpy_tpu.utils.weight_port as jwp
import mumpy_tpu.configs.model_config as jcfg
import mumpy_tpu_torch.configs as pcfg
from mumpy_tpu.models.mumpy import Mumpy as JaxMumpy
from mumpy_tpu_torch.models import swin
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.utils.serving import (make_serving_forward, prepare_for_inference,
                                           set_kernel_path)
from mumpy_tpu_torch.utils.weight_port import from_jax_params, random_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

CFG, PORT_CFG = jcfg.tiny_config(128), pcfg.tiny_config(128)


def _to_jax(model, template):
    enc = {k: v.numpy() for k, v in model.encoder.state_dict().items()}
    dec = {k: v.numpy() for k, v in model.decoder.state_dict().items()}
    orig = jwp.encoder_key_map
    jwp.encoder_key_map = functools.partial(
        orig, view_depths=tuple(v.depths for v in CFG.views))
    try:
        params, _ = jwp.port_state_dicts(enc, dec, template, allow_missing=False)
    finally:
        jwp.encoder_key_map = orig
    return params


@pytest.fixture(scope="module")
def case():
    clip = np.random.default_rng(1).standard_normal((2, 3, 128, 128, 3)).astype(np.float32)
    jmodel = JaxMumpy(CFG)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clip)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    model = Mumpy(PORT_CFG)
    model.load_state_dict(random_state_dict(model, seed=3, std=0.2))
    params = _to_jax(model, template)
    logits = np.asarray(jax.jit(lambda p, c: jmodel.apply({"params": p}, c))(
        params, jnp.asarray(clip)))
    return {"clip": clip, "model": model, "params": params, "jax_logits": logits}


def test_from_jax_params_roundtrip(case):
    sd = case["model"].state_dict()
    back = from_jax_params(case["params"], PORT_CFG)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_tiny_logits_match_jax(case):
    model = prepare_for_inference(case["model"])
    with torch.inference_mode():
        logits = model(torch.from_numpy(case["clip"])).numpy()
    ref = case["jax_logits"]
    assert logits.shape == ref.shape == (2, 128, 128, 1)
    assert np.abs(logits - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_relative_position_index_is_never_loaded():
    """The index buffer exists for checkpoint keys only: zeroing it changes
    nothing, because the bias gather recomputes the index."""
    model = Mumpy(PORT_CFG)
    blk = model.encoder.layers.layers[0].blocks[0].block1
    before = blk.attn.bias().clone()
    blk.attn.relative_position_index.zero_()
    assert torch.equal(blk.attn.bias(), before)


def test_forward_before_prepare_raises():
    """Kernel operands are built by prepare_for_inference only: a model that
    was not prepared refuses to run rather than build them on the fly."""
    model = Mumpy(PORT_CFG).eval()
    clip = torch.zeros(1, 3, 128, 128, 3)
    with pytest.raises(RuntimeError, match="prepare_for_inference"), torch.inference_mode():
        model(clip)


def test_serving_forward_returns_probabilities(case):
    fwd = make_serving_forward(case["model"], "cpu", torch.float32)
    probs = fwd(torch.from_numpy(case["clip"]))
    np.testing.assert_allclose(probs.numpy(), 1 / (1 + np.exp(-case["jax_logits"])),
                               atol=1e-5)


def test_tiny_forward_runs_pair_and_vit3_sites(case, monkeypatch):
    """The forward that matches JAX above goes through the new sites: per
    view one shifted pair and one lone stage-2 block, and the two ViT layers
    on time-major (3, B*16, 32) tokens."""
    calls = {"swin_pair": [], "swin_block": [], "vit3": []}
    for name in calls:
        plain = getattr(swin, f"{name}_plain")

        def record(x, ops, name=name, plain=plain):
            calls[name].append(tuple(x.shape))
            return plain(x, ops)

        monkeypatch.setattr(swin, f"{name}_plain", record)
    model = prepare_for_inference(case["model"])
    set_kernel_path(model, False)
    with torch.inference_mode():
        model(torch.from_numpy(case["clip"]))
    set_kernel_path(model, True)
    assert calls["swin_pair"] == [(8, 16, 48), (8, 16, 48), (24, 16, 96)]
    assert len(calls["swin_block"]) == 3
    assert calls["vit3"] == [(3, 32, 32)] * 2
