"""The port's training path against the JAX package at ``tiny_config(128)``.

* One training step, f32, drop-path 0, the same weights (``random_state_dict``
  N(0, 0.2), carried into the JAX tree by ``port_state_dicts``), the same clip
  and masks: the port's loss (model in train mode through ``train_step``: the
  training kernels' plain versions on the CPU, the plain blocks under
  checkpoint) equals ``jax.grad`` of the JAX package's ``_loss_for_batch`` on
  its XLA path within 1e-5 relative, every parameter's gradient within
  1e-4 * max(1, max|g|) (JAX's gradients mapped to torch layouts by
  ``from_jax_params``), and one SGD step of each (the DVI recipe's groups,
  optax against the port's optimizer) within 1e-5 * max(1, max|p|).  The JAX
  gradient is compiled once, for the file; the parameter template comes from
  ``jax.eval_shape``.
* The drop-path schedule: every cross, plain and ViT block's rate equals the
  JAX package's arithmetic (``encoder.py``: ``dpr = linspace(0, rate,
  sum(view-3 depths))``, ``dpr[base]`` for the cross blocks, ``dpr[base+1 :
  base+d_v]`` for a view's plain blocks, ``linspace(0, rate, layers)`` for the
  ViT), and the keep factors repeat as the JAX package repeats them: one per
  sample over its windows and tokens in the cross blocks, one per (clip,
  token) over the three time slices in the ViT.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mumpy_tpu.configs.model_config as jcfg
import mumpy_tpu.utils.weight_port as jwp
import mumpy_tpu_torch.configs as pcfg
from mumpy_tpu.models.mumpy import Mumpy as JaxMumpy
from mumpy_tpu.train.optim import OptimConfig as JaxOptimConfig
from mumpy_tpu.train.optim import build_optimizer
from mumpy_tpu.train.trainer import _loss_for_batch
from mumpy_tpu_torch.models import encoder, swin
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train.optim import OptimConfig, Optimizer
from mumpy_tpu_torch.train.trainer import TrainState, train_step
from mumpy_tpu_torch.utils.serving import set_kernel_path
from mumpy_tpu_torch.utils.weight_port import from_jax_params, random_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

CFG, PORT_CFG = jcfg.tiny_config(128), pcfg.tiny_config(128)
ITER_MAX = 10


def _to_jax(model, template):
    enc = {k: v.detach().numpy() for k, v in model.encoder.state_dict().items()}
    dec = {k: v.detach().numpy() for k, v in model.decoder.state_dict().items()}
    orig = jwp.encoder_key_map
    jwp.encoder_key_map = functools.partial(
        orig, view_depths=tuple(v.depths for v in CFG.views))
    try:
        params, _ = jwp.port_state_dicts(enc, dec, template, allow_missing=False)
    finally:
        jwp.encoder_key_map = orig
    return params


@pytest.fixture(scope="module")
def step():
    rng = np.random.default_rng(5)
    clip = rng.standard_normal((2, 3, 128, 128, 3)).astype(np.float32)
    mask = (rng.random((2, 128 * 128)) < 0.3).astype(np.float32)
    jmodel = JaxMumpy(CFG)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clip)))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    model = Mumpy(PORT_CFG)
    model.load_state_dict(random_state_dict(model, seed=3, std=0.2))
    params = _to_jax(model, template)

    batch = {"image": jnp.asarray(clip), "mask": jnp.asarray(mask)}
    loss_fn = lambda p: _loss_for_batch(jmodel.apply, p, batch, jax.random.PRNGKey(0), False)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = build_optimizer(params, JaxOptimConfig(), ITER_MAX)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    state = TrainState(model, Optimizer(model.named_parameters(), OptimConfig(), ITER_MAX))
    metrics = train_step(state, {"image": clip, "mask": mask}, None)
    return {"model": model, "loss": float(metrics["total"]), "jax_loss": float(jloss),
            "jax_grads": from_jax_params(jax.device_get(jgrads), PORT_CFG),
            "jax_new": from_jax_params(jax.device_get(jnew), PORT_CFG)}


def test_train_loss_matches_jax(step):
    assert abs(step["loss"] - step["jax_loss"]) <= 1e-5 * abs(step["jax_loss"])


def test_every_gradient_matches_jax(step):
    grads = {k: p.grad for k, p in step["model"].named_parameters()}
    assert set(grads) == {k for k in step["jax_grads"] if not k.endswith("_index")}
    for k, g in grads.items():
        ref = step["jax_grads"][k]
        err = (g - ref).abs().max().item()
        assert err <= 1e-4 * max(1.0, ref.abs().max().item()), (k, err)


def test_sgd_step_matches_optax(step):
    for k, p in step["model"].named_parameters():
        ref = step["jax_new"][k]
        err = (p.detach() - ref).abs().max().item()
        assert err <= 1e-5 * max(1.0, ref.abs().max().item()), (k, err)


@pytest.mark.parametrize("name", ["multiswin_config", "tiny_config"])
def test_drop_path_schedule_matches_jax(name):
    jc = getattr(jcfg, name)(drop_path_rate=0.3) if name == "multiswin_config" else \
        dataclasses.replace(getattr(jcfg, name)(), drop_path_rate=0.3)
    pc = dataclasses.replace(getattr(pcfg, name)(), drop_path_rate=0.3)
    with torch.device("meta"):
        model = Mumpy(pc)
    depths = jc.views[2].depths
    dpr = np.linspace(0.0, jc.drop_path_rate, sum(depths))
    for s, stage in enumerate(model.encoder.layers.layers):
        base = sum(depths[:s])
        for v, vc in enumerate(jc.views, start=1):
            blocks = [getattr(g, f"block{v}") for g in stage.blocks if hasattr(g, f"block{v}")]
            assert len(blocks) == vc.depths[s]
            assert blocks[0].drop_path == pytest.approx(dpr[base])
            want = dpr[base + 1: base + vc.depths[s]]
            assert [b.drop_path for b in blocks[1:]] == pytest.approx(list(want))
    assert model.encoder.globalblocks.drop_path == pytest.approx(
        list(np.linspace(0.0, jc.drop_path_rate, jc.global_encoder.num_layers)))


def test_keep_rows_repeat_as_in_jax(monkeypatch):
    """Cross blocks: the attention half's keep rows are one factor per sample
    over its windows, the tail's one per sample over its tokens.  Plain
    blocks: both keep vectors one factor per sample over its windows.  ViT: the
    tail's rows, time-major, take one factor per (clip, token), the same in
    all three time slices, and a dropped row passes its input through."""
    seen = {"attn": [], "tail": [], "vit_tail": [], "block": []}

    def record(kind, plain):
        def fn(*args):
            seen[kind].append((args[0].shape, args[-1].clone()))
            if kind == "block":  # keep1 too
                seen[kind].append((args[0].shape, args[-2].clone()))
            return plain(*args)
        return fn

    monkeypatch.setattr(encoder, "attn_ln_train_plain",
                        record("attn", encoder.attn_ln_train_plain))
    monkeypatch.setattr(encoder, "ln_mlp_train_plain", record("tail", encoder.ln_mlp_train_plain))
    monkeypatch.setattr(swin, "ln_mlp_train_plain", record("vit_tail", swin.ln_mlp_train_plain))
    monkeypatch.setattr(swin, "swin_block_train_plain",
                        record("block", swin.swin_block_train_plain))
    model = Mumpy(dataclasses.replace(pcfg.tiny_config(32), drop_path_rate=0.5)).train()
    set_kernel_path(model, False)  # the sites call the plain versions by these names
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model(torch.zeros(2, 3, 32, 32, 3), generator=gen)
    assert len(seen["attn"]) == len(seen["tail"]) == 12 and len(seen["vit_tail"]) == 2
    for (shape, keep) in seen["attn"]:
        per = keep.reshape(2, -1)  # sample-major windows
        assert shape[0] == keep.numel() and (per == per[:, :1]).all()
    for (shape, keep) in seen["tail"]:
        per = keep.reshape(2, -1)
        assert (per == per[:, :1]).all()
    assert len(seen["block"]) == 2 * 9  # tiny_config: 3 x 3 plain blocks, two keeps each
    for (shape, keep) in seen["block"]:
        per = keep.reshape(2, -1)  # sample-major windows
        assert shape[0] == keep.numel() and (per == per[:, :1]).all()
    assert any((k != 1).any() for _, k in seen["block"])
    assert any((k != 1).any() for _, k in seen["attn"] + seen["tail"])
    for (shape, keep) in seen["vit_tail"]:
        slices = keep.reshape(3, -1)  # rows t * R + r
        assert (slices == slices[:1]).all() and slices.shape[1] == 2 * 1  # B * (1x1 tokens)

    blk = model.encoder.globalblocks.blocks[1]
    x = torch.randn(3, 4, 32)
    keep = torch.tensor([0.0, 2.0, 0.0, 2.0])
    with torch.no_grad():
        y = blk.train_forward(x, keep, keep)
    assert torch.equal(y[:, 0], x[:, 0]) and torch.equal(y[:, 2], x[:, 2])
    assert not torch.allclose(y[:, 1], x[:, 1])
