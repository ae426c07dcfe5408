"""The port's optimizer (``mumpy_tpu_torch/train/optim.py``) against the JAX
package's optax transforms (``mumpy_tpu/train/optim.py``).

* Group labels: every parameter of the port's model lands in the group that
  ``label_params`` gives its JAX counterpart (mapped by ``from_jax_params``).
* ``polynomial_schedule`` equals the JAX one, past ``iter_max`` too.
* sgd, adam and rmsprop (with the three groups' own learning rates and
  decays) take four steps on numpy-seeded parameters and gradients, and
  2-step accumulation (``optax.MultiSteps``) four steps; the parameters agree
  with optax's after every step within 1e-5 * max(1, max|p|) (f32
  arithmetic in another order; adam's bias corrections round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mumpy_tpu.configs.model_config as jcfg
import mumpy_tpu.train.optim as jopt
import mumpy_tpu_torch.configs as pcfg
from mumpy_tpu.models.mumpy import Mumpy as JaxMumpy
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train import optim
from mumpy_tpu_torch.utils.weight_port import from_jax_params
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

CODES = {"enc": 0.0, "dec": 1.0, "cva": 2.0}


def test_group_labels_match_jax():
    cfg = jcfg.tiny_config(32)
    shapes = jax.eval_shape(lambda: JaxMumpy(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32, 3))))["params"]
    labels = jopt.label_params(shapes)
    codes = jax.tree_util.tree_map(lambda lab, s: np.full(s.shape, CODES[lab], np.float32),
                                   labels, shapes)
    want = from_jax_params(codes, pcfg.tiny_config(32))
    model = Mumpy(pcfg.tiny_config(32))
    got = optim.label_params(n for n, _ in model.named_parameters())
    assert set(got.values()) == set(CODES)
    for name, label in got.items():
        assert (want[name] == CODES[label]).all(), name


def test_polynomial_schedule_matches_jax():
    ours = optim.polynomial_schedule(1e-2, 1e-5, 0.9, 10)
    ref = jopt.polynomial_schedule(1e-2, 1e-5, 0.9, 10)
    for count in range(14):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6)


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"encoder.a": (3, 4), "encoder.stage.cva.w": (4, 2), "decoder.b": (5,),
              "decoder.head.w": (2, 3)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + ".") if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _run(kind, accumulation, steps=4, iter_max=5):
    kw = dict(optim=kind, optim_cnn=kind, weight_decay=1e-2, weight_decay_cnn=3e-2,
              lr=1e-1, lr_cnn=3e-2, lr_cva=5e-2, accumulation_steps=accumulation)
    params = _trees(0)
    jparams = _nest(params)
    tx = jopt.build_optimizer(jparams, jopt.OptimConfig(**kw), iter_max)
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = optim.Optimizer(tparams.items(), optim.OptimConfig(**kw), iter_max)
    for i in range(steps):
        grads = _trees(100 + i)
        updates, jstate = tx.update(_nest(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, ref in _flat(jparams).items():
            err = np.abs(tparams[k].detach().numpy() - ref).max()
            assert err <= 1e-5 * max(1.0, np.abs(ref).max()), (kind, i, k, err)
    assert opt.count == steps // accumulation


@pytest.mark.parametrize("kind", ["sgd", "adam", "rmsprop"])
def test_optimizer_matches_optax(kind):
    _run(kind, accumulation=1)


def test_accumulation_matches_multisteps():
    _run("sgd", accumulation=2)
