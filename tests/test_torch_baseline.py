"""The single-view Swin baseline (``mumpy_tpu_torch/models/baseline.py``)
against the JAX package's (``mumpy_tpu/models/baseline.py``), on the CPU,
from ``tests/golden/jax_baseline.npz`` (``tests/make_jax_baseline_golden.py``:
the JAX model at ``tiny_baseline_config``'s topology and half its widths, on
seeded unit-scale parameters, its eval logits with #1 in Pallas interpret
mode, and one training step's loss and gradients), so that no JAX is
compiled here:

* ``from_jax_baseline_params`` maps every JAX parameter onto the port's
  state_dict, with none missing or left over;
* the eval logits through ``prepare_for_inference`` (each block through
  ``swin_block``, whose CPU path is its plain version) within
  1e-4 * max(1, max|logit|);
* the training loss (each block through ``swin_block_train``'s plain
  version) within 1e-5 relative, every gradient within 1e-4 * max(1, max|g|);
* ``create_baseline()`` is Swin-B: 1024 features;
* the forward split over two CPU replicas equals the one-device forward
  (1e-6).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mumpy_tpu_torch.models.baseline import BaselineConfig, BaselineModel, create_baseline
from mumpy_tpu_torch.models.swin import SwinBlock
from mumpy_tpu_torch.train.trainer import _loss_for_batch
from mumpy_tpu_torch.utils.serving import make_serving_forward, prepare_for_inference
from mumpy_tpu_torch.utils.weight_port import from_jax_baseline_params
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = np.load(Path(__file__).resolve().parent / "golden" / "jax_baseline.npz")
# the golden writer's configuration (tests/make_jax_baseline_golden.py)
CFG = BaselineConfig(embed_dim=8, depths=(2, 2, 4, 2), num_heads=(2, 2, 2, 2), window_size=4,
                     image_size=32, drop_path_rate=0.0, decoder_features=(32,) * 5)


def tree(prefix):
    out = {}
    for key in GOLDEN.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = GOLDEN[key]
    return out


@pytest.fixture(scope="module")
def model():
    m = BaselineModel(CFG)
    m.load_state_dict(from_jax_baseline_params(tree("param/"), CFG))
    return m


def close(got, ref, tol):
    ref = torch.as_tensor(ref)
    return (got - ref).abs().max().item() <= tol * max(1.0, ref.abs().max().item())


def test_jax_parameters_map_one_to_one(model):
    sd = from_jax_baseline_params(tree("param/"), CFG)
    n_jax = sum(k.startswith("param/") for k in GOLDEN.files)
    params = dict(model.named_parameters())
    assert sd.keys() == model.state_dict().keys() and len(params) == n_jax
    assert sum(isinstance(m, SwinBlock) for m in model.modules()) == sum(CFG.depths)
    with pytest.raises(KeyError, match="no port counterpart"):
        extra = tree("param/")
        extra["encoder"]["spare"] = {"kernel": np.zeros(2)}
        from_jax_baseline_params(extra, CFG)


def test_logits_match_jax(model):
    with torch.inference_mode():
        logits = prepare_for_inference(model)(torch.from_numpy(GOLDEN["clip"]))
    assert logits.shape == GOLDEN["logits"].shape
    assert close(logits, GOLDEN["logits"], 1e-4)


def test_training_step_matches_jax(model):
    model.zero_grad(set_to_none=True)
    loss, _ = _loss_for_batch(model, {"image": GOLDEN["clip"], "mask": GOLDEN["mask"]},
                              torch.Generator().manual_seed(0), True)
    loss.backward()
    ref = float(GOLDEN["loss"])
    assert abs(loss.item() - ref) <= 1e-5 * abs(ref)
    want = from_jax_baseline_params(tree("grad/"), CFG)
    bad = [n for n, p in model.named_parameters() if not close(p.grad, want[n], 1e-4)]
    assert not bad, bad[:5]
    model.eval()


def test_create_baseline_is_swin_b():
    with torch.device("meta"):
        model = create_baseline()
    assert model.cfg.num_features == 1024
    assert [len(s.blocks) for s in model.encoder.layers] == [2, 2, 18, 2]


def test_split_over_two_replicas_equals_one_device(model):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 3, 32, 32, 3)).astype(np.float32))
    one = make_serving_forward(model, "cpu")(x)
    split = make_serving_forward(model, ["cpu", "cpu"])
    try:
        two = split(x)
    finally:
        split.close()
    assert (two - one).abs().max() <= 1e-6
