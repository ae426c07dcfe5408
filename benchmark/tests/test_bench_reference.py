"""The frozen reference against the port's plain path, on the CPU at test size.

The reference must compute what the port's plain path computes: the same
parameters by name and shape, the same logits in eval, and over three SGD
steps with drop-path the same losses, first-step gradients and parameter
changes (the keeps drawn from one seed in the same order).  This test may
import the port; the reference itself imports none of it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import pytest
import torch

import program
import tiny
from reference import train as ref_train
from reference import weights as ref_weights
from reference.context import Ctx

RECIPE = json.loads((tiny.BENCH / "workloads" / "flagship-train-b192.json").read_text())["recipe"]


def _port_model(cfg, weights):
    from mumpy_tpu_torch.utils.serving import prepare_for_inference, set_kernel_path

    model = program.build_model(cfg, weights, "cpu")
    set_kernel_path(model, False)
    return prepare_for_inference(model)


@pytest.mark.parametrize("name", ["mumpy-flagship", "swin-baseline"])
def test_config_files_are_the_ports_published_configurations(name):
    from mumpy_tpu_torch.configs import multiswin_config
    from mumpy_tpu_torch.models.baseline import BaselineConfig

    cfg = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    want = multiswin_config() if name == "mumpy-flagship" else BaselineConfig()
    assert program.port_config(cfg) == want


@pytest.mark.parametrize("name", ["mumpy-flagship", "swin-baseline", "tiny-flagship",
                                  "tiny-baseline"])
def test_spec_names_every_parameter_of_the_port(name):
    from mumpy_tpu_torch.models.baseline import BaselineModel
    from mumpy_tpu_torch.models.mumpy import Mumpy

    if name.startswith("tiny"):
        cfg = tiny.tiny_configs()[name]
    else:
        cfg = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    with torch.device("meta"):
        model = (Mumpy if cfg["model"] == "mumpy" else BaselineModel)(program.port_config(cfg))
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert {n: tuple(s) for n, s, _ in ref_weights.spec(cfg)} == port


@pytest.mark.parametrize("name", ["tiny-flagship", "tiny-baseline"])
def test_eval_logits_match_the_ports_plain_path(name):
    cfg = tiny.tiny_configs()[name]
    size = cfg["image_size"]
    clip = torch.randn(2, 3, size, size, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = _port_model(cfg, ref_weights.draw(cfg, 5, "cpu"))(clip)
        ref = ref_train.forward(Ctx(), ref_weights.draw(cfg, 5, "cpu"), cfg, clip)
    assert (got - ref).abs().max() <= 1e-4 * max(1.0, float(ref.abs().max()))


def _leaf_gap(got, ref):
    floor = statistics.median(ref.values())
    return max(abs(got[n] - ref[n]) / max(ref[n], floor) for n in ref)


@pytest.mark.parametrize("name", ["tiny-flagship", "tiny-baseline"])
def test_three_sgd_steps_with_drop_path_match_the_ports_plain_path(name):
    """f32 on both sides, drop-path 0.2: the keeps come from one seed in one
    order, or the losses would part."""
    import compare
    import traffic

    cfg = tiny.tiny_configs()[name]
    mix = {"batch": 4, "pool": 3, "frames": 3,
           "mask": {"rectangles": 1, "side_min": 0.1, "side_max": 0.34, "corner_max": 0.66}}
    batches = traffic.train_pool(mix, cfg["image_size"], 11, "cpu")
    model = program.build_model(cfg, ref_weights.draw(cfg, 5, "cpu"), "cpu")
    state = program.train_state(model, RECIPE, "blocks")
    from mumpy_tpu_torch.utils.serving import set_kernel_path

    set_kernel_path(model, False)
    params = program.parameters(state)
    p0 = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator().manual_seed(17)
    losses = []
    for i, batch in enumerate(batches):
        losses.append(float(program.train_step(state, batch, gen, None)["total"]))
        if i == 0:
            grad = compare.leaf_norms(program.optimizer_gradients(state))
    change = compare.leaf_norms({n: params[n].detach() - p0[n] for n in params})
    ref = ref_train.first_steps(cfg, ref_weights.draw(cfg, 5, "cpu"), batches, RECIPE,
                                torch.Generator().manual_seed(17))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    assert _leaf_gap(grad, ref["grad"]) <= 1e-4
    # three steps compound f32 summation order (the baseline's GroupNorm(32)
    # over 2 x 2 pixels at test size reads 3e-4)
    assert _leaf_gap(change, ref["change"]) <= 1e-3


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = [sys.argv[1]]\n"
            "import reference, reference.mumpy, reference.baseline, reference.train, "
            "reference.weights, reference.precision, reference.context, reference.layers\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mumpy_tpu', 'mumpy_tpu_torch'})\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(tiny.BENCH)], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_weights_are_drawn_by_the_fan_in_rule():
    cfg = tiny.tiny_configs()["tiny-flagship"]
    spec = {n: (s, k) for n, s, k in ref_weights.spec(cfg)}
    w = ref_weights.draw(cfg, 9, "cpu")
    assert torch.equal(w["encoder.globalembedding.weight"],
                       ref_weights.draw(cfg, 9, "cpu")["encoder.globalembedding.weight"])
    for name, t in w.items():
        shape, kind = spec[name]
        if kind == ref_weights.MAT and t.numel() >= 4096:
            fan_in = t.numel() // shape[0]
            assert float(t.std()) == pytest.approx(fan_in ** -0.5, rel=0.1), name
        if kind == ref_weights.NORM:
            assert float(t.mean()) == pytest.approx(1.0, abs=0.05), name
    # the CVA's output projection is not zero: the comparison sees the CVA
    assert float(w["encoder.layers.layers.0.blocks.0.block1.cva.crossattn.proj_out.weight"]
                 .abs().max()) > 0.1
