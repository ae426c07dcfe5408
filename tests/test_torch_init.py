"""The port's initialisation against the JAX package's, per tensor, at
``tiny_config(32)``.

``jax_init_state_dict`` (the train CLI's starting point) against
``tests/golden/jax_init_tiny32.json``, the statistics of ``mumpy_tpu``'s
``Mumpy.init`` that ``tests/make_jax_init_golden.py`` writes (no JAX compile
here): exact zeros and ones where JAX has them (biases, norm scales, the
CVA's ``proj_out``); elsewhere, each parameter's rule drawn until it has at
least 2000 values, as the file pooled JAX's draws, gives an RMS within 10%
of JAX's and a largest magnitude within 5% of JAX's (both truncate at two
stds).  The train CLI starts from that initialisation."""

import json
import math
from pathlib import Path

import pytest
import torch

from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.train import __main__ as train_cli
from mumpy_tpu_torch.utils.weight_port import draw_init, jax_init_rule, jax_init_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = json.loads((Path(__file__).resolve().parent / "golden" /
                     "jax_init_tiny32.json").read_text())
SAMPLES = 2000


@pytest.fixture(scope="module")
def model():
    return Mumpy(tiny_config(32))


def test_zeros_and_ones_where_jax_has_them(model):
    sd = jax_init_state_dict(model, seed=0)
    params = dict(model.named_parameters())
    assert set(GOLDEN) == set(params)
    kinds = {k: e["kind"] for k, e in GOLDEN.items()}
    for k, kind in kinds.items():
        t = sd[k]
        assert list(t.shape) == GOLDEN[k]["shape"], k
        if kind == "zeros":
            assert not t.any(), k
        elif kind == "ones":
            assert (t == 1).all(), k
        else:
            assert t.any() and not (t == 1).all(), k
    assert sum(k.endswith("cva.crossattn.proj_out.weight") and v == "zeros"
               for k, v in kinds.items()) == 8
    # from_jax_params, which wrote the golden keys, maps every tensor that a
    # plain block's training forward reads
    names = {id(p): k for k, p in params.items()}
    for blk in model.modules():
        if type(blk).__name__ == "SwinBlock":
            assert all(names[id(p)] in GOLDEN for p in blk.train_params())


def test_spread_matches_jax(model):
    modules = dict(model.named_modules())
    for k, e in GOLDEN.items():
        if e["kind"] != "random":
            continue
        shape = tuple(e["shape"])
        rule = jax_init_rule(k, modules[k.rsplit(".", 1)[0]], shape)
        draws = torch.cat([draw_init(rule, shape, torch.Generator().manual_seed(s)).reshape(-1)
                           for s in range(math.ceil(SAMPLES / math.prod(shape)))])
        rms = draws.double().pow(2).mean().sqrt().item()
        assert abs(rms / e["rms"] - 1) <= 0.1, (k, rms, e["rms"])
        assert abs(draws.abs().max().item() / e["max_abs"] - 1) <= 0.05, k


def test_train_cli_starts_from_it(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(train_cli, "train_loop", lambda state, *a, **kw: seen.update(
        sd=state.model.state_dict()))
    train_cli.main(["--tiny", "-imsize", "32", "-device", "cpu", "-seed", "5", "-seq_dir",
                    str(tmp_path), "-results_dir", str(tmp_path / "res")])
    want = jax_init_state_dict(Mumpy(tiny_config(32)), seed=5)
    assert seen["sd"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen["sd"][k], v), k
