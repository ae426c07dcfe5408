"""Dropout in the port (``mumpy_tpu_torch/models/dropout.py``) on the CPU.

* The sites: a training forward of ``tiny_config(32)`` at ``drop_rate =
  attn_drop_rate = 0.1`` drops at exactly the JAX package's sites, each with
  its rate and shape, from ``tests/golden/jax_dropout_sites.json``
  (``tests/make_jax_baseline_golden.py``: the JAX forward with
  ``flax.linen.Dropout.__call__`` wrapped; a scanned stack lists its body's
  sites once).
* Eval mode has no dropout: the logits at rate 0.1 equal those at rate 0.
* Each site keeps about 1 - p of its elements and scales them by 1/(1 - p).
* The masks replay: at rate 0.1 the remat policies none, ``"full"`` and
  ``"dots"`` give one loss and one gradient from one seed (1e-6).
* The masks split by rows: two gloo ranks, each on its half of the batch,
  take the one-process step (1e-5), without either drawing the whole mask.
"""

import dataclasses
import datetime
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.dropout import dropout, record_sites
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.parallel import init_from_env, row_shard
from mumpy_tpu_torch.train.optim import OptimConfig, Optimizer
from mumpy_tpu_torch.train.trainer import TrainState, _loss_for_batch, train_step
from mumpy_tpu_torch.utils.serving import prepare_for_inference
from mumpy_tpu_torch.utils.weight_port import _plain_block_slot, random_state_dict
from torch_cases import free_port, one_torch_thread, rank_env, spawn_ranks  # noqa: F401

GOLDEN = json.loads((Path(__file__).resolve().parent / "golden" /
                     "jax_dropout_sites.json").read_text())
RATE, SEED, ROWS = GOLDEN["rate"], 5, 4
CFG = dataclasses.replace(tiny_config(32), drop_rate=RATE, attn_drop_rate=RATE,
                          drop_path_rate=0.2)


def build(cfg=CFG, remat=True, policy="full"):
    model = Mumpy(dataclasses.replace(cfg, remat=remat, remat_policy=policy))
    model.load_state_dict(random_state_dict(model, 3, fan_in=True))
    return model


def batch(rows=ROWS):
    rng = np.random.default_rng(SEED)
    return {"image": torch.from_numpy(rng.standard_normal((rows, 3, 32, 32, 3),
                                                          dtype=np.float32)),
            "mask": torch.from_numpy((rng.random((rows, 32 * 32)) < 0.3).astype(np.float32))}


def loss_and_grads(model, b, generator):
    model.zero_grad(set_to_none=True)
    loss, _ = _loss_for_batch(model, b, generator, True)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def jax_path(name, tag, depths):
    """The JAX package's path of the port's site (module ``name``, ``tag``)."""
    idx = {"probs": 0, "act": 0, "out": 1}[tag]
    parts = name.split(".")
    if parts[1] == "globalblocks":  # encoder.globalblocks.blocks.{i}.(attn|mlp)
        base, sub = "encoder/global_blocks/block", parts[4]
        return f"{base}/Dropout_{idx}" if sub == "attn" else f"{base}/mlp/Dropout_{idx}"
    s, i, v = int(parts[3]), int(parts[5]), int(parts[6][-1])
    if i == 0:
        mod = f"stage{s}_cross_view{v}"
    else:
        mod, pair, _ = _plain_block_slot(s, v, i, depths[v - 1][s])
        mod += f"/{pair}" if pair else ""
    return f"encoder/stages/{mod}/{'/'.join(parts[7:])}/Dropout_{idx}"


@pytest.fixture(scope="module")
def recorded():
    model = build()
    names = {id(m): n for n, m in model.named_modules()}
    with record_sites() as sites:
        loss_and_grads(model, {k: v[:GOLDEN["batch"]] for k, v in batch().items()},
                       torch.Generator().manual_seed(0))
    depths = [v.depths for v in CFG.views]
    return [(jax_path(names[id(mod)], tag, depths), rate, list(shape), share)
            for (mod, tag), rate, shape, share in sites]


def test_sites_match_jax(recorded):
    ours = sorted({(p, r, tuple(s)) for p, r, s, _ in recorded})
    assert ours == sorted((p, r, tuple(s)) for p, r, s in GOLDEN["sites"])


def test_keep_share_and_scale(recorded):
    """Each site of the forward keeps about 1 - p (within five standard
    deviations of its element count, all sites together within 1%), and a
    kept element is scaled by exactly 1 / (1 - p)."""
    n_all = kept_all = 0
    for path, rate, shape, share in recorded:
        n = int(np.prod(shape))
        assert abs(share - (1 - rate)) <= 5 * (rate * (1 - rate) / n) ** 0.5 + 1e-9, path
        n_all, kept_all = n_all + n, kept_all + share * n
    assert abs(kept_all / n_all - (1 - RATE)) < 0.01
    x = torch.full((64, 1000), 2.0)
    y = dropout(x, RATE, torch.tensor(7), row0=3)
    kept = y[y != 0]
    assert torch.allclose(kept, torch.full_like(kept, 2.0 / (1 - RATE)), rtol=1e-7, atol=0)
    # rows are drawn by their index in the batch: a slice from row 3 is rows 3.. of the whole
    whole = dropout(torch.full((67, 1000), 2.0), RATE, torch.tensor(7))
    assert torch.equal(whole[3:], y)


def test_eval_logits_unchanged_by_rates():
    clip = batch()["image"][:2]
    out = []
    for rate in (0.0, RATE):
        model = build(dataclasses.replace(CFG, drop_rate=rate, attn_drop_rate=rate))
        with torch.inference_mode():
            out.append(prepare_for_inference(model)(clip))
    assert torch.equal(out[0], out[1])


def test_remat_policies_replay_the_masks():
    b, grads = batch(), []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        grads.append(loss_and_grads(build(remat=remat, policy=policy), b,
                                    torch.Generator().manual_seed(1)))
    (loss0, g0) = grads[0]
    for loss, g in grads[1:]:
        assert abs(loss - loss0) <= 1e-6 * max(1.0, abs(loss0))
        bad = [n for n in g0 if (g[n] - g0[n]).abs().max() > 1e-6 * max(1.0, g0[n].abs().max())]
        assert not bad, bad[:5]


def new_state(dist=None):
    model = build()
    opt = Optimizer(model.named_parameters(), OptimConfig(), iter_max=10)
    return TrainState(model, opt) if dist is None else TrainState(model, opt, dist=dist)


def step(state, b):
    out = train_step(state, b, torch.Generator().manual_seed(2))
    return float(out["total"]), {n: p.grad.clone() for n, p in state.model.named_parameters()}


def rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    rank_env(rank, world, port)
    dist = init_from_env("cpu", timeout=datetime.timedelta(seconds=60))
    rows = row_shard(ROWS, world, rank)
    loss, grads = step(new_state(dist), {k: v[rows.start:rows.stop] for k, v in batch().items()})
    torch.save({"loss": loss, "grads": grads}, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_two_gloo_ranks_take_the_one_process_step(tmp_path):
    loss1, grads1 = step(new_state(), batch())
    spawn_ranks(rank_main, 2, (2, free_port(), str(tmp_path)), timeout=120)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert abs(np.mean([r["loss"] for r in ranks]) - loss1) <= 1e-5 * max(1.0, abs(loss1))
    for res in ranks:
        bad = [n for n, g in grads1.items()
               if (res["grads"][n] - g).abs().max() > 1e-5 * max(1.0, g.abs().max())]
        assert not bad, bad[:5]
