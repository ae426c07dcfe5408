"""Data-parallel training of the port (``mumpy_tpu_torch/parallel``, the
trainer under ``torchrun``) on the CPU: 2 and 4 gloo ranks, spawned, against
the one-process step.

How the port is held against the reference here: this file holds the W-rank
step against the port's one-process step; ``tests/test_torch_train_model.py``
holds the one-process step against the JAX package's; and
``__graft_entry__.dryrun_multichip`` holds the JAX package's sharded step
against its single-device step.  So no JAX runs here.

At ``tiny_config(32)`` with drop-path 0.2, on one global batch of 12 rows
(6 clips x 2 streams, stream-major): every rank starts from other weights
than rank 0 and takes rank 0's through ``TrainState.broadcast``; each steps
on its rows (``row_shard``) through ``train_step``.  The mean of the ranks'
losses, every reduced gradient and every parameter after one SGD step equal
the one-process step's within 1e-5 * max(1, max|.|); the gradients are
averaged in one all-reduce (one dtype, one flat buffer), after the four
view-2 <- view-3 cross-view attentions gathered every rank's query windows
(their ratio-3 tiling reaches across clips); the drop-path keeps
each rank drew are its rows of the one-process keeps; and in one epoch of
``train_loop`` on the same rows from the same start (a train and a val
batch) only rank 0 writes ``ckpt_0.pt`` and ``metrics.jsonl``, whose first
line is the one-process loss.  Each spawn is joined
within 120 s and each process group waits at most 60 s in a collective, so
a hang fails the test.
"""

import dataclasses
import datetime
import json
import os

import numpy as np
import pytest
import torch

from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models import encoder
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.parallel import init_from_env, row_shard
from mumpy_tpu_torch.train import checkpoint as ckpt_lib
from mumpy_tpu_torch.train.optim import OptimConfig, Optimizer
from mumpy_tpu_torch.train.trainer import TrainLoopConfig, TrainState, train_loop, train_step
from mumpy_tpu_torch.utils.serving import set_kernel_path
from mumpy_tpu_torch.utils.weight_port import random_state_dict
from torch_cases import free_port, one_torch_thread, rank_env, spawn_ranks  # noqa: F401

CFG = dataclasses.replace(tiny_config(32), drop_path_rate=0.2)
ROWS, SEED = 12, 3
TOL = 1e-5


def global_batch():
    rng = np.random.default_rng(SEED)
    image = rng.standard_normal((ROWS, 3, 32, 32, 3), dtype=np.float32)
    mask = (rng.random((ROWS, 32 * 32)) < 0.3).astype(np.float32)
    return {"image": torch.from_numpy(image), "mask": torch.from_numpy(mask)}


def new_state(weight_seed, dist=None):
    model = Mumpy(CFG)
    model.load_state_dict(random_state_dict(model, weight_seed, fan_in=True))
    set_kernel_path(model, True)
    model.train()
    opt = Optimizer(model.named_parameters(), OptimConfig(), iter_max=100)
    return TrainState(model, opt) if dist is None else TrainState(model, opt, dist=dist)


def step_recording_keeps(state, batch):
    """One ``train_step``; returns (loss, keeps drawn, gradients, parameters)."""
    keeps, draw = [], encoder.drop_path_keep

    def recording(*args, **kwargs):
        keeps.append(draw(*args, **kwargs))
        return keeps[-1]

    encoder.drop_path_keep = recording  # every drop-path site is in encoder.py
    try:
        out = train_step(state, batch, torch.Generator().manual_seed(SEED))
    finally:
        encoder.drop_path_keep = draw
    named = dict(state.model.named_parameters())
    return (float(out["total"]), keeps, {n: p.grad.clone() for n, p in named.items()},
            {n: p.detach().clone() for n, p in named.items()})


def rank_main(rank, world, port, out_dir):
    """One gloo rank: other starting weights than rank 0's, then rank 0's by
    broadcast, one step on its rows, a checkpoint save; results to a file."""
    torch.set_num_threads(1)
    rank_env(rank, world, port)
    dist = init_from_env("cpu", timeout=datetime.timedelta(seconds=60))
    assert (dist.world, dist.rank, dist.grouped) == (world, rank, True)
    state = new_state(weight_seed=rank, dist=dist)
    state.broadcast()
    batch = global_batch()
    rows = row_shard(ROWS, world, rank)
    local = {k: v[rows.start:rows.stop] for k, v in batch.items()}
    calls = []
    reduce = torch.distributed.all_reduce
    torch.distributed.all_reduce = lambda t, *a, **kw: (calls.append(t.numel()),
                                                        reduce(t, *a, **kw))[1]
    try:
        loss, keeps, grads, params = step_recording_keeps(state, local)
    finally:
        torch.distributed.all_reduce = reduce
    torch.save({"loss": loss, "keeps": keeps, "grads": grads, "params": params,
                "all_reduce_sizes": calls}, os.path.join(out_dir, f"rank{rank}.pt"))
    # one epoch of the loop on this rank's rows from the same start: the same
    # step, its loss averaged over the ranks, its last epoch's checkpoint
    state = new_state(weight_seed=rank, dist=dist)
    state.broadcast()
    one = lambda: iter([{k: v.numpy() for k, v in local.items()}])  # noqa: E731
    train_loop(state, {"train": one, "val": one},
               TrainLoopConfig(model_name="ckpt", results_dir=out_dir, max_epoch=1,
                               print_every=1, seed=SEED))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def one_process():
    torch.set_num_threads(1)
    return step_recording_keeps(new_state(weight_seed=0), global_batch())


def close(got, want):
    scale = max(1.0, want.abs().max().item())
    return (got - want).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_take_the_one_process_step(one_process, world, tmp_path):
    loss1, keeps1, grads1, params1 = one_process
    spawn_ranks(rank_main, world, (world, free_port(), str(tmp_path)), timeout=120)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]
    assert abs(np.mean([r["loss"] for r in ranks]) - loss1) <= TOL * max(1.0, abs(loss1))
    n_grads = sum(g.numel() for g in grads1.values())
    for r, res in enumerate(ranks):
        # the gradients in one call on one flat f32 buffer, after the backward's
        # sums over the gathered query windows of the four ratio-3 CVAs
        sizes = res["all_reduce_sizes"]
        assert sizes[-1] == n_grads and n_grads not in sizes[:-1] and len(sizes) == 5, sizes
        bad = [n for n, g in grads1.items() if not close(res["grads"][n], g)]
        assert not bad, (r, bad[:5])
        bad = [n for n, p in params1.items() if not close(res["params"][n], p)]
        assert not bad, (r, bad[:5])
        assert len(res["keeps"]) == len(keeps1)
        for mine, whole in zip(res["keeps"], keeps1):
            n = mine.numel()
            assert whole.numel() == n * world
            assert torch.equal(mine, whole[r * n:(r + 1) * n])
    assert any((k == 0).any() for k in keeps1), "drop-path dropped nothing"
    # rank 0 alone wrote the loop's checkpoint and metrics: the global loss
    files = sorted(os.listdir(tmp_path / "ckpt"))
    board = [f for f in files if f.startswith("events.out.tfevents")]  # with tensorboardX
    assert len(board) <= 1
    assert [f for f in files if f not in board] == ["ckpt_0.pt", "meta_0.json", "metrics.jsonl"]
    saved = ckpt_lib.load_epoch(str(tmp_path / "ckpt"), 0)
    assert saved["step"] == 1
    with open(tmp_path / "ckpt" / "metrics.jsonl") as f:
        first = json.loads(f.readline())
    assert first["split"] == "train" and abs(first["total"] - loss1) <= TOL * max(1.0, loss1)


def test_rows_that_do_not_split_are_refused():
    assert row_shard(12, 4, 3) == range(9, 12)
    with pytest.raises(ValueError, match="12 rows does not split over 5 ranks"):
        row_shard(12, 5, 0)


def test_no_torchrun_is_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    dist = init_from_env("cpu")
    assert (dist.world, dist.rank, dist.grouped, dist.device) == (1, 0, False,
                                                                  torch.device("cpu"))
    assert not torch.distributed.is_initialized()
