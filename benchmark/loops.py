"""The two kinds of run: serving and training.

Each builds the program's model from the configuration with the benchmark's
seeded weights, makes the mix's pool of batches, warms up every shape the
window will use, measures for ``seconds``, optionally traces a few more
calls under ``torch.profiler``, frees the program's state, and then runs the
reference on what the window produced.  What it measured goes into a
:class:`Run`, which the metric readers of ``metrics/`` read.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import List, Optional

import torch

import compare
import devtrace
import program
import traffic
from reference import train as ref_train
from reference import weights as ref_weights
from reference.context import Ctx, f32_only

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KEEP_VISITS = 2  # serving: each pooled batch's output is kept at a seeded visit below this
FIRST_STEPS = 3  # training: the steps before the window that the reference follows


@dataclasses.dataclass
class Run:
    kind: str  # "serve" or "train"
    batch: int  # clips a call
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    issue_s: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    trace: Optional[devtrace.Trace] = None
    flops_per_call: Optional[float] = None  # of the reference, counted on the meta device
    bound_s_per_call: Optional[float] = None  # the kernel sites' roofline bound
    numbers: dict = dataclasses.field(default_factory=dict)  # compared with the reference
    peaks: Optional[dict] = None  # the card's published peaks (peaks.py)
    detail: Optional[dict] = None  # training: both sides' readings, leaf by leaf
    failed: int = 0

    @property
    def calls_per_s(self) -> float:
        """Calls a second of the untraced window."""
        return self.calls / self.window_s


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _traced(fn, calls: int, device):
    """``calls`` calls of ``fn(j)`` under the profiler, each in a ``call`` range."""
    with devtrace.profile() as prof:
        t0 = time.perf_counter()
        for j in range(calls):
            with devtrace.call_range():
                fn(j)
        _sync(device)
        window = time.perf_counter() - t0
    return devtrace.read(prof, window, calls)


def serve(cell, cfg, mix, seed, seconds, trace, device, setup_clock) -> Run:
    dtype = DTYPES[cell["dtype"]]
    run = Run("serve", mix["batch"])
    wseed = traffic.sub_seed(seed, traffic.WEIGHTS)
    model = program.build_model(cfg, ref_weights.draw(cfg, wseed, device, dtype), device)
    fwd = program.serving_forward(model, device, dtype, cell["kernel_set"])
    pool = traffic.serve_pool(mix, cfg["image_size"], seed, device, dtype)
    n = len(pool)
    # which visit of each pooled batch is kept for the comparison
    pick = torch.Generator().manual_seed(traffic.sub_seed(seed, traffic.SAMPLE))
    visit = torch.randint(0, KEEP_VISITS, (n,), generator=pick).tolist()
    _reset_peak(device)
    for clip in pool + pool[:1]:  # every shape of this traffic, and once more
        fwd(clip)
    _sync(device)
    run.setup_s = setup_clock()
    kept = [None] * n
    t0 = time.perf_counter()
    while True:
        k = run.calls % n
        ta = time.perf_counter()
        p = fwd(pool[k])
        tb = time.perf_counter()
        _sync(device)  # the client waits for its batch's probabilities
        run.latencies_ms.append((time.perf_counter() - ta) * 1e3)
        run.issue_s.append(tb - ta)
        if run.calls // n <= visit[k]:
            kept[k] = p
        run.calls += 1
        if time.perf_counter() - t0 >= seconds and run.calls >= KEEP_VISITS * n:
            break
    run.window_s = time.perf_counter() - t0
    run.peak_bytes = _peak(device)
    if trace:
        ranges = devtrace.Ranges(model)
        try:
            run.trace = _traced(lambda j: fwd(pool[j % n]), cell["trace_calls"], device)
        finally:
            ranges.remove()
    del fwd, model
    _free(device)
    with f32_only(), torch.no_grad():
        P = {k: v.float() for k, v in ref_weights.draw(cfg, wseed, device, dtype).items()}
        pairs = [(kept[k], torch.sigmoid(ref_train.forward(Ctx(), P, cfg, pool[k].float())))
                 for k in range(n)]
    limit = cell["limits"]["prob_gap"]
    run.failed = sum(not (compare.prob_gap([pr]) <= limit) for pr in pairs)
    run.numbers = {"prob_gap": compare.prob_gap(pairs)}
    return run


def train(cell, cfg, mix, seed, seconds, trace, device, setup_clock) -> Run:
    dtype = DTYPES[cell["dtype"]]
    run = Run("train", mix["batch"])
    wseed = traffic.sub_seed(seed, traffic.WEIGHTS)
    kseed = traffic.sub_seed(seed, traffic.KEEPS)
    model = program.build_model(cfg, ref_weights.draw(cfg, wseed, device, torch.float32), device)
    state = program.train_state(model, cell["recipe"], cell["kernel_set"])
    gen = torch.Generator(device=device).manual_seed(kseed)
    pool = traffic.train_pool(mix, cfg["image_size"], seed, device)
    n = len(pool)
    params = program.parameters(state)
    p0 = {k: p.detach().to("cpu", copy=True) for k, p in params.items()}
    _reset_peak(device)
    # the first steps: through the window's own call and feed, on distinct batches
    got = {"loss": []}
    for i in range(FIRST_STEPS):
        out = program.train_step(state, pool[i], gen, dtype)
        got["loss"].append(float(out["total"]))
        if i == 0:
            got["preds"] = out["preds"].float()
            got["grad"] = compare.leaf_norms(program.optimizer_gradients(state))
    got["delta"] = {k: params[k].detach().cpu() - p0[k] for k in params}
    got["change"] = compare.leaf_norms(got["delta"])
    del p0, out
    _sync(device)
    run.setup_s = setup_clock()
    losses = []
    t0 = time.perf_counter()
    while True:
        ta = time.perf_counter()
        losses.append(program.train_step(state, pool[(FIRST_STEPS + run.calls) % n], gen,
                                         dtype)["total"])
        run.issue_s.append(time.perf_counter() - ta)
        run.calls += 1
        if time.perf_counter() - t0 >= seconds and run.calls >= 2:
            break
    _sync(device)
    run.window_s = time.perf_counter() - t0
    run.peak_bytes = _peak(device)
    run.failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    if trace:
        run.trace = _traced(lambda j: program.train_step(state, pool[j % n], gen, dtype),
                            cell["trace_calls"], device)
    del state, model, params, pool, losses, gen
    _free(device)
    with f32_only():
        P = {k: v.detach() for k, v in
             ref_weights.draw(cfg, wseed, device, torch.float32).items()}
        batches = traffic.train_pool(mix, cfg["image_size"], seed, device, count=FIRST_STEPS)
        ref = ref_train.first_steps(cfg, P, batches, cell["recipe"],
                                    torch.Generator(device=device).manual_seed(kseed))
    run.numbers = compare.train_numbers(got, ref)
    run.detail = {"got": got, "ref": ref}
    return run


def count_flops(cfg, batch: int, train: bool) -> float:
    """Operations of one reference forward (and, ``train``, its backward
    without recomputation) at ``batch`` clips, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    P = {name: torch.empty(shape, device="meta", requires_grad=train)
         for name, shape, _ in ref_weights.spec(cfg)}
    size = cfg["image_size"]
    clip = torch.empty(batch, 3, size, size, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        logits = ref_train.forward(Ctx(train=train), P, cfg, clip)
        if train:
            mask = torch.empty(batch, size * size, device="meta")
            ref_train.total_loss(mask, logits.float().reshape(batch, -1)).backward()
    return float(counter.get_total_flops())
