"""Everything of a cell found by name, and a run's result line.

``BENCHMARK.json`` (at the checkout's root) names the cells, configurations
and metrics.  For a cell ``<c>`` of configuration ``<cfg>`` and traffic
``<t>`` the harness reads ``benchmark/workloads/<c>.json`` (how the program
runs it and the limits of its comparison), the configuration's ``file``,
and ``benchmark/mixes/<t>.json`` (the traffic, ``traffic.py``).  A per-layer
metric ``<m>`` is read by ``benchmark/metrics/<m>.py``, whose ``read(run)``
returns a number, or None where the run has nothing for it to read (the
metric is then left out of the line).  A later change adds a cell, a
configuration, a mix or a metric by adding files and entries.

A cell's file: ``dtype`` and ``kernel_set`` (how the program runs it),
``limits`` (of the numbers ``compare.py`` computes), ``trace_calls`` (calls
traced by ``--trace 1``); training ``recipe`` (the optimizer's settings).
"""

from __future__ import annotations

import importlib.util
import json
import statistics
from pathlib import Path
from typing import Callable, Dict, Optional

import compare
import loops
import work
from peaks import H100

HERE = Path(__file__).resolve().parent
KINDS = {"serve": loops.serve, "train": loops.train}


class Bench:
    """The benchmark whose ``BENCHMARK.json`` lies in ``root``."""

    def __init__(self, root: Path = HERE.parent):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def cell(self, name: str) -> dict:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return {**cells[name], **self._json("workloads", name)}

    def config(self, name: str) -> dict:
        cfgs = {c["name"]: c for c in self.spec["configs"]}
        return json.loads((self.root / cfgs[name]["file"]).read_text())

    def mix(self, name: str) -> dict:
        return self._json("mixes", name)

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.dir / folder / f"{name}.json").read_text())

    def end_to_end(self, cell: str):
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str):
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def end_to_end_values(run: loops.Run) -> Dict[str, float]:
    """Every end-to-end quantity the run measured, by metric name."""
    out = {"setup_s": run.setup_s, "peak_mem_gib": run.peak_bytes / 2**30}
    if run.kind == "serve":
        out["serve_fps"] = run.calls * run.batch / run.window_s
        lat = sorted(run.latencies_ms)
        out["serve_p95_ms"] = statistics.quantiles(lat, n=20, method="inclusive")[18]
    else:
        out["train_clips_per_s"] = run.calls * run.batch / run.window_s
    return out


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device,
             setup_clock: Callable[[], float], device_info: Optional[dict] = None) -> dict:
    """One run of cell ``name``: the contract's result object."""
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    run = KINDS[mix["kind"]](cell, cfg, mix, seed, seconds, trace, device, setup_clock)
    if trace:
        run.flops_per_call = loops.count_flops(cfg, mix["batch"], mix["kind"] == "train")
        if mix["kind"] == "serve":
            run.bound_s_per_call = sum(work.site_bound_s(f, b) for _, f, b in
                                       work.sites(cfg["model"], cfg, mix["batch"]))
        run.peaks = H100
    values = end_to_end_values(run)
    metrics = {}
    if trace:
        for m in bench.per_layer(name):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checks = compare.judge(run.numbers, cell["limits"])
    device = dict(device_info or {})
    device["memory_peak_bytes"] = run.peak_bytes
    result = {"correct": compare.is_correct(checks) and run.failed == 0,
              "attempted": run.calls, "failed": run.failed, "metrics": metrics,
              "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_gaps(10)}
    result["compared"] = checks
    return result
