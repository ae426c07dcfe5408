"""A copy of the benchmark with test-size configurations, mixes and cells
(files only, as a later change would add them), for the CPU tests."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def _plain(o):
    if isinstance(o, (list, tuple)):
        return [_plain(x) for x in o]
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    return o


def tiny_configs(drop_path=0.2):
    """{name: config file} of the flagship and the baseline at test size."""
    from mumpy_tpu_torch.configs import tiny_config
    from mumpy_tpu_torch.models.baseline import tiny_baseline_config

    flag = dataclasses.replace(tiny_config(32), drop_path_rate=drop_path)
    base = dataclasses.replace(tiny_baseline_config(64), drop_path_rate=drop_path)
    return {"tiny-flagship": {"model": "mumpy", **_plain(dataclasses.asdict(flag))},
            "tiny-baseline": {"model": "swin_baseline", **_plain(dataclasses.asdict(base))}}


# limits at test size, between the sound run's and the fp8 control's readings
# at the tests' seed on the CPU (sound / control: serve 0.0029 / 0.043 and
# 0.021 / 0.28; train predictions 0.005 / 0.038 and 0.050 / 0.29, changes
# 0.35 / 0.81 and 0.17 / 1.90, whole-model change differences 0.091 / 0.229
# and 0.187 / 0.595; the loss over half the batch 0.52 and 0.62; a state
# left unchanged reads 1)
LIMITS = {"tiny-flagship-serve": {"prob_gap": 0.02},
          "tiny-baseline-serve": {"prob_gap": 0.1},
          "tiny-flagship-train": {"pred_gap": 0.015, "change_gap": 0.6, "change_diff": 0.2},
          "tiny-baseline-train": {"pred_gap": 0.12, "change_gap": 0.6, "change_diff": 0.4}}


def make_root(tmp: Path) -> Path:
    """A checkout-like folder: BENCHMARK.json and ``benchmark/`` copied, plus
    the tiny configurations, mixes and four tiny cells."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in tiny_configs().items():
        (tmp / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test", "file":
                                f"benchmark/configs/{name}.json", "reduced": [], "why": "test"})
    mixes = {"tiny-serve": {"kind": "serve", "batch": 2, "pool": 2, "frames": 3},
             "tiny-train": {"kind": "train", "batch": 2, "pool": 4, "frames": 3,
                            "mask": {"rectangles": 1, "side_min": 0.1, "side_max": 0.34,
                                     "corner_max": 0.66}}}
    for name, mix in mixes.items():
        (tmp / "benchmark" / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    recipe = json.loads((BENCH / "workloads" / "flagship-train-b192.json").read_text())["recipe"]
    cells = {"tiny-flagship-serve": ("tiny-flagship", "tiny-serve"),
             "tiny-flagship-train": ("tiny-flagship", "tiny-train"),
             "tiny-baseline-serve": ("tiny-baseline", "tiny-serve"),
             "tiny-baseline-train": ("tiny-baseline", "tiny-train")}
    for name, (cfg, mix) in cells.items():
        spec["workloads"].append({"name": name, "config": cfg, "traffic": mix, "chips": 1,
                                  "why": "test"})
        cell = {"dtype": "bfloat16", "kernel_set": "blocks", "trace_calls": 2,
                "recipe": recipe, "limits": LIMITS[name]}
        (tmp / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        for m in spec["end_to_end"] + spec["per_layer"]:
            kind = "serve" if "serve" in name else "train"
            if "workloads" in m and any(kind in w for w in m["workloads"]):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp
