"""The harness on the CPU: cells found by name from files, the end-to-end
arithmetic, the result line, the refusals, the imports, and ``correct``
against the control and the planted faults at test size.  The test marked
``cuda`` runs a cell on a card and skips here."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import compare
import faults
import harness
import loops
import tiny

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 2**33 + 12345  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(harness.Bench(root), cell, seed, 0.2, trace, "cpu", lambda: 1.0,
                            {"platform": "cpu"})


def test_everything_of_a_cell_is_found_by_name_from_files(root):
    bench = harness.Bench(tiny.REPO)
    for w in bench.spec["workloads"]:
        cell = bench.cell(w["name"])
        assert bench.mix(cell["traffic"])["kind"] in harness.KINDS
        assert bench.config(cell["config"])["model"] in ("mumpy", "swin_baseline")
        assert "limits" in cell
        for m in bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))
    # a cell, configuration and mix added as files and entries, with no edit
    assert harness.Bench(root).cell("tiny-flagship-serve")["config"] == "tiny-flagship"


def test_every_metric_has_its_reader_and_every_cell_its_metrics():
    bench = harness.Bench(tiny.REPO)
    for m in bench.spec["per_layer"]:
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in bench.spec["workloads"]:
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2 and bench.per_layer(w["name"])


def test_rates_and_tails_come_from_every_request_of_the_window():
    run = loops.Run("serve", batch=32, window_s=2.0, calls=20, setup_s=3.0,
                    latencies_ms=[10.0] * 18 + [50.0, 90.0], peak_bytes=2**31)
    v = harness.end_to_end_values(run)
    assert v["serve_fps"] == 20 * 32 / 2.0
    assert v["serve_p95_ms"] == pytest.approx(52.0)  # the tail of all 20, interpolated
    assert v["peak_mem_gib"] == 2.0 and v["setup_s"] == 3.0
    run = loops.Run("train", batch=24, window_s=10.0, calls=31)
    assert harness.end_to_end_values(run)["train_clips_per_s"] == 31 * 24 / 10.0


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_has_the_contracts_keys_and_the_compared_numbers_last(root, trace):
    r = _run(root, "tiny-flagship-serve", trace)
    keys = list(r)
    assert CONTRACT <= set(keys) and keys[-1] == "compared"
    assert set(keys) - CONTRACT - {"compared"} <= ({"breakdown"} if trace else set())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 4
    names = {m["name"] for m in harness.Bench(root).end_to_end("tiny-flagship-serve")}
    if not trace:
        assert set(r["metrics"]) == names
    for c in r["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def _bare_run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "flagship-serve-b128", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _bare_run(tiny.REPO, env)
    assert out.returncode != 0 and "{" not in out.stdout


def test_a_checkout_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _bare_run(tmp_path, env)
    assert out.returncode != 0 and "{" not in out.stdout


def test_no_benchmark_module_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path[:0] = sys.argv[1:]\n"
            "import run, harness, loops, check, faults, compare, devtrace, work, traffic, "
            "program, peaks\n"
            "import mumpy_tpu_torch.utils.serving, mumpy_tpu_torch.train.trainer\n"
            "bad = run.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(tiny.BENCH), str(tiny.REPO)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    import mumpy_tpu_torch  # noqa: F401  the port's name begins with the JAX package's
    import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mumpy_tpu.models", types.ModuleType("mumpy_tpu.models"))
    assert run.forbidden_modules() == ["mumpy_tpu"]


@pytest.mark.parametrize("cell,fault", [("tiny-flagship-serve", "answer_altered"),
                                        ("tiny-baseline-serve", "answer_altered"),
                                        ("tiny-flagship-train", "half_batch"),
                                        ("tiny-flagship-train", "state_unchanged"),
                                        ("tiny-baseline-train", "half_batch"),
                                        ("tiny-baseline-train", "state_unchanged")])
def test_a_fault_under_the_timed_path_makes_correct_false(root, cell, fault):
    assert _run(root, cell)["correct"] is True
    with faults.FAULTS[fault]():
        assert _run(root, cell)["correct"] is False


def test_change_diff_sees_a_change_in_another_direction_that_norms_miss():
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0])}
    turned = {"a": torch.tensor([4.0, 3.0]), "b": torch.tensor([0.0, 1.0])}
    names = ["a", "b"]
    assert compare._leaf_gap(compare.leaf_norms(turned), compare.leaf_norms(ref), names) == 0
    assert compare.change_diff(turned, ref, names) == pytest.approx(2 ** 0.5 / 26 ** 0.5)
    assert compare.change_diff(ref, ref, names) == 0


@pytest.mark.parametrize("cell", ["tiny-flagship-serve", "tiny-flagship-train",
                                  "tiny-baseline-serve", "tiny-baseline-train"])
def test_the_fp8_control_fails_a_limit(root, cell):
    bench = harness.Bench(root)
    c = bench.cell(cell)
    cfg, mix = bench.config(c["config"]), bench.mix(c["traffic"])
    if mix["kind"] == "serve":
        numbers = faults.serve_control(c, cfg, mix, SEED, "cpu")
    else:
        numbers = compare.train_numbers(*faults.train_control(c, cfg, mix, SEED, "cpu"))
    assert not all(numbers[k] <= lim for k, lim in c["limits"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship-serve-b128"])
def test_a_cell_runs_on_the_card_and_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "2", "--trace", "1"], cwd=tiny.REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert torch.cuda.get_device_name(0) == result["device"]["kind"]
