"""The port's profiling and mask IO utilities on the CPU.

* ``utils/profiling.py``: ``cost_analysis`` of a matmul counts exactly
  2*M*N*K flops; ``model_flops`` counts a model on its plain path and leaves
  its kernel path as it was; ``StepTimer`` drops its warm-up steps;
  ``trace`` writes a Chrome trace.
* ``utils/io.py`` (the port's copy of ``mumpy_tpu/utils/io.py``, which loads
  no JAX): an indexed PNG round trip keeps labels and palette, and
  ``default_palette`` equals the JAX package's.
"""

import json

import numpy as np
import torch

from mumpy_tpu.utils import io as jax_io
from mumpy_tpu_torch.models.baseline import BaselineModel, tiny_baseline_config
from mumpy_tpu_torch.models.swin import KernelSite
from mumpy_tpu_torch.utils import io, profiling
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


def test_cost_analysis_counts_matmul_flops():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    assert profiling.cost_analysis(lambda x, y: x @ y, a, b) == {"flops": 2.0 * 64 * 128 * 32}
    model = BaselineModel(tiny_baseline_config())
    flops = profiling.model_flops(model, torch.zeros(2, 3, 32, 32, 3))
    assert flops > 0
    assert all(m.use_kernels for m in model.modules() if isinstance(m, KernelSite))


def test_step_timer_drops_warmup():
    t = profiling.StepTimer(warmup=1)
    for _ in range(3):
        t.start()
        t.stop(torch.ones(8, 8) * 2)
    assert len(t.times) == 2 and np.isfinite(t.mean)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_indexed_png_round_trip(tmp_path):
    labels = np.random.default_rng(0).integers(0, 5, (17, 23)).astype(np.uint8)
    io.imwrite_indexed(str(tmp_path / "m.png"), labels)
    got, palette = io.imread_indexed(str(tmp_path / "m.png"))
    assert np.array_equal(got, labels)
    assert np.array_equal(palette[:256], io.default_palette())


def test_default_palette_equals_jax_package():
    assert np.array_equal(io.default_palette(), jax_io.default_palette())
