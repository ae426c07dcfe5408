"""The split serving forward (``utils/serving.py:SplitForward``) on the CPU,
the analogue of ``tests/test_parallel_serving.py``: over ``[cpu] * 2`` and
``[cpu] * 4`` replicas, one host thread each, the probabilities equal the
one-device forward's within 1e-6.  The weights are drawn at 1/sqrt(fan-in),
so the cross-view attention's branch is of order one: were the replicas not
to hand each other their query windows (the view-2 <- view-3 attention's
ratio-3 tiling reaches across clips), the split would be ~0.1 off.  Also:
``serving_devices`` follows ``test.py:87``, and the kernels' launch counters
lose no count under many threads."""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.ops.counts import count_launch
from mumpy_tpu_torch.parallel import serving_devices
from mumpy_tpu_torch.utils.serving import make_serving_forward
from mumpy_tpu_torch.utils.weight_port import random_state_dict
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def case():
    model = Mumpy(tiny_config(32))
    model.load_state_dict(random_state_dict(model, 5, fan_in=True))
    clip = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 3, 32, 32, 3),
                                                                     dtype=np.float32))
    one = make_serving_forward(copy.deepcopy(model), "cpu")
    return model, clip, one(clip)


@pytest.mark.parametrize("n", [2, 4])
def test_split_forward_matches_one_device(case, n):
    model, clip, want = case
    forward = make_serving_forward(copy.deepcopy(model), [torch.device("cpu")] * n)
    try:
        got = forward(clip)
        threads = [t for t in threading.enumerate() if t.name.startswith("serve-")]
        assert len(threads) == n  # one persistent thread per replica
    finally:
        forward.close()
    assert got.shape == want.shape == (8, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    assert not [t for t in threading.enumerate() if t.name.startswith("serve-")]


def test_serving_devices_follow_test_py():
    assert serving_devices(32, list(range(8))) == list(range(8))
    assert serving_devices(6, list(range(4))) == [0, 1, 2]
    assert serving_devices(7, list(range(4))) == [0]
    assert serving_devices(4, ["cuda:0"]) == ["cuda:0"]


def test_launch_counts_are_exact_under_threads():
    def kernel():
        pass

    kernel.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=lambda: [count_launch(kernel) for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernel.launches == 16 * 5000
