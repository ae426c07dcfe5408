"""The ``swin_pair`` kernel's launch sequence on the CPU, against the model of
the C entry points (``torch_cases.ModelLib``): the qkv GEMM's row gather, the
projection GEMM's residual gather and output scatter, and the mask period of
the shifted windows, held against ``swin_pair_plain``, which rolls the image
instead.  f32 exact to 1e-5; bf16 to 2e-2 * max(1, max|ref|)."""

import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, identity_map
from mumpy_tpu_torch.ops import swin_pair
from mumpy_tpu_torch.ops.window import partition_tokens, unpartition_tokens
from torch_cases import (PAIR_GEOMETRIES, check_launches, model_lib,  # noqa: F401
                         pair_case, t)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geometry", list(PAIR_GEOMETRIES))
def test_swin_pair_launches(model_lib, dtype, geometry):
    _, x, ops = pair_case(PAIR_GEOMETRIES[geometry])
    got = swin_pair.launch_swin_pair(t(x).to(dtype), cast_ops(ops, dtype))
    check_launches(got, swin_pair.swin_pair_plain(t(x), ops), dtype)


@pytest.mark.parametrize("geometry", list(PAIR_GEOMETRIES))
def test_shift_row_map_is_the_rolled_partition(geometry):
    """Gathering unshifted windows through the map (periodic over images)
    gives partition(roll(image, -shift)); the map is a permutation."""
    win, shift, nwh, nww, c, _ = PAIR_GEOMETRIES[geometry]
    gh, gw = nwh * win, nww * win
    x = torch.randn(2 * nwh * nww, win * win, c)
    row_map = swin_pair.shift_row_map(gh, gw, win, shift).long()
    assert torch.equal(row_map.sort().values, torch.arange(gh * gw))
    rows = torch.arange(x.shape[0] * win * win)
    gathered = x.reshape(-1, c)[rows // (gh * gw) * (gh * gw) + row_map[rows % (gh * gw)]]
    rolled = partition_tokens(unpartition_tokens(x, gh, gw, win, 0), gh, gw, win, shift)
    assert torch.equal(gathered.reshape(rolled.shape), rolled)


def test_pair_without_shift_is_caught(model_lib):
    """chip_smoke.py's planted fault for the pair, on the bf16 launch model at
    the flagship's head width and view-3 grid (hd 32, 6x2 windows of 49): the
    launches stay within BF16_BRANCH_TOL of the f32 plain version on the same
    bf16 inputs, and the same launches with the identity map (no shift) land
    far above it."""
    _, x, ops = pair_case(PAIR_GEOMETRIES["w7s3"], seed=22)
    ops16, x16 = cast_ops(ops, torch.bfloat16), t(x).bfloat16()
    ref16 = swin_pair.swin_pair_plain(x16.float(), cast_ops(ops16, torch.float32))
    good = branch_error("swin_pair", x16.float(),
                        swin_pair.launch_swin_pair(x16, ops16), ref16)
    bad = branch_error("swin_pair", x16.float(),
                       swin_pair.launch_swin_pair(x16, identity_map(ops16)), ref16)
    assert good <= BF16_BRANCH_TOL / 2 and bad >= 3 * BF16_BRANCH_TOL, (good, bad)
