"""The tiny model's kernel path against its plain path on the card, and the
bf16 kernels of the first slice as ``chip_smoke.py`` holds them.

Marked ``cuda``; skips where ``torch.cuda`` has no device.  Imports no JAX.
"""

import numpy as np
import pytest
import torch

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops, drop_mask_bias
from mumpy_tpu_torch.configs import tiny_config
from mumpy_tpu_torch.models.mumpy import Mumpy
from mumpy_tpu_torch.ops import attn_ln, cva, ln_mlp, swin_block, swin_pair, vit3
from mumpy_tpu_torch.utils.serving import make_serving_forward
from mumpy_tpu_torch.utils.weight_port import random_state_dict
from torch_cases import (C, GRID, HEADS, WIN, Draw, attn_operands, attn_weights,  # noqa: F401
                         cuda, cva_case, mask_bias, mlp_operands, mlp_weights, t, to_dev,
                         windows)


@pytest.mark.cuda
def test_tiny_kernel_path_matches_plain_path_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    kernels = (swin_block.swin_block, swin_pair.swin_pair, attn_ln.attn_ln, ln_mlp.ln_mlp,
               cva.cva, vit3.vit3)
    model = Mumpy(tiny_config(128))
    model.load_state_dict(random_state_dict(model, seed=3, std=0.2))
    clip = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 3, 128, 128, 3)).astype(np.float32))
    out = {}
    for use_kernels in (True, False):
        for k in kernels:
            k.launches = 0
        fwd = make_serving_forward(model, cuda, torch.float32, use_kernels=use_kernels)
        out[use_kernels] = fwd(clip).cpu()
        # tiny_config(128): per view one stage-2 pair and a lone last block,
        # 12 cross blocks with their MLP tails, 8 CVAs, 2 ViT layers
        want = [3, 3, 12, 12, 8, 2] if use_kernels else [0] * 6
        assert [k.launches for k in kernels] == want
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(), atol=1e-4)


GEOMETRIES = {"hd8": dict(c=C, heads=HEADS, win=WIN, grid=GRID),
              "hd32": dict(c=96, heads=3, win=7, grid=14)}  # the flagship head and window


@pytest.mark.cuda
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_bf16_kernels_on_card(cuda, geo):
    """bf16 kernels (the tensor-core GEMM; at hd 32 the tensor-core attention
    core as well) as chip_smoke.py holds them: within 2e-2 * max(1, max|ref|)
    of the f32 plain version, the branch within BF16_BRANCH_TOL RMS of the f32
    plain version on the same bf16 inputs, and a zeroed mask+bias caught."""
    g = GEOMETRIES[geo]
    c, heads, win, grid = g["c"], g["heads"], g["win"], g["grid"]
    d = Draw(8)
    a, m = attn_weights(d, c), mlp_weights(d, c, 4 * c)
    mb, x = mask_bias(d, True, heads, win, grid), windows(d, c, win, grid)
    ops = {"attn": attn_operands(a, mb, heads), "mlp": mlp_operands(m)}
    _, (x1, x2, gy, gx), cops = cva_case(3, seed=9, c=c, heads=heads, win=win, grid=grid)
    cases = [("swin_block", (t(x),), (), ops), ("attn_ln", (t(x),), (), ops["attn"]),
             ("ln_mlp", (t(x),), (), ops["mlp"]), ("cva", (t(x1), t(x2)), (t(gy), t(gx)), cops)]
    for name, acts, coords, kops in cases:
        mod = {"swin_block": swin_block, "attn_ln": attn_ln, "ln_mlp": ln_mlp, "cva": cva}[name]
        kernel, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
        acts, coords, kops = to_dev(acts, cuda), to_dev(coords, cuda), to_dev(kops, cuda)
        acts16, kops16 = [a_.bfloat16() for a_ in acts], cast_ops(kops, torch.bfloat16)
        ref = plain(*acts, *coords, kops)
        ref16 = plain(*(a_.float() for a_ in acts16), *coords, cast_ops(kops16, torch.float32))
        got = kernel(*acts16, *coords, kops16)
        torch.cuda.synchronize()
        for g_, r_ in zip(got if isinstance(got, tuple) else (got,),
                          ref if isinstance(ref, tuple) else (ref,)):
            scale = max(1.0, r_.abs().max().item())
            assert (g_.float() - r_).abs().max().item() <= 2e-2 * scale, name
        x16 = acts16[0].float()
        assert branch_error(name, x16, got, ref16) <= BF16_BRANCH_TOL, name
        if "mb" in kops16.get("attn", kops16):
            bad = kernel(*acts16, *coords, drop_mask_bias(kops16))
            assert branch_error(name, x16, bad, ref16) > BF16_BRANCH_TOL, name
