"""The baseline ablation model's kernel instances on the card: every
distinct Swin-B block of ``BaselineConfig()`` at 224^2 (C 128 / 256 / 512 /
1024, window 7, head width 32, unshifted and shifted) through ``swin_block``
(#1) and ``swin_block_train`` (#8, forward and backward), each against its
plain PyTorch version on the block's own operands, at batch 2.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  f32 (TF32 off) within 1e-4 * max(1, max|ref|);
bf16 against the f32 plain version on the same bf16-valued inputs within
2e-2 * max(1, max|ref|), outputs and every gradient.
"""

import pytest
import torch

from mumpy_tpu_torch.models.baseline import BaselineConfig, BaselineModel
from mumpy_tpu_torch.ops import swin_block, swin_block_train
from mumpy_tpu_torch.ops.window import partition_tokens
from mumpy_tpu_torch.utils.serving import prepare_for_inference
from mumpy_tpu_torch.utils.weight_port import random_state_dict
from torch_cases import cuda, keep_vector, rounded, run_with_grads  # noqa: F401

DTYPES = (torch.float32, torch.bfloat16)


def _close(got, ref, dtype, what):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), (what, dtype, err)


def _cast(ops, dtype):
    """Kernel operands in ``dtype``; the f32 mask+bias stays f32."""
    if isinstance(ops, dict):
        return {k: v if k == "mb" else _cast(v, dtype) for k, v in ops.items()}
    return ops.to(dtype) if torch.is_tensor(ops) and ops.is_floating_point() else ops


def _blocks(dev):
    """(block, its windows of a seeded batch-2 input) of each distinct
    baseline block: the first two of every stage (unshifted, shifted; at
    7 x 7 the window covers the grid and never shifts)."""
    model = BaselineModel(BaselineConfig())
    model.load_state_dict(random_state_dict(model, 0, fan_in=True))
    prepare_for_inference(model.to(dev))
    g = torch.Generator(device=dev).manual_seed(5)
    for stage in model.encoder.layers:
        for blk in stage.blocks[:2]:
            (gh, gw), c = blk.grid(), blk.norm1.weight.shape[0]
            x = torch.randn(2, gh * gw, c, generator=g, device=dev)
            yield blk, partition_tokens(x, gh, gw, blk.window, blk.shift).contiguous()


@pytest.mark.cuda
def test_baseline_swin_block_on_card(cuda):
    for blk, wins in _blocks(cuda):
        ops = blk.kernel_ops()
        for dtype in DTYPES:
            x, ops_d = wins.to(dtype), _cast(ops, dtype)
            before = swin_block.swin_block.launches
            got = swin_block.swin_block(x, ops_d)
            torch.cuda.synchronize()
            assert swin_block.swin_block.launches == before + 1
            ref = swin_block.swin_block_plain(x.float(), _cast(ops_d, torch.float32))
            _close(got, ref, dtype, (tuple(wins.shape), blk.shift))


@pytest.mark.cuda
def test_baseline_swin_block_train_on_card(cuda):
    for blk, wins in _blocks(cuda):
        *weights, table = blk.train_params()
        params = swin_block_train.swin_block_weights(weights, blk.attn.num_heads)
        params = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in params.items()}
        r = wins.shape[0]
        args = (wins, blk.mask_bias(table).detach(), params, keep_vector(r).to(cuda),
                keep_vector(r + 1)[1:].to(cuda))
        cots = (torch.randn(wins.shape, generator=torch.Generator(device=cuda).manual_seed(6),
                            device=cuda),)
        kernel = swin_block_train.swin_block_train
        for dtype in DTYPES:
            before = (kernel.launches, kernel.backward_launches)
            outs, grads = run_with_grads(kernel, args, cots, dtype)
            torch.cuda.synchronize()
            assert (kernel.launches, kernel.backward_launches) == (before[0] + 1, before[1] + 1)
            routs, rgrads = run_with_grads(swin_block_train.swin_block_train_plain,
                                           [rounded(a, dtype) for a in args], cots)
            assert set(grads) == set(rgrads)
            _close(outs[0], routs[0], dtype, "out")
            for k in rgrads:
                _close(grads[k], rgrads[k], dtype, k)
