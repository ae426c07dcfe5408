"""Kernel ``swin_pair``: a shifted Swin block, then a plain one, on unshifted
window-major tokens.

    xs = partition(roll(img(x), -shift))     shifted window layout
    xs = swin_block(xs, a)                    mask + bias of period nW
    x  = partition(roll(img(xs), +shift))     back to the unshifted layout
    x  = swin_block(x, b)                     bias only

Replaces ``mumpy_tpu/ops/pallas/swin_pair.py:fused_pair_prepared`` (Pallas
``_pair_kernel``), which runs both blocks of a stage-2 pair in one launch and
rebuilds the cyclic shift in VMEM with static region copies.  On Hopper the
shift moves no bytes of its own: everything in a Swin block except the
attention is row-local, so the shifted block's LN + qkv GEMM reads its rows
through a row map (unshifted -> shifted), the attention core runs on the
shifted windows, and the projection GEMM reads its residual and stores its
output through the same map, back in the unshifted layout.  The MLP half and
the plain block run on unshifted rows as they are.  In bf16 the pair is one
call of ``csrc/swin_pair.cu``: fourteen launches, the row statistics before
each LayerNorm, the products on the persistent wgmma GEMM of
``csrc/gemm_sm90.cu`` (the LayerNorm applied to its landed A tiles, the maps
in its A loads and its epilogue's residual loads and stores) and the attention
core of ``csrc/window_attention.cu``; f32 composes the same sequence here
(``swin_block.block_sequence``, also the CPU model of the bf16 call) on
``csrc/gemm.cu``.  The activations between launches round-trip device memory.

The roll is taken on the temporally folded ``(T*H, W)`` grid, as the JAX
package's ``ops/window.py:img_to_window_perm`` takes it: for a view with three
time slices it wraps from one slice into the next.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .counts import count_launch
from .swin_block import block_sequence, swin_block_plain
from .window import partition_tokens, unpartition_tokens

__all__ = ["swin_pair", "swin_pair_plain", "swin_pair_operands", "shift_row_map"]


def shift_row_map(gh: int, gw: int, window: int, shift: int) -> torch.Tensor:
    """(gh*gw,) int32: for each row of one image's shifted window-major layout
    (``partition_tokens(..., shift)``), the row of the unshifted layout
    (``partition_tokens(..., 0)``) that holds the same token."""
    pos = torch.arange(gh * gw).reshape(1, gh * gw, 1)
    pos_unshifted = partition_tokens(pos, gh, gw, window, 0).reshape(-1)
    pos_shifted = partition_tokens(pos, gh, gw, window, shift).reshape(-1)
    row_of = torch.empty_like(pos_unshifted)
    row_of[pos_unshifted] = torch.arange(gh * gw)
    return row_of[pos_shifted].to(torch.int32)


def swin_pair_operands(ops_a, ops_b, row_map, grid):
    """Operands of a pair: the shifted block's and the plain block's
    ``swin_block`` operands (``ops_a`` with its mask + bias of period nW),
    the shift's row map (:func:`shift_row_map`, on the device) and the grid
    ``(gh, gw, window, shift)``."""
    return {"a": ops_a, "b": ops_b, "map": row_map, "grid": tuple(grid)}


def swin_pair_plain(x, ops):
    """Plain PyTorch version of the same function: two ``swin_block_plain``
    calls around the rolled window permutation."""
    gh, gw, w, s = ops["grid"]
    xs = partition_tokens(unpartition_tokens(x, gh, gw, w, 0), gh, gw, w, s)
    xs = swin_block_plain(xs, ops["a"])
    x = partition_tokens(unpartition_tokens(xs, gh, gw, w, s), gh, gw, w, 0)
    return swin_block_plain(x, ops["b"])


def swin_pair(x, ops):
    """``x`` (B*nW, N, C) unshifted windows -> the pair's output, same layout.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return swin_pair_plain(x, ops)
    count_launch(swin_pair)
    return launch_swin_pair(x, ops)


def launch_swin_pair(x, ops):
    """The kernel's launches: the shifted block with its rows gathered by the
    qkv GEMM and scattered back by the projection GEMM, then the plain block;
    one call in bf16.  ``ops["ln_stats_on"] = False`` (bf16) plants the
    LayerNorm-statistics fault of the checks."""
    r, n, c = x.shape
    gh, gw, _, _ = ops["grid"]
    row_map = ops["map"]
    if row_map.numel() != gh * gw or (r * n) % (gh * gw):
        raise ValueError(f"swin_pair: {r} windows of {n} tokens are not whole "
                         f"{gh}x{gw} images")
    if x.dtype == torch.bfloat16:
        return cuda_lib.swin_blocks_fwd(x, [ops["a"], ops["b"]], row_map=row_map,
                                        ln_stats_on=ops.get("ln_stats_on", True))
    x2 = block_sequence(x.reshape(r * n, c), ops["a"], r, n, row_map=row_map)
    return block_sequence(x2, ops["b"], r, n).reshape(r, n, c)


swin_pair.launches = 0
