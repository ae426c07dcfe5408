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
the plain block run on unshifted rows as they are.  Ten launches of
``csrc/gemm.cu`` and ``csrc/window_attention.cu``; like ``swin_block`` the
GEMMs are bound by their tile loads in bf16 (tensor cores), and the
activations between launches round-trip device memory.

The roll is taken on the temporally folded ``(T*H, W)`` grid, as the JAX
package's ``ops/window.py:img_to_window_perm`` takes it: for a view with three
time slices it wraps from one slice into the next.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .attn_ln import attention_launches
from .swin_block import launch_swin_block, swin_block_plain
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
    swin_pair.launches += 1
    return launch_swin_pair(x, ops)


def launch_swin_pair(x, ops):
    """The kernel's launches: the shifted block with its rows gathered by the
    qkv GEMM and scattered back by the projection GEMM, then the plain block."""
    r, n, c = x.shape
    gh, gw, _, _ = ops["grid"]
    row_map = ops["map"]
    if row_map.numel() != gh * gw or (r * n) % (gh * gw):
        raise ValueError(f"swin_pair: {r} windows of {n} tokens are not whole "
                         f"{gh}x{gw} images")
    a, m = ops["a"]["attn"], ops["a"]["mlp"]
    x2 = x.reshape(r * n, c)
    o = attention_launches(x2, a, r, n, a_map=row_map)
    _, x2 = cuda_lib.gemm(o, a["w_proj"], a["b_proj"], res=x2, want_y=False,
                          want_out=True, c_map=row_map)
    h, _ = cuda_lib.gemm(x2, m["w1"], m["b1"], ln=(m["ln_g"], m["ln_b"]), gelu=True)
    _, x2 = cuda_lib.gemm(h, m["w2"], m["b2"], res=x2, want_y=False, want_out=True)
    return launch_swin_block(x2.reshape(r, n, c), ops["b"])


swin_pair.launches = 0
