"""Kernel ``window_attention``: multi-head attention over windows with a
periodic additive term, differentiable.

    o[w, i, h] = sum_j softmax_j(q[w, i, h] . k[w, j, h] * hd^-0.5 + mb[w % P, h, i, j]) v[w, j, h]

``qkv`` is (B*nW, N, 3C), packed as the qkv Linear writes it (q of head h at
columns h*hd, k at C + h*hd, v at 2C + h*hd); ``mb`` is (P, H, N, N), the
relative-position bias (P = 1) or the shift mask plus the bias (P = nW).
The output is (B*nW, N, C), head h at columns h*hd.

Replaces ``mumpy_tpu/ops/pallas/window_attention.py:fused_window_attention``
(Pallas ``_attn_kernel``) and its custom VJP ``window_attention_ad``.  The
Pallas function takes rows R = B*nW*H, heads fastest, with a bias of period
P*H along them; the port keeps the windows and heads of the packed qkv and
reads the bias of window w as ``mb[w % P]``, which is the same function.  As
there, the scores and the softmax are f32, keys past N are masked, P is
rounded to v's dtype before P.V, and both products accumulate in f32; the
backward recomputes the softmax from q, k and the bias, as ``_ad_bwd`` does,
and returns d(qkv) and d(mb) summed over the windows of each period, in
``mb``'s dtype.  The JAX package runs that backward in XLA; the port has a
hand-written core for exactly this function and runs it:

* forward, one launch of ``csrc/window_attention.cu`` on the packed rows and
  ``mb`` as it is (f32 or bf16, read through its strides; the core masks the
  keys it pads to 64);
* backward, one launch of ``csrc/window_attention_bwd.cu``: P recomputed in
  f32, dP = dO V^T, dS = P (dP - rowsum(P dP)), dQ, dK, dV into the packed
  d(qkv), and dS summed per (period slot, head) into an f32 d(mb), then cast
  to ``mb``'s dtype.  It rounds P to the input dtype before dV = P^T dO and
  dS * scale before dQ and dK, as the JAX package's training kernels do
  (``_ad_bwd`` keeps f32 until its cast).

At the flagship's N = 49 and hd = 32 both are bound by device-memory bytes,
not by operations: the forward does about 25 flops per byte it must move in
bf16, the backward about 28, against the H100's ~295 for its tensor cores.
In bf16 (every flagship head is hd = 32) both run on the tensor cores
(mma.sync) with the scores and probabilities in registers, never in device
memory; a block takes one head and the windows of one mask slot, so the
slot's mask+bias is read once per block.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .counts import count_launch

__all__ = ["window_attention", "window_attention_plain", "launch_window_attention",
           "launch_window_attention_bwd"]


def _check(qkv, mb, heads):
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"window attention takes packed qkv (B*nW, N, 3C) with C a multiple "
                         f"of {heads} heads, got {tuple(qkv.shape)}")
    r, n = qkv.shape[:2]
    if mb.dim() != 4 or tuple(mb.shape[1:]) != (heads, n, n):
        raise ValueError(f"mask+bias must be (P, {heads}, {n}, {n}), got {tuple(mb.shape)}")
    if r % mb.shape[0]:
        raise ValueError(f"{r} windows are not a multiple of the mask period {mb.shape[0]}")


def window_attention_plain(qkv, mb, heads, drop=None):
    """Plain PyTorch version of the same function, differentiated by
    autograd: both products in the input dtype, the scores and the softmax
    in f32, the probabilities cast to v's dtype before P.V.  ``drop``, when
    given, is applied to the (R, H, N, N) probabilities (attention dropout in
    training, ``models/dropout.py``; the kernel has none)."""
    r, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    q, k, v = qkv.reshape(r, n, 3, heads, hd).unbind(2)  # (R, N, H, hd)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k).float() * hd**-0.5
    per = mb.shape[0]
    s = (s.reshape(r // per, per, heads, n, n) + mb.float()).reshape(r, heads, n, n)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    if drop is not None:
        a = drop(a)
    return torch.einsum("rhqk,rkhd->rqhd", a, v).reshape(r, n, c)


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mb, heads):
        r, n, c3 = qkv.shape
        o = cuda_lib.packed_window_attention(qkv.reshape(r * n, c3), mb, r=r, n=n,
                                             heads=heads)
        ctx.save_for_backward(qkv, mb)
        ctx.heads = heads
        return o.reshape(r, n, c3 // 3)

    @staticmethod
    def backward(ctx, do):
        count_launch(window_attention, "backward_launches")
        qkv, mb = ctx.saved_tensors
        dqkv, dmb = launch_window_attention_bwd(qkv, mb, do, ctx.heads)
        return dqkv, dmb.to(mb.dtype), None


def launch_window_attention_bwd(qkv, mb, do, heads, rowsum=True):
    """The backward's launch on the forward's packed ``qkv`` (R, N, 3C), its
    (P, H, N, N) ``mb`` and the output gradient ``do`` (R, N, C).  Returns
    d(qkv) (R, N, 3C) and d(mb) (P, H, N, N) f32; ``rowsum=False`` is the
    planted fault of the checks (the softmax backward without its rowsum
    term)."""
    r, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    dqkv, dmb = cuda_lib.window_attention_bwd(
        qkv.reshape(r * n, c3), do.reshape(r * n, c).contiguous(), mb, r=r, n=n,
        heads=heads, hd=hd, scale=hd**-0.5, rowsum=rowsum)
    return dqkv.reshape(r, n, c3), dmb


def window_attention(qkv, mb, heads):
    """Packed ``qkv`` (B*nW, N, 3C) and ``mb`` (P, H, N, N) -> the heads'
    outputs (B*nW, N, C), differentiable in both.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel.
    ``window_attention.launches`` counts forward launches,
    ``window_attention.backward_launches`` the backward's."""
    _check(qkv, mb, heads)
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, mb, heads)
    count_launch(window_attention)
    return launch_window_attention(qkv, mb, heads)


def launch_window_attention(qkv, mb, heads):
    """The kernel's forward launch, differentiable through its backward's."""
    return _WindowAttention.apply(cuda_lib.aligned(qkv), mb, heads)


window_attention.launches = 0
window_attention.backward_launches = 0
