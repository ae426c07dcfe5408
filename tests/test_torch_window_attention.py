"""The port's window attention (#7) against the JAX package's, from the
golden file ``tests/golden/jax_window_attention.npz`` (written by
``tests/make_jax_window_attention_golden.py``: ``fused_window_attention`` in
Pallas interpret mode and ``jax.vjp(window_attention_ad)``), so that no JAX
is compiled here.

The JAX function takes rows R = windows * heads, heads fastest, and a bias of
period P rows; the port takes the packed per-window qkv (windows, N, 3C) and
a (P / heads, heads, N, N) mask+bias.  Each case is converted between the
two layouts, and ``window_attention_plain`` (the CPU path of the wrapper) and
its autograd gradients of qkv and of the mask+bias are held to the JAX
output and dq, dk, dv, dbias within 1e-5 * max(1, max|ref|), f32.  The
cases: bias only at N = 49 (P = heads), and shift mask + bias at N = 16 and
N = 9 (P = nW * heads); 49 and 9 are not multiples of 8.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mumpy_tpu_torch.ops import window_attention as wa
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = np.load(Path(__file__).resolve().parent / "golden" / "jax_window_attention.npz")
CASES = ("bias_n49", "mask_n16", "mask_n9")


def _packed(rows, heads):
    """JAX rows (windows * heads, N, D) -> the port's (windows, N, heads * D)."""
    r, n, d = rows.shape
    return torch.from_numpy(rows).reshape(r // heads, heads, n, d).transpose(1, 2).reshape(
        r // heads, n, heads * d)


def _rows(packed, heads):
    """The inverse of :func:`_packed`."""
    w, n, c = packed.shape
    return packed.reshape(w, n, heads, c // heads).transpose(1, 2).reshape(w * heads, n, -1)


def _close(got, ref):
    ref = torch.as_tensor(ref)
    err = (got.detach() - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("name", CASES)
def test_plain_and_gradients_match_jax(name):
    z = {k: GOLDEN[f"{name}/{k}"] for k in ("q", "k", "v", "bias", "g", "out", "dq", "dk",
                                             "dv", "dbias", "heads")}
    heads = int(z["heads"])
    n = z["q"].shape[1]
    qkv = torch.cat([_packed(z[k], heads) for k in "qkv"], dim=-1).requires_grad_()
    mb = torch.from_numpy(z["bias"]).reshape(-1, heads, n, n).requires_grad_()
    before = wa.window_attention.launches
    out = wa.window_attention(qkv, mb, heads)  # a CPU tensor: the plain version
    assert wa.window_attention.launches == before
    _close(_rows(out, heads), z["out"])
    out.backward(_packed(z["g"], heads))
    c = heads * z["q"].shape[2]
    for i, k in enumerate(("dq", "dk", "dv")):
        _close(_rows(qkv.grad[..., i * c:(i + 1) * c], heads), z[k])
    _close(mb.grad.reshape(-1, n, n), z["dbias"])

