"""The persistent wgmma GEMM's C entry (``mumpy_gemm_rows``: the row maps and
the epilogues, after a LayerNorm row pass that writes the normalised rows
once, with its planted fault) and the
one-call sequences built on it (``mumpy_swin_blocks_fwd`` for #1 and #2,
``mumpy_ln_mlp_train_fwd`` / ``_bwd`` for #10), on the CPU against the model
of the C ABI (``torch_cases.ModelLib``): bf16-valued inputs, held to torch
within the chip's 2e-2 * max(1, max|ref|), with a ragged M, the shift's row
map and a keep divisor.  The card holds the kernels themselves
(``tests/test_torch_cuda_rowgemm.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import BF16_BRANCH_TOL, branch_error, cast_ops
from mumpy_tpu_torch.ops import cuda_lib, ln_mlp_train, swin_block, swin_pair
from torch_cases import (PAIR_GEOMETRIES, ModelLib, keep_vector, model_lib,  # noqa: F401
                         pair_case, t)
from torch_cases import one_torch_thread  # noqa: F401  (autouse)

M, K, N = 45, 24, 72  # a ragged M


def _close(got, ref):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), err


def _rnd(g, *shape, scale=1.0, mean=0.0):
    return (mean + torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)


def _recorded(monkeypatch):
    """The names of the C entry points the model runs, in order."""
    calls = []
    for name in ("mumpy_gemm_rows", "mumpy_gemm_sm90", "mumpy_gemm", "mumpy_ln_rows",
                 "mumpy_mlp_rows", "mumpy_swin_blocks_fwd", "mumpy_ln_mlp_train_fwd",
                 "mumpy_ln_mlp_train_bwd"):
        fn = getattr(ModelLib, name)
        monkeypatch.setattr(ModelLib, name,
                            lambda self, *a, fn=fn, name=name: calls.append(name) or fn(self, *a))
    return calls


@pytest.mark.parametrize("mapped", [False, True])
def test_gemm_rows_prologue_maps_epilogues(model_lib, monkeypatch, mapped):
    """bf16 ``cuda_lib.gemm`` runs the persistent GEMM: LN(x) rounded to bf16
    by one ``ln_rows`` pass, its rows gathered through a_map (a qkv product);
    the residual read and the rows stored through c_map (a projection); GELU;
    the row scale per divisor.  Ragged M without a map."""
    calls = _recorded(monkeypatch)
    g = torch.Generator().manual_seed(11)
    m = 48 if mapped else M
    x, o = _rnd(g, m, K, mean=0.5), _rnd(g, m, K)
    lg, lb = _rnd(g, K, scale=0.2, mean=1.0), _rnd(g, K, scale=0.2)
    w, b, res = _rnd(g, K, N, scale=K**-0.5), _rnd(g, N), _rnd(g, m, N)
    perm = torch.randperm(12, generator=g).to(torch.int32) if mapped else None
    src = (torch.arange(m) // 12 * 12 + perm.long().repeat(m // 12)) if mapped else \
        torch.arange(m)
    y, _ = cuda_lib.gemm(x, w, b, ln=(lg, lb), gelu=True, a_map=perm)
    h = F.layer_norm(x.float()[src], (K,), lg.float(), lb.float(), 1e-5).bfloat16().float()
    _close(y, F.gelu(h @ w.float() + b.float()))
    _, out = cuda_lib.gemm(o, w, b, res=res, want_y=False, want_out=True, c_map=perm)
    ref = torch.empty(m, N)
    ref[src] = res.float()[src] + (o.float() @ w.float() + b.float()).bfloat16().float()
    _close(out, ref)
    keep = torch.rand(-(-m // 7), generator=g)
    _, out = cuda_lib.gemm(o, w, b, res=res, want_y=False, want_out=True, row_scale=keep,
                           scale_div=7)
    _close(out, res.float() + keep.repeat_interleave(7)[:m, None] * (o.float() @ w.float()
                                                                     + b.float()))
    # a product with no map takes the training kernels' entry
    rows = "mumpy_gemm_rows" if mapped else "mumpy_gemm_sm90"
    assert calls == ["mumpy_ln_rows", rows, rows, "mumpy_gemm_sm90"]


def test_gemm_rows_ln_stats_fault(model_lib):
    """``ln_stats_on=False``, the planted fault: the LayerNorm with mean 0 and
    rstd 1, far from the product; f32 refuses it (the fault is bf16's)."""
    g = torch.Generator().manual_seed(12)
    x = _rnd(g, M, K, mean=0.5, scale=0.3)
    lg, lb, w = _rnd(g, K, mean=1.0), _rnd(g, K), _rnd(g, K, N, scale=K**-0.5)
    good, _ = cuda_lib.gemm(x, w, ln=(lg, lb))
    bad, _ = cuda_lib.gemm(x, w, ln=(lg, lb), ln_stats_on=False)
    _close(bad, (x.float() * lg.float() + lb.float()).bfloat16().float() @ w.float())
    assert (bad.float() - good.float()).abs().max() > 0.5 * good.float().abs().max()
    with pytest.raises(ValueError, match="bf16 GEMM only"):
        cuda_lib.gemm(x.float(), w.float(), ln=(lg.float(), lb.float()), ln_stats_on=False)


def test_swin_blocks_one_call(model_lib, monkeypatch):
    """#1 and #2 in bf16 launch one call each (``mumpy_swin_blocks_fwd``)
    within the branch bound of their f32 plain versions on the same bf16
    inputs, each block's MLP half at this C of 64 on the fused MLP; the
    LayerNorm-statistics fault lands far above it."""
    calls = _recorded(monkeypatch)
    _, x, ops = pair_case(PAIR_GEOMETRIES["w7s3"], seed=23)
    ops16, x16 = cast_ops(ops, torch.bfloat16), t(x).bfloat16()
    for name, kernel, plain, kops in (
            ("swin_pair", swin_pair.launch_swin_pair, swin_pair.swin_pair_plain, ops16),
            ("swin_block", swin_block.launch_swin_block, swin_block.swin_block_plain,
             ops16["b"])):
        calls.clear()
        ref = plain(x16.float(), cast_ops(kops, torch.float32))
        got = kernel(x16, kops)
        assert calls[0] == "mumpy_swin_blocks_fwd" and calls.count("mumpy_swin_blocks_fwd") == 1
        assert calls.count("mumpy_mlp_rows") == (2 if name == "swin_pair" else 1)
        assert calls.count("mumpy_ln_rows") == calls.count("mumpy_mlp_rows")  # LN1s only
        assert branch_error(name, x16.float(), got, ref) <= BF16_BRANCH_TOL / 2
        bad = kernel(x16, {**kops, "ln_stats_on": False})
        assert branch_error(name, x16.float(), bad, ref) >= 3 * BF16_BRANCH_TOL


@pytest.mark.parametrize("div", [1, 7])
def test_ln_mlp_train_one_call(model_lib, monkeypatch, div):
    """#10 in bf16: forward and backward one call each, out, dx and the six
    gradients against autograd of the plain version in f32 on the same bf16
    inputs, with keep factors 0, 1.25 and 1 per ``div`` rows over a ragged
    row count; gelu' = 1 is caught."""
    calls = _recorded(monkeypatch)
    g = torch.Generator().manual_seed(13 + div)
    rows, c, hid = 49, 16, 64
    x, dy = _rnd(g, rows, c), _rnd(g, rows, c)
    names = ("ln_g", "ln_b", "w1", "b1", "w2", "b2")
    p = dict(zip(names, (_rnd(g, c, mean=1.0, scale=0.1), _rnd(g, c, scale=0.1),
                         _rnd(g, hid, c, scale=c**-0.5), _rnd(g, hid, scale=0.1),
                         _rnd(g, c, hid, scale=hid**-0.5), _rnd(g, c, scale=0.1))))
    keep = keep_vector(-(-rows // div))
    if div == 1:  # the kernel's Function, as the model's sites call it
        out = ln_mlp_train.launch_ln_mlp_train(x, p, keep)
    else:  # the one call with a divisor, as swin_block_train's MLP half takes it
        out = cuda_lib.ln_mlp_train_fwd(x, keep, list(p.values()), div=div)
    dx, _, *grads = ln_mlp_train.launch_ln_mlp_train_bwd(
        x, keep, *(p[k] for k in names[:5]), None, dy, div=div)
    assert calls.count("mumpy_ln_mlp_train_fwd") == 1
    assert calls.count("mumpy_ln_mlp_train_bwd") == 1
    leaves = {k: v.float().requires_grad_() for k, v in [("x", x), *p.items()]}
    ref = ln_mlp_train.ln_mlp_train_plain(leaves["x"], leaves,
                                          keep.repeat_interleave(div)[:rows])
    ref.backward(dy.float())
    _close(out, ref.detach())
    for k, got in zip(("x",) + names, [dx] + grads):
        _close(got, leaves[k].grad)
    bad = ln_mlp_train.launch_ln_mlp_train_bwd(x, keep, *(p[k] for k in names[:5]), None, dy,
                                               div=div, gelu_grad=False)[0]
    assert (bad.float() - dx.float()).norm() > 0.05 * (dx.float() - dy.float()).norm()
