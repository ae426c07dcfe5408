"""The persistent warp-specialised wgmma GEMM (``csrc/gemm_sm90.cu``:
``mumpy_gemm_rows``) and the one-call sequences built on it
(``csrc/swin_pair.cu``, ``csrc/swin_block_train.cu``'s ``ln_mlp_train``
entries) on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  The GEMM is held against an f32 torch product
of the same bf16 inputs (TF32 off) after the contract's rounding of LN(x) to
bf16, within the bf16 bound of the port's checks, 2e-2 * max(1, max|ref|),
at the products of #2 (``swin_pair``) and #10 (``ln_mlp_train``): the
shifted block's qkv (LayerNorm, rows gathered through the shift's map) and
projection (residual read and rows stored through the map), fc1 (LayerNorm,
GELU) and fc2 (residual), on 6,272 rows at C = 384 and 18,816 at C = 512,
and a ragged row count.
"""

import pytest
import torch
import torch.nn.functional as F

from torch_cases import cuda  # noqa: F401

# (rows, C, heads): view 1/2's 14x14 grid at batch 32, view 3's 42x14, and a
# ragged count of rows (no map)
SHAPES = ((32 * 196, 384, 12), (32 * 588, 512, 16), (4711, 384, 12))


def _close(got, ref, what):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (what, err)


def _bf16(g, *shape, scale=1.0, mean=0.0):
    return (mean + torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


def _ln_ref(x, g, b):
    """The contract's A: LN(x) in f32, rounded to bf16."""
    return F.layer_norm(x.float(), (x.shape[-1],), g.float(), b.float(), 1e-5).bfloat16().float()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_gemm_rows_on_pair_products(cuda, shape):
    """qkv through the shift's map with the LayerNorm, the projection with
    its residual through the map, fc1 with the LayerNorm and GELU, fc2 with
    its residual; weights (in, out) as the serving operands store them."""
    from mumpy_tpu_torch.ops import cuda_lib
    from mumpy_tpu_torch.ops.swin_pair import shift_row_map

    rows, c, _ = SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(91 + shape)
    x = _bf16(g, rows, c, mean=0.5)
    lg, lb = _bf16(g, c, scale=0.2, mean=1.0), _bf16(g, c, scale=0.2)
    if rows % 196 == 0:
        gh = 14 if c == 384 else 42
        row_map = shift_row_map(gh, 14, 7, 3).to(cuda)
        src = (torch.arange(rows, device=cuda) // row_map.numel() * row_map.numel()
               + row_map.long().repeat(rows // row_map.numel()))
    else:
        row_map, src = None, torch.arange(rows, device=cuda)
    wq, bq = _bf16(g, c, 3 * c, scale=c**-0.5), _bf16(g, 3 * c)
    qkv, _ = cuda_lib.gemm(x, wq, bq, ln=(lg, lb), a_map=row_map)
    _close(qkv, _ln_ref(x[src], lg, lb) @ wq.float() + bq.float(), (rows, c, "qkv"))
    o = _bf16(g, rows, c)
    wp, bp = _bf16(g, c, c, scale=c**-0.5), _bf16(g, c)
    _, x2 = cuda_lib.gemm(o, wp, bp, res=x, want_y=False, want_out=True, c_map=row_map)
    ref = torch.empty(rows, c, device=cuda)
    ref[src] = x[src].float() + (o.float() @ wp.float() + bp.float()).bfloat16().float()
    _close(x2, ref, (rows, c, "proj"))
    w1, b1 = _bf16(g, c, 4 * c, scale=c**-0.5), _bf16(g, 4 * c)
    h, _ = cuda_lib.gemm(x2, w1, b1, ln=(lg, lb), gelu=True)
    _close(h, F.gelu(_ln_ref(x2, lg, lb) @ w1.float() + b1.float()), (rows, c, "fc1"))
    w2, b2 = _bf16(g, 4 * c, c, scale=(4 * c)**-0.5), _bf16(g, c)
    _, y = cuda_lib.gemm(h, w2, b2, res=x2, want_y=False, want_out=True)
    _close(y, x2.float() + (h.float() @ w2.float() + b2.float()).bfloat16().float(),
           (rows, c, "fc2"))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_gemm_rows_ln_stats_fault(cuda):
    """The planted fault (the LayerNorm with mean 0 and rstd 1) moves the
    product far off; the GEMM without it stays within the bound."""
    from mumpy_tpu_torch.ops import cuda_lib

    g = torch.Generator(device="cuda").manual_seed(95)
    x = _bf16(g, 6272, 384, mean=0.5, scale=0.3)
    lg, lb, w = _bf16(g, 384, mean=1.0), _bf16(g, 384), _bf16(g, 384, 1152, scale=384**-0.5)
    ref = _ln_ref(x, lg, lb) @ w.float()
    _close(cuda_lib.gemm(x, w, ln=(lg, lb))[0], ref, "ln")
    bad = cuda_lib.gemm(x, w, ln=(lg, lb), ln_stats_on=False)[0]
    assert (bad.float() - ref).abs().max().item() > 0.5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows, c, div", [(12 * 49 * 3, 768, 1), (12 * 784, 384, 49)])
def test_ln_mlp_train_one_call(cuda, rows, c, div):
    """#10's forward and backward, one call each, against autograd of its
    plain version in f32 on the same bf16 inputs, with keep factors 0, 1.25
    and 1 per ``div`` rows: out, dx and the six gradients; gelu' = 1 caught."""
    from mumpy_tpu_torch.ops import cuda_lib
    from mumpy_tpu_torch.ops.ln_mlp_train import ln_mlp_train_plain

    g = torch.Generator(device="cuda").manual_seed(96)
    x, dy = _bf16(g, rows, c), _bf16(g, rows, c)
    names = ("ln_g", "ln_b", "w1", "b1", "w2", "b2")
    ws = [_bf16(g, c, mean=1.0, scale=0.1), _bf16(g, c, scale=0.1),
          _bf16(g, 4 * c, c, scale=c**-0.5), _bf16(g, 4 * c, scale=0.1),
          _bf16(g, c, 4 * c, scale=(4 * c)**-0.5), _bf16(g, c, scale=0.1)]
    keep = torch.tensor([0.0, 1.25, 1.0], device=cuda).repeat(-(-rows // div) // 3 + 1)
    keep = keep[:-(-rows // div)].contiguous()
    out = cuda_lib.ln_mlp_train_fwd(x, keep, ws, div=div)
    dx, *grads = cuda_lib.ln_mlp_train_bwd(x, dy, keep, ws[:5] + [None], div=div)
    leaves = [t.float().requires_grad_() for t in [x] + ws]
    ref = ln_mlp_train_plain(leaves[0], dict(zip(names, leaves[1:])),
                             keep.repeat_interleave(div)[:rows])
    ref.backward(dy.float())
    torch.cuda.synchronize()
    _close(out, ref.detach(), "out")
    for name, got, leaf in zip(("x",) + names, [dx] + grads, leaves):
        _close(got, leaf.grad, name)
    bad = cuda_lib.ln_mlp_train_bwd(x, dy, keep, ws[:5] + [None], div=div, gelu_grad=False)[0]
    assert (bad.float() - dx.float()).norm() > 0.05 * (dx.float() - dy.float()).norm()
