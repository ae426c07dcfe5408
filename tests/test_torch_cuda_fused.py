"""#9 (``attn_ln_train``) as one C call each way (``csrc/swin_block_train.cu``,
its backward's o from the attention backward's core) and #1's fused MLP half
(``csrc/mlp_sm90.cu``), on the card.

Every test here is marked ``cuda`` and skips where ``torch.cuda`` has no
device; the file imports no JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py``).  bf16 against the f32 plain version on the same
bf16-valued inputs (TF32 off), within the port's bf16 bound 2e-2 * max(1,
max|ref|): #9 at two of its flagship shapes (stage 0 of view 3 and stage 3
of view 3, 49 tokens, hd 32) with keep factors 0, 1.25 and 1, y, out and
every gradient; the fused MLP at #1's stage-0/1 shapes and a ragged row count
with a hidden width of 5.5 chunks, against the two-product route it replaces
and an f32 torch product, with its two planted faults on the ragged case.
"""

import pytest
import torch
import torch.nn.functional as F

from torch_cases import cuda, rounded, run_with_grads  # noqa: F401

# #9: (windows, tokens, C, heads) of the 12-clip step's stage 0 and stage 3 at view 3
ATTN_SHAPES = ((2304, 49, 128, 4), (36, 49, 1024, 32))
# #1's MLP halves at batch 32, stages 0-1 (rows, C, hidden), and a ragged case
MLP_SHAPES = ((100352, 96, 384), (301056, 128, 512), (25088, 192, 768), (75264, 256, 1024),
              (4711, 96, 352))


def _bf16(g, *shape, scale=1.0, mean=0.0):
    return (mean + torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)


def _close(got, ref, what):
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * max(1.0, ref.abs().max().item()), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(ATTN_SHAPES)))
def test_attn_ln_train_one_call_flagship(cuda, shape):
    """#9's ``Function`` in bf16 (one C call each way) against autograd of
    ``attn_ln_train_plain``: y, out, dx, d(mask+bias) and the six weights'
    gradients."""
    from mumpy_tpu_torch.ops import attn_ln_train

    r, n, c, heads = ATTN_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(101 + shape)
    p = {"ln_g": _bf16(g, c, mean=1.0, scale=0.1), "ln_b": _bf16(g, c, scale=0.1),
         "w_qkv": _bf16(g, 3 * c, c, scale=c**-0.5), "b_qkv": _bf16(g, 3 * c, scale=0.1),
         "w_proj": _bf16(g, c, c, scale=c**-0.5), "b_proj": _bf16(g, c, scale=0.1),
         "heads": heads}
    x, mb = _bf16(g, r, n, c), _bf16(g, 1, heads, n, n)
    keep = torch.tensor([0.0, 1.25, 1.0], device=cuda).repeat(r // 3 + 1)[:r].contiguous()
    cots = (_bf16(g, r, n, c).float(), _bf16(g, r, n, c).float())
    args = (x, mb, p, keep)
    before = attn_ln_train.attn_ln_train.backward_launches
    outs, grads = run_with_grads(attn_ln_train.launch_attn_ln_train, args, cots, torch.bfloat16)
    torch.cuda.synchronize()
    assert attn_ln_train.attn_ln_train.backward_launches == before + 1
    routs, rgrads = run_with_grads(attn_ln_train.attn_ln_train_plain,
                                   [rounded(a, torch.bfloat16) for a in args], cots)
    assert set(grads) == set(rgrads)
    for name, got, ref in [("y", outs[0], routs[0]), ("out", outs[1], routs[1])] + [
            (k, grads[k], rgrads[k]) for k in rgrads]:
        _close(got, ref, (ATTN_SHAPES[shape], name))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(len(MLP_SHAPES)))
def test_fused_mlp(cuda, shape):
    """The fused MLP against the two-product route (``ln_rows``, fc1 with
    GELU, fc2 with the residual) and against an f32 torch product rounded
    where the contract rounds (LN(x), the hidden, the branch)."""
    from mumpy_tpu_torch.ops import cuda_lib

    rows, c, hidden = MLP_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(111 + shape)
    x = _bf16(g, rows, c, mean=0.5)
    m = {"ln_g": _bf16(g, c, mean=1.0, scale=0.1), "ln_b": _bf16(g, c, scale=0.1),
         "w1": _bf16(g, c, hidden, scale=c**-0.5), "b1": _bf16(g, hidden, scale=0.1),
         "w2": _bf16(g, hidden, c, scale=hidden**-0.5), "b2": _bf16(g, c, scale=0.1)}
    got = cuda_lib.mlp_rows(x, m)
    f, _ = cuda_lib.gemm(x, m["w1"], m["b1"], ln=(m["ln_g"], m["ln_b"]), gelu=True)
    _, two = cuda_lib.gemm(f, m["w2"], m["b2"], res=x, want_y=False, want_out=True)
    h = F.layer_norm(x.float(), (c,), m["ln_g"].float(), m["ln_b"].float(), 1e-5).bfloat16()
    f32 = F.gelu(h.float() @ m["w1"].float() + m["b1"].float()).bfloat16().float()
    branch = (f32 @ m["w2"].float() + m["b2"].float()).bfloat16().float()
    ref = x.float() + branch
    torch.cuda.synchronize()
    _close(got, ref, (rows, c, "f32 product"))
    _close(got, two.float(), (rows, c, "two products"))
    if rows % 128:  # the planted faults, each far off the branch
        scale = branch.abs().max().item()
        for fault in ("ln_stats_on", "gelu_on"):
            bad = cuda_lib.mlp_rows(x, m, **{fault: False})
            assert (bad.float() - ref).abs().max().item() > 0.1 * scale, fault
