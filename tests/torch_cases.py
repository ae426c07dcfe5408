"""Seeded inputs and weights shared by the kernel tests (numpy draws, JAX
layout (in, out)), their conversion to the port's kernel operands, the card
tests' fixture and checks, and a model of the kernels' C entry points for the
CPU launch tests.  Imports no JAX, so the card-only tests can use it where
JAX is absent."""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mumpy_tpu_torch.ops import attn_ln, cuda_lib, cva, ln_mlp, swin_block, swin_pair, vit3
from mumpy_tpu_torch.ops.window import shifted_window_mask

C, HEADS, MLP, WIN, GRID, BATCH = 24, 3, 96, 4, 8, 2  # hd 8, 4 windows per image


class Draw:
    """Weights in the JAX layout (in, out) from one seeded generator."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, *shape, mean=0.0, std=0.3):
        return (mean + std * self.rng.standard_normal(shape)).astype(np.float32)


def t(a, transpose=False):
    """numpy (in, out) -> torch, optionally as a torch Linear (out, in)."""
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def mask_bias(d, shifted, heads=HEADS, win=WIN, grid=GRID):
    n = win * win
    bias = d(1, heads, n, n)
    if not shifted:
        return bias
    mask = shifted_window_mask(grid, grid, win, win // 2).numpy()
    return mask[:, None] + bias  # (nW, H, n, n)


def wstd(fan_in, default=C):
    """Matrix std: 0.3 at the default fan-in, scaled by 1/sqrt(fan-in) so that
    scores and branches keep their size at other widths."""
    return 0.3 * (default / fan_in) ** 0.5


def attn_weights(d, c=C):
    return {"ln_scale": d(c, mean=1.0, std=0.1), "ln_bias": d(c, std=0.1),
            "qkv_kernel": d(c, 3 * c, std=wstd(c)), "qkv_bias": d(3 * c),
            "proj_kernel": d(c, c, std=wstd(c)), "proj_bias": d(c)}


def mlp_weights(d, c=C, m=MLP):
    return {"ln_scale": d(c, mean=1.0, std=0.1), "ln_bias": d(c, std=0.1),
            "w1": d(c, m, std=wstd(c)), "b1": d(m), "w2": d(m, c, std=wstd(m, MLP)),
            "b2": d(c)}


def attn_operands(w, mb, heads=HEADS):
    return attn_ln.attn_ln_operands(
        t(w["ln_scale"]), t(w["ln_bias"]), t(w["qkv_kernel"], True), t(w["qkv_bias"]),
        t(w["proj_kernel"], True), t(w["proj_bias"]), torch.from_numpy(mb), heads)


def mlp_operands(w):
    return ln_mlp.ln_mlp_operands(t(w["ln_scale"]), t(w["ln_bias"]), t(w["w1"], True),
                                  t(w["b1"]), t(w["w2"], True), t(w["b2"]))


def windows(d, c=C, win=WIN, grid=GRID):
    nw = (grid // win) ** 2
    return d(BATCH * nw, win * win, c, std=1.0)


def cva_case(ratio, seed=4, groups=3, c=C, heads=HEADS, win=WIN, grid=GRID):
    d = Draw(seed)
    n = win * win
    b1 = BATCH * (grid // win) ** 2
    w = {f"proj_{k}_kernel": d(c, c, std=wstd(c)) for k in ("q", "k", "v", "out")}
    w.update({f"proj_{k}_bias": d(c) for k in ("q", "k", "v", "out")})
    x1, x2 = d(b1, n, c, std=1.0), d(ratio * b1, n, c, std=1.0)
    # absolute pixel coordinates, some outside the window (zero padding)
    gy, gx = (d(groups, b1, n, mean=(win - 1) / 2, std=(win - 1) / 2) for _ in range(2))
    ops = cva.cva_operands(
        *(t(w[f"proj_{k}_{p}"], p == "kernel") for k in ("q", "k", "v")
          for p in ("kernel", "bias")), t(w["proj_out_kernel"], True), heads, groups, win)
    return w, (x1, x2, gy, gx), ops


# ---- swin_pair and vit3 cases (shared with chip_smoke.py's flagship shapes) ----

# (window, shift, nwh, nww, c, heads): tests/test_pair_fusion.py's first and
# fourth cases, the second at the flagship's stage-2 window and view-3 grid
PAIR_GEOMETRIES = {"w4s2": (4, 2, 2, 2, 48, 3), "w7s3": (7, 3, 6, 2, 64, 2)}
# the flagship's stage-2 pairs: views 1 and 2 (14x14 grid), view 3 (42x14)
FLAGSHIP_PAIRS = {"c384": (7, 3, 2, 2, 384, 12), "c512": (7, 3, 6, 2, 512, 16)}
VIT3_R, VIT3_C, VIT3_HEADS = 20, 48, 4
FLAGSHIP_VIT3 = (768, 12, 3072)  # C, heads, MLP width


def block_weights(d, c, m):
    """One Swin block's weights as the JAX package's Pallas kernels take them."""
    a, w = attn_weights(d, c), mlp_weights(d, c, m)
    return {"ln1_scale": a["ln_scale"], "ln1_bias": a["ln_bias"],
            "qkv_kernel": a["qkv_kernel"], "qkv_bias": a["qkv_bias"],
            "proj_kernel": a["proj_kernel"], "proj_bias": a["proj_bias"],
            "ln2_scale": w["ln_scale"], "ln2_bias": w["ln_bias"], "fc1_kernel": w["w1"],
            "fc1_bias": w["b1"], "fc2_kernel": w["w2"], "fc2_bias": w["b2"]}


def block_operands(w, mb, heads):
    return swin_block.swin_block_operands(
        t(w["ln1_scale"]), t(w["ln1_bias"]), t(w["qkv_kernel"], True), t(w["qkv_bias"]),
        t(w["proj_kernel"], True), t(w["proj_bias"]), t(w["ln2_scale"]),
        t(w["ln2_bias"]), t(w["fc1_kernel"], True), t(w["fc1_bias"]),
        t(w["fc2_kernel"], True), t(w["fc2_bias"]), torch.from_numpy(mb), heads)


def pair_case(geometry, seed=21, batch=BATCH):
    """A (shifted, plain) pair: JAX-layout weights of both blocks, the shifted
    block's mask + bias (nW, H, n, n), the plain block's bias (1, H, n, n),
    unshifted windows x (batch*nW, n, c), and the port's pair operands."""
    win, shift, nwh, nww, c, heads = geometry
    gh, gw, n = nwh * win, nww * win, win * win
    d = Draw(seed)
    wa, wb = block_weights(d, c, 4 * c), block_weights(d, c, 4 * c)
    mask = shifted_window_mask(gh, gw, win, shift).numpy()
    mb_s = mask[:, None] + d(1, heads, n, n, std=1.0)
    bias_p = d(1, heads, n, n, std=1.0)
    x = d(batch * nwh * nww, n, c, std=1.0)
    ops = swin_pair.swin_pair_operands(
        block_operands(wa, mb_s, heads), block_operands(wb, bias_p, heads),
        swin_pair.shift_row_map(gh, gw, win, shift), (gh, gw, win, shift))
    return (wa, wb, mb_s, bias_p), x, ops


def vit3_weights(d, c=VIT3_C, m=4 * VIT3_C):
    return block_weights(d, c, m)


def vit3_ops(w, heads):
    return vit3.vit3_operands(
        t(w["ln1_scale"]), t(w["ln1_bias"]), t(w["qkv_kernel"], True), t(w["qkv_bias"]),
        t(w["proj_kernel"], True), t(w["proj_bias"]), t(w["ln2_scale"]),
        t(w["ln2_bias"]), t(w["fc1_kernel"], True), t(w["fc1_bias"]),
        t(w["fc2_kernel"], True), t(w["fc2_bias"]), heads)


def vit3_case(seed=31, r=VIT3_R, c=VIT3_C, heads=VIT3_HEADS, m=None):
    """Time-major tokens x (3, r, c), JAX-layout weights and the port's operands."""
    d = Draw(seed)
    w = vit3_weights(d, c, m or 4 * c)
    return w, d(3, r, c, std=1.0), vit3_ops(w, heads)


# ---- training-kernel cases (attn_ln_train, ln_mlp_train) ----

DROP = 0.2  # a drop-path rate: keep factors are 0 or 1 / (1 - DROP)


def keep_vector(n, drop=DROP):
    """(n,) f32 keep factors cycling through 0, 1 / (1 - drop) and 1, so that
    every kind of row occurs (drop-path off, on and dropped)."""
    return torch.tensor([0.0, 1.0 / (1.0 - drop), 1.0] * (n // 3 + 1))[:n]


def attn_train_weights(w, heads=HEADS):
    """torch-layout live parameters of ``attn_ln_train`` from JAX-layout weights."""
    return {"ln_g": t(w["ln_scale"]), "ln_b": t(w["ln_bias"]),
            "w_qkv": t(w["qkv_kernel"], True), "b_qkv": t(w["qkv_bias"]),
            "w_proj": t(w["proj_kernel"], True), "b_proj": t(w["proj_bias"]), "heads": heads}


def mlp_train_weights(w):
    """torch-layout live parameters of ``ln_mlp_train`` from JAX-layout weights."""
    return {"ln_g": t(w["ln_scale"]), "ln_b": t(w["ln_bias"]), "w1": t(w["w1"], True),
            "b1": t(w["b1"]), "w2": t(w["w2"], True), "b2": t(w["b2"])}


def attn_train_case(seed, shifted, c=C, heads=HEADS, win=WIN, grid=GRID):
    """(x, mb, params, keep, (dy, dout)) for ``attn_ln_train``: seeded
    windows, a mask+bias of period 1 or nW, keep factors per window and the
    two cotangents."""
    d = Draw(seed)
    w, mb, x = attn_weights(d, c), mask_bias(d, shifted, heads, win, grid), windows(d, c, win, grid)
    cots = (t(d(*x.shape, std=1.0)), t(d(*x.shape, std=1.0)))
    return t(x), torch.from_numpy(mb), attn_train_weights(w, heads), keep_vector(x.shape[0]), cots


def mlp_train_case(seed, rows, c=C, m=MLP):
    """(x, params, keep, (dy,)) for ``ln_mlp_train`` on ``rows`` rows."""
    d = Draw(seed)
    w = mlp_weights(d, c, m)
    return (t(d(rows, c, std=1.0)), mlp_train_weights(w), keep_vector(rows),
            (t(d(rows, c, std=1.0)),))


def block_train_weights(w, heads=HEADS):
    """torch-layout live parameters of ``swin_block_train`` from JAX-layout
    attention and MLP weights."""
    a, m = attn_train_weights(w["attn"], heads), mlp_train_weights(w["mlp"])
    return {"ln1_g": a["ln_g"], "ln1_b": a["ln_b"], "w_qkv": a["w_qkv"], "b_qkv": a["b_qkv"],
            "w_proj": a["w_proj"], "b_proj": a["b_proj"], "ln2_g": m["ln_g"],
            "ln2_b": m["ln_b"], "w1": m["w1"], "b1": m["b1"], "w2": m["w2"], "b2": m["b2"],
            "heads": heads}


def block_train_case(seed, shifted, c=C, heads=HEADS, win=WIN, grid=GRID, m=None):
    """(x, mb, params, keep1, keep2, (dy,)) for ``swin_block_train``: seeded
    windows, a mask+bias of period 1 or nW, two different cycles of keep
    factors per window and the cotangent."""
    d = Draw(seed)
    w = {"attn": attn_weights(d, c), "mlp": mlp_weights(d, c, m or 4 * c)}
    mb, x = mask_bias(d, shifted, heads, win, grid), windows(d, c, win, grid)
    r = x.shape[0]
    return (t(x), torch.from_numpy(mb), block_train_weights(w, heads), keep_vector(r),
            keep_vector(r + 1)[1:], (t(d(*x.shape, std=1.0)),))


def rounded(obj, dtype):
    """Floating-point tensors (in dicts too) rounded to ``dtype`` and back to
    f32: the inputs of the f32 plain version a low-precision kernel is held
    against."""
    if isinstance(obj, dict):
        return {k: rounded(v, dtype) for k, v in obj.items()}
    if torch.is_tensor(obj) and obj.is_floating_point():
        return obj.to(dtype).float()
    return obj


def run_with_grads(fn, args, cots, dtype=torch.float32):
    """Call ``fn(*args)`` on copies of its floating-point tensors cast to
    ``dtype`` (those in a params dict included; keep factors stay f32), back-
    propagate ``cots`` and return (outputs, {name: gradient}) in f32."""
    leaves = {}

    def prep(obj, name):
        if isinstance(obj, dict):
            return {k: prep(v, f"{name}.{k}" if name else k) for k, v in obj.items()}
        if torch.is_tensor(obj) and obj.is_floating_point() and name != "keep":
            leaf = obj.detach().to(dtype).requires_grad_()
            leaves[name] = leaf
            return leaf
        return obj

    names = {3: ("x", "", "keep"), 4: ("x", "mb", "", "keep"),
             5: ("x", "mb", "", "keep", "keep")}[len(args)]
    inputs = [prep(a, n) for a, n in zip(args, names)]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [c.to(dtype) for c in cots])
    return ([o.detach().float() for o in outs],
            {k: v.grad.float() for k, v in leaves.items()})


# ---- fixtures ----

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each port test on one torch intra-op thread, then restore.  The
    tier-1 run puts six test workers on the machine's cores; torch's thread
    pool in one of them would compete with the JAX tests' own threads (the
    port's tests are tiny, so one thread costs them little)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the card tests' fixture and check ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def to_dev(obj, dev):
    if isinstance(obj, dict):
        return {k: to_dev(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(to_dev(v, dev) for v in obj)
    return obj.to(dev) if torch.is_tensor(obj) else obj


def assert_kernel_matches_plain(kernel, plain, args, dev):
    """f32 on the card: the kernel within 1e-4 * max(1, max|ref|) of its plain
    version (same order of magnitude as a reordered f32 sum over C <= 96)."""
    args = to_dev(args, dev)
    before = kernel.launches
    got, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        scale = max(1.0, r.abs().max().item())
        assert (g - r).abs().max().item() <= 1e-4 * scale


# ---- a model of the C entry points, for the launch tests on the CPU ----

DTYPES = {0: torch.float32, 1: torch.bfloat16}


def _view(p, n, dtype):
    """The n elements at a ctypes pointer, as a writable tensor."""
    size = n * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * size).from_address(p.value), dtype=dtype)


class ModelLib:
    """What csrc/gemm.cu, window_attention.cu, window_attention_bwd.cu,
    train_rows.cu, wgrad.cu, cva_sample.cu and vit3_attention.cu compute, on
    the raw buffers the wrappers pass."""

    def mumpy_gemm(self, x, w, bias, g, b, res, a_map, c_map, y, out, row_scale, aux,
                   aux_out, M, N, K, a_sum, a_seg, act, map_len, scale_div, dtype, stream):
        dt = DTYPES[dtype]
        rows = torch.arange(M)

        def mapped(mp):  # row m -> (m // L) * L + map[m % L]
            if mp is None:
                return rows
            perm = _view(mp, map_len, torch.int32).long()
            return rows // map_len * map_len + perm[rows % map_len]

        X = _view(x, M * a_sum * K, dt).reshape(M * a_sum, K).float()
        if a_sum > 1:
            base = (rows // a_seg) * a_sum * a_seg + rows % a_seg
            A = sum(X[base + t * a_seg] for t in range(a_sum))
        else:
            A = X[mapped(a_map)]
            if g is not None:
                A = F.layer_norm(A, (K,), _view(g, K, dt).float(), _view(b, K, dt).float(),
                                 1e-5).to(dt).float()
        v = A @ _view(w, K * N, dt).float().reshape(K, N)
        if bias is not None:
            v = v + _view(bias, N, dt).float()
        c_rows = mapped(c_map)
        if act == 1:
            v = F.gelu(v)
        elif act == 2:  # the GELU backward: times gelu'(aux)
            f1 = _view(aux, M * N, dt).reshape(M, N)[c_rows].float()
            v = v * (0.5 * (1 + torch.erf(f1 * 0.5**0.5))
                     + f1 * torch.exp(-0.5 * f1 * f1) * (2 * torch.pi) ** -0.5)
            if aux_out is not None:
                _view(aux_out, M * N, dt).reshape(M, N)[c_rows] = F.gelu(f1).to(dt)
        yv = v.to(dt)
        if y is not None:
            _view(y, M * N, dt).reshape(M, N)[c_rows] = yv
        if out is not None:
            resid = _view(res, M * N, dt).reshape(M, N)[c_rows].float()
            if row_scale is None:
                o = resid + yv.float()
            else:  # res + s * v, rounded once
                s = _view(row_scale, -(-M // scale_div), torch.float32)
                o = resid + s[rows // scale_div, None] * v
            _view(out, M * N, dt).reshape(M, N)[c_rows] = o.to(dt)
        return 0

    @staticmethod
    def _splits(rows, per, ws, parts, outs, dt):
        """Row splits of ``per`` rows: each split's f32 partials (``parts``
        of a row slice, concatenated) to its slice of the workspace, or with
        no workspace (one split) rounded into ``outs``."""
        n = -(-rows // per)
        chunks = [torch.cat([t.reshape(-1) for t in parts(slice(s * per, (s + 1) * per))])
                  for s in range(n)]
        if ws is not None:
            _view(ws, n * chunks[0].numel(), torch.float32).copy_(torch.cat(chunks))
            return 0
        assert n == 1, "one split writes T directly"
        at = 0
        for p, size in outs:
            _view(p, size, dt).copy_(chunks[0][at:at + size].to(dt))
            at += size
        return 0

    def mumpy_gemm_tn(self, a, b, ws, dw, db, M, O, I, rows_per_split, dtype, stream):
        dt = DTYPES[dtype]
        A = _view(a, M * O, dt).reshape(M, O).float()
        B = _view(b, M * I, dt).reshape(M, I).float()

        def parts(rows):
            return [A[rows].t() @ B[rows], A[rows].sum(0)]

        return self._splits(M, rows_per_split, ws, parts, [(dw, O * I), (db, O)], dt)

    def mumpy_col_sums(self, dh, x, mu, rstd, ws, dg, db, rows, C, rows_per_split, dtype,
                       stream):
        dt = DTYPES[dtype]
        D = _view(dh, rows * C, dt).reshape(rows, C).float()
        X = _view(x, rows * C, dt).reshape(rows, C).float()
        m, rs = (_view(t, rows, torch.float32)[:, None] for t in (mu, rstd))

        def parts(r):
            return [(D[r] * (X[r] - m[r]) * rs[r]).sum(0), D[r].sum(0)]

        return self._splits(rows, rows_per_split, ws, parts, [(dg, C), (db, C)], dt)

    def mumpy_reduce_splits(self, ws, splits, len1, out1, len2, out2, dtype, stream):
        dt = DTYPES[dtype]
        total = _view(ws, splits * (len1 + len2), torch.float32).reshape(splits, -1).sum(0)
        _view(out1, len1, dt).copy_(total[:len1].to(dt))
        _view(out2, len2, dt).copy_(total[len1:].to(dt))
        return 0

    def mumpy_window_attention_bwd(self, qkv, do, mb, dqkv, dmb, R, N, H, hd, P, chunks,
                                   scale, rowsum, dtype, stream):
        dt = DTYPES[dtype]
        c = H * hd
        q, k, v = _view(qkv, R * N * 3 * c, dt).reshape(R, N, 3, H, hd).float().unbind(2)
        g = _view(do, R * N * c, dt).reshape(R, N, H, hd).float()
        rows = torch.arange(R)
        s = torch.einsum("rihd,rjhd->rhij", q, k) * scale + _view(
            mb, P * H * N * 64, torch.float32).reshape(P, H, N, 64)[rows % P][..., :N]
        p = torch.softmax(s, -1)
        dp = torch.einsum("rihd,rjhd->rhij", g, v)
        dsum = (p * dp).sum(-1, keepdim=True) if rowsum else 0.0
        ds = p * (dp - dsum)
        gs = (ds * scale).to(dt).float()
        dq = torch.einsum("rhij,rjhd->rihd", gs, k)
        dk = torch.einsum("rhij,rihd->rjhd", gs, q)
        dv = torch.einsum("rhij,rihd->rjhd", p.to(dt).float(), g)
        out = torch.stack([dq, dk, dv], 2).reshape(-1)
        _view(dqkv, R * N * 3 * c, dt).copy_(out.to(dt))
        dm = _view(dmb, P * H * N * N, torch.float32).reshape(P, H, N, N)
        dm += ds.reshape(R // P, P, H, N, N).sum(0)
        return 0

    def mumpy_ln_rows(self, x, g, b, h, mu, rstd, rows, C, dtype, stream):
        dt = DTYPES[dtype]
        X = _view(x, rows * C, dt).reshape(rows, C).float()
        m = X.mean(-1)
        rs = torch.rsqrt(((X - m[:, None]) ** 2).mean(-1) + 1e-5)
        H = (X - m[:, None]) * rs[:, None] * _view(g, C, dt).float() + _view(b, C, dt).float()
        _view(h, rows * C, dt).copy_(H.reshape(-1).to(dt))
        _view(mu, rows, torch.float32).copy_(m)
        _view(rstd, rows, torch.float32).copy_(rs)
        return 0

    def mumpy_ln_bwd_rows(self, x, mu, rstd, g, dh, dres, dx, rows, C, dtype, stream):
        dt = DTYPES[dtype]
        X = _view(x, rows * C, dt).reshape(rows, C).float()
        m, rs = (_view(t, rows, torch.float32)[:, None] for t in (mu, rstd))
        xh = (X - m) * rs
        dxh = _view(dh, rows * C, dt).reshape(rows, C).float() * _view(g, C, dt).float()
        v = (dxh - dxh.mean(-1, keepdim=True) - xh * (dxh * xh).mean(-1, keepdim=True)) * rs
        if dres is not None:
            v = v + _view(dres, rows * C, dt).reshape(rows, C).float()
        _view(dx, rows * C, dt).copy_(v.reshape(-1).to(dt))
        return 0

    def mumpy_scale_add_rows(self, a, b, s, out, rows, C, div, dtype, stream):
        dt = DTYPES[dtype]
        sr = _view(s, -(-rows // div), torch.float32)[torch.arange(rows) // div, None]
        v = sr * _view(b, rows * C, dt).reshape(rows, C).float()
        if a is not None:
            v = v + _view(a, rows * C, dt).reshape(rows, C).float()
        _view(out, rows * C, dt).copy_(v.reshape(-1).to(dt))
        return 0

    def mumpy_window_attention(self, q, k, v, o, mb, R, N, H, hd, q_mod, ldq, ldk, ldv,
                               ldo, P, scale, dtype, stream):
        dt = DTYPES[dtype]

        def heads(p, windows, ld):
            flat = _view(p, (windows * N - 1) * ld + H * hd, dt)
            return flat.as_strided((windows, N, H, hd), (N * ld, ld, hd, 1)).float()

        rows = torch.arange(R)
        s = torch.einsum("rihd,rjhd->rhij", heads(q, q_mod, ldq)[rows % q_mod],
                         heads(k, R, ldk)) * scale
        if mb is not None:
            s = s + _view(mb, P * H * N * 64, torch.float32).reshape(P, H, N, 64)[
                rows % P][..., :N]
        p = torch.softmax(s, -1).to(dt).float()
        out = torch.einsum("rhij,rjhd->rihd", p, heads(v, R, ldv)).reshape(R * N, H * hd)
        _view(o, R * N * ldo, dt).reshape(R * N, ldo)[:, :H * hd].copy_(out.to(dt))
        return 0

    def mumpy_cva_sample(self, x2, gy, gx, s, R, B1, N, C, groups, ws, dtype, stream):
        dt = DTYPES[dtype]
        coords = [_view(c, groups * B1 * N, torch.float32).reshape(groups, B1, N)
                  for c in (gy, gx)]
        sampled = cva.sample_plain(_view(x2, R * N * C, dt).reshape(R, N, C), *coords,
                                   groups, ws)
        _view(s, R * N * C, dt).copy_(sampled.reshape(-1))
        return 0

    def mumpy_vit3_attention(self, qkv, o, R, H, hd, scale, dtype, stream):
        # token t, row r, head h: q at (t*R + r)*3C + h*hd, k at +C, v at +2C
        dt = DTYPES[dtype]
        c = H * hd
        q, k, v = _view(qkv, 3 * R * 3 * c, dt).reshape(3, R, 3, H, hd).float().unbind(2)
        p = torch.softmax(torch.einsum("irhd,jrhd->rhij", q * scale, k), -1)
        out = torch.einsum("rhij,jrhd->irhd", p, v).reshape(-1)
        _view(o, 3 * R * c, dt).copy_(out.to(dt))
        return 0


@pytest.fixture
def model_lib(monkeypatch):
    monkeypatch.setattr(cuda_lib, "_lib", ModelLib())
    monkeypatch.setattr(cuda_lib, "stream_of", lambda tensor: None)


def check_launches(got, ref, dtype):
    """The launch model is exact in f32 (1e-5); in bf16 it rounds where the
    kernels round and is held to the chip's 2e-2 * max(1, max|ref|)."""
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        err = (g.float() - r).abs().max().item()
        assert err <= (1e-5 if dtype == torch.float32 else 2e-2 * max(1.0, r.abs().max().item()))
