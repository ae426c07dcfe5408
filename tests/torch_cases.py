"""Seeded inputs and weights shared by the kernel tests (numpy draws, JAX
layout (in, out)), their conversion to the port's kernel operands, the card
tests' fixture and checks, a model of the kernels' C entry points for the
CPU launch tests, and the spawning of a data-parallel run's ranks on one
host (the CPU tests' gloo ranks, ``chip_smoke.py``'s phase f).  Imports no
JAX, so the card-only tests can use it where JAX is absent."""

import ctypes
import math
import os
import socket
import time

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


# ---- ranks of a data-parallel run, spawned on this host ----

def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_env(rank: int, world: int, port: int, local_rank: int = None) -> None:
    """Set the variables ``torchrun`` gives a rank (``parallel.init_from_env``
    reads them): a rendezvous on localhost ``port``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank if local_rank is None else local_rank))


def spawn_ranks(fn, world: int, args=(), timeout: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes and join them
    within ``timeout`` seconds.  A rank that raises or exits non-zero raises
    here (the others are stopped); so does a run past the timeout, which
    kills every rank first."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=tuple(args), nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout:.0f} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)


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
    """The n elements at a pointer (an int, as the wrappers pass it), as a
    writable tensor."""
    size = n * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_char * size).from_address(p), dtype=dtype)


def _mask(mb, P, H, N, strides, mb_dtype):
    """The (P, H, N, N) mask+bias at ``mb`` through its element strides, f32."""
    extent = 1 + sum((d - 1) * st for d, st in zip((P, H, N, N), strides))
    return _view(mb, extent, DTYPES[mb_dtype]).as_strided((P, H, N, N), strides).float()


class ModelLib:
    """What csrc/gemm.cu, gemm_sm90.cu, mlp_sm90.cu, attn_sm90.cu,
    vit3_sm90.cu, cva_sm90.cu, window_attention.cu, window_attention_bwd.cu,
    train_rows.cu, wgrad.cu, cva_sample.cu and vit3_attention.cu compute, on
    the raw buffers the wrappers pass, and the launch sequences of
    swin_pair.cu, swin_block_train.cu, vit3_sm90.cu and cva_sm90.cu, composed
    from those."""

    def mumpy_gemm(self, x, w, bias, g, b, res, a_map, c_map, y, out, row_scale, aux,
                   aux_out, M, N, K, a_sum, a_seg, act, map_len, scale_div, dtype, stream):
        assert dtype == 0, "csrc/gemm.cu takes f32 only"
        s = None if row_scale is None else _view(row_scale, -(-M // scale_div), torch.float32)
        return self._gemm(x, w, bias, g, b, res, a_map, c_map, y, out, s, aux, aux_out, M, N,
                          K, a_sum, a_seg, act, map_len, scale_div, DTYPES[dtype])

    def mumpy_gemm_sm90(self, a, b, bias, res, row_scale, aux, y, out, aux_out, M, N, K,
                        b_kmajor, act, scale_div, row_scale_on, stream):
        # bf16 only, K and N multiples of 8, 16-byte aligned operands (the wrapper checks)
        assert K % 8 == 0 and N % 8 == 0
        assert all(p is None or p % 16 == 0 for p in (a, b, bias, res, aux, y, out, aux_out))
        s = None if row_scale is None else _view(row_scale, -(-M // scale_div), torch.float32)
        if s is not None and not row_scale_on:  # the planted fault: the scale ignored
            s = torch.ones_like(s)
        return self._gemm(a, b, bias, None, None, res, None, None, y, out, s, aux, aux_out, M,
                          N, K, 1, 1, act, 0, scale_div, torch.bfloat16, b_kmajor)

    def mumpy_gemm_rows(self, a, b, bias, res, row_scale, aux, y, out, aux_out, a_map, c_map,
                        map_len, M, N, K, b_kmajor, act, scale_div, row_scale_on, stream):
        # the persistent GEMM: mumpy_gemm_sm90's operands and checks, with the maps
        assert K % 8 == 0 and N % 8 == 0
        assert all(p is None or p % 16 == 0 for p in (a, b, bias, res, aux, y, out, aux_out))
        assert (a_map is None and c_map is None) or (map_len > 0 and M % map_len == 0)
        s = None if row_scale is None else _view(row_scale, -(-M // scale_div), torch.float32)
        if s is not None and not row_scale_on:
            s = torch.ones_like(s)
        return self._gemm(a, b, bias, None, None, res, a_map, c_map, y, out, s, aux, aux_out, M,
                          N, K, 1, 1, act, map_len, scale_div, torch.bfloat16, b_kmajor)

    def _gemm(self, x, w, bias, g, b, res, a_map, c_map, y, out, s, aux, aux_out, M, N, K,
              a_sum, a_seg, act, map_len, scale_div, dt, w_kmajor=False):
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
        W = _view(w, K * N, dt).float()
        v = A @ (W.reshape(N, K).t() if w_kmajor else W.reshape(K, N))
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
            if s is None:
                o = resid + yv.float()
            else:  # res + s * v, rounded once
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
        assert dtype == 0, "csrc/wgrad.cu's gemm_tn is the f32 form"
        return self._tn(a, b, ws, dw, db, M, O, I, rows_per_split, torch.float32)

    def mumpy_gemm_sm90_tn(self, a, b, ws, dw, db, rows, M, N, rows_per_split, stream):
        assert M % 8 == 0 and N % 8 == 0
        assert all(p is None or p % 16 == 0 for p in (a, b, ws, dw))
        return self._tn(a, b, ws, dw, db, rows, M, N, rows_per_split, torch.bfloat16)

    def _tn(self, a, b, ws, dw, db, M, O, I, rows_per_split, dt):
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

    def mumpy_reduce_splits(self, ws, n, desc, outs, stream):
        for i in range(n):
            off, splits, len1, len2, dtype = desc[5 * i: 5 * i + 5]
            dt = DTYPES[dtype]
            total = _view(ws + 4 * off, splits * (len1 + len2), torch.float32).reshape(
                splits, -1).sum(0)
            _view(outs[2 * i], len1, dt).copy_(total[:len1].to(dt))
            if len2:
                _view(outs[2 * i + 1], len2, dt).copy_(total[len1:].to(dt))
        return 0

    def mumpy_window_attention_bwd(self, qkv, do, mb, dqkv, o, dmb, R, N, H, hd, P, mb_dtype,
                                   s0, s1, s2, s3, chunks, scale, rowsum, dtype, stream):
        dt = DTYPES[dtype]
        c = H * hd
        q, k, v = _view(qkv, R * N * 3 * c, dt).reshape(R, N, 3, H, hd).float().unbind(2)
        g = _view(do, R * N * c, dt).reshape(R, N, H, hd).float()
        rows = torch.arange(R)
        s = torch.einsum("rihd,rjhd->rhij", q, k) * scale + _mask(
            mb, P, H, N, (s0, s1, s2, s3), mb_dtype)[rows % P]
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
        if o is not None:  # the forward's head outputs, T(P) V
            ov = torch.einsum("rhij,rjhd->rihd", p.to(dt).float(), v).reshape(-1)
            _view(o, R * N * c, dt).copy_(ov.to(dt))
        return 0

    # csrc/swin_block_train.cu launches, for bf16, the sequence that
    # ops/swin_block_train.py composes for f32: the model runs that
    # composition on the same buffers (through the models above)
    @staticmethod
    def _block(x, mb, mb_dtype, strides, keep1, keep2, w, R, N, C, hidden, H, P):
        from mumpy_tpu_torch.ops import swin_block_train as sbt

        bf = torch.bfloat16
        shapes = ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,), (C,), (C,), (hidden, C),
                  (hidden,), (C, hidden), (C,))
        weights = [_view(w[i], math.prod(shape), bf).reshape(shape)
                   for i, shape in enumerate(shapes)]
        return (_view(x, R * N * C, bf).reshape(R, N, C),
                _view(mb, 1 + sum((d - 1) * st for d, st in zip((P, H, N, N), strides)),
                      DTYPES[mb_dtype]).as_strided((P, H, N, N), strides),
                _view(keep1, R, torch.float32), _view(keep2, R, torch.float32), weights, sbt)

    def mumpy_swin_block_train_scratch(self, R, N, C, hidden, H, P, backward):
        return 256

    def mumpy_swin_block_train_fwd(self, x, mb, mb_dtype, s0, s1, s2, s3, keep1, keep2, w, y,
                                   scratch, R, N, C, hidden, H, P, stream):
        x, mb, keep1, keep2, weights, sbt = self._block(x, mb, mb_dtype, (s0, s1, s2, s3), keep1,
                                                        keep2, w, R, N, C, hidden, H, P)
        transposed = [weights[i].t() for i in (2, 4, 8, 10)]
        out = sbt.forward_sequence(x, mb, keep1, keep2, weights, transposed, H)
        _view(y, R * N * C, torch.bfloat16).copy_(out.reshape(-1))
        return 0

    def mumpy_swin_block_train_bwd(self, x, dy, mb, mb_dtype, s0, s1, s2, s3, keep1, keep2, w,
                                   dx, dmb, dw, scratch, R, N, C, hidden, H, P, rowsum,
                                   gelu_grad, row_scale_on, stream):
        x, mb, keep1, keep2, weights, sbt = self._block(x, mb, mb_dtype, (s0, s1, s2, s3), keep1,
                                                        keep2, w, R, N, C, hidden, H, P)
        dyt = _view(dy, R * N * C, torch.bfloat16).reshape(R, N, C)
        transposed = [weights[i].t() for i in (2, 4, 8)]
        got = sbt.backward_sequence(x, mb, keep1, keep2, *weights, *transposed, H, dyt,
                                    bool(rowsum), bool(gelu_grad), bool(row_scale_on))
        _view(dx, R * N * C, torch.bfloat16).copy_(got[0].reshape(-1))
        _view(dmb, P * H * N * N, DTYPES[mb_dtype]).copy_(got[1].reshape(-1))
        for i, g in enumerate(got[4:]):
            _view(dw[i], g.numel(), torch.bfloat16).copy_(g.reshape(-1))
        return 0

    # csrc/swin_pair.cu launches, for bf16, the block sequence that
    # ops/swin_block.py composes for f32: the model runs that composition
    def mumpy_swin_blocks_scratch(self, R, N, C, hidden, blocks):
        return 256

    def mumpy_swin_blocks_fwd(self, x, blocks, w, mb, mb_desc, row_map, map_len, y, scratch,
                              R, N, C, hidden, H, ln_stats_on, gelu_on, stream):
        from mumpy_tpu_torch.ops import swin_block

        bf = torch.bfloat16
        shapes = ((C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,), (C, hidden),
                  (hidden,), (hidden, C), (C,))
        names = ("ln_g", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj",
                 "ln_g", "ln_b", "w1", "b1", "w2", "b2")
        out = _view(x, R * N * C, bf).reshape(R * N, C)
        rmap = None if row_map is None else _view(row_map, map_len, torch.int32)
        for i in range(blocks):
            ws = [_view(w[12 * i + j], math.prod(shape), bf).reshape(shape)
                  for j, shape in enumerate(shapes)]
            dtype, s0, s1, s2, s3, P = mb_desc[6 * i: 6 * i + 6]
            ops = {"attn": {**dict(zip(names[:6], ws[:6])), "heads": H,
                            "mb": _mask(mb[i], P, H, N, (s0, s1, s2, s3), dtype).to(DTYPES[dtype])},
                   "mlp": dict(zip(names[6:], ws[6:]))}
            out = swin_block.block_sequence(out, ops, R, N, row_map=rmap if i == 0 else None,
                                            ln_stats_on=bool(ln_stats_on),
                                            gelu_on=bool(gelu_on))
        _view(y, R * N * C, bf).copy_(out.reshape(-1))
        return 0

    def mumpy_mlp_rows(self, x, g, b, w1, b1, w2, b2, y, M, C, hidden, ln_stats_on, gelu_on,
                       stream):
        # csrc/mlp_sm90.cu: bf16, C a multiple of 16 up to 256, hidden a
        # multiple of 8, 16-byte aligned operands, y apart from x (the
        # wrapper checks); rounded where the kernel rounds: h, g, the branch
        assert C % 16 == 0 and 16 <= C <= 256 and hidden % 8 == 0 and x != y
        assert all(p % 16 == 0 for p in (x, g, b, w1, b1, w2, b2, y))
        bf = torch.bfloat16
        X = _view(x, M * C, bf).reshape(M, C).float()
        mu = X.mean(-1, keepdim=True)
        rs = torch.rsqrt(((X - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        if not ln_stats_on:  # the planted fault: mean 0, rstd 1
            mu, rs = torch.zeros_like(mu), torch.ones_like(rs)
        h = ((X - mu) * rs * _view(g, C, bf).float() + _view(b, C, bf).float()).to(bf).float()
        f1 = h @ _view(w1, C * hidden, bf).float().reshape(C, hidden) + _view(b1, hidden, bf).float()
        hid = (F.gelu(f1) if gelu_on else f1).to(bf).float()  # gelu_on = 0: the planted fault
        v = hid @ _view(w2, hidden * C, bf).float().reshape(hidden, C) + _view(b2, C, bf).float()
        _view(y, M * C, bf).copy_((X + v.to(bf).float()).to(bf).reshape(-1))
        return 0

    def mumpy_attn_rows(self, x, g, b, w_qkv, b_qkv, w_proj, b_proj, mb, mb_dtype, s0, s1, s2,
                        s3, P, y, out, R, N, C, H, ln_stats_on, key_mask_on, stream):
        # csrc/attn_sm90.cu: bf16, head width 32, C <= 256, N <= 64, 16-byte
        # aligned operands, outputs apart from x (the kernel refuses others);
        # rounded where the kernel rounds: h, q, k, v, P, o, y, out.  Each
        # window reads 64 rows, its N and the rows after it (zero past the
        # last), and normalises them all; keys >= N are masked unless
        # key_mask_on = 0, the planted fault
        assert C % 32 == 0 and C <= 256 and C == 32 * H and 0 < N <= 64 and R % P == 0
        assert all(p % 16 == 0 for p in (x, g, b, w_qkv, b_qkv, w_proj, b_proj, y, out))
        assert len({x, y, out}) == 3
        bf = torch.bfloat16
        X = _view(x, R * N * C, bf).reshape(R * N, C).float()
        rows = torch.arange(R)[:, None] * N + torch.arange(64)
        T = torch.cat([X, torch.zeros(64, C)])[rows]  # (R, 64, C)
        mu = T.mean(-1, keepdim=True)
        rs = torch.rsqrt(((T - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        if not ln_stats_on:  # the planted fault: mean 0, rstd 1
            mu, rs = torch.zeros_like(mu), torch.ones_like(rs)
        h = ((T - mu) * rs * _view(g, C, bf).float() + _view(b, C, bf).float()).to(bf).float()
        qkv = (h @ _view(w_qkv, 3 * C * C, bf).float().reshape(3 * C, C).t()
               + _view(b_qkv, 3 * C, bf).float()).to(bf).float()
        q, k, v = qkv.reshape(R, 64, 3, H, 32).unbind(2)  # (R, 64, H, 32)
        s = torch.einsum("rihd,rjhd->rhij", q, k) * 32**-0.5
        m = torch.zeros(R, H, 64, 64)
        m[:, :, :N, :N] = _mask(mb, P, H, N, (s0, s1, s2, s3), mb_dtype)[torch.arange(R) % P]
        if key_mask_on:
            m[..., N:] = -1e30
        prob = torch.softmax(s + m, -1).to(bf).float()
        o = torch.einsum("rhij,rjhd->rihd", prob, v).reshape(R, 64, C)[:, :N].to(bf).float()
        yv = (o @ _view(w_proj, C * C, bf).float().reshape(C, C)
              + _view(b_proj, C, bf).float()).to(bf)
        _view(y, R * N * C, bf).copy_(yv.reshape(-1))
        _view(out, R * N * C, bf).copy_((X.reshape(R, N, C) + yv.float()).to(bf).reshape(-1))
        return 0

    # csrc/swin_pair.cu's #3 and #4 calls: the fused kernel where it takes
    # the widths, else the sequences ops/attn_ln.py and ops/ln_mlp.py compose
    def mumpy_attn_ln_scratch(self, R, N, C, H):
        return 256

    def mumpy_attn_ln_fwd(self, x, w, mb, mb_dtype, s0, s1, s2, s3, P, y, out, scratch, R, N, C,
                          H, ln_stats_on, key_mask_on, stream):
        from mumpy_tpu_torch.ops import attn_ln

        if N <= 64 and C <= 256 and C == 32 * H:
            return self.mumpy_attn_rows(x, *w, mb, mb_dtype, s0, s1, s2, s3, P, y, out, R, N, C,
                                        H, ln_stats_on, key_mask_on, stream)
        bf = torch.bfloat16
        shapes = ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,))
        ws = [_view(w[i], math.prod(shape), bf).reshape(shape) for i, shape in enumerate(shapes)]
        ops = {"ln_g": ws[0], "ln_b": ws[1], "w_qkv": ws[2].t(), "b_qkv": ws[3],
               "w_proj": ws[4], "b_proj": ws[5], "heads": H,
               "mb": _mask(mb, P, H, N, (s0, s1, s2, s3), mb_dtype).to(DTYPES[mb_dtype])}
        got = attn_ln.attn_sequence(_view(x, R * N * C, bf).reshape(R * N, C), ops, R, N,
                                    ln_stats_on=bool(ln_stats_on))
        _view(y, R * N * C, bf).copy_(got[0].reshape(-1))
        _view(out, R * N * C, bf).copy_(got[1].reshape(-1))
        return 0

    def mumpy_ln_mlp_scratch(self, M, C, hidden):
        return 256

    def mumpy_ln_mlp_fwd(self, x, w, y, scratch, M, C, hidden, ln_stats_on, gelu_on, stream):
        from mumpy_tpu_torch.ops import ln_mlp

        bf = torch.bfloat16
        shapes = ((C,), (C,), (C, hidden), (hidden,), (hidden, C), (C,))
        ws = [_view(w[i], math.prod(shape), bf).reshape(shape) for i, shape in enumerate(shapes)]
        ops = dict(zip(("ln_g", "ln_b", "w1", "b1", "w2", "b2"), ws))
        got = ln_mlp.mlp_sequence(_view(x, M * C, bf).reshape(M, C), ops,
                                  ln_stats_on=bool(ln_stats_on), gelu_on=bool(gelu_on))
        _view(y, M * C, bf).copy_(got.reshape(-1))
        return 0

    # csrc/swin_block_train.cu's attn_ln_train calls, the sequences
    # ops/attn_ln_train.py composes for f32, likewise
    @staticmethod
    def _attn_views(x, mb, mb_dtype, strides, keep, w, R, N, C, H, P):
        bf = torch.bfloat16
        shapes = ((C,), (C,), (3 * C, C), (3 * C,), (C, C), (C,))
        weights = [None if w[i] is None else _view(w[i], math.prod(shape), bf).reshape(shape)
                   for i, shape in enumerate(shapes)]
        extent = 1 + sum((d - 1) * st for d, st in zip((P, H, N, N), strides))
        return (_view(x, R * N * C, bf).reshape(R, N, C),
                _view(mb, extent, DTYPES[mb_dtype]).as_strided((P, H, N, N), strides),
                _view(keep, R, torch.float32), weights)

    def mumpy_attn_ln_train_scratch(self, R, N, C, H, P, backward):
        return 256

    def mumpy_attn_ln_train_fwd(self, x, mb, mb_dtype, s0, s1, s2, s3, keep, w, y, out,
                                scratch, R, N, C, H, P, stream):
        from mumpy_tpu_torch.ops import attn_ln_train

        bf = torch.bfloat16
        xt, mbt, kt, ws = self._attn_views(x, mb, mb_dtype, (s0, s1, s2, s3), keep, w, R, N, C,
                                           H, P)
        got = attn_ln_train.forward_sequence(xt, mbt, kt, *ws, H)
        _view(y, R * N * C, bf).copy_(got[0].reshape(-1))
        _view(out, R * N * C, bf).copy_(got[1].reshape(-1))
        return 0

    def mumpy_attn_ln_train_bwd(self, x, dy, dout, mb, mb_dtype, s0, s1, s2, s3, keep, w, dx,
                                dmb, dw, scratch, R, N, C, H, P, rowsum, stream):
        from mumpy_tpu_torch.ops import attn_ln_train

        bf = torch.bfloat16
        xt, mbt, kt, ws = self._attn_views(x, mb, mb_dtype, (s0, s1, s2, s3), keep, w, R, N, C,
                                           H, P)
        dyt = None if dy is None else _view(dy, R * N * C, bf).reshape(R, N, C)
        got = attn_ln_train.backward_sequence(xt, mbt, kt, *ws[:5], None, H, dyt,
                                              _view(dout, R * N * C, bf).reshape(R, N, C),
                                              bool(rowsum))
        _view(dx, R * N * C, bf).copy_(got[0].reshape(-1))
        _view(dmb, P * H * N * N, DTYPES[mb_dtype]).copy_(got[1].reshape(-1))
        for i, g in enumerate(got[3:]):
            _view(dw[i], g.numel(), bf).copy_(g.reshape(-1))
        return 0

    # csrc/swin_block_train.cu's ln_mlp_train calls, the sequences
    # ops/ln_mlp_train.py composes for f32, likewise
    @staticmethod
    def _mlp(x, keep, w, rows, C, hidden, div):
        bf = torch.bfloat16
        shapes = ((C,), (C,), (hidden, C), (hidden,), (C, hidden), (C,))
        ws = [None if w[i] is None else _view(w[i], math.prod(shape), bf).reshape(shape)
              for i, shape in enumerate(shapes)]
        return (_view(x, rows * C, bf).reshape(rows, C),
                _view(keep, -(-rows // div), torch.float32), ws)

    def mumpy_ln_mlp_train_scratch(self, rows, C, hidden, backward):
        return 256

    def mumpy_ln_mlp_train_fwd(self, x, keep, w, out, scratch, rows, C, hidden, div, stream):
        from mumpy_tpu_torch.ops import ln_mlp_train

        x, keep, ws = self._mlp(x, keep, w, rows, C, hidden, div)
        got = ln_mlp_train.forward_sequence(x, keep, *ws, div=div)
        _view(out, rows * C, torch.bfloat16).copy_(got.reshape(-1))
        return 0

    def mumpy_ln_mlp_train_bwd(self, x, dy, keep, w, dx, dw, scratch, rows, C, hidden, div,
                               gelu_grad, stream):
        from mumpy_tpu_torch.ops import ln_mlp_train

        x, keep, ws = self._mlp(x, keep, w, rows, C, hidden, div)
        dyt = _view(dy, rows * C, torch.bfloat16).reshape(rows, C)
        got = ln_mlp_train.backward_sequence(x, keep, *ws[:5], None, dyt, div, bool(gelu_grad))
        _view(dx, rows * C, torch.bfloat16).copy_(got[0].reshape(-1))
        for i, g in enumerate(got[2:]):
            _view(dw[i], g.numel(), torch.bfloat16).copy_(g.reshape(-1))
        return 0

    def mumpy_ln_rows(self, x, g, b, h, mu, rstd, rows, C, stats_on, dtype, stream):
        dt = DTYPES[dtype]
        X = _view(x, rows * C, dt).reshape(rows, C).float()
        m = X.mean(-1)
        rs = torch.rsqrt(((X - m[:, None]) ** 2).mean(-1) + 1e-5)
        if not stats_on:  # the planted fault: mean 0, rstd 1
            m, rs = torch.zeros_like(m), torch.ones_like(rs)
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
                               ldo, P, mb_dtype, s0, s1, s2, s3, scale, dtype, stream):
        dt = DTYPES[dtype]

        def heads(p, windows, ld):
            flat = _view(p, (windows * N - 1) * ld + H * hd, dt)
            return flat.as_strided((windows, N, H, hd), (N * ld, ld, hd, 1)).float()

        rows = torch.arange(R)
        s = torch.einsum("rihd,rjhd->rhij", heads(q, q_mod, ldq)[rows % q_mod],
                         heads(k, R, ldk)) * scale
        if mb is not None:
            s = s + _mask(mb, P, H, N, (s0, s1, s2, s3), mb_dtype)[rows % P]
        p = torch.softmax(s, -1).to(dt).float()
        out = torch.einsum("rhij,rjhd->rihd", p, heads(v, R, ldv)).reshape(R * N, H * hd)
        _view(o, R * N * ldo, dt).reshape(R * N, ldo)[:, :H * hd].copy_(out.to(dt))
        return 0

    def mumpy_cva_sample(self, x2, gy, gx, s, R, B1, N, C, groups, ws, sample_on, dtype,
                         stream):
        dt = DTYPES[dtype]
        coords = [_view(c, groups * B1 * N, torch.float32).reshape(groups, B1, N)
                  for c in (gy, gx)]
        if not sample_on:  # the planted fault: the tap at the floor, weight 1
            coords = [c.floor() for c in coords]
        sampled = cva.sample_plain(_view(x2, R * N * C, dt).reshape(R, N, C), *coords,
                                   groups, ws)
        _view(s, R * N * C, dt).copy_(sampled.reshape(-1))
        return 0

    def mumpy_window_attention_fold(self, q, k, v, o, R, N, H, hd, q_mod, ldq, ldk, ldv, ldo,
                                    fold, fold_on, scale, dtype, stream):
        # the core without an additive term into a scratch o, then each run of
        # fold windows summed in f32 from the rounded o (only the first with
        # fold_on = 0, the planted fault) and rounded again
        assert R % fold == 0
        dt = DTYPES[dtype]
        c = H * hd
        full = torch.empty(R * N * c, dtype=dt)
        self.mumpy_window_attention(q, k, v, full.data_ptr(), None, R, N, H, hd, q_mod, ldq, ldk,
                                    ldv, c, 1, 0, 0, 0, 0, 0, scale, dtype, stream)
        runs = full.float().reshape(R // fold, fold, N, c)
        summed = runs.sum(1) if fold_on else runs[:, 0]
        _view(o, (R // fold * N - 1) * ldo + c, dt).as_strided(
            (R // fold * N, c), (ldo, 1)).copy_(summed.reshape(-1, c).to(dt))
        return 0

    # csrc/vit3_sm90.cu: the fused qkv + n = 3 attention, and #6's call
    def mumpy_vit3_qkv_attn(self, h, w_qkv, b_qkv, o, R, C, H, stream):
        # bf16, head width 64, 16-byte aligned operands (the kernel refuses
        # others); rounded where the kernel rounds: q, k, v, o
        assert C == 64 * H and all(p % 16 == 0 for p in (h, w_qkv, b_qkv, o)) and h != o
        bf = torch.bfloat16
        X = _view(h, 3 * R * C, bf).reshape(3, R, C).float()
        qkv = (X @ _view(w_qkv, 3 * C * C, bf).float().reshape(3 * C, C).t()
               + _view(b_qkv, 3 * C, bf).float()).to(bf).float()
        q, k, v = qkv.reshape(3, R, 3, H, 64).unbind(2)
        p = torch.softmax(torch.einsum("irhd,jrhd->rhij", q * 0.125, k), -1)
        out = torch.einsum("rhij,jrhd->irhd", p, v).reshape(-1)
        _view(o, 3 * R * C, bf).copy_(out.to(bf))
        return 0

    def mumpy_vit3_scratch(self, R, C, hidden, H):
        return 256

    def mumpy_vit3_fwd(self, x, w, out, scratch, R, C, hidden, H, stream):
        # the launches of the C call on buffers of its own: ln_rows, the
        # fused kernel (else the qkv GEMM and vit3_attention.cu), proj with
        # the residual, #4's call
        w = list(w)
        rows, bf = 3 * R, torch.bfloat16
        h, o, y = (torch.empty(rows * C, dtype=bf) for _ in range(3))
        mu, rstd = torch.empty(rows), torch.empty(rows)
        self.mumpy_ln_rows(x, w[0], w[1], h.data_ptr(), mu.data_ptr(), rstd.data_ptr(), rows, C,
                           1, 1, stream)
        if C == 64 * H:
            self.mumpy_vit3_qkv_attn(h.data_ptr(), w[2], w[3], o.data_ptr(), R, C, H, stream)
        else:
            qkv = torch.empty(rows * 3 * C, dtype=bf)
            self.mumpy_gemm_rows(h.data_ptr(), w[2], w[3], None, None, None, qkv.data_ptr(), None,
                                 None, None, None, 0, rows, 3 * C, C, 1, 0, 1, 1, stream)
            self.mumpy_vit3_attention(qkv.data_ptr(), o.data_ptr(), R, H, C // H,
                                      (C // H) ** -0.5, 1, stream)
        self.mumpy_gemm_rows(o.data_ptr(), w[4], w[5], x, None, None, None, y.data_ptr(), None,
                             None, None, 0, rows, C, C, 0, 0, 1, 1, stream)
        return self.mumpy_ln_mlp_fwd(y.data_ptr(), w[6:], out, None, rows, C, hidden, 1, 1,
                                     stream)

    # csrc/cva_sm90.cu: the fused core, and #5's call
    def mumpy_cva_rows(self, x1, x2, gy, gx, w_q, b_q, w_kv, b_kv, w_proj, out, B1, R, N, C, H,
                       groups, ws, sample_on, fold_on, key_mask_on, stream):
        # bf16, head width 32, C <= 256, N = ws^2 <= 64, 16-byte aligned
        # operands (the kernel refuses others); rounded where the kernel
        # rounds: s, q, k, v, P, each head's o, out.  Each partner window's s
        # is zero past row N (its 64-row slot), so keys >= N hold the k and v
        # biases; they are masked unless key_mask_on = 0, the planted fault.
        # The projection accumulates in f32 over heads and ratio steps
        assert C == 32 * H and C <= 256 and N == ws * ws <= 64 and R % B1 == 0
        assert (C // groups) % 8 == 0 and all(
            p % 16 == 0 for p in (x1, x2, w_q, b_q, w_kv, b_kv, w_proj, out))
        bf = torch.bfloat16
        ratio = R // B1
        X1 = _view(x1, B1 * N * C, bf).reshape(B1, N, C)
        X2 = _view(x2, R * N * C, bf).reshape(R, N, C)
        GY, GX = (_view(c, groups * B1 * N, torch.float32).reshape(groups, B1, N)
                  for c in (gy, gx))
        if not sample_on:  # the planted fault: the tap at the floor, weight 1
            GY, GX = GY.floor(), GX.floor()
        Wq = _view(w_q, C * C, bf).float().reshape(C, C)
        Wkv = _view(w_kv, 2 * C * C, bf).float().reshape(2 * C, C)
        Wp = _view(w_proj, C * C, bf).float().reshape(C, C)
        bq, bkv = _view(b_q, C, bf).float(), _view(b_kv, 2 * C, bf).float()
        acc = torch.zeros(B1, N, C)
        for t in range(ratio if fold_on else 1):
            js = torch.arange(B1) * ratio + t
            qw = js % B1
            s = cva.sample_plain(X2[js], GY[:, qw], GX[:, qw], groups, ws).float()
            s = torch.cat([s, torch.zeros(B1, 64 - N, C)], 1)  # the slot's 64 rows
            q = (X1[qw].float() @ Wq.t() + bq).to(bf).float().reshape(B1, N, H, 32)
            kv = (s @ Wkv.t() + bkv).to(bf).float()
            k, v = (u.reshape(B1, 64, H, 32) for u in (kv[..., :C], kv[..., C:]))
            sc = torch.einsum("bihd,bjhd->bhij", q, k) * 32**-0.5
            sc[..., N:] += -1e30 if key_mask_on else 0.0
            prob = torch.softmax(sc, -1).to(bf).float()
            o = torch.einsum("bhij,bjhd->bihd", prob, v).to(bf).float().reshape(B1, N, C)
            acc += o @ Wp
        _view(out, B1 * N * C, bf).copy_(acc.to(bf).reshape(-1))
        return 0

    def mumpy_cva_scratch(self, B1, R, N, C, H, groups, ws):
        return 256

    def mumpy_cva_fwd(self, x1, x2, gy, gx, w, out, scratch, B1, R, N, C, H, groups, ws,
                      sample_on, fold_on, key_mask_on, stream):
        # the fused kernel where it takes the widths, else the five launches
        # of the C call on buffers of its own
        w = list(w)
        if C == 32 * H and C <= 256 and N == ws * ws <= 64 and (C // groups) % 8 == 0:
            return self.mumpy_cva_rows(x1, x2, gy, gx, *w, out, B1, R, N, C, H, groups, ws,
                                       sample_on, fold_on, key_mask_on, stream)
        bf, hd = torch.bfloat16, C // H
        q, o = (torch.empty(B1 * N * C, dtype=bf) for _ in range(2))
        s, kv = torch.empty(R * N * C, dtype=bf), torch.empty(R * N * 2 * C, dtype=bf)
        self.mumpy_gemm_rows(x1, w[0], w[1], None, None, None, q.data_ptr(), None, None, None,
                             None, 0, B1 * N, C, C, 1, 0, 1, 1, stream)
        self.mumpy_cva_sample(x2, gy, gx, s.data_ptr(), R, B1, N, C, groups, ws, sample_on, 1,
                              stream)
        self.mumpy_gemm_rows(s.data_ptr(), w[2], w[3], None, None, None, kv.data_ptr(), None,
                             None, None, None, 0, R * N, 2 * C, C, 1, 0, 1, 1, stream)
        self.mumpy_window_attention_fold(q.data_ptr(), kv.data_ptr(), kv.data_ptr() + 2 * C,
                                         o.data_ptr(), R, N, H, hd, B1, C, 2 * C, 2 * C, C,
                                         R // B1, fold_on, hd**-0.5, 1, stream)
        return self.mumpy_gemm_rows(o.data_ptr(), w[4], None, None, None, None, out, None, None,
                                    None, None, 0, B1 * N, C, C, 0, 0, 1, 1, stream)

    def mumpy_vit3_attention(self, qkv, o, R, H, hd, scale, dtype, stream):
        # token t, row r, head h: q at (t*R + r)*3C + h*hd, k at +C, v at +2C
        dt = DTYPES[dtype]
        c = H * hd
        q, k, v = _view(qkv, 3 * R * 3 * c, dt).reshape(3, R, 3, H, hd).float().unbind(2)
        p = torch.softmax(torch.einsum("irhd,jrhd->rhij", q * scale, k), -1)
        out = torch.einsum("rhij,jrhd->irhd", p, v).reshape(-1)
        _view(o, 3 * R * c, dt).copy_(out.to(dt))
        return 0


def record_calls(monkeypatch, *names):
    """Record the C entry points of ``names`` that the model runs, in order,
    as (name, arguments) pairs (nested calls of a sequence's model too)."""
    calls = []
    for name in names:
        fn = getattr(ModelLib, name)
        monkeypatch.setattr(ModelLib, name,
                            lambda self, *a, fn=fn, name=name: calls.append((name, a))
                            or fn(self, *a))
    return calls


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
