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
    """What csrc/gemm.cu, window_attention.cu, cva_sample.cu and
    vit3_attention.cu compute, on the raw buffers the wrappers pass."""

    def mumpy_gemm(self, x, w, bias, g, b, res, a_map, c_map, y, out, M, N, K, a_sum,
                   a_seg, gelu, map_len, dtype, stream):
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
        yv = (F.gelu(v) if gelu else v).to(dt)
        c_rows = mapped(c_map)
        if y is not None:
            _view(y, M * N, dt).reshape(M, N)[c_rows] = yv
        if out is not None:
            resid = _view(res, M * N, dt).reshape(M, N)[c_rows].float()
            _view(out, M * N, dt).reshape(M, N)[c_rows] = (resid + yv.float()).to(dt)
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
