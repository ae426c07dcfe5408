"""Build and bind the hand-written CUDA kernels of ``mumpy_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library
is cached under ``<repo>/build/`` keyed by a hash of the sources, so a checkout
builds everything from its own files and a changed source rebuilds.  Nothing
is built at import time: every module of the package imports on a machine
without ``nvcc`` or a GPU.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds = None  # wall time of the nvcc run, or 0.0 when the cache hit
build_log = ""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mumpy_gemm": [_P] * 13 + [_I] * 9 + [_P],
    "mumpy_gemm_tn": [_P] * 5 + [_I] * 5 + [_P],
    "mumpy_col_sums": [_P] * 7 + [_I] * 4 + [_P],
    "mumpy_reduce_splits": [_P, _I, _I, _P, _I, _P, _I, _P],
    "mumpy_window_attention": [_P] * 5 + [_I] * 10 + [_F, _I, _P],
    "mumpy_cva_sample": [_P] * 4 + [_I] * 7 + [_P],
    "mumpy_vit3_attention": [_P] * 2 + [_I] * 3 + [_F, _I, _P],
    "mumpy_window_attention_bwd": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "mumpy_ln_rows": [_P] * 6 + [_I] * 3 + [_P],
    "mumpy_ln_bwd_rows": [_P] * 7 + [_I] * 3 + [_P],
    "mumpy_scale_add_rows": [_P] * 4 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def _build() -> Path:
    global build_seconds, build_log
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sorted(_CSRC.iterdir()):
        digest.update(f.name.encode() + f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"libmumpy_kernels_{digest.hexdigest()[:16]}.so"
    if target.exists():
        build_seconds = 0.0
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
        if not failed:
            so = Path(tmp) / "lib.so"
            link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(so),
                                   *map(str, objs)], capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["the link"]
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
        os.replace(so, target)  # atomic: a concurrent build never sees half a file
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.mumpy_error_string.argtypes = [ctypes.c_int]
        handle.mumpy_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().mumpy_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}") from None


def stream_of(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, name: str, like: torch.Tensor, shape=None,
            dtype=None) -> None:
    """Check that ``t`` is a contiguous tensor on ``like``'s CUDA device with
    the given dtype (default ``like.dtype``) and shape."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    want = like.dtype if dtype is None else dtype
    if t.dtype != want:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy only where it is not), as
    the bf16 kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---- launch helpers shared by the kernel wrappers ------------------------

_GRID_Y_MAX_ROWS = 65535 * 64  # gemm grid.y limit times the 64-row tile
_TC_MAX_LN_K = 1024  # kTcMaxLnK: LayerNorm rows the bf16 GEMM holds in registers


ACT_NONE, ACT_GELU, ACT_GELU_GRAD = 0, 1, 2  # the GEMM epilogue's activation (csrc/gemm.cu)


def gemm(x, w, bias=None, ln=None, res=None, want_y=True, want_out=False,
         gelu=False, a_sum=1, a_seg=1, a_map=None, c_map=None, row_scale=None,
         scale_div=1, gelu_grad_of=None, gelu_out=None):
    """Launch the tiled GEMM (csrc/gemm.cu).  ``x`` is (M*a_sum, K) (the fold
    reads ``a_sum`` rows per output row), ``w`` (K, N).  Returns ``y`` and/or
    ``out = res + y`` as requested.  ``a_map`` / ``c_map`` are int32 row maps
    of a period L dividing M: A row m (and its LayerNorm) is read from x row
    ``(m // L) * L + a_map[m % L]``, and the residual row and the stored rows
    of y / out are ``(m // L) * L + c_map[m % L]``.  ``row_scale`` (f32) makes
    ``out = res + row_scale[m // scale_div] * y``; ``gelu_grad_of`` (M, N)
    multiplies the product by GELU'(gelu_grad_of), the GELU backward, and
    then also writes GELU(gelu_grad_of) into ``gelu_out`` when it is given."""
    k = x.shape[-1]
    m = x.numel() // k // a_sum
    n = w.shape[1]
    require(x, "x", x)
    require(w, "w", x, shape=(k, n))
    if bias is not None:
        require(bias, "bias", x, shape=(n,))
    ln_g = ln_b = None
    if ln is not None:
        ln_g, ln_b = ln
        require(ln_g, "ln scale", x, shape=(k,))
        require(ln_b, "ln bias", x, shape=(k,))
    map_len = 0
    for mp, name in ((a_map, "a_map"), (c_map, "c_map")):
        if mp is not None:
            require(mp, name, x, dtype=torch.int32)
            if map_len and mp.numel() != map_len:
                raise ValueError("a_map and c_map differ in length")
            map_len = mp.numel()
    if row_scale is not None:
        require(row_scale, "row scale", x, shape=(-(-m // scale_div),), dtype=torch.float32)
    act = ACT_GELU if gelu else ACT_NONE
    if gelu_grad_of is not None:
        require(gelu_grad_of, "gelu input", x, shape=(m, n))
        act = ACT_GELU_GRAD
    if gelu_out is not None:
        if gelu_grad_of is None:
            raise ValueError("gemm: gelu_out needs gelu_grad_of")
        require(gelu_out, "gelu output", x, shape=(m, n))
    if map_len and (m % map_len or a_sum > 1):
        raise ValueError(f"gemm: a row map of length {map_len} needs M={m} to be a "
                         f"multiple of it and no row fold")
    if m > _GRID_Y_MAX_ROWS:
        raise ValueError(f"gemm: {m} rows exceed the grid limit {_GRID_Y_MAX_ROWS}")
    if x.dtype == torch.bfloat16:  # the tensor-core loop's limits (csrc/gemm.cu)
        operands = (x, w, bias, ln_g, ln_b, res, gelu_grad_of, gelu_out)
        if (k % 8 or n % 8 or (ln is not None and k > _TC_MAX_LN_K)
                or any(t is not None and t.data_ptr() % 16 for t in operands)):
            raise ValueError(f"bf16 gemm takes K and N multiples of 8, LayerNorm rows of "
                             f"at most {_TC_MAX_LN_K} and 16-byte aligned operands; got "
                             f"K={k} N={n}")
    y = torch.empty((m, n), device=x.device, dtype=x.dtype) if want_y else None
    out = None
    if want_out:
        require(res, "res", x, shape=(m, n))
        out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    check(lib().mumpy_gemm(ptr(x), ptr(w), ptr(bias), ptr(ln_g), ptr(ln_b), ptr(res),
                           ptr(a_map), ptr(c_map), ptr(y), ptr(out), ptr(row_scale),
                           ptr(gelu_grad_of), ptr(gelu_out), m, n, k, a_sum, a_seg, act, map_len,
                           scale_div, dtype_code(x), stream_of(x)), "gemm")
    return y, out


def window_attention(q, k, v, *, r, n, heads, hd, q_mod, ldq, ldk, ldv,
                     q_off=0, k_off=0, v_off=0, mb=None, scale):
    """Launch the window-attention core (csrc/window_attention.cu) over ``r``
    windows of ``n`` tokens.  q/k/v are row-major token matrices with row
    strides ``ld*``; head 0 starts at column ``*_off``.  Returns o (r*n, heads*hd)."""
    if n > 64 or hd > 32:
        raise ValueError(f"window attention takes n <= 64 and hd <= 32, got n={n} hd={hd}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, q)
    p = 1
    if mb is not None:
        require(mb, "mask+bias", q, dtype=torch.float32)
        if mb.dim() != 4 or mb.shape[1:] != (heads, n, 64):
            raise ValueError(f"mask+bias must be (P, {heads}, {n}, 64), got {tuple(mb.shape)}")
        p = mb.shape[0]
        if r % p:
            raise ValueError(f"{r} windows are not a multiple of the mask period {p}")
    c = heads * hd
    o = torch.empty((r * n, c), device=q.device, dtype=q.dtype)
    esize = q.element_size()
    check(lib().mumpy_window_attention(
        ctypes.c_void_p(q.data_ptr() + q_off * esize),
        ctypes.c_void_p(k.data_ptr() + k_off * esize),
        ctypes.c_void_p(v.data_ptr() + v_off * esize),
        ptr(o), ptr(mb), r, n, heads, hd, q_mod, ldq, ldk, ldv, c, p, scale,
        dtype_code(q), stream_of(q)), "window_attention")
    return o


def packed_window_attention(qkv, mbp, *, r, n, heads):
    """The window-attention core on the packed (R*N, 3C) rows the qkv GEMM
    writes (q at column h*hd, k at C + h*hd, v at 2C + h*hd) with the padded
    (P, H, N, 64) f32 mask+bias ``mbp``.  Returns o (R*N, C)."""
    c = qkv.shape[-1] // 3
    hd = c // heads
    return window_attention(qkv, qkv, qkv, r=r, n=n, heads=heads, hd=hd, q_mod=r,
                            ldq=3 * c, ldk=3 * c, ldv=3 * c, q_off=0, k_off=c, v_off=2 * c,
                            mb=mbp, scale=hd**-0.5)


def cva_sample(x2, gy, gx, *, b1, n, groups, ws):
    """Launch the per-group bilinear sampler (csrc/cva_sample.cu)."""
    r, c = x2.shape[0] // n, x2.shape[-1]
    require(x2, "x2", x2)
    require(gy, "gy", x2, shape=(groups, b1, n), dtype=torch.float32)
    require(gx, "gx", x2, shape=(groups, b1, n), dtype=torch.float32)
    s = torch.empty_like(x2)
    check(lib().mumpy_cva_sample(ptr(x2), ptr(gy), ptr(gx), ptr(s), r, b1, n, c, groups,
                                 ws, dtype_code(x2), stream_of(x2)), "cva_sample")
    return s


def vit3_attention(qkv, *, heads):
    """Launch the n = 3 attention (csrc/vit3_attention.cu) on the time-major
    packed ``qkv`` (3, R, 3C).  Returns o (3, R, C)."""
    three, r, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    require(qkv, "qkv", qkv)
    if three != 3 or c3 % 3 or c % heads or hd > 128:
        raise ValueError(f"vit3 attention takes (3, R, 3C) with hd = C / heads <= 128, "
                         f"got {tuple(qkv.shape)} and {heads} heads")
    o = torch.empty((3, r, c), device=qkv.device, dtype=qkv.dtype)
    check(lib().mumpy_vit3_attention(ptr(qkv), ptr(o), r, heads, hd, hd**-0.5,
                                     dtype_code(qkv), stream_of(qkv)), "vit3_attention")
    return o


def window_attention_bwd(qkv, do, mb, *, r, n, heads, hd, scale, rowsum=True):
    """Launch the window-attention backward (csrc/window_attention_bwd.cu) on
    the packed (R*N, 3C) ``qkv`` of the forward, the head-output gradient
    ``do`` (R*N, C) and the forward's padded (P, H, N, 64) f32 mask+bias.
    Returns dqkv (R*N, 3C) and the mask+bias gradient (P, H, N, N) f32."""
    c = heads * hd
    if n > 64 or hd > 32:
        raise ValueError(f"window attention takes n <= 64 and hd <= 32, got n={n} hd={hd}")
    require(qkv, "qkv", qkv, shape=(r * n, 3 * c))
    require(do, "d(head outputs)", qkv, shape=(r * n, c))
    require(mb, "mask+bias", qkv, dtype=torch.float32)
    if mb.dim() != 4 or mb.shape[1:] != (heads, n, 64):
        raise ValueError(f"mask+bias must be (P, {heads}, {n}, 64), got {tuple(mb.shape)}")
    p = mb.shape[0]
    if r % p:
        raise ValueError(f"{r} windows are not a multiple of the mask period {p}")
    dqkv = torch.empty_like(qkv)
    dmb = torch.zeros((p, heads, n, n), device=qkv.device, dtype=torch.float32)
    # about 8 blocks per SM of an H100 (132 SMs), each summing its windows' dS
    chunks = max(1, min(r // p, -(-1056 // (heads * p))))
    check(lib().mumpy_window_attention_bwd(ptr(qkv), ptr(do), ptr(mb), ptr(dqkv), ptr(dmb),
                                           r, n, heads, hd, p, chunks, scale, int(rowsum),
                                           dtype_code(qkv), stream_of(qkv)),
          "window_attention_bwd")
    return dqkv, dmb


def ln_rows(x, g, b):
    """Launch the LayerNorm row kernel (csrc/train_rows.cu) on ``x`` (rows, C):
    returns h = LN(x) in x's dtype and the f32 row statistics mu, rstd."""
    rows, c = x.shape
    require(x, "x", x)
    require(g, "ln scale", x, shape=(c,))
    require(b, "ln bias", x, shape=(c,))
    h = torch.empty_like(x)
    mu = torch.empty(rows, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mu)
    check(lib().mumpy_ln_rows(ptr(x), ptr(g), ptr(b), ptr(h), ptr(mu), ptr(rstd), rows, c,
                              dtype_code(x), stream_of(x)), "ln_rows")
    return h, mu, rstd


def ln_bwd_rows(x, mu, rstd, g, dh, dres=None):
    """Launch the LayerNorm backward row kernel: dx = dres + LN'(x)^T dh."""
    rows, c = x.shape
    require(x, "x", x)
    for t, name in ((mu, "mu"), (rstd, "rstd")):
        require(t, name, x, shape=(rows,), dtype=torch.float32)
    require(g, "ln scale", x, shape=(c,))
    require(dh, "dh", x, shape=(rows, c))
    if dres is not None:
        require(dres, "dres", x, shape=(rows, c))
    dx = torch.empty_like(x)
    check(lib().mumpy_ln_bwd_rows(ptr(x), ptr(mu), ptr(rstd), ptr(g), ptr(dh), ptr(dres),
                                  ptr(dx), rows, c, dtype_code(x), stream_of(x)),
          "ln_bwd_rows")
    return dx


# about two blocks per SM of an H100 (132 SMs): the row splits of the
# weight-gradient sums aim for this many blocks
_SPLIT_BLOCKS = 264
_TN_TILE = {torch.bfloat16: 128, torch.float32: 64}  # dW tile edge (csrc/wgrad.cu)


def _rows_per_split(rows, blocks):
    """Rows per split: enough splits that ``blocks`` blocks per split fill
    about _SPLIT_BLOCKS, each split at least 256 rows."""
    return -(-rows // max(1, min(-(-_SPLIT_BLOCKS // blocks), rows // 256)))


def _reduce_splits(ws, splits, out1, out2):
    check(lib().mumpy_reduce_splits(ptr(ws), splits, out1.numel(), ptr(out1), out2.numel(),
                                    ptr(out2), dtype_code(out1), stream_of(out1)),
          "reduce_splits")


def weight_grads(d, a):
    """The weight and bias gradients of a Linear layer from its output
    gradient ``d`` (M, O) and its input ``a`` (M, I), in their dtype with f32
    accumulation (csrc/wgrad.cu): ``(d^T a, d.sum(0))``, the first in torch
    Linear's (O, I) layout.  Many rows are split over blocks, and the f32
    partials summed in split order by a second launch."""
    rows, o = d.shape
    i = a.shape[1]
    require(d, "output gradient", d)
    require(a, "layer input", d, shape=(rows, i))
    if d.dtype == torch.bfloat16 and (o % 8 or i % 8):
        raise ValueError(f"bf16 weight gradients take widths that are multiples of 8, got "
                         f"{o} and {i}")
    tile = _TN_TILE[d.dtype]
    per = _rows_per_split(rows, -(-o // tile) * -(-i // tile))
    n_splits = -(-rows // per)
    dw = torch.empty((o, i), device=d.device, dtype=d.dtype)
    db = torch.empty(o, device=d.device, dtype=d.dtype)
    ws = None
    if n_splits > 1:
        ws = torch.empty((n_splits, o * i + o), device=d.device, dtype=torch.float32)
    check(lib().mumpy_gemm_tn(ptr(d), ptr(a), ptr(ws), ptr(dw), ptr(db), rows, o, i, per,
                              dtype_code(d), stream_of(d)), "gemm_tn")
    if ws is not None:
        _reduce_splits(ws, n_splits, dw, db)
    return dw, db


def ln_param_grads(x, mu, rstd, g, dh):
    """The LayerNorm scale and bias gradients, in ``g``'s dtype, from its
    input ``x``, the f32 row statistics :func:`ln_rows` returns and the
    output gradient ``dh``: the column sums of dh * xhat and of dh
    (csrc/wgrad.cu, rows split over blocks as in :func:`weight_grads`)."""
    rows, c = x.shape
    require(x, "x", x)
    require(dh, "dh", x, shape=(rows, c))
    for t, name in ((mu, "mu"), (rstd, "rstd")):
        require(t, name, x, shape=(rows,), dtype=torch.float32)
    require(g, "ln scale", x, shape=(c,))
    per = _rows_per_split(rows, -(-c // 32))
    n_splits = -(-rows // per)
    dg, db = torch.empty_like(g), torch.empty_like(g)
    ws = None
    if n_splits > 1:
        ws = torch.empty((n_splits, 2 * c), device=x.device, dtype=torch.float32)
    check(lib().mumpy_col_sums(ptr(dh), ptr(x), ptr(mu), ptr(rstd), ptr(ws), ptr(dg), ptr(db),
                               rows, c, per, dtype_code(x), stream_of(x)), "col_sums")
    if ws is not None:
        _reduce_splits(ws, n_splits, dg, db)
    return dg, db


def scale_add_rows(a, b, s, div=1):
    """Launch the row scale-add kernel: out = a + s[row // div] * b (a may be
    None); ``s`` is f32."""
    rows, c = b.shape
    require(b, "b", b)
    if a is not None:
        require(a, "a", b, shape=(rows, c))
    require(s, "row scale", b, shape=(-(-rows // div),), dtype=torch.float32)
    out = torch.empty_like(b)
    check(lib().mumpy_scale_add_rows(ptr(a), ptr(b), ptr(s), ptr(out), rows, c, div,
                                     dtype_code(b), stream_of(b)), "scale_add_rows")
    return out
