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
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_LIB_LOCK = threading.Lock()
build_seconds = None  # wall time of the nvcc run, or 0.0 when the cache hit
build_log = ""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mumpy_gemm": [_P] * 13 + [_I] * 9 + [_P],
    "mumpy_gemm_tn": [_P] * 5 + [_I] * 5 + [_P],
    "mumpy_gemm_sm90": [_P] * 9 + [_I] * 7 + [_P],
    "mumpy_gemm_rows": [_P] * 11 + [_I] * 8 + [_P],
    "mumpy_gemm_sm90_tn": [_P] * 5 + [_I] * 4 + [_P],
    "mumpy_col_sums": [_P] * 7 + [_I] * 4 + [_P],
    "mumpy_reduce_splits": [_P, _I, _P, _P, _P],
    "mumpy_window_attention": [_P] * 5 + [_I] * 15 + [_F, _I, _P],
    "mumpy_cva_sample": [_P] * 4 + [_I] * 8 + [_P],
    "mumpy_window_attention_fold": [_P] * 4 + [_I] * 11 + [_F, _I, _P],
    "mumpy_vit3_qkv_attn": [_P] * 4 + [_I] * 3 + [_P],
    "mumpy_vit3_scratch": [_I] * 4,
    "mumpy_vit3_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "mumpy_cva_rows": [_P] * 10 + [_I] * 10 + [_P],
    "mumpy_cva_scratch": [_I] * 7,
    "mumpy_cva_fwd": [_P] * 7 + [_I] * 10 + [_P],
    "mumpy_vit3_attention": [_P] * 2 + [_I] * 3 + [_F, _I, _P],
    "mumpy_window_attention_bwd": [_P] * 6 + [_I] * 11 + [_F, _I, _I, _P],
    "mumpy_ln_rows": [_P] * 6 + [_I] * 4 + [_P],
    "mumpy_swin_block_train_scratch": [_I] * 7,
    "mumpy_swin_block_train_fwd": [_P] * 2 + [_I] * 5 + [_P] * 5 + [_I] * 6 + [_P],
    "mumpy_swin_block_train_bwd": [_P] * 3 + [_I] * 5 + [_P] * 7 + [_I] * 9 + [_P],
    "mumpy_ln_bwd_rows": [_P] * 7 + [_I] * 3 + [_P],
    "mumpy_scale_add_rows": [_P] * 4 + [_I] * 4 + [_P],
    "mumpy_swin_blocks_scratch": [_I] * 5,
    "mumpy_swin_blocks_fwd": [_P, _I, _P, _P, _P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    "mumpy_mlp_rows": [_P] * 8 + [_I] * 5 + [_P],
    "mumpy_attn_rows": [_P] * 8 + [_I] * 6 + [_P] * 2 + [_I] * 6 + [_P],
    "mumpy_attn_ln_scratch": [_I] * 4,
    "mumpy_attn_ln_fwd": [_P] * 3 + [_I] * 6 + [_P] * 3 + [_I] * 6 + [_P],
    "mumpy_ln_mlp_scratch": [_I] * 3,
    "mumpy_ln_mlp_fwd": [_P] * 4 + [_I] * 5 + [_P],
    "mumpy_attn_ln_train_scratch": [_I] * 6,
    "mumpy_attn_ln_train_fwd": [_P] * 2 + [_I] * 5 + [_P] * 5 + [_I] * 5 + [_P],
    "mumpy_attn_ln_train_bwd": [_P] * 4 + [_I] * 5 + [_P] * 6 + [_I] * 6 + [_P],
    "mumpy_ln_mlp_train_scratch": [_I] * 4,
    "mumpy_ln_mlp_train_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "mumpy_ln_mlp_train_bwd": [_P] * 7 + [_I] * 5 + [_P],
}
_LONG_RESULTS = ("mumpy_swin_block_train_scratch", "mumpy_swin_blocks_scratch",
                 "mumpy_ln_mlp_train_scratch", "mumpy_attn_ln_train_scratch",
                 "mumpy_attn_ln_scratch", "mumpy_ln_mlp_scratch", "mumpy_vit3_scratch",
                 "mumpy_cva_scratch")


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
    """The loaded kernel library, built on first call (once, whichever
    thread calls first)."""
    global _lib
    if _lib is not None:
        return _lib
    with _LIB_LOCK:
        if _lib is None:
            handle = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name in _LONG_RESULTS:
                getattr(handle, name).restype = ctypes.c_longlong
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


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the int ctypes passes
    (``torch.cuda.current_stream(t.device).cuda_stream`` without building a
    ``Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t):
    """Device pointer of a tensor as an int (None -> NULL)."""
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, like: torch.Tensor, shape=None,
            dtype=None) -> None:
    """Check that ``t`` is a contiguous tensor on ``like``'s CUDA device with
    the given dtype (default ``like.dtype``) and shape."""
    if (t.dtype == (like.dtype if dtype is None else dtype) and t.is_contiguous()
            and (shape is None or t.shape == shape) and t.get_device() == like.get_device()):
        return  # the launch path: one test, then the reasons below
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

_GRID_Y_MAX_ROWS = 65535 * 64  # csrc/gemm.cu's grid.y limit times its 64-row tile


ACT_NONE, ACT_GELU, ACT_GELU_GRAD = 0, 1, 2  # the GEMM epilogue's activation (csrc/gemm.cu)


def gemm(x, w, bias=None, ln=None, res=None, want_y=True, want_out=False,
         gelu=False, a_sum=1, a_seg=1, a_map=None, c_map=None, row_scale=None,
         scale_div=1, gelu_grad_of=None, gelu_out=None, ln_stats_on=True):
    """The serving kernels' GEMM: bf16 on the persistent wgmma GEMM
    (:func:`gemm_sm90`), f32 on the tiled GEMM (csrc/gemm.cu), whose
    prologue alone takes the row fold (f32 only).  ``x`` is (M*a_sum, K)
    (the fold reads ``a_sum`` rows per output row), ``w`` (K, N).  Returns ``y``
    and/or ``out = res + y`` as requested.  ``a_map`` / ``c_map`` are int32
    row maps of a period L dividing M: A row m (and its LayerNorm) is read
    from x row ``(m // L) * L + a_map[m % L]``, and the residual row and the
    stored rows of y / out are ``(m // L) * L + c_map[m % L]``.
    ``row_scale`` (f32) makes ``out = res + row_scale[m // scale_div] * y``;
    ``gelu_grad_of`` (M, N) multiplies the product by GELU'(gelu_grad_of),
    the GELU backward, and then also writes GELU(gelu_grad_of) into
    ``gelu_out`` when it is given.  ``ln_stats_on=False`` (bf16) plants the
    checks' fault: the LayerNorm with mean 0 and rstd 1."""
    if x.dtype == torch.bfloat16:
        if a_sum > 1:
            raise ValueError("the row fold is f32 only: bf16 folds in the attention core "
                             "(window_attention_fold)")
        return gemm_sm90(x, w, bias, res=res, want_y=want_y, want_out=want_out, gelu=gelu,
                         row_scale=row_scale, scale_div=scale_div, gelu_grad_of=gelu_grad_of,
                         gelu_out=gelu_out, ln=ln, a_map=a_map, c_map=c_map,
                         ln_stats_on=ln_stats_on)
    if not ln_stats_on:
        raise ValueError("the LayerNorm-statistics fault is planted on the bf16 GEMM only")
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
    map_len = _map_len(x, m, a_map, c_map)
    if map_len and a_sum > 1:
        raise ValueError("gemm: a row map takes no row fold")
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
    if m > _GRID_Y_MAX_ROWS:
        raise ValueError(f"gemm: {m} rows exceed the grid limit {_GRID_Y_MAX_ROWS}")
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


def _map_len(x, m, a_map, c_map):
    """The period of the row maps (0 without one): int32 on x's device, of
    one length, dividing the M rows."""
    map_len = 0
    for mp, name in ((a_map, "a_map"), (c_map, "c_map")):
        if mp is not None:
            require(mp, name, x, dtype=torch.int32)
            if map_len and mp.numel() != map_len:
                raise ValueError("a_map and c_map differ in length")
            map_len = mp.numel()
    if map_len and m % map_len:
        raise ValueError(f"gemm: a row map of length {map_len} needs M={m} to be a "
                         f"multiple of it")
    return map_len


def gemm_sm90(x, w, bias=None, res=None, want_y=True, want_out=False, gelu=False,
              row_scale=None, scale_div=1, gelu_grad_of=None, gelu_out=None,
              row_scale_on=True, ln=None, a_map=None, c_map=None, ln_stats_on=True):
    """Launch the bf16 persistent wgmma GEMM (csrc/gemm_sm90.cu): ``x`` (M, K)
    @ ``w`` (K, N) with :func:`gemm`'s LayerNorm prologue (``ln`` = (scale,
    bias): the normalised rows written once by :func:`ln_rows` first, then
    gathered by the GEMM), row maps and epilogues (bias, GELU, the GELU backward with ``gelu_grad_of``
    / ``gelu_out``, ``out = res + y`` or, with ``row_scale``, ``res +
    row_scale[m // scale_div] * y``).  ``w`` is contiguous or the transpose of
    a contiguous (N, K) tensor (a torch Linear weight's ``.t()``, read as
    stored).  ``row_scale_on=False`` ignores the row scale and
    ``ln_stats_on=False`` the LayerNorm statistics (mean 0, rstd 1): the
    planted faults of the checks.  Returns ``y`` and/or ``out`` as requested."""
    k = x.shape[-1]
    m = x.numel() // k
    n = w.shape[1]
    require(x, "x", x, dtype=torch.bfloat16)
    b_kmajor = not w.is_contiguous()
    require(w.t() if b_kmajor else w, "w", x, shape=(n, k) if b_kmajor else (k, n))
    if bias is not None:
        require(bias, "bias", x, shape=(n,))
    if row_scale is not None:
        require(row_scale, "row scale", x, shape=(-(-m // scale_div),), dtype=torch.float32)
    act = ACT_GELU if gelu else ACT_NONE
    if gelu_grad_of is not None:
        require(gelu_grad_of, "gelu input", x, shape=(m, n))
        act = ACT_GELU_GRAD
    if gelu_out is not None:
        if gelu_grad_of is None:
            raise ValueError("gemm_sm90: gelu_out needs gelu_grad_of")
        require(gelu_out, "gelu output", x, shape=(m, n))
    ln_g = ln_b = None
    if ln is not None:
        ln_g, ln_b = ln
        require(ln_g, "ln scale", x, shape=(k,))
        require(ln_b, "ln bias", x, shape=(k,))
    map_len = _map_len(x, m, a_map, c_map)
    out = None
    if want_out:
        require(res, "res", x, shape=(m, n))
        out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    y = torch.empty((m, n), device=x.device, dtype=x.dtype) if want_y else None
    vectors = (x, w, bias, res, gelu_grad_of, y, out, gelu_out)  # moved 16 bytes at a time
    if k % 8 or n % 8 or any(t is not None and t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"gemm_sm90 takes K and N multiples of 8 and 16-byte aligned "
                         f"operands; got K={k} N={n}")
    if ln is not None:
        x = ln_rows(x.reshape(m, k), ln_g, ln_b, stats_on=ln_stats_on)[0]
    if not map_len:  # the training kernels' entry point
        check(lib().mumpy_gemm_sm90(ptr(x), ptr(w), ptr(bias), ptr(res), ptr(row_scale),
                                    ptr(gelu_grad_of), ptr(y), ptr(out), ptr(gelu_out), m, n, k,
                                    int(b_kmajor), act, scale_div, int(row_scale_on),
                                    stream_of(x)), "gemm_sm90")
        return y, out
    check(lib().mumpy_gemm_rows(ptr(x), ptr(w), ptr(bias), ptr(res), ptr(row_scale),
                                ptr(gelu_grad_of), ptr(y), ptr(out), ptr(gelu_out), ptr(a_map),
                                ptr(c_map), map_len, m, n, k, int(b_kmajor), act, scale_div,
                                int(row_scale_on), stream_of(x)), "gemm_rows")
    return y, out


def train_gemm(x, w, bias=None, ln=None, row_scale_on=True, **epilogue):
    """The training kernels' products: bf16 on the wgmma GEMM
    (:func:`gemm_sm90`, a LayerNorm prologue run first by :func:`ln_rows`),
    f32 on :func:`gemm`'s SIMT loop.  Arguments as :func:`gemm`'s."""
    if x.dtype == torch.bfloat16:
        if ln is not None:
            x = ln_rows(x, *ln)[0]
        return gemm_sm90(x, w, bias, row_scale_on=row_scale_on, **epilogue)
    if not row_scale_on:
        raise ValueError("the row-scale fault is planted on the bf16 path only")
    return gemm(x, w, bias, ln=ln, **epilogue)


def _mask_period(mb, like, r, n, heads):
    """Check the (P, H, N, N) f32 or bf16 mask+bias ``mb`` (any strides: the
    kernels read it through them); return P."""
    if mb.device != like.device or mb.dtype not in DTYPE_CODES:
        raise ValueError(f"mask+bias must be a float32 or bfloat16 tensor on {like.device}, "
                         f"got {mb.dtype} on {mb.device}")
    if mb.dim() != 4 or mb.shape[1:] != (heads, n, n):
        raise ValueError(f"mask+bias must be (P, {heads}, {n}, {n}), got {tuple(mb.shape)}")
    if r % mb.shape[0]:
        raise ValueError(f"{r} windows are not a multiple of the mask period {mb.shape[0]}")
    return mb.shape[0]


def window_attention(q, k, v, *, r, n, heads, hd, q_mod, ldq, ldk, ldv,
                     q_off=0, k_off=0, v_off=0, mb=None, scale):
    """Launch the window-attention core (csrc/window_attention.cu) over ``r``
    windows of ``n`` tokens.  q/k/v are row-major token matrices with row
    strides ``ld*``; head 0 starts at column ``*_off``; ``mb`` is the
    (P, H, N, N) additive term (f32 or bf16, any strides) or None.  Returns o
    (r*n, heads*hd)."""
    if n > 64 or hd > 32:
        raise ValueError(f"window attention takes n <= 64 and hd <= 32, got n={n} hd={hd}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, q)
    p = 1 if mb is None else _mask_period(mb, q, r, n, heads)
    c = heads * hd
    o = torch.empty((r * n, c), device=q.device, dtype=q.dtype)
    esize = q.element_size()
    check(lib().mumpy_window_attention(
        q.data_ptr() + q_off * esize, k.data_ptr() + k_off * esize,
        v.data_ptr() + v_off * esize,
        ptr(o), ptr(mb), r, n, heads, hd, q_mod, ldq, ldk, ldv, c, p,
        *((0, 0, 0, 0, 0) if mb is None else (dtype_code(mb), *mb.stride())), scale,
        dtype_code(q), stream_of(q)), "window_attention")
    return o


def packed_window_attention(qkv, mb, *, r, n, heads):
    """The window-attention core on the packed (R*N, 3C) rows the qkv GEMM
    writes (q at column h*hd, k at C + h*hd, v at 2C + h*hd) with the
    (P, H, N, N) mask+bias ``mb``.  Returns o (R*N, C)."""
    c = qkv.shape[-1] // 3
    hd = c // heads
    return window_attention(qkv, qkv, qkv, r=r, n=n, heads=heads, hd=hd, q_mod=r,
                            ldq=3 * c, ldk=3 * c, ldv=3 * c, q_off=0, k_off=c, v_off=2 * c,
                            mb=mb, scale=hd**-0.5)


def window_attention_fold(q, kv, *, r, n, heads, q_mod, fold, fold_on=True):
    """The window-attention core of the CVA (csrc/window_attention.cu,
    ``mumpy_window_attention_fold``): no additive term, window w's queries
    from ``q`` window ``w % q_mod`` (rows of C), keys and values from the
    packed k|v rows ``kv`` (r*n, 2C), and each run of ``fold`` consecutive
    windows summed.  Returns o (r / fold * n, C); ``fold_on=False`` keeps
    each run's first window, the checks' planted fault."""
    c = kv.shape[-1] // 2
    hd = c // heads
    require(q, "q", kv, shape=(q_mod * n, c))
    require(kv, "k|v", kv, shape=(r * n, 2 * c))
    if n > 64 or hd > 32 or r % fold:
        raise ValueError(f"the folding core takes n <= 64, hd <= 32 and whole runs of "
                         f"{fold} windows; got n={n} hd={hd} r={r}")
    o = torch.empty((r // fold * n, c), device=kv.device, dtype=kv.dtype)
    check(lib().mumpy_window_attention_fold(
        ptr(q), ptr(kv), kv.data_ptr() + c * kv.element_size(), ptr(o), r, n, heads, hd, q_mod,
        c, 2 * c, 2 * c, c, fold, int(fold_on), hd**-0.5, dtype_code(kv), stream_of(kv)),
        "window_attention_fold")
    return o


def cva_sample(x2, gy, gx, *, b1, n, groups, ws, sample_on=True):
    """Launch the per-group bilinear sampler (csrc/cva_sample.cu);
    ``sample_on=False`` plants the checks' fault (one tap at the floor of
    each coordinate, weight 1)."""
    r, c = x2.shape[0] // n, x2.shape[-1]
    require(x2, "x2", x2)
    require(gy, "gy", x2, shape=(groups, b1, n), dtype=torch.float32)
    require(gx, "gx", x2, shape=(groups, b1, n), dtype=torch.float32)
    s = torch.empty_like(x2)
    check(lib().mumpy_cva_sample(ptr(x2), ptr(gy), ptr(gx), ptr(s), r, b1, n, c, groups,
                                 ws, int(sample_on), dtype_code(x2), stream_of(x2)), "cva_sample")
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


def window_attention_bwd(qkv, do, mb, *, r, n, heads, hd, scale, rowsum=True, want_o=False):
    """Launch the window-attention backward (csrc/window_attention_bwd.cu) on
    the packed (R*N, 3C) ``qkv`` of the forward, the head-output gradient
    ``do`` (R*N, C) and the forward's (P, H, N, N) mask+bias (f32 or bf16,
    any strides).
    Returns dqkv (R*N, 3C) and the mask+bias gradient (P, H, N, N) f32, and
    with ``want_o`` also the forward's head outputs o (R*N, C), formed from
    the backward's own softmax."""
    c = heads * hd
    if n > 64 or hd > 32:
        raise ValueError(f"window attention takes n <= 64 and hd <= 32, got n={n} hd={hd}")
    require(qkv, "qkv", qkv, shape=(r * n, 3 * c))
    require(do, "d(head outputs)", qkv, shape=(r * n, c))
    p = _mask_period(mb, qkv, r, n, heads)
    dqkv = torch.empty_like(qkv)
    o = torch.empty_like(do) if want_o else None
    dmb = torch.zeros((p, heads, n, n), device=qkv.device, dtype=torch.float32)
    # about 8 blocks per SM of an H100 (132 SMs), each summing its windows' dS
    chunks = max(1, min(r // p, -(-1056 // (heads * p))))
    check(lib().mumpy_window_attention_bwd(ptr(qkv), ptr(do), ptr(mb), ptr(dqkv), ptr(o),
                                           ptr(dmb), r, n, heads, hd, p, dtype_code(mb),
                                           *mb.stride(), chunks, scale, int(rowsum),
                                           dtype_code(qkv), stream_of(qkv)),
          "window_attention_bwd")
    return (dqkv, dmb, o) if want_o else (dqkv, dmb)


def ln_rows(x, g, b, stats_on=True):
    """Launch the LayerNorm row kernel (csrc/train_rows.cu) on ``x`` (rows, C):
    returns h = LN(x) in x's dtype and the f32 row statistics mu, rstd.
    ``stats_on=False`` plants the checks' fault: mean 0 and rstd 1."""
    rows, c = x.shape
    require(x, "x", x)
    require(g, "ln scale", x, shape=(c,))
    require(b, "ln bias", x, shape=(c,))
    h = torch.empty_like(x)
    mu, rstd = torch.empty((2, rows), device=x.device, dtype=torch.float32)
    check(lib().mumpy_ln_rows(ptr(x), ptr(g), ptr(b), ptr(h), ptr(mu), ptr(rstd), rows, c,
                              int(stats_on), dtype_code(x), stream_of(x)), "ln_rows")
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
_MAX_SUMS = 8  # kMaxSums: workspaces one reduce_splits launch adds (csrc/wgrad.cu)
# dW tile (rows, columns): csrc/gemm_sm90.cu's TN form (bf16), csrc/wgrad.cu's gemm_tn (f32)
_TN_TILE = {torch.bfloat16: (64, 128), torch.float32: (64, 64)}


def _rows_per_split(rows, blocks):
    """Rows per split: enough splits that ``blocks`` blocks per split fill
    about _SPLIT_BLOCKS, each split at least 256 rows."""
    return -(-rows // max(1, min(-(-_SPLIT_BLOCKS // blocks), rows // 256)))


def grad_sums(*terms):
    """Weight, bias and LayerNorm-parameter gradients in their inputs' dtype
    with f32 accumulation, one pair per term: ``(d, a)``, a Linear layer's
    output gradient (M, O) and input (M, I), gives ``(d^T a, d.sum(0))``, the
    first in torch Linear's (O, I) layout (bf16: csrc/gemm_sm90.cu's TN form;
    f32: csrc/wgrad.cu's gemm_tn); ``(x, mu, rstd, g, dh)``, a LayerNorm's
    input, the f32 row statistics :func:`ln_rows` returns, its scale and
    output gradient, gives the column sums of dh * xhat and of dh
    (csrc/wgrad.cu's col_sums).  Many rows are split over blocks: every
    split writes f32 partials into one shared workspace, and one launch of
    reduce_splits adds each term's partials in split order, so the result
    does not depend on the schedule."""
    if not 0 < len(terms) <= _MAX_SUMS:
        raise ValueError(f"grad_sums takes 1 to {_MAX_SUMS} terms, got {len(terms)}")
    plans, total = [], 0
    for term in terms:
        if len(term) == 2:
            d, a = term
            rows, o = d.shape
            i = a.shape[1]
            require(d, "output gradient", d)
            require(a, "layer input", d, shape=(rows, i))
            if d.dtype == torch.bfloat16 and (o % 8 or i % 8):
                raise ValueError(f"bf16 weight gradients take widths that are multiples of 8, "
                                 f"got {o} and {i}")
            to, ti = _TN_TILE[d.dtype]
            per = _rows_per_split(rows, -(-o // to) * -(-i // ti))
            outs = (torch.empty((o, i), device=d.device, dtype=d.dtype),
                    torch.empty(o, device=d.device, dtype=d.dtype))
        else:
            x, mu, rstd, g, dh = term
            rows, c = x.shape
            require(x, "x", x)
            require(dh, "dh", x, shape=(rows, c))
            require(mu, "mu", x, shape=(rows,), dtype=torch.float32)
            require(rstd, "rstd", x, shape=(rows,), dtype=torch.float32)
            require(g, "ln scale", x, shape=(c,))
            per = _rows_per_split(rows, -(-c // 32))
            outs = (torch.empty_like(g), torch.empty_like(g))
        splits = -(-rows // per)
        size = outs[0].numel() + outs[1].numel()
        plans.append((term, rows, per, splits, size, outs, total))
        if splits > 1:
            total += -(-splits * size // 4) * 4  # 16-byte aligned slices
    first = plans[0][5][0]
    ws = None if total == 0 else torch.empty(total, device=first.device, dtype=torch.float32)
    desc, out_ptrs = [], []
    for term, rows, per, splits, size, (o1, o2), off in plans:
        wsp = None if splits == 1 else ws.data_ptr() + 4 * off
        if len(term) == 2:
            d, a = term
            if d.dtype == torch.bfloat16:  # the TN form of the wgmma GEMM
                check(lib().mumpy_gemm_sm90_tn(d.data_ptr(), a.data_ptr(), wsp, o1.data_ptr(),
                                               o2.data_ptr(), rows, d.shape[1], a.shape[1], per,
                                               stream_of(d)), "gemm_sm90_tn")
            else:
                check(lib().mumpy_gemm_tn(d.data_ptr(), a.data_ptr(), wsp, o1.data_ptr(),
                                          o2.data_ptr(), rows, d.shape[1], a.shape[1], per,
                                          dtype_code(d), stream_of(d)), "gemm_tn")
        else:
            x, mu, rstd, g, dh = term
            check(lib().mumpy_col_sums(dh.data_ptr(), x.data_ptr(), mu.data_ptr(),
                                       rstd.data_ptr(), wsp, o1.data_ptr(), o2.data_ptr(), rows,
                                       x.shape[1], per, dtype_code(x), stream_of(x)),
                  "col_sums")
        if splits > 1:
            desc += [off, splits, o1.numel(), o2.numel(), dtype_code(o1)]
            out_ptrs += [o1.data_ptr(), o2.data_ptr()]
    if desc:
        check(lib().mumpy_reduce_splits(ws.data_ptr(), len(desc) // 5,
                                        (ctypes.c_longlong * len(desc))(*desc),
                                        (ctypes.c_void_p * len(out_ptrs))(*out_ptrs),
                                        stream_of(first)), "reduce_splits")
    return [o for plan in plans for o in plan[5]]


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


_BLOCK_WEIGHTS = 12  # ops/swin_block_train.py:_WEIGHTS


def _block_operands(x, mb, keep1, keep2, weights, heads):
    """Check the bf16 operands of the block's launch sequences; return
    (R, N, C, hidden, P)."""
    r, n, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    if len(weights) != _BLOCK_WEIGHTS:
        raise ValueError(f"the block takes {_BLOCK_WEIGHTS} weights, got {len(weights)}")
    hidden = weights[8].shape[0]
    shapes = ((c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,), (c,), (c,), (hidden, c),
              (hidden,), (c, hidden), (c,))
    for i, (w, shape) in enumerate(zip(weights, shapes)):
        require(w, f"weight {i}", x, shape=shape)
    for k, name in ((keep1, "keep1"), (keep2, "keep2")):
        require(k, name, x, shape=(r,), dtype=torch.float32)
    if n > 64 or c % heads or c // heads > 32 or c % 8 or hidden % 8:
        raise ValueError(f"the block's launch sequence takes n <= 64, a head width of at "
                         f"most 32 and widths that are multiples of 8; got n={n} C={c} "
                         f"heads={heads} hidden={hidden}")
    return r, n, c, hidden, _mask_period(mb, x, r, n, heads)


def _scratch(x, dims, heads, backward):
    r, n, c, hidden, p = dims
    nbytes = lib().mumpy_swin_block_train_scratch(r, n, c, hidden, heads, p, int(backward))
    return torch.empty(nbytes, device=x.device, dtype=torch.uint8)


def swin_block_train_fwd(x, mb, keep1, keep2, weights, heads):
    """bf16: the whole-block training kernel's forward launches in one call
    (csrc/swin_block_train.cu).  ``x`` (R, N, C), ``mb`` (P, H, N, N) f32 or
    bf16 (any strides), ``keep1`` / ``keep2`` (R,) f32 per window,
    ``weights`` the 12 tensors of ``swin_block_train._WEIGHTS`` as torch
    stores them.  Returns y (R, N, C)."""
    dims = _block_operands(x, mb, keep1, keep2, weights, heads)
    scratch = _scratch(x, dims, heads, backward=False)
    y = torch.empty_like(x)
    r, n, c, hidden, p = dims
    check(lib().mumpy_swin_block_train_fwd(
        x.data_ptr(), mb.data_ptr(), dtype_code(mb), *mb.stride(), keep1.data_ptr(),
        keep2.data_ptr(), (ctypes.c_void_p * _BLOCK_WEIGHTS)(*(w.data_ptr() for w in weights)),
        y.data_ptr(), scratch.data_ptr(), r, n, c, hidden, heads, p, stream_of(x)),
        "swin_block_train_fwd")
    return y


def swin_block_train_bwd(x, mb, keep1, keep2, weights, heads, dy, rowsum=True,
                         gelu_grad=True, row_scale=True):
    """bf16: the whole-block training kernel's backward launches in one call
    (csrc/swin_block_train.cu), operands as :func:`swin_block_train_fwd`'s
    and the output gradient ``dy`` (R, N, C).  Returns dx, d(mb) (P, H, N, N)
    in mb's dtype and the 12 weights' gradients; ``rowsum``, ``gelu_grad``
    and ``row_scale`` False plant the checks' faults."""
    dims = _block_operands(x, mb, keep1, keep2, weights, heads)
    dy = dy.contiguous()
    require(dy, "dy", x, shape=x.shape)
    r, n, c, hidden, p = dims
    scratch = _scratch(x, dims, heads, backward=True)
    dx = torch.empty_like(x)
    dmb = torch.empty((p, heads, n, n), device=x.device, dtype=mb.dtype)
    grads = [torch.empty_like(w) for w in weights]
    ptrs = ctypes.c_void_p * _BLOCK_WEIGHTS
    check(lib().mumpy_swin_block_train_bwd(
        x.data_ptr(), dy.data_ptr(), mb.data_ptr(), dtype_code(mb), *mb.stride(),
        keep1.data_ptr(), keep2.data_ptr(), ptrs(*(w.data_ptr() for w in weights)),
        dx.data_ptr(), dmb.data_ptr(), ptrs(*(g.data_ptr() for g in grads)),
        scratch.data_ptr(), r, n, c, hidden, heads, p, int(rowsum), int(gelu_grad),
        int(row_scale), stream_of(x)), "swin_block_train_bwd")
    return (dx, dmb, *grads)



_SERVING_BLOCK = ("ln_g", "ln_b", "w_qkv", "b_qkv", "w_proj", "b_proj")  # attn, then mlp's
_SERVING_MLP = ("ln_g", "ln_b", "w1", "b1", "w2", "b2")


def swin_blocks_fwd(x, blocks, row_map=None, ln_stats_on=True, gelu_on=True):
    """bf16: one or two serving Swin blocks in turn, launched in one call
    (csrc/swin_pair.cu; a block's MLP half on :func:`mlp_rows` where
    :func:`fused_mlp` takes its widths).  ``x`` (R, N, C); ``blocks`` the
    blocks' ``swin_block`` operands (weights (in, out), the (P, H, N, N)
    mask+bias); ``row_map`` (int32, the period of one image) the first
    block's row map, as :func:`gemm`'s ``a_map`` for its qkv product and
    ``c_map`` for its projection.  ``ln_stats_on=False`` and
    ``gelu_on=False`` plant the checks' faults (every LayerNorm with mean 0
    and rstd 1; the fused MLP without its GELU).  Returns y (R, N, C)."""
    r, n, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    weights, masks, desc = [], [], []
    heads = blocks[0]["attn"]["heads"]
    hidden = blocks[0]["mlp"]["w1"].shape[1]
    for ops in blocks:
        a, m = ops["attn"], ops["mlp"]
        shapes = ((c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,),
                  (c,), (c,), (c, hidden), (hidden,), (hidden, c), (c,))
        ws = [a[k] for k in _SERVING_BLOCK] + [m[k] for k in _SERVING_MLP]
        for i, (w, shape) in enumerate(zip(ws, shapes)):
            require(w, f"weight {i}", x, shape=shape)
        if a["heads"] != heads:
            raise ValueError("the blocks of one call take one head count")
        weights += ws
        masks.append(a["mb"])
        desc += [dtype_code(a["mb"]), *a["mb"].stride(), _mask_period(a["mb"], x, r, n, heads)]
    map_len = 0
    if row_map is not None:
        require(row_map, "row map", x, dtype=torch.int32)
        map_len = row_map.numel()
        if (r * n) % map_len:
            raise ValueError(f"{r * n} rows are not whole periods of the row map ({map_len})")
    if n > 64 or c % heads or c // heads > 32 or c % 8 or hidden % 8:
        raise ValueError(f"the serving block sequence takes n <= 64, a head width of at most "
                         f"32 and widths that are multiples of 8; got n={n} C={c} "
                         f"heads={heads} hidden={hidden}")
    nbytes = lib().mumpy_swin_blocks_scratch(r, n, c, hidden, len(blocks))
    scratch = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    y = torch.empty_like(x)
    check(lib().mumpy_swin_blocks_fwd(
        x.data_ptr(), len(blocks), (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights)),
        (ctypes.c_void_p * len(masks))(*(mb.data_ptr() for mb in masks)),
        (ctypes.c_int * len(desc))(*desc), ptr(row_map), map_len, y.data_ptr(),
        scratch.data_ptr(), r, n, c, hidden, heads, int(ln_stats_on), int(gelu_on),
        stream_of(x)), "swin_blocks_fwd")
    return y


def fused_mlp(c, hidden):
    """Whether a serving block's bf16 MLP half of width ``c`` runs on the
    fused kernel (csrc/mlp_sm90.cu; csrc/swin_pair.cu's ``fused_mlp``)."""
    return c <= 256 and c % 16 == 0 and hidden % 8 == 0


def mlp_rows(x, ops, ln_stats_on=True, gelu_on=True):
    """bf16: the fused MLP half of a serving block (csrc/mlp_sm90.cu), ``x +
    fc2(gelu(fc1(LN x)))`` on ``x`` (M, C) with ``ops`` the ``ln_mlp``
    operands (weights (in, out)), the 4C hidden never in device memory.
    ``ln_stats_on=False`` and ``gelu_on=False`` plant the checks' faults."""
    m, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    hidden = ops["w1"].shape[1]
    for k, shape in (("ln_g", (c,)), ("ln_b", (c,)), ("w1", (c, hidden)), ("b1", (hidden,)),
                     ("w2", (hidden, c)), ("b2", (c,))):
        require(ops[k], k, x, shape=shape)
    if not fused_mlp(c, hidden):
        raise ValueError(f"the fused MLP takes C <= 256, a multiple of 16, and a hidden width "
                         f"that is a multiple of 8; got C={c} hidden={hidden}")
    y = torch.empty_like(x)
    check(lib().mumpy_mlp_rows(ptr(x), *(ptr(ops[k]) for k in ("ln_g", "ln_b", "w1", "b1",
                                                                "w2", "b2")),
                               ptr(y), m, c, hidden, int(ln_stats_on), int(gelu_on),
                               stream_of(x)), "mlp_rows")
    return y


_CROSS_ATTN = ("ln_g", "ln_b", "w_qkv_rows", "b_qkv", "w_proj", "b_proj")  # #3's weights


def fused_attn(n, c, heads):
    """Whether #3's bf16 attention half runs on the fused kernel
    (csrc/attn_sm90.cu; csrc/swin_pair.cu's ``fused_attn``): a head width of
    32, C <= 256, N <= 64."""
    return n <= 64 and c <= 256 and c == 32 * heads


def _cross_attn_operands(x, ops):
    """Check #3's bf16 operands (``attn_ln`` operands); return (R, N, C, P)."""
    r, n, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    for k, shape in zip(_CROSS_ATTN, ((c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,))):
        require(ops[k], k, x, shape=shape)
    heads = ops["heads"]
    if n > 64 or c % heads or c // heads > 32 or c % 8:
        raise ValueError(f"attn_ln takes n <= 64, a head width of at most 32 and C a "
                         f"multiple of 8; got n={n} C={c} heads={heads}")
    return r, n, c, _mask_period(ops["mb"], x, r, n, heads)


def _mask_args(mb, p):
    return dtype_code(mb), *mb.stride(), p


def attn_rows(x, ops, ln_stats_on=True, key_mask_on=True):
    """bf16: #3's fused attention half (csrc/attn_sm90.cu) on ``x`` (R, N, C)
    with ``ops`` its ``attn_ln`` operands: ``(y, x + y)``, y = proj(MSA(LN x)
    + mb), qkv and the head outputs never in device memory.
    ``ln_stats_on=False`` and ``key_mask_on=False`` plant the checks' faults
    (the LayerNorm with mean 0 and rstd 1; the pad keys N..63 unmasked)."""
    r, n, c, p = _cross_attn_operands(x, ops)
    if not fused_attn(n, c, ops["heads"]):
        raise ValueError(f"the fused attention half takes a head width of 32, C <= 256 and "
                         f"n <= 64; got n={n} C={c} heads={ops['heads']}")
    mb = ops["mb"]
    y, out = torch.empty_like(x), torch.empty_like(x)
    check(lib().mumpy_attn_rows(ptr(x), *(ptr(ops[k]) for k in _CROSS_ATTN), ptr(mb),
                                *_mask_args(mb, p), ptr(y), ptr(out), r, n, c, ops["heads"],
                                int(ln_stats_on), int(key_mask_on), stream_of(x)), "attn_rows")
    return y, out


def attn_ln_fwd(x, ops, ln_stats_on=True, key_mask_on=True):
    """bf16: #3 in one call (csrc/swin_pair.cu): at the widths :func:`fused_attn`
    takes one launch of the fused kernel (:func:`attn_rows`), wider the four
    launches ``ln_rows``, the qkv product (Wqkv read as torch stores it), the
    attention core and the projection writing y and x + y.  Arguments as
    :func:`attn_rows`'s (``key_mask_on`` acts on the fused route only)."""
    r, n, c, p = _cross_attn_operands(x, ops)
    heads, mb = ops["heads"], ops["mb"]
    scratch = torch.empty(lib().mumpy_attn_ln_scratch(r, n, c, heads), device=x.device,
                          dtype=torch.uint8)
    y, out = torch.empty_like(x), torch.empty_like(x)
    check(lib().mumpy_attn_ln_fwd(
        ptr(x), (ctypes.c_void_p * 6)(*(ptr(ops[k]) for k in _CROSS_ATTN)), ptr(mb),
        *_mask_args(mb, p), ptr(y), ptr(out), ptr(scratch), r, n, c, heads, int(ln_stats_on),
        int(key_mask_on), stream_of(x)), "attn_ln_fwd")
    return y, out


def ln_mlp_fwd(x, ops, ln_stats_on=True, gelu_on=True):
    """bf16: #4 in one call (csrc/swin_pair.cu): ``x + fc2(gelu(fc1(LN x)))``
    on ``x`` (M, C), one launch of the fused MLP (:func:`mlp_rows`) where
    :func:`fused_mlp` takes the widths, else ``ln_rows`` and two products.
    Arguments as :func:`mlp_rows`'s (``gelu_on`` acts on the fused route
    only)."""
    m, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    hidden = ops["w1"].shape[1]
    for k, shape in zip(_SERVING_MLP, ((c,), (c,), (c, hidden), (hidden,), (hidden, c), (c,))):
        require(ops[k], k, x, shape=shape)
    if c % 8 or hidden % 8:
        raise ValueError(f"ln_mlp takes widths that are multiples of 8, got C={c} "
                         f"hidden={hidden}")
    scratch = torch.empty(lib().mumpy_ln_mlp_scratch(m, c, hidden), device=x.device,
                          dtype=torch.uint8)
    y = torch.empty_like(x)
    check(lib().mumpy_ln_mlp_fwd(
        ptr(x), (ctypes.c_void_p * 6)(*(ptr(ops[k]) for k in _SERVING_MLP)), ptr(y),
        ptr(scratch), m, c, hidden, int(ln_stats_on), int(gelu_on), stream_of(x)), "ln_mlp_fwd")
    return y


_ATTN_WEIGHTS = 6  # ops/attn_ln_train.py:_WEIGHTS


def _attn_operands(x, mb, keep, weights, heads):
    """Check the bf16 operands of attn_ln_train's launch sequences; return
    (R, N, C, P)."""
    r, n, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    if len(weights) != _ATTN_WEIGHTS:
        raise ValueError(f"attn_ln_train takes {_ATTN_WEIGHTS} weights (b_proj may be None), "
                         f"got {len(weights)}")
    for i, (w, shape) in enumerate(zip(weights, ((c,), (c,), (3 * c, c), (3 * c,), (c, c),
                                                 (c,)))):
        if w is not None or i < 5:
            require(w, f"weight {i}", x, shape=shape)
    require(keep, "keep", x, shape=(r,), dtype=torch.float32)
    if n > 64 or c % heads or c // heads > 32 or c % 8:
        raise ValueError(f"attn_ln_train's launch sequence takes n <= 64, a head width of at "
                         f"most 32 and C a multiple of 8; got n={n} C={c} heads={heads}")
    return r, n, c, _mask_period(mb, x, r, n, heads)


def attn_ln_train_fwd(x, mb, keep, weights, heads):
    """bf16: attn_ln_train's forward launches in one call
    (csrc/swin_block_train.cu).  ``x`` (R, N, C), ``mb`` (P, H, N, N) f32 or
    bf16 (any strides), ``keep`` (R,) f32 per window, ``weights`` (ln_g,
    ln_b, w_qkv, b_qkv, w_proj, b_proj) as torch stores them, read in place.
    Returns ``(y, x + keep * y)``."""
    r, n, c, p = _attn_operands(x, mb, keep, weights, heads)
    scratch = torch.empty(lib().mumpy_attn_ln_train_scratch(r, n, c, heads, p, 0),
                          device=x.device, dtype=torch.uint8)
    y, out = torch.empty_like(x), torch.empty_like(x)
    check(lib().mumpy_attn_ln_train_fwd(
        x.data_ptr(), mb.data_ptr(), dtype_code(mb), *mb.stride(), keep.data_ptr(),
        (ctypes.c_void_p * _ATTN_WEIGHTS)(*(w.data_ptr() for w in weights)), y.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), r, n, c, heads, p, stream_of(x)),
        "attn_ln_train_fwd")
    return y, out


def attn_ln_train_bwd(x, mb, keep, weights, heads, dy, dout, rowsum=True):
    """bf16: attn_ln_train's backward launches in one call
    (csrc/swin_block_train.cu), operands as :func:`attn_ln_train_fwd`'s (the
    backward reads no b_proj: None will do) and the cotangents ``dy`` (may be
    None) and ``dout`` of ``(y, out)``.
    Returns dx, d(mb) (P, H, N, N) in mb's dtype and the six weights'
    gradients; ``rowsum=False`` plants the checks' fault."""
    r, n, c, p = _attn_operands(x, mb, keep, weights, heads)
    for t, name in ((dy, "dy"), (dout, "dout")):
        if t is not None:
            require(t, name, x, shape=x.shape)
    scratch = torch.empty(lib().mumpy_attn_ln_train_scratch(r, n, c, heads, p, 1),
                          device=x.device, dtype=torch.uint8)
    dx = torch.empty_like(x)
    dmb = torch.empty((p, heads, n, n), device=x.device, dtype=mb.dtype)
    grads = [torch.empty_like(w) for w in weights[:5]] + [torch.empty_like(weights[0])]
    ptrs = ctypes.c_void_p * _ATTN_WEIGHTS
    check(lib().mumpy_attn_ln_train_bwd(
        x.data_ptr(), ptr(dy), dout.data_ptr(), mb.data_ptr(), dtype_code(mb), *mb.stride(),
        keep.data_ptr(), ptrs(*(ptr(w) for w in weights)), dx.data_ptr(), dmb.data_ptr(),
        ptrs(*(g.data_ptr() for g in grads)), scratch.data_ptr(), r, n, c, heads, p,
        int(rowsum), stream_of(x)), "attn_ln_train_bwd")
    return (dx, dmb, *grads)


def _mlp_operands(x, keep, weights, div):
    """Check the bf16 operands of ln_mlp_train's launch sequences; return
    (rows, C, hidden)."""
    rows, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    if len(weights) != 6:
        raise ValueError(f"ln_mlp_train takes 6 weights (b2 may be None), got {len(weights)}")
    hidden = weights[2].shape[0]
    for i, (w, shape) in enumerate(zip(weights, ((c,), (c,), (hidden, c), (hidden,),
                                                 (c, hidden), (c,)))):
        if w is not None or i < 5:
            require(w, f"weight {i}", x, shape=shape)
    require(keep, "keep", x, shape=(-(-rows // div),), dtype=torch.float32)
    if c % 8 or hidden % 8:
        raise ValueError(f"ln_mlp_train's bf16 sequence takes widths that are multiples of 8, "
                         f"got C={c} hidden={hidden}")
    return rows, c, hidden


def ln_mlp_train_fwd(x, keep, weights, div=1):
    """bf16: ln_mlp_train's forward launches in one call
    (csrc/swin_block_train.cu).  ``x`` (rows, C), ``keep`` (rows / div,) f32,
    ``weights`` (ln_g, ln_b, w1, b1, w2, b2) as torch stores them.  Returns
    ``x + keep * fc2(gelu(fc1(LN x)))``."""
    rows, c, hidden = _mlp_operands(x, keep, weights, div)
    scratch = torch.empty(lib().mumpy_ln_mlp_train_scratch(rows, c, hidden, 0),
                          device=x.device, dtype=torch.uint8)
    out = torch.empty_like(x)
    check(lib().mumpy_ln_mlp_train_fwd(
        x.data_ptr(), keep.data_ptr(), (ctypes.c_void_p * 6)(*(w.data_ptr() for w in weights)),
        out.data_ptr(), scratch.data_ptr(), rows, c, hidden, div, stream_of(x)),
        "ln_mlp_train_fwd")
    return out


def ln_mlp_train_bwd(x, dy, keep, weights, div=1, gelu_grad=True):
    """bf16: ln_mlp_train's backward launches in one call
    (csrc/swin_block_train.cu), operands as :func:`ln_mlp_train_fwd`'s (the
    backward reads no b2: None will do) and the output gradient ``dy``.
    Returns dx and the six weights' gradients; ``gelu_grad=False`` plants the
    checks' fault (gelu' = 1)."""
    rows, c, hidden = _mlp_operands(x, keep, weights, div)
    require(dy, "dy", x, shape=x.shape)
    scratch = torch.empty(lib().mumpy_ln_mlp_train_scratch(rows, c, hidden, 1),
                          device=x.device, dtype=torch.uint8)
    dx = torch.empty_like(x)
    grads = [torch.empty_like(w) for w in weights[:5]] + [torch.empty_like(weights[0])]
    ptrs = ctypes.c_void_p * 6
    check(lib().mumpy_ln_mlp_train_bwd(
        x.data_ptr(), dy.data_ptr(), keep.data_ptr(), ptrs(*(ptr(w) for w in weights)),
        dx.data_ptr(), ptrs(*(g.data_ptr() for g in grads)), scratch.data_ptr(), rows, c, hidden,
        div, int(gelu_grad), stream_of(x)), "ln_mlp_train_bwd")
    return (dx, *grads)


# ---- #6 and #5 in one call each (csrc/vit3_sm90.cu, csrc/cva_sm90.cu) ----

_VIT3_WEIGHTS = (("attn", "ln_g"), ("attn", "ln_b"), ("attn", "w_qkv_rows"), ("attn", "b_qkv"),
                 ("attn", "w_proj"), ("attn", "b_proj"), ("mlp", "ln_g"), ("mlp", "ln_b"),
                 ("mlp", "w1"), ("mlp", "b1"), ("mlp", "w2"), ("mlp", "b2"))


def fused_vit3(c, heads):
    """Whether #6's bf16 qkv product and n = 3 attention run fused
    (csrc/vit3_sm90.cu): a head width of 64."""
    return heads > 0 and c == 64 * heads


def vit3_qkv_attn(h, w_qkv, b_qkv, heads):
    """bf16: #6's fused qkv product and n = 3 attention
    (``mumpy_vit3_qkv_attn``) on the normalised time-major rows ``h`` (3, R,
    C), ``w_qkv`` (3C, C) as torch stores it: o (3, R, C), qkv never in
    device memory."""
    three, r, c = h.shape
    require(h, "h", h, dtype=torch.bfloat16)
    require(w_qkv, "w_qkv", h, shape=(3 * c, c))
    require(b_qkv, "b_qkv", h, shape=(3 * c,))
    if three != 3 or not fused_vit3(c, heads):
        raise ValueError(f"the fused qkv + attention takes (3, R, C) rows and a head width of "
                         f"64; got {tuple(h.shape)} and {heads} heads")
    o = torch.empty_like(h)
    check(lib().mumpy_vit3_qkv_attn(ptr(h), ptr(w_qkv), ptr(b_qkv), ptr(o), r, c, heads,
                                    stream_of(h)), "vit3_qkv_attn")
    return o


def vit3_fwd(x, ops):
    """bf16: #6 in one call (``mumpy_vit3_fwd``) on the time-major ``x`` (3,
    R, C) with its ``vit3`` operands: ``ln_rows``, the fused qkv + attention
    where :func:`fused_vit3` takes the width (else the qkv product and
    csrc/vit3_attention.cu), the projection with the residual, and ``ln_mlp``'s
    call.  Returns the layer's output (3, R, C)."""
    three, r, c = x.shape
    require(x, "x", x, dtype=torch.bfloat16)
    heads, hidden = ops["attn"]["heads"], ops["mlp"]["w1"].shape[1]
    shapes = ((c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,), (c,), (c,), (c, hidden),
              (hidden,), (hidden, c), (c,))
    weights = [ops[a][k] for a, k in _VIT3_WEIGHTS]
    for (_, k), w, shape in zip(_VIT3_WEIGHTS, weights, shapes):
        require(w, k, x, shape=shape)
    if three != 3 or c % heads or c // heads > 128 or c % 8 or hidden % 8:
        raise ValueError(f"vit3 takes (3, R, C) rows, a head width of at most 128 and widths "
                         f"that are multiples of 8; got {tuple(x.shape)}, {heads} heads, "
                         f"hidden {hidden}")
    scratch = torch.empty(lib().mumpy_vit3_scratch(r, c, hidden, heads), device=x.device,
                          dtype=torch.uint8)
    out = torch.empty_like(x)
    check(lib().mumpy_vit3_fwd(ptr(x), (ctypes.c_void_p * 12)(*(ptr(w) for w in weights)),
                               ptr(out), ptr(scratch), r, c, hidden, heads, stream_of(x)),
          "vit3_fwd")
    return out


_CVA_WEIGHTS = ("w_q_rows", "b_q", "w_kv_rows", "b_kv", "w_proj")


def fused_cva(n, c, heads, groups, ws):
    """Whether #5's bf16 core runs on the fused kernel (csrc/cva_sm90.cu): a
    head width of 32, C <= 256, windows of ws x ws <= 64 tokens and groups of
    whole 8-channel chunks."""
    return (heads > 0 and c == 32 * heads and c <= 256 and n <= 64 and n == ws * ws
            and groups > 0 and c % groups == 0 and (c // groups) % 8 == 0)


def _cva_operands(x1, x2, gy, gx, ops):
    """Check #5's bf16 operands; return (B1, R, N, C)."""
    b1, n, c = x1.shape
    r = x2.shape[0]
    require(x1, "x1", x1, dtype=torch.bfloat16)
    require(x2, "x2", x1, shape=(r, n, c))
    groups, heads = ops["groups"], ops["heads"]
    for t, name in ((gy, "gy"), (gx, "gx")):
        require(t, name, x1, shape=(groups, b1, n), dtype=torch.float32)
    for k, shape in zip(_CVA_WEIGHTS, ((c, c), (c,), (2 * c, c), (2 * c,), (c, c))):
        require(ops[k], k, x1, shape=shape)
    if r % b1 or n > 64 or c % heads or c // heads > 32 or c % 8 or c % groups:
        raise ValueError(f"cva takes partner windows in whole multiples of the query windows, "
                         f"n <= 64, a head width of at most 32 and C a multiple of 8 and of the "
                         f"groups; got B1={b1} R={r} n={n} C={c} heads={heads} groups={groups}")
    return b1, r, n, c


def cva_rows(x1, x2, gy, gx, ops, sample_on=True, fold_on=True, key_mask_on=True):
    """bf16: #5's fused core (``mumpy_cva_rows``) on query windows ``x1``
    (B1, N, C), partner windows ``x2`` (R, N, C) and the f32 coordinates
    ``gy`` / ``gx`` (groups, B1, N) with its ``cva`` operands: the
    ratio-folded output (B1, N, C) without the proj_out bias, s, k|v and o
    never in device memory.  ``sample_on``, ``fold_on`` and ``key_mask_on``
    False plant the checks' faults."""
    b1, r, n, c = _cva_operands(x1, x2, gy, gx, ops)
    if not fused_cva(n, c, ops["heads"], ops["groups"], ops["ws"]):
        raise ValueError(f"the fused CVA core takes a head width of 32, C <= 256 and windows of "
                         f"ws x ws <= 64 tokens; got n={n} C={c} heads={ops['heads']}")
    out = torch.empty_like(x1)
    check(lib().mumpy_cva_rows(ptr(x1), ptr(x2), ptr(gy), ptr(gx),
                               *(ptr(ops[k]) for k in _CVA_WEIGHTS), ptr(out), b1, r, n, c,
                               ops["heads"], ops["groups"], ops["ws"], int(sample_on),
                               int(fold_on), int(key_mask_on), stream_of(x1)), "cva_rows")
    return out


def cva_fwd(x1, x2, gy, gx, ops, sample_on=True, fold_on=True, key_mask_on=True):
    """bf16: #5 in one call (``mumpy_cva_fwd``): one launch of the fused core
    where :func:`fused_cva` takes the widths, else five (q, the sampler, k|v,
    the folding attention core, the projection).  Arguments as
    :func:`cva_rows`'s (``key_mask_on`` acts on the fused route only)."""
    b1, r, n, c = _cva_operands(x1, x2, gy, gx, ops)
    heads, groups, ws = ops["heads"], ops["groups"], ops["ws"]
    scratch = torch.empty(lib().mumpy_cva_scratch(b1, r, n, c, heads, groups, ws),
                          device=x1.device, dtype=torch.uint8)
    out = torch.empty_like(x1)
    check(lib().mumpy_cva_fwd(ptr(x1), ptr(x2), ptr(gy), ptr(gx),
                              (ctypes.c_void_p * 5)(*(ptr(ops[k]) for k in _CVA_WEIGHTS)),
                              ptr(out), ptr(scratch), b1, r, n, c, heads, groups, ws,
                              int(sample_on), int(fold_on), int(key_mask_on), stream_of(x1)),
          "cva_fwd")
    return out
