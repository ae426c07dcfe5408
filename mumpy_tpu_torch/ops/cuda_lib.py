"""Build and bind the hand-written CUDA kernels of ``mumpy_tpu_torch/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The library
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds = None  # wall time of the nvcc run, or 0.0 when the cache hit
build_log = ""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mumpy_gemm": [_P] * 10 + [_I] * 8 + [_P],
    "mumpy_window_attention": [_P] * 5 + [_I] * 10 + [_F, _I, _P],
    "mumpy_cva_sample": [_P] * 4 + [_I] * 7 + [_P],
    "mumpy_vit3_attention": [_P] * 2 + [_I] * 3 + [_F, _I, _P],
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
        capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
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


# ---- launch helpers shared by the kernel wrappers ------------------------

_GRID_Y_MAX_ROWS = 65535 * 64  # gemm grid.y limit times the 64-row tile
_TC_MAX_LN_K = 1024  # kTcMaxLnK: LayerNorm rows the bf16 GEMM holds in registers


def gemm(x, w, bias=None, ln=None, res=None, want_y=True, want_out=False,
         gelu=False, a_sum=1, a_seg=1, a_map=None, c_map=None):
    """Launch the tiled GEMM (csrc/gemm.cu).  ``x`` is (M*a_sum, K) (the fold
    reads ``a_sum`` rows per output row), ``w`` (K, N).  Returns ``y`` and/or
    ``out = res + y`` as requested.  ``a_map`` / ``c_map`` are int32 row maps
    of a period L dividing M: A row m (and its LayerNorm) is read from x row
    ``(m // L) * L + a_map[m % L]``, and the residual row and the stored rows
    of y / out are ``(m // L) * L + c_map[m % L]``."""
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
    if map_len and (m % map_len or a_sum > 1):
        raise ValueError(f"gemm: a row map of length {map_len} needs M={m} to be a "
                         f"multiple of it and no row fold")
    if m > _GRID_Y_MAX_ROWS:
        raise ValueError(f"gemm: {m} rows exceed the grid limit {_GRID_Y_MAX_ROWS}")
    if x.dtype == torch.bfloat16:  # the tensor-core loop's limits (csrc/gemm.cu)
        operands = (x, w, bias, ln_g, ln_b, res)
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
                           ptr(a_map), ptr(c_map), ptr(y), ptr(out), m, n, k, a_sum,
                           a_seg, int(gelu), map_len, dtype_code(x), stream_of(x)), "gemm")
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
