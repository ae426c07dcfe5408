#!/usr/bin/env python3
"""Drive the PyTorch port (``mumpy_tpu_torch``) of the Mumpy serving path on
one CUDA GPU and check it.

Phases (any failure exits non-zero, before the result line):

1. the device: ``torch.cuda.get_device_name(0)``, and on a line of its own
   the card's name and power limit as ``nvidia-smi`` gives them;
2. build the hand-written kernels from ``mumpy_tpu_torch/csrc`` (nvcc, sm_90a);
3. capture the input of every distinct kernel instance (kernel, shapes, mask
   period, ratio) that the flagship 224^2 forward launches, at batch 2, plus
   the instances earlier slices launched and the default path no longer does
   (the stage-2 blocks one by one, as each pair's two halves, and the
   ViT-shaped ``ln_mlp``) and seeded flagship-shaped pair and vit3 cases
   (``tests/torch_cases.py``), and hold each kernel against its plain
   PyTorch version, in f32 and in bf16: the largest error against
   max(1, max|ref|) (f32 1e-4; bf16, against the f32 plain version, 2e-2),
   and the RMS error against the RMS of the kernel's own branch, the output
   less the residual it adds (f32 1e-5, bf16 2e-2, see ``branch_error``).
   Planted faults run on the bf16 instances and the branch comparison must
   call each wrong: the mask+bias zeroed (every instance that takes one),
   the pair's row map replaced by the identity (no shift), and vit3's scores
   zeroed (uniform attention; required on the seeded case, see
   ``planted_faults``);
4. the main path: the flagship forward through ``make_serving_forward`` with
   seeded random weights, once on the kernel path and once on the plain path
   (chosen by argument), f32 logits agreeing within 1e-3 * max(1, max|logit|),
   and the kernels' launch counts per forward (swin_block / swin_pair /
   attn_ln / ln_mlp / cva / vit3 = 12 / 18 / 12 / 12 / 8 / 12); then both
   paths in bf16 against the f32 logits, the kernel path no further off than
   twice the plain path;
5. bf16 frames/s of both paths at batch 32 (CUDA events after warm-up) and
   the peak device memory;
6. each kernel's time per batch-32 bf16 forward beside its plain version's,
   and the least time the card could take for the same work (``bound_ms``:
   the larger of the bytes over 3.35 TB/s and the flops over 989 TFLOP/s,
   the H100 SXM's HBM rate and dense bf16 tensor-core peak), per instance.

The weights are drawn with ``random_state_dict(..., fan_in=True)``: matrices
at 1/sqrt(fan-in) and relative-position tables at unit scale, so every score,
mask+bias term and branch is of order one at every width, and a kernel that
dropped any of them would show.

The second-to-last line of output is a JSON object with one entry per kernel;
the last is ``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
F32_TOL, BF16_TOL = 1e-4, 2e-2  # max error / max(1, max|ref|)
# RMS error / RMS of the branch.  On the flagship instances (H100, PERF.md):
# f32 at most 1.5e-6; bf16 at most 0.0106, and the zeroed-mask+bias controls
# at least 0.0449, so the bf16 bound sits about 2x from each.
F32_BRANCH_TOL, BF16_BRANCH_TOL = 1e-5, 2e-2
LOGIT_TOL = 1e-3
EXPECTED_LAUNCHES = {"swin_block": 12, "swin_pair": 18, "attn_ln": 12, "ln_mlp": 12,
                     "cva": 8, "vit3": 12}
KERNEL_INFO = {  # name -> (CUDA sources it launches, TPU kernel it replaces)
    "swin_block": (["gemm.cu", "window_attention.cu"], "mumpy_tpu/ops/pallas/swin_block.py:180"),
    "swin_pair": (["gemm.cu", "window_attention.cu"], "mumpy_tpu/ops/pallas/swin_pair.py:191"),
    "attn_ln": (["gemm.cu", "window_attention.cu"], "mumpy_tpu/ops/pallas/attn_ln.py:51"),
    "ln_mlp": (["gemm.cu"], "mumpy_tpu/ops/pallas/ln_mlp.py:40"),
    "cva": (["gemm.cu", "cva_sample.cu", "window_attention.cu"],
            "mumpy_tpu/ops/pallas/cva.py:79"),
    "vit3": (["gemm.cu", "vit3_attention.cu"], "mumpy_tpu/ops/pallas/vit3.py:77"),
}
RESIDUAL_KERNELS = ("swin_block", "swin_pair", "ln_mlp", "vit3")  # out = x + branch
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16 tensor cores, HBM3


def log(*a):
    print(*a, flush=True)


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return (got - ref).abs().max().item(), max(1.0, ref.abs().max().item())


def branch_error(name, x, got, ref):
    """RMS error of a kernel's outputs over the RMS of its own contribution:
    the output less the residual input ``x`` it adds (swin_block, ln_mlp),
    ``y`` for both of attn_ln's outputs ``(y, x + y)``, and all of cva's
    output.  The residual stream can be many times the branch added to it, so
    a bound scaled by the output would pass a branch that is wrong."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    branch = ref[0] - x if name in RESIDUAL_KERNELS else ref[0]

    def rms(t):
        return t.double().pow(2).mean().sqrt().item()

    return max(rms(g.double() - r.double()) for g, r in zip(got, ref)) / rms(branch)


def mask_bias_shape(ops):
    """Shape of the first additive mask+bias in ``ops`` (its period P leads),
    or None for a kernel that takes none."""
    if not isinstance(ops, dict):
        return None
    if "mb" in ops:
        return tuple(ops["mb"].shape)
    return next((s for v in ops.values() if (s := mask_bias_shape(v))), None)


def drop_mask_bias(ops):
    """The operands with every additive mask+bias zeroed (its key-pad columns
    kept): the planted fault the branch comparison must catch."""
    if "mb" not in ops:
        return {k: drop_mask_bias(v) if mask_bias_shape(v) else v for k, v in ops.items()}
    mb = ops["mb"].clone()
    mb[..., : mb.shape[2]] = 0.0
    return {**ops, "mb": mb}


def identity_map(ops):
    """swin_pair operands whose row map is the identity: the shifted block
    runs on unshifted windows (no shift), the planted fault of the pair."""
    return {**ops, "map": torch.arange(ops["map"].numel(), dtype=torch.int32,
                                       device=ops["map"].device)}


def uniform_attention(ops):
    """vit3 operands with the query projection zeroed, so every score is 0
    and the attention uniform: the planted fault of vit3."""
    a = ops["attn"]
    c = a["w_proj"].shape[0]
    w, b = a["w_qkv"].clone(), a["b_qkv"].clone()
    w[:, :c] = 0
    b[:c] = 0
    return {**ops, "attn": {**a, "w_qkv": w, "b_qkv": b}}


def planted_faults(name, ops):
    """(label, operands, whether the flagship forward's own inputs must show
    it) of every planted fault that applies to an instance.  Uniform
    attention is required to show only on the seeded inputs: the random-weight
    flagship's ViT input has three nearly alike time slices (views 1 and 2
    are tiled over time), so its own softmax is nearly uniform already
    (PERF.md, Findings PR 3)."""
    faults = []
    if mask_bias_shape(ops):
        faults.append(("mask+bias zeroed", drop_mask_bias(ops), True))
    if name == "swin_pair":
        faults.append(("identity row map", identity_map(ops), True))
    if name == "vit3":
        faults.append(("scores zeroed", uniform_attention(ops), False))
    return faults


def tensors_of(obj):
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors_of(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in tensors_of(v)]
    return [obj] if torch.is_tensor(obj) else []


def work(name, args):
    """(flops, bytes) one call needs at these inputs: the products and
    attention of the contract, each input tensor (operands included) read once
    and each output written once."""
    x, ops = args[0], args[-1]
    nbytes = sum(t.numel() * t.element_size() for t in tensors_of(args))
    out_bytes = x.numel() * x.element_size() * (2 if name == "attn_ln" else 1)
    c = x.shape[-1]

    def block(rows, n, mlp):  # a Swin block: qkv, proj, MLP, QK^T and PV
        return 2 * rows * (4 * c * c + 2 * c * mlp) + 4 * rows * n * c

    if name == "swin_block":
        flops = block(x.shape[0] * x.shape[1], x.shape[1], ops["mlp"]["w1"].shape[1])
    elif name == "swin_pair":
        flops = sum(block(x.shape[0] * x.shape[1], x.shape[1], ops[k]["mlp"]["w1"].shape[1])
                    for k in ("a", "b"))
    elif name == "attn_ln":
        rows = x.shape[0] * x.shape[1]
        flops = 8 * rows * c * c + 4 * rows * x.shape[1] * c
    elif name == "ln_mlp":
        flops = 4 * (x.numel() // c) * c * ops["w1"].shape[1]
    elif name == "cva":
        b1, n = x.shape[0], x.shape[1]
        r = args[1].shape[0]
        flops = 4 * b1 * n * c * c + 4 * r * n * c * c + 4 * r * n * n * c
    else:  # vit3: 3R rows of qkv, proj and MLP; nine q.k and nine p.v per row
        rows = x.numel() // c
        flops = 2 * rows * (4 * c * c + 2 * c * ops["mlp"]["w1"].shape[1]) + 12 * rows * c
    return flops, nbytes + out_bytes


def cast_ops(ops, dtype):
    """Kernel operands in ``dtype``; the f32 mask+bias stays f32."""
    if isinstance(ops, dict):
        return {k: v if k == "mb" else cast_ops(v, dtype) for k, v in ops.items()}
    if torch.is_tensor(ops) and ops.is_floating_point():
        return ops.to(dtype)
    return ops


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Record the arguments of every distinct plain-kernel call during one
    plain-path forward, with how often each instance ran."""

    def __init__(self):
        from mumpy_tpu_torch.models import deformable, encoder, swin
        from mumpy_tpu_torch.ops import attn_ln, cva, ln_mlp, swin_block, swin_pair, vit3

        self.kernels = {"swin_block": swin_block, "swin_pair": swin_pair, "attn_ln": attn_ln,
                        "ln_mlp": ln_mlp, "cva": cva, "vit3": vit3}
        self.sites = [(mod, f"{name}_plain") for mod in (swin, encoder, deformable)
                      for name in self.kernels if hasattr(mod, f"{name}_plain")]
        self.instances = {}

    def add(self, name, args, count, tag="captured"):
        tensors = [a for a in args if torch.is_tensor(a)]
        key = (name, tuple(tuple(t.shape) for t in tensors), mask_bias_shape(args[-1]), tag)
        if key not in self.instances:
            self.instances[key] = [tuple(a.clone() if torch.is_tensor(a) else a
                                         for a in args), 0]
        self.instances[key][1] += count

    def add_earlier_instances(self):
        """The instances earlier slices launched that the default path no
        longer does, at zero launches: each pair's two blocks one by one (the
        shifted one on its rolled windows) and each ViT layer's MLP tail on
        token-major rows."""
        from mumpy_tpu_torch.ops.window import partition_tokens, unpartition_tokens

        for (name, *_), (args, _) in list(self.instances.items()):
            x, ops = args[0], args[-1]
            if name == "swin_pair":
                gh, gw, w, s = ops["grid"]
                xs = partition_tokens(unpartition_tokens(x, gh, gw, w, 0), gh, gw, w, s)
                self.add("swin_block", (xs.contiguous(), ops["a"]), 0, "earlier slice")
                self.add("swin_block", (x, ops["b"]), 0, "earlier slice")
            elif name == "vit3":
                self.add("ln_mlp", (x.transpose(0, 1).contiguous(), ops["mlp"]), 0,
                         "earlier slice")

    def add_seeded_cases(self, device):
        """The flagship pair and vit3 shapes at batch 2 from independent seeded
        draws (``tests/torch_cases.py``, shared with the card tests): every
        window, head and time slice differs, so each planted fault has a
        function to break."""
        sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
        import torch_cases as tc

        for geometry in tc.FLAGSHIP_PAIRS.values():
            _, x, ops = tc.pair_case(geometry, seed=51, batch=2)
            self.add("swin_pair", tc.to_dev((tc.t(x), ops), device), 0, "seeded")
        c, heads, m = tc.FLAGSHIP_VIT3
        _, x, ops = tc.vit3_case(seed=52, r=2 * 49, c=c, heads=heads, m=m)
        self.add("vit3", tc.to_dev((tc.t(x), ops), device), 0, "seeded")

    def _wrap(self, name, plain):
        def rec(*args):
            self.add(name, args, 1)
            return plain(*args)
        return rec

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr)) for mod, attr in self.sites]
        for mod, attr, fn in self.saved:
            setattr(mod, attr, self._wrap(attr[: -len("_plain")], fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def build_model(cfg, device):
    from mumpy_tpu_torch.models.mumpy import Mumpy
    from mumpy_tpu_torch.utils.weight_port import random_state_dict

    model = Mumpy(cfg)
    model.load_state_dict(random_state_dict(model, SEED, fan_in=True))
    return model.to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mumpy_tpu_torch.configs import multiswin_config
    from mumpy_tpu_torch.ops import cuda_lib
    from mumpy_tpu_torch.ops.attn_ln import attn_ln
    from mumpy_tpu_torch.ops.cva import cva
    from mumpy_tpu_torch.ops.ln_mlp import ln_mlp
    from mumpy_tpu_torch.ops.swin_block import swin_block
    from mumpy_tpu_torch.ops.swin_pair import swin_pair
    from mumpy_tpu_torch.ops.vit3 import vit3
    from mumpy_tpu_torch.utils.serving import make_serving_forward

    KERNELS = (swin_block, swin_pair, attn_ln, ln_mlp, cva, vit3)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # ---- 2. build ----
    cuda_lib.lib()
    cached = " (library reused from build/, not rebuilt)" if not cuda_lib.build_log else ""
    log(f"[build] nvcc {cuda_lib.build_seconds:.1f} s{cached}")
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    cfg = multiswin_config()
    rng = np.random.default_rng(SEED)
    clip2 = torch.from_numpy(rng.standard_normal((2, 3, 224, 224, 3), dtype=np.float32))

    # ---- 3. every kernel instance vs its plain version ----
    model = build_model(cfg, dev)
    fwd_plain = make_serving_forward(model, dev, torch.float32, use_kernels=False)
    with Capture() as cap:
        fwd_plain(clip2)
    cap.add_earlier_instances()
    cap.add_seeded_cases(dev)
    errs = {k: 0.0 for k in EXPECTED_LAUNCHES}
    ok = True
    with torch.inference_mode():
        for key, (args, count) in cap.instances.items():
            name = key[0]
            mod = cap.kernels[name]
            kernel, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
            n_act = 2 if name == "cva" else 1  # activations; cva's coordinates stay f32
            acts, coords, ops = args[:n_act], args[n_act:-1], args[-1]
            acts16, ops16 = [a.to(torch.bfloat16) for a in acts], cast_ops(ops, torch.bfloat16)
            ref, got = plain(*args), kernel(*args)
            # bf16: the kernel's own error, against the f32 plain version run
            # on the same bf16-valued inputs
            ref16 = plain(*(a.float() for a in acts16), *coords,
                          cast_ops(ops16, torch.float32))
            got16 = kernel(*acts16, *coords, ops16)
            torch.cuda.synchronize()
            x16 = acts16[0].float()
            b32 = branch_error(name, acts[0], got, ref)
            b16 = branch_error(name, x16, got16, ref16)
            good = b32 <= F32_BRANCH_TOL and b16 <= BF16_BRANCH_TOL
            refs = ref if isinstance(ref, tuple) else (ref,)
            g32 = got if isinstance(got, tuple) else (got,)
            g16 = got16 if isinstance(got16, tuple) else (got16,)
            e32 = e16 = 0.0
            for r, a, b in zip(refs, g32, g16):
                ea, s = rel_err(a, r)
                eb, _ = rel_err(b, r)
                good &= ea <= F32_TOL * s and eb <= BF16_TOL * s
                e32, e16 = max(e32, ea / s), max(e16, eb / s)
                errs[name] = max(errs[name], ea)
            control = ""
            for label, bad_ops, required in planted_faults(name, ops16):
                bc = branch_error(name, x16, kernel(*acts16, *coords, bad_ops), ref16)
                caught = bc > BF16_BRANCH_TOL
                if required or key[3] == "seeded":
                    good &= caught
                    verdict = "caught" if caught else "NOT CAUGHT"
                else:
                    verdict = "reported only"
                control += f"; control ({label}) {bc:.3g} {verdict}"
            ok &= good
            log(f"[kernel] {name} {key[1]} P={key[2]} ({key[3]}) x{count}: max err / scale f32 "
                f"{e32:.3g} bf16 {e16:.3g}; branch RMS err f32 {b32:.3g} bf16 {b16:.3g}"
                f"{control} {'ok' if good else 'FAIL'}")
    if not ok:
        log("[kernel] FAILED: a kernel disagrees with its plain version, or a "
            "planted fault went unseen")
        return 1
    del cap

    # ---- 4. main path: kernel path vs plain path, launch counts ----
    def serve(dtype, use_kernels):
        """Probabilities from the serving forward with the kernels' launch
        counts of that forward, and the logits of the same prepared model
        (compared as logits: a probability near 0 or 1 keeps too few bits of
        its logit)."""
        fwd = make_serving_forward(model, dev, dtype, use_kernels=use_kernels)
        for k in KERNELS:
            k.launches = 0
        probs = fwd(clip2)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in KERNELS}
        with torch.inference_mode():
            logit = model(clip2.to(dev, dtype)).double()
        if not torch.allclose(probs.double(), torch.sigmoid(logit), atol=1e-6, rtol=0):
            raise RuntimeError("serving probabilities are not sigmoid(logits)")
        return probs, counts, logit.cpu()

    probs, launches, a = serve(torch.float32, True)
    _, plain_counts, b = serve(torch.float32, False)
    if any(plain_counts.values()):
        log(f"[main] FAILED: the plain path launched kernels: {plain_counts}")
        return 1
    log(f"[main] launches per forward: {launches}")
    err, scale = rel_err(a, b)
    finite = bool(torch.isfinite(probs).all()) and tuple(probs.shape) == (2, 224, 224, 1)
    log(f"[main] f32 logits kernel vs plain: max err {err:.3g} (scale {scale:.3g}); "
        f"probabilities shape {tuple(probs.shape)} finite {finite}")
    if launches != EXPECTED_LAUNCHES or err > LOGIT_TOL * scale or not finite:
        log("[main] FAILED")
        return 1
    # the bf16 forward that phase 5 times, against the f32 logits
    err16 = {use_kernels: rel_err(serve(torch.bfloat16, use_kernels)[2], b)[0]
             for use_kernels in (True, False)}
    log(f"[main] bf16 logits vs f32: kernel path max err {err16[True]:.3g}, plain path "
        f"{err16[False]:.3g} (scale {scale:.3g})")
    if not err16[True] <= 2 * err16[False]:
        log("[main] FAILED: the bf16 kernel path is further off than twice the plain path")
        return 1

    # ---- 5. bf16 throughput at batch 32 ----
    clip32 = torch.from_numpy(rng.standard_normal((32, 3, 224, 224, 3), dtype=np.float32))
    for use_kernels in (False, True, True, False):
        fwd = make_serving_forward(model, dev, torch.bfloat16, use_kernels=use_kernels)
        x = clip32.to(dev)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fwd(x), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        tag = "kernel" if use_kernels else "plain"
        log(f"[fps] bf16 batch 32 {tag} path: {ms:.1f} ms/batch, {32e3 / ms:.1f} frames/s, "
            f"peak {peak:.2f} GiB ({smi})")

    # ---- 6. per-kernel time per batch-32 bf16 forward ----
    fwd = make_serving_forward(model, dev, torch.bfloat16, use_kernels=False)
    with Capture() as cap:
        fwd(clip32)
    # per kernel: kernel ms, plain ms, bound ms, seconds of flops, seconds of bytes
    times = {k: [0.0] * 5 for k in EXPECTED_LAUNCHES}
    with torch.inference_mode():
        for key, (args, count) in cap.instances.items():
            name = key[0]
            mod = cap.kernels[name]
            kernel, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
            flops, nbytes = work(name, args)
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row = times[name]
            row[0] += count * cuda_ms(lambda: kernel(*args), reps=5)
            row[1] += count * cuda_ms(lambda: plain(*args), reps=5)
            row[2] += count * max(t_ops, t_bytes)
            row[3] += count * t_ops
            row[4] += count * t_bytes
    for name, (k_ms, p_ms, b_ms, _, _) in times.items():
        log(f"[time] {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
            f"per bf16 batch-32 forward ({smi})")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"mumpy_tpu_torch/ops/{name}.py",
         "cuda_sources": [f"mumpy_tpu_torch/csrc/{f}" for f in KERNEL_INFO[name][0]],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": times[name][2],
         "bound_by": "operations" if times[name][3] >= times[name][4] else "bytes",
         # no single PyTorch call computes any of these whole contracts
         "library_ms": None}
        for name in EXPECTED_LAUNCHES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
