#!/usr/bin/env python3
"""Where the time of the fused attention half (#3, ``csrc/attn_sm90.cu``) or,
with ``--cva``, of the fused CVA core (#5, ``csrc/cva_sm90.cu``) goes, on a
CUDA GPU: each variant is the kernel with one part changed or left out (a
textual edit of a copy of ``mumpy_tpu_torch/csrc``), built in a process of
its own and timed by CUDA events at the flagship's four C <= 256 #3 (or #5)
shapes (batch 32) on seeded bf16 operands.  A variant that leaves a part out
computes a wrong result: its time says what the part costs, nothing more.

    python3 scripts/attn_sm90_variants.py            # every variant, in turn
    python3 scripts/attn_sm90_variants.py --cva      # the same for #5
    python3 scripts/attn_sm90_variants.py --sass     # instructions per section

``--sass`` prints, for ``attn_rows_kernel<128>``, the instructions between
the kernel's wgmma products, waits, barriers and exponentials
(``cuobjdump -sass`` of the built library).  Run from the repository root;
the builds go under the git-ignored ``build/``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNEL = "mumpy_tpu_torch/csrc/attn_sm90.cu"
# (windows, tokens, C, heads) of #3's C <= 256 instances at batch 32
SHAPES = ((6144, 49, 128, 4), (2048, 49, 96, 3), (1536, 49, 256, 8), (512, 49, 192, 6))
VARIANTS = {  # name -> [(text in the kernel source, its replacement)]
    "kernel": [],
    "two consumers": [("NC <= 128 ? 3 : 2", "2"), ("kCons == 3 ? 24 : 40", "40"),
                      ("kCons == 3 ? 160 : 232", "232")],
    "mask from device memory": [
        ("  p.mask_smem = p.P == 1 && p.H * p.N * p.N * 4 + 256 <= S::kMask;",
         "  p.mask_smem = 0;")],
    "exact exp": [("__expf(", "expf(")],
    "no LayerNorm": [("      ln_tile_rows(a_tile + cw * kPanel,",
                      "      if (0) ln_tile_rows(a_tile + cw * kPanel,")],
    "no softmax": [("        head_attention(qa, keys, vt, oa, [&](float (&sc)[32]) {",
                    "        head_attention(qa, keys, vt, oa, [&](float (&sc)[32]) { return;")],
    "no stores": [("            *reinterpret_cast<uint4*>(p.y + idx) = yv;",
                   "            if (0) *reinterpret_cast<uint4*>(p.y + idx) = yv;"),
                  ("            *reinterpret_cast<uint4*>(p.out + idx) = pack8(f);",
                   "            if (0) *reinterpret_cast<uint4*>(p.out + idx) = pack8(f);")],
    "barriers and copies only": [
        ("      if (win >= p.R) {  // no window: keep the barriers in step",
         "      if (true) {  // no window: keep the barriers in step")],
}


CVA_KERNEL = "mumpy_tpu_torch/csrc/cva_sm90.cu"
# (query windows, ratio, C, heads, grid) of #5's C <= 256 instances at batch 32
CVA_SHAPES = ((2048, 3, 96, 3, 224), (2048, 1, 96, 3, 224), (512, 3, 192, 6, 112),
              (512, 1, 192, 6, 112))
CVA_VARIANTS = {
    "kernel": [],
    "two consumers at C <= 128": [("NC <= 128 ? 3 : NC <= 192 ? 2 : 1", "NC <= 192 ? 2 : 1"),
                                  ("kCons == 3 ? 24 : 40", "40")],
    "no sampling": [("        sample_slot<NC, kBM>(slot, p, qw, tid & 127, cw);",
                     "        if (0) sample_slot<NC, kBM>(slot, p, qw, tid & 127, cw);")],
    "no softmax": [("          head_attention(qa, keys, vt, oa, [&](float (&sc)[32]) {",
                    "          head_attention(qa, keys, vt, oa, [&](float (&sc)[32]) { return;")],
    "barriers and copies only": [
        ("      if (b >= p.B1) {  // no window: keep the barriers in step",
         "      if (true) {  // no window: keep the barriers in step")],
}


def build(name, kernel=KERNEL, variants=VARIANTS):
    """The kernel library of one variant, built from an edited copy of csrc
    (each edit in the kernel's source or, failing that, in the per-head
    steps it shares, ``csrc/attn_sm90.cuh``)."""
    from mumpy_tpu_torch.ops import cuda_lib

    files = [kernel, "mumpy_tpu_torch/csrc/attn_sm90.cuh"]
    src = {f: (ROOT / f).read_text() for f in files}
    for old, new in variants[name]:
        where = next((f for f in files if old in src[f]), None)
        if where is None:
            raise SystemExit(f"variant {name!r}: {old!r} is not in {' or '.join(files)}")
        src[where] = src[where].replace(old, new)
    d = ROOT / "build" / "attn_variants" / re.sub(r"\W+", "_", f"{Path(kernel).stem} {name}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "mumpy_tpu_torch" / "csrc", d)
    for f in files:
        (d / Path(f).name).write_text(src[f])
    cuda_lib._CSRC = d
    cuda_lib.lib()
    return cuda_lib


def cuda_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_variant(name):
    import torch

    from mumpy_tpu_torch.ops.attn_ln import attn_ln_operands

    cuda_lib = build(name)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0, mean=0.0):
        return (mean + torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

    times = []
    for r, n, c, heads in SHAPES:
        ops = attn_ln_operands(rnd(c, mean=1.0, scale=0.1), rnd(c, scale=0.1),
                               rnd(3 * c, c, scale=c**-0.5), rnd(3 * c, scale=0.1),
                               rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1),
                               torch.randn(1, heads, n, n, generator=g, device="cuda"), heads)
        x = rnd(r, n, c)
        times.append(f"C {c} {cuda_ms(lambda: cuda_lib.attn_rows(x, ops)):.4f} ms")
    print(f"{name}: " + ", ".join(times), flush=True)


def time_cva_variant(name):
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_cases as tc

    cuda_lib = build(name, CVA_KERNEL, CVA_VARIANTS)
    times = []
    for b1, ratio, c, heads, grid in CVA_SHAPES:
        _, args, ops = tc.cva_case(ratio, seed=0, c=c, heads=heads, win=7, grid=grid)
        x1, x2, gy, gx = (tc.t(a).cuda() for a in args)
        ops = tc.to_dev({k: v.bfloat16() if torch.is_tensor(v) else v for k, v in ops.items()},
                        "cuda")
        x1, x2 = x1.bfloat16(), x2.bfloat16()
        ms = cuda_ms(lambda: cuda_lib.cva_rows(x1, x2, gy, gx, ops))
        times.append(f"C {c} ratio {ratio} {ms:.4f} ms")
    print(f"{name}: " + ", ".join(times), flush=True)


def sass_sections():
    """Instructions between the wgmma products, waits, barriers and
    exponentials of attn_rows_kernel<128>."""
    so = build("kernel")._build()  # the library just built (or found built)
    fn = "_ZN5mumpy16attn_rows_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_8AttnArgsE"
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", "-fun", fn, str(so)],
                          capture_output=True, text=True, check=True).stdout
    marks, prev = [], None
    for line in sass.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,5})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)", line)
        if m and m.group(3).startswith(("HGMMA", "MUFU.EX2", "BAR.SYNC", "WARPGROUP.DEPBAR")):
            op = m.group(3)
            if not (prev and prev[1] == op and op == "MUFU.EX2"):
                marks.append((int(m.group(1), 16), op))
            prev = (int(m.group(1), 16), op)
    for (a, op), (b, nxt) in zip(marks, marks[1:]):
        print(f"{op} @{a:05x} -> {nxt} @{b:05x}: {(b - a) // 16} instructions")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("attn_sm90_variants: needs a CUDA device")
    cva = "--cva" in sys.argv[1:]
    if "--sass" in sys.argv[1:]:
        sass_sections()
    elif "--variant" in sys.argv[1:]:
        name = sys.argv[sys.argv.index("--variant") + 1]
        time_cva_variant(name) if cva else time_variant(name)
    else:
        print(f"{torch.cuda.get_device_name(0)}; shapes "
              + (f"(query windows, ratio, C, heads, grid) {CVA_SHAPES}" if cva else
                 f"(windows, tokens, C, heads) {SHAPES}"))
        for name in CVA_VARIANTS if cva else VARIANTS:  # one kernel library a process
            subprocess.run([sys.executable, __file__, "--variant", name]
                           + (["--cva"] if cva else []), check=True)


if __name__ == "__main__":
    main()
