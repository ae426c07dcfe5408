"""Run one cell of the benchmark of ``mumpy_tpu_torch`` and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (with ``--trace 0`` the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with the
reference beside its limit, which also close standard error.  Exit codes: 0
a result was printed (``correct`` may be false); 2 bad arguments; 3 no card,
too few cards, or the program cannot be imported; 4 JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux), else now."""
    try:
        ticks = os.sysconf(os.sysconf_names["SC_CLK_TCK"])
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, KeyError, IndexError):
        return time.time()


STARTED = _process_start()
HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# the program's kernel and compile caches: fixed directories inside the checkout
BUILD = REPO / "build"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "mumpy_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(REPO)]
    import json

    import torch

    import harness

    bench = harness.Bench(REPO)
    cell = bench.cell(args.workload)
    try:
        import mumpy_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program cannot be imported: {e}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
            "power_limit_w": power_limit_w()}
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              device, lambda: time.time() - STARTED, info)
    found = forbidden_modules()
    if found:
        print(f"run.py: loaded after the window: {found}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit_w():
    """The card's power limit in watts, from ``nvidia-smi``, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


if __name__ == "__main__":
    sys.exit(main())
