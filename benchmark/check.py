"""Readings that set a cell's limits: the program on many seeds, the control
(the reference in a lower precision, in the program's place) and the planted
faults, each held against the float32 reference at the cell's own size, in
one process.

    python3 benchmark/check.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault half_batch --fault-seeds 7,8,9]

Prints one JSON line a reading: {"what", "seed", "numbers", "s" (seconds),
"peak_gib" (the card's allocated peak over the reading, the reference's
included)}.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _seeds(s):
    return [int(x) for x in s.split(",")] if s else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    import compare
    import faults
    import harness

    if not torch.cuda.is_available():
        print("check.py: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    bench = harness.Bench(HERE.parent)
    cell = bench.cell(args.workload)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    drive = harness.KINDS[mix["kind"]]

    def say(what, seed, numbers, t0, detail=None):
        line = {"what": what, "seed": seed, "numbers": numbers, "s": round(time.time() - t0, 1),
                "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        torch.cuda.reset_peak_memory_stats(device)
        if detail is not None:  # training: the leaves with the widest gaps
            line["worst"] = compare.worst_leaves(detail["got"], detail["ref"])
        print(json.dumps(line), flush=True)

    for seed in _seeds(args.seeds):
        t0 = time.time()
        run = drive(cell, cfg, mix, seed, 0.0, False, device, lambda: 0.0)
        say("program", seed, run.numbers, t0, run.detail)
    for seed in _seeds(args.control_seeds):
        t0 = time.time()
        if mix["kind"] == "serve":
            say("control:fp8", seed, faults.serve_control(cell, cfg, mix, seed, device), t0)
        else:
            got, ref = faults.train_control(cell, cfg, mix, seed, device)
            say("control:fp8", seed, compare.train_numbers(got, ref), t0,
                {"got": got, "ref": ref})
    for fault in args.fault:
        for seed in _seeds(args.fault_seeds):
            t0 = time.time()
            with faults.FAULTS[fault]():
                run = drive(cell, cfg, mix, seed, 0.0, False, device, lambda: 0.0)
            say(f"fault:{fault}", seed, run.numbers, t0, run.detail)
    return 0


if __name__ == "__main__":
    sys.exit(main())
