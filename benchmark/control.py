"""The readings that the limits of ``check.py`` are set from, for one cell
on several seeds in one process: the program's numbers (its sound runs,
the lower readings) and, on the same sampled keyframes, the numbers of the
control, the plain reference in a lower precision put in the program's
place (the upper readings). The benchmark's own runs never run this.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 --seconds 8 \\
        [--precisions tf32,bf16]

Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--precisions", default="tf32,bf16")
    args = ap.parse_args(argv)

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.run_cell(cell, seed, args.seconds, False, "cuda")
        row = {"seed": seed, "frames": ctx["window"].fed, "keyframes": len(ctx["n_updates"]),
               "sampled": sorted(ctx["outputs"]), "check_s": ctx["check_s"],
               "program": ctx["numbers"]}
        for precision in args.precisions.split(","):
            t0 = time.perf_counter()
            row[precision] = harness.control_readings(cell, ctx, precision)
            row[precision + "_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
