"""Run one cell of ``BENCHMARK.json`` once on one NVIDIA GPU:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, last, ``checks`` (each number compared, with its limit);
the same numbers are the last lines of standard error. Exits non-zero and
prints no result without a CUDA device, or when JAX or the JAX package was
loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the program's own kernels build into build/torch_kernels
    beside its package)."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    import torch

    from benchmark import harness, stats, views

    cell = harness.load_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    ctx = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    out = harness.result(ctx, bool(args.trace))
    bad = harness.forbidden_modules()   # after the metric readers have loaded
    if bad:
        print(f"modules loaded that the port must not load: {', '.join(bad)}", file=sys.stderr)
        return 3
    win = ctx["window"]
    print(f"{args.workload} seed {args.seed}: set-up {ctx['setup_s']:.3f} s, window "
          f"{win.fed} frames, check {ctx['check_s']:.3f} s", file=sys.stderr)
    if win.due:
        late = views.late_ms(win)
        print(f"generator late: median {stats.percentile(late, 50):.4f} ms, max "
              f"{max(late):.4f} ms", file=sys.stderr)
        lat = views.latencies_ms(win)
        print("latency ms: " + ", ".join(f"p{q} {stats.percentile(lat, q)!r}"
                                         for q in (50, 90, 95, 98, 99)), file=sys.stderr)
    for name, row in out["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
