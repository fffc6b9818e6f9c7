"""Run one cell of the benchmark on the card and print its result line.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run makes the
sequence from the seed, builds or loads the port's kernels, runs the
set-up frames, measures for ``--seconds``, checks the answers against the
plain reference and prints one JSON object as the last line of standard
output (each compared number and its limit are the last lines of standard
error). Without a CUDA device it exits with an error and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "slam_bench", "_cache")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # every compile cache a library could use, at fixed paths in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    from slam_bench import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                                  t_process=T_PROCESS)
    except harness.BenchError as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_loaded()
    if found:
        print(f"slam_bench: the run's process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
