"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs ``pi3_slam_tpu_torch`` (never the JAX package) on the machine it is
started on, from the root of a checkout that holds ``BENCHMARK.json``. With
``--trace 0`` the last stdout line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the profiler's device busy time
and window, and the breakdown. The numbers compared with the plain reference
follow on stderr, each beside its limit, and under ``checks`` as the last
key of the result line. Exits 2 without a CUDA card (or with fewer than the
cell asks for), 3 if JAX or the JAX package was loaded; neither prints a
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, manifest  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = manifest.load_benchmark(ROOT)
    cell = manifest.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    for key, path in harness.cache_dirs(ROOT).items():
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              bench=bench, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    checks, line = harness.main_result_lines(result)
    sys.stderr.flush()
    print(checks, file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
