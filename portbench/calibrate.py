"""The readings a cell's correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... [--control-seeds 1 2 3]
        [--seconds 0.5]

For each seed one short run of the cell (set-up, the window, the check of a
chunk against the plain fp32 reference, ``harness.run_cell``) prints the
program's numbers; for each control seed the control, the reference itself
in the next precision below the configuration's (the trunk's products on
float8 e4m3 operands, the fp32 parts in TF32), is compared with the fp32
reference on the same chunk and prints its numbers. One JSON line each,
``{"seed", "side": "program" | "control", "numbers"}``. The benchmark's own
runs never run the control. Every run is in one process, so the kernels
load once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    import torch

    from portbench.reference.pi3 import Precision

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load_benchmark(ROOT)
    cell = manifest.workload(bench, args.workload)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    family = manifest.family(config["family"])
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        keep = {}
        result = harness.run_cell(args.workload, seed, args.seconds, False, bench=bench,
                                  keep=keep)
        record, _, ref = keep["checked"][0]
        if seed in args.seeds:
            nums = {k: v["value"] for k, v in result["checks"].items()}
            print(json.dumps({"seed": seed, "side": "program", "numbers": nums}), flush=True)
        if seed in args.control_seeds:
            control = family.reference_chunk(config, traffic, seed, record["paths"],
                                             torch.device("cuda"), Precision(fp8=True))
            nums = family.compare(control, ref)
            print(json.dumps({"seed": seed, "side": "control", "numbers": nums}), flush=True)
        del keep, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
