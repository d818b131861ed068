"""Phase 14 of chip_smoke.py over four distinct cards.

chip_smoke.py runs its multi-device phase over meshes whose devices repeat
one card. This script runs the same phase over cuda:0-3, so that devices no
longer repeat: peer copies between cards, and dp replicas launching from
threads of their own on distinct cards. Before it, the kernels' build and
phase 4's metric-depth run (the reference chunks of (d)). Each sharded
forward and the whole ring are timed on the host clock between
synchronisations of every card. On a machine with four GPUs:

    python3 multi_card_check.py

It prints the path's launch counts and the kernels' sub-rows as one JSON
line, then {"ok": true, "device": {...}}; with fewer than four GPUs it exits
non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import chip_smoke as smoke


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("multi_card_check.py needs four GPUs", file=sys.stderr)
        return 1
    from pi3_slam_tpu_torch.device import select_device
    from pi3_slam_tpu_torch.models.convert import init_moge_params, moge_vits_config, save_params_npz

    select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    smoke.log(smi)
    t0 = time.perf_counter()
    smoke.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        smoke.write_frames(frames)
        moge = os.path.join(tmp, "moge_random.npz")
        save_params_npz(moge, init_moge_params(0, moge_vits_config()))
        smoke.run_cli("metric_depth", frames, os.path.join(tmp, "metric"), ["--moge-path", moge])
        smoke.log(f"[14] multi-device over four cards  [t={time.perf_counter() - t0:.1f}s]")
        counts, rows = smoke.phase_multidevice(tmp, [torch.device("cuda", i) for i in range(4)])
    smoke.log(f"done  [t={time.perf_counter() - t0:.1f}s]")
    print(json.dumps({"multidevice": counts, "multidevice_shapes": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
