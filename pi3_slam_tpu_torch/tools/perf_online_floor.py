"""Cost of the online mode's SfM chain at eval scale, its stages alone.

    python -m pi3_slam_tpu_torch.tools.perf_online_floor [--chunks 5] [--frames-per 100]
        [--kp 400] [--overlap 20] [--device cuda]

The online loop's steady period is max(device forward + pull, build,
finish), where build is the pull and the per-chunk BA reconstruction and
finish the Sim3 alignment with its refine BA. The port's online driver runs
both on the card (``OnlineConfig.sfm_backend='auto'``; ``'cpu'`` puts them
on the host), so this probe runs them on ``--device`` (the card unless
``--device cpu``) alone: no pipeline, no forward, no contention, at the
eval-scale shapes (chunks of 100, overlap 20, 400 keypoints; reference
``scripts/eval_7scenes.sh:59-181``). It prints one JSON line with the JAX
tool's keys (its metric named ``online_sfm_chain_floor``: the chain is not
pinned to the host CPU here):

  * per-chunk reconstruction (``build_chunk_reconstruction``, 10 BA
    iterations) and alignment (``align_chunks``, 50 refine iterations)
    seconds; chunk 0 stays out of the steady medians (on the card it
    carries the first calls' warm-up);
  * the BA iterations each solve ran (``sfm.ba.last_ba_info``): whether the
    early stop fires at eval scale;
  * the steady FPS ceilings the chain allows: new frames a chunk over
    max(recon, align) when build and finish overlap
    (``fps_ceiling_two_stage``), and over recon + align when they run in
    series (``fps_ceiling_single_core``): on one card the two stages'
    kernels share the device, so the series bound is the one to expect.

The chunks come from the eval-scale synthetic scene of the system APE gates
(``tools/synthetic.py``) with confidence-correlated outliers, the error
structure the pruning works against. Without a GPU ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--frames-per", type=int, default=100)
    ap.add_argument("--kp", type=int, default=400)
    ap.add_argument("--overlap", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, time the stages, print the JSON line and return it."""
    args = build_parser().parse_args(argv)
    if args.chunks < 3:
        raise SystemExit("--chunks must be >= 3 (chunk 0 carries the warm-up and is excluded "
                         "from the steady medians)")

    from ..device import select_device
    from ..sfm.alignment import align_chunks
    from ..sfm.ba import last_ba_info
    from ..sfm.reconstruction import build_chunk_reconstruction
    from ..slam.offline_reconstructor import load_chunk_npz
    from .synthetic import EVAL_SCALE, write_synthetic_chunks

    device = select_device(args.device)
    stride = args.frames_per - args.overlap
    n_frames = stride * (args.chunks - 1) + args.frames_per
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as td:
        # the scene parameters of the eval-scale system APE gate
        write_synthetic_chunks(
            td, rng, **dict(EVAL_SCALE, n_frames=n_frames, chunk_length=args.frames_per,
                            overlap=args.overlap, n_kp=args.kp))
        paths = sorted(glob.glob(os.path.join(td, "chunks", "*.npz")))
        recon_s, align_s, ba_iters = [], [], []
        prev = None
        for p in paths:
            chunk = load_chunk_npz(p)
            t0 = time.perf_counter()
            recon = build_chunk_reconstruction(chunk, device=device)
            recon_s.append(time.perf_counter() - t0)
            info = last_ba_info()
            ba_iters.append(info["iterations"] if info else None)
            if prev is not None:
                t0 = time.perf_counter()
                align_chunks(prev, recon, device=device)
                align_s.append(time.perf_counter() - t0)
            prev = recon

    steady_recon = float(np.median(recon_s[1:]))
    steady_align = float(np.median(align_s[1:]))
    result = {
        "metric": "online_sfm_chain_floor",
        "recon_s_per_chunk": [round(s, 4) for s in recon_s],
        "align_s_per_chunk": [round(s, 4) for s in align_s],
        "ba_iterations": ba_iters,
        "ba_max_iterations": 10,
        "steady_recon_s": round(steady_recon, 4),
        "steady_align_s": round(steady_align, 4),
        "new_frames_per_chunk": stride,
        "fps_ceiling_two_stage": round(stride / max(steady_recon, steady_align), 2),
        "fps_ceiling_single_core": round(stride / (steady_recon + steady_align), 2),
    }
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
