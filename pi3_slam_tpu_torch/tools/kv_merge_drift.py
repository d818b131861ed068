"""Synthetic drift proxy for --global-kv-merge.

    python -m pi3_slam_tpu_torch.tools.kv_merge_drift [--seeds 0 1 2] [--merges 2 4]
        [--frames 8 16] [--sharpen 1 8] [--full] [--ape] [--device cuda]

global_kv_merge merges m consecutive frames' k/v tokens in the decoder's
global attention (``models/pi3.py`` ``Pi3Config.global_kv_merge``;
FastVGGT-style). No real checkpoint is in the repository, so its accuracy
cost cannot be validated end to end, but the architecture-level distortion
can be bounded: run the same random-weight forward exact and merged on
video-like correlated frames and measure how far poses, pointmaps and
confidence move, across merge factors and chunk lengths.

With plain random weights the attention logits are near zero, softmax is
near-uniform, and averaging k/v groups under uniform attention is near-exact
by construction (drift ~1e-6 whatever the frame correlation). Trained models
have sharp attention, where merging bites, so the proxy sharpens the logits
by scaling the blocks' ``q_norm_scale`` by ``--sharpen`` (default sweep 1 and
8) and reports drift in both regimes; the sharpened numbers are the bound.

Every mode runs in float32 (as the JAX tool does) on ``--device``, the GPU
unless ``--device cpu``; without a GPU ``--device cuda`` raises. The default
is a tiny model (``TINY``'s widths: decoder heads of 32, which the port runs
on its plain attention route on the card too); ``--full`` is the full-width
Pi3 at 308x406, whose forwards run the fp32 entries of the hand-written
kernels (the kv-merge global blocks the partial-attention kernel). ``--ape``
runs the online pipeline per merge factor on the tiny model and reports the
trajectory APE against the exact run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..models.dinov2 import DinoV2Config
from ..models.pi3 import Pi3Config

# the JAX package's tiny test configuration (tests/test_pi3_model.py TINY)
TINY = Pi3Config(
    encoder=DinoV2Config(embed_dim=64, depth=2, num_heads=2, pos_embed_size=37),
    dec_embed_dim=64,
    dec_num_heads=2,
    dec_depth=4,
    num_register_tokens=5,
    head_dim=64,
    head_depth=2,
    head_num_heads=2,
    camera_dim=32,
)


def make_video_frames(rng, n, h, w):
    """Sliding crops of one smooth texture: consecutive frames are highly
    correlated, the regime the cross-frame kv merge assumes."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(2 * w), indexing="ij")
    base = 0.5 + 0.25 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    base = np.stack([base, np.roll(base, 3, axis=1), np.roll(base, 7, axis=0)], 0)
    base = base + 0.1 * rng.random((3, h, 2 * w))
    frames = [base[:, :, 3 * i : 3 * i + w] for i in range(n)]
    return np.clip(np.stack(frames)[None], 0.0, 1.0).astype(np.float32)


def sharpen_params(params, s: float):
    """Scale every ``q_norm_scale`` leaf of a parameter tree in the JAX layout
    (``models.convert.init_pi3_params``; ``q_norm.weight`` in the module) by
    s: logits scale by s, softmax sharpens, emulating trained attention's
    peakiness on random weights. Other leaves are shared, not copied."""
    if s == 1.0:
        return params

    def visit(node, key=None):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node * s if key == "q_norm_scale" else node

    return visit(params)


def drift_metrics(exact, merged):
    """Pose / pointmap / confidence drift between two forward outputs."""
    pe = np.asarray(exact["points"], np.float64)
    pm = np.asarray(merged["points"], np.float64)
    scene_scale = float(np.std(pe)) + 1e-12
    point_rel = float(np.median(np.linalg.norm(pm - pe, axis=-1)) / scene_scale)

    Te = np.asarray(exact["camera_poses"], np.float64)[0]
    Tm = np.asarray(merged["camera_poses"], np.float64)[0]
    t_scale = float(np.median(np.linalg.norm(Te[:, :3, 3], axis=-1))) + 1e-12
    trans_rel = float(
        np.median(np.linalg.norm(Tm[:, :3, 3] - Te[:, :3, 3], axis=-1)) / t_scale
    )
    R_rel = np.einsum("nij,nkj->nik", Tm[:, :3, :3], Te[:, :3, :3])
    cos = np.clip((np.trace(R_rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_deg = float(np.median(np.degrees(np.arccos(cos))))

    ce = 1.0 / (1.0 + np.exp(-np.asarray(exact["conf"], np.float64)))
    cm = 1.0 / (1.0 + np.exp(-np.asarray(merged["conf"], np.float64)))
    conf_mad = float(np.mean(np.abs(cm - ce)))
    return {"point_rel": point_rel, "trans_rel": trans_rel,
            "rot_deg": rot_deg, "conf_mad": conf_mad}


def build_model(params, cfg: Pi3Config, device):
    """The float32 Pi3 of a JAX-layout parameter tree on ``device``."""
    import torch

    from ..models.convert import build_pi3, pi3_state_from_jax

    return build_pi3(cfg, pi3_state_from_jax(params), torch.device(device), torch.float32)


def forward(model, imgs: np.ndarray, merge: int = 1) -> dict:
    """One forward of (1, N, 3, H, W) images at global kv-merge ``merge``;
    its outputs as float32 numpy arrays."""
    import torch

    model.cfg = dataclasses.replace(model.cfg, global_kv_merge=merge)
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.from_numpy(imgs).to(dev))
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def drift_rows(make_params, cfg: Pi3Config, hw, seeds, sharpens, frames, merges, device,
               quiet=False) -> list:
    """Exact against merged forwards for every seed, sharpening, frame count
    and merge factor that divides it (the JAX tool's loop and its draws of
    the frames); one row of ``drift_metrics`` each."""
    h, w = hw
    rows = []
    for seed in seeds:
        base_params = make_params(seed)
        rng = np.random.default_rng(1000 + seed)
        for sharpen in sharpens:
            model = build_model(sharpen_params(base_params, sharpen), cfg, device)
            for n in frames:
                imgs = make_video_frames(rng, n, h, w)
                exact = forward(model, imgs)
                for m in merges:
                    if n % m:
                        continue
                    r = {"seed": seed, "sharpen": sharpen, "frames": n, "merge": m,
                         **drift_metrics(exact, forward(model, imgs, m))}
                    rows.append(r)
                    if not quiet:
                        print(f"seed {seed} sharpen {sharpen:g} N={n:3d} m={m}: "
                              f"point_rel {r['point_rel']:.4f}  "
                              f"trans_rel {r['trans_rel']:.4f}  rot {r['rot_deg']:.3f} deg  "
                              f"conf_mad {r['conf_mad']:.4f}", flush=True)
            del model
    return rows


def ape_bridge(merges=(2, 4), sharpen=8.0, seed=0, n_frames=16,
               chunk_length=8, overlap=3, workdir=None, quiet=False, device="cuda"):
    """Task-level bridge: forward drift -> trajectory APE.

    Runs the online pipeline (Pi3SLAMOnline: chunk steps, per-chunk BA, the
    Sim3 alignment chain) on the same correlated video-like frames with
    global_kv_merge in {1, *merges} and identical sharpened tiny random
    weights (written as a checkpoint with TINY's config, run in float32),
    then scores each merged trajectory against the exact (merge=1) one with
    the Sim3-aligned APE of the eval scripts. Point and rotation drift are
    the mechanism; APE is what users of --global-kv-merge pay. Returns a list
    of {merge, sharpen, seed, ape_m, ape_rel_span} rows (span = the exact
    trajectory's path length). These numbers bound the architecture-level
    task impact only (see the module docstring).
    """
    import shutil
    import tempfile

    from PIL import Image

    from ..models.convert import init_pi3_params, save_pi3_checkpoint
    from ..slam.config import OnlineConfig
    from ..slam.online import Pi3SLAMOnline
    from ..utils.evaluation import ape_translation

    h, w = 42, 56
    rng = np.random.default_rng(1000 + seed)
    frames = make_video_frames(rng, n_frames, h, w)[0]  # (N, 3, h, w)

    work = workdir or tempfile.mkdtemp(prefix="kv_ape_")
    ckpt = os.path.join(work, "pi3_tiny_sharpened.npz")
    save_pi3_checkpoint(ckpt, sharpen_params(init_pi3_params(seed, TINY), sharpen), TINY)
    img_dir = os.path.join(work, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(img_dir, f"frame_{i:04d}.png")
        Image.fromarray(
            (f.transpose(1, 2, 0) * 255).clip(0, 255).astype(np.uint8)
        ).save(p)
        paths.append(p)

    trajs = {}
    for m in [1] + [m for m in merges if m != 1]:
        cfg = OnlineConfig(
            chunk_length=chunk_length, overlap=overlap, pixel_limit=h * w, device=device,
            checkpoint_path=ckpt, use_metric_depth=False, max_keypoints=32,
            compute_dtype="float32", output_dir=os.path.join(work, f"out_m{m}"),
            global_kv_merge=m,
        )
        slam = Pi3SLAMOnline(cfg)
        slam.process_image_paths(paths)
        trajs[m] = slam._merged_trajectory()[0]

    exact = trajs[1]
    span = float(np.linalg.norm(np.diff(exact, axis=0), axis=1).sum()) + 1e-12
    rows = []
    for m in merges:
        ape = ape_translation(exact, trajs[m], align_sim3=True)
        rows.append({
            "merge": int(m), "sharpen": float(sharpen), "seed": int(seed),
            "ape_m": float(ape.rmse), "ape_rel_span": float(ape.rmse / span),
        })
        if not quiet:
            print(f"kv-merge m={m} sharpen {sharpen:g}: APE-vs-exact "
                  f"{ape.rmse:.5f} (span {span:.3f}, rel {ape.rmse / span:.4f})",
                  flush=True)
    if workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--merges", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--frames", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--sharpen", type=float, nargs="+", default=[1.0, 8.0])
    ap.add_argument("--full", action="store_true",
                    help="the full-width Pi3 at 308x406")
    ap.add_argument("--ape", action="store_true",
                    help="task-level bridge: run the online pipeline per "
                         "merge factor and report trajectory APE vs exact")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def run(argv=None, make_params=None) -> list:
    """Parse ``argv``, run the drift (or ``--ape``) sweep, print its lines and
    the JSON rows, and return the rows. ``make_params(seed)`` gives the
    parameter tree of a seed (default: ``init_pi3_params(seed, cfg)``)."""
    args = build_parser().parse_args(argv)

    from ..device import select_device

    device = select_device(args.device)
    if args.ape:
        rows = []
        for seed in args.seeds:
            for s in args.sharpen:
                rows += ape_bridge(merges=args.merges, sharpen=s, seed=seed, device=args.device)
        print("\n=== APE-vs-exact median over seeds ===")
        for s in args.sharpen:
            for m in args.merges:
                sel = [r for r in rows if r["merge"] == m and r["sharpen"] == s]
                if sel:
                    print(f"sharpen {s:g} m={m}: APE "
                          f"{np.median([r['ape_m'] for r in sel]):.5f}  "
                          f"rel-span {np.median([r['ape_rel_span'] for r in sel]):.4f}")
        print(json.dumps(rows))
        return rows

    from ..models.convert import init_pi3_params

    cfg, hw = (Pi3Config(), (308, 406)) if args.full else (TINY, (42, 56))
    rows = drift_rows(make_params or (lambda s: init_pi3_params(s, cfg)), cfg, hw, args.seeds,
                      args.sharpen, args.frames, args.merges, device)

    print("\n=== median over seeds ===")
    for sharpen in args.sharpen:
        for n in args.frames:
            for m in args.merges:
                sel = [r for r in rows
                       if r["frames"] == n and r["merge"] == m
                       and r["sharpen"] == sharpen]
                if not sel:
                    continue
                med = {k: float(np.median([r[k] for r in sel]))
                       for k in ("point_rel", "trans_rel", "rot_deg", "conf_mad")}
                print(f"sharpen {sharpen:g} N={n:3d} m={m}: "
                      f"point_rel {med['point_rel']:.4f}  "
                      f"trans_rel {med['trans_rel']:.4f}  rot {med['rot_deg']:.3f} deg  "
                      f"conf_mad {med['conf_mad']:.4f}")
    print(json.dumps(rows))
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
