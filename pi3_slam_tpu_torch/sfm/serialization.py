"""Reconstruction containers on disk (``--save-per-chunk``) and the
reprojection-debug GIFs (``--save-debug-projections``).

Port of ``pi3_slam_tpu/sfm/serialization.py``: ``save_reconstruction`` /
``load_reconstruction`` write and read the same npz keys, so either package
reads the other's files; ``render_debug_projections`` draws the same frames.
Its numeric part, :func:`debug_projection_data` (the tracks picked, observed
and reprojected pixels, per-observation errors from ``sfm/ba`` on the
``device`` given), is callable on its own, without matplotlib.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..device import select_device
from .ba import reprojection_errors
from .reconstruction import ChunkReconstruction

_ARRAYS = ("rotations", "centers", "intrinsics", "points", "colors", "track_frame", "track_kp",
           "track_uv", "track_valid", "obs_frame", "obs_uv", "obs_valid")


def save_reconstruction(recon: ChunkReconstruction, path: str) -> None:
    """Write a ChunkReconstruction to a compressed .npz."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, frame_names=np.asarray(recon.frame_names),
                        image_width=recon.image_width, image_height=recon.image_height,
                        **{k: getattr(recon, k) for k in _ARRAYS})


def load_reconstruction(path: str) -> ChunkReconstruction:
    with np.load(path, allow_pickle=False) as z:
        return ChunkReconstruction(
            frame_names=[str(n) for n in z["frame_names"]],
            image_width=int(z["image_width"]),
            image_height=int(z["image_height"]),
            **{k: z[k] for k in _ARRAYS},
        )


def debug_projection_data(recon: ChunkReconstruction, num_frames: int, max_tracks: int = 200,
                          device="cuda") -> List[Dict]:
    """Per frame of the first ``num_frames``: the observations of up to
    ``max_tracks`` live tracks (picked with ``np.random.default_rng(0)`` as the
    JAX function picks them) as 'rows' / 'cols' into the observation table,
    'observed' and 'reprojected' pixels (N, 2), 'errors' (N,) from
    ``reprojection_errors`` on ``device`` (inf where invalid or behind the
    camera) and the frame's 'title'. ``device="cpu"`` is the explicit CPU
    mode; ``cuda`` without a GPU raises."""
    dev = select_device(str(device))
    err = reprojection_errors(recon.to_problem(device=dev)).cpu().numpy()
    rng = np.random.default_rng(0)
    track_sel = np.nonzero(recon.track_valid > 0)[0]
    if track_sel.size > max_tracks:
        track_sel = rng.choice(track_sel, max_tracks, replace=False)
    sel_mask = np.zeros(recon.num_tracks, bool)
    sel_mask[track_sel] = True
    frames = []
    for f in range(num_frames):
        rows, cols = np.nonzero((recon.obs_frame == f) & (recon.obs_valid > 0) & sel_mask[:, None])
        R, c = recon.rotations[f], recon.centers[f]
        fx, fy, cx, cy = recon.intrinsics[f]
        xc = (recon.points[rows] - c) @ R.T
        z = np.maximum(xc[:, 2], 1e-9)
        e = err[rows, cols]
        finite = np.isfinite(e)
        title = (f"frame {f} ({recon.frame_names[f]}) mean reproj {e[finite].mean():.2f}px"
                 if finite.any() else f"frame {f}")
        frames.append({"rows": rows, "cols": cols, "observed": recon.obs_uv[rows, cols],
                       "reprojected": np.stack([fx * xc[:, 0] / z + cx, fy * xc[:, 1] / z + cy],
                                               axis=1),
                       "errors": e, "title": title})
    return frames


def render_debug_projections(recon: ChunkReconstruction, images: np.ndarray, out_path: str,
                             max_tracks: int = 200, fps: int = 1, device="cuda") -> None:
    """Reprojection-debug frames: each of ``images`` ((N, 3, H, W) float in
    [0, 1]) with the observed keypoints of the picked tracks (green), their
    reprojections (red) and the error segments between them (yellow), drawn
    with matplotlib's Agg backend and saved as an animated GIF through PIL.
    Raises ImportError without matplotlib (``Pi3SLAMOnline`` prints it and
    runs on)."""
    import io

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    frames = []
    for f, d in enumerate(debug_projection_data(recon, min(len(images), recon.num_frames),
                                                max_tracks, device)):
        fig, ax = plt.subplots(figsize=(6, 4.5), dpi=100)
        ax.imshow(np.clip(images[f].transpose(1, 2, 0), 0, 1))
        obs, proj = d["observed"], d["reprojected"]
        ax.scatter(obs[:, 0], obs[:, 1], s=6, c="lime", label="observed")
        ax.scatter(proj[:, 0], proj[:, 1], s=6, c="red", label="reprojected")
        for o, p in zip(obs, proj):
            ax.plot([o[0], p[0]], [o[1], p[1]], c="yellow", lw=0.5, alpha=0.6)
        ax.set_title(d["title"])
        ax.legend(loc="upper right", fontsize=7)
        ax.set_xlim(0, recon.image_width)
        ax.set_ylim(recon.image_height, 0)
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        plt.close(fig)
        buf.seek(0)
        frames.append(Image.open(buf).convert("RGB"))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    if frames:
        frames[0].save(out_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / max(fps, 1)), loop=0)
