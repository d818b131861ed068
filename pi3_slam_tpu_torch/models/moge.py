"""MoGe-2 metric monocular depth: the runner the chunk creator calls.

Port of the single-device part of ``pi3_slam_tpu/models/moge.py``. The
pipeline uses MoGe only for metric-scale recovery: depth on a chunk's first
frame, then the median MoGe / Pi3 depth ratio (``slam/chunk_creator.py``).
The batched chunk-dp path (``shard_params``, ``infer_depth_batch_async``)
waits for the multi-device port (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from .convert import build_moge, load_moge_checkpoint, moge_state_from_jax
from .moge_model import moge_infer_depth

# the JAX runner's message for a checkpoint that was not given; the creator
# prints it and runs on without metric depth
MISSING_CHECKPOINT = (
    "MoGe checkpoint not provided (convert with tools/convert_checkpoint.py --model moge); "
    "pipeline continues without metric depth"
)


class MoGeRunner:
    """infer_depth((3, H, W) float in [0, 1], or uint8) -> (H, W) metric depth,
    inf outside MoGe's validity mask.

    Everything runs in fp32, as the JAX runner computes it
    (``compute_dtype=jnp.float32``): on the GPU the encoder blocks through the
    fp32 entries of the hand-written kernels (see ``moge_model.py``)."""

    def __init__(self, checkpoint_path: str | None, device: torch.device):
        if checkpoint_path is None:
            raise FileNotFoundError(MISSING_CHECKPOINT)
        tree, self.cfg = load_moge_checkpoint(checkpoint_path)
        self.model = build_moge(self.cfg, moge_state_from_jax(tree), device, torch.float32)
        self.device = device

    @torch.no_grad()
    def infer_depth_async(self, image) -> torch.Tensor:
        """Enqueue depth inference on the current stream and return the (H, W)
        device tensor without waiting for it (the creator queues it right
        behind the Pi3 chunk step)."""
        img = torch.as_tensor(image).to(self.device, non_blocking=True)
        if img.dtype == torch.uint8:  # raw bytes from the loader
            img = img.float() / 255.0
        return moge_infer_depth(self.model, img)

    def infer_depth(self, image) -> np.ndarray:
        return self.infer_depth_async(image).cpu().numpy()
