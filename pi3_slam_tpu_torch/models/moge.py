"""MoGe-2 metric monocular depth: the runner the chunk creator calls.

Port of ``pi3_slam_tpu/models/moge.py``. The pipeline uses MoGe only for
metric-scale recovery: depth on a chunk's first frame, then the median MoGe /
Pi3 depth ratio (``slam/chunk_creator.py``). On a chunk-dp mesh
(:meth:`MoGeRunner.shard_params`) :meth:`MoGeRunner.infer_depth_batch_async`
runs each chunk's first frame on its dp replica's device, as the JAX runner
shards the batch over dp with replicated weights: no collectives, one
single-device forward a frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import span
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
        # (device, model) of each dp replica; one on the runner's device
        # until shard_params lays the replicas over a mesh
        self._replicas = [(device, self.model)]

    def shard_params(self, mesh) -> None:
        """Replicate the model over the mesh's dp axis, one replica on each dp
        index's first device (sharing the weights where that is the runner's
        device), for :meth:`infer_depth_batch_async`."""
        from ..parallel import replicate

        devices = [mesh.device(dp=i) for i in range(mesh.axis_size("dp"))]
        self._replicas = [(d, replicate(self.model, d)) for d in devices]

    @torch.no_grad()
    def infer_depth_async(self, image) -> torch.Tensor:
        """Enqueue depth inference on the current stream and return the (H, W)
        device tensor without waiting for it (the creator queues it right
        behind the Pi3 chunk step)."""
        with span("moge.forward"):
            img = torch.as_tensor(image).to(self.device, non_blocking=True)
            if img.dtype == torch.uint8:  # raw bytes from the loader
                img = img.float() / 255.0
            return moge_infer_depth(self.model, img)

    def infer_depth_batch_async(self, images) -> list[torch.Tensor]:
        """Depth of B first frames ((B, 3, H, W), or a sequence of (3, H, W)):
        frame b on dp replica b // (B / dp) (every frame on the first where dp
        does not divide B), replicas on distinct devices from threads of their
        own. Returns the B (H, W) depth tensors, each on its replica's device,
        without waiting for them."""
        from ..parallel import run_on_devices

        n, dp = len(images), len(self._replicas)
        per = n // dp if n % dp == 0 else n

        def job(b):
            dev, model = self._replicas[b // per]
            img = torch.as_tensor(images[b]).to(dev, non_blocking=True)
            if img.dtype == torch.uint8:
                img = img.float() / 255.0
            with torch.no_grad():
                return moge_infer_depth(model, img)

        with span("moge.forward"):
            return run_on_devices([(self._replicas[b // per][0], lambda b=b: job(b))
                                   for b in range(n)])

    def infer_depth(self, image) -> np.ndarray:
        return self.infer_depth_async(image).cpu().numpy()
