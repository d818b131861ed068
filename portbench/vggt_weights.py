"""VGGT's random weights, drawn from the seed on the device.

``weights.draw`` keys its rules on Pi3's leaf names (LayerScale 0.01 only
under ``decoder.``, clipped normals under ``camera_head.``), which do not fit
VGGT's leaves. This draws VGGT's with rules of its own, in the same way (the
leaves grouped by how they are drawn, each group one flat buffer from a
``torch.Generator`` on the device, cut into views), as close to VGGT's init
as known:

* biases 0, norm scales 1, the camera head's empty pose encoding 0;
* LayerScale 0.01 in the aggregator's blocks and the camera head's trunk
  (VGGT's ``init_values``), 1 in DINOv2 (VGGT builds it with 1.0);
* the aggregator's camera and register tokens normal at std 1e-6 (VGGT's
  ``nn.init.normal_``), DINOv2's cls and register tokens uniform at 1e-6 (the
  port's DINOv2 init);
* convolutions uniform at the fan-in's std (a transposed convolution of
  stride = kernel sees its input channels once: fan-in = in channels);
* every other weight uniform at std 0.02 (the port's linear init).

The trunk (DINOv2, the aggregator's blocks and tokens) is rounded to the
configuration's compute dtype, the heads are drawn in float32: the types the
program serves them in. The same seed gives the same values on the same
device.
"""

from __future__ import annotations

import math
import re

import torch

from .weights import PIECE

TRUNK = ("encoder.", "frame_blocks.", "global_blocks.", "camera_token", "register_token")
TRANSPOSED = re.compile(r"_head\.resize_layers\.[01]\.weight$")


def leaf_rule(name: str, shape: tuple) -> tuple[str, float]:
    """(kind, value) of a VGGT leaf: ('const', v), ('uniform', std) or
    ('normal', std)."""
    parts = name.split(".")
    last, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if last in ("bias", "empty_pose_tokens"):
        return "const", 0.0
    if last == "weight" and "norm" in parent:
        return "const", 1.0
    if last in ("ls1", "ls2"):
        return "const", 1.0 if name.startswith("encoder.") else 0.01
    if last in ("camera_token", "register_token"):
        return "normal", 1e-6
    if last in ("cls_token", "register_tokens"):
        return "uniform", 1e-6
    if len(shape) == 4:
        fan_in = shape[0] if TRANSPOSED.search(name) else shape[1] * shape[2] * shape[3]
        return "uniform", fan_in ** -0.5
    return "uniform", 0.02


@torch.no_grad()
def draw(module: torch.nn.Module, seed: int, device, trunk_dtype: torch.dtype,
         out_dtype: torch.dtype | None = None) -> dict:
    """{name: tensor} for every parameter of ``module`` (a meta-device VGGT):
    drawn in float32 on ``device``, the trunk's leaves rounded to
    ``trunk_dtype``; handed over in ``out_dtype`` where given (the
    reference's float32), else each leaf in the type it was rounded to."""
    groups: dict = {}
    for name, p in module.named_parameters():
        dtype = trunk_dtype if name.startswith(TRUNK) else torch.float32
        key = leaf_rule(name, tuple(p.shape)) + (str(dtype),)
        groups.setdefault(key, (dtype, []))[1].append((name, tuple(p.shape)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = {}
    for key in sorted(groups):
        kind, value, _ = key
        dtype, leaves = groups[key]
        n = sum(math.prod(s) for _, s in leaves)
        buf = torch.empty(n, dtype=out_dtype or dtype, device=device)
        for at in range(0, n, PIECE):  # float32 staging of one piece at a time
            m = min(PIECE, n - at)
            if kind == "const":
                piece = torch.full((m,), value, dtype=torch.float32, device=device)
            elif kind == "uniform":
                piece = torch.rand(m, generator=gen, device=device).sub_(0.5).mul_(
                    value * 12**0.5)
            else:
                piece = torch.randn(m, generator=gen, device=device).mul_(value)
            buf[at:at + m] = piece.to(dtype)
        at = 0
        for name, shape in leaves:
            size = math.prod(shape)
            state[name] = buf[at:at + size].view(shape)
            at += size
    return state
