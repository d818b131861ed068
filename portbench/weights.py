"""Random weights drawn from the seed on the device, in a few large calls.

The leaves of a model are enumerated from the reference's modules (which
carry the port's parameter names), grouped by how they are drawn, and each
group is drawn as one flat buffer with a ``torch.Generator`` on the device
and cut into views. The distributions are those of the port's seeded init
(``models/convert.init_pi3_params`` / ``init_moge_params``): weights uniform
with a stated std, the camera head's clipped normals, zero biases, unit
norms, LayerScale 0.01 in Pi3's decoder. The same seed gives the same
values on the same device, so the reference draws the program's weights
again after the window instead of holding a copy through it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# elements drawn in one call: 256 MB of float32 staging at most
PIECE = 1 << 26


def leaf_rule(name: str, shape: tuple) -> tuple[str, float]:
    """(kind, value) of a leaf: ('const', v), ('uniform', std) or
    ('clipped_normal', std)."""
    last = name.rsplit(".", 1)[-1]
    parent = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if last == "bias":
        return "const", 0.0
    if last == "weight" and "norm" in parent:
        return "const", 1.0
    if last in ("ls1", "ls2"):
        return "const", 0.01 if name.startswith("decoder.") else 1.0
    if last in ("cls_token", "register_tokens", "register_token"):
        return "uniform", 1e-6
    if name.startswith("camera_head."):
        return "clipped_normal", 0.02
    if len(shape) == 4:  # a convolution: fan-in scaled
        return "uniform", (shape[1] * shape[2] * shape[3]) ** -0.5
    if name.startswith("scale_head."):
        return "uniform", shape[1] ** -0.5
    return "uniform", 0.02


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one of a run's random streams."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def draw(module: torch.nn.Module, seed: int, device, dtype: torch.dtype,
         out_dtype: torch.dtype | None = None) -> dict:
    """{name: tensor} for every parameter of ``module`` (a meta-device
    module): drawn in float32 on ``device`` a piece at a time, rounded to
    ``dtype`` (the type the weights are served in) and handed over in
    ``out_dtype`` (default ``dtype``)."""
    out_dtype = out_dtype or dtype
    groups: dict = {}
    for name, p in module.named_parameters():
        groups.setdefault(leaf_rule(name, tuple(p.shape)), []).append((name, tuple(p.shape)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = {}
    for (kind, value) in sorted(groups):
        leaves = groups[(kind, value)]
        n = sum(math.prod(s) for _, s in leaves)
        buf = torch.empty(n, dtype=out_dtype, device=device)
        for at in range(0, n, PIECE):  # float32 staging of one piece at a time
            m = min(PIECE, n - at)
            if kind == "const":
                piece = torch.full((m,), value, dtype=torch.float32, device=device)
            elif kind == "uniform":
                piece = torch.rand(m, generator=gen, device=device).sub_(0.5).mul_(
                    value * 12**0.5)
            else:
                piece = torch.randn(m, generator=gen, device=device).clamp_(-2.0, 2.0).mul_(value)
            buf[at:at + m] = piece.to(dtype)
        at = 0
        for name, shape in leaves:
            size = math.prod(shape)
            state[name] = buf[at:at + size].view(shape)
            at += size
    return state
