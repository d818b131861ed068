"""Device selection and numeric set-up.

TF32 is switched off for both matmuls and cuDNN: the Pi3 heads run in fp32
(reference ``models/pi3.py:235``) and the focal solver needs true fp32, and
cuDNN would otherwise run fp32 convolutions in TF32 by default.
"""

from __future__ import annotations

import torch


def select_device(name: str) -> torch.device:
    """Resolve a ``--device`` flag. ``cuda`` without a CUDA device raises:
    there is no quiet CPU fallback; ``cpu`` is the explicit CPU mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: no CUDA device is available (pass --device cpu "
                "for the explicit CPU mode)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
