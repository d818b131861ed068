"""Read ``.safetensors`` files without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping each
tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end,
relative to the first byte after the header; an optional ``__metadata__``
entry), then the raw little-endian bytes. The reference Pi3 checkpoint is a
``model.safetensors`` file.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Dict

import numpy as np

# safetensors dtype -> the little-endian numpy type its bytes are read as
_STORED = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of ``path`` as a float32 numpy array, by name.

    F32 tensors are read-only memory maps of the file (no copy); F16 and BF16
    ones are widened to float32 (a bfloat16 is the top half of a float32's
    bits, so the widening is exact). Any other dtype raises, naming it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    start = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        dtype, shape = info["dtype"], tuple(info["shape"])
        if dtype not in _STORED:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}; only F32, F16 and "
                             "BF16 are read")
        begin, end = info["data_offsets"]
        stored = np.dtype(_STORED[dtype])
        if end - begin != math.prod(shape) * stored.itemsize:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} spans {end - begin} bytes")
        if not math.prod(shape):
            out[name] = np.zeros(shape, np.float32)
            continue
        raw = np.memmap(path, dtype=stored, mode="r", offset=start + begin, shape=shape)
        if dtype == "F32":
            out[name] = raw
        elif dtype == "F16":
            out[name] = raw.astype(np.float32)
        else:
            out[name] = (raw.astype(np.uint32) << 16).view(np.float32)
    return out
