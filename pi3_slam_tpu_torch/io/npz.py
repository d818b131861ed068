"""Chunk-file (npz) writing with a selectable compression level.

Port of ``pi3_slam_tpu/io/npz.py`` (that package's ``io/__init__`` pulls in
JAX). ``default`` is zlib 6 (``np.savez_compressed``), ``fast`` zlib 1,
``none`` STORED; ``np.load`` reads all three identically.
"""

from __future__ import annotations

import zipfile

import numpy as np

_MODES = ("default", "fast", "none")


def save_npz(path: str, compression: str = "default", **arrays) -> None:
    """Write ``arrays`` to ``path`` as an npz with the given compression."""
    if compression not in _MODES:
        raise ValueError(f"compression must be one of {_MODES}, got {compression!r}")
    if compression == "default":
        np.savez_compressed(path, **arrays)
        return
    method = zipfile.ZIP_STORED if compression == "none" else zipfile.ZIP_DEFLATED
    kwargs = {} if compression == "none" else {"compresslevel": 1}
    with zipfile.ZipFile(path, "w", method, allowZip64=True, **kwargs) as zf:
        for name, arr in arrays.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
