"""Binary PLY point-cloud writer / reader.

Port of ``pi3_slam_tpu/io/ply.py`` (that package's ``io/__init__`` pulls in
JAX), the same bytes: binary little-endian, one "vertex" element with
x/y/z/nx/ny/nz float32 + red/green/blue uchar, written from numpy structured
arrays.
"""

from __future__ import annotations

import os

import numpy as np

_VERTEX_DTYPE = np.dtype(
    [
        ("x", "<f4"),
        ("y", "<f4"),
        ("z", "<f4"),
        ("nx", "<f4"),
        ("ny", "<f4"),
        ("nz", "<f4"),
        ("red", "u1"),
        ("green", "u1"),
        ("blue", "u1"),
    ]
)


def _rainbow_colors(xyz: np.ndarray) -> np.ndarray:
    """HSV rainbow fallback coloring by normalized position (reference
    pi3/utils/basic.py:415-441): hue = 0.7x + 0.2y + 0.1z, s=0.9, v=0.8."""
    lo = xyz.min(axis=0)
    hi = xyz.max(axis=0)
    n = (xyz - lo) / (hi - lo + 1e-8)
    hue = 0.7 * n[:, 0] + 0.2 * n[:, 1] + 0.1 * n[:, 2]
    s = 0.9
    v = 0.8
    c = v * s
    hp = (hue * 6.0) % 6.0
    x = c * (1 - np.abs(hp % 2 - 1))
    m = v - c
    zeros = np.zeros_like(x)
    sector = np.floor(hp).astype(int) % 6
    r = np.choose(sector, [c, x, zeros, zeros, x, c])
    g = np.choose(sector, [x, c, c, x, zeros, zeros])
    b = np.choose(sector, [zeros, zeros, x, c, c, x])
    return np.stack([r, g, b], axis=1) + m


def write_ply(
    xyz: np.ndarray,
    rgb: np.ndarray | None = None,
    path: str = "output.ply",
    max_points: int | None = None,
    normals: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
) -> None:
    """Write (..., 3) points (+ optional colors in [0,1] or [0,255]) as binary PLY."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    if rgb is not None:
        rgb = np.asarray(rgb, dtype=np.float32).reshape(-1, 3)
        if rgb.size and rgb.max() > 1:
            rgb = rgb / 255.0
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)

    if max_points is not None and xyz.shape[0] > max_points:
        rng = rng or np.random.default_rng()
        idx = rng.choice(xyz.shape[0], max_points, replace=False)
        xyz = xyz[idx]
        if rgb is not None:
            rgb = rgb[idx]
        if normals is not None:
            normals = normals[idx]

    if rgb is None:
        rgb = _rainbow_colors(xyz) if xyz.shape[0] else np.zeros((0, 3), np.float32)

    n = xyz.shape[0]
    rec = np.empty(n, dtype=_VERTEX_DTYPE)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    nrm = normals if normals is not None else np.zeros_like(xyz)
    rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    col = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]

    header = "\n".join(
        [
            "ply",
            "format binary_little_endian 1.0",
            f"element vertex {n}",
            "property float x",
            "property float y",
            "property float z",
            "property float nx",
            "property float ny",
            "property float nz",
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            "end_header",
            "",
        ]
    )
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> dict:
    """Read a binary-little-endian PLY with float/uchar vertex properties.

    Returns {'xyz': (N,3) f32, 'rgb': (N,3) u8 or None, 'normals': (N,3) f32 or None}.
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header_lines = data[:end].decode("ascii").splitlines()
    fmt = next(l for l in header_lines if l.startswith("format"))
    if "binary_little_endian" not in fmt:
        raise ValueError(f"unsupported PLY format: {fmt}")
    n = None
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header_lines:
        if line.startswith("element"):
            _, name, cnt = line.split()
            in_vertex = name == "vertex"
            if in_vertex:
                n = int(cnt)
        elif line.startswith("property") and in_vertex:
            _, typ, name = line.split()
            props.append((name, typ))
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8",
        "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
    }
    dtype = np.dtype([(name, type_map[typ]) for name, typ in props])
    rec = np.frombuffer(data[end : end + n * dtype.itemsize], dtype=dtype)
    out = {"xyz": np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)}
    names = dtype.names
    out["normals"] = (
        np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1).astype(np.float32)
        if "nx" in names
        else None
    )
    out["rgb"] = (
        np.stack([rec["red"], rec["green"], rec["blue"]], axis=1) if "red" in names else None
    )
    return out
