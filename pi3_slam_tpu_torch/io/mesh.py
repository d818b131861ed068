"""Binary PLY triangle-mesh writer / reader.

Port of ``pi3_slam_tpu/io/mesh.py`` (host numpy in both packages), the same
bytes: binary little-endian like ``io/ply.py``, plus a face element with a
uchar-count int32 vertex-index list, the standard PLY mesh encoding that
MeshLab, Open3D and Blender read. It serves the dense-mapping export
(``mapping/tsdf.py`` + ``mapping/surface_nets.py``); the reference exports
point clouds only (pi3/utils/basic.py:377-459).
"""

from __future__ import annotations

import os

import numpy as np


def write_mesh_ply(
    vertices: np.ndarray,
    faces: np.ndarray,
    path: str,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
) -> None:
    """Write a triangle mesh as binary PLY.

    vertices: (V, 3) float; faces: (F, 3) int vertex indices;
    colors: optional (V, 3) per-vertex colors in [0, 1] or [0, 255];
    normals: optional (V, 3) unit vertex normals (nx ny nz properties —
    the same layout io/ply.py and the reference's write_ply use).
    """
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if faces.size and (faces.min() < 0 or faces.max() >= len(vertices)):
        raise ValueError(
            f"face indices out of range [0, {len(vertices)}): "
            f"[{faces.min()}, {faces.max()}]"
        )
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors, np.float32).reshape(-1, 3)
        if len(colors) != len(vertices):
            raise ValueError("colors must be per-vertex")
        if colors.size and colors.max() > 1:
            colors = colors / 255.0
        col = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    has_normal = normals is not None
    if has_normal:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)
        if len(normals) != len(vertices):
            raise ValueError("normals must be per-vertex")

    vprops = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_normal:
        vprops += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_color:
        vprops += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    vrec = np.empty(len(vertices), dtype=np.dtype(vprops))
    vrec["x"], vrec["y"], vrec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if has_normal:
        vrec["nx"], vrec["ny"], vrec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if has_color:
        vrec["red"], vrec["green"], vrec["blue"] = col[:, 0], col[:, 1], col[:, 2]

    frec = np.empty(
        len(faces), dtype=np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    )
    frec["n"] = 3
    frec["i"] = faces.astype("<i4")

    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {len(vertices)}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if has_normal:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
        "",
    ]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(vrec.tobytes())
        f.write(frec.tobytes())


def read_mesh_ply(path: str) -> dict:
    """Read a binary-little-endian PLY triangle mesh written by
    write_mesh_ply (uchar-count int32 face lists, all faces triangles).

    Returns {'vertices': (V,3) f32, 'faces': (F,3) i32, 'rgb': (V,3) u8 or
    None, 'normals': (V,3) f32 or None}.
    """
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if not any("binary_little_endian" in l for l in header):
        raise ValueError("unsupported PLY format (expect binary_little_endian)")

    n_vert = n_face = 0
    vprops: list[tuple[str, str]] = []
    section = None
    for line in header:
        if line.startswith("element"):
            _, name, cnt = line.split()
            section = name
            if name == "vertex":
                n_vert = int(cnt)
            elif name == "face":
                n_face = int(cnt)
        elif line.startswith("property") and section == "vertex":
            parts = line.split()
            if parts[1] == "list":
                raise ValueError("list property on vertex element unsupported")
            vprops.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1"}
    vdtype = np.dtype([(name, type_map[typ]) for name, typ in vprops])
    off = end
    vrec = np.frombuffer(data[off : off + n_vert * vdtype.itemsize], dtype=vdtype)
    off += n_vert * vdtype.itemsize

    fdtype = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    frec = np.frombuffer(data[off : off + n_face * fdtype.itemsize], dtype=fdtype)
    if n_face and not (frec["n"] == 3).all():
        raise ValueError("non-triangle face encountered")

    out = {
        "vertices": np.stack([vrec["x"], vrec["y"], vrec["z"]], 1).astype(np.float32),
        "faces": frec["i"].astype(np.int32).reshape(-1, 3),
    }
    out["rgb"] = (
        np.stack([vrec["red"], vrec["green"], vrec["blue"]], 1)
        if "red" in vdtype.names
        else None
    )
    out["normals"] = (
        np.stack([vrec["nx"], vrec["ny"], vrec["nz"]], 1).astype(np.float32)
        if "nx" in vdtype.names
        else None
    )
    return out
