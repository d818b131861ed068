"""Naive surface nets: SDF voxel grid -> triangle mesh (vectorized numpy).

Port of ``pi3_slam_tpu/mapping/surface_nets.py``, the same arithmetic (host
numpy in both packages), so the same volume gives the same vertices, faces
and colours bit for bit. Surface nets needs no 256-case lookup tables, puts
one vertex per sign-change cell at the centroid of its edge crossings, and
vectorizes into array slicing. Meshing is a one-shot export step, so it runs
on the host on the fused volume pulled back from the device; the
O(frames x voxels) fusion (``mapping/tsdf.py``) is the device part.

Conventions: SDF negative inside, positive outside; emitted triangles
wind counter-clockwise seen from outside (normals outward).
"""

from __future__ import annotations

import numpy as np


def _edge_crossings(d: np.ndarray, level: float, axis: int):
    """Crossing mask + interpolated offset t for grid edges along `axis`.

    Returns (cross (bool), t (float)) with shape d.shape minus one along
    `axis`; t is the fractional position of the zero crossing from the
    lower corner.
    """
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[axis] = slice(None, -1)
    hi[axis] = slice(1, None)
    a = d[tuple(lo)] - level
    b = d[tuple(hi)] - level
    cross = (a < 0) != (b < 0)
    denom = a - b
    t = np.where(np.abs(denom) > 1e-20, a / np.where(denom == 0, 1.0, denom), 0.5)
    return cross, np.clip(t, 0.0, 1.0)


def sdf_vertex_normals(
    sdf: np.ndarray,
    vertices_world: np.ndarray,
    origin: np.ndarray | None = None,
    voxel_size: float = 1.0,
    grad: np.ndarray | None = None,
) -> np.ndarray:
    """Unit vertex normals from the SDF gradient (outward: SDF increases
    toward free space), trilinearly sampled at the vertex positions.

    Smoother than face-normal averaging because the TSDF itself averages
    many observations. Degenerate gradients (flat/unobserved regions)
    fall back to +z. grad: optional precomputed (X, Y, Z, 3) SDF gradient
    (TSDFVolume.sdf_gradient caches it across calls).
    """
    d = np.asarray(sdf, np.float32)
    org = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
    g = np.asarray(vertices_world, np.float64).reshape(-1, 3)
    g = (g - org) / float(voxel_size)  # grid coords

    if grad is None:
        grad = np.stack(np.gradient(d), axis=-1)  # (X, Y, Z, 3), d/dgrid

    dims = np.array(d.shape)
    base = np.clip(np.floor(g).astype(int), 0, dims - 2)
    t = np.clip(g - base, 0.0, 1.0)
    n = np.zeros((len(g), 3))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (t[:, 0] if dx else 1 - t[:, 0])
                    * (t[:, 1] if dy else 1 - t[:, 1])
                    * (t[:, 2] if dz else 1 - t[:, 2])
                )
                n += w[:, None] * grad[base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz]
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 1e-12, n / np.maximum(norm, 1e-12), [0.0, 0.0, 1.0])
    return n.astype(np.float32)


def surface_nets(
    sdf: np.ndarray,
    level: float = 0.0,
    origin: np.ndarray | None = None,
    voxel_size: float = 1.0,
    observed: np.ndarray | None = None,
    colors: np.ndarray | None = None,
):
    """Extract the `level` isosurface of an (X, Y, Z) SDF grid.

    observed: optional (X, Y, Z) bool — grid points carrying real data
    (TSDF weight > 0); edges/cells touching unobserved points are skipped.
    colors: optional (X, Y, Z, 3) per-voxel colors, nearest-sampled onto
    the vertices.

    Returns (vertices (V, 3) world coords, faces (F, 3) int32,
    vertex_colors (V, 3) or None).
    """
    d = np.asarray(sdf, np.float32)
    if d.ndim != 3 or min(d.shape) < 2:
        raise ValueError(f"sdf must be (X>=2, Y>=2, Z>=2), got {d.shape}")
    X, Y, Z = d.shape
    obs = (
        np.ones_like(d, bool)
        if observed is None
        else np.asarray(observed, bool)
    )

    # ---- edge crossings along each axis (masked to observed endpoints)
    crossings = []
    for ax in range(3):
        cross, t = _edge_crossings(d, level, ax)
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        cross &= obs[tuple(lo)] & obs[tuple(hi)]
        crossings.append((cross, t))

    # ---- per-cell centroid of edge-crossing points
    cs = (X - 1, Y - 1, Z - 1)
    vsum = np.zeros(cs + (3,), np.float64)
    vcnt = np.zeros(cs, np.int32)
    for ax in range(3):
        cross, t = crossings[ax]
        # crossing point in grid coords: lower corner + t along ax
        base = np.stack(
            np.meshgrid(
                np.arange(cross.shape[0], dtype=np.float64),
                np.arange(cross.shape[1], dtype=np.float64),
                np.arange(cross.shape[2], dtype=np.float64),
                indexing="ij",
            ),
            axis=-1,
        )
        base[..., ax] += t
        # the edge along `ax` at (i, j, k) belongs to the 4 cells offset by
        # 0/-1 along the two other axes
        o1, o2 = [a for a in range(3) if a != ax]
        for d1 in (0, 1):
            for d2 in (0, 1):
                # cell index = edge index - (d1 along o1, d2 along o2)
                src = [slice(None)] * 3
                dst = [slice(None)] * 3
                # valid cell range: edge idx - d >= 0 and < cells
                for o, dd in ((o1, d1), (o2, d2)):
                    n_edge = cross.shape[o]
                    n_cell = cs[o]
                    lo_e = dd
                    hi_e = min(n_edge, n_cell + dd)
                    src[o] = slice(lo_e, hi_e)
                    dst[o] = slice(lo_e - dd, hi_e - dd)
                w = cross[tuple(src)]
                vsum[tuple(dst)] += np.where(w[..., None], base[tuple(src)], 0.0)
                vcnt[tuple(dst)] += w

    active = vcnt > 0
    cell_vid = np.full(cs, -1, np.int64)
    idx = np.nonzero(active)
    cell_vid[idx] = np.arange(len(idx[0]))
    vertices = (vsum[idx] / vcnt[idx][:, None]).astype(np.float64)

    # ---- quads: one per interior sign-change edge, over its 4 cells
    faces = []
    sign_in = d < level  # True = inside
    for ax in range(3):
        cross, _ = crossings[ax]
        o1, o2 = [a for a in range(3) if a != ax]
        # interior edges only: all 4 adjacent cells exist
        sl = [slice(None)] * 3
        sl[ax] = slice(None, cs[ax])  # edge lower corner within cell range
        sl[o1] = slice(1, cs[o1])
        sl[o2] = slice(1, cs[o2])
        m = cross[tuple(sl)]
        e = np.nonzero(m)
        if len(e[0]) == 0:
            continue
        # absolute edge indices (undo the slice offsets)
        starts = [s.start or 0 for s in sl]
        eidx = [e[k] + starts[k] for k in range(3)]

        def cid(d1, d2):
            c = [eidx[0].copy(), eidx[1].copy(), eidx[2].copy()]
            c[o1] = c[o1] - d1
            c[o2] = c[o2] - d2
            return cell_vid[c[0], c[1], c[2]]

        v00 = cid(1, 1)
        v10 = cid(0, 1)
        v11 = cid(0, 0)
        v01 = cid(1, 0)
        # winding: if the lower endpoint is inside (sign_in), the surface
        # normal points along +ax; otherwise along -ax
        flip = sign_in[eidx[0], eidx[1], eidx[2]]
        # axis parity: the (o1, o2) pair of axis `ax` forms a right-handed
        # frame with +ax only for even permutations — odd axes flip once more
        if ax == 1:
            flip = ~flip
        q = np.stack([v00, v01, v11, v10], axis=1)
        q_f = np.stack([v00, v10, v11, v01], axis=1)
        quad = np.where(flip[:, None], q_f, q)
        faces.append(quad[:, [0, 1, 2]])
        faces.append(quad[:, [0, 2, 3]])

    faces_arr = (
        np.concatenate(faces).astype(np.int32)
        if faces
        else np.zeros((0, 3), np.int32)
    )
    if (faces_arr < 0).any():  # pragma: no cover — adjacency guarantees active
        keep = (faces_arr >= 0).all(axis=1)
        faces_arr = faces_arr[keep]

    if origin is not None or voxel_size != 1.0:
        org = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
        verts_world = org + vertices * float(voxel_size)
    else:
        verts_world = vertices

    vcolors = None
    if colors is not None and len(vertices):
        cgrid = np.asarray(colors)
        gi = np.clip(np.round(vertices).astype(int), 0, np.array(d.shape) - 1)
        vcolors = cgrid[gi[:, 0], gi[:, 1], gi[:, 2]]

    return verts_world.astype(np.float32), faces_arr, vcolors
