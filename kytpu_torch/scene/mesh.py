"""Triangle-mesh ingestion: procedural generators and a minimal OBJ parser
(kytpu/scene/mesh.py, copied: the port imports nothing of kytpu).

numpy only. `builders.mesh_scene` binds the (vertices, faces) arrays these
return onto a scene, whose triangle rows the big-scene kernels
(kernels/bigscene.py) sweep past 64 surfaces.

Conventions: vertices are (V, 3) float64 (builders downcast when freezing),
faces are (F, 3) int32 with counter-clockwise winding seen from OUTSIDE
(normal = normalize(cross(p1 - p0, p2 - p0)), the reference's triangle
orientation, ky.cpp:1177). Triangles are one-sided exactly like the
reference's triangle_t (only rectangles flip at hit, ky.cpp:1289).
"""

from __future__ import annotations

import numpy as np

__all__ = ["icosphere", "torus", "load_obj", "mesh_bounds",
           "transform_mesh"]


def icosphere(subdivisions: int = 2, center=(0.0, 0.0, 0.0),
              radius: float = 1.0):
    """Geodesic sphere: icosahedron subdivided `s` times and reprojected.

    Returns (verts (V, 3) f64, faces (F, 3) i32) with F = 20 * 4**s and
    V = 10 * 4**s + 2, outward winding, watertight.
    """
    if subdivisions < 0:
        raise ValueError("subdivisions must be >= 0")
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ], np.float64)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ], np.int64)

    for _ in range(subdivisions):
        vlist = list(verts)
        midpoint = {}

        def mid(a, b):
            k = (a, b) if a < b else (b, a)
            m = midpoint.get(k)
            if m is None:
                p = vlist[a] + vlist[b]
                p = p / np.linalg.norm(p)
                m = midpoint[k] = len(vlist)
                vlist.append(p)
            return m

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        verts = np.asarray(vlist, np.float64)
        faces = np.asarray(new_faces, np.int64)

    verts = verts * float(radius) + np.asarray(center, np.float64)
    return verts, faces.astype(np.int32)


def torus(major_radius: float = 1.0, minor_radius: float = 0.35,
          nu: int = 24, nv: int = 12, center=(0.0, 0.0, 0.0)):
    """Parametric torus in the xz-plane: 2 * nu * nv triangles, watertight.

    nu segments around the major circle, nv around the tube. Handy as an
    arbitrarily-dense genus-1 stress mesh (self-shadowing, grazing hits).
    """
    if nu < 3 or nv < 3:
        raise ValueError("nu and nv must be >= 3")
    u = 2.0 * np.pi * np.arange(nu) / nu
    v = 2.0 * np.pi * np.arange(nv) / nv
    uu, vv = np.meshgrid(u, v, indexing="ij")          # (nu, nv)
    ring = major_radius + minor_radius * np.cos(vv)
    verts = np.stack([ring * np.cos(uu),
                      minor_radius * np.sin(vv),
                      ring * np.sin(uu)], axis=-1).reshape(-1, 3)
    verts += np.asarray(center, np.float64)

    i = np.repeat(np.arange(nu), nv)
    j = np.tile(np.arange(nv), nu)
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    # outward winding: at (u, v) = (0, 0) the surface normal is +x and
    # cross(b - a, c - a) points along -x for (a, b, c), so wind (a, c, b)
    faces = np.concatenate([np.stack([a, c, b], -1),
                            np.stack([a, d, c], -1)], axis=0)
    return verts, faces.astype(np.int32)


def load_obj(source: str):
    """Minimal Wavefront OBJ reader -> (verts (V, 3) f64, faces (F, 3) i32).

    `source` is a filesystem path or the file's text. Supports `v` and `f`
    records (with `v/vt/vn` slash forms), 1-based and negative indices, and
    fan-triangulation of n-gons; ignores normals/uvs/materials/groups.
    """
    if "\n" in source or source.lstrip().startswith(("v ", "f ", "#")):
        text = source
    else:
        with open(source, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
    verts, faces = [], []
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v" and len(parts) >= 4:
            verts.append((float(parts[1]), float(parts[2]),
                          float(parts[3])))
        elif parts[0] == "f" and len(parts) >= 4:
            idx = []
            for tok in parts[1:]:
                i = int(tok.split("/")[0])
                idx.append(i - 1 if i > 0 else len(verts) + i)
            for k in range(1, len(idx) - 1):    # fan triangulation
                faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("OBJ face index out of range")
    return v, f.astype(np.int32)


def mesh_bounds(verts):
    """(lo, hi) AABB of a vertex array."""
    v = np.asarray(verts, np.float64)
    return v.min(axis=0), v.max(axis=0)


def transform_mesh(verts, scale=1.0, rotate_y: float = 0.0,
                   translate=(0.0, 0.0, 0.0)):
    """Uniform scale, then rotation about +y (radians), then translation."""
    v = np.asarray(verts, np.float64) * float(scale)
    if rotate_y:
        c, s = np.cos(rotate_y), np.sin(rotate_y)
        v = v @ np.array([[c, 0.0, s], [0.0, 1.0, 0.0],
                          [-s, 0.0, c]], np.float64).T
    return v + np.asarray(translate, np.float64)
