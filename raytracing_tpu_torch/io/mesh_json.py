"""Assimp-style JSON mesh parser -> flat triangle soup
(``raytracing_tpu.io.mesh_json``, number for number; pure numpy).

  * per-node column-major ``modelMatrix`` applied to positions, and the
    inverse-transpose of its upper 3x3 to normals, in float64 before the
    float32 cast
  * indexed or unindexed meshes; 3 vertices per triangle in the output
  * per-triangle material index; materials carry ``diffuseReflectance``
    rgba (one white material when none are given)
  * bounds over the transformed positions (empty: +inf / -inf)
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class MeshData:
    n_triangles: int
    positions: np.ndarray      # (T, 3, 3) float32
    normals: np.ndarray        # (T, 3, 3) float32
    material_indices: np.ndarray  # (T,) int32
    materials: np.ndarray      # (M, 4) float32 diffuse rgba
    tcoords: np.ndarray | None  # (T, 3, 2) or None
    bounds_min: np.ndarray
    bounds_max: np.ndarray


def _mat4(col_major16) -> np.ndarray:
    """Column-major 16-vector -> (4, 4) row-major float64 matrix."""
    return np.asarray(col_major16, np.float64).reshape(4, 4).T


def _normal_matrix(m4: np.ndarray) -> np.ndarray:
    """Inverse-transpose of the upper-left 3x3 (identity when singular)."""
    try:
        return np.linalg.inv(m4[:3, :3]).T
    except np.linalg.LinAlgError:
        return np.eye(3)


def parse_mesh_json(text: str) -> MeshData:
    model = json.loads(text)
    positions, normals, tcoords, mat_ids = [], [], [], []
    has_tc = True

    nodes = model.get("nodes")
    for k in range(len(nodes) if nodes else 1):
        if nodes:
            m4 = _mat4(nodes[k]["modelMatrix"])
            mesh_indices = nodes[k]["meshIndices"]
        else:
            m4 = np.eye(4)
            mesh_indices = list(range(len(model["meshes"])))
        n3 = _normal_matrix(m4)
        for index in mesh_indices:
            mesh = model["meshes"][index]
            vp = np.asarray(mesh["vertexPositions"], np.float64).reshape(-1, 3)
            vn = np.asarray(mesh["vertexNormals"], np.float64).reshape(-1, 3)
            tcs = mesh.get("vertexTexCoordinates")
            tc = (np.asarray(tcs[0], np.float64).reshape(-1, 2)
                  if tcs and len(tcs) > 0 and tcs[0] else None)
            idx = mesh.get("indices")
            idx = (np.asarray(idx, np.int64) if idx is not None
                   else np.arange(vp.shape[0]))
            tri_idx = idx.reshape(-1, 3)

            vp_t = vp @ m4[:3, :3].T + m4[:3, 3]
            vn_t = vn @ n3.T
            positions.append(vp_t[tri_idx])
            normals.append(vn_t[tri_idx])
            mat_ids.append(np.full(tri_idx.shape[0],
                                   mesh.get("materialIndex", 0), np.int32))
            if tc is not None:
                tcoords.append(tc[tri_idx])
            else:
                has_tc = False

    if positions:
        p = np.concatenate(positions).astype(np.float32)
        n = np.concatenate(normals).astype(np.float32)
        mi = np.concatenate(mat_ids)
    else:
        p = np.zeros((0, 3, 3), np.float32)
        n = np.zeros((0, 3, 3), np.float32)
        mi = np.zeros((0,), np.int32)

    materials = [m["diffuseReflectance"] for m in model.get("materials", [])]
    materials = (np.asarray(materials, np.float32).reshape(-1, 4)
                 if materials else np.ones((1, 4), np.float32))

    if p.size:
        lo = p.reshape(-1, 3).min(0)
        hi = p.reshape(-1, 3).max(0)
    else:
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)

    return MeshData(n_triangles=p.shape[0], positions=p, normals=n,
                    material_indices=mi, materials=materials,
                    tcoords=(np.concatenate(tcoords).astype(np.float32)
                             if (has_tc and tcoords) else None),
                    bounds_min=lo, bounds_max=hi)


def load_mesh_json(path: str) -> MeshData:
    with open(path, "r") as f:
        return parse_mesh_json(f.read())


# -- mesh-instance transforms (the reference's Mesh.normalize / scale /
#    translate) --------------------------------------------------------------

def normalize_unit_cube(md: MeshData) -> MeshData:
    """Centre at the origin and scale by 1 / the longest side, so that the
    longest axis spans 1."""
    center = 0.5 * (md.bounds_min + md.bounds_max)
    dims = md.bounds_max - md.bounds_min
    s = 1.0 / max(float(dims.max()), 1e-30)
    p = (md.positions - center) * s
    return dataclasses.replace(
        md, positions=p.astype(np.float32),
        bounds_min=((md.bounds_min - center) * s).astype(np.float32),
        bounds_max=((md.bounds_max - center) * s).astype(np.float32))


def scale(md: MeshData, sx, sy, sz) -> MeshData:
    s = np.asarray([sx, sy, sz], np.float32)
    return dataclasses.replace(
        md, positions=(md.positions * s).astype(np.float32),
        bounds_min=(md.bounds_min * s).astype(np.float32),
        bounds_max=(md.bounds_max * s).astype(np.float32))


def translate(md: MeshData, tx, ty, tz) -> MeshData:
    t = np.asarray([tx, ty, tz], np.float32)
    return dataclasses.replace(
        md, positions=(md.positions + t).astype(np.float32),
        bounds_min=(md.bounds_min + t).astype(np.float32),
        bounds_max=(md.bounds_max + t).astype(np.float32))
