"""Procedural mesh API: validated vertex-stream descriptors.

Array-of-structs interleaved vertex buffers (reference:
Game/VertexLayouts.swift, Game/ProceduralMeshAPI.swift:19-181,
Game/ProceduralMeshBuilder.swift) become plain struct-of-arrays numpy — the
natural layout for device consumption. Tangents are computed on demand per
Game/MeshTangents.swift semantics (accumulated per-triangle UV-space tangent
frames, orthonormalized per vertex with handedness in w).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class MeshDescriptor:
    """Static triangle mesh (reference ProceduralMeshDescriptor)."""

    positions: np.ndarray          # (V,3) f32
    indices: np.ndarray            # (I,) i32, triangles
    normals: Optional[np.ndarray] = None    # (V,3)
    uvs: Optional[np.ndarray] = None        # (V,2)
    tangents: Optional[np.ndarray] = None   # (V,4)
    name: str = "mesh"

    def __post_init__(self):
        v = len(self.positions)
        _check(v > 0, f"{self.name}: empty positions")
        _check(self.positions.shape == (v, 3), f"{self.name}: positions must be (V,3)")
        _check(len(self.indices) % 3 == 0, f"{self.name}: indices not a triangle list")
        _check(self.indices.min(initial=0) >= 0 and self.indices.max(initial=0) < v,
               f"{self.name}: index out of range")
        if self.normals is not None:
            _check(self.normals.shape == (v, 3), f"{self.name}: normals shape")
        if self.uvs is not None:
            _check(self.uvs.shape == (v, 2), f"{self.name}: uvs shape")
        if self.tangents is not None:
            _check(self.tangents.shape == (v, 4), f"{self.name}: tangents shape")

    @property
    def vertex_count(self) -> int:
        return len(self.positions)

    @property
    def triangle_count(self) -> int:
        return len(self.indices) // 3

    def bounds(self):
        return self.positions.min(axis=0), self.positions.max(axis=0)

    def with_tangents(self) -> "MeshDescriptor":
        if self.tangents is not None or self.uvs is None or self.normals is None:
            return self
        return MeshDescriptor(
            positions=self.positions, indices=self.indices, normals=self.normals,
            uvs=self.uvs, tangents=compute_tangents(self.positions, self.normals,
                                                    self.uvs, self.indices),
            name=self.name)


@dataclass(frozen=True)
class SkinnedMeshDescriptor:
    """Skinned triangle mesh (reference SkinnedMeshDescriptor)."""

    positions: np.ndarray      # (V,3)
    normals: np.ndarray        # (V,3)
    uvs: np.ndarray            # (V,2)
    joints: np.ndarray         # (V,4) i32
    weights: np.ndarray        # (V,4) f32
    indices: np.ndarray        # (I,) i32
    inv_bind_model: Optional[np.ndarray] = None  # (B,4,4) override
    tangents: Optional[np.ndarray] = None
    name: str = "skinned"

    def __post_init__(self):
        v = len(self.positions)
        _check(v > 0, f"{self.name}: empty positions")
        for arr, shape, nm in ((self.normals, (v, 3), "normals"),
                               (self.uvs, (v, 2), "uvs"),
                               (self.joints, (v, 4), "joints"),
                               (self.weights, (v, 4), "weights")):
            _check(arr.shape == shape, f"{self.name}: {nm} shape {arr.shape} != {shape}")
        _check(len(self.indices) % 3 == 0, f"{self.name}: indices not a triangle list")
        _check(self.indices.min(initial=0) >= 0 and self.indices.max(initial=0) < v,
               f"{self.name}: index out of range")

    @property
    def vertex_count(self) -> int:
        return len(self.positions)

    def with_tangents(self) -> "SkinnedMeshDescriptor":
        if self.tangents is not None:
            return self
        return SkinnedMeshDescriptor(
            positions=self.positions, normals=self.normals, uvs=self.uvs,
            joints=self.joints, weights=self.weights, indices=self.indices,
            inv_bind_model=self.inv_bind_model,
            tangents=compute_tangents(self.positions, self.normals, self.uvs,
                                      self.indices),
            name=self.name)


def simplify_mesh(mesh: MeshDescriptor, target_tris: int) -> MeshDescriptor:
    """Vertex-clustering decimation to approximately ``target_tris``.

    Quantizes vertices to a uniform grid sized from the triangle budget,
    merges co-located vertices (averaging attributes), and drops collapsed
    triangles. Fast (pure numpy) and topology-free — the right trade for
    dense scanned assets under a render triangle budget.
    """
    t = mesh.triangle_count
    if t <= target_tris:
        return mesh
    lo = mesh.positions.min(axis=0)
    hi = mesh.positions.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    # grid resolution: start around the budget's scale, coarsen until the
    # triangle count fits.
    res = max(int(np.cbrt(target_tris) * 2.0), 4)
    for _ in range(12):
        cell = (mesh.positions - lo) / span
        key = np.clip((cell * res).astype(np.int64), 0, res - 1)
        flat = (key[:, 0] * res + key[:, 1]) * res + key[:, 2]
        uniq, inv = np.unique(flat, return_inverse=True)
        tri = inv[mesh.indices.reshape(-1, 3)]
        keep = (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) & \
               (tri[:, 0] != tri[:, 2])
        n_out = int(keep.sum())
        if n_out <= target_tris or res <= 4:
            break
        res = max(int(res / 1.3), 4)

    v_out = len(uniq)
    counts = np.bincount(inv, minlength=v_out).astype(np.float64)[:, None]

    def avg(attr):
        if attr is None:
            return None
        out = np.zeros((v_out, attr.shape[1]), np.float64)
        np.add.at(out, inv, attr.astype(np.float64))
        return (out / counts).astype(np.float32)

    positions = avg(mesh.positions)
    normals = avg(mesh.normals)
    if normals is not None:
        ln = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = np.where(ln > 1e-8, normals / np.maximum(ln, 1e-20),
                           np.array([[0, 1, 0]], np.float32)).astype(np.float32)
    uvs = avg(mesh.uvs)
    return MeshDescriptor(positions=positions, indices=tri[keep].reshape(-1).astype(np.int32),
                          normals=normals, uvs=uvs, name=mesh.name + ":lod")


def simplify_skinned(positions, normals, uvs, indices, joints, weights,
                     target_tris: int):
    """Vertex-clustering decimation preserving LBS weights (top-4 re-pick)."""
    t = len(indices) // 3
    if t <= target_tris:
        return positions, normals, uvs, indices, joints, weights
    lo = positions.min(axis=0)
    span = np.maximum(positions.max(axis=0) - lo, 1e-9)
    res = max(int(np.cbrt(target_tris) * 2.0), 4)
    tri = indices.reshape(-1, 3)
    for _ in range(12):
        key = np.clip(((positions - lo) / span * res).astype(np.int64), 0, res - 1)
        flat = (key[:, 0] * res + key[:, 1]) * res + key[:, 2]
        uniq, inv = np.unique(flat, return_inverse=True)
        tri2 = inv[tri]
        keep = (tri2[:, 0] != tri2[:, 1]) & (tri2[:, 1] != tri2[:, 2]) & \
               (tri2[:, 0] != tri2[:, 2])
        if int(keep.sum()) <= target_tris or res <= 4:
            break
        res = max(int(res / 1.3), 4)

    v_out = len(uniq)
    counts = np.bincount(inv, minlength=v_out).astype(np.float64)[:, None]

    def avg(attr):
        out = np.zeros((v_out, attr.shape[1]), np.float64)
        np.add.at(out, inv, attr.astype(np.float64))
        return (out / counts).astype(np.float32)

    pos = avg(positions)
    nrm = avg(normals)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(ln > 1e-8, nrm / np.maximum(ln, 1e-20),
                   np.array([[0, 1, 0]], np.float32)).astype(np.float32)
    uv = avg(uvs)

    # merge weights per cluster: accumulate per (cluster, bone), take top-4
    n_b = int(joints.max()) + 1
    acc = np.zeros((v_out, n_b), np.float64)
    rows = np.repeat(inv, 4)
    np.add.at(acc, (rows, joints.reshape(-1)), weights.reshape(-1))
    top = np.argsort(-acc, axis=1)[:, :4]
    w4 = np.take_along_axis(acc, top, axis=1)
    s = w4.sum(axis=1, keepdims=True)
    w4 = np.where(s > 0, w4 / np.maximum(s, 1e-20), 0.0)

    return (pos, nrm, uv, tri2[keep].reshape(-1).astype(np.int32),
            top.astype(np.int32), w4.astype(np.float32))


def compute_tangents(positions, normals, uvs, indices) -> np.ndarray:
    """Per-vertex tangents with handedness (reference: Game/MeshTangents.swift:11-82).

    Accumulates UV-gradient tangents/bitangents per triangle, then
    Gram-Schmidt orthonormalizes against the vertex normal; w = handedness.
    Vectorized with scatter-adds instead of the reference's per-index loop.
    """
    v = len(positions)
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = (positions[tri[:, k]] for k in range(3))
    u0, u1, u2 = (uvs[tri[:, k]] for k in range(3))

    e1 = p1 - p0
    e2 = p2 - p0
    duv1 = u1 - u0
    duv2 = u2 - u0
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    inv = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))[:, None]
    t = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv
    b = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv

    tan = np.zeros((v, 3), np.float64)
    bit = np.zeros((v, 3), np.float64)
    for k in range(3):
        np.add.at(tan, tri[:, k], t)
        np.add.at(bit, tri[:, k], b)

    n = normals.astype(np.float64)
    t_ortho = tan - n * (n * tan).sum(axis=1, keepdims=True)
    ln = np.linalg.norm(t_ortho, axis=1, keepdims=True)
    fallback = np.tile(np.array([1.0, 0, 0]), (v, 1))
    t_unit = np.where(ln > 1e-8, t_ortho / np.maximum(ln, 1e-20), fallback)
    handed = np.where((np.cross(n, t_unit) * bit).sum(axis=1) < 0.0, -1.0, 1.0)
    return np.concatenate([t_unit, handed[:, None]], axis=1).astype(np.float32)
