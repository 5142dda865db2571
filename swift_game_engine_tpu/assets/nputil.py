"""Host-side (numpy) math helpers for asset loading.

Deliberately independent from the jnp runtime math in
``swift_game_engine_tpu.math3d`` — loaders run once on the host, and keeping a
second small implementation doubles as an oracle in parity tests.
Conventions match math3d: column-vector 4x4s, (x, y, z, w) quaternions.
"""

from __future__ import annotations

import numpy as np


def rotation_xyz_degrees(deg) -> np.ndarray:
    """Euler XYZ rotation ``Rz @ Ry @ Rx`` as 4x4 (reference: Game/Skeleton.swift:212-217).

    ``deg``: (..., 3) degrees. Returns (..., 4, 4) float32.
    """
    deg = np.asarray(deg, np.float32)
    rad = np.deg2rad(deg).astype(np.float32)
    cx, cy, cz = np.cos(rad[..., 0]), np.cos(rad[..., 1]), np.cos(rad[..., 2])
    sx, sy, sz = np.sin(rad[..., 0]), np.sin(rad[..., 1]), np.sin(rad[..., 2])
    out = np.zeros((*deg.shape[:-1], 4, 4), np.float32)
    out[..., 0, 0] = cz * cy
    out[..., 0, 1] = cz * sy * sx - sz * cx
    out[..., 0, 2] = cz * sy * cx + sz * sx
    out[..., 1, 0] = sz * cy
    out[..., 1, 1] = sz * sy * sx + cz * cx
    out[..., 1, 2] = sz * sy * cx - cz * sx
    out[..., 2, 0] = -sy
    out[..., 2, 1] = cy * sx
    out[..., 2, 2] = cy * cx
    out[..., 3, 3] = 1.0
    return out


def translation_mat(t) -> np.ndarray:
    t = np.asarray(t, np.float32)
    out = np.zeros((*t.shape[:-1], 4, 4), np.float32)
    out[..., 0, 0] = out[..., 1, 1] = out[..., 2, 2] = out[..., 3, 3] = 1.0
    out[..., :3, 3] = t
    return out


def fk_model_transforms(parent: np.ndarray, local: np.ndarray) -> np.ndarray:
    """Sequential forward kinematics; parents must precede children.

    reference: Game/Skeleton.swift:175-187.
    """
    model = np.empty_like(local)
    for i in range(local.shape[0]):
        p = int(parent[i])
        model[i] = local[i] if p < 0 else model[p] @ local[i]
    return model


def quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix (3x3 block of 4x4) -> quaternion (x, y, z, w), host-side."""
    m = np.asarray(m, np.float64)
    r = m[:3, :3]
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                      (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = np.array([0.25 * s, (r[0, 1] + r[1, 0]) / s,
                      (r[0, 2] + r[2, 0]) / s, (r[2, 1] - r[1, 2]) / s])
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = np.array([(r[0, 1] + r[1, 0]) / s, 0.25 * s,
                      (r[1, 2] + r[2, 1]) / s, (r[0, 2] - r[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = np.array([(r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s,
                      0.25 * s, (r[1, 0] - r[0, 1]) / s])
    return (q / np.linalg.norm(q)).astype(np.float32)


def topological_levels(parent: np.ndarray) -> list[np.ndarray]:
    """Group bone indices by depth for level-parallel FK."""
    n = len(parent)
    depth = np.zeros(n, np.int32)
    for i in range(n):
        p = int(parent[i])
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = []
    for d in range(int(depth.max()) + 1 if n else 0):
        levels.append(np.nonzero(depth == d)[0].astype(np.int32))
    return levels
