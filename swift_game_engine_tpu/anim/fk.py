"""Level-parallel forward kinematics in translation/quaternion form.

The reference walks bones sequentially, multiplying 4x4 locals by parent
model transforms (Game/Skeleton.swift:175-203). On an accelerator that shape
is wrong: a 65-step sequential chain serializes every bone. Here:

  * Rigid transforms are carried as ``(t, q)`` pairs — (B, 3) translations and
    (B, 4) quaternions — so every FK step is a handful of fused elementwise
    ops instead of 4x4 matmuls.
  * Bones are grouped by tree depth and *permuted into level order* at load
    time, so each level's update is a contiguous ``dynamic_update_slice``
    (cheap for XLA) and parent lookups are static-index gathers.
  * Matrices are materialized exactly once at the end (for the skinning
    palette / render transforms).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import math3d as m3


class FKSolver:
    """Precomputed per-skeleton FK plan. Static; safe to close over in jit."""

    def __init__(self, parent: np.ndarray, levels):
        parent = np.asarray(parent, np.int32)
        b = len(parent)
        # Permutation sorting bones by level (stable within a level).
        perm = np.concatenate([np.asarray(lv, np.int64) for lv in levels]) if b else np.zeros(0, np.int64)
        inv_perm = np.empty(b, np.int64)
        inv_perm[perm] = np.arange(b)
        self.perm = perm.astype(np.int32)
        self.inv_perm = inv_perm.astype(np.int32)
        # Level ranges in permuted space + permuted-space parent indices.
        self.ranges = []
        pos = 0
        for li, lv in enumerate(levels):
            n = len(lv)
            if li > 0 and n > 0:
                pparent = inv_perm[parent[np.asarray(lv, np.int64)]].astype(np.int32)
                self.ranges.append((pos, n, pparent))
            pos += n
        self.bone_count = b

    def model_tq(self, t_local, q_local):
        """FK over (t, q) locals.

        Args:
          t_local: (B, 3); q_local: (B, 4) — unbatched (vmap for batches).
        Returns:
          (t_model (B, 3), q_model (B, 4)) in model space.
        """
        t_p = t_local[self.perm]
        q_p = q_local[self.perm]
        t_m, q_m = t_p, q_p
        for start, n, pparent in self.ranges:
            pt = t_m[pparent]
            pq = q_m[pparent]
            lt = t_p[start:start + n]
            lq = q_p[start:start + n]
            new_q = m3.quat_mul(pq, lq)
            new_t = pt + m3.quat_act(pq, lt)
            t_m = t_m.at[start:start + n].set(new_t)
            q_m = q_m.at[start:start + n].set(new_q)
        return t_m[self.inv_perm], q_m[self.inv_perm]

    def model_matrices(self, t_local, q_local):
        """FK then materialize (B, 4, 4) model matrices once."""
        t_m, q_m = self.model_tq(t_local, q_local)
        mat = m3.mat4_from_quat(q_m)
        return mat.at[..., :3, 3].set(t_m)


def palette_from_model(model, inv_bind_model):
    """Skinning palette = model @ invBind (reference: ProceduralPoseSystem.swift:400-402)."""
    return jnp.matmul(model, inv_bind_model)
