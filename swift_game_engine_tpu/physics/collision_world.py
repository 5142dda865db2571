"""Collision world: triangle soup baking + per-step retransform.

The reference keeps two incremental triangle sets (static / dynamic) with a
median-split BVH refit per frame and per-query stack traversal
(reference: Game/CollisionQuery.swift:320-470, 496-707). Here the
broadphase tree is replaced by *batched brute force with an AABB prefilter*:
queries evaluate (agents x triangles) pairs in one fused program — for
scene-scale collision sets (hull-decimated meshes, hundreds to a few
thousand triangles) this is faster than divergent traversal and has zero
build/refit cost.

Triangles are stored in *local space* with a per-triangle entity index; a
single jitted ``transform_soup`` re-bakes world-space vertices from the
entity transform array every step, which subsumes the reference's
static/dynamic split and incremental refit (static entity transforms simply
don't change). Arrays are padded to a multiple of 128 with invalid lanes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from .primitives import triangle_normal

LAYER_ALL = np.uint32(0xFFFFFFFF)
LAYER_DEFAULT = np.uint32(1)


class TriangleSoup(NamedTuple):
    """World-space triangle arrays (T padded).

    ``tri_id`` carries GLOBAL triangle ids: the full soup uses arange, and
    per-agent candidate sub-soups (see queries.gather_candidates) carry the
    ids of the gathered rows — query results always report global ids, so
    tri identity survives across substeps regardless of candidate order
    (the manifold cache and ground-tri change detection compare them)."""

    v0: jnp.ndarray       # (T,3)
    v1: jnp.ndarray       # (T,3)
    v2: jnp.ndarray       # (T,3)
    normal: jnp.ndarray   # (T,3) geometric normal
    mu_s: jnp.ndarray     # (T,)
    mu_k: jnp.ndarray     # (T,)
    flatten: jnp.ndarray  # (T,) bool
    layer: jnp.ndarray    # (T,) uint32
    valid: jnp.ndarray    # (T,) bool
    tri_id: jnp.ndarray   # (T,) int32 global triangle id

    @property
    def aabb(self):
        bmin = jnp.minimum(jnp.minimum(self.v0, self.v1), self.v2)
        bmax = jnp.maximum(jnp.maximum(self.v0, self.v1), self.v2)
        return bmin, bmax


class LocalTriangles(NamedTuple):
    """Local-space triangle arrays + per-triangle entity binding."""

    p0: jnp.ndarray       # (T,3) local
    p1: jnp.ndarray
    p2: jnp.ndarray
    entity: jnp.ndarray   # (T,) int32 index into the transform array
    mu_s: jnp.ndarray
    mu_k: jnp.ndarray
    flatten: jnp.ndarray
    layer: jnp.ndarray
    valid: jnp.ndarray


class CollisionWorldBuilder:
    """Host-side accumulation of collision meshes into padded arrays."""

    def __init__(self):
        self._tris = []  # list of per-mesh dicts

    def add_mesh(self, positions, indices, entity: int,
                 mu_s: float = 0.8, mu_k: float = 0.6, flatten: bool = False,
                 layer: int = int(LAYER_DEFAULT), per_tri_materials=None):
        """Add a triangle mesh bound to a transform slot ``entity``.

        Degenerate triangles are culled at build time
        (reference: Game/CollisionQuery.swift:341-389, areaEps 1e-10 on the
        squared cross length).
        """
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        tri = np.asarray(indices, np.int64).reshape(-1, 3)
        p0 = positions[tri[:, 0]]
        p1 = positions[tri[:, 1]]
        p2 = positions[tri[:, 2]]
        area2 = np.sum(np.cross(p1 - p0, p2 - p0) ** 2, axis=1)
        keep = area2 > 1e-10
        n = int(keep.sum())
        if n == 0:
            return
        if per_tri_materials is not None and len(per_tri_materials) == len(tri):
            mats = np.asarray(per_tri_materials, np.float32)[keep]  # (n, 3): mu_s, mu_k, flatten
            mu_s_arr = mats[:, 0]
            mu_k_arr = mats[:, 1]
            flat_arr = mats[:, 2] > 0.5
        else:
            mu_s_arr = np.full(n, mu_s, np.float32)
            mu_k_arr = np.full(n, mu_k, np.float32)
            flat_arr = np.full(n, flatten, bool)
        self._tris.append(dict(
            p0=p0[keep], p1=p1[keep], p2=p2[keep],
            entity=np.full(n, entity, np.int32),
            mu_s=mu_s_arr, mu_k=mu_k_arr, flatten=flat_arr,
            layer=np.full(n, layer, np.uint32),
        ))

    def build(self, pad_to: int = 128) -> LocalTriangles:
        if not self._tris:
            t = 0
        else:
            t = sum(len(m["p0"]) for m in self._tris)
        padded = max(pad_to, ((t + pad_to - 1) // pad_to) * pad_to)

        def cat(key, dtype, fill=0):
            if t == 0:
                arr = np.zeros((0, 3) if key in ("p0", "p1", "p2") else 0, dtype)
            else:
                arr = np.concatenate([m[key] for m in self._tris])
            shape = (padded, 3) if arr.ndim == 2 else (padded,)
            out = np.full(shape, fill, dtype)
            out[:t] = arr
            return out

        valid = np.zeros(padded, bool)
        valid[:t] = True
        return LocalTriangles(
            p0=jnp.asarray(cat("p0", np.float32)),
            p1=jnp.asarray(cat("p1", np.float32)),
            p2=jnp.asarray(cat("p2", np.float32)),
            entity=jnp.asarray(cat("entity", np.int32)),
            mu_s=jnp.asarray(cat("mu_s", np.float32)),
            mu_k=jnp.asarray(cat("mu_k", np.float32)),
            flatten=jnp.asarray(cat("flatten", bool)),
            layer=jnp.asarray(cat("layer", np.uint32)),
            valid=jnp.asarray(valid),
        )


def transform_soup(local: LocalTriangles, transforms,
                   entity_alive=None) -> TriangleSoup:
    """Bake local triangles to world space from per-entity 4x4 transforms.

    ``transforms``: (E, 4, 4). Runs under jit each fixed step — replaces the
    reference's incremental updateTransforms + BVH refit. ``entity_alive``
    ((E,) bool, optional) invalidates triangles bound to despawned entities
    (the destroyEntity analog of the reference's structural rebuild).
    """
    m = transforms[local.entity]               # (T,4,4)
    rot = m[..., :3, :3]
    t = m[..., :3, 3]

    def xf(p):
        return jnp.einsum("tij,tj->ti", rot, p) + t

    v0, v1, v2 = xf(local.p0), xf(local.p1), xf(local.p2)
    valid = local.valid
    if entity_alive is not None:
        valid = valid & entity_alive[local.entity]
    return TriangleSoup(
        v0=v0, v1=v1, v2=v2,
        normal=triangle_normal(v0, v1, v2),
        mu_s=local.mu_s, mu_k=local.mu_k, flatten=local.flatten,
        layer=local.layer, valid=valid,
        tri_id=jnp.arange(v0.shape[0], dtype=jnp.int32),
    )
