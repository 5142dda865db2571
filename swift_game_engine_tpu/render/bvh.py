"""Render BVH: host build, per-frame device refit, stackless lockstep traversal.

The reference leans on Metal's opaque acceleration-structure API (BLAS build
+ refit, TLAS over instances — reference: Game/RTAccelerationBuilder.swift:10-247).
Here the engine owns the structure:

  * **Build (host, once per scene):** median-split over triangle AABB
    centroids with a largest-axis pivot and a sorted-split fallback, leaf
    size <= 4 — the same topology policy as the reference's collision BVH
    (Game/CollisionQuery.swift:496-707), reused here for rendering. Nodes
    are emitted in *preorder*, so during traversal "descend" is `node + 1`
    and a precomputed `skip` link jumps over a rejected subtree: traversal
    needs no stack and every ray runs the identical loop.
  * **Refit (device, per frame):** triangle AABBs from the (skinned /
    instance-transformed) world vertices, then level-ordered
    internal-node merges — pure gathers + mins, runs inside the frame jit
    (mirrors the reference's dynamic BLAS refit).
  * **Traversal (device):** a while loop over `(node, skip)` pointers per
    ray (``traverse``, vmapped: the plain reference), or the GPU kernel in
    ``ops.rt_kernel`` reading the packed row layout (``pack_rows``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..physics.primitives import ray_triangle

LEAF_SIZE = 4
BIG = np.float32(3.0e38)

# Packed row layout (``pack_rows``), one row of ROW f32 per node:
#   [0:3] bmin   [3:6] bmax   [6] skip link   [7] leaf flag
#   [ROW_TRIS + 9j : ROW_TRIS + 9j + 9]  triangle j as (a, b-a, c-a)
#   [ROW_IDS + j]  triangle j's original id (-1 if empty)
# LEAF_SLOTS = 12 fills a 512-byte row exactly (8 + 9*12 + 12 = 128); the
# render tree is built with this leaf size.
LEAF_SLOTS = 12
ROW_TRIS = 8
ROW_IDS = ROW_TRIS + 9 * LEAF_SLOTS
ROW = ROW_IDS + LEAF_SLOTS


class BVHTopology(NamedTuple):
    """Static (host-built) structure. Node arrays are preorder."""

    skip: np.ndarray          # (M,) int32 — next node if subtree rejected (-1 = exit)
    first_tri: np.ndarray     # (M,) int32 — start into leaf_tris (leaves only)
    tri_count: np.ndarray     # (M,) int32 — 0 for internal nodes
    left: np.ndarray          # (M,) int32 — child indices (internal), -1 at leaves
    right: np.ndarray         # (M,) int32
    tri_order: np.ndarray     # (T,) int32 — triangle permutation, leaf-contiguous
    levels: tuple             # tuple of int32 arrays: internal nodes by depth, deepest first
    leaf_slots: np.ndarray    # (M, LEAF_SIZE) int32 triangle ids (-1 padded), in tri_order space

    @property
    def node_count(self):
        return len(self.skip)


def build_bvh(tri_min: np.ndarray, tri_max: np.ndarray) -> BVHTopology:
    """Median-split build over triangle AABBs (host, numpy, iterative)."""
    t = len(tri_min)
    assert t > 0
    centroids = (tri_min + tri_max) * 0.5
    order = np.arange(t, dtype=np.int64)

    skip, first_tri, tri_count, left, right, parent, depth = [], [], [], [], [], [], []

    # Iterative preorder build: stack of (start, count, parent_idx, depth).
    # Children are processed left-first so node emission order is preorder.
    stack = [(0, t, -1, 0, False)]  # (start, count, parent, depth, is_right)
    # We need two passes for child links; record ranges then fix up.
    node_range = []

    while stack:
        start, count, par, dep, is_right = stack.pop()
        idx = len(skip)
        skip.append(-1)
        first_tri.append(start)
        tri_count.append(0)
        left.append(-1)
        right.append(-1)
        parent.append(par)
        depth.append(dep)
        node_range.append((start, count))
        if par >= 0:
            if is_right:
                right[par] = idx
            else:
                left[par] = idx

        if count <= LEAF_SIZE:
            tri_count[idx] = count
            continue

        seg = order[start:start + count]
        c = centroids[seg]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        axis = int(np.argmax(cmax - cmin))
        pivot = 0.5 * (cmin[axis] + cmax[axis])
        mask = c[:, axis] < pivot
        n_left = int(mask.sum())
        if n_left == 0 or n_left == count:
            # Sorted-split fallback (CollisionQuery.swift:637-653).
            perm = np.argsort(c[:, axis], kind="stable")
            order[start:start + count] = seg[perm]
            n_left = count // 2
        else:
            order[start:start + count] = np.concatenate([seg[mask], seg[~mask]])
        # Push right first so left pops first (preorder).
        stack.append((start + n_left, count - n_left, idx, dep + 1, True))
        stack.append((start, n_left, idx, dep + 1, False))

    m = len(skip)
    skip_arr = np.full(m, -1, np.int32)
    left_arr = np.asarray(left, np.int32)
    right_arr = np.asarray(right, np.int32)
    parent_arr = np.asarray(parent, np.int32)
    tri_count_arr = np.asarray(tri_count, np.int32)
    first_tri_arr = np.asarray(first_tri, np.int32)

    # skip links: skip(left child) = right sibling; skip(right child) = skip(parent).
    for i in range(m):
        p = parent_arr[i]
        if p < 0:
            skip_arr[i] = -1
        elif left_arr[p] == i:
            skip_arr[i] = right_arr[p]
        else:
            skip_arr[i] = skip_arr[p]

    # Internal-node levels, deepest first (for bottom-up refit).
    depth_arr = np.asarray(depth, np.int32)
    internal = np.nonzero(tri_count_arr == 0)[0]
    levels = []
    if len(internal):
        for d in range(int(depth_arr[internal].max()), -1, -1):
            lv = internal[depth_arr[internal] == d]
            if len(lv):
                levels.append(lv.astype(np.int32))

    leaf_slots = np.full((m, LEAF_SIZE), -1, np.int32)
    for i in range(m):
        c = tri_count_arr[i]
        if c > 0:
            s = first_tri_arr[i]
            leaf_slots[i, :c] = np.arange(s, s + c)

    return BVHTopology(
        skip=skip_arr, first_tri=first_tri_arr, tri_count=tri_count_arr,
        left=left_arr, right=right_arr, tri_order=order.astype(np.int32),
        levels=tuple(levels), leaf_slots=leaf_slots)


def build_bvh_morton(tri_min: np.ndarray, tri_max: np.ndarray,
                     leaf_size: int = 12) -> BVHTopology:
    """Morton-ordered balanced build: LBVH-style topology in O(T log T).

    Sorts triangles by the 30-bit Morton code of their centroid, then builds
    a balanced binary tree over contiguous ranges (leaf <= 4). Per-node cost
    is pure index arithmetic — ~100x faster host build than the median-split
    path for large scenes; node bounds come from the device refit either way.
    Equivalent to the reference's Metal BLAS-build offload in spirit: fast
    build, spatial quality traded slightly against the median split.
    """
    t = len(tri_min)
    assert t > 0
    c = (tri_min + tri_max) * 0.5
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-9)
    q = np.clip(((c - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order = np.argsort(morton, kind="stable").astype(np.int64)
    codes = morton[order].astype(np.uint64)

    def radix_split(start, count):
        """Karras-style split: partition where the highest differing Morton
        bit flips (spatial octree-like quality); falls back to halving when
        the range shares one code."""
        first = int(codes[start])
        last = int(codes[start + count - 1])
        if first == last:
            return count // 2
        bit = 1 << (int(first ^ last).bit_length() - 1)   # highest differing bit
        target = (first & ~((bit << 1) - 1)) | bit
        lo = int(np.searchsorted(codes[start:start + count], target))
        return min(max(lo, 1), count - 1)

    skip, first_tri, tri_count, left, right, parent, depth = [], [], [], [], [], [], []
    stack = [(0, t, -1, 0, False)]
    while stack:
        start, count, par, dep, is_right = stack.pop()
        idx = len(skip)
        skip.append(-1)
        first_tri.append(start)
        tri_count.append(0)
        left.append(-1)
        right.append(-1)
        parent.append(par)
        depth.append(dep)
        if par >= 0:
            if is_right:
                right[par] = idx
            else:
                left[par] = idx
        if count <= leaf_size:
            tri_count[idx] = count
            continue
        if count <= 2 * leaf_size:
            # Terminal split: emit one full leaf (keeps average leaf
            # occupancy high — tree bytes scale with node count).
            n_left = min(leaf_size, count - 1)
        else:
            n_left = radix_split(start, count)
        stack.append((start + n_left, count - n_left, idx, dep + 1, True))
        stack.append((start, n_left, idx, dep + 1, False))

    m = len(skip)
    skip_arr = np.full(m, -1, np.int32)
    left_arr = np.asarray(left, np.int32)
    right_arr = np.asarray(right, np.int32)
    parent_arr = np.asarray(parent, np.int32)
    tri_count_arr = np.asarray(tri_count, np.int32)
    first_tri_arr = np.asarray(first_tri, np.int32)
    for i in range(m):
        p = parent_arr[i]
        if p < 0:
            skip_arr[i] = -1
        elif left_arr[p] == i:
            skip_arr[i] = right_arr[p]
        else:
            skip_arr[i] = skip_arr[p]

    depth_arr = np.asarray(depth, np.int32)
    internal = np.nonzero(tri_count_arr == 0)[0]
    levels = []
    if len(internal):
        for d in range(int(depth_arr[internal].max()), -1, -1):
            lv = internal[depth_arr[internal] == d]
            if len(lv):
                levels.append(lv.astype(np.int32))

    leaf_slots = np.full((m, leaf_size), -1, np.int32)
    leaves = np.nonzero(tri_count_arr > 0)[0]
    for i in leaves:
        cn = tri_count_arr[i]
        s = first_tri_arr[i]
        leaf_slots[i, :cn] = np.arange(s, s + cn)

    return BVHTopology(
        skip=skip_arr, first_tri=first_tri_arr, tri_count=tri_count_arr,
        left=left_arr, right=right_arr, tri_order=order.astype(np.int32),
        levels=tuple(levels), leaf_slots=leaf_slots)


class BVHArrays(NamedTuple):
    """Device-side refit output: node bounds + leaf triangle data.

    ``rows`` is the packed row-per-node layout (``pack_rows``) the GPU
    traversal kernel (ops.rt_kernel) reads.
    """

    bmin: jnp.ndarray      # (M,3)
    bmax: jnp.ndarray      # (M,3)
    skip: jnp.ndarray      # (M,)
    is_leaf: jnp.ndarray   # (M,) bool
    slot_tri: jnp.ndarray  # (M, LEAF_SIZE) original triangle ids (-1 padded)
    v0: jnp.ndarray        # (T,3) world-space tri verts (original order)
    v1: jnp.ndarray
    v2: jnp.ndarray
    rows: jnp.ndarray      # (M, ROW) kernel layout


def pack_rows(bmin, bmax, skip, is_leaf, slot_tri, v0, v1, v2):
    """Node arrays -> (M, ROW) packed rows (see the layout above)."""
    m, k = slot_tri.shape
    assert k <= LEAF_SLOTS, f"leaf width {k} exceeds row capacity {LEAF_SLOTS}"
    if k < LEAF_SLOTS:
        slot_tri = jnp.concatenate(
            [slot_tri, jnp.full((m, LEAF_SLOTS - k), -1, slot_tri.dtype)], 1)
    safe = jnp.maximum(slot_tri, 0)
    a = v0[safe]                                        # (M,LEAF_SLOTS,3)
    tris = jnp.concatenate([a, v1[safe] - a, v2[safe] - a], axis=-1)
    return jnp.concatenate([
        bmin, bmax,
        skip.astype(jnp.float32)[:, None],
        is_leaf.astype(jnp.float32)[:, None],
        tris.reshape(m, 9 * LEAF_SLOTS),
        slot_tri.astype(jnp.float32),
    ], axis=-1)


def refit(topo: BVHTopology, v0, v1, v2) -> BVHArrays:
    """Recompute all node AABBs from current world-space triangles (jit-safe).

    Leaf bounds from their <= 4 triangles; internal bounds by level-ordered
    child merges (mirrors RTAccelerationBuilder's refit +
    CollisionQuery.swift:528-575's deepest-first parent pass).
    """
    t_order = jnp.asarray(topo.tri_order)
    tri_min = jnp.minimum(jnp.minimum(v0, v1), v2)[t_order]   # ordered space
    tri_max = jnp.maximum(jnp.maximum(v0, v1), v2)[t_order]

    m = topo.node_count
    slots = jnp.asarray(topo.leaf_slots)            # (M,4) into ordered space
    slot_valid = slots >= 0
    safe = jnp.maximum(slots, 0)
    leaf_min = jnp.min(jnp.where(slot_valid[..., None], tri_min[safe], BIG), axis=1)
    leaf_max = jnp.max(jnp.where(slot_valid[..., None], tri_max[safe], -BIG), axis=1)

    bmin = leaf_min
    bmax = leaf_max
    left = jnp.asarray(topo.left)
    right = jnp.asarray(topo.right)
    for lv in topo.levels:
        lv = jnp.asarray(lv)
        l_idx = left[lv]
        r_idx = right[lv]
        bmin = bmin.at[lv].set(jnp.minimum(bmin[l_idx], bmin[r_idx]))
        bmax = bmax.at[lv].set(jnp.maximum(bmax[l_idx], bmax[r_idx]))

    # slot_tri in ORIGINAL triangle ids for attribute lookup.
    slot_tri = jnp.where(slot_valid, t_order[safe], -1)
    skip = jnp.asarray(topo.skip)
    is_leaf = jnp.asarray(topo.tri_count > 0)
    return BVHArrays(bmin=bmin, bmax=bmax, skip=skip, is_leaf=is_leaf,
                     slot_tri=slot_tri, v0=v0, v1=v1, v2=v2,
                     rows=pack_rows(bmin, bmax, skip, is_leaf, slot_tri,
                                    v0, v1, v2))


def traverse(bvh: BVHArrays, origin, direction, t_max, max_steps: int = None):
    """Nearest-hit traversal for one ray. vmap over rays.

    Returns (t, tri_index, bary_u, bary_v, hit). ``tri_index`` is in original
    triangle id space. A ray with ``t_max <= 0`` is inactive and exits at
    once. ``max_steps`` defaults to a full-walk bound (every
    node visited once) — a fixed small cap silently truncates traversal on
    larger trees and returns farther hits (caught by the raster-primary
    parity test at 512).
    """
    if max_steps is None:
        max_steps = int(bvh.skip.shape[0]) + 2
    inv = 1.0 / jnp.where(jnp.abs(direction) < 1e-12,
                          jnp.where(direction < 0, -1e-12, 1e-12), direction)

    def cond(c):
        node, t_best, _, _, tri_best, step = c
        return (node >= 0) & (step < max_steps)

    def body(c):
        node, t_best, u_best, v_best, tri_best, step = c
        nb_min = bvh.bmin[node]
        nb_max = bvh.bmax[node]
        t0 = (nb_min - origin) * inv
        t1 = (nb_max - origin) * inv
        tmin = jnp.max(jnp.minimum(t0, t1))
        tmax = jnp.min(jnp.maximum(t0, t1))
        box_hit = (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_best)

        leaf = bvh.is_leaf[node]
        slots = bvh.slot_tri[node]                    # (4,)
        s_ok = (slots >= 0) & box_hit & leaf
        s_safe = jnp.maximum(slots, 0)
        hit, t = ray_triangle(origin, direction,
                              bvh.v0[s_safe], bvh.v1[s_safe], bvh.v2[s_safe])
        hit = hit & s_ok & (t < t_best) & (t > 1e-4)
        t = jnp.where(hit, t, BIG)
        k = jnp.argmin(t)
        better = t[k] < t_best
        t_best = jnp.where(better, t[k], t_best)
        tri_best = jnp.where(better, slots[k], tri_best)

        descend = box_hit & ~leaf
        node = jnp.where(descend, node + 1, bvh.skip[node])
        return node, t_best, u_best, v_best, tri_best, step + 1

    t_max = jnp.asarray(t_max, jnp.float32)
    init = (jnp.where(t_max > 0, 0, -1).astype(jnp.int32), t_max,
            jnp.float32(0.0),
            jnp.float32(0.0), jnp.int32(-1), jnp.int32(0))
    node, t_best, _, _, tri_best, _ = jax.lax.while_loop(cond, body, init)

    found = tri_best >= 0
    # Recover barycentrics for the best triangle (one extra intersection).
    safe_tri = jnp.maximum(tri_best, 0)
    a = bvh.v0[safe_tri]
    b = bvh.v1[safe_tri]
    c = bvh.v2[safe_tri]
    p = origin + direction * t_best
    # Barycentric via edge projections.
    ab = b - a
    ac = c - a
    ap = p - a
    d00 = jnp.dot(ab, ab)
    d01 = jnp.dot(ab, ac)
    d11 = jnp.dot(ac, ac)
    d20 = jnp.dot(ap, ab)
    d21 = jnp.dot(ap, ac)
    denom = jnp.maximum(d00 * d11 - d01 * d01, 1e-20)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return t_best, tri_best, u, v, found
