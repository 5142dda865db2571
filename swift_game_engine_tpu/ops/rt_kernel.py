"""Closest-hit BVH traversal kernel for NVIDIA GPUs (Pallas, Triton route).

This is the engine's equivalent of the reference's hardware intersector
(`intersector.intersect`, Game/RayTracing.metalinc:242).

Design: every ray walks the stackless preorder skip-link tree
(render.bvh) on its own. A program owns ``RAYS_PER_PROGRAM`` rays, one per
thread; each ray keeps only its node cursor, its best ``t`` and its best
triangle id in registers. A step gathers the node's 8-float header
(bounds, skip link, leaf flag) for every live lane: a box hit on an interior
node descends to ``node + 1``, a miss or a leaf follows the skip link. Leaf
triangle tests run when any lane of the program stands on a leaf it hits;
their loads are masked to those lanes. The tree (``render.bvh.pack_rows``:
one 512-byte row per node) stays in device memory and is read through the
caches; a full-fidelity DemoScene tree is a few tens of MB and fits in L2.

The results match ``render.bvh.traverse`` (the plain reference): the same
slab test, the same Moller-Trumbore test with ``t > 1e-4``, and within a
leaf the first of equal minima wins.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..render.bvh import LEAF_SLOTS, ROW, ROW_IDS, ROW_TRIS

# Rays per program: one ray per thread of 4 warps.
RAYS_PER_PROGRAM = 128
NUM_WARPS = 4
_EPS = 1e-6


def _kernel(rows_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            tmax_ref, t_ref, tri_ref):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    t_max = tmax_ref[...]

    def safe_inv(v):
        tiny = jnp.abs(v) < 1e-12
        return 1.0 / jnp.where(tiny, jnp.where(v < 0, -1e-12, 1e-12), v)

    inv_x, inv_y, inv_z = safe_inv(dx), safe_inv(dy), safe_inv(dz)

    def leaf_tests(base, on_leaf, t_best, tri_best):
        for j in range(LEAF_SLOTS):
            tri_id = plgpu.load(rows_ref.at[base + (ROW_IDS + j)],
                                mask=on_leaf, other=-1.0)
            valid = on_leaf & (tri_id >= 0)
            tb = base + (ROW_TRIS + 9 * j)

            def g(k):
                return plgpu.load(rows_ref.at[tb + k], mask=valid, other=0.0)

            ax, ay, az = g(0), g(1), g(2)
            e1x, e1y, e1z = g(3), g(4), g(5)
            e2x, e2y, e2z = g(6), g(7), g(8)
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = jnp.abs(det) >= _EPS
            inv_det = 1.0 / jnp.where(ok, det, 1.0)
            tvx, tvy, tvz = ox - ax, oy - ay, oz - az
            u = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * e1z - tvz * e1y
            qy = tvz * e1x - tvx * e1z
            qz = tvx * e1y - tvy * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            hit = valid & ok & (u >= 0) & (u <= 1) & (v >= 0) & \
                (u + v <= 1) & (t > 1e-4) & (t < t_best)
            t_best = jnp.where(hit, t, t_best)
            tri_best = jnp.where(hit, tri_id, tri_best)
        return t_best, tri_best

    def cond(c):
        return jnp.max(c[0]) >= 0

    def body(c):
        node, t_best, tri_best = c
        alive = node >= 0
        base = jnp.maximum(node, 0) * ROW

        def h(k):
            return rows_ref[base + k]

        tx0 = (h(0) - ox) * inv_x
        tx1 = (h(3) - ox) * inv_x
        ty0 = (h(1) - oy) * inv_y
        ty1 = (h(4) - oy) * inv_y
        tz0 = (h(2) - oz) * inv_z
        tz1 = (h(5) - oz) * inv_z
        tmin = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                       jnp.minimum(ty0, ty1)),
                           jnp.minimum(tz0, tz1))
        tmax = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                       jnp.maximum(ty0, ty1)),
                           jnp.maximum(tz0, tz1))
        box_hit = alive & (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < t_best)
        is_leaf = h(7) > 0.5
        on_leaf = box_hit & is_leaf
        t_best, tri_best = jax.lax.cond(
            jnp.max(on_leaf.astype(jnp.int32)) > 0,
            lambda a: leaf_tests(base, on_leaf, *a), lambda a: a,
            (t_best, tri_best))
        skip = h(6).astype(jnp.int32)
        node = jnp.where(alive, jnp.where(box_hit & ~is_leaf, node + 1, skip),
                         -1)
        return node, t_best, tri_best

    node0 = jnp.where(t_max > 0, 0, -1).astype(jnp.int32)
    tri0 = jnp.full(t_max.shape, -1.0, jnp.float32)
    _, t_best, tri_best = jax.lax.while_loop(cond, body, (node0, t_max, tri0))
    t_ref[...] = t_best
    tri_ref[...] = tri_best.astype(jnp.int32)


def trace_rays(rows, o, d, t_max, interpret: bool = False):
    """Closest hit for a flat ray batch.

    ``rows``: (M, ROW) packed tree (``render.bvh.pack_rows``); ``o``/``d``:
    (N, 3); ``t_max``: (N,) — lanes with ``t_max <= 0`` are inactive and
    exit at once. Returns (t (N,) f32, tri (N,) int32): ``tri`` is the
    original triangle id, -1 (with ``t == t_max``) where nothing was hit.
    ``interpret`` runs the kernel in the Pallas interpreter (tests only).
    """
    n = o.shape[0]
    pad = (-n) % RAYS_PER_PROGRAM
    t_max = jnp.asarray(t_max, jnp.float32)
    if pad:
        o = jnp.pad(o, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        t_max = jnp.pad(t_max, (0, pad))
    n_pad = n + pad
    lanes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max]
    lane_spec = pl.BlockSpec((RAYS_PER_PROGRAM,), lambda i: (i,))
    out_shape = (jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                 jax.ShapeDtypeStruct((n_pad,), jnp.int32))
    t, tri = pl.pallas_call(
        _kernel,
        grid=(n_pad // RAYS_PER_PROGRAM,),
        in_specs=[pl.no_block_spec] + [lane_spec] * 7,
        out_specs=(lane_spec, lane_spec),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="bvh_closest_hit",
    )(rows.reshape(-1), *lanes)
    return t[:n], tri[:n]
