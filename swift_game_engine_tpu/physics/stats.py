"""Collision query statistics (reference: Game/CollisionQuery.swift:280-318).

The reference counts broadphase candidates, sweep tests and
conservative-advancement iterations per query, reset each substep
(Systems.swift:176). The engine's queries are lockstep, so the analogous
numbers are exact array reductions; this probe runs the standard query set
for a set of agents outside the hot path (the per-substep pipeline stays a
pure state -> state function).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .collision_world import TriangleSoup
from .primitives import aabb_overlap
from . import queries as Q


class CollisionQueryStats(NamedTuple):
    capsule_candidate_count: jnp.ndarray   # broadphase AABB-overlap pairs
    capsule_sweep_count: jnp.ndarray       # narrowphase lanes evaluated
    capsule_sweep_iterations: jnp.ndarray  # total CA iterations
    capsule_sweep_max_iterations: jnp.ndarray


@jax.jit
def capsule_cast_stats(soup: TriangleSoup, positions, deltas, radius,
                       half_height) -> CollisionQueryStats:
    """Stats for a batch of capsule casts (positions/deltas (N,3))."""

    def one(p, d, r, hh):
        up = jnp.array([0.0, 1.0, 0.0]) * hh
        ends = jnp.stack([p + up, p - up, p + up + d, p - up + d])
        qmin = ends.min(axis=0) - r
        qmax = ends.max(axis=0) + r
        tmin, tmax = soup.aabb
        cand = soup.valid & aabb_overlap(qmin, qmax, tmin, tmax)
        hit = Q.capsule_cast(soup, p, d, r, hh)
        return cand.sum(), soup.valid.sum(), hit.iterations

    cands, sweeps, iters = jax.vmap(one)(positions, deltas, radius, half_height)
    return CollisionQueryStats(
        capsule_candidate_count=cands.sum(),
        capsule_sweep_count=sweeps.sum(),
        capsule_sweep_iterations=iters.sum(),
        capsule_sweep_max_iterations=iters.max(),
    )
