"""Kinematic character controller: move-and-slide with ground snap.

Array re-design of the reference's per-entity controller pipeline
(reference: Game/Systems.swift:1402-1903 KinematicMoveStopSystem, plus the
helper resolvers at :644-1399). All N agents advance in lockstep: the
sequential per-entity loop becomes vmapped branchless stages, early ``break``s
become done-masks, and the per-query BVH traversals become the batched soup
queries in ``physics.queries``. Agent-vs-agent sweeps use the *start-of-step
snapshot* of all agents — exactly the reference's ``agentStates`` capture
(Systems.swift:1592-1611,1837), so batching does not change semantics.

Per-substep stage order (= reference :1842-1901):
  decay contact cache -> platform carry -> velocity gate ->
  pre-sweep depenetration (<=4 iters) -> slide loop (<=4 iters of
  blocking static cast + agent sweep + slide resolve + crease clamp) ->
  ground probe/snap/slope friction -> writeback.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from .. import math3d as m3
from .collision_world import TriangleSoup
from . import queries as Q
from .capsule_pair import capsule_capsule_sweep

BIG = np.float32(3.0e38)
UP = np.array([0.0, 1.0, 0.0], np.float32)
DOWN = np.array([0.0, -1.0, 0.0], np.float32)
MANIFOLD_SLOTS = 4          # reference ContactManifoldCache.maxCount
MANIFOLD_FRAMES = 8         # reference ContactManifoldCache.maxFrames
SIDE_FRAMES = 3


class ControllerParams(NamedTuple):
    """Per-agent tuning (reference: Components.swift:353-431 defaults)."""

    radius: jnp.ndarray
    half_height: jnp.ndarray
    skin_width: jnp.ndarray
    ground_snap_skin: jnp.ndarray
    snap_distance: jnp.ndarray
    fall_probe_distance: jnp.ndarray
    ground_snap_max_speed: jnp.ndarray
    ground_snap_max_toi: jnp.ndarray
    ground_snap_max_step: jnp.ndarray
    ground_sweep_max_step: jnp.ndarray
    min_ground_dot: jnp.ndarray
    collision_mask: jnp.ndarray      # uint32
    agent_radius: jnp.ndarray        # radiusOverride ?? radius
    agent_mass_weight: jnp.ndarray
    agent_solid: jnp.ndarray         # bool
    active: jnp.ndarray              # bool — inactive agents are skipped

    @staticmethod
    def default(n):
        f = lambda v: jnp.full((n,), v, jnp.float32)
        return ControllerParams(
            radius=f(1.5), half_height=f(1.0), skin_width=f(0.3),
            ground_snap_skin=f(0.05), snap_distance=f(0.8),
            fall_probe_distance=f(200.0), ground_snap_max_speed=f(5.0),
            ground_snap_max_toi=f(0.1), ground_snap_max_step=f(0.1),
            ground_sweep_max_step=f(0.1), min_ground_dot=f(0.5),
            collision_mask=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
            agent_radius=f(1.5), agent_mass_weight=f(1.0),
            agent_solid=jnp.ones((n,), bool), active=jnp.ones((n,), bool),
        )


class ControllerState(NamedTuple):
    """Mutable per-agent contact state."""

    grounded: jnp.ndarray            # (N,) bool
    grounded_near: jnp.ndarray       # (N,) bool
    ground_normal: jnp.ndarray       # (N,3)
    ground_tri: jnp.ndarray          # (N,) int32
    ground_sliding: jnp.ndarray      # (N,) bool
    ground_transition_frames: jnp.ndarray  # (N,) int32
    ground_distance: jnp.ndarray     # (N,)
    side_normal: jnp.ndarray         # (N,3)
    side_frames: jnp.ndarray         # (N,) int32
    manifold_tri: jnp.ndarray        # (N,4) int32 (-1 empty)
    manifold_normal: jnp.ndarray     # (N,4,3)
    manifold_frames: jnp.ndarray     # (N,) int32
    # Per-substep collision query stats, reset each pipeline step — the
    # array form of CollisionQueryStats counted per query and reset per
    # refresh (reference: CollisionQuery.swift:280-318, Systems.swift:176).
    query_candidates: jnp.ndarray    # (N,) int32 prefilter-passing triangles
    query_casts: jnp.ndarray         # (N,) int32 casts + overlap tests issued

    @staticmethod
    def initial(n):
        return ControllerState(
            grounded=jnp.zeros((n,), bool),
            grounded_near=jnp.zeros((n,), bool),
            ground_normal=jnp.tile(UP, (n, 1)),
            ground_tri=jnp.full((n,), -1, jnp.int32),
            ground_sliding=jnp.zeros((n,), bool),
            ground_transition_frames=jnp.zeros((n,), jnp.int32),
            ground_distance=jnp.full((n,), BIG),
            side_normal=jnp.zeros((n, 3), jnp.float32),
            side_frames=jnp.zeros((n,), jnp.int32),
            manifold_tri=jnp.full((n, MANIFOLD_SLOTS), -1, jnp.int32),
            manifold_normal=jnp.zeros((n, MANIFOLD_SLOTS, 3), jnp.float32),
            manifold_frames=jnp.zeros((n,), jnp.int32),
            query_candidates=jnp.zeros((n,), jnp.int32),
            query_casts=jnp.zeros((n,), jnp.int32),
        )


class PlatformSet(NamedTuple):
    """Kinematic platform AABBs + per-substep deltas (world space)."""

    aabb_min: jnp.ndarray  # (P,3)
    aabb_max: jnp.ndarray  # (P,3)
    delta: jnp.ndarray     # (P,3) position - prevPosition
    valid: jnp.ndarray     # (P,) bool

    @staticmethod
    def empty():
        return PlatformSet(aabb_min=jnp.zeros((1, 3)), aabb_max=jnp.zeros((1, 3)),
                           delta=jnp.zeros((1, 3)), valid=jnp.zeros((1,), bool))


class AgentSnapshot(NamedTuple):
    """Start-of-substep view of all agents for agent-agent sweeps."""

    position: jnp.ndarray     # (N,3)
    velocity: jnp.ndarray     # (N,3)
    radius: jnp.ndarray       # (N,)
    half_height: jnp.ndarray  # (N,)
    solid: jnp.ndarray        # (N,) bool


# ---------------------------------------------------------------------------
# Contact manifold cache (reference: Systems.swift:1093-1205)


def _manifold_lookup(tri, m_tri, m_normal):
    """Cached normal for a triangle, or zeros. Returns (normal, found)."""
    match = (m_tri == tri) & (m_tri >= 0)
    found = jnp.any(match)
    idx = jnp.argmax(match)
    return jnp.where(found, m_normal[idx], jnp.zeros(3)), found


def _manifold_update(tri, normal, m_tri, m_normal, m_frames, side_normal):
    """ContactManifoldCache.update semantics (Systems.swift:1177-1204)."""
    n_ok = jnp.sum(normal * normal) >= 1e-8
    frames = jnp.where(n_ok, MANIFOLD_FRAMES, m_frames)

    match = (m_tri == tri) & (m_tri >= 0)
    found = jnp.any(match)
    idx = jnp.argmax(match)
    cached = m_normal[idx]
    n_aligned = jnp.where(jnp.sum(cached * normal) < 0, -normal, normal)
    combined = m3.normalize(cached * 0.75 + n_aligned * 0.25)

    # Existing-entry path: blend in place.
    m_normal_upd = m_normal.at[idx].set(jnp.where(found & n_ok, combined, m_normal[idx]))
    side_upd = jnp.where(found & n_ok, combined, side_normal)

    # Insert-at-front path: shift (dropping last), put new at slot 0.
    shifted_tri = jnp.concatenate([tri[None].astype(jnp.int32), m_tri[:-1]])
    shifted_nrm = jnp.concatenate([m3.normalize(normal)[None], m_normal[:-1]])
    insert = (~found) & n_ok
    m_tri_out = jnp.where(insert, shifted_tri, m_tri)
    m_normal_out = jnp.where(insert, shifted_nrm, m_normal_upd)
    side_out = jnp.where(insert, m3.normalize(normal), side_upd)
    return m_tri_out, m_normal_out, frames, side_out


def _cache_record(tri, normal, is_side, m_tri, m_normal, m_frames,
                  side_normal, side_frames, enable):
    """DefaultContactCachePolicy.record (Systems.swift:1122-1133), masked."""
    nt, nn, nf, ns = _manifold_update(tri, normal, m_tri, m_normal, m_frames, side_normal)
    m_tri = jnp.where(enable, nt, m_tri)
    m_normal = jnp.where(enable, nn, m_normal)
    m_frames = jnp.where(enable, nf, m_frames)
    side_normal = jnp.where(enable, ns, side_normal)
    side_normal = jnp.where(enable & is_side, m3.normalize(normal), side_normal)
    side_frames = jnp.where(enable & is_side, SIDE_FRAMES, side_frames)
    return m_tri, m_normal, m_frames, side_normal, side_frames


# ---------------------------------------------------------------------------
# Platform carry (reference: Systems.swift:644-731)


def _platform_carry(position, params_radius, params_half_height, skin_width,
                    ground_snap_skin, snap_distance, platforms: PlatformSet):
    cap_half = params_half_height + params_radius
    base_y = position[1] - cap_half
    cap_min = position - jnp.array([1.0, 0.0, 1.0]) * params_radius - jnp.array([0.0, 1.0, 0.0]) * cap_half
    cap_max = position + jnp.array([1.0, 0.0, 1.0]) * params_radius + jnp.array([0.0, 1.0, 0.0]) * cap_half
    side_tol = jnp.maximum(skin_width, ground_snap_skin)

    amin, amax, delta = platforms.aabb_min, platforms.aabb_max, platforms.delta
    moving = platforms.valid & (jnp.sum(delta * delta, axis=-1) >= 1e-8)

    overlap = jnp.all((cap_min <= amax + side_tol) & (cap_max >= amin - side_tol), axis=-1)
    within_xz = (position[0] >= amin[:, 0] - params_radius) & \
                (position[0] <= amax[:, 0] + params_radius) & \
                (position[2] >= amin[:, 2] - params_radius) & \
                (position[2] <= amax[:, 2] + params_radius)
    top_y = amax[:, 1]
    top_tol = snap_distance + jnp.maximum(skin_width, ground_snap_skin) + 0.05
    on_top = within_xz & (base_y >= top_y - top_tol) & (base_y <= top_y + top_tol)

    carry_cand = moving & overlap & on_top
    carry_len = jnp.where(carry_cand, jnp.sum(delta * delta, axis=-1), -1.0)
    best = jnp.argmax(carry_len)
    best_carry = jnp.where(carry_len[best] > 1e-8, delta[best], jnp.zeros(3))

    # Side push: within Y extent, outside XZ, pushed toward the capsule.
    y_ok = (position[1] >= amin[:, 1] - cap_half) & (position[1] <= amax[:, 1] + cap_half)
    outside_x = (position[0] < amin[:, 0] - params_radius) | (position[0] > amax[:, 0] + params_radius)
    outside_z = (position[2] < amin[:, 2] - params_radius) | (position[2] > amax[:, 2] + params_radius)
    cx = jnp.clip(position[0], amin[:, 0], amax[:, 0])
    cz = jnp.clip(position[2], amin[:, 2], amax[:, 2])
    dx = position[0] - cx
    dz = position[2] - cz
    side_dist_sq = dx * dx + dz * dz
    side_push_tol = params_radius + side_tol
    dir_len = jnp.sqrt(jnp.maximum(side_dist_sq, 0.0))
    safe_len = jnp.where(dir_len > 1e-5, dir_len, 1.0)
    move_toward = (delta[:, 0] * dx + delta[:, 2] * dz) / safe_len
    push_cand = moving & overlap & ~on_top & y_ok & (outside_x | outside_z) & \
        (side_dist_sq <= side_push_tol * side_push_tol) & (dir_len > 1e-5) & (move_toward > 0)
    push = jnp.sum(jnp.where(push_cand[:, None],
                             delta * jnp.array([1.0, 0.0, 1.0]), 0.0), axis=0)

    use_carry = jnp.sum(best_carry * best_carry) > 1e-8
    use_push = jnp.sum(push * push) > 1e-8
    return jnp.where(use_carry, best_carry, jnp.where(use_push, push, jnp.zeros(3)))


# ---------------------------------------------------------------------------
# Slide resolve (reference: Systems.swift:1207-1375)


class SlideOptions(NamedTuple):
    allow_horizontal_ground_pass: bool
    adjust_velocity: bool
    use_ground_snap_skin_for_static: bool
    allow_triangle_normal_ground_like: bool


KINEMATIC_MOVE = SlideOptions(False, True, True, True)
AGENT_SEPARATION = SlideOptions(True, False, False, False)


def _resolve_hit(remaining, length, position, velocity,
                 hit_toi, hit_normal, hit_tri_normal, hit_is_static,
                 min_ground_dot, skin_width, ground_snap_skin, ground_sweep_max_step,
                 was_grounded, was_grounded_near,
                 side_frames, cached_side_normal, cached_side_found,
                 fallback_side_normal, options: SlideOptions):
    """One slide-hit response. Returns (position, remaining, velocity, done,
    slide_normal).

    Faithful branch-to-mask translation of SlideResolver.resolveHit
    (Systems.swift:1229-1375); the two unreachable post-`into < -eps`
    early-outs (:1332-1341) are omitted. ``cached_side_normal/found`` is the
    manifold-cache entry for the hit triangle (kinematic path);
    ``fallback_side_normal`` is the controller's last side-contact normal,
    applied with the reference's |dot| > 0.5 rule when no cache entry exists.
    """
    hit_is_ground_like = hit_is_static & (hit_tri_normal[1] >= min_ground_dot)
    contact_skin = jnp.where(
        hit_is_static,
        jnp.where(hit_is_ground_like & options.use_ground_snap_skin_for_static,
                  ground_snap_skin, skin_width),
        0.0)

    slide_normal = hit_normal
    # Cached side-normal substitution (Systems.swift:1273-1292).
    side_eligible = hit_is_static & (slide_normal[1] < min_ground_dot) & (side_frames > 0)
    cached_flipped = jnp.where(jnp.sum(cached_side_normal * slide_normal) < 0,
                               -cached_side_normal, cached_side_normal)
    fb_len_sq = jnp.sum(fallback_side_normal * fallback_side_normal)
    fb_n = fallback_side_normal / jnp.sqrt(jnp.maximum(fb_len_sq, 1e-20))
    fb_dot = jnp.sum(fb_n * slide_normal)
    fb_apply = side_eligible & ~cached_side_found & (fb_len_sq > 1e-6) & (jnp.abs(fb_dot) > 0.5)
    slide_normal = jnp.where(fb_apply, jnp.where(fb_dot >= 0, fb_n, -fb_n), slide_normal)
    slide_normal = jnp.where(side_eligible & cached_side_found, cached_flipped, slide_normal)

    # Wall-ify below minGroundDot.
    below = slide_normal[1] < min_ground_dot
    use_tri = below & hit_is_ground_like & options.allow_triangle_normal_ground_like
    slide_normal = jnp.where(use_tri, hit_tri_normal, slide_normal)
    below2 = slide_normal[1] < min_ground_dot
    flat = slide_normal * jnp.array([1.0, 0.0, 1.0])
    flat_len = jnp.linalg.norm(flat)
    degenerate = below2 & (flat_len <= 1e-5)
    slide_normal = jnp.where(below2 & ~degenerate,
                             flat / jnp.maximum(flat_len, 1e-20), slide_normal)

    into = jnp.sum(remaining * slide_normal)
    into_eps = 1e-4 * length
    effective_skin = jnp.where((hit_toi <= contact_skin) & (into < -into_eps),
                               jnp.minimum(contact_skin, hit_toi * 0.5), contact_skin)
    sticky = contact_skin * 0.1

    # Case A: horizontal ground pass (agent-separation option only).
    case_pass_h = (jnp.asarray(options.allow_horizontal_ground_pass) & hit_is_static &
                   (jnp.abs(remaining[1]) < 1e-5) & (hit_normal[1] >= min_ground_dot))
    # Case B: degenerate wall-ify -> pass through.
    case_degen = degenerate
    # Case C: sticky stop.
    case_sticky = (hit_toi <= sticky) & (into < -into_eps)
    # Case D: not moving into the surface -> pass through (with ground-y gate).
    case_not_into = into >= -into_eps
    # Case E: slide.

    # --- outcomes ---
    dir_ = remaining / jnp.maximum(length, 1e-20)
    raw_move = jnp.maximum(hit_toi - effective_skin, 0.0)
    ground_clamp = (slide_normal[1] >= min_ground_dot) & (remaining[1] < 0) & \
                   (raw_move > ground_sweep_max_step)
    move_dist = jnp.where(ground_clamp, ground_sweep_max_step, raw_move)
    pos_slide = position + dir_ * move_dist
    leftover = remaining - dir_ * move_dist
    leftover = leftover - slide_normal * jnp.sum(leftover * slide_normal)
    gate_y = was_grounded & was_grounded_near & (leftover[1] < 0)
    leftover = jnp.where(gate_y, leftover * jnp.array([1.0, 0.0, 1.0]), leftover)
    residual = jnp.sum(leftover * slide_normal)
    leftover = jnp.where(jnp.abs(residual) < 1e-5,
                         leftover - slide_normal * residual, leftover)
    slide_done = jnp.sum(leftover * leftover) < 1e-8
    v_into = jnp.sum(velocity * slide_normal)
    vel_slide = jnp.where(jnp.asarray(options.adjust_velocity) & (v_into < 0),
                          velocity - slide_normal * v_into, velocity)

    rem_pass = remaining
    gate_pass = case_not_into & was_grounded_near & hit_is_static & \
        ~hit_is_ground_like & (remaining[1] < 0)
    rem_pass = jnp.where(gate_pass, rem_pass * jnp.array([1.0, 0.0, 1.0]), rem_pass)

    rem_sticky = remaining - slide_normal * into

    # Select by priority: pass_h > degen > sticky > not_into > slide.
    def sel(vals):
        ph, dg, st, ni, sl = vals
        out = sl
        out = jax.tree.map(lambda a, b: jnp.where(case_not_into, a, b), ni, out)
        out = jax.tree.map(lambda a, b: jnp.where(case_sticky, a, b), st, out)
        out = jax.tree.map(lambda a, b: jnp.where(case_degen, a, b), dg, out)
        out = jax.tree.map(lambda a, b: jnp.where(case_pass_h, a, b), ph, out)
        return out

    zero3 = jnp.zeros(3)
    new_position = sel((position + remaining, position + remaining, position,
                        position + rem_pass, pos_slide))
    new_remaining = sel((zero3, zero3, rem_sticky, zero3,
                         jnp.where(slide_done, zero3, leftover)))
    new_velocity = sel((velocity, velocity, velocity, velocity, vel_slide))
    done = sel((jnp.asarray(True), jnp.asarray(True), jnp.asarray(False),
                jnp.asarray(True), slide_done))
    return new_position, new_remaining, new_velocity, done, slide_normal


# ---------------------------------------------------------------------------
# Pre-sweep depenetration (reference: Systems.swift:734-808)


def _depenetrate(soup, position, velocity, params_i, state_i, iterations=4):
    """Iterative capsule depenetration. Returns (position, velocity,
    cache fields..., depen_normal, resolved)."""
    radius = params_i["radius"]
    half_height = params_i["half_height"]
    skin = params_i["skin_width"]
    mgd = params_i["min_ground_dot"]
    mask = params_i["mask"]
    slop = jnp.maximum(skin * 0.5, 0.001)
    m_tri0, m_normal0, m_frames0 = state_i["m_tri"], state_i["m_normal"], state_i["m_frames"]
    side_normal0, side_frames0 = state_i["side_normal"], state_i["side_frames"]

    def cond(carry):
        stop, i = carry[-2], carry[-1]
        return jnp.any(~stop) & (i < iterations)

    def body(carry):
        (position, velocity, m_tri, m_normal, m_frames, side_normal, side_frames,
         normal_sum, normal_weight, did, q_cand, q_casts, stop, i) = carry
        ran = ~stop
        hits = Q.capsule_overlap_all(soup, position, radius, half_height, mask, k=8)
        q_cand = q_cand + jnp.where(ran, hits.candidates, 0)
        q_casts = q_casts + ran.astype(jnp.int32)
        any_hit = hits.valid[0]
        stop = stop | ~any_hit
        act = ~stop

        deepest_n = hits.normal[0]
        side_contact = deepest_n[1] < mgd
        # use deepest 1 (side) or 2 hits.
        use2 = ~side_contact & hits.valid[1]
        max_depth = hits.depth[0]

        frame_normal = jnp.zeros(3)
        for h in range(2):
            use = act & hits.valid[h] & (use2 if h == 1 else jnp.asarray(True))
            n_h = hits.normal[h]
            cached, found = _manifold_lookup(hits.tri_index[h], m_tri, m_normal)
            n_eff = jnp.where(found, cached, n_h)
            frame_normal = frame_normal + jnp.where(use, n_eff * hits.depth[h], 0.0)
            is_side_h = n_h[1] < mgd
            m_tri, m_normal, m_frames, side_normal, side_frames = _cache_record(
                hits.tri_index[h], n_eff, is_side_h,
                m_tri, m_normal, m_frames, side_normal, side_frames, use)

        fn_len = jnp.linalg.norm(frame_normal)
        depen_n = jnp.where(fn_len > 1e-6, frame_normal / jnp.maximum(fn_len, 1e-20),
                            frame_normal)
        push = jnp.where(side_contact,
                         jnp.minimum(jnp.maximum(max_depth, 0.0), skin),
                         jnp.maximum(max_depth + slop, 0.0))
        stop = stop | (act & (push <= 1e-6))
        act = act & (push > 1e-6)

        position = jnp.where(act, position + depen_n * push, position)
        v_into = jnp.sum(velocity * depen_n)
        velocity = jnp.where(act & (v_into < 0), velocity - depen_n * v_into, velocity)
        did = did | act
        normal_sum = normal_sum + jnp.where(act, depen_n * max_depth, 0.0)
        normal_weight = normal_weight + jnp.where(act, max_depth, 0.0)
        return (position, velocity, m_tri, m_normal, m_frames, side_normal,
                side_frames, normal_sum, normal_weight, did, q_cand, q_casts,
                stop, i + 1)

    init = (position, velocity, m_tri0, m_normal0, m_frames0, side_normal0,
            side_frames0, jnp.zeros(3), jnp.float32(0.0),
            jnp.asarray(False), jnp.int32(0), jnp.int32(0),
            jnp.asarray(False), jnp.int32(0))
    (position, velocity, m_tri, m_normal, m_frames, side_normal, side_frames,
     normal_sum, normal_weight, did, q_cand, q_casts, _, _) = \
        jax.lax.while_loop(cond, body, init)

    avg = jnp.where(normal_weight > 1e-6, normal_sum / jnp.maximum(normal_weight, 1e-20),
                    normal_sum)
    avg_len = jnp.linalg.norm(avg)
    depen_normal = avg / jnp.maximum(avg_len, 1e-20)
    return (position, velocity, m_tri, m_normal, m_frames, side_normal,
            side_frames, depen_normal, did & (avg_len > 1e-20), q_cand, q_casts)


# ---------------------------------------------------------------------------
# Ground probe / snap / slope friction (reference: Systems.swift:810-1021)


def _ground_contact(soup, position, velocity, params_i,
                    was_grounded, was_grounded_near, prev_normal, prev_tri,
                    ground_sliding, transition_frames, gravity, dt):
    radius = params_i["radius"]
    half_height = params_i["half_height"]
    skin = params_i["skin_width"]
    gss = params_i["ground_snap_skin"]
    snap_dist = params_i["snap_distance"]
    mgd = params_i["min_ground_dot"]
    mask = params_i["mask"]

    snap_delta = DOWN * snap_dist

    # All six ground probes (center snap, long fall probe, 4 normal-sampling
    # offsets) in ONE vmapped cast — same queries, 1/6 the program size.
    offs = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                      [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                      [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    origins = position + offs * (radius * 0.6)
    deltas = jnp.stack([snap_delta, DOWN * params_i["fall_probe_distance"],
                        snap_delta, snap_delta, snap_delta, snap_delta])
    probes = jax.vmap(lambda o, d: Q.capsule_cast(
        soup, o, d, radius, half_height, mask=mask, min_normal_y=mgd))(origins, deltas)
    center = jax.tree.map(lambda x: x[0], probes)
    fall = jax.tree.map(lambda x: x[1], probes)

    center_ok = center.hit & (snap_dist > 0) & (center.toi <= snap_dist)
    distance = jnp.where(fall.hit & (params_i["fall_probe_distance"] > 0), fall.toi, BIG)

    base_center_y = position[1] - half_height
    bottom_y = base_center_y - radius
    ground_tol = jnp.maximum(skin, gss)
    valid_point = center.position[1] <= bottom_y + ground_tol
    near = center.toi <= jnp.maximum(gss, skin)
    distance = jnp.where(center_ok, center.toi, distance)

    gate_vel = velocity[1] <= 0
    v_into = jnp.sum(velocity * center.normal)
    gate_speed = v_into >= -params_i["ground_snap_max_speed"]
    gate_toi = center.toi <= params_i["ground_snap_max_toi"]
    can_snap = valid_point & gate_vel & (near | gate_speed | gate_toi)
    can_snap = jnp.where(was_grounded_near & center_ok, valid_point, can_snap)
    can_snap = can_snap & center_ok

    grounded = center_ok & valid_point & (near | can_snap)

    # Normal averaging on non-flat ground (Systems.swift:895-924).
    normal_sum = center.tri_normal
    do_samples = grounded & (center.tri_normal[1] < 0.98) & (was_grounded_near | near)
    combine_tol = jnp.maximum(jnp.maximum(gss, skin), 0.05)
    s_ok = do_samples & probes.hit[2:] & (probes.toi[2:] <= center.toi + combine_tol) & \
        (jnp.sum(probes.tri_normal[2:] * center.tri_normal, axis=-1) > 0.98)
    normal_sum = normal_sum + jnp.sum(
        jnp.where(s_ok[:, None], probes.tri_normal[2:], 0.0), axis=0)
    n_len = jnp.linalg.norm(normal_sum)
    normal = jnp.where(n_len > 1e-6, normal_sum / jnp.maximum(n_len, 1e-20),
                       center.tri_normal)

    # Previous-normal smoothing (:927-934).
    smooth_ok = grounded & was_grounded_near & (jnp.sum(prev_normal * normal) > 0.9)
    normal = jnp.where(smooth_ok, m3.normalize(prev_normal * 0.8 + normal * 0.2), normal)
    # flattenGround override (:935-937).
    normal = jnp.where(grounded & center.flatten, UP, normal)
    normal = jnp.where(grounded, normal, UP)

    # GroundSnap (:945-963).
    raw_move = jnp.maximum(center.toi - gss, 0.0)
    move = jnp.where(near & (raw_move > params_i["ground_snap_max_step"]),
                     params_i["ground_snap_max_step"], raw_move)
    position = jnp.where(can_snap, position + DOWN * move, position)
    v_into_snap = jnp.sum(velocity * center.normal)
    velocity = jnp.where(can_snap & (v_into_snap < 0),
                         velocity - center.normal * v_into_snap, velocity)

    tri = jnp.where(grounded, center.tri_index, prev_tri)
    # Ground transition frames (:1787-1792).
    transition_frames = jnp.where(
        grounded & (center.tri_index != prev_tri) & (normal[1] - prev_normal[1] > 0.02),
        3, transition_frames)

    # SlopeFriction (:965-1021).
    n = m3.normalize(normal)
    flat_exit = n[1] > 0.98
    in_transition = transition_frames > 0
    transition_frames_out = jnp.where(grounded & ~flat_exit & in_transition,
                                      transition_frames - 1, transition_frames)
    transition_frames_out = jnp.where(grounded & flat_exit, 0, transition_frames_out)

    g_n = jnp.sum(gravity * n)
    g_tan = gravity - n * g_n
    g_tan_len = jnp.linalg.norm(g_tan)
    slope_active = grounded & ~flat_exit & ~in_transition & (g_tan_len > 0.5)
    g_tan_dir = g_tan / jnp.maximum(g_tan_len, 1e-20)
    # Friction coefficients come from the ground-hit surface material.
    stick_limit = center.mu_s * jnp.abs(g_n)
    enter_slide = g_tan_len > stick_limit * 1.05
    exit_slide = g_tan_len < stick_limit * 0.9
    sliding = jnp.where(slope_active,
                        jnp.where(ground_sliding, ~exit_slide, enter_slide),
                        jnp.where(grounded & ~flat_exit & in_transition, False,
                                  jnp.where(grounded, ground_sliding, False)))
    sliding = jnp.where(grounded & flat_exit, False, sliding)

    stick = slope_active & ~sliding & (g_tan_len <= stick_limit)
    v_tan = velocity - n * jnp.sum(velocity * n)
    downhill = jnp.sum(v_tan * g_tan_dir)
    velocity = jnp.where(stick & (downhill > 0), velocity - g_tan_dir * downhill, velocity)
    slide_mag = jnp.maximum(g_tan_len - center.mu_k * jnp.abs(g_n), 0.0)
    do_slide = slope_active & ~stick & (slide_mag > 0)
    velocity = jnp.where(do_slide, velocity + g_tan_dir * slide_mag * dt, velocity)

    # groundedNear is the raw proximity flag, independent of `grounded`
    # (Systems.swift:879).
    return dict(position=position, velocity=velocity, grounded=grounded,
                grounded_near=near & center_ok, normal=normal, tri=tri,
                distance=distance, sliding=sliding,
                transition_frames=transition_frames_out,
                mu_s=center.mu_s, mu_k=center.mu_k,
                q_cand=jnp.sum(probes.iterations),
                q_casts=jnp.int32(probes.iterations.shape[0]))


# ---------------------------------------------------------------------------
# Per-agent substep (vmapped by CharacterPipeline.step)


def _agent_sweep(position, remaining, remaining_len, base_move_len, dt,
                 self_idx, self_solid, self_radius, half_height,
                 snapshot: AgentSnapshot):
    """Earliest agent-agent hit (reference: Systems.swift:1053-1091)."""
    time_scale = jnp.where(base_move_len > 1e-6,
                           jnp.minimum(remaining_len / jnp.maximum(base_move_len, 1e-20), 1.0),
                           1.0)
    seg_dt = dt * time_scale
    other_delta = snapshot.velocity * seg_dt
    toi, normal, hit = capsule_capsule_sweep(
        position[None, :], remaining[None, :], self_radius, half_height,
        snapshot.position, other_delta, snapshot.radius, snapshot.half_height)
    n_agents = snapshot.position.shape[0]
    others = snapshot.solid & (jnp.arange(n_agents) != self_idx) & self_solid
    toi = jnp.where(hit & others, toi, BIG)
    best = jnp.argmin(toi)
    return toi[best], normal[best], toi[best] < BIG


def _step_single(soup, platforms, snapshot, self_idx, position, velocity,
                 state_i, params_i, gravity, dt,
                 max_slide_iterations, depen_iterations):
    """Full controller pipeline for one agent (Systems.swift:1842-1901)."""
    active = params_i["active"]

    # 1. Contact cache decay (Systems.swift:1105-1116).
    side_frames = jnp.maximum(state_i["side_frames"] - 1, 0)
    m_frames = jnp.maximum(state_i["m_frames"] - 1, 0)
    expired = (state_i["m_frames"] > 0) & (m_frames == 0)
    m_tri = jnp.where(expired, -1, state_i["m_tri"])
    m_normal = jnp.where(expired, 0.0, state_i["m_normal"])
    side_normal = jnp.where(expired, 0.0, state_i["side_normal"])

    # 2. Platform carry/push.
    position = position + _platform_carry(
        position, params_i["radius"], params_i["half_height"],
        params_i["skin_width"], params_i["ground_snap_skin"],
        params_i["snap_distance"], platforms)

    was_grounded = state_i["grounded"]
    was_grounded_near = state_i["grounded_near"]

    # 3. Velocity gate (Systems.swift:1037-1051).
    gate = was_grounded & was_grounded_near & (velocity[1] < 0)
    velocity = jnp.where(gate, velocity * jnp.array([1.0, 0.0, 1.0]), velocity)
    remaining = velocity * dt
    remaining = jnp.where(was_grounded & was_grounded_near & (remaining[1] < 0),
                          remaining * jnp.array([1.0, 0.0, 1.0]), remaining)

    # 4. Pre-sweep depenetration.
    depen_state = dict(m_tri=m_tri, m_normal=m_normal, m_frames=m_frames,
                       side_normal=side_normal, side_frames=side_frames)
    (position, velocity, m_tri, m_normal, m_frames, side_normal, side_frames,
     depen_normal, depen_ok, dq_cand, dq_casts) = _depenetrate(
         soup, position, velocity, params_i, depen_state, depen_iterations)
    into = jnp.sum(remaining * depen_normal)
    remaining = jnp.where(depen_ok & (into < 0),
                          remaining - depen_normal * into, remaining)

    # 5. Slide loop (lax loop: body traced once, not unrolled).
    base_move_len = jnp.linalg.norm(velocity * dt)

    def slide_cond(carry):
        remaining, loop_done, i = carry[1], carry[-2], carry[-1]
        live = ~loop_done & (jnp.linalg.norm(remaining) >= 1e-6)
        return jnp.any(live) & (i < max_slide_iterations)

    def slide_body(carry):
        (position, remaining, velocity, m_tri, m_normal, m_frames,
         side_normal, side_frames, last_slide_normal, have_last, q_cand,
         q_casts, loop_done, it) = carry
        length = jnp.linalg.norm(remaining)
        it_active = ~loop_done & (length >= 1e-6)

        s_hit = Q.capsule_cast(soup, position, remaining, params_i["radius"],
                               params_i["half_height"], mask=params_i["mask"],
                               blocking=True)
        q_cand = q_cand + jnp.where(it_active, s_hit.iterations, 0)
        q_casts = q_casts + it_active.astype(jnp.int32)
        # Pre-selection cached side-normal substitution (Systems.swift:1683-1694).
        cached_n, cached_found = _manifold_lookup(s_hit.tri_index, m_tri, m_normal)
        sub_ok = s_hit.hit & (s_hit.normal[1] < params_i["min_ground_dot"]) & \
            (side_frames > 0) & cached_found
        cached_aligned = jnp.where(jnp.sum(cached_n * s_hit.normal) < 0, -cached_n, cached_n)
        s_normal = jnp.where(sub_ok, cached_aligned, s_hit.normal)

        a_toi, a_normal, a_hit = _agent_sweep(
            position, remaining, length, base_move_len, dt, self_idx,
            params_i["agent_solid"], params_i["agent_radius"],
            params_i["half_height"], snapshot)

        # Best-hit select (Systems.swift:1378-1398).
        static_skin = jnp.where(s_normal[1] >= params_i["min_ground_dot"],
                                params_i["ground_snap_skin"], params_i["skin_width"])
        static_stop = jnp.maximum(s_hit.toi - static_skin, 0.0)
        agent_stop = jnp.maximum(a_toi, 0.0)
        pick_static = s_hit.hit & (~a_hit | (static_stop <= agent_stop))
        any_hit = s_hit.hit | a_hit

        hit_toi = jnp.where(pick_static, s_hit.toi, a_toi)
        hit_normal = jnp.where(pick_static, s_normal, a_normal)
        hit_tri_normal = jnp.where(pick_static, s_hit.tri_normal, jnp.zeros(3))

        new_pos, new_rem, new_vel, done, _ = _resolve_hit(
            remaining, length, position, velocity,
            hit_toi, hit_normal, hit_tri_normal, pick_static,
            params_i["min_ground_dot"], params_i["skin_width"],
            params_i["ground_snap_skin"], params_i["ground_sweep_max_step"],
            was_grounded, was_grounded_near,
            side_frames, cached_n, sub_ok, side_normal, KINEMATIC_MOVE)

        # Record side contacts (Systems.swift:1738-1743).
        rec = it_active & any_hit & pick_static & \
            (s_normal[1] < params_i["min_ground_dot"])
        m_tri, m_normal, m_frames, side_normal, side_frames = _cache_record(
            s_hit.tri_index, s_normal, jnp.asarray(True),
            m_tri, m_normal, m_frames, side_normal, side_frames, rec)

        # Crease clamp (Systems.swift:1744-1754).
        crease = it_active & any_hit & have_last & \
            (jnp.abs(jnp.sum(last_slide_normal * hit_normal)) < 0.98)
        axis = m3.cross(last_slide_normal, hit_normal)
        axis_len = jnp.linalg.norm(axis)
        axis_n = axis / jnp.maximum(axis_len, 1e-20)
        new_rem = jnp.where(crease & (axis_len > 1e-5),
                            axis_n * jnp.sum(new_rem * axis_n), new_rem)

        # No hit: consume remaining and stop.
        pos_nohit = position + remaining
        position = jnp.where(it_active, jnp.where(any_hit, new_pos, pos_nohit), position)
        remaining = jnp.where(it_active, jnp.where(any_hit, new_rem, jnp.zeros(3)), remaining)
        velocity = jnp.where(it_active & any_hit, new_vel, velocity)
        last_slide_normal = jnp.where(it_active & any_hit, hit_normal, last_slide_normal)
        have_last = have_last | (it_active & any_hit)
        loop_done = loop_done | (it_active & (~any_hit | done))
        return (position, remaining, velocity, m_tri, m_normal, m_frames,
                side_normal, side_frames, last_slide_normal, have_last,
                q_cand, q_casts, loop_done, it + 1)

    slide_init = (position, remaining, velocity, m_tri, m_normal, m_frames,
                  side_normal, side_frames, jnp.zeros(3), jnp.asarray(False),
                  dq_cand, dq_casts, jnp.asarray(False), jnp.int32(0))
    (position, remaining, velocity, m_tri, m_normal, m_frames, side_normal,
     side_frames, _, _, q_cand, q_casts, _, _) = jax.lax.while_loop(
         slide_cond, slide_body, slide_init)

    # 6. Ground contact.
    g = _ground_contact(soup, position, velocity, params_i,
                        was_grounded, was_grounded_near,
                        state_i["ground_normal"], state_i["ground_tri"],
                        state_i["ground_sliding"], state_i["transition_frames"],
                        gravity, dt)

    # Inactive agents keep everything unchanged.
    def keep(new, old):
        return jnp.where(active, new, old)

    out_state = dict(
        grounded=keep(g["grounded"], state_i["grounded"]),
        grounded_near=keep(g["grounded_near"], state_i["grounded_near"]),
        ground_normal=keep(g["normal"], state_i["ground_normal"]),
        ground_tri=keep(g["tri"], state_i["ground_tri"]),
        ground_sliding=keep(g["sliding"], state_i["ground_sliding"]),
        transition_frames=keep(g["transition_frames"], state_i["transition_frames"]),
        ground_distance=keep(g["distance"], state_i["ground_distance"]),
        side_normal=keep(side_normal, state_i["side_normal"]),
        side_frames=keep(side_frames, state_i["side_frames"]),
        m_tri=keep(m_tri, state_i["m_tri"]),
        m_normal=keep(m_normal, state_i["m_normal"]),
        m_frames=keep(m_frames, state_i["m_frames"]),
        query_candidates=jnp.where(active, q_cand + g["q_cand"], 0),
        query_casts=jnp.where(active, q_casts + g["q_casts"], 0),
    )
    return keep(g["position"], state_i["position0"]), \
        keep(g["velocity"], state_i["velocity0"]), out_state


class CharacterPipeline:
    """Batched kinematic character mover."""

    def __init__(self, gravity=(0.0, -98.0, 0.0), max_slide_iterations: int = 4,
                 depen_iterations: int = 4, broadphase_cap: int = 256):
        self.gravity = jnp.asarray(gravity, jnp.float32)
        self.max_slide_iterations = max_slide_iterations
        self.depen_iterations = depen_iterations
        # Broadphase candidate lists (CollisionQuery.swift:496-707 analog):
        # when the soup exceeds this many rows, each agent's queries run
        # over a gathered nearest-``cap`` candidate sub-soup instead of the
        # full set (Q.gather_candidates). <=0 disables.
        self.broadphase_cap = broadphase_cap

    def step(self, soup: TriangleSoup, position, velocity,
             state: ControllerState, params: ControllerParams,
             platforms: PlatformSet, dt):
        """Advance all agents one fixed substep.

        Args:
          position, velocity: (N,3) agent body state.
        Returns (position, velocity, new ControllerState).
        """
        snapshot = AgentSnapshot(position=position, velocity=velocity,
                                 radius=params.agent_radius,
                                 half_height=params.half_height,
                                 solid=params.agent_solid & params.active)

        def single(idx, pos, vel, st, pr, soup):
            params_i = dict(radius=pr["radius"], half_height=pr["half_height"],
                            skin_width=pr["skin_width"],
                            ground_snap_skin=pr["ground_snap_skin"],
                            snap_distance=pr["snap_distance"],
                            fall_probe_distance=pr["fall_probe_distance"],
                            ground_snap_max_speed=pr["ground_snap_max_speed"],
                            ground_snap_max_toi=pr["ground_snap_max_toi"],
                            ground_snap_max_step=pr["ground_snap_max_step"],
                            ground_sweep_max_step=pr["ground_sweep_max_step"],
                            min_ground_dot=pr["min_ground_dot"],
                            mask=pr["collision_mask"],
                            agent_radius=pr["agent_radius"],
                            agent_solid=pr["agent_solid"],
                            active=pr["active"])
            state_i = dict(grounded=st["grounded"], grounded_near=st["grounded_near"],
                           ground_normal=st["ground_normal"], ground_tri=st["ground_tri"],
                           ground_sliding=st["ground_sliding"],
                           transition_frames=st["transition_frames"],
                           ground_distance=st["ground_distance"],
                           side_normal=st["side_normal"], side_frames=st["side_frames"],
                           m_tri=st["m_tri"], m_normal=st["m_normal"],
                           m_frames=st["m_frames"],
                           position0=pos, velocity0=vel)
            return _step_single(soup, platforms, snapshot, idx, pos, vel,
                                state_i, params_i, self.gravity, jnp.float32(dt),
                                self.max_slide_iterations, self.depen_iterations)

        n = position.shape[0]
        st_dict = dict(grounded=state.grounded, grounded_near=state.grounded_near,
                       ground_normal=state.ground_normal, ground_tri=state.ground_tri,
                       ground_sliding=state.ground_sliding,
                       transition_frames=state.ground_transition_frames,
                       ground_distance=state.ground_distance,
                       side_normal=state.side_normal, side_frames=state.side_frames,
                       m_tri=state.manifold_tri, m_normal=state.manifold_normal,
                       m_frames=state.manifold_frames)
        pr_dict = params._asdict()

        cap = self.broadphase_cap
        if 0 < cap < soup.v0.shape[0]:
            # Conservative per-substep motion bound: integrate + slide can
            # move at most |v + g*dt|*dt; ground probes reach snap/fall
            # distances below and sweep-step above; +skin and a platform
            # margin (platforms both carry agents and move toward them).
            speed = jnp.linalg.norm(
                velocity + self.gravity[None] * dt, axis=-1)
            reach = speed * dt + jnp.maximum(params.snap_distance,
                                             params.fall_probe_distance) \
                + params.ground_sweep_max_step + params.skin_width + 1.0
            soup_arg, _bp_count = Q.gather_candidates(
                soup, position, params.half_height, params.radius,
                reach, cap)
            soup_axis = 0
        else:
            soup_arg, soup_axis = soup, None

        new_pos, new_vel, out = jax.vmap(
            single, in_axes=(0, 0, 0, 0, 0, soup_axis))(
                jnp.arange(n), position, velocity, st_dict, pr_dict, soup_arg)
        new_state = ControllerState(
            grounded=out["grounded"], grounded_near=out["grounded_near"],
            ground_normal=out["ground_normal"], ground_tri=out["ground_tri"],
            ground_sliding=out["ground_sliding"],
            ground_transition_frames=out["transition_frames"],
            ground_distance=out["ground_distance"],
            side_normal=out["side_normal"], side_frames=out["side_frames"],
            manifold_tri=out["m_tri"], manifold_normal=out["m_normal"],
            manifold_frames=out["m_frames"],
            query_candidates=out["query_candidates"],
            query_casts=out["query_casts"])
        return new_pos, new_vel, new_state
