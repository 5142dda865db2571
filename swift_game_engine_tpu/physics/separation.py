"""Agent-agent separation after move-and-slide.

Data-parallel reformulation of the reference's XZ hash-grid Gauss-Seidel pass
(reference: Game/Systems.swift:1906-2210) with the same per-pair
position/impulse math (inverse-mass-weighted XZ push + approach-velocity
cancellation), Jacobi-accumulated per iteration instead of sequential
in-place pair updates.

Candidate generation scales with N:
  * small N (<= _GRID_MIN_N): dense (N x N) masked matrix — cheaper than
    any sort at demo scale.
  * large N: the reference's XZ grid, array-shaped — agents sort by integer
    cell key (cell = 2*maxR + margin, Systems.swift:2130-2135), and each
    agent gathers a fixed window of _CELL_CAP sorted entries from each of
    its 9 neighbor cells via searchsorted. O(N * 9 * CAP) pair terms, all
    gathers, no scatters. Pairs beyond _CELL_CAP co-residents per cell are
    dropped for that iteration (the reference's Gauss-Seidel is similarly
    approximate under extreme stacking); the distance test makes boundary
    key aliasing a pure false positive.

The reference's per-pair "static blocked" redistribution (casting each pair
move against the world, Systems.swift:2002-2037) is folded into the
post-process: every agent's accumulated correction is re-run through the
move-and-slide resolver against the static world and re-snapped to ground
(Systems.swift:2048-2123), which is the mechanism that actually prevents
tunneling.
"""

from __future__ import annotations

import os
from ..config import knob
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import math3d as m3
from . import queries as Q
from .collision_world import TriangleSoup
from .character import (_resolve_hit, AGENT_SEPARATION, ControllerParams,
                        ControllerState, BIG, DOWN)

# Dense-matrix cutoff and per-cell candidate cap (env-tunable).
_GRID_MIN_N = knob("SGE_SEP_GRID_MIN_N")
_CELL_CAP = knob("SGE_SEP_CELL_CAP")
_FORCE_GRID = bool(knob("SGE_SEP_FORCE_GRID"))


def _pair_accumulate(position, velocity, j_idx, pair_ok, params, inv_w,
                     separation_margin, height_margin):
    """Shared per-pair math. ``j_idx`` is (N, K) partner indices (clamped
    in-range), ``pair_ok`` the (N, K) validity mask. Returns (d_position,
    d_velocity) Jacobi accumulations — identical formulas for the dense
    matrix (K = N, j_idx = arange) and the grid candidates."""
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    dx = px[:, None] - px[j_idx]
    dz = pz[:, None] - pz[j_idx]
    dist_sq = dx * dx + dz * dz

    skin_allow = jnp.minimum(params.skin_width[:, None],
                             params.skin_width[j_idx])
    margin = jnp.minimum(separation_margin, skin_allow)
    min_dist = params.agent_radius[:, None] + params.agent_radius[j_idx] + margin

    a_min = py - params.half_height
    a_max = py + params.half_height
    height_sep = (a_max[:, None] < a_min[j_idx] - height_margin) | \
                 (a_min[:, None] > a_max[j_idx] + height_margin)

    w_sum = inv_w[:, None] + inv_w[j_idx]
    overlap = pair_ok & ~height_sep & (dist_sq < min_dist * min_dist) & (w_sum > 0)

    dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-8))
    nx = dx / dist
    nz = dz / dist
    pen = min_dist - dist
    corr = jnp.where(overlap, pen / jnp.maximum(w_sum, 1e-20), 0.0)

    # Jacobi position accumulation (each pair contributes to both agents).
    move_x = jnp.sum(nx * corr, axis=1) * inv_w
    move_z = jnp.sum(nz * corr, axis=1) * inv_w
    zeros = jnp.zeros_like(move_x)
    d_pos = jnp.stack([move_x, zeros, move_z], axis=-1)

    # Approach-velocity impulse (Systems.swift:1991-2001).
    vx, vz = velocity[:, 0], velocity[:, 2]
    rvx = vx[:, None] - vx[j_idx]
    rvz = vz[:, None] - vz[j_idx]
    vn = rvx * nx + rvz * nz
    approaching = overlap & (vn < 0)
    impulse = jnp.where(approaching, -vn, 0.0)
    scale = inv_w[:, None] / jnp.maximum(w_sum, 1e-20)
    dvx = jnp.sum(nx * impulse * scale, axis=1)
    dvz = jnp.sum(nz * impulse * scale, axis=1)
    d_vel = jnp.stack([dvx, zeros, dvz], axis=-1)
    return d_pos, d_vel


def _grid_candidate_rows(position, velocity, params, inv_w, solid,
                         separation_margin):
    """XZ-grid candidates as a ROW table: (rows (N, 9*CAP, 12), ok mask).

    Cell size = 2*maxR + margin (Systems.swift:2130-2135). Sort agents by
    integer cell key, then each agent windows CAP sorted entries from each
    neighbor cell found via searchsorted. All shapes static.

    The per-agent attributes ride in ONE (N, 12) row table gathered once
    into sorted order and once per candidate window: one row gather
    instead of 8 scalar 1-D gathers of (N, 9*CAP).

    Row layout: [px, py, pz, vx, vz, radius, half_height, skin, inv_w,
    solid, id, pad]."""
    n = position.shape[0]
    cell = 2.0 * jnp.max(params.agent_radius) + separation_margin
    # Clamp cell coords so parked/despawned agents (arbitrary positions,
    # masked out of every pair anyway) can't overflow the int32 row key.
    # Live agents are chunk-rebased near the player, far inside this range.
    lim = jnp.int32(1 << 12)
    cx = jnp.clip(jnp.floor(position[:, 0] / cell), -lim, lim).astype(jnp.int32)
    cz = jnp.clip(jnp.floor(position[:, 2] / cell), -lim, lim).astype(jnp.int32)
    cz0 = cz - jnp.min(cz)
    width = jnp.max(cz0) + 3          # +3: neighbor offsets stay in-row range
    key = (cx - jnp.min(cx) + 1) * width + cz0 + 1
    order = jnp.argsort(key)
    key_sorted = key[order]

    table = jnp.stack([
        position[:, 0], position[:, 1], position[:, 2],
        velocity[:, 0], velocity[:, 2],
        params.agent_radius, params.half_height, params.skin_width,
        inv_w, solid.astype(jnp.float32),
        jnp.arange(n, dtype=jnp.float32), jnp.zeros(n),
    ], axis=-1)
    table_sorted = table[order]                                   # (N,12)

    offs = jnp.array([dxc * 1 for dxc in range(-1, 2)], jnp.int32)
    # 9 neighbor cell keys per agent
    nk = key[:, None] + (offs[:, None] * width + offs[None, :]).reshape(-1)[None, :]
    # searchsorted-left == count of keys below the query. The explicit
    # comparison-count is pure vector compare+reduce (N*9*N lanes — ~9.4M
    # at 1024 agents), while jnp.searchsorted lowers to a binary-search
    # loop of per-element gathers. Above the quadratic cutoff the gather
    # loop wins again.
    if n <= 4096:
        start = jnp.sum(key_sorted[None, None, :] < nk[:, :, None],
                        axis=-1).astype(jnp.int32)                # (N, 9)
    else:
        start = jnp.searchsorted(key_sorted, nk)                  # (N, 9)
    win = start[..., None] + jnp.arange(_CELL_CAP)[None, None, :]  # (N,9,CAP)
    win_c = jnp.minimum(win, n - 1)
    same_cell = key_sorted[win_c] == nk[..., None]
    in_range = win < n
    rows = table_sorted[win_c.reshape(n, -1)]                     # (N,K,12)
    ok = (same_cell & in_range).reshape(n, -1)
    return rows, ok


def _pair_accumulate_rows(position, velocity, rows, pair_ok, params, inv_w,
                          separation_margin, height_margin):
    """Row-table twin of _pair_accumulate: partner attributes come from the
    gathered candidate rows instead of j_idx gathers. Identical math."""
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    jx, jy, jz = rows[..., 0], rows[..., 1], rows[..., 2]
    dx = px[:, None] - jx
    dz = pz[:, None] - jz
    dist_sq = dx * dx + dz * dz

    skin_allow = jnp.minimum(params.skin_width[:, None], rows[..., 7])
    margin = jnp.minimum(separation_margin, skin_allow)
    min_dist = params.agent_radius[:, None] + rows[..., 5] + margin

    a_min = py - params.half_height
    a_max = py + params.half_height
    j_min = jy - rows[..., 6]
    j_max = jy + rows[..., 6]
    height_sep = (a_max[:, None] < j_min - height_margin) | \
                 (a_min[:, None] > j_max + height_margin)

    w_sum = inv_w[:, None] + rows[..., 8]
    overlap = pair_ok & ~height_sep & (dist_sq < min_dist * min_dist) & \
        (w_sum > 0)

    dist = jnp.sqrt(jnp.maximum(dist_sq, 1e-8))
    nx = dx / dist
    nz = dz / dist
    pen = min_dist - dist
    corr = jnp.where(overlap, pen / jnp.maximum(w_sum, 1e-20), 0.0)

    move_x = jnp.sum(nx * corr, axis=1) * inv_w
    move_z = jnp.sum(nz * corr, axis=1) * inv_w
    zeros = jnp.zeros_like(move_x)
    d_pos = jnp.stack([move_x, zeros, move_z], axis=-1)

    vx, vz = velocity[:, 0], velocity[:, 2]
    rvx = vx[:, None] - rows[..., 3]
    rvz = vz[:, None] - rows[..., 4]
    vn = rvx * nx + rvz * nz
    approaching = overlap & (vn < 0)
    impulse = jnp.where(approaching, -vn, 0.0)
    scale = inv_w[:, None] / jnp.maximum(w_sum, 1e-20)
    dvx = jnp.sum(nx * impulse * scale, axis=1)
    dvz = jnp.sum(nz * impulse * scale, axis=1)
    d_vel = jnp.stack([dvx, zeros, dvz], axis=-1)
    return d_pos, d_vel


def separate_agents(soup: TriangleSoup, position, velocity,
                    state: ControllerState, params: ControllerParams,
                    iterations: int = 2, separation_margin: float = 0.2,
                    height_margin: float = 0.1, slide_iterations: int = 2):
    """Resolve agent-agent overlaps. Returns (position, velocity, state).

    position/velocity: (N,3).
    """
    n = position.shape[0]
    solid = params.agent_solid & params.active
    inv_w = jnp.where(params.agent_mass_weight > 0,
                      1.0 / jnp.maximum(params.agent_mass_weight, 1e-20), 0.0)
    use_grid = _FORCE_GRID or n > _GRID_MIN_N

    start_position = position
    velocity0 = velocity

    for _ in range(iterations):
        if use_grid:
            rows, ok = _grid_candidate_rows(position, velocity, params,
                                            inv_w, solid, separation_margin)
            self_pair = rows[..., 10] == jnp.arange(n)[:, None]
            pair_ok = ok & ~self_pair & solid[:, None] & (rows[..., 9] > 0.5)
            d_pos, d_vel = _pair_accumulate_rows(
                position, velocity, rows, pair_ok, params, inv_w,
                separation_margin, height_margin)
        else:
            j_idx = jnp.broadcast_to(jnp.arange(n)[None, :], (n, n))
            pair_ok = solid[:, None] & solid[None, :] & \
                ~jnp.eye(n, dtype=bool)
            d_pos, d_vel = _pair_accumulate(position, velocity, j_idx,
                                            pair_ok, params, inv_w,
                                            separation_margin, height_margin)
        position = position + d_pos
        velocity = velocity + d_vel

    # Post-process: re-run the accumulated delta through move-and-slide vs the
    # static world, then re-snap to ground (Systems.swift:2048-2123).
    def post(idx, start, target, vel, st_gr, st_gn, st_n, st_tri):
        pr_r = params.agent_radius[idx]
        pr_hh = params.half_height[idx]
        mask = params.collision_mask[idx]
        mgd = params.min_ground_dot[idx]
        delta = target - start
        moved = jnp.linalg.norm(delta) > 1e-6
        pos = jnp.where(moved, start, target)
        remaining = jnp.where(moved, delta, jnp.zeros(3))
        vel_dummy = vel
        done = ~moved
        q_cand = jnp.int32(0)
        q_casts = jnp.int32(0)
        for _ in range(slide_iterations):
            seg = jnp.linalg.norm(remaining)
            act = ~done & (seg >= 1e-6)
            hit = Q.capsule_cast(soup, pos, remaining, pr_r, pr_hh,
                                 mask=mask, blocking=True)
            q_cand = q_cand + jnp.where(act, hit.iterations, 0)
            q_casts = q_casts + act.astype(jnp.int32)
            new_pos, new_rem, _, hdone, _ = _resolve_hit(
                remaining, seg, pos, vel_dummy,
                hit.toi, hit.normal, hit.tri_normal, jnp.asarray(True),
                mgd, params.skin_width[idx], params.ground_snap_skin[idx],
                params.ground_sweep_max_step[idx],
                jnp.asarray(False), jnp.asarray(False),
                jnp.int32(0), jnp.zeros(3), jnp.asarray(False), jnp.zeros(3),
                AGENT_SEPARATION)
            pos_nohit = pos + remaining
            pos = jnp.where(act, jnp.where(hit.hit, new_pos, pos_nohit), pos)
            remaining = jnp.where(act & hit.hit, new_rem, jnp.zeros(3))
            done = done | (act & (~hit.hit | hdone))

        # Re-snap (only if we moved and aren't moving upward).
        do_snap = moved & (vel[1] <= 0) & (params.snap_distance[idx] > 0)
        snap = Q.capsule_cast(soup, pos, DOWN * params.snap_distance[idx],
                              pr_r, pr_hh, mask=mask, min_normal_y=mgd)
        q_cand = q_cand + jnp.where(do_snap, snap.iterations, 0)
        q_casts = q_casts + do_snap.astype(jnp.int32)
        snap_ok = do_snap & snap.hit & (snap.toi <= params.snap_distance[idx])
        raw = jnp.maximum(snap.toi - params.ground_snap_skin[idx], 0.0)
        move = jnp.minimum(raw, params.ground_snap_max_step[idx])
        pos = jnp.where(snap_ok, pos + DOWN * move, pos)
        gr = jnp.where(snap_ok, True, st_gr)
        gn = jnp.where(snap_ok,
                       snap.toi <= jnp.maximum(params.ground_snap_skin[idx],
                                               params.skin_width[idx]), st_gn)
        nrm = jnp.where(snap_ok, jnp.where(snap.flatten, jnp.array([0.0, 1, 0]),
                                           snap.tri_normal), st_n)
        tri = jnp.where(snap_ok, snap.tri_index, st_tri)
        active = params.active[idx] & params.agent_solid[idx]
        return (jnp.where(active, pos, start),
                jnp.where(active, gr, st_gr),
                jnp.where(active, gn, st_gn),
                jnp.where(active, nrm, st_n),
                jnp.where(active, tri, st_tri),
                jnp.where(active, q_cand, 0),
                jnp.where(active, q_casts, 0))

    new_pos, gr, gn, nrm, tri, q_cand, q_casts = jax.vmap(post)(
        jnp.arange(n), start_position, position, velocity,
        state.grounded, state.grounded_near, state.ground_normal, state.ground_tri)

    new_state = state._replace(grounded=gr, grounded_near=gn,
                               ground_normal=nrm, ground_tri=tri,
                               query_candidates=state.query_candidates + q_cand,
                               query_casts=state.query_casts + q_casts)
    active3 = (params.active & params.agent_solid)[:, None]
    velocity = jnp.where(active3, velocity, velocity0)
    return new_pos, velocity, new_state
