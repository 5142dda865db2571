"""World step: the fixed-substep pipeline over the pytree world state.

One jitted function advances every system in the reference's exact order
(reference: Game/DemoScene.swift:56-75 wiring + Game/Systems.swift:52-94
FixedStepRunner):

  pre:   Spin -> OscillateMove -> ActiveChunk -> PhysicsLocalize -> Dodge ->
         PhysicsIntent -> Jump -> PhysicsBeginStep
  fixed: PlatformMotion -> CollisionQueryRefresh (soup retransform) ->
         Gravity -> KinematicMoveStop -> AgentSeparation -> PhysicsIntegrate ->
         LocomotionProfile -> ActionAnimation -> PoseStack
  post:  PhysicsWriteback -> WorldPositionSync

The demo plays inside one 512-unit chunk, so ActiveChunk/PhysicsLocalize are
identity re-anchors here (chunk math itself is exercised by WorldPositionSync
+ the ecs tests); the active-set culling hook is `ControllerParams.active`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import math3d as m3
from ..ecs.world import (WorldState, SceneSpec, BODY_STATIC, BODY_DYNAMIC,
                         BODY_KINEMATIC, CHUNK_SIZE, world_to_chunk_local,
                         chunk_local_to_world, canonicalize)
from ..physics import systems as S
from ..physics.collision_world import LocalTriangles, transform_soup
from ..physics.character import CharacterPipeline, PlatformSet
from ..physics.separation import separate_agents
from ..physics.systems import DodgeState, ActionClock
from ..anim.pose import (PoseEngine, ProfileBank, ActionProfile, LocoState,
                         ActionState, PoseInputs, locomotion_pose_tq,
                         apply_action_layer)
from ..anim.locomotion import locomotion_fsm_step


def _trs_matrices(t, r, s):
    """TransformComponent.modelMatrix = T * R * S (Components.swift:26-44)."""
    rot = m3.mat3_from_quat(r) * s[..., None, :]
    m = m3.mat4_identity(t.shape[:-1])
    m = m.at[..., :3, :3].set(rot)
    return m.at[..., :3, 3].set(t)


class Stepper:
    """Builds the jitted substep for a scene."""

    def __init__(self, spec: SceneSpec, collision: LocalTriangles,
                 pose_engine: PoseEngine = None, bank: ProfileBank = None,
                 action_profile: ActionProfile = None,
                 inv_bind_override=None, chunk_radius: int = 2):
        self.spec = spec
        self.collision = collision
        # ActiveChunk radius (Components.swift:150 radiusChunks default 2);
        # the active set/origin need a player with a WorldPosition — without
        # one the system is a no-op (Systems.swift:2360-2364 early return).
        self.chunk_radius = int(chunk_radius)
        p = np.nonzero(spec.is_player & spec.has_wp)[0]
        self.player_idx = int(p[0]) if len(p) else None
        self.pose_engine = pose_engine
        self.bank = bank
        self.action_profile = action_profile
        # Per-character inverse-bind override from the skinned asset
        # (reference: Systems.swift:2507-2527 — mesh invBind wins over the
        # skeleton-derived palette when present). (C,B,4,4) or None.
        self.inv_bind_override = None if inv_bind_override is None else \
            jnp.asarray(inv_bind_override)
        self.pipeline = CharacterPipeline(gravity=spec.gravity)
        # static masks as jnp
        self.m = {k: jnp.asarray(getattr(spec, k)) for k in
                  ("has_body", "has_controller", "has_intent", "has_loco",
                   "has_action", "has_dodge", "has_osc", "has_spin",
                   "has_platform", "has_wp", "is_player")}
        self.body_type = jnp.asarray(spec.body_type)
        self.character_slot = jnp.asarray(spec.character_slot)
        self.char_entities = np.nonzero(spec.character_slot >= 0)[0]
        self.gravity = jnp.asarray(spec.gravity, jnp.float32)

        self._substep = jax.jit(self._substep_impl)

    # ------------------------------------------------------------------

    def _substep_impl(self, state: WorldState, dt) -> WorldState:
        spec = self.spec
        dt = jnp.float32(dt)
        # Runtime liveness: every system mask is gated by the alive mask so
        # despawned entities stop simulating (World.destroyEntity analog).
        alive = state.alive
        m = {k: v & alive for k, v in self.m.items()}

        # --- pre: Spin (Systems.swift:97-119)
        spin_rot = S.spin_step(state.body_rot, jnp.asarray(spec.spin["speed"]),
                               jnp.asarray(spec.spin["axis"]), dt)
        body_rot = jnp.where((m["has_spin"] & m["has_body"])[:, None], spin_rot,
                             state.body_rot)
        trs_r = jnp.where((m["has_spin"] & ~m["has_body"])[:, None],
                          S.spin_step(state.trs_r, jnp.asarray(spec.spin["speed"]),
                                      jnp.asarray(spec.spin["axis"]), dt),
                          state.trs_r)

        # --- pre: OscillateMove -> intent velocity
        osc_time, osc_vel = S.oscillate_move(
            jnp.asarray(spec.osc["origin"]), jnp.asarray(spec.osc["axis"]),
            jnp.asarray(spec.osc["amplitude"]), jnp.asarray(spec.osc["speed"]),
            state.osc_time, dt, enabled=m["has_osc"])
        intent_vel = jnp.where((m["has_osc"] & m["has_intent"])[:, None],
                               osc_vel, state.intent_vel)

        # --- pre: ActiveChunk (Systems.swift:2354-2411) — Chebyshev
        # chunk-radius active set centered on the player's chunk; the physics
        # origin becomes that chunk (originLocal = 0). Inactive entities stop
        # simulating and their static collision drops out of the query set
        # (Systems.swift:174 activeStaticEntityIDs); they still render.
        # --- pre: PhysicsLocalize (Systems.swift:2310-2351) — every
        # WorldPosition entity's transform/body position is rebased to
        # origin-relative floats: (chunk - center) stays exact in int32, so
        # float precision is independent of distance from the world origin.
        trs_t = state.trs_t
        body_pos = state.body_pos
        center = jnp.zeros(3, jnp.int32)
        if self.player_idx is not None:
            center = state.wp_chunk[self.player_idx]
            rel_chunk = state.wp_chunk - center
            cheb = jnp.max(jnp.abs(rel_chunk), axis=-1) <= self.chunk_radius
            chunk_active = ~self.m["has_wp"] | cheb
            alive = alive & chunk_active
            m = {k: v & chunk_active for k, v in m.items()}
            local_world = rel_chunk.astype(jnp.float32) * CHUNK_SIZE + state.wp_local
            haswp_alive = state.alive & self.m["has_wp"]
            trs_t = jnp.where(haswp_alive[:, None], local_world, trs_t)
            body_pos = jnp.where((haswp_alive & self.m["has_body"])[:, None],
                                 local_world, body_pos)

        # --- pre: Dodge (drives intent + triggers action restart)
        dodge, overrides = S.dodge_step(state.dodge, body_rot,
                                        state.intent_dodge & m["has_dodge"], dt)
        apply_d = overrides["apply"] & m["has_dodge"]
        intent_vel = jnp.where(apply_d[:, None], overrides["desired_velocity"], intent_vel)
        intent_yaw = jnp.where(apply_d, overrides["facing_yaw"], state.intent_yaw)
        intent_has_yaw = jnp.where(apply_d, True, state.intent_has_yaw)
        intent_jump = jnp.where(apply_d, False, state.intent_jump)
        intent_dodge = jnp.zeros_like(state.intent_dodge)
        action_trigger = overrides["action_trigger"] & m["has_action"]

        # --- pre: PhysicsIntent
        body_vel, body_rot = S.physics_intent(
            state.body_vel, body_rot, intent_vel, intent_yaw, intent_has_yaw,
            dodge.active, m["has_controller"],
            jnp.asarray(spec.movement["max_accel"]),
            jnp.asarray(spec.movement["max_decel"]), dt,
            enabled=m["has_intent"] & m["has_body"] & (self.body_type != BODY_STATIC))

        # --- pre: Jump
        grounded = state.ctrl.grounded
        body_vel, grounded, intent_jump = S.jump_step(
            body_vel, grounded, intent_jump & m["has_intent"] & m["has_controller"])
        ctrl = state.ctrl._replace(grounded=grounded)

        # --- pre: PhysicsBeginStep (latch prev, in the localized frame)
        latch = m["has_body"] & (self.body_type != BODY_STATIC)
        body_prev_pos = jnp.where(latch[:, None], body_pos, state.body_prev_pos)
        body_prev_rot = jnp.where(latch[:, None], body_rot, state.body_prev_rot)

        # --- fixed: PlatformMotion. The platform's orbit origin is
        # recovered from its (localized) current position minus the current
        # offset (PhysicsLocalize does the same, Systems.swift:2339-2348),
        # so the motion stays exact in the active-origin frame.
        p_axis = jnp.asarray(spec.platform["axis"])
        p_axis_len = jnp.linalg.norm(p_axis, axis=-1, keepdims=True)
        p_axis_n = jnp.where(p_axis_len > 1e-4,
                             p_axis / jnp.maximum(p_axis_len, 1e-20),
                             jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]),
                                              p_axis.shape))
        p_speed = jnp.asarray(spec.platform["speed"])
        p_amp = jnp.asarray(spec.platform["amplitude"])
        p_phase = jnp.asarray(spec.platform["phase"])
        offset_now = jnp.sin(state.platform_time * p_speed + p_phase) * p_amp
        plat_origin = jnp.where((m["has_platform"] & self.m["has_wp"])[:, None],
                                body_pos - p_axis_n * offset_now[:, None],
                                jnp.asarray(spec.platform["origin"]))
        plat_time, plat_pos = S.kinematic_platform_motion(
            plat_origin, p_axis, p_amp, p_speed, p_phase,
            state.platform_time, dt, enabled=m["has_platform"])
        is_plat = m["has_platform"] & (self.body_type == BODY_KINEMATIC)
        body_pos = jnp.where(is_plat[:, None], plat_pos, body_pos)
        body_vel = jnp.where(is_plat[:, None], 0.0, body_vel)
        trs_t = jnp.where(is_plat[:, None], plat_pos, trs_t)

        # --- fixed: CollisionQueryRefresh — retransform the soup from current
        # entity transforms (body pose for bodies, TRS otherwise).
        ent_t = jnp.where(m["has_body"][:, None], body_pos, trs_t)
        ent_r = jnp.where(m["has_body"][:, None], body_rot, trs_r)
        transforms = _trs_matrices(ent_t, ent_r, state.trs_s)
        soup = transform_soup(self.collision, transforms, entity_alive=alive)

        # platform carry set: world AABBs + deltas
        plat_delta = body_pos - body_prev_pos
        platforms = PlatformSet(
            aabb_min=body_pos + jnp.asarray(spec.platform["aabb_min"]),
            aabb_max=body_pos + jnp.asarray(spec.platform["aabb_max"]),
            delta=plat_delta,
            valid=is_plat)

        # --- fixed: Gravity (dynamic bodies, skip grounded&near)
        body_vel = S.gravity_step(body_vel, ctrl.grounded, ctrl.grounded_near,
                                  m["has_body"] & (self.body_type == BODY_DYNAMIC),
                                  dt, spec.gravity)

        # --- fixed: KinematicMoveStop (characters); despawned agents inert
        cp = spec.controller_params._replace(
            active=spec.controller_params.active & alive)
        new_pos, new_vel, new_ctrl = self.pipeline.step(
            soup, body_pos, body_vel, ctrl, cp, platforms, dt)
        body_pos, body_vel, ctrl = new_pos, new_vel, new_ctrl

        # --- fixed: AgentSeparation
        body_pos, body_vel, ctrl = separate_agents(
            soup, body_pos, body_vel, ctrl, cp)

        # --- fixed: PhysicsIntegrate (plain bodies only)
        integ = m["has_body"] & ~m["has_controller"] & ~m["has_platform"]
        int_pos, int_rot = S.integrate_bodies(
            body_pos, body_rot, body_vel, state.body_ang_vel,
            self.body_type != BODY_STATIC, ~integ, dt)
        body_pos = jnp.where(integ[:, None], int_pos, body_pos)
        body_rot = jnp.where(integ[:, None], int_rot, body_rot)

        # --- fixed: LocomotionProfile (FSM)
        loco = state.loco
        if self.bank is not None:
            new_loco = locomotion_fsm_step(loco, self.bank, self.spec.loco_tuning,
                                           body_vel, ctrl.grounded_near,
                                           ctrl.ground_distance)
            loco = jax.tree.map(
                lambda a, b: jnp.where(
                    m["has_loco"].reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
                new_loco, loco)

        # --- fixed: ActionAnimation clock
        action = state.action
        if self.action_profile is not None:
            cfg = spec.action_cfg
            action = S.action_animation_step(
                action, jnp.asarray(cfg["cycle"]),
                jnp.where(jnp.asarray(spec.dodge_cfg["end_time"]) > 0,
                          jnp.asarray(spec.dodge_cfg["end_time"]),
                          jnp.asarray(spec.dodge_cfg["duration"])),
                m["has_dodge"], dt,
                playback_rate=jnp.asarray(cfg["rate"]),
                blend_in_time=jnp.asarray(cfg["blend_in"]),
                blend_out_half_life=jnp.asarray(cfg["blend_out"]),
                trigger=action_trigger)
            action = jax.tree.map(
                lambda a, b: jnp.where(m["has_action"], a, b), action, state.action)

        # --- fixed: PoseStack (characters only, gathered to C slots)
        palettes = state.palettes
        pose_phase = state.pose_phase
        if self.pose_engine is not None and len(self.char_entities):
            ce = jnp.asarray(self.char_entities)
            fwd = m3.quat_act(body_rot[ce], jnp.array([0.0, 0.0, -1.0]))
            inputs = PoseInputs(forward=fwd,
                                ground_normal=ctrl.ground_normal[ce],
                                grounded_near=ctrl.grounded_near[ce])
            loco_c = jax.tree.map(lambda x: x[ce], loco)
            params_c = jax.tree.map(lambda x: x[ce], spec.loco_params)
            astate_c = ActionState(time=action.time[ce], weight=action.weight[ce],
                                   active=action.active[ce])
            step = jax.vmap(lambda lo, pa, a, i: self.pose_engine.step_character(
                self.bank, self.action_profile, lo, pa, a, i, dt))
            res = step(loco_c, params_c, astate_c, inputs)
            loco = jax.tree.map(lambda full, upd: full.at[ce].set(upd), loco, res.loco)
            # Scatter pose results (ce enumeration order) into palette rows by
            # character_slot — slots need not be monotonic in entity order.
            slots = self.character_slot[ce]
            if self.inv_bind_override is not None:
                pal = jnp.matmul(res.model, self.inv_bind_override[slots])
            else:
                pal = res.palette
            palettes = palettes.at[slots].set(pal)
            pose_phase = pose_phase.at[ce].set(res.phase)

        # --- post: PhysicsWriteback (body -> transform)
        trs_t = jnp.where(m["has_body"][:, None], body_pos, trs_t)
        trs_r = jnp.where(m["has_body"][:, None], body_rot, trs_r)

        # --- post: WorldPositionSync (chunk/local, latch prev)
        wp_prev_chunk = jnp.where(m["has_wp"][:, None], state.wp_chunk,
                                  state.wp_prev_chunk)
        wp_prev_local = jnp.where(m["has_wp"][:, None], state.wp_local,
                                  state.wp_prev_local)
        # body positions are active-origin relative; re-anchor to the origin
        # chunk before canonicalizing (Systems.swift:2270-2307 adds the
        # active origin back the same way).
        chunk_b, local_b = world_to_chunk_local(body_pos)
        chunk_b = chunk_b + center
        chunk_c, local_c = canonicalize(state.wp_chunk, state.wp_local)
        use_body = m["has_wp"] & m["has_body"]
        wp_chunk = jnp.where(use_body[:, None], chunk_b,
                             jnp.where(m["has_wp"][:, None], chunk_c, state.wp_chunk))
        wp_local = jnp.where(use_body[:, None], local_b,
                             jnp.where(m["has_wp"][:, None], local_c, state.wp_local))

        return state._replace(
            trs_t=trs_t, trs_r=trs_r,
            wp_chunk=wp_chunk, wp_local=wp_local,
            wp_prev_chunk=wp_prev_chunk, wp_prev_local=wp_prev_local,
            body_pos=body_pos, body_vel=body_vel, body_rot=body_rot,
            body_prev_pos=body_prev_pos, body_prev_rot=body_prev_rot,
            ctrl=ctrl,
            intent_vel=intent_vel, intent_yaw=intent_yaw,
            intent_has_yaw=intent_has_yaw, intent_jump=intent_jump,
            intent_dodge=intent_dodge,
            loco=loco, action=action, dodge=dodge,
            osc_time=osc_time, platform_time=plat_time,
            palettes=palettes, pose_phase=pose_phase,
        )

    def device_put(self, dev):
        """Return a copy with every captured jax.Array moved to ``dev``.

        Scene assembly is staged on the host CPU device; jitted programs
        close over the stepper's arrays (collision soup, pose bank, masks),
        so one bulk move keeps those captures resident on the device that
        runs the frame (see DemoScene.build).
        """
        import copy
        import jax as _jax

        def move(t):
            return _jax.tree.map(
                lambda x: _jax.device_put(x, dev)
                if isinstance(x, _jax.Array) else x, t)

        new = copy.copy(self)
        for k, v in vars(self).items():
            if k == "_substep":
                continue
            setattr(new, k, move(v))
        new._substep = _jax.jit(new._substep_impl)
        return new

    def substep(self, state: WorldState, dt: float) -> WorldState:
        return self._substep(state, dt)

    # ------------------------------------------------------------------

    def extract(self, state: WorldState, alpha: float, camera_world):
        """RenderExtract: interpolated camera-relative instance transforms.

        reference: Systems.swift:2415-2547 — slerp rotations / lerp positions
        between prev and current physics state by the accumulator alpha;
        follow-target substitution; camera-relative f64->f32 rebase.
        """
        return self._extract(state, jnp.float32(alpha),
                             jnp.asarray(camera_world, jnp.float32))

    @partial(jax.jit, static_argnums=(0,))
    def _extract(self, state, alpha, camera_world):
        m = self.m
        # interpolate world position (chunk+local) when present, else body.
        prev_w = chunk_local_to_world(state.wp_prev_chunk, state.wp_prev_local)
        curr_w = chunk_local_to_world(state.wp_chunk, state.wp_local)
        interp_wp = prev_w + (curr_w - prev_w) * alpha
        interp_body = state.body_prev_pos + (state.body_pos - state.body_prev_pos) * alpha
        pos = jnp.where(m["has_wp"][:, None], interp_wp,
                        jnp.where(m["has_body"][:, None], interp_body, state.trs_t))
        rot = jnp.where(m["has_body"][:, None],
                        m3.quat_slerp(state.body_prev_rot, state.body_rot, alpha),
                        state.trs_r)
        # follow-target substitution
        follow = jnp.asarray(self.spec.follow_target)
        has_follow = follow >= 0
        src = jnp.where(has_follow, follow, jnp.arange(self.spec.n_entities))
        pos = pos[src]
        rot = rot[src]
        # reference: a follower renders with the TARGET transform's scale
        # (interpolatedModelMatrix uses t.scale of the substituted target).
        scale = state.trs_s[src]
        pos = pos - camera_world
        # Despawned entities: degenerate (zero-scale) instances parked far
        # from the camera never rasterize/intersect.
        alive = state.alive[src] & state.alive
        pos = jnp.where(alive[:, None], pos, 1.0e7)
        scale = jnp.where(alive[:, None], scale, 0.0)
        return _trs_matrices(pos, rot, scale), state.palettes
