"""ECS world: pytree-of-arrays state + host-side entity builder.

The reference World is a registry of per-type Entity->struct dictionaries with
1-4 component queries (reference: Game/World.swift:12-133, Game/Entity.swift).
The array redesign: every component is a dense array table sized by the entity
capacity E plus a boolean ``has`` mask — queries become mask intersections,
per-entity loops become masked vectorized ops, and the whole mutable state is
one pytree (`WorldState`) stepped under jit. Static/config data (meshes,
tuning, masks) lives in `SceneSpec` on the host and is closed over by the
jitted step.

Large-world positions keep the reference's chunk+local split
(Components.swift:54-135) as (int32 chunk, f32 local) — f32 keeps every device op in single precision.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..physics.character import ControllerState, ControllerParams
from ..physics.systems import DodgeState, ActionClock
from ..anim.pose import LocoState, LocoParams, ActionState

BODY_STATIC, BODY_KINEMATIC, BODY_DYNAMIC = 0, 1, 2
CHUNK_SIZE = 512.0


class WorldState(NamedTuple):
    """All mutable per-entity state (E entities)."""

    # Entity liveness (runtime createEntity/destroyEntity analog,
    # reference: Game/World.swift:44-57). Capacity is static; spawn/despawn
    # are mask flips inside jit (see spawn_entity/despawn_entity). Dead
    # entities are skipped by every system, their collision triangles are
    # invalidated, and extraction parks their render instances.
    alive: jnp.ndarray        # (E,) bool
    # TransformComponent (TRS)
    trs_t: jnp.ndarray        # (E,3)
    trs_r: jnp.ndarray        # (E,4) quat
    trs_s: jnp.ndarray        # (E,3)
    # WorldPositionComponent (chunk+local, with prev for interpolation)
    wp_chunk: jnp.ndarray     # (E,3) int32
    wp_local: jnp.ndarray     # (E,3) f32
    wp_prev_chunk: jnp.ndarray
    wp_prev_local: jnp.ndarray
    # PhysicsBodyComponent
    body_pos: jnp.ndarray     # (E,3)
    body_vel: jnp.ndarray     # (E,3)
    body_ang_vel: jnp.ndarray  # (E,3)
    body_rot: jnp.ndarray     # (E,4)
    body_prev_pos: jnp.ndarray
    body_prev_rot: jnp.ndarray
    # CharacterController dynamic state
    ctrl: ControllerState
    # MoveIntentComponent
    intent_vel: jnp.ndarray   # (E,3)
    intent_yaw: jnp.ndarray   # (E,)
    intent_has_yaw: jnp.ndarray  # (E,) bool
    intent_jump: jnp.ndarray  # (E,) bool
    intent_dodge: jnp.ndarray  # (E,) bool
    # Locomotion / pose clocks
    loco: LocoState           # batched (E,)
    action: ActionClock
    dodge: DodgeState
    single_clip_time: jnp.ndarray  # (E,) MotionProfileComponent.time
    # demo drivers
    osc_time: jnp.ndarray     # (E,)
    platform_time: jnp.ndarray  # (E,)
    # derived pose (palettes for rendering), kept for extraction
    palettes: jnp.ndarray     # (C,B,4,4)
    pose_phase: jnp.ndarray   # (E,)


def world_to_chunk_local(world):
    """WorldPosition.fromWorld (Components.swift:58-68), f32/int32 variant."""
    shifted = jnp.floor((world + CHUNK_SIZE * 0.5) / CHUNK_SIZE)
    chunk = shifted.astype(jnp.int32)
    local = world - shifted * CHUNK_SIZE
    return chunk, local


def chunk_local_to_world(chunk, local):
    return chunk.astype(jnp.float32) * CHUNK_SIZE + local


def canonicalize(chunk, local):
    """WorldPosition.canonicalize (Components.swift:71-86)."""
    d, l = world_to_chunk_local(local)
    return chunk + d, l


@dataclass
class SceneSpec:
    """Static scene description produced by WorldBuilder.build()."""

    n_entities: int
    names: list
    # masks
    has_body: np.ndarray
    body_type: np.ndarray         # (E,) int
    has_controller: np.ndarray
    has_intent: np.ndarray
    has_movement: np.ndarray
    has_loco: np.ndarray
    has_action: np.ndarray
    has_dodge: np.ndarray
    has_osc: np.ndarray
    has_spin: np.ndarray
    has_platform: np.ndarray
    has_wp: np.ndarray
    is_player: np.ndarray
    # params
    controller_params: ControllerParams
    loco_params: LocoParams       # per-entity pose params
    movement: dict                # walk/run speeds, thresholds, accel (E,)
    osc: dict                     # origin/axis/amplitude/speed (E,...)
    spin: dict                    # speed/axis
    platform: dict                # origin/axis/amplitude/speed/phase, local aabb (E,...)
    dodge_cfg: dict               # duration/distance/start/end (E,)
    action_cfg: dict              # cycle/blend_in/blend_out/loop/rate/has_dodge (E,)
    character_slot: np.ndarray    # (E,) int32 pose-character index or -1
    follow_target: np.ndarray     # (E,) int32 target entity or -1
    gravity: tuple = (0.0, -98.0, 0.0)


class WorldBuilder:
    """Host-side scene assembly (the reference's World.add(...) calls).

    Components are staged in per-entity dicts and densified into
    (SceneSpec, WorldState) by build().
    """

    def __init__(self):
        self.names: list = []
        self.c: dict[str, dict[int, dict]] = {}
        self._alive: list = []

    def create_entity(self, name: Optional[str] = None, alive: bool = True) -> int:
        """``alive=False`` reserves a dormant slot (components configured but
        skipped by every system) for runtime spawn_entity reuse."""
        e = len(self.names)
        self.names.append(name or f"entity_{e}")
        self._alive.append(bool(alive))
        return e

    def add(self, e: int, comp: str, **kw):
        self.c.setdefault(comp, {})[e] = kw
        return self

    @property
    def n(self) -> int:
        return len(self.names)

    # -- densification -------------------------------------------------------

    def _dense(self, comp, key, default, shape=(), dtype=np.float32):
        out = np.full((self.n, *shape), default, dtype)
        for e, kw in self.c.get(comp, {}).items():
            if key in kw and kw[key] is not None:
                out[e] = kw[key]
        return out

    def _mask(self, comp):
        m = np.zeros(self.n, bool)
        for e in self.c.get(comp, {}):
            m[e] = True
        return m

    def build(self):
        n = self.n
        tc = self.c.get("transform", {})

        def trs(key, default, dim=3):
            out = np.tile(np.asarray(default, np.float32), (n, 1))
            for e, kw in tc.items():
                if key in kw and kw[key] is not None:
                    out[e] = kw[key]
            return out

        t = trs("translation", [0, 0, 0])
        r = trs("rotation", [0, 0, 0, 1], 4)
        s = trs("scale", [1, 1, 1])

        body_t = self._dense("body", "position", 0.0, (3,))
        body_r = self._dense("body", "rotation", [0, 0, 0, 1], (4,))
        body_type = self._dense("body", "body_type", BODY_STATIC, (), np.int32)

        # controller params
        cp_defaults = ControllerParams.default(n)
        cp_kw = {f: np.asarray(getattr(cp_defaults, f)).copy()
                 for f in ControllerParams._fields}
        for e, kw in self.c.get("controller", {}).items():
            for k, v in kw.items():
                if k in cp_kw and v is not None:
                    cp_kw[k][e] = v
        has_ctrl = self._mask("controller")
        has_agent = self._mask("agent")
        for e, kw in self.c.get("agent", {}).items():
            cp_kw["agent_mass_weight"][e] = kw.get("mass_weight", 1.0)
            cp_kw["agent_solid"][e] = kw.get("is_solid", True)
            ro = kw.get("radius_override")
            cp_kw["agent_radius"][e] = ro if ro is not None else cp_kw["radius"][e]
        # agents without overrides follow their controller radius
        no_agent = ~has_agent
        cp_kw["agent_radius"][no_agent] = cp_kw["radius"][no_agent]
        # only controller-bodies are active in the mover
        cp_kw["active"] = has_ctrl & (body_type != BODY_STATIC) & self._mask("body")
        # agent_solid only meaningful with an agent component (reference:
        # collectAgentStates requires AgentCollisionComponent)
        cp_kw["agent_solid"] = np.asarray(cp_kw["agent_solid"]) & has_agent
        controller_params = ControllerParams(**{k: jnp.asarray(v) for k, v in cp_kw.items()})

        movement = dict(
            walk_speed=self._dense("movement", "walk_speed", 4.5),
            run_speed=self._dense("movement", "run_speed", 12.5),
            run_threshold=self._dense("movement", "run_threshold", 0.78),
            max_accel=self._dense("movement", "max_acceleration", 20.0),
            max_decel=self._dense("movement", "max_deceleration", 30.0),
        )

        osc = dict(
            origin=self._dense("oscillate", "origin", 0.0, (3,)),
            axis=self._dense("oscillate", "axis", [1, 0, 0], (3,)),
            amplitude=self._dense("oscillate", "amplitude", 4.0),
            speed=self._dense("oscillate", "speed", 1.0),
        )
        spin = dict(
            speed=self._dense("spin", "speed", 0.0),
            axis=self._dense("spin", "axis", [0, 1, 0], (3,)),
        )
        platform = dict(
            origin=self._dense("platform", "origin", 0.0, (3,)),
            axis=self._dense("platform", "axis", [0, 1, 0], (3,)),
            amplitude=self._dense("platform", "amplitude", 2.0),
            speed=self._dense("platform", "speed", 1.0),
            phase=self._dense("platform", "phase", 0.0),
            aabb_min=self._dense("platform", "aabb_min", 0.0, (3,)),
            aabb_max=self._dense("platform", "aabb_max", 0.0, (3,)),
        )
        dodge_cfg = dict(
            duration=self._dense("dodge", "duration", 0.35),
            distance=self._dense("dodge", "distance", 3.0),
            start_time=self._dense("dodge", "start_time", 0.0),
            end_time=self._dense("dodge", "end_time", 0.0),
        )
        action_cfg = dict(
            cycle=self._dense("action", "cycle", 1.0),
            blend_in=self._dense("action", "blend_in", 0.08),
            blend_out=self._dense("action", "blend_out", 0.12),
            rate=self._dense("action", "rate", 1.0),
        )

        loco_params = LocoParams(
            playback_rate=jnp.asarray(self._dense("motion_profile", "playback_rate", 1.0)),
            loop=jnp.asarray(self._dense("motion_profile", "loop", True, (), bool)),
            in_place=jnp.asarray(self._dense("motion_profile", "in_place", True, (), bool)),
            blend_time=jnp.asarray(self._dense("locomotion", "blend_time", 0.2)),
            idle_inertia_half_life=jnp.asarray(
                self._dense("locomotion", "idle_inertia_half_life", 0.18)),
        )

        character_slot = self._dense("character", "slot", -1, (), np.int32)
        n_chars = max(int(character_slot.max()) + 1, 1)
        n_bones = 1
        for e, kw in self.c.get("character", {}).items():
            n_bones = max(n_bones, int(kw.get("bone_count", 1)))

        follow = self._dense("follow", "target", -1, (), np.int32)

        from ..anim.locomotion import LocomotionTuning
        lt = LocomotionTuning.default((n,))
        lt_kw = {f: np.asarray(getattr(lt, f)).copy() for f in LocomotionTuning._fields}
        for e, kw in self.c.get("locomotion", {}).items():
            for k, v in kw.items():
                if k in lt_kw and v is not None:
                    lt_kw[k][e] = v
        self.loco_tuning = LocomotionTuning(**{k: jnp.asarray(v) for k, v in lt_kw.items()})

        spec = SceneSpec(
            n_entities=n,
            names=list(self.names),
            has_body=self._mask("body"),
            body_type=body_type,
            has_controller=has_ctrl,
            has_intent=self._mask("intent"),
            has_movement=self._mask("movement"),
            has_loco=self._mask("locomotion"),
            has_action=self._mask("action"),
            has_dodge=self._mask("dodge"),
            has_osc=self._mask("oscillate"),
            has_spin=self._mask("spin"),
            has_platform=self._mask("platform"),
            has_wp=self._mask("world_position"),
            is_player=self._mask("player"),
            controller_params=controller_params,
            loco_params=loco_params,
            movement=movement,
            osc=osc,
            spin=spin,
            platform=platform,
            dodge_cfg=dodge_cfg,
            action_cfg=action_cfg,
            character_slot=character_slot,
            follow_target=follow,
        )
        spec.loco_tuning = self.loco_tuning

        chunk, local = (np.zeros((n, 3), np.int32), np.zeros((n, 3), np.float32))
        wc, wl = [], []
        for e in range(n):
            w = t[e].astype(np.float64)
            sh = np.floor((w + CHUNK_SIZE / 2) / CHUNK_SIZE)
            chunk[e] = sh.astype(np.int32)
            local[e] = (w - sh * CHUNK_SIZE).astype(np.float32)

        state = WorldState(
            alive=jnp.asarray(np.asarray(self._alive, bool)),
            trs_t=jnp.asarray(t), trs_r=jnp.asarray(r), trs_s=jnp.asarray(s),
            wp_chunk=jnp.asarray(chunk), wp_local=jnp.asarray(local),
            wp_prev_chunk=jnp.asarray(chunk), wp_prev_local=jnp.asarray(local),
            body_pos=jnp.asarray(body_t), body_vel=jnp.zeros((n, 3)),
            body_ang_vel=jnp.asarray(self._dense("body", "angular_velocity", 0.0, (3,))),
            body_rot=jnp.asarray(body_r),
            body_prev_pos=jnp.asarray(body_t), body_prev_rot=jnp.asarray(body_r),
            ctrl=ControllerState.initial(n),
            intent_vel=jnp.zeros((n, 3)), intent_yaw=jnp.zeros(n),
            intent_has_yaw=jnp.zeros(n, bool), intent_jump=jnp.zeros(n, bool),
            intent_dodge=jnp.zeros(n, bool),
            loco=LocoState.initial((n,)),
            action=ActionClock.default((n,)),
            dodge=DodgeState(
                active=jnp.zeros(n, bool), time=jnp.zeros(n),
                duration=jnp.asarray(dodge_cfg["duration"]),
                distance=jnp.asarray(dodge_cfg["distance"]),
                start_time=jnp.asarray(dodge_cfg["start_time"]),
                end_time=jnp.asarray(dodge_cfg["end_time"]),
                direction=jnp.zeros((n, 3)), facing_yaw=jnp.zeros(n)),
            single_clip_time=jnp.zeros(n),
            osc_time=jnp.zeros(n),
            platform_time=jnp.zeros(n),
            palettes=jnp.tile(jnp.eye(4, dtype=jnp.float32), (n_chars, n_bones, 1, 1)),
            pose_phase=jnp.zeros(n),
        )
        return spec, state


# ---------------------------------------------------------------------------
# Runtime entity lifecycle (reference: Game/World.swift:44-57). Fixed
# capacity + alive mask: spawn/despawn are jit-safe array updates on a slot
# whose component configuration was reserved at build time.


def despawn_entity(state: WorldState, e) -> WorldState:
    """destroyEntity analog: the slot stops simulating, colliding and
    rendering; its dynamic state is neutralized for clean reuse (velocities,
    intents AND animation clocks — a recycled slot must not resume the
    previous occupant's mid-flight action/dodge/locomotion blend)."""
    z3 = jnp.zeros(3)
    zf = jnp.float32(0.0)
    act = state.action
    dod = state.dodge
    loco = state.loco
    return state._replace(
        alive=state.alive.at[e].set(False),
        body_vel=state.body_vel.at[e].set(z3),
        body_ang_vel=state.body_ang_vel.at[e].set(z3),
        intent_vel=state.intent_vel.at[e].set(z3),
        intent_jump=state.intent_jump.at[e].set(False),
        intent_dodge=state.intent_dodge.at[e].set(False),
        action=act._replace(
            active=act.active.at[e].set(False),
            time=act.time.at[e].set(zf),
            weight=act.weight.at[e].set(zf),
            exiting=act.exiting.at[e].set(False)),
        dodge=dod._replace(
            active=dod.active.at[e].set(False),
            time=dod.time.at[e].set(zf)),
        loco=loco._replace(
            state=loco.state.at[e].set(0),
            from_state=loco.from_state.at[e].set(0),
            times=loco.times.at[e].set(jnp.zeros(4)),
            blend_t=loco.blend_t.at[e].set(1.0),
            idle_inertia=loco.idle_inertia.at[e].set(zf),
            is_blending=loco.is_blending.at[e].set(False)),
    )


def spawn_entity(state: WorldState, e, position=None, rotation=None) -> WorldState:
    """createEntity analog into a dormant/despawned slot ``e``: resets the
    slot's dynamic state and enables it. Component layout (which systems act
    on the slot) is the build-time reservation."""
    st = despawn_entity(state, e)  # neutralizes velocities, intents + clocks
    pos = state.body_pos[e] if position is None else jnp.asarray(position, jnp.float32)
    rot = state.body_rot[e] if rotation is None else jnp.asarray(rotation, jnp.float32)
    chunk, local = world_to_chunk_local(pos)
    return st._replace(
        alive=st.alive.at[e].set(True),
        trs_t=st.trs_t.at[e].set(pos),
        trs_r=st.trs_r.at[e].set(rot),
        body_pos=st.body_pos.at[e].set(pos),
        body_rot=st.body_rot.at[e].set(rot),
        body_prev_pos=st.body_prev_pos.at[e].set(pos),
        body_prev_rot=st.body_prev_rot.at[e].set(rot),
        wp_chunk=st.wp_chunk.at[e].set(chunk),
        wp_local=st.wp_local.at[e].set(local),
        wp_prev_chunk=st.wp_prev_chunk.at[e].set(chunk),
        wp_prev_local=st.wp_prev_local.at[e].set(local),
    )
