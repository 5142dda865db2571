"""Pose stack: locomotion blending, action layer, procedural corrections, FK.

Array-native re-design of the reference's per-entity pose loop
(reference: Game/ProceduralPoseSystem.swift:10-407). Differences in *how*:

  * All four locomotion clips live in one stacked coefficient bank
    ``(4, B, 6, C)``; sampling a state is a leading-axis gather plus one
    matvec, instead of per-bone dictionary lookups and scalar Fourier loops.
  * Poses are carried as ``(t, q)`` translation/quaternion pairs; matrices are
    materialized once for FK. Blending, the action layer, and the procedural
    corrections are all branchless ``where``/slerp ops, so the whole pose
    update vmaps over N characters and runs inside the world-step jit.
  * The locomotion *state machine* (transitions) lives in
    ``anim.locomotion``; this module consumes its state and only advances
    clocks/blend weights exactly like the reference's pose system does.

Semantics parity notes (all verified against an independent NumPy oracle in
tests/test_pose.py):
  * clock advance + loop wrap: ProceduralPoseSystem.swift:42-56
  * idle-inertia vs timed blend update: :58-75
  * weightTo (smootherstep / 1-inertia): :101-111
  * runWeight: :112-124
  * per-bone sampling with rest-delta unit rescaling: :144-179
  * root in-place XZ lock: :174-179
  * pre-rotation / root-fix composition: :181-200 (pre-baked into
    ``Skeleton.pre_rot`` at load)
  * root yaw-stable slerp during blends: :206-218
  * action layer slerp: :286-338
  * pelvis pitch-only ground align (strength 0.33, parent space): :344-367
  * run/idle chest lean 10 deg: :369-393
  * FK + palette: :396-402
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from .. import math3d as m3
from ..assets.skeleton import Skeleton
from ..assets.motion_profile import PackedMotionProfile
from .fourier import evaluate_packed
from .fk import FKSolver, palette_from_model

# Locomotion states (reference: Game/Components.swift:223-228).
IDLE, WALK, RUN, FALLING = 0, 1, 2, 3


class LocoState(NamedTuple):
    """Mutable locomotion pose state (per character; batch with leading axis)."""

    state: jnp.ndarray        # () int32
    from_state: jnp.ndarray   # () int32
    times: jnp.ndarray        # (4,) clip clocks [idle, walk, run, fall]
    blend_t: jnp.ndarray      # ()
    idle_inertia: jnp.ndarray  # ()
    is_blending: jnp.ndarray  # () bool

    @staticmethod
    def initial(batch_shape=()):
        z = jnp.zeros(batch_shape, jnp.float32)
        return LocoState(
            state=jnp.zeros(batch_shape, jnp.int32),
            from_state=jnp.zeros(batch_shape, jnp.int32),
            times=jnp.zeros((*batch_shape, 4), jnp.float32),
            blend_t=z + 1.0,
            idle_inertia=z,
            is_blending=jnp.zeros(batch_shape, bool),
        )


class LocoParams(NamedTuple):
    """Per-character tuning (reference: Components.swift:230-293, 203-221)."""

    playback_rate: jnp.ndarray       # ()
    loop: jnp.ndarray                # () bool
    in_place: jnp.ndarray            # () bool
    blend_time: jnp.ndarray          # ()
    idle_inertia_half_life: jnp.ndarray  # ()

    @staticmethod
    def default(batch_shape=()):
        o = jnp.ones(batch_shape, jnp.float32)
        t = jnp.ones(batch_shape, bool)
        return LocoParams(
            playback_rate=o,
            loop=t,
            in_place=t,
            blend_time=o * 0.2,
            idle_inertia_half_life=o * 0.18,
        )


class ActionState(NamedTuple):
    """Action clip playback state (reference: Components.swift:620-653)."""

    time: jnp.ndarray     # ()
    weight: jnp.ndarray   # ()
    active: jnp.ndarray   # () bool

    @staticmethod
    def inactive(batch_shape=()):
        z = jnp.zeros(batch_shape, jnp.float32)
        return ActionState(time=z, weight=z, active=jnp.zeros(batch_shape, bool))


class PoseInputs(NamedTuple):
    """Per-character inputs from transform/physics for procedural corrections."""

    forward: jnp.ndarray        # (3,) world forward (rotation acting on (0,0,-1))
    ground_normal: jnp.ndarray  # (3,)
    grounded_near: jnp.ndarray  # () bool

    @staticmethod
    def default(batch_shape=()):
        return PoseInputs(
            forward=jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (*batch_shape, 3)),
            ground_normal=jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (*batch_shape, 3)),
            grounded_near=jnp.zeros(batch_shape, bool),
        )


class SkeletonArrays(NamedTuple):
    """Device-resident skeleton tensors (B bones).

    Rotations are carried as quaternions: the whole pose pipeline runs in
    (t, q) form and 4x4 matrices are materialized exactly once (for the
    palette) — far fewer ops.
    """

    inv_bind_model: jnp.ndarray   # (B,4,4)
    rest_translation: jnp.ndarray  # (B,3)
    raw_rest_translation: jnp.ndarray  # (B,3)
    pre_rot_quat: jnp.ndarray     # (B,4) pre-rotation (+root fix at bone 0)


class ProfileBank(NamedTuple):
    """Stacked locomotion profiles [idle, walk, run, fall]."""

    coeffs: jnp.ndarray       # (4,B,6,C)
    has_channel: jnp.ndarray  # (4,B,6)
    cycles: jnp.ndarray       # (4,)


class ActionProfile(NamedTuple):
    coeffs: jnp.ndarray       # (B,6,C)
    has_channel: jnp.ndarray  # (B,6)
    cycle: jnp.ndarray        # ()
    in_place: jnp.ndarray     # () bool


class PoseResult(NamedTuple):
    local: jnp.ndarray    # (B,4,4)
    model: jnp.ndarray    # (B,4,4)
    palette: jnp.ndarray  # (B,4,4)
    phase: jnp.ndarray    # ()
    loco: "LocoState"


def _compose_tq(t, q):
    """Local matrix = T(t) @ R(q)."""
    m = m3.mat4_from_quat(q)
    return m.at[..., :3, 3].set(t)


def _sample_tq(coeffs, has_channel, phase, order: int, skel: SkeletonArrays,
               unit_scale: float, in_place):
    """Sample one profile into per-bone (translation, rotation-quat).

    reference: ProceduralPoseSystem.swift:144-200 — translation is rebased by
    ``rest_scaled + (anim_raw - rest_raw) * unitScale``; rotation is
    ``pre_rot * eulerXYZ(anim_degrees)`` with the root fix pre-baked into
    ``pre_rot[0]`` (quaternion composition ≡ the reference's matrix products).
    Returns (t (B,3), q (B,4)).
    """
    trans_raw, rot_deg = evaluate_packed(coeffs, has_channel, phase, order,
                                         skel.raw_rest_translation)
    delta = trans_raw - skel.raw_rest_translation
    t = skel.rest_translation + delta * unit_scale
    # Root in-place XZ lock (root bone is index 0 by schema convention).
    locked = t.at[0, 0].set(skel.rest_translation[0, 0]).at[0, 2].set(skel.rest_translation[0, 2])
    t = jnp.where(in_place, locked, t)
    q = m3.quat_mul(skel.pre_rot_quat, m3.quat_from_euler_xyz_degrees(rot_deg))
    return t, q


def locomotion_pose_tq(bank: ProfileBank, state: LocoState, params: LocoParams,
                       skel: SkeletonArrays, order: int, unit_scale: float, dt):
    """Advance locomotion clocks/blends and sample the blended (t, q) pose.

    Returns (t (B,3), q (B,4), phase (), run_lean_weight (), new LocoState).
    """
    dt = jnp.asarray(dt, jnp.float32)
    cycles = jnp.maximum(bank.cycles, 0.001)

    times = state.times + dt * params.playback_rate
    times = jnp.where(params.loop, jnp.mod(times, cycles), jnp.minimum(times, cycles))

    # Blend bookkeeping (ProceduralPoseSystem.swift:58-75).
    is_idle = state.state == IDLE
    half_life = jnp.maximum(params.idle_inertia_half_life, 0.001)
    inertia_decayed = state.idle_inertia * jnp.power(0.5, dt / half_life)
    idle_done = inertia_decayed <= 0.001
    blend_dur = jnp.maximum(params.blend_time, 0.001)
    bt_next = jnp.minimum(state.blend_t + dt / blend_dur, 1.0)

    blend_t = jnp.where(
        state.is_blending,
        jnp.where(is_idle, jnp.where(idle_done, 1.0, state.blend_t), bt_next),
        state.blend_t,
    )
    idle_inertia = jnp.where(
        state.is_blending & is_idle,
        jnp.where(idle_done, 0.0, inertia_decayed),
        state.idle_inertia,
    )
    is_blending = jnp.where(
        state.is_blending,
        jnp.where(is_idle, ~idle_done, bt_next < 1.0),
        False,
    )

    phases = jnp.clip(times / cycles, 0.0, 1.0)  # (4,)
    pose_phase = phases[state.state]

    # weightTo (ProceduralPoseSystem.swift:101-111) using *updated* blend vars.
    w_idle = 1.0 - jnp.clip(idle_inertia, 0.0, 1.0)
    w_timed = m3.smootherstep01(jnp.clip(blend_t, 0.0, 1.0))
    weight_to = jnp.where(is_blending, jnp.where(is_idle, w_idle, w_timed), 1.0)

    # runWeight (ProceduralPoseSystem.swift:112-124).
    run_weight = jnp.where(
        is_blending,
        jnp.where(state.state == RUN, weight_to,
                  jnp.where(state.from_state == RUN, 1.0 - weight_to, 0.0)),
        jnp.where(state.state == RUN, 1.0, 0.0),
    )

    from_eff = jnp.where(is_blending, state.from_state, state.state)
    to_eff = state.state

    t_from, q_from = _sample_tq(
        bank.coeffs[from_eff], bank.has_channel[from_eff], phases[from_eff],
        order, skel, unit_scale, params.in_place)
    t_to, q_to = _sample_tq(
        bank.coeffs[to_eff], bank.has_channel[to_eff], phases[to_eff],
        order, skel, unit_scale, params.in_place)

    t = t_from + (t_to - t_from) * weight_to
    q = m3.quat_slerp(q_from, q_to, weight_to)

    # Root yaw-stable slerp while blending (ProceduralPoseSystem.swift:206-218):
    # decompose the *from* root rotation's yaw, slerp only the pitch/roll
    # remainder, re-apply yaw. (The reference reads the matrix z column;
    # quat_act(q, e_z) is the same vector.)
    z_axis = m3.quat_act(q_from[0], jnp.array([0.0, 0.0, 1.0]))
    yaw = jnp.arctan2(z_axis[0], z_axis[2])
    yaw_q = m3.quat_from_axis_angle(yaw, jnp.array([0.0, 1.0, 0.0]))
    yaw_q_inv = m3.quat_conj(yaw_q)
    from_pr = m3.quat_mul(yaw_q_inv, q_from[0])
    to_pr = m3.quat_mul(yaw_q_inv, q_to[0])
    pr = m3.quat_slerp(from_pr, to_pr, weight_to)
    q_root_stable = m3.quat_mul(yaw_q, pr)
    q = q.at[0].set(jnp.where(is_blending, q_root_stable, q[0]))

    new_state = LocoState(state=state.state, from_state=state.from_state,
                          times=times, blend_t=blend_t,
                          idle_inertia=idle_inertia, is_blending=is_blending)
    return t, q, pose_phase, run_weight, new_state


def single_profile_pose_tq(coeffs, has_channel, cycle, time, params: LocoParams,
                           skel: SkeletonArrays, order: int, unit_scale: float, dt):
    """Single-clip playback path (ProceduralPoseSystem.swift:224-276).

    Returns (t, q, phase, new_time).
    """
    cycle = jnp.maximum(cycle, 0.001)
    time = time + jnp.asarray(dt, jnp.float32) * params.playback_rate
    time = jnp.where(params.loop, jnp.mod(time, cycle), jnp.minimum(time, cycle))
    phase = jnp.clip(time / cycle, 0.0, 1.0)
    t, q = _sample_tq(coeffs, has_channel, phase, order, skel, unit_scale,
                      params.in_place)
    return t, q, phase, time


def apply_action_layer(t, q, run_lean_weight, action: ActionProfile,
                       astate: ActionState, skel: SkeletonArrays, order: int,
                       unit_scale: float):
    """Blend a one-shot action clip over the base pose.

    reference: ProceduralPoseSystem.swift:286-338 (translation lerp +
    quaternion slerp by the action weight; lean weight attenuated by 1-w).
    """
    phase = jnp.clip(astate.time / jnp.maximum(action.cycle, 0.001), 0.0, 1.0)
    t_a, q_a = _sample_tq(action.coeffs, action.has_channel, phase, order,
                          skel, unit_scale, action.in_place)
    apply = astate.active & (astate.weight > 0.001)
    w = jnp.where(apply, jnp.clip(astate.weight, 0.0, 1.0), 0.0)
    t_out = t + (t_a - t) * w
    q_out = m3.quat_slerp(q, q_a, w)
    return t_out, q_out, run_lean_weight * (1.0 - w)


class PoseEngine:
    """Per-skeleton pose pipeline with static FK plan and semantic indices."""

    def __init__(self, skeleton: Skeleton):
        from ..assets import nputil
        self.skeleton = skeleton
        self.unit_scale = float(skeleton.unit_scale)
        self.fk = FKSolver(skeleton.parent, skeleton.levels)
        pre_q = np.stack([nputil.quat_from_mat(m) for m in skeleton.pre_rot])
        self.arrays = SkeletonArrays(
            inv_bind_model=jnp.asarray(skeleton.inv_bind_model),
            rest_translation=jnp.asarray(skeleton.rest_translation),
            raw_rest_translation=jnp.asarray(skeleton.raw_rest_translation),
            pre_rot_quat=jnp.asarray(pre_q),
        )
        self.pelvis = skeleton.semantic.get("pelvis")
        # Lean bone fallback chain (ProceduralPoseSystem.swift:371-374).
        self.lean_index: Optional[int] = None
        for key in ("chest", "spine3", "spine2", "spine1"):
            if key in skeleton.semantic:
                self.lean_index = skeleton.semantic[key]
                break
        self.parent_np = np.asarray(skeleton.parent, np.int32)

    def make_bank(self, idle: PackedMotionProfile, walk: PackedMotionProfile,
                  run: PackedMotionProfile, fall: PackedMotionProfile) -> ProfileBank:
        profs = [idle, walk, run, fall]
        order = profs[0].order
        assert all(p.order == order for p in profs), "profile order mismatch"
        self.order = order
        return ProfileBank(
            coeffs=jnp.stack([jnp.asarray(p.coeffs) for p in profs]),
            has_channel=jnp.stack([jnp.asarray(p.has_channel) for p in profs]),
            cycles=jnp.array([p.cycle for p in profs], jnp.float32),
        )

    def make_action(self, packed: PackedMotionProfile, in_place=True) -> ActionProfile:
        return ActionProfile(
            coeffs=jnp.asarray(packed.coeffs),
            has_channel=jnp.asarray(packed.has_channel),
            cycle=jnp.float32(packed.cycle),
            in_place=jnp.asarray(in_place, bool),
        )

    # -- procedural corrections + FK ------------------------------------

    def finish_pose(self, t, q, run_lean_weight, inputs: PoseInputs):
        """Pelvis ground-align, chest run-lean, FK, palette.

        reference: ProceduralPoseSystem.swift:344-402.
        """
        up = jnp.array([0.0, 1.0, 0.0])
        if self.pelvis is not None:
            fwd = inputs.forward
            horiz = jnp.array([1.0, 0.0, 1.0]) * fwd
            horiz_ok = jnp.sum(horiz * horiz) > 1e-4
            fwd_h = jnp.where(horiz_ok, m3.normalize(horiz), jnp.array([0.0, 0.0, -1.0]))
            right = m3.normalize(m3.cross(up, fwd_h))
            gn = inputs.ground_normal
            n_proj = m3.normalize(gn - right * m3.dot(gn, right))
            cross_up = m3.cross(up, n_proj)
            angle = jnp.arctan2(m3.dot(cross_up, right), m3.dot(up, n_proj)) * 0.33
            angle = jnp.where(inputs.grounded_near, angle, 0.0)
            align_q = m3.quat_from_axis_angle(angle, right)
            # Left-multiplying a pure rotation M onto T(t)R: t' = M t, q' = qM q.
            p = self.pelvis
            t = t.at[p].set(m3.quat_act(align_q, t[p]))
            q = q.at[p].set(m3.quat_mul(align_q, q[p]))

            if self.lean_index is not None:
                li = self.lean_index
                _, q_model_pre = self.fk.model_tq(t, q)
                # Model-matrix column 0 == quat_act(q_model, e_x).
                right_world = m3.normalize(m3.quat_act(q_model_pre[li], jnp.array([1.0, 0.0, 0.0])))
                pi = int(self.parent_np[li])
                if pi >= 0:
                    right_local = m3.quat_act(m3.quat_conj(q_model_pre[pi]), right_world)
                else:
                    right_local = right_world
                lean_angle = m3.radians_from_degrees(10.0) * run_lean_weight
                lean_q = m3.quat_from_axis_angle(lean_angle, right_local)
                t = t.at[li].set(m3.quat_act(lean_q, t[li]))
                q = q.at[li].set(m3.quat_mul(lean_q, q[li]))

        local = _compose_tq(t, q)
        model = self.fk.model_matrices(t, q)
        palette = palette_from_model(model, self.arrays.inv_bind_model)
        return local, model, palette

    # -- full per-character step (vmap over leading axis for batches) ----

    def step_character(self, bank: ProfileBank, action: Optional[ActionProfile],
                       loco: LocoState, params: LocoParams,
                       astate: Optional[ActionState], inputs: PoseInputs,
                       dt) -> PoseResult:
        t, q, phase, run_w, new_loco = locomotion_pose_tq(
            bank, loco, params, self.arrays, self.order, self.unit_scale, dt)
        if action is not None and astate is not None:
            t, q, run_w = apply_action_layer(
                t, q, run_w, action, astate, self.arrays, self.order, self.unit_scale)
        local, model, palette = self.finish_pose(t, q, run_w, inputs)
        return PoseResult(local=local, model=model, palette=palette,
                          phase=phase, loco=new_loco)
