"""Independent NumPy oracle of the reference pose-stack semantics.

Scalar, loop-based, written directly from the behavior of
Game/ProceduralPoseSystem.swift — used only to validate the vectorized
implementation in swift_game_engine_tpu.anim.pose.
"""

import numpy as np

from swift_game_engine_tpu.assets import nputil
from swift_game_engine_tpu.assets.motion_profile import evaluate_fourier

IDLE, WALK, RUN, FALLING = 0, 1, 2, 3


# --- tiny independent quaternion lib (x, y, z, w) ---

def q_from_mat(m):
    m = np.asarray(m, np.float64)[:3, :3]
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def q_to_mat4(q):
    x, y, z, w = q
    m = np.eye(4)
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return m


def q_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def q_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def q_axis_angle(angle, axis):
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([0.0, 0, 0, 1])
    axis = axis / n
    return np.array([*(axis * np.sin(angle / 2)), np.cos(angle / 2)])


def q_slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    d = min(d, 1.0)
    theta = np.arccos(d)
    if np.sin(theta) < 1e-6:
        out = (1 - t) * q0 + t * q1
    else:
        out = (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)
    return out / np.linalg.norm(out)


def q_act(q, v):
    qv = q[:3]
    w = q[3]
    t = 2 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def eval_channel(channel, phase, order, default):
    """MotionProfileEvaluator.evaluateChannel semantics."""
    out = np.array(default, np.float64)
    if channel:
        for i, ax in enumerate("xyz"):
            coeffs = channel.get(ax)
            if coeffs is not None:
                out[i] = evaluate_fourier(coeffs, phase, order)
    return out


def sample_bone(profile, name, phase, skeleton, i, in_place):
    """Per-bone sampling per ProceduralPoseSystem.swift:144-200 (locomotion
    path semantics: missing bone falls back to rest/zero defaults)."""
    rest_scaled = skeleton.rest_translation[i].astype(np.float64)
    rest_raw = skeleton.raw_rest_translation[i].astype(np.float64)
    bone = profile.bones.get(name)
    if bone is not None:
        raw = eval_channel(bone.get("translation"), phase, profile.order, rest_raw)
        rot_deg = eval_channel(bone.get("rotation"), phase, profile.order, (0.0, 0.0, 0.0))
    else:
        raw = rest_raw.copy()
        rot_deg = np.zeros(3)
    t = rest_scaled + (raw - rest_raw) * skeleton.unit_scale
    if i == 0 and in_place:
        t[0] = rest_scaled[0]
        t[2] = rest_scaled[2]
    rot = skeleton.pre_rot[i].astype(np.float64) @ nputil.rotation_xyz_degrees(rot_deg).astype(np.float64)
    return t, rot


def oracle_pose_step(skeleton, profiles, state, params, dt,
                     action_profile=None, action_state=None,
                     forward=(0, 0, -1), ground_normal=(0, 1, 0), grounded_near=False):
    """Full pose step. ``profiles`` = [idle, walk, run, fall] MotionProfile.

    ``state`` dict: state, from_state, times(4), blend_t, idle_inertia, is_blending.
    ``params`` dict: playback_rate, loop, in_place, blend_time, idle_half_life.
    Returns dict with local/model/palette (B,4,4 float64), phase, new state.
    """
    b_count = skeleton.bone_count
    cycles = np.array([max(p.cycle, 0.001) for p in profiles])
    times = state["times"] + dt * params["playback_rate"]
    if params["loop"]:
        times = np.mod(times, cycles)
    else:
        times = np.minimum(times, cycles)

    blend_t = state["blend_t"]
    inertia = state["idle_inertia"]
    blending = state["is_blending"]
    if blending:
        if state["state"] == IDLE:
            inertia *= 0.5 ** (dt / max(params["idle_half_life"], 0.001))
            if inertia <= 0.001:
                inertia = 0.0
                blend_t = 1.0
                blending = False
        else:
            blend_t = min(blend_t + dt / max(params["blend_time"], 0.001), 1.0)
            if blend_t >= 1.0:
                blending = False

    phases = np.clip(times / cycles, 0, 1)
    phase = phases[state["state"]]

    if blending:
        if state["state"] == IDLE:
            weight_to = 1.0 - min(max(inertia, 0.0), 1.0)
        else:
            tt = min(max(blend_t, 0.0), 1.0)
            weight_to = tt * tt * tt * (tt * (tt * 6 - 15) + 10)
    else:
        weight_to = 1.0
    if blending:
        if state["state"] == RUN:
            run_weight = weight_to
        elif state["from_state"] == RUN:
            run_weight = 1.0 - weight_to
        else:
            run_weight = 0.0
    else:
        run_weight = 1.0 if state["state"] == RUN else 0.0

    from_state = state["from_state"] if blending else state["state"]
    to_state = state["state"]

    local_t = np.zeros((b_count, 3))
    local_q = np.zeros((b_count, 4))
    for i, name in enumerate(skeleton.names):
        ft, frot = sample_bone(profiles[from_state], name, phases[from_state], skeleton, i, params["in_place"])
        tt_, trot = sample_bone(profiles[to_state], name, phases[to_state], skeleton, i, params["in_place"])
        t = ft + (tt_ - ft) * weight_to
        fq = q_from_mat(frot)
        tq = q_from_mat(trot)
        if i == 0 and blending:
            z = frot[:3, 2]
            yaw = np.arctan2(z[0], z[2])
            yaw_q = q_axis_angle(yaw, (0, 1, 0))
            from_pr = q_mul(q_conj(yaw_q), fq)
            to_pr = q_mul(q_conj(yaw_q), tq)
            pr = q_slerp(from_pr, to_pr, weight_to)
            rq = q_mul(yaw_q, pr)
        else:
            rq = q_slerp(fq, tq, weight_to)
        local_t[i] = t
        local_q[i] = rq

    run_lean = run_weight
    if action_profile is not None and action_state is not None and \
            action_state["active"] and action_state["weight"] > 0.001:
        cycle = max(action_profile.cycle, 0.001)
        aphase = min(max(action_state["time"] / cycle, 0.0), 1.0)
        w = min(max(action_state["weight"], 0.0), 1.0)
        run_lean *= (1 - w)
        for i, name in enumerate(skeleton.names):
            at, arot = sample_bone(action_profile, name, aphase, skeleton, i, action_state.get("in_place", True))
            aq = q_from_mat(arot)
            local_t[i] = local_t[i] + (at - local_t[i]) * w
            local_q[i] = q_slerp(local_q[i], aq, w)

    # Pelvis pitch-only ground align.
    pelvis = skeleton.semantic.get("pelvis")
    if pelvis is not None:
        fwd = np.asarray(forward, np.float64)
        horiz = np.array([fwd[0], 0, fwd[2]])
        if np.dot(horiz, horiz) > 1e-4:
            fwd_h = horiz / np.linalg.norm(horiz)
        else:
            fwd_h = np.array([0.0, 0, -1])
        if grounded_near:
            up = np.array([0.0, 1, 0])
            right = np.cross(up, fwd_h)
            right /= np.linalg.norm(right)
            gn = np.asarray(ground_normal, np.float64)
            nproj = gn - right * np.dot(gn, right)
            nproj /= np.linalg.norm(nproj)
            angle = np.arctan2(np.dot(np.cross(up, nproj), right), np.dot(up, nproj)) * 0.33
            align_q = q_axis_angle(angle, right)
        else:
            align_q = np.array([0.0, 0, 0, 1])
        local_t[pelvis] = q_act(align_q, local_t[pelvis])
        local_q[pelvis] = q_mul(align_q, local_q[pelvis])

        lean_index = None
        for key in ("chest", "spine3", "spine2", "spine1"):
            if key in skeleton.semantic:
                lean_index = skeleton.semantic[key]
                break
        if run_lean > 0.001 and lean_index is not None:
            local = compose_all(local_t, local_q)
            model = nputil.fk_model_transforms(skeleton.parent, local.astype(np.float32)).astype(np.float64)
            right_world = model[lean_index][:3, 0]
            right_world /= np.linalg.norm(right_world)
            pi = int(skeleton.parent[lean_index])
            if pi >= 0:
                pq = q_from_mat(model[pi])
                right_local = q_act(q_conj(pq), right_world)
            else:
                right_local = right_world
            lean_q = q_axis_angle(np.deg2rad(10.0) * run_lean, right_local)
            local_t[lean_index] = q_act(lean_q, local_t[lean_index])
            local_q[lean_index] = q_mul(lean_q, local_q[lean_index])

    local = compose_all(local_t, local_q)
    model = nputil.fk_model_transforms(skeleton.parent, local.astype(np.float32)).astype(np.float64)
    palette = model @ skeleton.inv_bind_model.astype(np.float64)
    return {
        "local": local, "model": model, "palette": palette, "phase": phase,
        "state": {"state": state["state"], "from_state": state["from_state"],
                  "times": times, "blend_t": blend_t, "idle_inertia": inertia,
                  "is_blending": blending},
    }


def compose_all(local_t, local_q):
    out = np.zeros((len(local_t), 4, 4))
    for i in range(len(local_t)):
        m = q_to_mat4(local_q[i])
        m[:3, 3] = local_t[i]
        out[i] = m
    return out
