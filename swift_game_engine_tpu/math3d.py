"""3D math substrate: matrices, quaternions, Euler rotations.

JAX replacement for the reference engine's simd-based math layer
(reference: Game/Math.swift:11-82, Game/Skeleton.swift:212-221).

Conventions (matching the reference's simd semantics):
  * Matrices are stored as standard numpy/jnp ``(..., 4, 4)`` arrays with the
    column-vector convention: ``p' = M @ p``.  The reference constructs
    ``matrix_float4x4`` column-by-column; here element ``[i, j]`` is row ``i``,
    column ``j`` of the same mathematical matrix, so ``simd_mul(a, b) == a @ b``.
  * Quaternions are ``(..., 4)`` arrays laid out ``(x, y, z, w)`` (imaginary
    part first, real part last) exactly like ``simd_quatf``.
  * Angles are radians unless a function name says degrees.

Everything here is pure jnp, safe under ``jit``/``vmap``, float32 by default.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Basic helpers


def radians_from_degrees(deg):
    """reference: Game/Math.swift:48-50."""
    return (jnp.asarray(deg, jnp.float32) / 180.0) * jnp.pi


def normalize(v, eps=1e-12):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def cross(a, b):
    return jnp.cross(a, b)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


# ---------------------------------------------------------------------------
# 4x4 matrix builders (reference: Game/Math.swift)


def mat4_identity(batch_shape=()):
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (*batch_shape, 4, 4))


def mat4_rotation(radians, axis):
    """Axis-angle rotation. reference: Game/Math.swift:11-24.

    Batched: ``radians`` shape ``(...,)``, ``axis`` shape ``(..., 3)``.
    """
    radians = jnp.asarray(radians, jnp.float32)
    axis = normalize(jnp.asarray(axis, jnp.float32))
    ct = jnp.cos(radians)
    st = jnp.sin(radians)
    ci = 1.0 - ct
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = jnp.zeros_like(ct)
    ones = jnp.ones_like(ct)
    # Rows of the standard Rodrigues rotation matrix.
    m = jnp.stack(
        [
            jnp.stack([ct + x * x * ci, x * y * ci - z * st, x * z * ci + y * st, zeros], axis=-1),
            jnp.stack([y * x * ci + z * st, ct + y * y * ci, y * z * ci - x * st, zeros], axis=-1),
            jnp.stack([z * x * ci - y * st, z * y * ci + x * st, ct + z * z * ci, zeros], axis=-1),
            jnp.stack([zeros, zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return m


def mat4_translation(t):
    """reference: Game/Math.swift:26-33. ``t`` shape ``(..., 3)``."""
    t = jnp.asarray(t, jnp.float32)
    m = mat4_identity(t.shape[:-1])
    return m.at[..., :3, 3].set(t)


def mat4_from_rt(rot3, t):
    """Compose a 4x4 from a 3x3 rotation block and translation."""
    batch = jnp.broadcast_shapes(rot3.shape[:-2], t.shape[:-1])
    m = mat4_identity(batch)
    m = m.at[..., :3, :3].set(jnp.broadcast_to(rot3, (*batch, 3, 3)))
    m = m.at[..., :3, 3].set(jnp.broadcast_to(t, (*batch, 3)))
    return m


def mat4_perspective_rh(fovy_radians, aspect, near, far):
    """Right-handed perspective, Metal-style [0,1] depth.

    reference: Game/Math.swift:35-46.
    """
    ys = 1.0 / jnp.tan(jnp.asarray(fovy_radians, jnp.float32) * 0.5)
    xs = ys / aspect
    zs = far / (near - far)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(xs)
    m = m.at[1, 1].set(ys)
    m = m.at[2, 2].set(zs)
    m = m.at[2, 3].set(zs * near)
    m = m.at[3, 2].set(-1.0)
    return m


def mat4_perspective_rh_inverse(fovy_radians, aspect, near, far):
    """Closed-form inverse of mat4_perspective_rh.

    jnp.linalg.inv on the forward matrix suffers catastrophic cancellation at
    the far plane in f32; the analytic inverse is exact.
    """
    ys = 1.0 / jnp.tan(jnp.asarray(fovy_radians, jnp.float32) * 0.5)
    xs = ys / aspect
    zs = far / (near - far)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(1.0 / xs)
    m = m.at[1, 1].set(1.0 / ys)
    m = m.at[2, 3].set(-1.0)
    m = m.at[3, 2].set(1.0 / (zs * near))
    m = m.at[3, 3].set(1.0 / near)
    return m


def mat4_look_at_rh(eye, center, up):
    """reference: Game/Math.swift:52-66."""
    eye = jnp.asarray(eye, jnp.float32)
    f = normalize(jnp.asarray(center, jnp.float32) - eye)
    r = normalize(cross(f, jnp.asarray(up, jnp.float32)))
    u = cross(r, f)
    m = jnp.stack(
        [
            jnp.concatenate([r, -dot(r, eye)[..., None]], axis=-1),
            jnp.concatenate([u, -dot(u, eye)[..., None]], axis=-1),
            jnp.concatenate([-f, dot(f, eye)[..., None]], axis=-1),
            jnp.broadcast_to(jnp.array([0, 0, 0, 1], jnp.float32), (*eye.shape[:-1], 4)),
        ],
        axis=-2,
    )
    return m


def mat4_ortho_rh(left, right, bottom, top, near, far):
    """reference: Game/Math.swift:68-82."""
    rl = right - left
    tb = top - bottom
    fn = far - near
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(2.0 / rl)
    m = m.at[1, 1].set(2.0 / tb)
    m = m.at[2, 2].set(-1.0 / fn)
    m = m.at[0, 3].set(-(right + left) / rl)
    m = m.at[1, 3].set(-(top + bottom) / tb)
    m = m.at[2, 3].set(-near / fn)
    m = m.at[3, 3].set(1.0)
    return m


def rotation_xyz_degrees(deg):
    """Euler XYZ (applied X then Y then Z): ``Rz @ Ry @ Rx``.

    reference: Game/Skeleton.swift:212-217. ``deg`` shape ``(..., 3)``.
    Returns a 4x4.
    """
    deg = jnp.asarray(deg, jnp.float32)
    rad = radians_from_degrees(deg)
    cx, cy, cz = jnp.cos(rad[..., 0]), jnp.cos(rad[..., 1]), jnp.cos(rad[..., 2])
    sx, sy, sz = jnp.sin(rad[..., 0]), jnp.sin(rad[..., 1]), jnp.sin(rad[..., 2])
    # Rz @ Ry @ Rx expanded analytically (cheaper than three matmuls).
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    zeros = jnp.zeros_like(r00)
    ones = jnp.ones_like(r00)
    m = jnp.stack(
        [
            jnp.stack([r00, r01, r02, zeros], axis=-1),
            jnp.stack([r10, r11, r12, zeros], axis=-1),
            jnp.stack([r20, r21, r22, zeros], axis=-1),
            jnp.stack([zeros, zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    return m


def mat4_translation_part(m):
    """reference: Game/Skeleton.swift:219-221."""
    return m[..., :3, 3]


def transform_point(m, p):
    """``(M @ [p, 1]).xyz`` for ``m (...,4,4)``, ``p (...,3)``."""
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def transform_dir(m, d):
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], d)


def mat4_inverse_rigid(m):
    """Inverse of a rotation+translation matrix (no scale)."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    rt = jnp.swapaxes(r, -1, -2)
    ti = -jnp.einsum("...ij,...j->...i", rt, t)
    return mat4_from_rt(rt, ti)


# ---------------------------------------------------------------------------
# Quaternions — layout (x, y, z, w) like simd_quatf

QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def quat_identity(batch_shape=()):
    return jnp.broadcast_to(QUAT_IDENTITY, (*batch_shape, 4))


def quat_from_axis_angle(angle, axis):
    """simd_quatf(angle:axis:)."""
    angle = jnp.asarray(angle, jnp.float32)
    axis = normalize(jnp.asarray(axis, jnp.float32))
    half = angle * 0.5
    s = jnp.sin(half)
    return jnp.concatenate([axis * s[..., None], jnp.cos(half)[..., None]], axis=-1)


def quat_mul(a, b):
    """Hamilton product ``a * b`` (apply b first, then a), simd semantics."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], jnp.float32)


def quat_inverse(q):
    return quat_conj(q) / jnp.maximum(jnp.sum(q * q, axis=-1, keepdims=True), 1e-20)


def quat_act(q, v):
    """Rotate vector ``v`` by unit quaternion ``q`` (simd_act)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_normalize(q, eps=1e-12):
    return normalize(q, eps)


def quat_from_mat3(r):
    """Rotation matrix (...,3,3) -> quaternion, branch-free (Shepperd's method).

    Matches simd_quaternion(matrix) up to sign (q and -q encode the same
    rotation; slerp here always takes the shortest arc, so the sign is
    irrelevant downstream).
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate 4*q_i^2 - 1 terms; pick the largest for stability.
    qw2 = tr
    qx2 = m00 - m11 - m22
    qy2 = m11 - m00 - m22
    qz2 = m22 - m00 - m11

    # Candidate quaternions (unnormalized) built from each dominant component.
    def build(dom2, a, b, c, order):
        s = jnp.sqrt(jnp.maximum(dom2 + 1.0, 0.0)) * 0.5
        inv = 0.25 / jnp.maximum(s, 1e-12)
        return order(s, a * inv, b * inv, c * inv)

    qw = build(qw2, m21 - m12, m02 - m20, m10 - m01,
               lambda s, a, b, c: jnp.stack([a, b, c, s], axis=-1))
    qx = build(qx2, m21 - m12, m01 + m10, m02 + m20,
               lambda s, a, b, c: jnp.stack([s, b, c, a], axis=-1))
    qy = build(qy2, m02 - m20, m01 + m10, m12 + m21,
               lambda s, a, b, c: jnp.stack([b, s, c, a], axis=-1))
    qz = build(qz2, m10 - m01, m02 + m20, m12 + m21,
               lambda s, a, b, c: jnp.stack([b, c, s, a], axis=-1))

    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    scores = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32).repeat(4, axis=-1), axis=-2)[..., 0, :]
    return quat_normalize(q)


def quat_from_mat4(m):
    return quat_from_mat3(m[..., :3, :3])


def mat3_from_quat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def mat4_from_quat(q):
    r = mat3_from_quat(q)
    batch = q.shape[:-1]
    m = mat4_identity(batch)
    return m.at[..., :3, :3].set(r)


def quat_from_euler_xyz_degrees(deg):
    """Quaternion of the Euler XYZ rotation ``Rz @ Ry @ Rx`` (see
    rotation_xyz_degrees), composed analytically: ``qz * qy * qx``.

    ``deg`` shape (..., 3). Equals ``quat_from_mat4(rotation_xyz_degrees(deg))``
    up to sign.
    """
    half = radians_from_degrees(jnp.asarray(deg, jnp.float32)) * 0.5
    cx, cy, cz = jnp.cos(half[..., 0]), jnp.cos(half[..., 1]), jnp.cos(half[..., 2])
    sx, sy, sz = jnp.sin(half[..., 0]), jnp.sin(half[..., 1]), jnp.sin(half[..., 2])
    # qz * qy * qx expanded (x, y, z, w):
    return jnp.stack(
        [
            cz * cy * sx - sz * sy * cx,
            cz * sy * cx + sz * cy * sx,
            sz * cy * cx - cz * sy * sx,
            cz * cy * cx + sz * sy * sx,
        ],
        axis=-1,
    )


def quat_slerp(q0, q1, t):
    """Shortest-arc slerp with nlerp fallback for nearly-parallel inputs.

    Matches simd_slerp's shortest-arc behavior. ``t`` broadcastable scalar
    or ``(...,)``.
    """
    t = jnp.asarray(t, jnp.float32)[..., None]
    d = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(d < 0.0, -q1, q1)
    d = jnp.abs(d)
    d = jnp.clip(d, -1.0, 1.0)
    theta = jnp.arccos(d)
    sin_theta = jnp.sin(theta)
    use_lerp = sin_theta < 1e-5
    safe_sin = jnp.where(use_lerp, 1.0, sin_theta)
    w0 = jnp.where(use_lerp, 1.0 - t, jnp.sin((1.0 - t) * theta) / safe_sin)
    w1 = jnp.where(use_lerp, t, jnp.sin(t * theta) / safe_sin)
    return quat_normalize(w0 * q0 + w1 * q1)


def smootherstep01(t):
    """Quintic smootherstep on already-clamped t: t^3 (t (6t - 15) + 10).

    reference: Game/ProceduralPoseSystem.swift:108 and Systems.swift dodge curve.
    """
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)
