"""Vectorized collision geometry primitives.

Branchless jnp re-derivations of the reference's scalar routines
(reference: Game/CollisionQuery.swift:1396-1631): Ericson-style
point-triangle closest point, segment-segment closest points,
Moller-Trumbore segment/ray-triangle intersection, and the capsule-core
segment-triangle distance that drives the CCD sweep. Every function
broadcasts over arbitrary leading batch dims so (agents x triangles) pairs
evaluate as one fused elementwise program.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..math3d import cross, dot

_EPS = 1e-6


def closest_point_on_triangle(p, a, b, c):
    """Closest point on triangle abc to point p (broadcasting).

    Returns (dist_sq, point). Branch structure follows the Voronoi-region
    method (reference: Game/CollisionQuery.swift:1464-1517), expressed as a
    priority chain of masks.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)

    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)

    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    # Region tests in the reference's order; first true wins.
    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_c = (d6 >= 0) & (d5 <= d6)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    def safe_div(num, den):
        return num / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)

    p_ab = a + ab * safe_div(d1, d1 - d3)[..., None]
    p_ac = a + ac * safe_div(d2, d2 - d6)[..., None]
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    p_bc = b + (c - b) * w_bc[..., None]

    denom = safe_div(jnp.ones_like(va), va + vb + vc)
    p_in = a + ab * (vb * denom)[..., None] + ac * (vc * denom)[..., None]

    # Priority chain (later = lower priority).
    point = p_in
    point = jnp.where(m_bc[..., None], p_bc, point)
    point = jnp.where(m_ac[..., None], p_ac, point)
    point = jnp.where(m_c[..., None], jnp.broadcast_to(c, point.shape), point)
    point = jnp.where(m_ab[..., None], p_ab, point)
    point = jnp.where(m_b[..., None], jnp.broadcast_to(b, point.shape), point)
    point = jnp.where(m_a[..., None], jnp.broadcast_to(a, point.shape), point)

    diff = p - point
    return dot(diff, diff), point


def segment_segment_closest(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2] (broadcasting).

    Returns (dist_sq, point_on_1, point_on_2). Follows the clamped-quadratic
    method of the reference (Game/CollisionQuery.swift:1519-1569).
    """
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = dot(d1, d1)
    e = dot(d2, d2)
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)

    denom = a * e - b * b
    s_general = jnp.clip(jnp.where(jnp.abs(denom) > 0, (b * f - c * e) /
                                   jnp.where(denom == 0, 1.0, denom), 0.0), 0.0, 1.0)

    t_nom = b * s_general + f
    e_safe = jnp.where(e < _EPS, 1.0, e)
    a_safe = jnp.where(a < _EPS, 1.0, a)

    s = s_general
    t = t_nom / e_safe
    s = jnp.where(t_nom < 0, jnp.clip(-c / a_safe, 0.0, 1.0), s)
    t = jnp.where(t_nom < 0, 0.0, t)
    s = jnp.where(t_nom > e, jnp.clip((b - c) / a_safe, 0.0, 1.0), s)
    t = jnp.where(t_nom > e, 1.0, t)

    # Degenerate segments.
    both_pts = (a <= _EPS) & (e <= _EPS)
    seg1_pt = (a <= _EPS) & ~both_pts
    seg2_pt = (e <= _EPS) & ~both_pts
    s = jnp.where(both_pts | seg1_pt, 0.0, s)
    t = jnp.where(both_pts, 0.0, jnp.where(seg1_pt, jnp.clip(f / e_safe, 0.0, 1.0), t))
    s = jnp.where(seg2_pt, jnp.clip(-c / a_safe, 0.0, 1.0), s)
    t = jnp.where(seg2_pt, 0.0, t)

    c1 = p1 + d1 * s[..., None]
    c2 = p2 + d2 * t[..., None]
    diff = c1 - c2
    return dot(diff, diff), c1, c2


def segment_triangle_intersect(a, b, v0, v1, v2):
    """Segment [a,b] vs triangle: (hit bool, point). Moller-Trumbore with
    t in [0,1] (reference: Game/CollisionQuery.swift:1440-1462)."""
    d = b - a
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) >= _EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tvec = a - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0) & (t <= 1)
    point = a + d * t[..., None]
    return hit, point


# ---------------------------------------------------------------------------
# COLUMN-FORM interiors. Ops on (..., 3)-shaped arrays make the 3-wide axis
# the minor dimension of every elementwise op, with relayouts between most
# of them. The capsule-triangle distance is the
# inner loop of every cast/overlap over (agents x candidate-tris) pairs, so
# its interior runs on per-axis column arrays; the (.., 3) interface packs
# only at the boundary.
# ---------------------------------------------------------------------------


def _cols(v):
    return v[..., 0], v[..., 1], v[..., 2]


def _cpt_cols(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """closest_point_on_triangle, column form -> (dist_sq, qx, qy, qz)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz

    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz

    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    m_c = (d6 >= 0) & (d5 <= d6)
    m_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    m_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    def safe_div(num, den):
        return num / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)

    w_ab = safe_div(d1, d1 - d3)
    w_ac = safe_div(d2, d2 - d6)
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = safe_div(jnp.ones_like(va), va + vb + vc)
    wv = vb * denom
    wc = vc * denom

    def pick(axis_a, ab_c, ac_c, b_c, c_c, cb_c):
        q = axis_a + ab_c * wv + ac_c * wc
        q = jnp.where(m_bc, b_c + cb_c * w_bc, q)
        q = jnp.where(m_ac, axis_a + ac_c * w_ac, q)
        q = jnp.where(m_c, c_c, q)
        q = jnp.where(m_ab, axis_a + ab_c * w_ab, q)
        q = jnp.where(m_b, b_c, q)
        q = jnp.where(m_a, axis_a, q)
        return q

    qx = pick(ax, abx, acx, bx, cx, cx - bx)
    qy = pick(ay, aby, acy, by, cy, cy - by)
    qz = pick(az, abz, acz, bz, cz, cz - bz)
    dx, dy, dz = px - qx, py - qy, pz - qz
    return dx * dx + dy * dy + dz * dz, qx, qy, qz


def _seg_seg_cols(p1x, p1y, p1z, q1x, q1y, q1z,
                  p2x, p2y, p2z, q2x, q2y, q2z):
    """segment_segment_closest, column form ->
    (dist_sq, c1x, c1y, c1z, c2x, c2y, c2z)."""
    d1x, d1y, d1z = q1x - p1x, q1y - p1y, q1z - p1z
    d2x, d2y, d2z = q2x - p2x, q2y - p2y, q2z - p2z
    rx, ry, rz = p1x - p2x, p1y - p2y, p1z - p2z
    a = d1x * d1x + d1y * d1y + d1z * d1z
    e = d2x * d2x + d2y * d2y + d2z * d2z
    f = d2x * rx + d2y * ry + d2z * rz
    c = d1x * rx + d1y * ry + d1z * rz
    b = d1x * d2x + d1y * d2y + d1z * d2z

    denom = a * e - b * b
    s_general = jnp.clip(jnp.where(jnp.abs(denom) > 0, (b * f - c * e) /
                                   jnp.where(denom == 0, 1.0, denom), 0.0),
                         0.0, 1.0)

    t_nom = b * s_general + f
    e_safe = jnp.where(e < _EPS, 1.0, e)
    a_safe = jnp.where(a < _EPS, 1.0, a)

    s = s_general
    t = t_nom / e_safe
    s = jnp.where(t_nom < 0, jnp.clip(-c / a_safe, 0.0, 1.0), s)
    t = jnp.where(t_nom < 0, 0.0, t)
    s = jnp.where(t_nom > e, jnp.clip((b - c) / a_safe, 0.0, 1.0), s)
    t = jnp.where(t_nom > e, 1.0, t)

    both_pts = (a <= _EPS) & (e <= _EPS)
    seg1_pt = (a <= _EPS) & ~both_pts
    seg2_pt = (e <= _EPS) & ~both_pts
    s = jnp.where(both_pts | seg1_pt, 0.0, s)
    t = jnp.where(both_pts, 0.0,
                  jnp.where(seg1_pt, jnp.clip(f / e_safe, 0.0, 1.0), t))
    s = jnp.where(seg2_pt, jnp.clip(-c / a_safe, 0.0, 1.0), s)
    t = jnp.where(seg2_pt, 0.0, t)

    c1x, c1y, c1z = p1x + d1x * s, p1y + d1y * s, p1z + d1z * s
    c2x, c2y, c2z = p2x + d2x * t, p2y + d2y * t, p2z + d2z * t
    dx, dy, dz = c1x - c2x, c1y - c2y, c1z - c2z
    return dx * dx + dy * dy + dz * dz, c1x, c1y, c1z, c2x, c2y, c2z


def segment_triangle_distance(center, half_height, v0, v1, v2):
    """Distance from a Y-axis capsule core segment to a triangle.

    The segment is [center + (0,h,0), center - (0,h,0)]. Returns
    (dist, seg_point, tri_point); dist == 0 with coincident points when the
    segment pierces the triangle (reference: Game/CollisionQuery.swift:1396-1438).
    Interior runs in column form (see the section note above).
    """
    cxp, cyp, czp = _cols(center)
    ax, ay, az = cxp, cyp + half_height, czp
    bx, by, bz = cxp, cyp - half_height, czp
    v0x, v0y, v0z = _cols(v0)
    v1x, v1y, v1z = _cols(v1)
    v2x, v2y, v2z = _cols(v2)

    # Moller-Trumbore segment pierce (d = b - a = (0, -2h, 0))
    dx, dy, dz = ax - bx, ay - by, az - bz
    dx, dy, dz = -dx, -dy, -dz
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = jnp.abs(det) >= _EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tvx, tvy, tvz = ax - v0x, ay - v0y, az - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & \
        (t >= 0) & (t <= 1)
    pix, piy, piz = ax + dx * t, ay + dy * t, az + dz * t

    d0, p0x, p0y, p0z = _cpt_cols(ax, ay, az, v0x, v0y, v0z,
                                  v1x, v1y, v1z, v2x, v2y, v2z)
    d1, p1x, p1y, p1z = _cpt_cols(bx, by, bz, v0x, v0y, v0z,
                                  v1x, v1y, v1z, v2x, v2y, v2z)
    de0, s0x, s0y, s0z, t0x, t0y, t0z = _seg_seg_cols(
        ax, ay, az, bx, by, bz, v0x, v0y, v0z, v1x, v1y, v1z)
    de1, s1x, s1y, s1z, t1x, t1y, t1z = _seg_seg_cols(
        ax, ay, az, bx, by, bz, v1x, v1y, v1z, v2x, v2y, v2z)
    de2, s2x, s2y, s2z, t2x, t2y, t2z = _seg_seg_cols(
        ax, ay, az, bx, by, bz, v2x, v2y, v2z, v0x, v0y, v0z)

    # Nearest of the 5 feature candidates by a select chain (an argmin +
    # take_along_axis form lowered to per-element gathers costing 74
    # ms/substep at 1024 agents); strict-< keeps the first minimum on
    # ties exactly like argmin.
    z = jnp.zeros_like(d0)
    bd = d0
    bsx, bsy, bsz = ax + z, ay + z, az + z
    btx, bty, btz = p0x, p0y, p0z
    for dk, sxk, syk, szk, txk, tyk, tzk in (
            (d1, bx + z, by + z, bz + z, p1x, p1y, p1z),
            (de0, s0x, s0y, s0z, t0x, t0y, t0z),
            (de1, s1x, s1y, s1z, t1x, t1y, t1z),
            (de2, s2x, s2y, s2z, t2x, t2y, t2z)):
        win = dk < bd
        bd = jnp.where(win, dk, bd)
        bsx = jnp.where(win, sxk, bsx)
        bsy = jnp.where(win, syk, bsy)
        bsz = jnp.where(win, szk, bsz)
        btx = jnp.where(win, txk, btx)
        bty = jnp.where(win, tyk, bty)
        btz = jnp.where(win, tzk, btz)

    dist = jnp.sqrt(jnp.maximum(bd, 0.0))
    dist = jnp.where(hit, 0.0, dist)
    seg_point = jnp.stack([jnp.where(hit, pix, bsx),
                           jnp.where(hit, piy, bsy),
                           jnp.where(hit, piz, bsz)], axis=-1)
    tri_point = jnp.stack([jnp.where(hit, pix, btx),
                           jnp.where(hit, piy, bty),
                           jnp.where(hit, piz, btz)], axis=-1)
    return dist, seg_point, tri_point


def ray_triangle(origin, direction, v0, v1, v2):
    """Ray-triangle: (hit bool, t). reference: Game/CollisionQuery.swift:1575-1601."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) >= _EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv
    t = dot(e2, qvec) * inv
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return hit, t


def ray_aabb(origin, inv_dir, bmin, bmax):
    """Slab test: (tmin, tmax, hit). reference: Game/CollisionQuery.swift:1603-1631."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tsm = jnp.minimum(t0, t1)
    tbg = jnp.maximum(t0, t1)
    tmin = jnp.max(tsm, axis=-1)
    tmax = jnp.min(tbg, axis=-1)
    return tmin, tmax, tmax >= tmin


def triangle_normal(v0, v1, v2, eps=1e-12):
    n = cross(v1 - v0, v2 - v0)
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.maximum(ln, eps)


def aabb_overlap(amin, amax, bmin, bmax):
    return jnp.all((amax >= bmin) & (amin <= bmax), axis=-1)
