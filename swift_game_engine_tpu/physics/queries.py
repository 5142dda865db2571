"""Batched collision queries: capsule CCD cast, overlap, raycast.

Data-parallel reformulation of the reference's per-query BVH traversal + scalar
conservative advancement (reference: Game/CollisionQuery.swift:768-1394).

Two cast implementations:

``capsule_cast`` (default, used by the whole physics pipeline) computes the
exact time of impact *analytically* in one fused pass — zero sequential
iterations. The swept Y-axis capsule vs triangle problem decomposes into
closed-form feature events (endpoint-sphere vs face plane: linear;
core-line vs edge-line: linear since both directions are fixed;
endpoint-sphere vs vertex / edge, vertex vs core cylinder: quadratics).
The true TOI t* is always the *first* root of its achieving feature's
equation (feature distance >= capsule-triangle distance > r for t < t*),
so: generate every feature's first root, validate each candidate by
checking its contact point lies in the feature's Voronoi region (face
barycentric / edge parameter / vertex ownership checks — see
``_analytic_toi``), and take the min over valid candidates. This turns
the reference's <=256-iteration conservative-advancement loop
(CollisionQuery.swift:1285-1394) into one data-parallel program — the same
answer the reference's CA + 10-step bisection converges to, without the
sequential dependency chain a batched device program cannot hide.

``capsule_cast_ca`` keeps the lockstep conservative-advancement form whose
schedule mirrors the reference exactly (same advance rule, contact eps,
bisection refine); it is the parity oracle twin and the fallback.

Shared semantics (both paths):
  * contact normal = seg-tri closest-point axis, or the (dir-opposed)
    triangle normal when penetrating (:1331-1340)
  * blockingOnly rejects hits whose normal or triangle normal does not
    oppose the motion (:1087-1094); ground casts reject triangle normals
    below minNormalY (:1095-1097)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..math3d import cross
from .primitives import (segment_triangle_distance, ray_triangle, aabb_overlap)
from .collision_world import TriangleSoup

CONTACT_EPS = 1e-5
# Conservative-advancement iteration budget. The reference caps at 256 with
# min advance max(0.02 r, 1e-4) (CollisionQuery.swift:1295-1296); character
# sweeps move <= ~1.2 units/substep so ~40 iterations suffice even for
# grazing contacts — 48 keeps headroom while every iteration costs a fixed
# lockstep kernel launch.
DEFAULT_CA_ITERS = 48
REFINE_ITERS = 10
BIG = np.float32(3.0e38)


class CapsuleCastHit(NamedTuple):
    hit: jnp.ndarray           # () bool
    toi: jnp.ndarray           # ()
    normal: jnp.ndarray        # (3,)
    tri_normal: jnp.ndarray    # (3,)
    position: jnp.ndarray      # (3,) contact point on triangle
    tri_index: jnp.ndarray     # () int32
    mu_s: jnp.ndarray
    mu_k: jnp.ndarray
    flatten: jnp.ndarray       # () bool
    iterations: jnp.ndarray    # () int32 — path-dependent query stats:
    # analytic path = AABB-prefilter candidate count; CA path = iteration
    # count. Consumers treat it as the per-query work counter
    # (CollisionQueryStats analog), not specifically CA iterations.


class CapsuleOverlapHits(NamedTuple):
    """Top-K deepest overlaps (K static)."""

    depth: jnp.ndarray        # (K,) 0 where no hit
    normal: jnp.ndarray       # (K,3)
    tri_normal: jnp.ndarray   # (K,3)
    position: jnp.ndarray     # (K,3)
    tri_index: jnp.ndarray    # (K,) int32, -1 where no hit
    valid: jnp.ndarray        # (K,) bool
    candidates: jnp.ndarray   # () int32 — stats (CollisionQuery.swift:280-318)


class RaycastHit(NamedTuple):
    hit: jnp.ndarray
    distance: jnp.ndarray
    position: jnp.ndarray
    normal: jnp.ndarray
    tri_index: jnp.ndarray
    mu_s: jnp.ndarray
    mu_k: jnp.ndarray


def _layer_mask(soup: TriangleSoup, mask):
    return soup.valid & ((soup.layer & jnp.uint32(mask)) != 0)


def gather_candidates(soup: TriangleSoup, center, half_height, radius,
                      reach, cap: int):
    """Broadphase candidate lists: per-agent padded sub-soups.

    The reference bounds narrowphase work with a per-query BVH descent
    (CollisionQuery.swift:496-707, leaf <= 4); the batched analog is an
    AABB-vs-AABB prefilter gathered into FIXED-CAPACITY per-agent triangle
    lists, so every downstream cast/overlap runs over (N, cap) instead of
    (N, T).  Selection is nearest-first (squared centroid distance), so on
    overflow the dropped triangles are the farthest — graceful degradation;
    ``overflow`` reports agents whose candidate count exceeded ``cap``.

    Args:
      center (N,3): agent capsule centers.
      half_height, radius, reach (N,): capsule dims + conservative motion
        bound (travel + probes + skin) the caller guarantees per substep.
    Returns (sub_soup with leading axis N and row count cap, count (N,)).
    """
    tmin, tmax = soup.aabb                      # (T,3)
    ext = jnp.stack([radius + reach,
                     half_height + radius + reach,
                     radius + reach], axis=-1)  # (N,3)
    qmin = center - ext
    qmax = center + ext
    overlap = jnp.all((qmin[:, None, :] <= tmax[None]) &
                      (qmax[:, None, :] >= tmin[None]), axis=-1)
    overlap = overlap & soup.valid[None]        # (N,T)
    centroid = (soup.v0 + soup.v1 + soup.v2) * (1.0 / 3.0)
    d2 = jnp.sum((center[:, None, :] - centroid[None]) ** 2, axis=-1)
    key = jnp.where(overlap, -d2, -BIG)
    _, idx = jax.lax.top_k(key, cap)            # (N,cap) nearest-first
    keep = jnp.take_along_axis(overlap, idx, axis=1)

    def g(a):
        return a[idx]

    sub = TriangleSoup(
        v0=g(soup.v0), v1=g(soup.v1), v2=g(soup.v2), normal=g(soup.normal),
        mu_s=g(soup.mu_s), mu_k=g(soup.mu_k), flatten=g(soup.flatten),
        layer=g(soup.layer), valid=keep, tri_id=g(soup.tri_id))
    count = jnp.sum(overlap.astype(jnp.int32), axis=1)
    return sub, count


def _cast_prefilter(soup, from_pos, delta, radius, half_height, mask):
    """Swept-AABB prefilter (reference CollisionQuery.swift:1025-1065)."""
    length = jnp.linalg.norm(delta)
    nonzero = length >= 1e-6
    dir = delta / jnp.where(nonzero, length, 1.0)
    up = jnp.array([0.0, 1.0, 0.0]) * half_height
    ends = jnp.stack([from_pos + up, from_pos - up,
                      from_pos + up + delta, from_pos - up + delta])
    qmin = ends.min(axis=0) - radius
    qmax = ends.max(axis=0) + radius
    tmin, tmax = soup.aabb
    cand = _layer_mask(soup, mask) & aabb_overlap(qmin, qmax, tmin, tmax) & nonzero
    return length, dir, cand


def _cast_select(soup, from_pos, delta, dir, toi, contact, iters,
                 radius, half_height, blocking, min_normal_y):
    """Hit attributes at per-triangle TOI + best-hit argmin select.

    Shared tail of both cast implementations (reference
    CollisionQuery.swift:1087-1117, 1331-1340).
    """
    center = from_pos + dir * toi[..., None]
    dist, seg_p, tri_p = segment_triangle_distance(center, half_height,
                                                   soup.v0, soup.v1, soup.v2)
    # Column form for the normal/gate math ((T,3) elementwise ops waste
    # 125/128 lanes; see primitives.py section note).
    tnx, tny, tnz = soup.normal[:, 0], soup.normal[:, 1], soup.normal[:, 2]
    axx = seg_p[..., 0] - tri_p[..., 0]
    axy = seg_p[..., 1] - tri_p[..., 1]
    axz = seg_p[..., 2] - tri_p[..., 2]
    alen = jnp.maximum(jnp.sqrt(axx * axx + axy * axy + axz * axz), 1e-20)
    dirx, diry, dirz = dir[..., 0], dir[..., 1], dir[..., 2]
    tflip = jnp.where(tnx * dirx + tny * diry + tnz * dirz > 0, -1.0, 1.0)
    is_pen = dist < 1e-6
    nx = jnp.where(is_pen, tnx * tflip, axx / alen)
    ny = jnp.where(is_pen, tny * tflip, axy / alen)
    nz = jnp.where(is_pen, tnz * tflip, axz / alen)
    nflip = jnp.where(tnx * nx + tny * ny + tnz * nz < 0, -1.0, 1.0)
    tri_nx, tri_ny, tri_nz = tnx * nflip, tny * nflip, tnz * nflip

    ok = contact
    if blocking:
        dlx, dly, dlz = delta[..., 0], delta[..., 1], delta[..., 2]
        ok = ok & (dlx * nx + dly * ny + dlz * nz < 0) \
                & (dlx * tri_nx + dly * tri_ny + dlz * tri_nz < 0)
    if min_normal_y is not None:
        ok = ok & (tri_ny >= min_normal_y)

    toi_masked = jnp.where(ok, toi, BIG)
    # Best-hit select WITHOUT argmin+indexing: under the per-agent vmap
    # those lower to batched gathers. A first-minimum one-hot + masked reductions is pure
    # elementwise/reduce work; falls back to triangle 0 exactly like
    # argmin over an all-BIG vector.
    best_toi = jnp.min(toi_masked, axis=0)
    best_ok = best_toi < BIG
    is_best = toi_masked == best_toi
    sel = is_best & (jnp.cumsum(is_best.astype(jnp.int32), axis=0) == 1)
    sel = jnp.where(jnp.any(is_best),
                    sel, jnp.arange(toi.shape[0]) == 0)

    def pick(x):
        return jnp.sum(jnp.where(sel, x, 0), axis=0)

    def pick_vec(x, y, z):
        return jnp.stack([pick(x), pick(y), pick(z)], axis=-1)

    return CapsuleCastHit(
        hit=best_ok,
        toi=jnp.where(best_ok, pick(toi), BIG),
        normal=pick_vec(nx, ny, nz),
        tri_normal=pick_vec(tri_nx, tri_ny, tri_nz),
        position=pick_vec(tri_p[..., 0], tri_p[..., 1], tri_p[..., 2]),
        tri_index=jnp.where(best_ok, pick(soup.tri_id), -1),
        mu_s=pick(soup.mu_s),
        mu_k=pick(soup.mu_k),
        flatten=pick(soup.flatten.astype(jnp.int32)).astype(bool) & best_ok,
        iterations=iters,
    )


def _first_quad_root(A, B, C):
    """Smallest real root of A t^2 + B t + C = 0 (A >= 0), or +inf.

    Falls back to the linear root when A ~ 0. The smaller root is where a
    feature-pair distance first reaches the capsule radius.
    """
    lin = jnp.abs(A) < 1e-12
    disc = B * B - 4.0 * A * C
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(lin, 1.0, A)
    quad_root = (-B - sq) / (2.0 * a_safe)
    b_safe = jnp.where(jnp.abs(B) < 1e-12, 1.0, B)
    lin_root = -C / b_safe
    root = jnp.where(lin, jnp.where(jnp.abs(B) < 1e-12, BIG, lin_root), quad_root)
    return jnp.where(lin | (disc >= 0), root, BIG)


def _toward_root(c0, c1, r):
    """First t with |c0 + c1 t| = r for a linear feature distance, or +inf."""
    sgn = jnp.where(c0 >= 0, 1.0, -1.0)
    c1_safe = jnp.where(jnp.abs(c1) < 1e-12, 1.0, c1)
    t = (sgn * r - c0) / c1_safe
    return jnp.where(jnp.abs(c1) < 1e-12, BIG, t)


def _analytic_toi(soup: TriangleSoup, from_pos, dir, length, radius,
                  half_height, cand):
    """Exact per-triangle first-contact distance along ``dir``.

    Returns (contact (T,) bool, toi (T,)). Feature decomposition: each
    candidate root is validated by a *region check* — the event is accepted
    iff the feature pair consists of actual points of the capsule core
    segment and the triangle (feet within bounds). Then the pair distance
    equals the radius by construction, which proves capsule-triangle
    distance <= r at that time (soundness: no candidate earlier than the
    true TOI survives, because distance > r there means no realizable pair
    at distance r exists). At the true TOI the achieving closest pair is
    within bounds, so its event is accepted (completeness). The min
    surviving candidate is therefore the exact TOI.
    """
    up = jnp.array([0.0, 1.0, 0.0])
    e0 = from_pos + up * half_height      # (3,) core segment top
    e1 = from_pos - up * half_height      # bottom
    v = (soup.v0, soup.v1, soup.v2)       # each (T,3)
    edges = ((soup.v0, soup.v1), (soup.v1, soup.v2), (soup.v2, soup.v0))
    EPS_R = 1e-4  # relative region-check slack

    best = jnp.full(soup.valid.shape, BIG)

    def consider(t, valid):
        return jnp.minimum(
            jnp.where(valid & (t >= 0.0) & (t <= length), t, BIG), best)

    # --- Face events: endpoint-sphere vs triangle plane (linear). The
    # realized pair is (endpoint, its plane projection); valid when the
    # projection lies inside the triangle.
    n = soup.normal                                          # (T,3)
    ndot = jnp.sum(n * dir, axis=-1)                         # (T,)
    e10 = soup.v1 - soup.v0
    e21 = soup.v2 - soup.v1
    e02 = soup.v0 - soup.v2
    two_area = jnp.sum(cross(e10, -e02) * n, axis=-1)        # = 2*area (n unit)
    a_eps = EPS_R * jnp.abs(two_area)
    for e in (e0, e1):
        phi0 = jnp.sum(n * (e - v[0]), axis=-1)
        t = _toward_root(phi0, ndot, radius)
        p_at = e + dir * t[:, None]
        proj = p_at - n * jnp.sum(n * (p_at - v[0]), axis=-1)[:, None]
        c0 = jnp.sum(cross(e10, proj - soup.v0) * n, axis=-1)
        c1 = jnp.sum(cross(e21, proj - soup.v1) * n, axis=-1)
        c2 = jnp.sum(cross(e02, proj - soup.v2) * n, axis=-1)
        inside = (c0 >= -a_eps) & (c1 >= -a_eps) & (c2 >= -a_eps)
        best = consider(t, inside)

    # --- Core-line vs edge-line events (linear: both directions fixed;
    # the core direction is exactly +Y). Valid when both closest-point
    # feet land within their segments.
    for (p, q) in edges:
        ed = q - p
        el = jnp.linalg.norm(ed, axis=-1)
        e_n = ed / jnp.maximum(el, 1e-20)[:, None]
        # m = Y x e_n is the mutual-perpendicular axis.
        m = jnp.stack([e_n[:, 2], jnp.zeros_like(el), -e_n[:, 0]], axis=-1)
        mlen2 = jnp.sum(m * m, axis=-1)                      # = 1 - (Y.e)^2
        m_n = m / jnp.maximum(jnp.sqrt(mlen2), 1e-20)[:, None]
        c0 = jnp.sum((from_pos - p) * m_n, axis=-1)
        c1 = jnp.sum(dir * m_n, axis=-1)
        t = _toward_root(c0, c1, radius)
        # Closest params between the lines at time t.
        r0 = (from_pos + dir * t[:, None]) - p               # core center - p
        b = e_n[:, 1]                                        # Y . e_n
        cc = r0[:, 1]                                        # Y . r0
        f = jnp.sum(e_n * r0, axis=-1)
        denom = jnp.maximum(mlen2, 1e-12)
        u_core = (b * f - cc) / denom
        s_edge = (f - b * cc) / denom
        h_eps = EPS_R * jnp.maximum(half_height, radius)
        ok = (mlen2 > 1e-9) & \
             (u_core >= -half_height - h_eps) & (u_core <= half_height + h_eps) & \
             (s_edge >= -EPS_R * el) & (s_edge <= el * (1.0 + EPS_R))
        best = consider(t, ok)

    # --- Endpoint-sphere vs vertex events (quadratic, |dir| == 1 so
    # A = 1). The realized pair is (endpoint, vertex): always actual
    # points of both objects — no region check needed.
    for e in (e0, e1):
        for vv in v:
            u0 = e - vv
            B = 2.0 * jnp.sum(u0 * dir, axis=-1)
            C = jnp.sum(u0 * u0, axis=-1) - radius * radius
            best = consider(_first_quad_root(jnp.ones_like(B), B, C),
                            jnp.ones_like(B, bool))

    # --- Endpoint-sphere vs edge-line events (quadratic). Valid when the
    # foot lies within the edge segment.
    for e in (e0, e1):
        for (p, q) in edges:
            ed = q - p
            el = jnp.linalg.norm(ed, axis=-1)
            e_n = ed / jnp.maximum(el, 1e-20)[:, None]
            u0 = e - p
            dd = jnp.sum(dir * e_n, axis=-1)
            u0e = jnp.sum(u0 * e_n, axis=-1)
            A = 1.0 - dd * dd
            B = 2.0 * (jnp.sum(u0 * dir, axis=-1) - u0e * dd)
            C = jnp.sum(u0 * u0, axis=-1) - u0e * u0e - radius * radius
            t = _first_quad_root(A, B, C)
            s = u0e + dd * t
            ok = (el > 1e-9) & (s >= -EPS_R * el) & (s <= el * (1.0 + EPS_R))
            best = consider(t, ok)

    # --- Vertex vs core-cylinder events (quadratic in the XZ plane).
    # Valid when the vertex's Y lies within the core segment's Y span.
    dxz = dir * jnp.array([1.0, 0.0, 1.0])
    A_c = jnp.sum(dxz * dxz)
    h_eps = EPS_R * jnp.maximum(half_height, radius)
    for vv in v:
        w = (vv - from_pos) * jnp.array([1.0, 0.0, 1.0])
        B = -2.0 * jnp.sum(w * dxz, axis=-1)
        C = jnp.sum(w * w, axis=-1) - radius * radius
        t = _first_quad_root(jnp.broadcast_to(A_c, B.shape), B, C)
        u = vv[:, 1] - (from_pos[1] + dir[1] * t)
        ok = (u >= -half_height - h_eps) & (u <= half_height + h_eps)
        best = consider(t, ok)

    # Start-penetration: contact at t = 0 (reference contact eps).
    dist0, _, _ = segment_triangle_distance(from_pos, half_height,
                                            soup.v0, soup.v1, soup.v2)
    pen0 = cand & (dist0 <= radius + CONTACT_EPS)

    toi = jnp.where(cand, best, BIG)
    toi = jnp.where(pen0, 0.0, toi)
    contact = pen0 | (toi < BIG)
    return contact, jnp.where(contact, toi, BIG)


@partial(jax.jit, static_argnames=("blocking",))
def capsule_cast(soup: TriangleSoup, from_pos, delta, radius, half_height,
                 mask=np.uint32(0xFFFFFFFF), blocking=False,
                 min_normal_y=None) -> CapsuleCastHit:
    """Sweep a Y-axis capsule along ``delta`` against all triangles.

    Analytic TOI (see module docstring) — one fused data-parallel pass,
    no sequential advancement loop. ``min_normal_y``: None for plain /
    blocking casts, or a scalar for ground-filtered casts (traced; pass
    -2.0 to disable dynamically).
    """
    from_pos = jnp.asarray(from_pos, jnp.float32)
    delta = jnp.asarray(delta, jnp.float32)
    length, dir, cand = _cast_prefilter(soup, from_pos, delta, radius,
                                        half_height, mask)
    contact, toi = _analytic_toi(soup, from_pos, dir, length, radius,
                                 half_height, cand)
    toi = jnp.where(contact, toi, 0.0)
    return _cast_select(soup, from_pos, delta, dir, toi, contact,
                        jnp.sum(cand.astype(jnp.int32)),
                        radius, half_height, blocking, min_normal_y)


@partial(jax.jit, static_argnames=("max_iters", "blocking"))
def capsule_cast_ca(soup: TriangleSoup, from_pos, delta, radius, half_height,
                    mask=np.uint32(0xFFFFFFFF), blocking=False,
                    min_normal_y=None, max_iters: int = DEFAULT_CA_ITERS) -> CapsuleCastHit:
    """Conservative-advancement cast — schedule-parity twin of the
    reference (CollisionQuery.swift:1285-1394): advance step
    max(dist - radius, max(0.02 r, 1e-4)), contact at dist <= r + 1e-5,
    over-max-distance checked BEFORE the distance test, lastSafe advanced
    only on non-contact iterations, 10-step bisection refine that returns
    hi when the bracket is already < 1e-5 wide.
    """
    from_pos = jnp.asarray(from_pos, jnp.float32)
    delta = jnp.asarray(delta, jnp.float32)
    length, dir, cand = _cast_prefilter(soup, from_pos, delta, radius,
                                        half_height, mask)

    min_adv = jnp.maximum(radius * 0.02, 1e-4)

    # Conservative advancement, all candidate triangles in lockstep.
    # status: 0 advancing, 1 contact, 2 missed.
    t0 = jnp.zeros(soup.valid.shape, jnp.float32)
    status0 = jnp.where(cand, 0, 2)
    iters0 = jnp.zeros(soup.valid.shape, jnp.int32)

    # Early-exit while_loop: most casts resolve in a handful of iterations
    # (the advance step is dist - radius, so far triangles terminate fast);
    # the fixed budget is only the worst-case cap. Under the caller's vmap
    # the predicate lifts to an all-lanes any(), so the batch runs exactly
    # as long as its slowest lane needs.
    def cond(carry):
        _, _, status, _, i = carry
        return jnp.any(status == 0) & (i < max_iters)

    def body(carry):
        t, last_safe, status, iters, i = carry
        advancing = status == 0
        iters = iters + advancing.astype(jnp.int32)
        over = t > length
        center = from_pos + dir * t[..., None]
        dist, _, _ = segment_triangle_distance(center, half_height,
                                               soup.v0, soup.v1, soup.v2)
        contact = dist <= radius + CONTACT_EPS
        new_status = jnp.where(advancing,
                               jnp.where(over, 2, jnp.where(contact, 1, 0)),
                               status)
        still = new_status == 0
        adv = jnp.maximum(dist - radius, min_adv)
        last_safe = jnp.where(still, t, last_safe)
        t = jnp.where(still, t + adv, t)
        return t, last_safe, new_status, iters, i + 1

    t, last_safe, status, iters, _ = jax.lax.while_loop(
        cond, body, (t0, t0, status0, iters0, jnp.int32(0)))
    contact = status == 1

    # Bisection refine on contact lanes (CollisionQuery.swift:1361-1394).
    lo = jnp.minimum(jnp.clip(last_safe, 0.0, length), jnp.clip(t, 0.0, length))
    hi = jnp.maximum(jnp.clip(last_safe, 0.0, length), jnp.clip(t, 0.0, length))
    tiny = (hi - lo) < 1e-5

    # Refine only runs while some contact lane still has a wide bracket —
    # a cast with no contacts skips bisection entirely.
    def refine_cond(carry):
        lo, hi, i = carry
        return jnp.any(contact & ((hi - lo) >= 1e-5)) & (i < REFINE_ITERS)

    def refine(carry):
        lo, hi, i = carry
        mid = 0.5 * (lo + hi)
        center = from_pos + dir * mid[..., None]
        dist, _, _ = segment_triangle_distance(center, half_height,
                                               soup.v0, soup.v1, soup.v2)
        inside = dist <= radius
        return jnp.where(inside, lo, mid), jnp.where(inside, mid, hi), i + 1

    lo_r, hi_r, _ = jax.lax.while_loop(refine_cond, refine, (lo, hi, jnp.int32(0)))
    toi = jnp.where(tiny, hi, hi_r)
    return _cast_select(soup, from_pos, delta, dir, toi, contact,
                        jnp.sum(iters), radius, half_height, blocking,
                        min_normal_y)


@partial(jax.jit, static_argnames=("k",))
def capsule_overlap_all(soup: TriangleSoup, center, radius, half_height,
                        mask=np.uint32(0xFFFFFFFF), k: int = 8) -> CapsuleOverlapHits:
    """All penetrating triangles, deepest-K.

    The reference returns the first up-to-8 hits in traversal order and its
    caller sorts by depth (Systems.swift:759); returning the deepest K
    directly is a strict refinement of that selection.
    """
    center = jnp.asarray(center, jnp.float32)
    dist, seg_p, tri_p = segment_triangle_distance(center, half_height,
                                                   soup.v0, soup.v1, soup.v2)
    ok = _layer_mask(soup, mask) & (dist < radius)
    depth = jnp.where(ok, radius - dist, 0.0)

    tn = soup.normal
    axis = seg_p - tri_p
    axis_n = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True), 1e-20)
    normal = jnp.where((dist < 1e-6)[..., None], tn, axis_n)
    tri_n = jnp.where(jnp.sum(tn * normal, axis=-1, keepdims=True) < 0, -tn, tn)

    top_depth, top_idx = jax.lax.top_k(depth, k)
    valid = top_depth > 0
    return CapsuleOverlapHits(
        depth=top_depth,
        normal=normal[top_idx],
        tri_normal=tri_n[top_idx],
        position=tri_p[top_idx],
        tri_index=jnp.where(valid, soup.tri_id[top_idx], -1),
        valid=valid,
        candidates=jnp.sum(ok.astype(jnp.int32)),
    )


@jax.jit
def raycast(soup: TriangleSoup, origin, direction, max_distance,
            mask=np.uint32(0xFFFFFFFF)) -> RaycastHit:
    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    hit, t = ray_triangle(origin, direction, soup.v0, soup.v1, soup.v2)
    ok = hit & _layer_mask(soup, mask) & (t < max_distance)
    t_masked = jnp.where(ok, t, BIG)
    best = jnp.argmin(t_masked)
    best_ok = t_masked[best] < BIG
    tn = soup.normal[best]
    n = jnp.where(jnp.sum(tn * direction) > 0, -tn, tn)
    return RaycastHit(
        hit=best_ok,
        distance=jnp.where(best_ok, t[best], BIG),
        position=origin + direction * t[best],
        normal=n,
        tri_index=jnp.where(best_ok, soup.tri_id[best], -1),
        mu_s=soup.mu_s[best],
        mu_k=soup.mu_k[best],
    )
