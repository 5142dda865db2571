"""Ray-traced render path: the engine's equivalent of the reference's RT kernel.

Faithful restructuring of Game/RayTracing.metalinc:197-730 raytraceKernel as
batched array ops over all pixels:

  * up to 3 front-to-back transparency layers with alpha accumulation
  * per-hit PBR direct lighting (GGX) per directional light, with
    alpha-filtered shadow rays (<= 4 layers) for light 0
  * SH-L1 ambient x occlusion; split-sum specular IBL x occlusion
  * one deterministic mirror bounce for roughness <= 0.08 & metallic >= 0.8
    (bounce shading = direct + ambient + emissive, incl. its own shadows)
  * one refraction bounce for transmission > 0 with IOR eta flip and a
    Fresnel mix
  * 0.02/0.02/0.03 background + screen-space hash dither

Every ray query goes through one dispatch point, ``trace_closest``: the GPU
traversal kernel (ops.rt_kernel) on CUDA devices, the vmapped stackless
walk (render.bvh.traverse) on the CPU. Divergence control: every branch is a
lane mask; masked rays enter traversal inactive and exit at once.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import knob
from ..math3d import normalize
from ..ops.rt_kernel import trace_rays
from . import bvh as B
from .ibl import IBL, eval_env_sh, eval_spec_ibl
from .scene_geometry import (SceneGeometry, FrameGeometry,
                             texture_usage, TextureUsage)
from .shading import (eval_brdf, fresnel_schlick, fresnel_schlick3,
                      shadow_bias, hash12, apply_normal_map, reflect, refract)
from .textures import sample_bilinear

BG_COLOR = np.array([0.02, 0.02, 0.03], np.float32)
AMBIENT_INTENSITY = 0.25  # RayTracingRenderer.swift:82
BIG = np.float32(3.0e38)
# No-specialization fallback: sample every slot (used when callers pass
# usage=None, e.g. direct API use outside render_frame).
FULL_USAGE = TextureUsage(True, True, True, True, True, True)


class DirectionalLights(NamedTuple):
    """reference: Game/Lights.swift:10-28 / RTDirectionalLight."""

    direction: jnp.ndarray     # (L,3)
    intensity: jnp.ndarray     # (L,)
    color: jnp.ndarray         # (L,3)
    enabled: jnp.ndarray       # (L,) bool
    max_distance: jnp.ndarray  # (L,)

    @staticmethod
    def default_sun():
        """RayTracingRenderer.swift:163-168 fallback sun."""
        return DirectionalLights(
            direction=jnp.array([[-0.2, -1.0, -0.4]]),
            intensity=jnp.array([2.6]),
            color=jnp.array([[1.0, 0.95, 0.85]]),
            enabled=jnp.array([True]),
            max_distance=jnp.array([200.0]))

    @staticmethod
    def from_list(lights):
        if not lights:
            return DirectionalLights.default_sun()
        return DirectionalLights(
            direction=jnp.asarray([l["direction"] for l in lights], jnp.float32),
            intensity=jnp.asarray([l["intensity"] for l in lights], jnp.float32),
            color=jnp.asarray([l["color"] for l in lights], jnp.float32),
            enabled=jnp.asarray([l.get("enabled", True) for l in lights]),
            max_distance=jnp.asarray([l.get("max_distance", 200.0) for l in lights],
                                     jnp.float32))


# Honor Material.unlit in the RT path: unlit hits shade as albedo+emissive
# (the reference raster fragment shader's unlit branch,
# ShadersRaster.metalinc:73-75) and cast NO shadow rays. The reference's
# raytraceKernel does not consult unlit (RTInstanceInfo carries no such
# field) and runs full PBR on everything — but the scene's translucent
# collision-hull viz entities are authored unlit (DemoScene.swift:164,243),
# so honoring the material model is the intended look AND removes the
# dominant transparency-layer cost (hull layers need no GGX/shadow work).
# SGE_RT_UNLIT=0 restores the reference kernel's shade-everything behavior.
_UNLIT_FAST = bool(knob("SGE_RT_UNLIT"))
# Consolidated per-hit gathers: read uv corners + material id + unlit from
# the static (T,8) tri_shade row and the face normal from the per-frame
# (T,3) table instead of 7 separate vertex-indirection gathers.
_SROW = bool(knob("SGE_RT_SROW"))


# Chunked compaction: work that touches a small, scattered subset of lanes
# (texture taps, normal mapping, transparency layers 2+, mirror/refraction
# bounces) is gathered (live lanes in ascending order, so chunks stay
# spatially coherent) into fixed-size chunks processed until the set is
# drained — EXACT for any live count, while the common case (a few percent
# of lanes) costs one small chunk instead of a dense full-batch pass.
# Layer continuations can cover a large screen fraction (translucent
# hulls), so their cap is large to avoid loop iterations; tap sets are
# typically small, so their cap is small — fill lanes in an oversized chunk
# still pay dense elementwise shade cost.
_CHUNK = knob("SGE_RT_CHUNK")
_CHUNK_SMALL = knob("SGE_RT_CHUNK_SMALL")
# Bounce (mirror/refraction) chunk cap, separate from the tap cap: bounce
# chunk bodies carry a full trace + shade + shadow walk per iteration, so
# their per-iteration fixed cost is far higher than a tap chunk's.
_CHUNK_BOUNCE = knob("SGE_RT_CHUNK_BOUNCE")
# Sort-based compaction: _chunked's per-iteration nonzero scan + mask
# scatter is replaced by ONE stable sort of the mask upfront; chunk
# contents and order are identical (live lanes ascending).
_SORT_COMPACT = bool(knob("SGE_RT_SORT_COMPACT"))
# Compaction-schedule builder: "scan" = cumsum + drop-scatter (O(n), one
# prefix sum and one unique-index scatter), "sort" = stable argsort of the
# mask (O(n log n)). Both produce the SAME schedule — live lanes ascending
# — so chunk contents are identical; only the cost of building the
# permutation differs.
_COMPACT_ORDER = knob("SGE_RT_COMPACT_ORDER")


def _chunked(mask, body, carry, cap=None):
    """Run ``body(idx, valid, carry) -> carry`` over <=cap-lane chunks of
    the set lanes of ``mask`` until drained. ``idx`` is (cap,) int32 into
    the flat lane space with out-of-range fill (scatters at fill indices
    drop; gathers must clamp). Skips entirely when ``mask`` is empty."""
    p = mask.shape[0]
    cap = min(p, _CHUNK if cap is None else cap)
    if _SORT_COMPACT:
        return _chunked_sorted(mask, body, carry, cap)

    def cond(c):
        m, _ = c
        return jnp.any(m)

    def step(c):
        m, carry = c
        idx = jnp.nonzero(m, size=cap, fill_value=p)[0]
        valid = idx < p
        carry = body(idx, valid, carry)
        m = m.at[idx].set(False)
        return m, carry

    _, carry = jax.lax.while_loop(cond, step, (mask, carry))
    return carry


def _chunked_sorted(mask, body, carry, cap):
    """Same contract (and identical chunk contents) as ``_chunked``, but
    the chunk schedule comes from ONE stable sort — live lanes first in
    ascending lane order — instead of a full nonzero scan + mask scatter
    per iteration.

    The whole machinery (schedule build + loop) is cond-guarded on the
    live count: compaction sites whose set is empty this frame (bounce
    passes on hull-only records, taps on untextured chunks, ...) cost one
    mask reduction instead of an argsort + big-carry loop setup."""
    p = mask.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))

    def run(carry):
        if _COMPACT_ORDER == "scan":
            # cumsum + drop-scatter: live lane i lands at slot (#live < i).
            # Slots >= count stay 0 — never read live (idx is masked by
            # ``valid`` before use), so any in-range filler is fine.
            pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
            lane = jnp.arange(p, dtype=jnp.int32)
            order = jnp.zeros(p, jnp.int32).at[
                jnp.where(mask, pos, p)].set(lane, mode="drop")
        else:
            order = jnp.argsort(jnp.where(mask, 0, 1).astype(jnp.int8),
                                stable=True).astype(jnp.int32)
        # pad to a cap multiple so every chunk's dynamic_slice is exact
        # (a clamped slice would re-offer earlier lanes as later ones)
        pad = (-p) % cap
        if pad:
            order = jnp.concatenate([order, jnp.full(pad, p, jnp.int32)])
        return _chunked_sorted_loop(order, count, body, carry, cap, p)

    return jax.lax.cond(count > 0, run, lambda c: c, carry)


def _chunked_sorted_loop(order, count, body, carry, cap, p):

    def cond(c):
        i = c[0]
        return i * cap < count

    def step(c):
        i, carry = c
        idx = jax.lax.dynamic_slice(order, (i * cap,), (cap,))
        valid = (i * cap + jnp.arange(cap, dtype=jnp.int32)) < count
        idx = jnp.where(valid, idx, p)
        carry = body(idx, valid, carry)
        return i + 1, carry

    _, carry = jax.lax.while_loop(cond, step, (jnp.int32(0), carry))
    return carry


def _sparse_tap(textures, tex_ids, uv, default, active=None):
    """Bilinear texture taps only for lanes that bind a texture
    (tex_id >= 0), chunk-compacted; other lanes get ``default``. Each
    bilinear sample is 4 gathers per lane, so dense taps dominate shade
    cost when only a few lanes are textured. ``active``: optional lane
    mask — INACTIVE
    lanes never tap (dead records gather tri 0's material id, which may
    bind textures)."""
    p = tex_ids.shape[0]
    bound = tex_ids >= 0
    if active is not None:
        bound = bound & active
    out = jnp.broadcast_to(default, (p, 4))

    def body(idx, valid, out):
        safe = jnp.minimum(idx, p - 1)
        s = sample_bilinear(textures, tex_ids[safe], uv[safe], default)
        return out.at[idx].set(s)

    return _chunked(bound, body, out, cap=_CHUNK_SMALL)

def barycentrics(bvh, o, d, t, tri):
    """(u, v, found) of hit records (matches render.bvh.traverse)."""
    found = tri >= 0
    safe = jnp.maximum(tri, 0)
    a = bvh.v0[safe]
    b = bvh.v1[safe]
    c = bvh.v2[safe]
    p = o + d * t[..., None]
    ab = b - a
    ac = c - a
    ap = p - a
    d00 = jnp.sum(ab * ab, axis=-1)
    d01 = jnp.sum(ab * ac, axis=-1)
    d11 = jnp.sum(ac * ac, axis=-1)
    d20 = jnp.sum(ap * ab, axis=-1)
    d21 = jnp.sum(ap * ac, axis=-1)
    denom = jnp.maximum(d00 * d11 - d01 * d01, 1e-20)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return u, v, found


def trace_plain(bvh, o, d, t_max):
    """Closest hit per ray with the vmapped stackless walk (the plain
    reference). Returns (t, tri)."""
    def one(o_i, d_i, t_i):
        t, tri, _, _, _ = B.traverse(bvh, o_i, d_i, t_i)
        return t, tri
    return jax.vmap(one)(o, d, t_max)


def trace_closest(bvh, o, d, t_max):
    """THE dispatch point for ray queries: (o, d, t_max) -> (t, tri).

    Chosen when the program is lowered for its device: the traversal kernel
    on CUDA, the plain walk on the CPU; lowering for any other platform is
    an error. Lanes with ``t_max <= 0`` are inactive and exit at once."""
    def kernel(o, d, t_max):
        return trace_rays(bvh.rows, o, d, t_max)

    def plain(o, d, t_max):
        return trace_plain(bvh, o, d, t_max)

    return jax.lax.platform_dependent(o, d, t_max, cuda=kernel, cpu=plain)


@jax.jit
def _trace_batch(bvh, o, d, active):
    """Nearest-hit traversal over a ray batch; inactive lanes exit at once.
    Returns (t, tri, u, v, found) with t = BIG and tri = -1 on misses."""
    t, tri = trace_closest(bvh, o, d, jnp.where(active, BIG, 0.0))
    u, v, found = barycentrics(bvh, o, d, t, tri)
    found = found & active
    return jnp.where(found, t, BIG), jnp.where(found, tri, -1), u, v, found


def _interp(attr, tri_v, u, v):
    """Barycentric vertex-attribute interp: attr (V,C), tri_v (P,3)."""
    w = (1.0 - u - v)[..., None]
    return attr[tri_v[:, 0]] * w + attr[tri_v[:, 1]] * u[..., None] \
        + attr[tri_v[:, 2]] * v[..., None]


def _sample_material(geo: SceneGeometry, mid, uv, usage, unlit=None,
                     active=None):
    """PBR material sample per hit (RayTracing.metalinc:132-176).

    ``mid`` is the per-lane material id (callers read it from the
    tri_shade row — see SceneGeometry.tri_shade). ``usage`` (static
    TextureUsage) prunes texture taps for slots no scene material binds —
    each bilinear sample is 4 gathers per lane."""
    mats = geo.materials
    row = mats.packed[mid]                      # (P,16): ONE gather per hit
    base = row[..., 0:3]
    alpha = jnp.clip(row[..., 3], 0.0, 1.0)
    metallic = jnp.clip(row[..., 4], 0.0, 1.0)
    roughness = jnp.clip(row[..., 5], 0.05, 1.0)
    emissive = row[..., 6:9]
    occlusion = jnp.clip(row[..., 9], 0.0, 1.0)
    transmission = jnp.clip(row[..., 10], 0.0, 1.0)
    ior = jnp.maximum(row[..., 11], 1.0)
    normal_scale = row[..., 12]
    base_tex = row[..., 13].astype(jnp.int32)
    normal_tex = row[..., 14].astype(jnp.int32)
    mr_tex = row[..., 15].astype(jnp.int32)

    white = jnp.ones(4)

    # Sparse taps: only the lanes whose material binds the slot sample it
    # (chunk-compacted); typically a few percent of lanes are textured.
    if usage.base:
        base_t = _sparse_tap(geo.textures, base_tex, uv, white, active)
        base = base * base_t[..., :3]
        alpha = alpha * base_t[..., 3]
    if usage.mr:
        mr_t = _sparse_tap(geo.textures, mr_tex, uv, white, active)
        roughness = roughness * mr_t[..., 1]
        metallic = metallic * mr_t[..., 2]
    if usage.emissive:
        em_t = _sparse_tap(geo.textures, mats.emissive_tex[mid], uv, white,
                           active)
        emissive = emissive * em_t[..., :3]
    if usage.occlusion:
        oc_t = _sparse_tap(geo.textures, mats.occlusion_tex[mid], uv, white,
                           active)
        occlusion = occlusion * oc_t[..., 0]

    return dict(base=base, alpha=alpha, metallic=metallic, roughness=roughness,
                emissive=emissive, occlusion=occlusion,
                transmission=transmission, ior=ior,
                normal_tex=normal_tex,
                normal_scale=normal_scale, mid=mid,
                unlit=mats.unlit[mid] if unlit is None else unlit)

def _sample_alpha(geo: SceneGeometry, tri, u, v, usage, active=None):
    """Shadow-filter alpha (RayTracing.metalinc:178-195). When no bound
    base texture carries alpha < 1 the material factor alone is exact and
    the 4-tap texture gather is skipped (static specialization)."""
    mats = geo.materials
    if _SROW:
        srow = geo.tri_shade[jnp.maximum(tri, 0)]   # one gather: uvs + mid
        mid = srow[:, 6].astype(jnp.int32)
    else:
        mid = jnp.maximum(geo.tri_material[jnp.maximum(tri, 0)], 0)
    alpha = jnp.clip(mats.alpha[mid], 0.0, 1.0)
    if not (usage.base and usage.alpha_tex):
        return alpha
    if _SROW:
        w = (1.0 - u - v)[..., None]
        uv = srow[:, 0:2] * w + srow[:, 2:4] * u[..., None] \
            + srow[:, 4:6] * v[..., None]
    else:
        tri_v = geo.tri[jnp.maximum(tri, 0)]
        uv = _interp(geo.uv, tri_v, u, v)
    base_t = _sparse_tap(geo.textures, mats.base_tex[mid], uv, jnp.ones(4),
                         active)
    return alpha * base_t[..., 3]

def _shadow_factor(geo, fg: FrameGeometry, hit_pos, n, light_dir, max_dist,
                   bias, active, shadow_layers: int, usage=None):
    """Alpha-filtered shadow ray toward a directional light
    (RayTracing.metalinc:332-372): hits are walked nearest-first, each
    translucent layer multiplies by (1 - alpha), and the walk stops at
    shadow <= 0.02 or after ``shadow_layers`` layers."""
    l = normalize(-light_dir)
    if usage is None:
        usage = FULL_USAGE
    o0 = hit_pos + n * bias[..., None]

    def cond(carry):
        _, shadow, act, layer = carry
        return jnp.any(act & (shadow > 0.02)) & (layer < shadow_layers)

    def body(carry):
        o, shadow, act, layer = carry
        live = act & (shadow > 0.02)
        t, tri, u, v, found = _trace_batch(fg.bvh, o, jnp.broadcast_to(l, o.shape), live)
        found = found & (t < max_dist)
        a = _sample_alpha(geo, tri, u, v, usage)
        shadow = jnp.where(found, shadow * (1.0 - a), shadow)
        sh_pos = o + l * t[..., None]
        o = jnp.where(found[..., None], sh_pos + l * (bias * 2.0)[..., None], o)
        return o, shadow, live & found, layer + 1

    init = (o0, jnp.ones(hit_pos.shape[0]), active, jnp.int32(0))
    _, shadow, _, _ = jax.lax.while_loop(cond, body, init)
    return shadow


def _gbuffer(geo, fg: FrameGeometry, ray_o, ray_d, t_hit, tri, u, v,
             active, usage):
    """Geometry + material stage of the shade: per-record shading normal
    (incl. chunk-compacted normal mapping), hit position, shadow bias and
    the sampled material dict — NO lighting, NO shadow rays."""
    t_hit = jnp.where(active, t_hit, 1.0)
    safe_tri = jnp.maximum(tri, 0)
    if _SROW:
        # Two dense gathers per hit replace seven: the per-frame face normal
        # (fg.tri_nrm) and the static shade row (uv corners + material id +
        # unlit; SceneGeometry.tri_shade).
        srow = geo.tri_shade[safe_tri]
        n_geom = fg.tri_nrm[safe_tri]
        wbar = (1.0 - u - v)[..., None]
        uv = srow[:, 0:2] * wbar + srow[:, 2:4] * u[..., None] \
            + srow[:, 4:6] * v[..., None]
        mid = srow[:, 6].astype(jnp.int32)
        unlit = srow[:, 7] > 0.5
    else:
        tri_v = geo.tri[safe_tri]
        w0 = fg.pos[tri_v[:, 0]]
        w1 = fg.pos[tri_v[:, 1]]
        w2 = fg.pos[tri_v[:, 2]]
        n_geom = normalize(jnp.cross(w1 - w0, w2 - w0))
        uv = _interp(geo.uv, tri_v, u, v)
        mid = jnp.maximum(geo.tri_material[safe_tri], 0)
        unlit = None
    n_geom = jnp.where(jnp.sum(n_geom * ray_d, axis=-1, keepdims=True) > 0,
                       -n_geom, n_geom)
    view = normalize(-ray_d)
    m = _sample_material(geo, mid, uv, usage, unlit=unlit, active=active)

    # Tangent-space normal mapping (RayTracing.metalinc:283-316),
    # chunk-compacted to the lanes whose material binds a normal map — the
    # vertex-normal/tangent interpolation gathers and the 4-tap texture
    # sample only run for those lanes.
    if usage.normal:
        pshape = n_geom.shape[0]

        def nm_body(idx, valid, n_out):
            safe = jnp.minimum(idx, pshape - 1)
            tv = geo.tri[safe_tri[safe]]   # vertex gathers only on the chunk
            uc, vc = u[safe], v[safe]
            n_vert = normalize(_interp(fg.nrm, tv, uc, vc))
            tan4 = _interp(fg.tan, tv, uc, vc)
            tan = normalize(tan4[..., :3])
            n_tex = sample_bilinear(geo.textures, m["normal_tex"][safe],
                                    uv[safe],
                                    jnp.array([0.5, 0.5, 1.0, 1.0]))[..., :3]
            n_mapped = apply_normal_map(n_geom[safe], n_vert, tan,
                                        jnp.sign(tan4[..., 3]),
                                        n_tex, m["normal_scale"][safe],
                                        view[safe])
            n_mapped = jnp.where(
                jnp.sum(n_mapped * ray_d[safe], axis=-1, keepdims=True) > 0,
                -n_mapped, n_mapped)
            return n_out.at[idx].set(n_mapped)

        n = _chunked((m["normal_tex"] >= 0) & active, nm_body, n_geom,
                     cap=_CHUNK_SMALL)
    else:
        n = n_geom

    hit_pos = ray_o + ray_d * t_hit[..., None]
    bias = shadow_bias(t_hit)
    return m, n, hit_pos, bias


def _light_gate(lights: DirectionalLights, i: int, m, n, hit_pos, cam_pos,
                active):
    """Per-record gate for directional light i (the shade loop's gate
    condition, RayTracing.metalinc:320-330 + the unlit fast path) and its
    max shadow distance. Returns (gate, ndotl, max_dist, l)."""
    max_dist = jnp.where(lights.max_distance[i] > 0,
                         lights.max_distance[i], 1e6)
    l = normalize(-lights.direction[i])
    ndotl = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
    cam_dist = jnp.linalg.norm(hit_pos - cam_pos, axis=-1)
    # Unlit fast path (see _UNLIT_FAST): unlit lanes leave every light's
    # gate, so a chunk of pure-hull hits (transparency layers 2+) runs NO
    # shadow walk at all — its shadow rays enter inactive.
    lit = jnp.logical_not(m["unlit"]) if _UNLIT_FAST else \
        jnp.ones_like(active)
    gate = active & lit & lights.enabled[i] & (cam_dist <= max_dist) \
        & (ndotl > 0)
    return gate, ndotl, max_dist, l


def _light_records(ibl: IBL, lights: DirectionalLights, cam_pos, ray_d,
                   m, n, hit_pos, active, with_ibl_spec: bool,
                   shadow0=None, gates=None):
    """Lighting stage over pre-computed G-buffer records: GGX direct per
    light + SH ambient + split-sum IBL + unlit override — all elementwise.
    ``shadow0``: light-0 shadow factor per record (1 everywhere if None).
    ``gates``: optional per-light gate list (recomputed here if None)."""
    view = normalize(-ray_d)
    direct = jnp.zeros_like(hit_pos)
    for i in range(lights.direction.shape[0]):
        if gates is not None:
            gate, ndotl, _, l = gates[i]
        else:
            gate, ndotl, _, l = _light_gate(lights, i, m, n, hit_pos,
                                            cam_pos, active)
        if i == 0 and shadow0 is not None:
            shadow = shadow0
        else:
            shadow = jnp.ones_like(ndotl)
        brdf = eval_brdf(n, view, jnp.broadcast_to(l, n.shape),
                         m["base"], m["metallic"], m["roughness"])
        li = lights.color[i] * lights.intensity[i]
        direct = direct + jnp.where(gate[..., None],
                                    brdf * li * (ndotl * shadow)[..., None], 0.0)

    ambient = m["base"] * eval_env_sh(n, ibl.sh0, ibl.sh1) * AMBIENT_INTENSITY \
        * m["occlusion"][..., None]
    color = direct + ambient + m["emissive"]
    if with_ibl_spec:
        spec = eval_spec_ibl(n, view, m["roughness"], m["metallic"], m["base"],
                             ibl.brdf_lut)
        color = color + spec * m["occlusion"][..., None]
    if _UNLIT_FAST:
        # albedo + emissive, exactly the raster unlit branch
        # (ShadersRaster.metalinc:73-75).
        color = jnp.where(m["unlit"][..., None],
                          m["base"] + m["emissive"], color)
    return jnp.where(active[..., None], color, 0.0)

@partial(jax.jit, static_argnames=("with_ibl_spec", "shadow_layers", "usage"))
def _shade_hit(geo, fg: FrameGeometry, ibl: IBL, lights: DirectionalLights,
               cam_pos, ray_o, ray_d, t_hit, tri, u, v, active,
               with_ibl_spec: bool, shadow_layers: int, usage=None):
    """Shade one hit batch. Returns (color, m, n_shade, hit_pos, bias).

    Inactive/missed lanes are sanitized (t := 1) and their color forced to 0
    so downstream arithmetic can't propagate inf/NaN through `x * 0`.
    Composition of _gbuffer + the light-0 shadow walk + _light_records.
    """
    if usage is None:
        usage = FULL_USAGE
    m, n, hit_pos, bias = _gbuffer(geo, fg, ray_o, ray_d, t_hit, tri, u, v,
                                   active, usage)
    gates = [_light_gate(lights, i, m, n, hit_pos, cam_pos, active)
             for i in range(lights.direction.shape[0])]
    gate0, _, max_dist0, _ = gates[0]
    shadow0 = _shadow_factor(geo, fg, hit_pos, n, lights.direction[0],
                             max_dist0, bias, gate0, shadow_layers, usage)
    color = _light_records(ibl, lights, cam_pos, ray_d, m, n, hit_pos,
                           active, with_ibl_spec, shadow0=shadow0,
                           gates=gates)
    return color, m, n, hit_pos, bias


def render_frame(geo: SceneGeometry, fg: FrameGeometry, ibl: IBL,
                 lights: DirectionalLights, inv_view_proj, cam_pos,
                 width: int, height: int, max_layers: int = 3,
                 shadow_layers: int = 4, enable_mirror: bool = True,
                 enable_refraction: bool = True):
    """Full RT frame -> (H, W, 3) linear color (rgba16f-equivalent range).

    Rays are generated directly in tile-major lane order (see
    camera.generate_rays_tiled): consecutive lanes — one traversal
    program's rays — cover a compact screen patch, and the final image is
    one reshape+transpose+crop with no permutation gathers."""
    from .camera import generate_rays_tiled, untile_image
    ray_o, ray_d, pxl, pyl = generate_rays_tiled(inv_view_proj, cam_pos,
                                                 width, height)
    out = _render_rays(geo, fg, ibl, lights, cam_pos, ray_o, ray_d,
                       max_layers, shadow_layers, enable_mirror,
                       enable_refraction)
    # Per-pixel hash dither in lane order (identical per-pixel values to
    # the reference's screen-space hash), then one reshape to the image.
    noise = hash12(jnp.stack([pxl.astype(jnp.float32),
                              pyl.astype(jnp.float32)], axis=-1))
    dither = (noise - 0.5) * (1.0 / 255.0)
    out = jnp.maximum(out + dither[..., None], 0.0)
    return untile_image(out, width, height)


def _mirror_pass(geo, fg, ibl, lights, cam, d, n, hit_pos, bias, metallic,
                 base, mask, color, shadow_layers, usage):
    """One deterministic mirror bounce for the set lanes of ``mask``
    (RayTracing.metalinc:382-542), chunk-compacted. The color carry rides
    as channel-split 1-D arrays (1-D row scatters, no (p,3) carries)."""
    p = mask.shape[0]

    def body(idx, valid, carry):
        cr, cg, cb = carry
        safe = jnp.minimum(idx, p - 1)
        n_c = n[safe]
        d_c = d[safe]
        r_dir = normalize(reflect(d_c, n_c))
        r_o = jnp.where(valid[:, None],
                        hit_pos[safe] + n_c * bias[safe][..., None], 1.0e9)
        rt, rtri, ru, rv, rfound = _trace_batch(fg.bvh, r_o, r_dir, valid)
        r_color, r_m, _, _, _ = _shade_hit(
            geo, fg, ibl, lights, cam, r_o, r_dir, rt, rtri, ru, rv,
            rfound, False, shadow_layers, usage=usage)
        refl_alpha = jnp.where(rfound, r_m["alpha"], 0.0)
        refl = jnp.where(rfound[..., None], r_color * refl_alpha[..., None], 0.0) \
            + BG_COLOR * (1.0 - refl_alpha)[..., None]
        nov = jnp.clip(jnp.sum(n_c * normalize(-d_c), axis=-1), 0.0, 1.0)
        met = metallic[safe]
        f0 = 0.04 * (1.0 - met[..., None]) + base[safe] * met[..., None]
        f = fresnel_schlick3(nov, f0)
        old_c = jnp.stack([cr[safe], cg[safe], cb[safe]], axis=-1)
        new_c = old_c * (1.0 - f) + refl * f
        return (cr.at[idx].set(new_c[:, 0]), cg.at[idx].set(new_c[:, 1]),
                cb.at[idx].set(new_c[:, 2]))

    cr, cg, cb = _chunked(mask, body, (color[:, 0], color[:, 1], color[:, 2]),
                          cap=_CHUNK_BOUNCE)
    return jnp.stack([cr, cg, cb], axis=-1)


def refraction_setup(d, n, ior):
    """Dense refraction precompute (RayTracing.metalinc:546-556): Fresnel
    eta flip for rays hitting a back-facing shading normal (cosi < 0 ->
    medium exit, eta = ior), Snell refract, TIR gate via |T|. Returns
    (t_dir (unnormalized; zero on TIR), t_len, eta)."""
    view = normalize(-d)
    cosi = jnp.sum(n * view, axis=-1)
    flip = cosi < 0
    n_r = jnp.where(flip[..., None], -n, n)
    eta = jnp.where(flip, ior, 1.0 / ior)
    t_dir = refract(-view, n_r, eta)
    t_len = jnp.linalg.norm(t_dir, axis=-1)
    return t_dir, t_len, eta


def _refraction_pass(geo, fg, ibl, lights, cam, d, n, hit_pos, bias, base,
                     transmission, ior, found, color, shadow_layers, usage):
    """One refraction bounce with IOR eta flip + Fresnel mix for
    transmissive hits (RayTracing.metalinc:544-713), chunk-compacted. The
    refracted direction is computed densely (cheap vector math); only the
    bounce trace + shade are chunked."""
    p = found.shape[0]
    view = normalize(-d)
    t_dir, t_len, _eta = refraction_setup(d, n, ior)
    has_t = found & (transmission > 0.001) & (t_len > 0)

    def body(idx, valid, carry):
        cr, cg, cb = carry
        safe = jnp.minimum(idx, p - 1)
        t_dir_c = t_dir[safe]
        t_dir_n = t_dir_c / jnp.maximum(t_len[safe][..., None], 1e-20)
        t_o = jnp.where(valid[:, None],
                        hit_pos[safe] + t_dir_c * bias[safe][..., None], 1.0e9)
        ft, ftri, fu, fv, ffound = _trace_batch(fg.bvh, t_o, t_dir_n, valid)
        f_color, f_m, _, _, _ = _shade_hit(
            geo, fg, ibl, lights, cam, t_o, t_dir_n, ft, ftri, fu, fv,
            ffound, False, shadow_layers, usage=usage)
        refr_alpha = jnp.where(ffound, f_m["alpha"], 0.0)
        refr_bg = eval_env_sh(t_dir_n, ibl.sh0, ibl.sh1) * AMBIENT_INTENSITY
        refr = jnp.where(ffound[..., None], f_color * refr_alpha[..., None], 0.0) \
            + refr_bg * (1.0 - refr_alpha)[..., None]
        f_s = fresnel_schlick(jnp.clip(jnp.sum(n[safe] * view[safe], axis=-1),
                                       0.0, 1.0), jnp.float32(0.04))[..., None]
        trans_color = refr * base[safe]
        old_c = jnp.stack([cr[safe], cg[safe], cb[safe]], axis=-1)
        mix_color = trans_color * (1.0 - f_s) + old_c * f_s
        new_c = old_c + (mix_color - old_c) * transmission[safe][..., None]
        return (cr.at[idx].set(new_c[:, 0]), cg.at[idx].set(new_c[:, 1]),
                cb.at[idx].set(new_c[:, 2]))

    cr, cg, cb = _chunked(has_t, body, (color[:, 0], color[:, 1], color[:, 2]),
                          cap=_CHUNK_BOUNCE)
    return jnp.stack([cr, cg, cb], axis=-1)

def _render_rays(geo: SceneGeometry, fg: FrameGeometry, ibl: IBL,
                 lights: DirectionalLights, cam_pos, ray_o, ray_d,
                 max_layers: int = 3, shadow_layers: int = 4,
                 enable_mirror: bool = True, enable_refraction: bool = True):
    """Trace + shade a flat ray batch -> (P,3) colors (no dither/reshape).

    Layer 1 is a dense full-batch trace + shade (every pixel needs it);
    mirror/refraction bounces and transparency layers 2+ run chunk-compacted
    (see _chunked) so their cost scales with the lanes that need them.

    The shardable core: embarrassingly parallel over rays (parallel.sharding
    partitions this over the device mesh)."""
    p = ray_o.shape[0]
    cam = jnp.asarray(cam_pos, jnp.float32)
    usage = texture_usage(geo)  # static: geo is concrete at trace time
    d = ray_d

    def shade_layer(o_l, d_l, t, tri, u, v, found, alpha_in):
        """Shade one layer's hits incl. bounces -> (color, contrib, next_o)."""
        color, m, n, hit_pos, bias = _shade_hit(
            geo, fg, ibl, lights, cam, o_l, d_l, t, tri, u, v, found,
            True, shadow_layers, usage=usage)
        if enable_mirror:
            mirror = found & (m["roughness"] <= 0.08) & (m["metallic"] >= 0.8)
            color = _mirror_pass(geo, fg, ibl, lights, cam, d_l, n, hit_pos,
                                 bias, m["metallic"], m["base"], mirror,
                                 color, shadow_layers, usage)
        if enable_refraction:
            color = _refraction_pass(geo, fg, ibl, lights, cam, d_l, n,
                                     hit_pos, bias, m["base"],
                                     m["transmission"], m["ior"], found,
                                     color, shadow_layers, usage)
        contrib = jnp.where(found, m["alpha"] * (1.0 - alpha_in), 0.0)
        next_o = hit_pos + d_l * (bias * 2.0)[..., None]
        return color, contrib, next_o

    # ---- layer 1: dense over every ray.
    t, tri, u, v, found = _trace_batch(fg.bvh, ray_o, d, jnp.ones(p, bool))
    color, contrib, next_o = shade_layer(ray_o, d, t, tri, u, v, found,
                                         jnp.zeros(p))
    accum = color * contrib[..., None]
    accum_alpha = contrib
    o = jnp.where(found[..., None], next_o, ray_o)
    live = found

    # ---- layers 2..max_layers: chunk-compacted continuation re-traces.
    if max_layers > 1:
        def layer_cond(carry):
            _, live, _, accum_alpha, layer = carry
            return jnp.any(live & (accum_alpha < 0.99)) & (layer < max_layers)

        def layer_body(carry):
            o, live, accum, accum_alpha, layer = carry
            live = live & (accum_alpha < 0.99)

            def chunk(idx, valid, carry):
                o, live_next, accum, accum_alpha = carry
                safe = jnp.minimum(idx, p - 1)
                oc = o[safe]
                dc = d[safe]
                t, tri, u, v, found = _trace_batch(fg.bvh, oc, dc, valid)
                color, contrib, next_o = shade_layer(
                    oc, dc, t, tri, u, v, found, accum_alpha[safe])
                accum = accum.at[idx].add(color * contrib[..., None])
                accum_alpha = accum_alpha.at[idx].add(contrib)
                o = o.at[idx].set(jnp.where(found[:, None], next_o, o[safe]))
                live_next = live_next.at[idx].set(found & valid)
                return o, live_next, accum, accum_alpha

            o, live_next, accum, accum_alpha = _chunked(
                live, chunk, (o, jnp.zeros_like(live), accum, accum_alpha),
                cap=_CHUNK)
            return o, live_next, accum, accum_alpha, layer + 1

        o, live, accum, accum_alpha, _ = jax.lax.while_loop(
            layer_cond, layer_body, (o, live, accum, accum_alpha, jnp.int32(1)))

    return accum + BG_COLOR * (1.0 - accum_alpha)[..., None]
