"""Raster render path: tile rasterizer visibility + the raster shading model.

The reference's raster path is a vertex/fragment pipeline (MVP transform +
normal-mapped hemispherical wrap diffuse, emissive, occlusion, unlit branch,
per-material ACES tone map + dither — reference:
Game/ShadersRaster.metalinc:38-101, Game/RenderPasses.swift:10-77).

Visibility comes from primary rays through the render BVH: the nearest
fragment per pixel, then up to ``max_layers`` continuation hits behind it,
reproducing the front-to-back alpha accumulation the reference gets from
fixed-function blending (reference: Game/PipelineBuilder.swift:37-45).
Shading is the raster fragment model, unchanged.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from ..math3d import normalize
from .rt import _trace_batch, _interp, _sample_material, BG_COLOR
from .scene_geometry import texture_usage
from .scene_geometry import SceneGeometry, FrameGeometry
from .shading import tone_map_aces, hash12, apply_normal_map
from .textures import sample_bilinear
from .camera import generate_rays_tiled, untile_image

# Fixed raster light direction (ShadersRaster.metalinc:89).
RASTER_L = (np.array([-0.2, 1.0, -0.4]) / np.linalg.norm([-0.2, 1.0, -0.4])).astype(np.float32)


def _raster_shade(geo: SceneGeometry, fg: FrameGeometry, o, d, t, tri, u, v,
                  active, usage):
    """Fragment shading per ShadersRaster.metalinc:56-101."""
    t = jnp.where(active, t, 1.0)
    safe_tri = jnp.maximum(tri, 0)
    tri_v = geo.tri[safe_tri]
    uv = _interp(geo.uv, tri_v, u, v)
    mid = jnp.maximum(geo.tri_material[safe_tri], 0)
    m = _sample_material(geo, mid, uv, usage)
    mats = geo.materials

    albedo = m["base"]
    alpha = m["alpha"]
    emissive = m["emissive"]
    if usage.occlusion:
        occ_t = sample_bilinear(geo.textures, mats.occlusion_tex[mid], uv,
                                jnp.ones(4))[..., 0]
        occlusion = 1.0 + (occ_t - 1.0) * jnp.clip(mats.occlusion_strength[mid],
                                                   0.0, 1.0)
    else:
        occlusion = jnp.ones_like(alpha)

    n_vert = normalize(_interp(fg.nrm, tri_v, u, v))
    view = normalize(-d)
    if usage.normal:
        tan4 = _interp(fg.tan, tri_v, u, v)
        tan = normalize(tan4[..., :3])
        n_tex = sample_bilinear(geo.textures, mats.normal_tex[mid], uv,
                                jnp.array([0.5, 0.5, 1.0, 1.0]))[..., :3]
        n = apply_normal_map(n_vert, n_vert, tan, jnp.sign(tan4[..., 3]),
                             n_tex, mats.normal_scale[mid], view)
    else:
        n = n_vert

    nl = jnp.clip(jnp.sum(n * RASTER_L, axis=-1), 0.0, 1.0) * 0.85 + 0.15
    lit = albedo * (nl * occlusion)[..., None] + emissive
    unlit = albedo + emissive
    color = jnp.where(mats.unlit[mid][..., None], unlit, lit)

    # Per-material ACES tone map + dither (ShadersRaster.metalinc:93-99).
    tm = tone_map_aces(color * jnp.maximum(mats.exposure[mid], 0.0)[..., None])
    color = jnp.where(mats.tone_mapped[mid][..., None], tm, color)

    color = jnp.where(active[..., None], color, 0.0)
    alpha = jnp.where(active, alpha, 0.0)
    hit_pos = o + d * t[..., None]
    return color, alpha, hit_pos


def render_frame_raster(geo: SceneGeometry, fg: FrameGeometry, inv_view_proj,
                        cam_pos, width: int, height: int, max_layers: int = 2,
                        background=BG_COLOR):
    """Raster-path frame -> (H, W, 3)."""
    usage = texture_usage(geo)
    ray_o, ray_d, _, _ = generate_rays_tiled(inv_view_proj, cam_pos, width,
                                             height)
    p = ray_o.shape[0]

    def layer_body(_, carry):
        o, live, accum, accum_alpha = carry
        live = live & (accum_alpha < 0.99)
        t, tri, u, v, found = _trace_batch(fg.bvh, o, ray_d, live)
        color, alpha, hit_pos = _raster_shade(geo, fg, o, ray_d, t, tri, u, v, found, usage)
        contrib = jnp.where(found, alpha * (1.0 - accum_alpha), 0.0)
        accum = accum + color * contrib[..., None]
        accum_alpha = accum_alpha + contrib
        bias = jnp.maximum(0.002, t * 0.002)
        o = jnp.where(found[..., None], hit_pos + ray_d * (bias * 2.0)[..., None], o)
        return o, live & found, accum, accum_alpha

    init = (ray_o, jnp.ones(p, bool), jnp.zeros((p, 3)), jnp.zeros(p))
    _, _, accum, accum_alpha = jax.lax.fori_loop(0, max_layers, layer_body, init)
    out = accum + jnp.asarray(background) * (1.0 - accum_alpha)[..., None]
    return untile_image(out, width, height)
