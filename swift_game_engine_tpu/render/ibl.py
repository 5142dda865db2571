"""Image-based lighting: SH ambient, prefiltered environment, BRDF LUT.

reference: Game/IBLResources.swift:11-175 (CPU-precomputed 128^3 mipped env
cube + 128^2 GGX BRDF LUT via 256-sample Hammersley integration) and
Game/RayTracingRenderer.swift:190-198 (hemisphere SH L0/L1 ambient).

Design notes: the reference's env cube is *generated from an analytic
hemisphere-gradient + roughness-widened-sun function* and then sampled with
trilinear mips; here `sample_env` evaluates that same analytic function
directly at the roughness-interpolated mip exponent — the continuous version
of the cube lookup (no 128^3 texture gathers on the hot path). The cube
faces and the BRDF LUT are still precomputed as arrays for parity/export.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

ENV_SIZE = 128
ENV_MIP_COUNT = 8  # 128 -> 1
LUT_SIZE = 128

_SKY = np.array([0.65, 0.72, 0.9], np.float32)
_GROUND = np.array([0.12, 0.12, 0.14], np.float32)
_SUN_DIR = (np.array([0.2, 0.9, 0.1]) / np.linalg.norm([0.2, 0.9, 0.1])).astype(np.float32)

# SH basis constants (RayTracing.metalinc:65-86).
_C0, _C1 = 0.282095, 0.488603


def hemisphere_sh():
    """Ambient SH L0/L1 from sky/ground hemisphere
    (RayTracingRenderer.swift:190-198). Returns (sh0 (3,), sh1 (3,))."""
    sky = jnp.array([0.7, 0.8, 1.0])
    ground = jnp.array([0.3, 0.25, 0.2])
    avg = (sky + ground) * 0.5
    diff = (sky - ground) * 0.5
    return avg / _C0, diff / _C1


def eval_env_sh(n, sh0, sh1):
    """L0 + y-linear L1 irradiance (only bands the reference populates)."""
    return sh0 * _C0 + sh1 * (_C1 * n[..., 1:2])


def sample_env(direction, roughness):
    """Analytic prefiltered environment (IBLResources.swift:106-121).

    ``roughness`` is mapped through the cube's mip parameterization:
    mip = roughness * (mipCount-1); roughness-at-mip = mip/(mipCount-1) —
    i.e. identity, so the analytic function is evaluated directly.
    """
    d = direction
    t = jnp.clip(d[..., 1] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    color = _GROUND + (_SKY - _GROUND) * t
    ndotl = jnp.maximum(jnp.sum(d * _SUN_DIR, axis=-1), 0.0)
    exponent = 800.0 + (30.0 - 800.0) * jnp.clip(roughness, 0.0, 1.0)
    sun = jnp.power(jnp.maximum(ndotl, 1e-6), exponent) * 4.0
    return jnp.clip(color + sun[..., None], 0.0, 1.0)


# ---------------------------------------------------------------------------
# BRDF LUT (host precompute, vectorized numpy)


def _radical_inverse_vdc(bits):
    x = bits.astype(np.uint32)
    x = (x << 16) | (x >> 16)
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return x.astype(np.float64) * 2.3283064365386963e-10


def integrate_brdf_lut(size: int = LUT_SIZE, samples: int = 256) -> np.ndarray:
    """GGX split-sum BRDF LUT, (size, size, 2): x=NoV, y=roughness.

    Same integrand as IBLResources.swift:123-175 (Smith k = a^2/2,
    Hammersley sequence), fully vectorized.
    """
    i = np.arange(samples)
    xi = np.stack([i / samples, _radical_inverse_vdc(i)], axis=-1)  # (S,2)

    nov = np.maximum(np.arange(size) / (size - 1), 0.001)           # (X,)
    rough = np.maximum(np.arange(size) / (size - 1), 0.001)         # (Y,)
    r = rough[:, None, None]
    a = r * r
    phi = 2.0 * np.pi * xi[None, None, :, 0]
    cos_t = np.sqrt((1.0 - xi[None, None, :, 1]) /
                    (1.0 + (a * a - 1.0) * xi[None, None, :, 1]))
    sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
    h = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t,
                  np.broadcast_to(cos_t, np.broadcast_shapes(cos_t.shape, phi.shape))],
                 axis=-1)                                            # (Y,1,S,3)

    nv = nov[None, :, None]
    v = np.stack([np.sqrt(np.maximum(1.0 - nv ** 2, 0.0)),
                  np.zeros_like(nv), nv], axis=-1)                   # (1,X,1,3)
    voh = np.maximum(np.sum(v * h, axis=-1), 0.0)                    # (Y,X,S)
    l = 2.0 * voh[..., None] * h - v
    nol = np.maximum(l[..., 2], 0.0)
    noh = np.maximum(h[..., 2], 0.0)

    k = (r[..., 0] ** 2) * 0.5                                       # (Y,1)
    g_v = nv[..., 0] / (nv[..., 0] * (1.0 - k) + k)                  # (Y,X)
    g_l = nol / (nol * (1.0 - k[..., None]) + k[..., None])          # (Y,X,S)
    g = g_v[..., None] * g_l
    g_vis = (g * voh) / np.maximum(noh * nv[..., 0][..., None], 1e-4)
    fc = (1.0 - voh) ** 5
    valid = nol > 0
    a_term = np.where(valid, (1.0 - fc) * g_vis, 0.0).mean(axis=-1)
    b_term = np.where(valid, fc * g_vis, 0.0).mean(axis=-1)
    return np.stack([a_term, b_term], axis=-1).astype(np.float32)    # (Y,X,2)


def sample_brdf_lut(lut, nov, roughness):
    """Bilinear LUT sample; lut (Y,X,2), coords clamped like GPU sampling."""
    size = lut.shape[0]
    x = jnp.clip(nov, 0.0, 1.0) * (size - 1)
    y = jnp.clip(roughness, 0.0, 1.0) * (size - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, size - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, size - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    # Flat-index ROW gathers: 2-D integer indexing (lut[y0, x0]) lowers to
    # a per-element gather; single-index row gathers of the flattened table
    # move whole rows.
    flat = lut.reshape(-1, lut.shape[-1])
    base = y0 * size + x0
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + size]
    v11 = flat[base + size + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def eval_spec_ibl(n, v, roughness, metallic, base, lut):
    """Split-sum specular IBL (RayTracing.metalinc:88-104): analytic
    prefiltered env along the reflection vector x BRDF LUT."""
    nov = jnp.clip(jnp.sum(n * v, axis=-1), 0.0, 1.0)
    r = 2.0 * jnp.sum(n * v, axis=-1, keepdims=True) * n - v
    prefiltered = sample_env(r, roughness)
    brdf = sample_brdf_lut(lut, nov, roughness)
    f0 = 0.04 * (1.0 - metallic[..., None]) + base * metallic[..., None]
    return prefiltered * (f0 * brdf[..., 0:1] + brdf[..., 1:2])


# ---------------------------------------------------------------------------
# Env cube faces (parity export; not on the hot path)


def _cube_direction(face, u, v):
    """IBLResources.swift:93-104 face conventions."""
    if face == 0:
        d = np.stack([np.ones_like(u), -v, -u], axis=-1)
    elif face == 1:
        d = np.stack([-np.ones_like(u), -v, u], axis=-1)
    elif face == 2:
        d = np.stack([u, np.ones_like(u), v], axis=-1)
    elif face == 3:
        d = np.stack([u, -np.ones_like(u), -v], axis=-1)
    elif face == 4:
        d = np.stack([u, -v, np.ones_like(u)], axis=-1)
    else:
        d = np.stack([-u, -v, -np.ones_like(u)], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def make_env_cube(size: int = ENV_SIZE):
    """All mips x 6 faces of the analytic environment, as float32 arrays."""
    mips = []
    mip_count = int(np.log2(size)) + 1
    for mip in range(mip_count):
        s = max(size >> mip, 1)
        roughness = mip / (mip_count - 1) if mip_count > 1 else 0.0
        xs = (2.0 * (np.arange(s) + 0.5) / s) - 1.0
        u, v = np.meshgrid(xs, xs)  # v rows, u cols
        faces = []
        for face in range(6):
            d = _cube_direction(face, u, v)
            c = np.asarray(sample_env(jnp.asarray(d, jnp.float32), roughness))
            faces.append(c)
        mips.append(np.stack(faces))
    return mips


class IBL(NamedTuple):
    sh0: jnp.ndarray
    sh1: jnp.ndarray
    brdf_lut: jnp.ndarray
    env_mip_count: int

    @staticmethod
    def build():
        sh0, sh1 = hemisphere_sh()
        return IBL(sh0=sh0, sh1=sh1,
                   brdf_lut=jnp.asarray(integrate_brdf_lut()),
                   env_mip_count=ENV_MIP_COUNT)
