"""Texture bank: fixed-size array of all scene textures + bilinear sampling.

The reference binds up to 32 textures through a bindless slot array
(reference: Game/RTGeometryCache.swift:245-258, Game/RayTracing.metalinc:9).
Here, per-material texture objects become one (X, S, S, 4) float32 array:
every texture is resampled to S x S at load (sRGB decoded to linear, matching
Metal's sRGB sample semantics) and shaders gather bilinear taps by texture id.
Id -1 means "no texture" and samplers return the neutral value.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..assets.procedural_textures import Texture

MAX_RT_TEXTURES = 32  # parity budget with the reference's slot array


def srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


class TextureBank(NamedTuple):
    data: jnp.ndarray   # (X, S, S, 4) float32 linear
    size: int

    @property
    def count(self):
        return int(self.data.shape[0])


class TextureBankBuilder:
    def __init__(self, size: int = 512):
        self.size = size
        self._textures: list[np.ndarray] = []

    def add(self, tex: Optional[Texture]) -> int:
        """Returns texture id, or -1 for None."""
        if tex is None:
            return -1
        f = tex.pixels.astype(np.float32) / 255.0
        if f.shape[0] != self.size or f.shape[1] != self.size:
            # antialiased bilinear resample on the host
            f = np.asarray(jax.image.resize(
                f, (self.size, self.size, f.shape[2]), "bilinear",
                antialias=True))
            f = np.clip(np.round(f * 255.0), 0, 255) / 255.0
        if tex.srgb:
            f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
        self._textures.append(f)
        return len(self._textures) - 1

    def build(self) -> TextureBank:
        if not self._textures:
            data = np.ones((1, self.size, self.size, 4), np.float32)
        else:
            data = np.stack(self._textures)
        return TextureBank(data=jnp.asarray(data), size=self.size)


def sample_bilinear(bank: TextureBank, tex_id, uv, default):
    """Bilinear sample with clamp-to-edge addressing and a -1 fallback.

    tex_id: (...,) int32; uv: (...,2); default: (...,4) or (4,) neutral value.
    """
    s = bank.size
    tid = jnp.maximum(tex_id, 0)
    u = jnp.clip(uv[..., 0], 0.0, 1.0) * (s - 1)
    v = jnp.clip(uv[..., 1], 0.0, 1.0) * (s - 1)
    x0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, s - 2)
    y0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, s - 2)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    # Flat-index ROW gathers: 3-D integer indexing (d[tid, y0, x0]) lowers
    # to per-element multi-index gathers (~ms-scale per tap per image of
    # lanes); single-index row gathers of the flattened bank are ~100x
    # faster (see ibl.sample_brdf_lut).
    d = bank.data.reshape(-1, bank.data.shape[-1])
    base = (tid * s + y0) * s + x0
    v00 = d[base]
    v01 = d[base + 1]
    v10 = d[base + s]
    v11 = d[base + s + 1]
    out = (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy
    return jnp.where((tex_id >= 0)[..., None], out, default)
