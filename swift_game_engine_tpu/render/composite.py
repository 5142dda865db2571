"""Composite + UI overlay: RT output -> displayable frame with FPS digits.

reference: Game/Renderer.swift:260-290 (composite = fullscreen unlit quad
textured by the RT output, with per-material tone-map flags) +
Game/FPSOverlaySystem.swift:11-96 (EMA-smoothed FPS drawn as digit quads from
a procedural 5x7 atlas, top-right, ortho overlay) +
Game/RenderPasses.swift:79-154 (CompositePass clear-load, UIPass
load-preserve with alpha blending).

The composite tone map runs in the frame jit; the UI overlay has two forms:
``overlay_blit_device`` renders the digits INSIDE the fused frame program
(the reference's UIPass draws digit quads over the final target in-engine),
and ``FPSOverlay.blit`` remains as a host-side fallback for paths that
present raw numpy frames.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .shading import tone_map_aces, hash12
from ..assets import procedural_textures as pt


@jax.jit
def composite_frame(rt_output, exposure=1.0, tone_map_enabled=True):
    """Tone-map + dither the linear RT output (H, W, 3) -> display range.

    Matches the composite material's shading path: ACES on color * exposure,
    screen-space hash dither at half-pixel frequency
    (ShadersRaster.metalinc:93-99).
    """
    h, w = rt_output.shape[:2]
    tm = tone_map_aces(rt_output * jnp.maximum(exposure, 0.0))
    gx, gy = jnp.meshgrid(jnp.arange(w, dtype=jnp.float32),
                          jnp.arange(h, dtype=jnp.float32))
    noise = hash12(jnp.stack([gx, gy], axis=-1) * 0.5)
    out = tm + ((noise - 0.5) * (1.0 / 255.0))[..., None]
    return jnp.where(tone_map_enabled, out, rt_output)


def overlay_blit_device(u8_img, fps):
    """Device-side FPS digit overlay (UIPass analog) for the fused frame
    program: alpha-blend up to three digits top-right of a (H, W, 3) uint8
    image. ``fps`` is a traced int32; fps < 0 disables the overlay (the
    with_overlay=False path shares the same compiled program).

    Layout matches FPSOverlaySystem.update (margin from the top-right
    corner, digits left-to-right most-significant first); positions are
    traced scalars so 1-3 digit counts share one executable
    (FPSOverlaySystem.swift:11-96)."""
    atlas = np.asarray(pt.digits_atlas().pixels, np.float32)  # (12,80,4)
    cell_w, cell_h = pt.DIGITS_CELL_W, pt.DIGITS_CELL_H
    scale = int(FPSOverlay.SCALE)
    dw, dh = cell_w * scale, cell_h * scale
    sp = FPSOverlay.SPACING
    m = FPSOverlay.MARGIN
    h, w = u8_img.shape[:2]
    if h < m + dh or w < m + dw:
        return u8_img
    fps = jnp.clip(jnp.asarray(fps, jnp.int32), -1, 999)
    digits = [fps % 10, (fps // 10) % 10, fps // 100]
    show = [fps >= 0, fps >= 10, fps >= 100]
    n = 1 + (fps >= 10).astype(jnp.int32) + (fps >= 100).astype(jnp.int32)
    total = n * dw + (n - 1) * sp
    x_left = jnp.maximum(m, w - m - total)
    a_f = jnp.asarray(atlas)
    out = u8_img
    for k in range(3):  # k counts digits from the least-significant end
        xk = x_left + (n - 1 - k) * (dw + sp)
        cell = jax.lax.dynamic_slice(a_f, (0, digits[k] * cell_w, 0),
                                     (cell_h, cell_w, 4))
        cell = jnp.repeat(jnp.repeat(cell, scale, 0), scale, 1)  # NEAREST x2
        region = jax.lax.dynamic_slice(
            out, (m, xk, 0), (dh, dw, 3)).astype(jnp.float32)
        a = cell[..., 3:4] * (1.0 / 255.0)
        blended = cell[..., :3] * a + region * (1.0 - a)
        blended = jnp.where(show[k], blended, region).astype(jnp.uint8)
        out = jax.lax.dynamic_update_slice(out, blended, (m, xk, 0))
    return out


class FPSOverlay:
    """EMA-smoothed FPS counter (0.9/0.1) rendered from the digit atlas."""

    MARGIN = 12
    SPACING = 2
    SCALE = 2.0

    def __init__(self):
        self.fps_smoothed = 0.0
        atlas = pt.digits_atlas()
        self.cell_w = pt.DIGITS_CELL_W
        self.cell_h = pt.DIGITS_CELL_H
        self.atlas = atlas.pixels  # (12, 80, 4) uint8

    def update(self, dt: float) -> int:
        if dt <= 0:
            return int(round(self.fps_smoothed))
        inst = 1.0 / dt
        if self.fps_smoothed == 0:
            self.fps_smoothed = inst
        else:
            self.fps_smoothed = self.fps_smoothed * 0.9 + inst * 0.1
        return max(int(round(self.fps_smoothed)), 0)

    def blit(self, frame_u8: np.ndarray, fps_value: int) -> np.ndarray:
        """Alpha-blend the digits onto a (H, W, 3) uint8 frame, top-right.

        Digit layout per FPSOverlaySystem.update (Swift y-up ortho: margin
        from the top-right corner)."""
        h, w = frame_u8.shape[:2]
        digits = [int(c) for c in str(max(fps_value, 0))]
        dw = int(self.cell_w * self.SCALE)
        dh = int(self.cell_h * self.SCALE)
        total = len(digits) * dw + max(0, len(digits) - 1) * self.SPACING
        x = int(max(self.MARGIN, w - self.MARGIN - total))
        y = self.MARGIN  # distance from top edge
        out = frame_u8.copy()
        # nearest-neighbour upscale (pixel-centre sampling)
        rows = ((np.arange(dh) + 0.5) * self.cell_h / dh).astype(np.int64)
        cols = ((np.arange(dw) + 0.5) * self.cell_w / dw).astype(np.int64)
        for d in digits:
            cell = self.atlas[:, d * self.cell_w:(d + 1) * self.cell_w]
            img = cell[rows][:, cols]
            y0, y1 = y, min(y + dh, h)
            x0, x1 = x, min(x + dw, w)
            if y1 > y0 and x1 > x0:
                a = img[: y1 - y0, : x1 - x0, 3:4].astype(np.float32) / 255.0
                rgb = img[: y1 - y0, : x1 - x0, :3].astype(np.float32)
                dst = out[y0:y1, x0:x1].astype(np.float32)
                out[y0:y1, x0:x1] = (rgb * a + dst * (1 - a)).astype(np.uint8)
            x += dw + self.SPACING
        return out
