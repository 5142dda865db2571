"""Camera: RH look-at view + Metal-style perspective, large-world anchor.

reference: Game/Camera.swift:10-56 (fov 65 deg, near 0.1, far 100, view from
position/target/up) + the chunk/local world anchor used by the extractor for
camera-relative rendering (Components.swift:96-104).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from .. import math3d as m3


@dataclass
class Camera:
    fov_degrees: float = 65.0
    near_z: float = 0.1
    far_z: float = 100.0
    position: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 8.0], np.float32))
    target: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = field(default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    world_chunk: np.ndarray = field(default_factory=lambda: np.zeros(3, np.int64))
    world_local: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))

    def projection(self, width: float, height: float):
        aspect = max(width / max(height, 1.0), 1e-4)
        return m3.mat4_perspective_rh(m3.radians_from_degrees(self.fov_degrees),
                                      aspect, self.near_z, self.far_z)

    def view(self):
        return m3.mat4_look_at_rh(jnp.asarray(self.position, jnp.float32),
                                  jnp.asarray(self.target, jnp.float32),
                                  jnp.asarray(self.up, jnp.float32))

    def inv_view_proj(self, width: float, height: float):
        """inv(P @ V) = rigidInv(V) @ analyticInv(P) — exact in f32 (a
        numeric inverse cancels catastrophically at the far plane).

        Pure numpy: this runs on the HOST once per frame, so it issues no
        eager device ops."""
        aspect = max(width / max(height, 1.0), 1e-4)
        fov = np.float32(np.radians(self.fov_degrees))
        ys = np.float32(1.0) / np.tan(fov * np.float32(0.5))
        xs = ys / np.float32(aspect)
        zs = np.float32(self.far_z / (self.near_z - self.far_z))
        inv_p = np.zeros((4, 4), np.float32)
        inv_p[0, 0] = 1.0 / xs
        inv_p[1, 1] = 1.0 / ys
        inv_p[2, 3] = -1.0
        inv_p[3, 2] = 1.0 / (zs * np.float32(self.near_z))
        inv_p[3, 3] = 1.0 / np.float32(self.near_z)

        # numpy mirror of m3.mat4_look_at_rh + rigid inverse
        eye = np.asarray(self.position, np.float32)
        f = np.asarray(self.target, np.float32) - eye
        f = f / np.float32(np.linalg.norm(f) + 1e-20)
        up = np.asarray(self.up, np.float32)
        r = np.cross(f, up)
        r = r / np.float32(np.linalg.norm(r) + 1e-20)
        u = np.cross(r, f)
        rot = np.stack([r, u, -f])                  # view rotation rows
        # rigid inverse: [rot^T | eye]
        inv_v = np.eye(4, dtype=np.float32)
        inv_v[:3, :3] = rot.T
        inv_v[:3, 3] = eye
        return (inv_v @ inv_p).astype(np.float32)

    def view_proj(self, width: float, height: float) -> np.ndarray:
        """Forward P @ V in numpy — exact inverse pair of inv_view_proj."""
        aspect = max(width / max(height, 1.0), 1e-4)
        fov = np.float32(np.radians(self.fov_degrees))
        ys = np.float32(1.0) / np.tan(fov * np.float32(0.5))
        xs = ys / np.float32(aspect)
        zs = np.float32(self.far_z / (self.near_z - self.far_z))
        p = np.zeros((4, 4), np.float32)
        p[0, 0] = xs
        p[1, 1] = ys
        p[2, 2] = zs
        p[2, 3] = zs * np.float32(self.near_z)
        p[3, 2] = -1.0

        eye = np.asarray(self.position, np.float32)
        f = np.asarray(self.target, np.float32) - eye
        f = f / np.float32(np.linalg.norm(f) + 1e-20)
        up = np.asarray(self.up, np.float32)
        r = np.cross(f, up)
        r = r / np.float32(np.linalg.norm(r) + 1e-20)
        u = np.cross(r, f)
        rot = np.stack([r, u, -f])
        v = np.eye(4, dtype=np.float32)
        v[:3, :3] = rot
        v[:3, 3] = -rot @ eye
        return (p @ v).astype(np.float32)

    @property
    def world_position(self) -> np.ndarray:
        """f64 world-space camera position (chunk*512 + local)."""
        return self.world_chunk.astype(np.float64) * 512.0 + self.world_local


# Tile-major ray order: lane l covers pixel (px, py) of the TILE_H x TILE_W
# screen tile l // (TILE_H * TILE_W). One tile is 128 lanes — one program of
# the GPU traversal kernel — so a program's rays leave the camera through a
# compact 16x8-pixel patch and walk nearly the same nodes. 1920x1080 divides
# into whole tiles (no padding lanes).
TILE_H = 8
TILE_W = 16


def generate_rays_tiled(inv_view_proj, camera_position, width: int,
                        height: int, tile_h: int = TILE_H,
                        tile_w: int = TILE_W):
    """Primary rays in PADDED TILE-MAJOR lane order.

    Lane l covers pixel (px, py) of the (tile_h x tile_w) screen tile
    l // (tile_h*tile_w); pixels beyond the image (tile padding) get real
    rays through their (out-of-image) pixel centers and are cropped by the
    caller's final reshape (``untile_image``), so no permutation gathers
    exist anywhere in the frame.

    Returns (o (P,3), d (P,3), px (P,) int32, py (P,) int32) with
    P = ceil(W/tile_w) * ceil(H/tile_h) * tile_h * tile_w.
    """
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    n_tiles = tiles_x * tiles_y
    lane = jnp.arange(n_tiles * tile_h * tile_w, dtype=jnp.int32)
    per_tile = tile_h * tile_w
    tile = lane // per_tile
    within = lane % per_tile
    px = (tile % tiles_x) * tile_w + within % tile_w
    py = (tile // tiles_x) * tile_h + within // tile_w
    ndc_x = (px.astype(jnp.float32) + 0.5) / width * 2.0 - 1.0
    ndc_y = (1.0 - (py.astype(jnp.float32) + 0.5) / height) * 2.0 - 1.0
    clip = jnp.stack([ndc_x, ndc_y, jnp.ones_like(ndc_x),
                      jnp.ones_like(ndc_x)], axis=-1)
    world = clip @ jnp.asarray(inv_view_proj, jnp.float32).T
    p = world[..., :3] / world[..., 3:4]
    cam = jnp.asarray(camera_position, jnp.float32)
    d = m3.normalize(p - cam)
    o = jnp.broadcast_to(cam, d.shape)
    return o, d, px, py


def untile_image(flat, width: int, height: int, tile_h: int = TILE_H,
                 tile_w: int = TILE_W):
    """(P, C) tile-major lanes -> (H, W, C) image (reshape + transpose +
    crop — no gathers). Inverse of the generate_rays_tiled lane order."""
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    c = flat.shape[-1]
    img = flat.reshape(tiles_y, tiles_x, tile_h, tile_w, c)
    img = img.transpose(0, 2, 1, 3, 4).reshape(tiles_y * tile_h,
                                               tiles_x * tile_w, c)
    return img[:height, :width]
