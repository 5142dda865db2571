"""Refraction-path behavior tests (reference RayTracing.metalinc:544-713).

The transmission > 0 bounce: eta flip direction, TIR gate, Fresnel mix
bounds, and a see-through frame behavior test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swift_game_engine_tpu.render.shading import refract
from swift_game_engine_tpu.render.rt import refraction_setup

pytestmark = pytest.mark.fast


def test_refract_snell_direction():
    """Entering glass (eta = 1/1.5): Snell's law holds and the refracted
    vector is unit length (|T|^2 = eta^2 sin^2 + cos_t^2 = 1)."""
    n = jnp.array([[0.0, 1.0, 0.0]])
    theta_i = np.deg2rad(45.0)
    incident = jnp.array([[np.sin(theta_i), -np.cos(theta_i), 0.0]],
                         dtype=jnp.float32)
    eta = jnp.array([1.0 / 1.5])
    t = np.asarray(refract(incident, n, eta))[0]
    assert abs(np.linalg.norm(t) - 1.0) < 1e-5
    sin_t = np.hypot(t[0], t[2])
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, atol=1e-5)
    assert t[1] < 0  # continues into the medium


def test_refract_total_internal_reflection():
    """Exiting glass (eta = 1.5) past the ~41.8 deg critical angle returns
    the zero vector (Metal refract semantics; the kernel gates on |T|>0)."""
    n = jnp.array([[0.0, 1.0, 0.0]])
    theta_i = np.deg2rad(60.0)
    incident = jnp.array([[np.sin(theta_i), -np.cos(theta_i), 0.0]],
                         dtype=jnp.float32)
    t = np.asarray(refract(incident, n, jnp.array([1.5])))[0]
    np.testing.assert_allclose(t, 0.0, atol=0.0)


def test_eta_flip_direction():
    """refraction_setup (RayTracing.metalinc:546-556): a front-facing
    shading normal (cosi >= 0) means medium ENTRY -> eta = 1/ior; a
    back-facing one (cosi < 0, e.g. a normal-mapped normal pushed past
    grazing) means EXIT -> the normal flips and eta = ior."""
    ior = jnp.array([1.5, 1.5])
    d = jnp.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])  # rays downward
    n = jnp.array([[0.0, 1.0, 0.0],    # faces the viewer: entry
                   [0.0, -1.0, 0.0]])  # faces away: exit
    t_dir, t_len, eta = jax.jit(refraction_setup)(d, n, ior)
    eta = np.asarray(eta)
    np.testing.assert_allclose(eta[0], 1.0 / 1.5, atol=1e-6)
    np.testing.assert_allclose(eta[1], 1.5, atol=1e-6)
    # head-on rays refract straight through in both cases
    t_dir = np.asarray(t_dir)
    for k in range(2):
        np.testing.assert_allclose(t_dir[k] / np.linalg.norm(t_dir[k]),
                                   [0.0, -1.0, 0.0], atol=1e-5)
    assert np.asarray(t_len).min() > 0.9


def _pane_scene(transmission, ior=1.0, pane_alpha=1.0):
    """Camera -> transmissive pane -> bright green emissive wall."""
    from swift_game_engine_tpu.assets import procedural_meshes as pm
    from swift_game_engine_tpu.assets.materials import Material
    from swift_game_engine_tpu.render.scene_geometry import (
        RenderGeometryBuilder, flatten_frame)
    from swift_game_engine_tpu.render.camera import Camera

    b = RenderGeometryBuilder(texture_size=16)
    # single-sided pane (the refraction bounce is ONE layer deep —
    # RayTracing.metalinc:565 maxRefrLayers=1 — so a closed box would show
    # its own back face, not the wall behind)
    b.add_static_mesh(pm.plane(12.0), Material(
        name="pane", base_color_factor=(1.0, 1.0, 1.0), alpha=pane_alpha,
        roughness_factor=0.4, transmission_factor=transmission, ior=ior),
        instance=0)
    b.add_static_mesh(pm.box(6.0), Material(
        name="wall", base_color_factor=(0, 0, 0),
        emissive_factor=(0.1, 6.0, 0.1), unlit=True), instance=1)
    geo = b.build()
    tf = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    # rotate the XZ-plane pane to face the camera (+z normal)
    tf[0, :3, :3] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    tf[0, :3, 3] = [0.0, 0.0, 0.0]    # pane at origin
    tf[1, :3, 3] = [0.0, 0.0, -8.0]   # wall behind it
    fg = flatten_frame(geo, jnp.asarray(tf), jnp.zeros((1, 1, 4, 4)))
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 8.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    return geo, fg, cam


def _render_pane(transmission, ior=1.0, **kw):
    from swift_game_engine_tpu.render import rt as RT
    from swift_game_engine_tpu.render.ibl import IBL
    W, H = 32, 24
    geo, fg, cam = _pane_scene(transmission, ior=ior, **kw)
    lights = RT.DirectionalLights.default_sun()
    img = jax.jit(lambda: RT.render_frame(
        geo, fg, IBL.build(), lights, jnp.asarray(cam.inv_view_proj(W, H)),
        jnp.asarray(cam.position), W, H, max_layers=1, shadow_layers=1,
        enable_mirror=False, enable_refraction=True))()
    return np.asarray(img), (W, H)


def test_transmissive_pane_sees_through():
    """transmission=1 shows the emissive wall through the pane; the same
    pane with transmission=0 shows only its own (green-free) shade."""
    through, (W, H) = _render_pane(1.0)
    blocked, _ = _render_pane(0.0)
    assert np.isfinite(through).all() and np.isfinite(blocked).all()
    c_thr = through[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3]
    c_blk = blocked[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3]
    # green from the wall dominates through the pane, absent when blocked
    assert c_thr[..., 1].mean() > c_blk[..., 1].mean() + 1.0, (
        c_thr[..., 1].mean(), c_blk[..., 1].mean())


def test_fresnel_mix_bounds():
    """The blended output is old + (mix - old) * transmission with
    mix = trans*(1-Fs) + old*Fs, Fs in [0.04, 1] -> every channel lies in
    the convex hull of the surface's own shade and the transmitted color.
    With the wall emitting only green, the pane's red/blue channels can
    never exceed their blocked-pane values (plus dither)."""
    through, (W, H) = _render_pane(1.0)
    blocked, _ = _render_pane(0.0)
    c_thr = through[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3]
    c_blk = blocked[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3]
    eps = 0.15  # wall's 0.1 red/blue emissive floor + dither
    assert (c_thr[..., 0] <= c_blk[..., 0] + eps).all()
    assert (c_thr[..., 2] <= c_blk[..., 2] + eps).all()
