"""GPU traversal kernel (ops.rt_kernel) vs the plain walk (bvh.traverse),
and the one dispatch point (rt.trace_closest).

On the CPU the kernel runs in the Pallas interpreter; the ``gpu`` cases run
the compiled Triton kernel and skip here."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swift_game_engine_tpu.render import bvh as B
from swift_game_engine_tpu.render import rt as RT
from swift_game_engine_tpu.render.bvh_native import build_bvh_sah
from swift_game_engine_tpu.ops.rt_kernel import RAYS_PER_PROGRAM, trace_rays


def _soup_bvh(n_tris, seed, spread=5.0, size=0.5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v = [c + rng.normal(0, size, (n_tris, 3)).astype(np.float32)
         for _ in range(3)]
    lo = np.minimum(np.minimum(v[0], v[1]), v[2])
    hi = np.maximum(np.maximum(v[0], v[1]), v[2])
    topo = build_bvh_sah(lo, hi, leaf_size=B.LEAF_SLOTS)
    return B.refit(topo, *map(jnp.asarray, v))


def _rays(n, seed, extent=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _check(bvh, o, d, t_max, interpret=True):
    o, d, t_max = map(jnp.asarray, (o, d, t_max))
    tk, trik = trace_rays(bvh.rows, o, d, t_max, interpret=interpret)
    tp, trip = RT.trace_plain(bvh, o, d, t_max)
    tk, trik, tp, trip = map(np.asarray, (tk, trik, tp, trip))
    assert trik.shape == trip.shape == (o.shape[0],)
    assert trik.dtype == np.int32
    same = trik == trip
    # shared edges can tie: a differing lane must hit at the same distance
    rel = np.abs(tk - tp) / np.maximum(np.abs(tp), 1e-6)
    assert (same | ((trik >= 0) & (trip >= 0) & (rel < 1e-4))).all()
    assert same.mean() >= 0.9999 or o.shape[0] < 10000
    hit = trip >= 0
    np.testing.assert_allclose(tk[hit], tp[hit], rtol=1e-5)
    np.testing.assert_array_equal(tk[~hit], np.asarray(t_max)[~hit])
    return trik, tk


@pytest.mark.parametrize("n_tris,n_rays,seed", [
    (600, 256, 0),      # sparse soup, two full programs
    (2000, 300, 1),     # denser soup, ragged last program
    (37, 1, 2),         # single leaf-heavy tree, single ray
])
def test_kernel_matches_plain_on_random_soup(n_tris, n_rays, seed):
    bvh = _soup_bvh(n_tris, seed)
    o, d = _rays(n_rays, seed + 10)
    tri, _ = _check(bvh, o, d, np.full(n_rays, B.BIG, np.float32))
    if n_rays > 100:
        assert (tri >= 0).sum() > 10   # the soup is actually hit


@pytest.mark.parametrize("n_rays", [1, RAYS_PER_PROGRAM - 1,
                                    RAYS_PER_PROGRAM + 1])
def test_kernel_pads_ragged_batches(n_rays):
    bvh = _soup_bvh(400, 5, spread=2.0)
    o, d = _rays(n_rays, 6, extent=3.0)
    _check(bvh, o, d, np.full(n_rays, B.BIG, np.float32))


def test_kernel_inactive_lanes_exit():
    bvh = _soup_bvh(500, 3, spread=2.0)
    o, d = _rays(200, 4, extent=1.0)     # origins inside the root box
    t_max = np.where(np.arange(200) % 3 == 0, 0.0, B.BIG).astype(np.float32)
    tri, t = _check(bvh, o, d, t_max)
    assert (tri[t_max == 0] == -1).all()
    assert (t[t_max == 0] == 0).all()
    assert (tri[t_max > 0] >= 0).sum() > 20


def test_kernel_t_max_clips_hits():
    bvh = _soup_bvh(800, 7, spread=3.0)
    o, d = _rays(256, 8, extent=1.0)
    tri_far, t_far = _check(bvh, o, d, np.full(256, B.BIG, np.float32))
    clip = np.float32(1.0)
    tri, t = _check(bvh, o, d, np.full(256, clip, np.float32))
    near = (tri_far >= 0) & (t_far < clip)
    np.testing.assert_array_equal(tri[near], tri_far[near])
    assert (tri[(tri_far >= 0) & (t_far >= clip)] == -1).all()
    assert near.any() and ((tri_far >= 0) & (t_far >= clip)).any()


@pytest.fixture(scope="module")
def demo_view():
    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    from swift_game_engine_tpu.render.scene_geometry import flatten_frame
    from swift_game_engine_tpu.render.camera import (Camera,
                                                     generate_rays_tiled)
    scene = DemoScene(include_imported_assets=False).build()
    transforms, palettes = scene["stepper"].extract(
        scene["state"], 0.0, np.zeros(3, np.float32))
    fg = flatten_frame(scene["geometry"], transforms, palettes)
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    w, h = 32, 16
    o, d, _, _ = generate_rays_tiled(jnp.asarray(cam.inv_view_proj(w, h)),
                                     jnp.asarray(cam.position), w, h)
    return fg.bvh, np.asarray(o), np.asarray(d)


def test_kernel_matches_plain_on_demo_primary_rays(demo_view):
    bvh, o, d = demo_view
    tri, _ = _check(bvh, o, d, np.full(o.shape[0], B.BIG, np.float32))
    assert (tri >= 0).mean() > 0.5


def test_dispatch_cpu_is_plain(demo_view):
    bvh, o, d = demo_view
    t_max = jnp.full(o.shape[0], B.BIG, jnp.float32)
    t, tri = jax.jit(lambda o, d, tm: RT.trace_closest(bvh, o, d, tm))(
        jnp.asarray(o), jnp.asarray(d), t_max)
    tp, trip = RT.trace_plain(bvh, jnp.asarray(o), jnp.asarray(d), t_max)
    np.testing.assert_array_equal(np.asarray(tri), np.asarray(trip))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(tp))


def _lowered_text(platform):
    bvh = _soup_bvh(50, 9)
    o, d = _rays(8, 9)
    f = jax.jit(lambda o, d, tm: RT.trace_closest(bvh, o, d, tm))
    return f.trace(jnp.asarray(o), jnp.asarray(d),
                   jnp.full(8, B.BIG, jnp.float32)).lower(
        lowering_platforms=(platform,)).as_text()


def test_dispatch_cuda_lowers_to_the_kernel():
    assert "triton" in _lowered_text("cuda")
    assert "triton" not in _lowered_text("cpu")


def test_dispatch_unknown_platform_is_an_error():
    with pytest.raises(Exception, match="(?i)platform"):
        _lowered_text("rocm")


@pytest.mark.gpu
def test_compiled_kernel_matches_plain():
    bvh = _soup_bvh(20000, 11, spread=20.0)
    o, d = _rays(1 << 16, 12, extent=25.0)
    _check(bvh, o, d, np.full(o.shape[0], B.BIG, np.float32),
           interpret=False)
