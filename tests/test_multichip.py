"""Multi-device sharding correctness.

Runs on the virtual 8-device CPU mesh that conftest.py provisions. Asserts
the image-plane-sharded render path (parallel.sharding.sharded_render)
produces the same image as a single-device render, and that the driver's
`dryrun_multichip` entry point succeeds in a fresh process (pinning the
env-setup fix: JAX_PLATFORMS=cpu + host device count forced before jax
import).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swift_game_engine_tpu.parallel.sharding import make_mesh, sharded_render
from swift_game_engine_tpu.render.ibl import IBL
from swift_game_engine_tpu.render.camera import Camera

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_scene():
    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    return DemoScene(include_imported_assets=False).build()


def _frame_inputs(tiny_scene, w, h):
    stepper = tiny_scene["stepper"]
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    ivp = cam.inv_view_proj(w, h)
    state = stepper.substep(tiny_scene["state"], 1.0 / 60.0)
    transforms, palettes = stepper.extract(state, 1.0, np.zeros(3, np.float32))
    return transforms, palettes, ivp, jnp.asarray(cam.position)


def test_sharded_render_matches_single_device(tiny_scene):
    assert len(jax.devices()) >= 8, "conftest must provision 8 CPU devices"
    w, h = 64, 32
    ibl = IBL.build()
    geo, lights = tiny_scene["geometry"], tiny_scene["lights"]
    transforms, palettes, ivp, cam_pos = _frame_inputs(tiny_scene, w, h)

    mesh8 = make_mesh(jax.devices()[:8])
    mesh1 = make_mesh(jax.devices()[:1])
    r8 = sharded_render(mesh8, geo, ibl, lights, w, h,
                        max_layers=2, shadow_layers=1)
    r1 = sharded_render(mesh1, geo, ibl, lights, w, h,
                        max_layers=2, shadow_layers=1)
    img8 = np.asarray(r8(transforms, palettes, ivp, cam_pos))
    img1 = np.asarray(r1(transforms, palettes, ivp, cam_pos))
    assert img8.shape == (h, w, 3)
    assert np.isfinite(img8).all()
    assert np.isfinite(img1).all()
    np.testing.assert_allclose(img8, img1, rtol=1e-5, atol=1e-5)
    # something was actually rendered (not all background)
    assert img8.std() > 1e-3


def test_sharded_output_is_sharded_input_consistent(tiny_scene):
    """Non-multiple-of-8 image width exercises the ray-padding path."""
    w, h = 60, 28
    ibl = IBL.build()
    geo, lights = tiny_scene["geometry"], tiny_scene["lights"]
    transforms, palettes, ivp, cam_pos = _frame_inputs(tiny_scene, w, h)
    mesh8 = make_mesh(jax.devices()[:8])
    img = np.asarray(sharded_render(mesh8, geo, ibl, lights, w, h,
                                    max_layers=1, shadow_layers=1)(
        transforms, palettes, ivp, cam_pos))
    assert img.shape == (h, w, 3)
    assert np.isfinite(img).all()


def test_pallas_kernel_under_shard_map(tiny_scene):
    """The GPU traversal kernel (Pallas interpreter on the CPU) inside
    jax.shard_map over 8 devices == the plain walk on one device."""
    from jax.sharding import PartitionSpec as P
    from swift_game_engine_tpu.ops.rt_kernel import trace_rays
    from swift_game_engine_tpu.render import rt as RT
    from swift_game_engine_tpu.render.camera import generate_rays_tiled
    from swift_game_engine_tpu.render.scene_geometry import flatten_frame

    w, h = 32, 16
    transforms, palettes, ivp, cam_pos = _frame_inputs(tiny_scene, w, h)
    fg = flatten_frame(tiny_scene["geometry"], transforms, palettes)
    o, d, _, _ = generate_rays_tiled(jnp.asarray(ivp), cam_pos, w, h)
    t_max = jnp.full(o.shape[0], 3.0e38, jnp.float32)
    mesh = make_mesh(jax.devices()[:8])
    rows = fg.bvh.rows

    def per_shard(rows, o, d, t_max):
        return trace_rays(rows, o, d, t_max, interpret=True)

    sharded = jax.jit(jax.shard_map(
        per_shard, mesh=mesh, in_specs=(P(), P("rays"), P("rays"), P("rays")),
        out_specs=(P("rays"), P("rays")), check_vma=False))
    t8, tri8 = sharded(rows, o, d, t_max)
    t1, tri1 = RT.trace_plain(fg.bvh, o, d, t_max)
    assert len(t8.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(tri8), np.asarray(tri1))
    hit = np.asarray(tri1) >= 0
    assert hit.mean() > 0.5
    np.testing.assert_allclose(np.asarray(t8)[hit], np.asarray(t1)[hit],
                               rtol=1e-5)


def test_dryrun_multichip_fresh_process():
    """Pin the driver-visible entry: must self-provision its CPU mesh."""
    code = ("import __graft_entry__ as g; g.dryrun_multichip(8)")
    env = dict(os.environ)
    # Simulate the driver's environment: no CPU forcing, no device count.
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"dryrun_multichip failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert "dryrun_multichip(8): fused substeps+extract+render OK" in proc.stdout


def test_entity_sharded_substep_matches_replicated():
    """SURVEY §5 entity axis: the physics substep on an
    entity-sharded WorldState must produce the same state as the
    replicated run — GSPMD partitioning cannot change the math."""
    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    from swift_game_engine_tpu.parallel.sharding import (make_mesh,
                                                         shard_world_state)
    scene = DemoScene(include_imported_assets=False,
                      pad_entities_to=8).build()
    stepper = scene["stepper"]
    mesh = make_mesh(jax.devices()[:8])

    @jax.jit
    def steps(st):
        for _ in range(4):
            st = stepper._substep_impl(st, jnp.float32(1.0 / 60.0))
        return st

    ref = steps(scene["state"])
    sharded = steps(shard_world_state(mesh, scene["state"]))
    for a, b, path in zip(jax.tree.leaves(ref), jax.tree.leaves(sharded),
                          jax.tree.flatten(ref)[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_fused_sharded_step_matches_unsharded():
    """The fused substeps+extract+render program (the shipped frame
    structure) sharded over the mesh == the unsharded computation."""
    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    from swift_game_engine_tpu.parallel.sharding import (
        make_mesh, shard_world_state, sharded_fused_step)
    from swift_game_engine_tpu.render.scene_geometry import flatten_frame
    from swift_game_engine_tpu.render import rt as RT

    scene = DemoScene(include_imported_assets=False,
                      pad_entities_to=8).build()
    stepper = scene["stepper"]
    ibl = IBL.build()
    w, h = 64, 32
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    ivp = jnp.asarray(cam.inv_view_proj(w, h))
    cpos = jnp.asarray(cam.position)

    mesh = make_mesh(jax.devices()[:8])
    step = sharded_fused_step(mesh, scene, ibl, w, h, n_substeps=2,
                              max_layers=1, shadow_layers=1)
    st2, img2 = step(shard_world_state(mesh, scene["state"]), ivp, cpos,
                     jnp.zeros(3))

    # unsharded reference of the same structure
    st_ref = scene["state"]
    for _ in range(2):
        st_ref = stepper.substep(st_ref, 1.0 / 60.0)
    transforms, palettes = stepper.extract(st_ref, 1.0,
                                           np.zeros(3, np.float32))
    geo = scene["geometry"]
    fg = flatten_frame(geo, transforms, palettes)
    img_ref = RT.render_frame(geo, fg, ibl, scene["lights"], ivp, cpos,
                              w, h, max_layers=1, shadow_layers=1)
    np.testing.assert_allclose(np.asarray(st2.body_pos),
                               np.asarray(st_ref.body_pos),
                               rtol=1e-5, atol=1e-5)
    a = np.asarray(img2)
    b = np.asarray(img_ref)
    # sharded path renders without the final dither; compare through the
    # same post-processing the unsharded frame applies? render_frame adds
    # dither — compare with generous tolerance on means and per-pixel.
    diff = np.abs(a - b).max()
    assert diff < 1.0 / 128.0, diff
