"""Unit tests: skinning, locomotion FSM, chunk math, render graph, IBL,
input system, composite/overlay."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swift_game_engine_tpu.anim.skinning import skin_vertices, skin_matrices
from swift_game_engine_tpu.anim.locomotion import LocomotionTuning, locomotion_fsm_step
from swift_game_engine_tpu.anim.pose import LocoState, ProfileBank, IDLE, WALK, RUN, FALLING
from swift_game_engine_tpu.ecs import world as W
from swift_game_engine_tpu.render.graph import RenderGraph, RenderPass
from swift_game_engine_tpu.render import ibl as IBL
from swift_game_engine_tpu.render.composite import FPSOverlay
from swift_game_engine_tpu.render.shading import tone_map_aces
from swift_game_engine_tpu.scene.input import InputSystem, InputFrame

pytestmark = pytest.mark.fast


# --- skinning ---

def test_skinning_identity():
    v = np.random.default_rng(0).standard_normal((10, 3)).astype(np.float32)
    w = np.zeros((10, 4), np.float32)
    w[:, 0] = 1.0
    dense = np.zeros((10, 2), np.float32)
    dense[:, 0] = 1.0
    palette = jnp.tile(jnp.eye(4), (2, 1, 1))
    out = skin_vertices(jnp.asarray(dense), palette, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(out["positions"]), v, atol=1e-6)


def test_skinning_blend_translation():
    v = np.zeros((1, 3), np.float32)
    dense = np.array([[0.25, 0.75]], np.float32)
    p0 = np.eye(4, dtype=np.float32)
    p1 = np.eye(4, dtype=np.float32)
    p1[:3, 3] = [4, 0, 0]
    palette = jnp.asarray(np.stack([p0, p1]))
    out = skin_vertices(jnp.asarray(dense), palette, jnp.asarray(v))
    np.testing.assert_allclose(np.asarray(out["positions"])[0], [3, 0, 0], atol=1e-6)


def test_skinned_normals_unit():
    rng = np.random.default_rng(1)
    n = rng.standard_normal((5, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    dense = np.array([[0.5, 0.5]] * 5, np.float32)
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = 2.0 * np.eye(3)  # scaled palette: normals must renormalize
    palette = jnp.asarray(np.stack([rot, np.eye(4, dtype=np.float32)]))
    out = skin_vertices(dense, palette, jnp.zeros((5, 3)), normals=jnp.asarray(n))
    np.testing.assert_allclose(np.linalg.norm(np.asarray(out["normals"]), axis=1),
                               1.0, atol=1e-5)


# --- locomotion FSM ---

def mk_bank():
    return ProfileBank(coeffs=jnp.zeros((4, 1, 6, 9)),
                       has_channel=jnp.zeros((4, 1, 6), bool),
                       cycles=jnp.array([1.0, 0.8, 0.6, 1.2]))


def fsm(state, speed, grounded_near=True, drop=0.0):
    tune = LocomotionTuning.default(())
    vel = jnp.array([speed, 0.0, 0.0])
    return locomotion_fsm_step(state, mk_bank(), tune, vel,
                               jnp.asarray(grounded_near), jnp.asarray(drop))


def test_fsm_idle_to_walk_to_run():
    st = LocoState.initial()
    st2 = fsm(st, 1.0)
    assert int(st2.state) == WALK and bool(st2.is_blending)
    assert float(st2.blend_t) == 0.0
    st3 = fsm(st2._replace(is_blending=jnp.asarray(False)), 7.0)
    assert int(st3.state) == RUN
    # hysteresis: 5.5 is between runExit(5) and runEnter(6): stays run
    st4 = fsm(st3._replace(is_blending=jnp.asarray(False)), 5.5)
    assert int(st4.state) == RUN
    st5 = fsm(st4._replace(is_blending=jnp.asarray(False)), 4.0)
    assert int(st5.state) == WALK


def test_fsm_idle_inertia_armed():
    st = LocoState.initial()._replace(state=jnp.int32(WALK))
    st2 = fsm(st, 0.05)
    assert int(st2.state) == IDLE
    assert float(st2.idle_inertia) == 1.0


def test_fsm_falling_requires_drop():
    st = LocoState.initial()._replace(state=jnp.int32(WALK))
    st2 = fsm(st, 3.0, grounded_near=False, drop=2.0)
    assert int(st2.state) == WALK  # airborne but not high enough
    st3 = fsm(st, 3.0, grounded_near=False, drop=50.0)
    assert int(st3.state) == FALLING
    # once falling, stays falling while airborne regardless of drop
    st4 = fsm(st3._replace(is_blending=jnp.asarray(False)), 3.0,
              grounded_near=False, drop=1.0)
    assert int(st4.state) == FALLING
    # landing: falling -> grounded FSM treats current as idle
    st5 = fsm(st4._replace(is_blending=jnp.asarray(False)), 0.0,
              grounded_near=True)
    assert int(st5.state) == IDLE


def test_fsm_phase_alignment():
    st = LocoState.initial()._replace(
        state=jnp.int32(WALK), times=jnp.array([0.0, 0.4, 0.0, 0.0]))
    st2 = fsm(st, 7.0)  # walk (cycle .8, phase .5) -> run (cycle .6)
    assert int(st2.state) == RUN
    assert float(st2.times[RUN]) == pytest.approx(0.5 * 0.6, abs=1e-5)


# --- chunk math ---

def test_chunk_roundtrip():
    w = jnp.array([[1000.0, -3.0, 255.9], [-257.0, 0.0, 0.0]])
    c, l = W.world_to_chunk_local(w)
    np.testing.assert_allclose(np.asarray(W.chunk_local_to_world(c, l)),
                               np.asarray(w), atol=1e-3)
    assert (np.abs(np.asarray(l)) <= 256.0 + 1e-3).all()
    c2, l2 = W.canonicalize(c, l + 512.0)
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(c) + 1)
    np.testing.assert_allclose(np.asarray(l2), np.asarray(l), atol=1e-3)


# --- render graph ---

def test_render_graph_prune_sort_cycle():
    order = []

    def mk(name, out=None):
        def run(res):
            order.append(name)
            return {out: name} if out else {}
        return run

    g = RenderGraph()
    g.add_pass(RenderPass("dead", mk("dead", "unused"), writes=("unused",)))
    g.add_pass(RenderPass("composite", mk("composite", "view"),
                          reads=("rt_out",), target="view"))
    g.add_pass(RenderPass("rt", mk("rt", "rt_out"), writes=("rt_out",)))
    res = g.execute({})
    assert order == ["rt", "composite"]  # dead pruned, deps sorted
    assert res["view"] == "composite"

    g2 = RenderGraph()
    g2.add_pass(RenderPass("a", mk("a", "x"), reads=("y",), writes=("x",)))
    g2.add_pass(RenderPass("b", mk("b", "y"), reads=("x",), target="view",
                           writes=("y",)))
    with pytest.raises(RuntimeError, match="cycle"):
        g2.execute({})


# --- IBL ---

def test_ibl_sh_and_lut():
    sh0, sh1 = IBL.hemisphere_sh()
    up = IBL.eval_env_sh(jnp.array([0.0, 1.0, 0.0]), sh0, sh1)
    down = IBL.eval_env_sh(jnp.array([0.0, -1.0, 0.0]), sh0, sh1)
    np.testing.assert_allclose(np.asarray(up), [0.7, 0.8, 1.0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(down), [0.3, 0.25, 0.2], atol=1e-5)

    lut = IBL.integrate_brdf_lut(32, 64)
    assert lut.shape == (32, 32, 2)
    assert np.isfinite(lut).all()
    assert (lut >= 0).all() and (lut[..., 0] <= 1.5).all()

    env_sharp = np.asarray(IBL.sample_env(jnp.array([0.2, 0.9, 0.1]) / np.linalg.norm([0.2, 0.9, 0.1]), 0.0))
    env_rough = np.asarray(IBL.sample_env(jnp.array([0.2, 0.9, 0.1]) / np.linalg.norm([0.2, 0.9, 0.1]), 1.0))
    assert env_sharp.max() == pytest.approx(1.0)  # clamped sun


def test_env_cube_faces():
    mips = IBL.make_env_cube(16)
    assert len(mips) == 5
    assert mips[0].shape == (6, 16, 16, 3)
    assert mips[-1].shape == (6, 1, 1, 3)


# --- input ---

def test_input_deadzone_and_speeds():
    inp = InputSystem()
    out = inp.update(InputFrame(ly=0.05), 1 / 60, False, 4.5, 12.5, 0.78)
    np.testing.assert_allclose(out["desired_velocity"], 0.0)
    out = inp.update(InputFrame(ly=0.5), 1 / 60, False, 4.5, 12.5, 0.78)
    assert np.linalg.norm(out["desired_velocity"]) == pytest.approx(4.5, abs=1e-3)
    out = inp.update(InputFrame(ly=1.0), 1 / 60, False, 4.5, 12.5, 0.78)
    assert np.linalg.norm(out["desired_velocity"]) == pytest.approx(12.5, abs=1e-3)


def test_input_jump_edge():
    inp = InputSystem()
    out1 = inp.update(InputFrame(jump=True), 1 / 60, False, 4.5, 12.5, 0.78)
    out2 = inp.update(InputFrame(jump=True), 1 / 60, False, 4.5, 12.5, 0.78)
    out3 = inp.update(InputFrame(jump=False), 1 / 60, False, 4.5, 12.5, 0.78)
    out4 = inp.update(InputFrame(jump=True), 1 / 60, False, 4.5, 12.5, 0.78)
    assert out1["jump_requested"] and not out2["jump_requested"]
    assert not out3["jump_requested"] and out4["jump_requested"]


def test_chase_camera():
    from swift_game_engine_tpu.render.camera import Camera
    inp = InputSystem()
    cam = Camera()
    inp.update_camera(cam, np.array([0.0, 2.0, 0.0]))
    # yaw 0, pitch -0.1: camera behind +z, slightly below target height+1.5
    assert cam.world_position[2] > 7.0
    assert np.linalg.norm(cam.target) == pytest.approx(8.0, abs=1e-3)


# --- composite / overlay ---

def test_aces_range():
    x = jnp.array([[0.0, 0.5, 100.0]])
    y = np.asarray(tone_map_aces(x))
    assert (y >= 0).all() and (y <= 1).all()
    assert y[0, 2] > 0.99  # bright saturates


def test_fps_overlay_blit():
    ov = FPSOverlay()
    fps = ov.update(1 / 60)
    assert fps == 60
    frame = np.zeros((120, 160, 3), np.uint8)
    out = ov.blit(frame, 60)
    assert out.sum() > 0  # digits drawn
    # top-right region has white pixels
    assert out[:40, 100:].max() == 255


def test_fps_overlay_device_matches_host():
    """The in-device UIPass blit equals the host blit for 1-3 digit values,
    and fps < 0 leaves the frame untouched."""
    from swift_game_engine_tpu.render.composite import overlay_blit_device
    ov = FPSOverlay()
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    for fps in (7, 60, 144, 999):
        host = ov.blit(frame, fps)
        dev = np.asarray(jax.jit(overlay_blit_device)(jnp.asarray(frame),
                                                      jnp.int32(fps)))
        # float rounding in the two blend paths may differ by 1 ulp of u8
        assert np.abs(dev.astype(int) - host.astype(int)).max() <= 1, fps
    off = np.asarray(jax.jit(overlay_blit_device)(jnp.asarray(frame),
                                                  jnp.int32(-1)))
    assert (off == frame).all()


def test_sort_compaction_matches_chunked():
    """rt._chunked (sort-based compaction schedule) visits exactly the set
    lanes of the mask, each once, in <= cap-lane chunks."""
    import numpy as np
    import jax.numpy as jnp
    from swift_game_engine_tpu.render import rt as RT

    rng = np.random.default_rng(3)
    n = 1000
    mask = jnp.asarray(rng.random(n) < 0.3)
    table = jnp.asarray(rng.random((n, 3), np.float32))
    default = jnp.asarray(rng.random((n, 3), np.float32))

    def body2(idx, valid, carry):
        out, visits = carry
        safe = jnp.minimum(idx, n - 1)
        out = out.at[idx].set(table[safe] * 2.0 + 1.0)
        return out, visits.at[idx].add(1)

    visits0 = jnp.zeros(n, jnp.int32)
    got, visits = RT._chunked(mask, body2, (default, visits0), cap=128)
    expect = jnp.where(mask[:, None], table * 2.0 + 1.0, default)
    assert np.allclose(np.asarray(got), np.asarray(expect))
    assert np.array_equal(np.asarray(visits), np.asarray(mask, np.int32))

    # empty mask: zero iterations, defaults pass through
    got0, _ = RT._chunked(jnp.zeros(n, bool), body2, (default, visits0),
                          cap=128)
    assert np.array_equal(np.asarray(got0), np.asarray(default))
