"""Pose engine parity vs the NumPy oracle (reference semantics), on the
DemoScene player rig (assets.player_rig: the reference's files when
available, else the derived rig with synthetic profiles)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swift_game_engine_tpu.assets.motion_profile import pack_profile
from swift_game_engine_tpu.assets.player_rig import load_player_rig
from swift_game_engine_tpu.anim import pose as P

import oracle_pose as O

pytestmark = pytest.mark.fast

@pytest.fixture(scope="module")
def setup():
    sk, profs = load_player_rig()
    profiles = [profs[n] for n in ("Idle", "Walking", "Running",
                                   "FallingIdle")]
    action = profs["StandingDodgeBackward"]
    eng = P.PoseEngine(sk)
    bank = eng.make_bank(*[pack_profile(p, sk) for p in profiles])
    act = eng.make_action(pack_profile(action, sk))
    step = jax.jit(lambda loco, params, astate, inputs, dt:
                   eng.step_character(bank, act, loco, params, astate, inputs, dt))
    return sk, profiles, action, eng, bank, act, step


def mk_state(state=P.IDLE, from_state=P.IDLE, times=(0, 0, 0, 0),
             blend_t=1.0, idle_inertia=0.0, is_blending=False):
    return P.LocoState(
        state=jnp.int32(state), from_state=jnp.int32(from_state),
        times=jnp.asarray(times, jnp.float32), blend_t=jnp.float32(blend_t),
        idle_inertia=jnp.float32(idle_inertia), is_blending=jnp.asarray(is_blending))


def run_both(setup, loco_kw, dt=1 / 60, action_kw=None, inputs_kw=None, steps=1):
    sk, profiles, action_prof, eng, bank, act, step = setup
    loco = mk_state(**loco_kw)
    params = P.LocoParams.default()
    astate = P.ActionState.inactive()
    if action_kw:
        astate = P.ActionState(time=jnp.float32(action_kw["time"]),
                               weight=jnp.float32(action_kw["weight"]),
                               active=jnp.asarray(action_kw["active"]))
    inputs = P.PoseInputs.default()
    if inputs_kw:
        inputs = P.PoseInputs(
            forward=jnp.asarray(inputs_kw.get("forward", [0, 0, -1]), jnp.float32),
            ground_normal=jnp.asarray(inputs_kw.get("ground_normal", [0, 1, 0]), jnp.float32),
            grounded_near=jnp.asarray(inputs_kw.get("grounded_near", False)))

    o_state = {"state": loco_kw.get("state", P.IDLE),
               "from_state": loco_kw.get("from_state", P.IDLE),
               "times": np.asarray(loco_kw.get("times", (0, 0, 0, 0)), np.float64),
               "blend_t": loco_kw.get("blend_t", 1.0),
               "idle_inertia": loco_kw.get("idle_inertia", 0.0),
               "is_blending": loco_kw.get("is_blending", False)}
    o_params = {"playback_rate": 1.0, "loop": True, "in_place": True,
                "blend_time": 0.2, "idle_half_life": 0.18}
    o_action = None
    if action_kw:
        o_action = dict(action_kw)
        o_action.setdefault("in_place", True)
    ik = inputs_kw or {}

    for _ in range(steps):
        res = step(loco, params, astate, inputs, jnp.float32(dt))
        loco = res.loco
        o = O.oracle_pose_step(sk, profiles, o_state, o_params, dt,
                               action_profile=action_prof if action_kw else None,
                               action_state=o_action,
                               forward=ik.get("forward", (0, 0, -1)),
                               ground_normal=ik.get("ground_normal", (0, 1, 0)),
                               grounded_near=ik.get("grounded_near", False))
        o_state = o["state"]
    return res, o


def assert_pose_close(res, o, atol=5e-3):
    np.testing.assert_allclose(np.asarray(res.palette), o["palette"], atol=atol)
    np.testing.assert_allclose(np.asarray(res.model), o["model"], atol=atol)
    assert float(res.phase) == pytest.approx(float(o["phase"]), abs=1e-4)


def test_idle_no_blend(setup):
    res, o = run_both(setup, {"state": P.IDLE}, steps=3)
    assert_pose_close(res, o)


def test_walk_phase_advance(setup):
    res, o = run_both(setup, {"state": P.WALK, "times": (0.3, 0.5, 0.1, 0.0)}, steps=5)
    assert_pose_close(res, o)
    st = res.loco
    np.testing.assert_allclose(np.asarray(st.times), o["state"]["times"], atol=1e-4)


def test_walk_to_run_blend(setup):
    res, o = run_both(
        setup,
        {"state": P.RUN, "from_state": P.WALK, "times": (0.0, 0.37, 0.12, 0.0),
         "blend_t": 0.0, "is_blending": True},
        steps=4,
    )
    assert_pose_close(res, o)
    assert bool(res.loco.is_blending) == o["state"]["is_blending"]
    assert float(res.loco.blend_t) == pytest.approx(o["state"]["blend_t"], abs=1e-5)


def test_run_to_idle_inertia_blend(setup):
    res, o = run_both(
        setup,
        {"state": P.IDLE, "from_state": P.RUN, "times": (0.2, 0.1, 0.8, 0.0),
         "blend_t": 0.0, "idle_inertia": 1.0, "is_blending": True},
        steps=6,
    )
    assert_pose_close(res, o)
    assert float(res.loco.idle_inertia) == pytest.approx(o["state"]["idle_inertia"], abs=1e-5)


def test_action_layer(setup):
    res, o = run_both(
        setup,
        {"state": P.WALK, "from_state": P.WALK, "times": (0.0, 0.22, 0.0, 0.0)},
        action_kw={"time": 0.2, "weight": 0.7, "active": True},
    )
    assert_pose_close(res, o)


def test_ground_align_and_lean(setup):
    n = np.array([0.25, 1.0, 0.1])
    n /= np.linalg.norm(n)
    res, o = run_both(
        setup,
        {"state": P.RUN, "from_state": P.RUN, "times": (0, 0, 0.4, 0)},
        inputs_kw={"forward": [0.6, 0.0, -0.8], "ground_normal": n.tolist(),
                   "grounded_near": True},
    )
    assert_pose_close(res, o)


def test_vmapped_batch(setup):
    sk, profiles, action_prof, eng, bank, act, _ = setup
    n = 4
    loco = P.LocoState(
        state=jnp.array([0, 1, 2, 3], jnp.int32),
        from_state=jnp.array([0, 0, 1, 2], jnp.int32),
        times=jnp.tile(jnp.array([0.1, 0.2, 0.3, 0.05], jnp.float32), (n, 1)),
        blend_t=jnp.array([1.0, 1.0, 0.3, 0.5], jnp.float32),
        idle_inertia=jnp.zeros(n, jnp.float32),
        is_blending=jnp.array([False, False, True, True]),
    )
    params = P.LocoParams.default((n,))
    astate = P.ActionState.inactive((n,))
    inputs = P.PoseInputs.default((n,))
    step = jax.jit(jax.vmap(
        lambda lo, pa, a, i: eng.step_character(bank, act, lo, pa, a, i, 1 / 60),
    ))
    res = step(loco, params, astate, inputs)
    assert res.palette.shape == (n, sk.bone_count, 4, 4)
    # Each batch row must match the unbatched call.
    single = jax.jit(lambda lo, pa, a, i: eng.step_character(bank, act, lo, pa, a, i, 1 / 60))
    for b in range(n):
        one = single(jax.tree.map(lambda x: x[b], loco),
                     jax.tree.map(lambda x: x[b], params),
                     jax.tree.map(lambda x: x[b], astate),
                     jax.tree.map(lambda x: x[b], inputs))
        np.testing.assert_allclose(np.asarray(res.palette[b]), np.asarray(one.palette),
                                   atol=1e-5)
