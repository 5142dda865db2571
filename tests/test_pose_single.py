"""Single-profile pose playback path (ProceduralPoseSystem.swift:224-276)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from swift_game_engine_tpu.assets.motion_profile import pack_profile
from swift_game_engine_tpu.assets.player_rig import load_player_rig
from swift_game_engine_tpu.anim import pose as P
from swift_game_engine_tpu.assets import nputil

import oracle_pose as O

pytestmark = pytest.mark.fast

def test_single_profile_matches_oracle():
    sk, profiles = load_player_rig()
    prof = profiles["Walking"]
    packed = pack_profile(prof, sk)
    eng = P.PoseEngine(sk)
    eng.order = packed.order
    params = P.LocoParams.default()

    time0 = jnp.float32(0.2)
    dt = 1.0 / 60.0
    f = jax.jit(lambda t: P.single_profile_pose_tq(
        jnp.asarray(packed.coeffs), jnp.asarray(packed.has_channel),
        jnp.float32(packed.cycle), t, params, eng.arrays, packed.order,
        eng.unit_scale, dt))
    t, q, phase, new_time = f(time0)

    # oracle: single-profile path semantics
    time_o = 0.2 + dt
    cycle = max(prof.cycle, 0.001)
    time_o = time_o % cycle
    phase_o = min(max(time_o / cycle, 0.0), 1.0)
    assert float(phase) == pytest.approx(phase_o, abs=1e-5)
    assert float(new_time) == pytest.approx(time_o, abs=1e-5)

    local = np.zeros((sk.bone_count, 4, 4))
    for i, name in enumerate(sk.names):
        tt, rot = O.sample_bone(prof, name, phase_o, sk, i, True)
        m = np.eye(4)
        m[:3, :3] = rot[:3, :3]
        m[:3, 3] = tt
        local[i] = m
    # compare local transforms reconstructed from (t, q)
    got = np.asarray(P._compose_tq(t, q))
    np.testing.assert_allclose(got, local, atol=4e-3)

    # FK + palette equals oracle's
    model_o = nputil.fk_model_transforms(sk.parent, local.astype(np.float32))
    model = np.asarray(eng.fk.model_matrices(t, q))
    np.testing.assert_allclose(model, model_o, atol=6e-3)
