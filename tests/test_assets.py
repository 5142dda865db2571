"""Skeleton and motion-profile assets.

Golden checks against the reference project's own JSON files run when
$SGE_REFERENCE_DIR points at a checkout of it and skip otherwise; the
structural checks run on the rig derived from assets/YBot.skinned.json
(assets.player_rig) with its synthetic profiles."""

import numpy as np
import pytest

from swift_game_engine_tpu.assets import nputil
from swift_game_engine_tpu.assets.skeleton import load_skeleton, build_skeleton
from swift_game_engine_tpu.assets.motion_profile import (
    load_motion_profile, pack_profile, evaluate_fourier, fourier_basis_np,
)
from swift_game_engine_tpu.assets import player_rig

pytestmark = pytest.mark.fast


def _reference(name):
    path = player_rig.reference_file(name)
    if path is None:
        pytest.skip(f"reference asset {name} not available "
                    f"(set ${player_rig.REFERENCE_DIR_ENV})")
    return path


@pytest.fixture(scope="module")
def ref_ybot():
    return load_skeleton(_reference("YBot.skeleton.json"))


@pytest.fixture(scope="module")
def rig():
    """(skeleton, profiles) the DemoScene player uses."""
    return player_rig.load_player_rig()


@pytest.fixture(scope="module")
def ybot(rig):
    return rig[0]


def test_ybot_basic_shape(ref_ybot):
    ybot = ref_ybot
    assert ybot.bone_count == 65
    assert ybot.parent[0] == -1
    assert ybot.unit_scale == pytest.approx(0.026)
    assert ybot.names[0] == "mixamorig:Hips"
    # mixamo rig -> auto root rule -> zero_root: root rest translation is 0
    np.testing.assert_allclose(ybot.rest_translation[0], 0.0)
    # but the raw rest keeps the file's value
    assert abs(ybot.raw_rest_translation[0][1] - 99.791939) < 1e-4


def test_ybot_semantics(ybot):
    # the pose stack's semantic bones all resolve on the player rig
    assert ybot.semantic["pelvis"] == 0
    for key in ("head", "thighL", "calfR", "footL", "chest" if "chest" in ybot.semantic else "spine3"):
        assert key in ybot.semantic or key == "chest"


def test_ybot_root_fix_is_y180(ybot):
    # the reference's Mixamo root fix, kept by the derived rig
    expected = nputil.rotation_xyz_degrees(np.array([0.0, 180.0, 0.0]))
    np.testing.assert_allclose(ybot.root_rotation_fix, expected, atol=1e-6)


def test_bind_pose_structure(ybot):
    # bind_local = T(rest) @ pre_rot
    recon = nputil.translation_mat(ybot.rest_translation) @ ybot.pre_rot
    np.testing.assert_allclose(ybot.bind_local, recon, atol=1e-6)
    # inv_bind_model inverts the FK of bind locals
    model = nputil.fk_model_transforms(ybot.parent, ybot.bind_local)
    prod = model @ ybot.inv_bind_model
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(4), prod.shape), atol=1e-4)


def test_levels_partition(ybot):
    n = ybot.bone_count
    flat = np.concatenate(ybot.levels)
    assert sorted(flat.tolist()) == list(range(n))
    # every bone's parent is in a strictly earlier level
    level_of = {}
    for li, idxs in enumerate(ybot.levels):
        for i in idxs:
            level_of[int(i)] = li
    for i in range(n):
        p = int(ybot.parent[i])
        if p >= 0:
            assert level_of[p] < level_of[i]


def test_zero_root_rule_explicit():
    sk = build_skeleton(
        names=["a", "b"], parent=[-1, 0],
        raw_translations=[[1, 2, 3], [4, 5, 6]],
        pre_rotation_degrees=[[0, 0, 0], [0, 0, 0]],
        unit_scale=2.0, root_rule="keep",
    )
    np.testing.assert_allclose(sk.rest_translation, [[2, 4, 6], [8, 10, 12]])


def test_motion_profile_load():
    p = load_motion_profile(_reference("Idle.motionProfile.json"))
    assert p.name == "Idle"
    assert p.order == 4
    assert p.sample_fps == 60
    assert p.cycle == pytest.approx(p.duration)
    assert "mixamorig:Hips" in p.bones


def test_fourier_oracle_simple():
    # f(p) = 1 + 2cos(2pi p) + 3sin(2pi p)
    coeffs = [1.0, 2.0, 3.0]
    for p in (0.0, 0.25, 0.5, 0.77):
        ang = 2 * np.pi * p
        assert evaluate_fourier(coeffs, p, 4) == pytest.approx(1 + 2 * np.cos(ang) + 3 * np.sin(ang), abs=1e-5)
    # phase clamped to [0, 1]
    assert evaluate_fourier(coeffs, -1.0, 4) == pytest.approx(evaluate_fourier(coeffs, 0.0, 4))
    assert evaluate_fourier(coeffs, 2.0, 4) == pytest.approx(evaluate_fourier(coeffs, 1.0, 4))


def test_fourier_dangling_coeff_rule():
    # Even-length list: trailing a_k with no b_k must be ignored.
    coeffs = [1.0, 2.0, 3.0, 99.0]
    assert evaluate_fourier(coeffs, 0.3, 4) == pytest.approx(evaluate_fourier([1.0, 2.0, 3.0], 0.3, 4))


def test_packed_matches_oracle(rig):
    ybot, profiles = rig
    prof = profiles["Walking"]
    packed = pack_profile(prof, ybot)
    rng = np.random.default_rng(0)
    for phase in rng.uniform(0, 1, 4):
        basis = fourier_basis_np(np.float32(phase), packed.order)
        vals = packed.coeffs @ basis  # (B, 6)
        for b, name in enumerate(ybot.names):
            bone = prof.bones.get(name)
            if bone is None:
                assert not packed.has_channel[b].any()
                continue
            for ch, (group, axis) in enumerate(
                [("translation", "x"), ("translation", "y"), ("translation", "z"),
                 ("rotation", "x"), ("rotation", "y"), ("rotation", "z")]
            ):
                coeffs = (bone.get(group) or {}).get(axis)
                if coeffs is None:
                    assert not packed.has_channel[b, ch]
                else:
                    assert packed.has_channel[b, ch]
                    expected = evaluate_fourier(coeffs, phase, prof.order)
                    assert vals[b, ch] == pytest.approx(expected, abs=2e-3), (name, group, axis)


def test_packed_dangling_zeroed(ref_ybot):
    ybot = ref_ybot
    prof = load_motion_profile(_reference("Idle.motionProfile.json"))
    packed = pack_profile(prof, ybot)
    basis = fourier_basis_np(np.float32(0.37), packed.order)
    vals = packed.coeffs @ basis
    hips = ybot.index_by_name["mixamorig:Hips"]
    expected = evaluate_fourier(prof.bones["mixamorig:Hips"]["rotation"]["y"], 0.37, prof.order)
    assert vals[hips, 4] == pytest.approx(expected, abs=2e-3)


# --- the rig derived from assets/YBot.skinned.json (assets.player_rig) ---

def test_derived_rig_fk_reproduces_inverse_binds():
    """FK of the derived bind pose (root kept, no root fix) reproduces every
    inverse bind matrix of the skin, translations in scene units."""
    import json
    sk = player_rig.skeleton_from_skinned(root_rule="keep",
                                          root_fix_degrees=(0, 0, 0))
    with open(player_rig.SKINNED_JSON) as f:
        bones = json.load(f)["skin"]["bones"]
    ib = np.stack([np.asarray(b["inverseBindMatrix"], np.float64)
                   .reshape(4, 4) for b in bones])
    ib[:, :3, 3] *= player_rig.YBOT_UNIT_SCALE
    assert sk.bone_count == len(bones) == 52
    np.testing.assert_allclose(sk.inv_bind_model, ib, atol=1e-4)
    model = nputil.fk_model_transforms(sk.parent, sk.bind_local)
    np.testing.assert_allclose(model @ ib, np.broadcast_to(np.eye(4),
                                                           ib.shape), atol=1e-4)


def test_derived_rig_hierarchy():
    sk = player_rig.skeleton_from_skinned()
    name = {i: n.split(":")[-1] for i, n in enumerate(sk.names)}
    parent_of = {name[i]: (name[int(p)] if p >= 0 else None)
                 for i, p in enumerate(sk.parent)}
    assert parent_of["Hips"] is None
    assert parent_of["Head"] == "Neck" and parent_of["Neck"] == "Spine2"
    assert parent_of["LeftShoulder"] == "Spine2"
    assert parent_of["RightHandPinky3"] == "RightHandPinky2"
    assert parent_of["LeftHandThumb1"] == "LeftHand"
    assert parent_of["RightToeBase"] == "RightFoot"
    assert parent_of["LeftUpLeg"] == "Hips"
    # every semantic bone of the pose stack resolves
    for key in ("pelvis", "spine1", "spine2", "spine3", "neck", "head",
                "upperarmL", "handR", "thighL", "calfR", "footL", "ballR"):
        assert key in sk.semantic, key
    # zero_root: the hips sit at the entity origin, the raw rest keeps FBX cm
    np.testing.assert_allclose(sk.rest_translation[0], 0.0)
    assert sk.raw_rest_translation[0][1] == pytest.approx(99.79, abs=0.01)


def test_euler_xyz_round_trip():
    rng = np.random.default_rng(0)
    for deg in rng.uniform(-170, 170, (20, 3)):
        deg[1] = np.clip(deg[1], -85, 85)
        r = nputil.rotation_xyz_degrees(deg)[:3, :3]
        back = nputil.rotation_xyz_degrees(player_rig.euler_xyz_degrees(r))
        np.testing.assert_allclose(back[:3, :3], r, atol=1e-5)
    gimbal = nputil.rotation_xyz_degrees([0.0, 90.0, 30.0])[:3, :3]
    back = nputil.rotation_xyz_degrees(player_rig.euler_xyz_degrees(gimbal))
    np.testing.assert_allclose(back[:3, :3], gimbal, atol=1e-5)


@pytest.mark.parametrize("name", player_rig.PROFILE_NAMES)
def test_synthetic_profiles_pack(rig, name):
    ybot, profiles = rig
    prof = profiles[name]
    assert prof.order == 4 and prof.sample_fps == 60
    assert prof.cycle == pytest.approx(prof.duration)
    packed = pack_profile(prof, ybot)
    assert packed.coeffs.shape == (ybot.bone_count, 6, 9)
    assert packed.has_channel.any()
    assert np.isfinite(packed.coeffs).all()
    # the evaluator agrees with the scalar oracle on every packed channel
    basis = fourier_basis_np(np.float32(0.3), packed.order)
    vals = packed.coeffs @ basis
    for b, ch in zip(*np.nonzero(packed.has_channel)):
        group = "translation" if ch < 3 else "rotation"
        coeffs = prof.bones[ybot.names[b]][group]["xyz"[ch % 3]]
        assert vals[b, ch] == pytest.approx(
            evaluate_fourier(coeffs, 0.3, prof.order), abs=2e-3)
