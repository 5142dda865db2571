"""FitMotion tool: synthetic ASCII-FBX round trip.

The repo's FBX sources are binary (the tool, like the reference, consumes
Mixamo ASCII exports), so the test synthesizes an ASCII FBX with known
sinusoidal curves for YBot bones, fits it, and checks the recovered Fourier
coefficients, schema, and evaluator round trip.
"""

import json
import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import fit_motion as FM  # noqa: E402

from swift_game_engine_tpu.assets.motion_profile import (  # noqa: E402
    load_motion_profile, evaluate_fourier)
from swift_game_engine_tpu.assets import player_rig  # noqa: E402

TIME_SCALE = 46186158000.0


def _reference(name):
    """The reference project's own file, or skip (not in this repo)."""
    path = player_rig.reference_file(name)
    if path is None:
        pytest.skip(f"reference asset {name} not available "
                    f"(set ${player_rig.REFERENCE_DIR_ENV})")
    return path


def _skeleton_json(tmp_path):
    """The player rig (reference skeleton when available, else the one
    derived from assets/YBot.skinned.json) as a *.skeleton.json file."""
    ref = player_rig.reference_file("YBot.skeleton.json")
    if ref is not None:
        return ref
    sk = player_rig.skeleton_from_skinned()
    path = tmp_path / "YBot.skeleton.json"
    path.write_text(json.dumps({
        "version": 1, "name": "YBot", "unitScale": sk.unit_scale,
        "rigProfile": {"name": "mixamo"},
        "root": {"rule": "zero_root",
                 "rotationFixDegrees": list(player_rig.YBOT_ROOT_FIX_DEGREES)},
        "names": list(sk.names), "parent": sk.parent.tolist(),
        "translations": sk.raw_rest_translation.tolist(),
        "preRotationDegrees": sk.pre_rotation_degrees.tolist()}))
    return str(path)


pytestmark = pytest.mark.fast

def make_ascii_fbx(bones, duration=1.0, n_keys=61):
    """bones: {name: {channel: {axis: fn(t)->value}}}."""
    lines = []
    next_id = [1000]

    def nid():
        next_id[0] += 1
        return next_id[0]

    model_ids = {}
    for name in bones:
        mid = nid()
        model_ids[name] = mid
        lines.append(f'\tModel: {mid}, "Model::{name}", "LimbNode" {{\n\t}}')

    conns = []
    times = np.linspace(0, duration, n_keys)
    key_times = ", ".join(str(int(round(t * TIME_SCALE))) for t in times)
    for name, channels in bones.items():
        for channel, axes in channels.items():
            node_id = nid()
            ch = "Lcl Translation" if channel == "translation" else "Lcl Rotation"
            conns.append(f'\tC: "OP",{node_id},{model_ids[name]}, "{ch}"')
            for axis, fn in axes.items():
                cid = nid()
                vals = ", ".join(f"{fn(t):.6f}" for t in times)
                lines.append(
                    f'\tAnimationCurve: {cid}, "AnimCurve::", "" {{\n'
                    f'\t\tKeyTime: *{n_keys} {{ a: {key_times}}}\n'
                    f'\t\tKeyValueFloat: *{n_keys} {{ a: {vals}}}\n\t}}')
                conns.append(f'\tC: "OP",{cid},{node_id}, "d|{axis.upper()}"')
    return "Objects: {\n" + "\n".join(lines) + "\n}\nConnections: {\n" + \
        "\n".join(conns) + "\n}\n"


def test_roundtrip_simple_sine(tmp_path):
    dur = 1.0
    bones = {
        "mixamorig:Hips": {
            "translation": {
                "y": lambda t: 100.0 + 5.0 * math.sin(2 * math.pi * t / dur)},
            "rotation": {
                "x": lambda t: 10.0 * math.cos(2 * math.pi * t / dur),
                "y": lambda t: 3.0,
            },
        },
    }
    fbx = tmp_path / "clip.fbx"
    fbx.write_text(make_ascii_fbx(bones, dur))
    out = tmp_path / "clip.motionProfile.json"
    FM.fit(str(fbx), str(out), clip_name="TestClip", fps=60, order=4)

    data = json.loads(out.read_text())
    assert data["name"] == "TestClip"
    assert data["order"] == 4
    assert data["units"] == {"rotation": "degrees", "translation": "fbx_local"}
    assert data["phase"]["mode"] == "normalized_time"

    ty = data["bones"]["mixamorig:Hips"]["translation"]["y"]
    # a0 ~ 100, b1 ~ 5 (sine), a1 ~ 0
    assert ty[0] == pytest.approx(100.0, abs=0.2)
    assert ty[1] == pytest.approx(0.0, abs=0.3)
    assert ty[2] == pytest.approx(5.0, abs=0.3)
    rx = data["bones"]["mixamorig:Hips"]["rotation"]["x"]
    assert rx[1] == pytest.approx(10.0, abs=0.4)
    ry = data["bones"]["mixamorig:Hips"]["rotation"]["y"]
    assert ry[0] == pytest.approx(3.0, abs=1e-3)
    # absent axes are null
    assert data["bones"]["mixamorig:Hips"]["translation"]["x"] is None

    # loads through the engine's profile loader and evaluates close to source
    prof = load_motion_profile(str(out))
    for phase in (0.1, 0.4, 0.85):
        got = evaluate_fourier(prof.bones["mixamorig:Hips"]["translation"]["y"],
                               phase, 4)
        want = 100.0 + 5.0 * math.sin(2 * math.pi * phase)
        assert got == pytest.approx(want, abs=0.25)


def test_walk_cycle_phase_detection(tmp_path):
    """Two gait cycles in one clip: contact cascade should find the
    half-duration period and the stride fix should restore full duration."""
    skel_path = _skeleton_json(tmp_path)
    dur = 2.0
    gait = 1.0  # one gait cycle per second

    def foot_motion(phase_shift):
        def fn(t):
            # down (contact) half the cycle, lifted the other half
            c = math.sin(2 * math.pi * (t / gait + phase_shift))
            return max(c, 0.0) * 15.0
        return fn

    bones = {
        "mixamorig:Hips": {"translation": {
            "y": lambda t: 100.0 + 2.0 * math.sin(4 * math.pi * t / gait)}},
        # feet: animate local y translation so FK sees height changes
        "mixamorig:LeftFoot": {"translation": {"y": foot_motion(0.0)}},
        "mixamorig:RightFoot": {"translation": {"y": foot_motion(0.5)}},
    }
    fbx = tmp_path / "walk.fbx"
    fbx.write_text(make_ascii_fbx(bones, dur, n_keys=121))
    out = tmp_path / "walk.motionProfile.json"
    FM.fit(str(fbx), str(out), clip_name="Walk", fps=60, order=4,
           skeleton_json=skel_path)
    data = json.loads(out.read_text())
    assert "contacts" in data
    assert len(data["contacts"]["left"]) == 9
    # cycle should be ~1s (gait) or the stride-fixed 2s
    cyc = data["phase"]["cycle_duration"]
    assert 0.9 <= cyc <= 1.1 or 1.8 <= cyc <= 2.2, data["phase"]


def test_mirror_override(tmp_path):
    dur = 1.0
    bones = {
        "mixamorig:RightUpLeg": {"rotation": {
            "x": lambda t: 20.0 * math.sin(2 * math.pi * t / dur),
            "y": lambda t: 5.0 * math.cos(2 * math.pi * t / dur)}},
        "mixamorig:LeftUpLeg": {"rotation": {
            "x": lambda t: 1.0}},
    }
    fbx = tmp_path / "clip.fbx"
    fbx.write_text(make_ascii_fbx(bones, dur))
    ov = tmp_path / "overrides.json"
    ov.write_text(json.dumps({"mirror": [{
        "source": "mixamorig:RightUpLeg", "target": "mixamorig:LeftUpLeg",
        "phase_offset": 0.5, "rotation": {"x": 1, "y": -1, "z": -1}}]}))
    out = tmp_path / "clip.json"
    FM.fit(str(fbx), str(out), fps=60, order=4, overrides_path=str(ov))
    data = json.loads(out.read_text())
    right = data["bones"]["mixamorig:RightUpLeg"]["rotation"]
    left = data["bones"]["mixamorig:LeftUpLeg"]["rotation"]
    # left = right sampled at phase+0.5 with sign flips:
    # sin(2pi(t+.5)) = -sin -> x (sign +1): b1 ~ -20
    assert left["x"][2] == pytest.approx(-right["x"][2], rel=0.05)
    # y channel: cos shifted+negated -> a1 ~ +5... source a1 is 5, shifted -> -5, sign -1 -> +5
    assert left["y"][1] == pytest.approx(right["y"][1], rel=0.1)


# ---------------------------------------------------------------------------
# Golden parity: the checked-in reference profiles are the tool's golden
# outputs (SURVEY §4). The source clips are not in-tree (binary Mixamo
# exports never checked in), so the round trip synthesizes FBX curves FROM
# the golden coefficients, refits with the full pipeline (FK foot contacts +
# phase cascade + DFT fit), and requires the result to reproduce the golden
# evaluation, allowing one global circular phase re-origin (the cascade may
# legitimately rebase phi to a contact onset).


def _eval_coeffs(c, phi, order=4):
    c = np.asarray(c, np.float64)
    out = np.full_like(phi, c[0], dtype=np.float64)
    for k in range(1, order + 1):
        if 2 * k >= len(c):
            break
        out = out + c[2 * k - 1] * np.cos(2 * np.pi * k * phi) \
            + c[2 * k] * np.sin(2 * np.pi * k * phi)
    return out


def _profile_channels(data):
    """{(bone, channel, axis): coeffs} for non-null channels."""
    out = {}
    for bone, ch in data["bones"].items():
        for channel in ("translation", "rotation"):
            chd = ch.get(channel) or {}
            for axis in ("x", "y", "z"):
                co = chd.get(axis)
                if co:
                    out[(bone, channel, axis)] = co
    return out


@pytest.mark.parametrize("clip", ["Idle", "Walking"])
def test_golden_profile_roundtrip(tmp_path, clip):
    src = json.loads(open(_reference(f"{clip}.motionProfile.json")).read())
    dur = float(src["duration"])
    order = int(src["order"])
    cycle = float(src["phase"]["cycle_duration"])
    golden = _profile_channels(src)

    bones = {}
    for (bone, channel, axis), co in golden.items():
        def fn(t, co=co):
            return float(_eval_coeffs(co, np.asarray([(t % cycle) / cycle]),
                                      order)[0])
        bones.setdefault(bone, {}).setdefault(channel, {})[axis] = fn

    fbx = tmp_path / f"{clip}.fbx"
    fbx.write_text(make_ascii_fbx(bones, dur, n_keys=int(dur * 240) + 1))
    out = tmp_path / "refit.json"
    FM.fit(str(fbx), str(out), clip_name=clip, fps=src["sample_fps"],
           order=order, skeleton_json=_reference("YBot.skeleton.json"))
    refit = json.loads(out.read_text())

    assert refit["duration"] == pytest.approx(dur, rel=0.02)
    got = _profile_channels(refit)
    keys = sorted(set(golden) & set(got))
    assert len(keys) >= 0.95 * len(golden)

    g = 512
    phi = np.arange(g) / g
    a = np.stack([_eval_coeffs(golden[k], phi, order) for k in keys])  # (C,G)
    b = np.stack([_eval_coeffs(got[k], phi, order) for k in keys])

    # one global circular shift (brute force over the phase grid)
    errs = []
    for s in range(g):
        errs.append(np.abs(a - np.roll(b, s, axis=1)).mean())
    s_best = int(np.argmin(errs))
    b_al = np.roll(b, s_best, axis=1)

    span = a.max(axis=1) - a.min(axis=1)
    tol = np.maximum(0.05 * span, 0.05)
    worst = np.abs(a - b_al).max(axis=1)
    bad = [(keys[i], float(worst[i]), float(tol[i]))
           for i in range(len(keys)) if worst[i] > tol[i]]
    assert not bad, f"{len(bad)} channels off (shift {s_best}/{g}): {bad[:5]}"


def test_binary_fbx_curves():
    """tools/fbx.py-backed binary parsing binds mixamorig curves (the
    in-tree Y Bot.fbx carries a 2-key T-pose take)."""
    root = os.environ.get(player_rig.REFERENCE_DIR_ENV)
    fbx = os.path.join(root, "ExternalResources", "Y Bot.fbx") if root else ""
    if not os.path.exists(fbx):
        pytest.skip("reference Y Bot.fbx not available "
                    f"(set ${player_rig.REFERENCE_DIR_ENV})")
    anims, duration = FM.parse_fbx_curves_binary(fbx)
    assert any(n.startswith("mixamorig") for n in anims)
    hips = anims.get("mixamorig:Hips") or anims.get("mixamorig9:Hips")
    assert hips and (hips["translation"] or hips["rotation"])
    assert duration > 0
