"""The DemoScene player rig, built from the files this repository holds.

The reference loads the player from ``YBot.skeleton.json`` and five
``*.motionProfile.json`` Fourier fits (Game/CharacterFactory.swift:12-135).
Those files are not part of this repository; ``assets/YBot.skinned.json`` is.
It names 52 ``mixamorig:*`` bones, parents before children, each with the
inverse bind matrix of the FBX bind pose. This module derives a skeleton
from it and generates five motion profiles:

  * **Skeleton.** The Mixamo hierarchy is fixed by the rig's naming, so the
    parent table is written out below rather than guessed from geometry.
    With model = inv(inverseBind), every bone's bind-local transform is
    inv(model_parent) @ model, decomposed into the ``build_skeleton`` fields:
    a translation (FBX units) and an XYZ pre-rotation in degrees.
  * **Motion profiles.** Idle, Walking, Running, FallingIdle and
    StandingDodgeBackward are SYNTHETIC stand-ins, not the reference's fits:
    low-order Fourier curves on the hips, spine, legs and arms, in the
    ``MotionProfile`` schema the loader reads (order 4, 60 fps). They keep
    the pose stack (locomotion blends, the dodge action, ground align and
    lean) driven with plausible motion.

Where a directory with the reference's own files is given
(``DemoScene(asset_dir=...)``, or ``$SGE_REFERENCE_DIR/Game``), those files
win over the derived ones, file by file.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from . import nputil
from .motion_profile import MotionProfile, load_motion_profile
from .skeleton import Skeleton, build_skeleton, load_skeleton

_REPO_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "assets")
SKINNED_JSON = os.path.join(_REPO_ASSETS, "YBot.skinned.json")

# Environment variable naming a checkout of the reference project (the
# directory holding ``Game/`` and ``ExternalResources/``).
REFERENCE_DIR_ENV = "SGE_REFERENCE_DIR"

# The reference skeleton's unitScale for YBot: FBX centimetres -> scene units,
# sizing the 180 cm mesh to the player capsule (radius 1.5, half height 1).
YBOT_UNIT_SCALE = 0.026
# The reference's Mixamo root handling: root translation zeroed (the hips sit
# at the entity origin, feet near the capsule bottom) and a 180 degree turn
# about Y so the mesh faces the controller's forward.
YBOT_ROOT_RULE = "zero_root"
YBOT_ROOT_FIX_DEGREES = (0.0, 180.0, 0.0)

PROFILE_NAMES = ("Idle", "Walking", "Running", "FallingIdle",
                 "StandingDodgeBackward")
PROFILE_ORDER = 4
PROFILE_FPS = 60

_PREFIX = "mixamorig:"


def _mixamo_parents() -> dict:
    """Short bone name -> short parent name (None for the root)."""
    par = {"Hips": None}
    chain = ["Hips", "Spine", "Spine1", "Spine2", "Neck", "Head"]
    for a, b in zip(chain, chain[1:]):
        par[b] = a
    for side in ("Left", "Right"):
        arm = ["Spine2", f"{side}Shoulder", f"{side}Arm", f"{side}ForeArm",
               f"{side}Hand"]
        for a, b in zip(arm, arm[1:]):
            par[b] = a
        for finger in ("Thumb", "Index", "Middle", "Ring", "Pinky"):
            prev = f"{side}Hand"
            for k in (1, 2, 3):
                par[f"{side}Hand{finger}{k}"] = prev
                prev = f"{side}Hand{finger}{k}"
        leg = ["Hips", f"{side}UpLeg", f"{side}Leg", f"{side}Foot",
               f"{side}ToeBase"]
        for a, b in zip(leg, leg[1:]):
            par[b] = a
    return par


MIXAMO_PARENTS = _mixamo_parents()


def mixamo_parent_indices(names) -> np.ndarray:
    """(B,) parent index per bone of a ``mixamorig:`` bone list (-1 = root).
    Raises if a bone is not in the Mixamo table or precedes its parent."""
    index = {n: i for i, n in enumerate(names)}
    out = np.full(len(names), -1, np.int32)
    for i, name in enumerate(names):
        short = name.split(":")[-1]
        if short not in MIXAMO_PARENTS:
            raise ValueError(f"bone {name!r} is not in the Mixamo table")
        p = MIXAMO_PARENTS[short]
        if p is None:
            continue
        j = index.get(_PREFIX + p)
        if j is None or j >= i:
            raise ValueError(f"parent of {name!r} missing or after it")
        out[i] = j
    return out


def euler_xyz_degrees(r: np.ndarray) -> np.ndarray:
    """Inverse of ``nputil.rotation_xyz_degrees`` (R = Rz @ Ry @ Rx) for a
    3x3 rotation; at gimbal lock the X angle is taken as 0."""
    r = np.asarray(r, np.float64)
    sy = -r[2, 0]
    if abs(sy) < 1.0 - 1e-9:
        x = np.arctan2(r[2, 1], r[2, 2])
        y = np.arcsin(np.clip(sy, -1.0, 1.0))
        z = np.arctan2(r[1, 0], r[0, 0])
    else:
        x = 0.0
        y = np.pi / 2 if sy > 0 else -np.pi / 2
        z = np.arctan2(-r[0, 1], r[1, 1])
    return np.degrees([x, y, z])


def _orthonormal(r: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(r)
    return u @ vt


def skeleton_from_skinned(path: str = SKINNED_JSON,
                          unit_scale: float = YBOT_UNIT_SCALE,
                          root_rule: str = YBOT_ROOT_RULE,
                          root_fix_degrees=YBOT_ROOT_FIX_DEGREES) -> Skeleton:
    """Skeleton whose bind pose is the skin's: with ``root_rule="keep"`` and
    no root fix, FK of the bind locals reproduces every inverse bind of the
    file (translations scaled by ``unit_scale``)."""
    with open(path) as f:
        bones = json.load(f)["skin"]["bones"]
    names = [b["name"] for b in bones]
    parent = mixamo_parent_indices(names)
    inv_bind = np.stack([np.asarray(b["inverseBindMatrix"], np.float64)
                         .reshape(4, 4) for b in bones])
    model = np.linalg.inv(inv_bind)
    trans = np.zeros((len(names), 3))
    pre = np.zeros((len(names), 3))
    for i, p in enumerate(parent):
        local = model[i] if p < 0 else np.linalg.inv(model[p]) @ model[i]
        trans[i] = local[:3, 3]
        pre[i] = euler_xyz_degrees(_orthonormal(local[:3, :3]))
    return build_skeleton(names, parent, trans, pre, unit_scale=unit_scale,
                          root_rule=root_rule,
                          root_fix_degrees=root_fix_degrees, rig_name="mixamo")


# ---------------------------------------------------------------------------
# Synthetic motion profiles.
#
# Each curve is (a0, a1, b1, a2, b2) in the Fourier schema
# a0 + a1 cos(2 pi p) + b1 sin(2 pi p) + a2 cos(4 pi p) + b2 sin(4 pi p),
# padded with zeros to order 4. Rotations are degrees about the world axis
# named in the table ("x" = lateral, "y" = up, "z" = forward); they are mapped
# onto the bone-local Euler axis that points closest to that world axis in the
# bind pose, so the same table reads correctly whatever the rig's bone
# frames. The hips translation is a vertical bob in FBX units.

def _c(a0=0.0, a1=0.0, b1=0.0, a2=0.0, b2=0.0):
    return [a0, a1, b1, a2, b2]


def _mirror(curve):
    """The other leg/arm: half a cycle later (first harmonic negated)."""
    a0, a1, b1, a2, b2 = curve
    return [a0, -a1, -b1, a2, b2]


def _gait(swing, knee, arm, bob, lean):
    return {
        "Hips": {"ty": _c(0.0, 0.0, 0.0, bob, 0.0)},
        "Spine": {"x": _c(lean), "y": _c(0.0, 0.0, 0.3 * arm)},
        "LeftUpLeg": {"x": _c(0.0, 0.0, swing)},
        "RightUpLeg": {"x": _mirror(_c(0.0, 0.0, swing))},
        "LeftLeg": {"x": _c(knee, 0.0, -knee * 0.8)},
        "RightLeg": {"x": _mirror(_c(knee, 0.0, -knee * 0.8))},
        "LeftArm": {"x": _mirror(_c(0.0, 0.0, arm))},
        "RightArm": {"x": _c(0.0, 0.0, arm)},
        "LeftForeArm": {"x": _c(0.4 * arm)},
        "RightForeArm": {"x": _c(0.4 * arm)},
    }


_PROFILE_TABLES = {
    # name: (duration seconds, table)
    "Idle": (2.0, {
        "Hips": {"ty": _c(0.0, 0.4)},
        "Spine": {"x": _c(1.0, 1.0)},
        "Spine1": {"x": _c(0.5, 0.8)},
        "Neck": {"y": _c(0.0, 0.0, 2.0)},
        "LeftArm": {"z": _c(0.0, 1.5)},
        "RightArm": {"z": _c(0.0, -1.5)},
    }),
    "Walking": (1.1, _gait(swing=25.0, knee=20.0, arm=18.0, bob=1.5,
                           lean=3.0)),
    "Running": (0.7, _gait(swing=45.0, knee=45.0, arm=35.0, bob=3.0,
                           lean=12.0)),
    "FallingIdle": (1.5, {
        "Spine": {"x": _c(-5.0, 3.0)},
        "LeftArm": {"z": _c(40.0, 0.0, 10.0)},
        "RightArm": {"z": _c(-40.0, 0.0, -10.0)},
        "LeftUpLeg": {"x": _c(10.0, 0.0, 15.0)},
        "RightUpLeg": {"x": _mirror(_c(10.0, 0.0, 15.0))},
        "LeftLeg": {"x": _c(25.0, 10.0)},
        "RightLeg": {"x": _c(25.0, -10.0)},
    }),
    # A backward dodge over one non-looping cycle: lean back and crouch,
    # peaking mid-cycle (a0 - a1 cos(2 pi p) is 0 at both ends).
    "StandingDodgeBackward": (1.2, {
        "Hips": {"ty": _c(-6.0, 6.0)},
        "Spine": {"x": _c(-10.0, 10.0)},
        "Spine1": {"x": _c(-6.0, 6.0)},
        "LeftUpLeg": {"x": _c(15.0, -15.0)},
        "RightUpLeg": {"x": _c(15.0, -15.0)},
        "LeftLeg": {"x": _c(25.0, -25.0)},
        "RightLeg": {"x": _c(25.0, -25.0)},
        "LeftArm": {"x": _c(12.0, -12.0)},
        "RightArm": {"x": _c(12.0, -12.0)},
    }),
}

_WORLD_AXIS = {"x": 0, "y": 1, "z": 2}


def _pad(curve):
    out = [0.0] * (2 * PROFILE_ORDER + 1)
    out[:len(curve)] = [float(c) for c in curve]
    return out


def synthetic_profile(name: str, skeleton: Skeleton) -> MotionProfile:
    """One synthetic stand-in profile for ``skeleton`` (see module doc)."""
    duration, table = _PROFILE_TABLES[name]
    model = nputil.fk_model_transforms(skeleton.parent, skeleton.bind_local)
    bones = {}
    for short, channels in table.items():
        full = _PREFIX + short
        i = skeleton.index_by_name[full]
        rot = {"x": None, "y": None, "z": None}
        trans = {"x": None, "y": None, "z": None}
        for ch, curve in channels.items():
            if ch == "ty":
                rest = float(skeleton.raw_rest_translation[i, 1])
                trans["y"] = _pad([rest + curve[0]] + list(curve[1:]))
                continue
            # bone-local axis closest to the requested world axis
            world = model[i, :3, :3]
            k = int(np.argmax(np.abs(world[_WORLD_AXIS[ch], :])))
            sign = float(np.sign(world[_WORLD_AXIS[ch], k]) or 1.0)
            axis = "xyz"[k]
            scaled = [sign * c for c in curve]
            if rot[axis] is not None:
                scaled = [a + b for a, b in zip(rot[axis], _pad(scaled))]
            rot[axis] = _pad(scaled)
        bones[full] = {"translation": trans, "rotation": rot}
    return MotionProfile(name=name, duration=duration, order=PROFILE_ORDER,
                         sample_fps=PROFILE_FPS, bones=bones,
                         cycle_duration=duration)


def reference_game_dir() -> Optional[str]:
    """``$SGE_REFERENCE_DIR/Game`` when that variable is set, else None."""
    root = os.environ.get(REFERENCE_DIR_ENV)
    return os.path.join(root, "Game") if root else None


def reference_file(name: str, asset_dir: Optional[str] = None) -> Optional[str]:
    """Path of the reference's own ``name`` under ``asset_dir`` (default
    :func:`reference_game_dir`), or None when it is not there."""
    asset_dir = asset_dir if asset_dir is not None else reference_game_dir()
    if not asset_dir:
        return None
    path = os.path.join(asset_dir, name)
    return path if os.path.exists(path) else None


def load_player_rig(asset_dir: Optional[str] = None):
    """(skeleton, {name: MotionProfile}) for the player: the reference's
    files where ``asset_dir`` holds them, the derived rig and synthetic
    profiles otherwise."""
    sk_path = reference_file("YBot.skeleton.json", asset_dir)
    skeleton = load_skeleton(sk_path) if sk_path else skeleton_from_skinned()
    profiles = {}
    for name in PROFILE_NAMES:
        path = reference_file(f"{name}.motionProfile.json", asset_dir)
        profiles[name] = load_motion_profile(path) if path \
            else synthetic_profile(name, skeleton)
    return skeleton, profiles
