"""Skeleton asset: JSON schema loader + packed array form.

Loads the same ``*.skeleton.json`` schema as the reference
(reference: Game/SkeletonLoader.swift:12-158, Game/Skeleton.swift:10-226):

    {version, name, unitScale, rigProfile{name, aliases?},
     root{rule, rotationFixDegrees}, names[B], parent[B],
     translations[B][3], preRotationDegrees[B][3]}

The output is a frozen dataclass of numpy arrays, pre-packing everything the
pose engine needs:
  * ``bind_local`` / ``inv_bind_model`` — bind pose and inverse bind palette
  * ``pre_rot`` — per-bone left rotation multiplier, with the root rotation
    fix already composed into bone 0, so the runtime computes
    ``rot[i] = pre_rot[i] @ euler_xyz(anim_degrees[i])`` uniformly
  * ``levels`` — bones grouped by tree depth for level-parallel FK
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import nputil

SEMANTIC_BONES = (
    "pelvis", "spine1", "spine2", "spine3", "chest", "neck", "head",
    "clavicleL", "upperarmL", "lowerarmL", "handL",
    "clavicleR", "upperarmR", "lowerarmR", "handR",
    "thighL", "calfL", "footL", "ballL",
    "thighR", "calfR", "footR", "ballR",
)

# Alias tables per rig profile (reference: Game/Skeleton.swift:64-90).
_MIXAMO_ALIASES = {
    "pelvis": ["mixamorig:Hips", "Hips", "pelvis"],
    "spine1": ["mixamorig:Spine", "Spine", "spine_01"],
    "spine2": ["mixamorig:Spine1", "Spine1", "spine_02"],
    "spine3": ["mixamorig:Spine2", "Spine2", "spine_03"],
    "neck": ["mixamorig:Neck", "Neck", "neck_01"],
    "head": ["mixamorig:Head", "Head"],
    "clavicleL": ["mixamorig:LeftShoulder", "LeftShoulder", "clavicle_l"],
    "upperarmL": ["mixamorig:LeftArm", "LeftArm", "upperarm_l"],
    "lowerarmL": ["mixamorig:LeftForeArm", "LeftForeArm", "lowerarm_l"],
    "handL": ["mixamorig:LeftHand", "LeftHand", "hand_l"],
    "clavicleR": ["mixamorig:RightShoulder", "RightShoulder", "clavicle_r"],
    "upperarmR": ["mixamorig:RightArm", "RightArm", "upperarm_r"],
    "lowerarmR": ["mixamorig:RightForeArm", "RightForeArm", "lowerarm_r"],
    "handR": ["mixamorig:RightHand", "RightHand", "hand_r"],
    "thighL": ["mixamorig:LeftUpLeg", "LeftUpLeg", "thigh_l"],
    "calfL": ["mixamorig:LeftLeg", "LeftLeg", "calf_l"],
    "footL": ["mixamorig:LeftFoot", "LeftFoot", "foot_l"],
    "ballL": ["mixamorig:LeftToeBase", "LeftToeBase", "ball_l"],
    "thighR": ["mixamorig:RightUpLeg", "RightUpLeg", "thigh_r"],
    "calfR": ["mixamorig:RightLeg", "RightLeg", "calf_r"],
    "footR": ["mixamorig:RightFoot", "RightFoot", "foot_r"],
    "ballR": ["mixamorig:RightToeBase", "RightToeBase", "ball_r"],
}


def resolve_semantic_index(rig_name: str, names: list[str],
                           alias_overrides: Optional[dict] = None) -> dict[str, int]:
    """Map semantic bone keys -> bone index via rig-profile alias lists.

    reference: Game/Skeleton.swift:44-62 (first matching alias wins,
    case-insensitive).
    """
    aliases = dict(_MIXAMO_ALIASES) if rig_name.lower() == "mixamo" else {}
    for key, lst in (alias_overrides or {}).items():
        if key in SEMANTIC_BONES:
            aliases[key] = lst
    table = {}
    for i, name in enumerate(names):
        table.setdefault(name.lower(), i)
    out = {}
    for semantic, lst in aliases.items():
        for alias in lst:
            idx = table.get(alias.lower())
            if idx is not None:
                out[semantic] = idx
                break
    return out


@dataclass(frozen=True)
class Skeleton:
    """Packed skeleton. All arrays are float32/int32 numpy, B = bone count."""

    names: tuple[str, ...]
    parent: np.ndarray                 # (B,) int32, -1 for root
    bind_local: np.ndarray             # (B,4,4)
    inv_bind_model: np.ndarray         # (B,4,4)
    rest_translation: np.ndarray       # (B,3) scaled (unit_scale applied)
    raw_rest_translation: np.ndarray   # (B,3) unscaled FBX-local
    pre_rotation_degrees: np.ndarray   # (B,3)
    pre_rot: np.ndarray                # (B,4,4) pre-rotation (+root fix at bone 0)
    root_rotation_fix: np.ndarray      # (4,4)
    unit_scale: float
    semantic: dict = field(default_factory=dict)
    levels: tuple[np.ndarray, ...] = ()
    index_by_name: dict = field(default_factory=dict)

    @property
    def bone_count(self) -> int:
        return len(self.parent)

    def semantic_index(self, key: str, *fallbacks: str) -> Optional[int]:
        for k in (key, *fallbacks):
            if k in self.semantic:
                return self.semantic[k]
        return None


def build_skeleton(names, parent, raw_translations, pre_rotation_degrees,
                   unit_scale=1.0, root_rule="keep", root_fix_degrees=(0, 0, 0),
                   rig_name="generic", alias_overrides=None) -> Skeleton:
    """Assemble a packed skeleton from raw schema fields.

    Semantics follow Game/SkeletonLoader.swift:28-87: the root translation is
    zeroed under the ``zero_root`` rule, translations are scaled by
    ``unitScale``, bind-local = T(rest_scaled) @ [rootFix @] preRot, and the
    inverse bind palette comes from FK of the bind pose.
    """
    b = len(names)
    parent = np.asarray(parent, np.int32)
    raw = np.asarray(raw_translations, np.float32).reshape(b, 3)
    pre = np.asarray(pre_rotation_degrees, np.float32).reshape(b, 3) \
        if len(pre_rotation_degrees) else np.zeros((b, 3), np.float32)

    rest = raw.copy()
    if root_rule == "zero_root" and b > 0:
        rest[0] = 0.0
    rest = rest * np.float32(unit_scale)

    root_fix = nputil.rotation_xyz_degrees(np.asarray(root_fix_degrees, np.float32))
    pre_rot = nputil.rotation_xyz_degrees(pre)        # (B,4,4)
    if b > 0:
        pre_rot[0] = root_fix @ pre_rot[0]
    bind_local = nputil.translation_mat(rest) @ pre_rot

    model = nputil.fk_model_transforms(parent, bind_local)
    inv_bind = np.linalg.inv(model).astype(np.float32)

    semantic = resolve_semantic_index(rig_name, list(names), alias_overrides)
    levels = tuple(nputil.topological_levels(parent))

    return Skeleton(
        names=tuple(names),
        parent=parent,
        bind_local=bind_local.astype(np.float32),
        inv_bind_model=inv_bind,
        rest_translation=rest.astype(np.float32),
        raw_rest_translation=raw.astype(np.float32),
        pre_rotation_degrees=pre.astype(np.float32),
        pre_rot=pre_rot.astype(np.float32),
        root_rotation_fix=root_fix.astype(np.float32),
        unit_scale=float(unit_scale),
        semantic=semantic,
        levels=levels,
        index_by_name={n: i for i, n in enumerate(names)},
    )


def _resolve_root_rule(rule: str, rig_name: str) -> str:
    """reference: Game/SkeletonLoader.swift:141-158."""
    rule = rule.lower()
    if rule in ("zero", "zero_root", "zero-root"):
        return "zero_root"
    if rule in ("keep", "preserve"):
        return "keep"
    if rule == "auto":
        return "zero_root" if rig_name.lower() == "mixamo" else "keep"
    return "keep"


def load_skeleton(path: str) -> Skeleton:
    """Load a ``*.skeleton.json`` file (schema per Game/SkeletonLoader.swift:90-110)."""
    with open(path) as f:
        data = json.load(f)
    names = data["names"]
    b = len(names)
    if len(data["parent"]) != b or len(data["translations"]) != b:
        raise ValueError(f"skeleton arrays do not match: {path}")
    pre = data.get("preRotationDegrees", [])
    if pre and len(pre) != b:
        raise ValueError(f"preRotationDegrees count mismatch: {path}")
    rig = data.get("rigProfile", {"name": "generic"})
    root = data.get("root", {"rule": "keep", "rotationFixDegrees": [0, 0, 0]})
    rule = _resolve_root_rule(root.get("rule", "keep"), rig.get("name", "generic"))
    fix = root.get("rotationFixDegrees", [0, 0, 0])
    if len(fix) < 3:
        fix = [0, 0, 0]
    return build_skeleton(
        names=names,
        parent=data["parent"],
        raw_translations=[t[:3] if len(t) >= 3 else [0, 0, 0] for t in data["translations"]],
        pre_rotation_degrees=[t[:3] if len(t) >= 3 else [0, 0, 0] for t in pre] if pre else [],
        unit_scale=data.get("unitScale", 1.0),
        root_rule=rule,
        root_fix_degrees=fix[:3],
        rig_name=rig.get("name", "generic"),
        alias_overrides=rig.get("aliases"),
    )
