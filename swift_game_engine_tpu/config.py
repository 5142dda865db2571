"""Engine configuration: every tuned knob in ONE dataclass (SURVEY §5's
config directive — the reference's configuration surface is constructor
defaults + RendererConstants; ours is this tree). Environment variables
named after each field remain overrides for experiments, read once at
import through :func:`knob`.

The module comments at each point of use say what each knob selects.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class RenderConfig:
    """RT/raster pipeline knobs (render.rt, render.raster, scene)."""

    # --- shading / compaction ----------------------------------------------
    SGE_RT_CHUNK: int = 131072
    SGE_RT_CHUNK_SMALL: int = 8192
    SGE_RT_CHUNK_BOUNCE: int = 16384
    SGE_RT_SORT_COMPACT: int = 1
    SGE_RT_COMPACT_ORDER: str = "sort"
    SGE_RT_UNLIT: int = 1
    SGE_RT_SROW: int = 1

    # --- scene --------------------------------------------------------------
    # 0 disables import decimation (full fidelity); the default decimates
    # each imported part to this many render triangles.
    SGE_IMPORT_TRI_BUDGET: int = 20000
    SGE_TEX_SIZE: int = 512


@dataclass(frozen=True)
class PhysicsConfig:
    """Physics/separation knobs (physics.separation, physics.queries)."""

    SGE_SEP_GRID_MIN_N: int = 64         # dense all-pairs below this
    SGE_SEP_CELL_CAP: int = 12           # sorted-window entries per cell
    SGE_SEP_FORCE_GRID: int = 0


@dataclass(frozen=True)
class EngineDefaults:
    render: RenderConfig = field(default_factory=RenderConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)


DEFAULTS = EngineDefaults()

_FLAT = {}
for _section in (DEFAULTS.render, DEFAULTS.physics):
    for _k, _v in vars(_section).items():
        _FLAT[_k] = _v


def knob(name: str, default=None):
    """Read config value ``name``: environment override if set, else the
    dataclass default (``default`` overrides the dataclass when given —
    for call sites that predate a field)."""
    base = _FLAT.get(name, default)
    raw = os.environ.get(name)
    if raw is None:
        return base
    if isinstance(base, bool):
        return raw == "1"
    if isinstance(base, int):
        return int(raw)
    if isinstance(base, float):
        return float(raw)
    if base is None:
        # knob not in the dataclass (debug/profiling-only): numeric strings
        # parse as ints so `bool(knob("X"))` honors X=0
        try:
            return int(raw)
        except ValueError:
            return raw
    return raw
