"""rtResolutionScale: RT target renders at scale, composites to view size.

Reference: Renderer.swift:232-258 reallocates the RT target at
rtResolutionScale (min 0.25) and composites it onto the FULL-size drawable
via a fullscreen quad — so Engine(rt_resolution_scale=s) must return
(height, width, 3) frames for every s, warm-up frames included.
"""

import numpy as np
import pytest

from swift_game_engine_tpu.scene.demo_scene import DemoScene
from swift_game_engine_tpu.scene.engine import Engine
from swift_game_engine_tpu.scene.input import InputFrame


@pytest.fixture(scope="module")
def scene():
    return DemoScene(include_imported_assets=False).build()


def test_half_scale_frames_are_view_sized(scene):
    W, H = 64, 36
    eng = Engine(scene, width=W, height=H, path="rt", max_layers=1,
                 shadow_layers=0, rt_resolution_scale=0.5, pipeline_depth=2)
    assert eng.rt_size == (32, 18)
    for i in range(4):
        u8 = eng.frame(1.0 / 60.0, InputFrame(), with_overlay=(i == 3))
        assert u8.shape == (H, W, 3), f"frame {i}: {u8.shape}"
    assert u8.max() > 0  # post warm-up frame has content


def test_quarter_scale_clamp(scene):
    # Renderer.swift:175 clamps the scale at 0.25.
    W, H = 64, 36
    eng = Engine(scene, width=W, height=H, path="rt", max_layers=1,
                 shadow_layers=0, rt_resolution_scale=0.1)
    assert eng.rt_size == (16, 9)
    u8 = eng.frame(1.0 / 60.0, InputFrame(), with_overlay=False)
    assert u8.shape == (H, W, 3)


def test_half_scale_approximates_full(scene):
    """Upscaled half-res frame is a blurred version of the full-res frame,
    not garbage: mean intensity within a loose band."""
    W, H = 64, 36
    full = Engine(scene, width=W, height=H, path="rt", max_layers=1,
                  shadow_layers=0)
    half = Engine(scene, width=W, height=H, path="rt", max_layers=1,
                  shadow_layers=0, rt_resolution_scale=0.5)
    a = np.asarray(full.frame(1.0 / 60.0, InputFrame(), with_overlay=False),
                   np.float64)
    b = np.asarray(half.frame(1.0 / 60.0, InputFrame(), with_overlay=False),
                   np.float64)
    assert abs(a.mean() - b.mean()) < 8.0


def test_runtime_scale_change(scene):
    """Changing rtResolutionScale at
    runtime rebuilds the frame program for the new RT size (lazily, cached
    per size) without constructing a new Engine — the reference reallocates
    its RT target when the scene's scale changes (Renderer.swift:232-258)."""
    W, H = 64, 36
    eng = Engine(scene, width=W, height=H, path="rt", max_layers=1,
                 shadow_layers=0, rt_resolution_scale=1.0)
    u8_full = eng.frame(1.0 / 60.0, InputFrame(), with_overlay=False)
    assert eng.rt_size == (W, H) and u8_full.shape == (H, W, 3)

    eng.set_rt_resolution_scale(0.5)
    assert eng.rt_size == (32, 18)
    for _ in range(2):
        u8_half = eng.frame(1.0 / 60.0, InputFrame(), with_overlay=False)
        assert u8_half.shape == (H, W, 3)
    assert u8_half.max() > 0

    # switching BACK reuses the cached program (no rebuild)
    fused_half = eng._fused
    eng.set_rt_resolution_scale(1.0)
    assert eng.rt_size == (W, H)
    eng.set_rt_resolution_scale(0.5)
    assert eng._fused is fused_half
    u8 = eng.frame(1.0 / 60.0, InputFrame(), with_overlay=False)
    assert u8.shape == (H, W, 3)
