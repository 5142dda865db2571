"""Frame pacing: pipeline_depth>1 presents the same images (shifted by the
warm-up), it must not corrupt or reorder frame content."""

import numpy as np
import pytest

from swift_game_engine_tpu.scene.demo_scene import DemoScene
from swift_game_engine_tpu.scene.engine import Engine
from swift_game_engine_tpu.scene.input import InputFrame


@pytest.fixture(scope="module")
def scene():
    return DemoScene(include_imported_assets=False).build()


def test_pipelined_frames_match(scene):
    W, H = 48, 27
    frames = {}
    for depth in (1, 3):
        eng = Engine(scene, width=W, height=H, path="rt", max_layers=1,
                     shadow_layers=0, pipeline_depth=depth)
        # settle with zero input: the player falls deterministically, and a
        # (depth-1)-frame-old camera snapshot equals the current one only
        # once motion stops — so compare the settled tail.
        out = [np.asarray(eng.frame(1.0 / 60.0, InputFrame(),
                                    with_overlay=False))
               for _ in range(72)]
        frames[depth] = out
        # the frame program's health counter: no NaN/inf in the float image
        assert eng.nonfinite_values == 0

    # depth-3 presents frame k at call k+2 (2 warm-up frames); the idle
    # animation keeps the scene evolving, so compare shifted frames in the
    # settled tail (where the lagged camera snapshot has converged).
    for k in (64, 67, 69):
        np.testing.assert_array_equal(frames[1][k], frames[3][k + 2])
    # warm-up frames are black, then real frames appear
    assert frames[3][0].max() == 0
    assert frames[3][5].max() > 0


def test_raster_pbr_path_matches_rt_no_bounce(scene):
    """path="raster_pbr" = the RT shading pipeline with bounce passes off:
    it renders, and it differs from the wrap-diffuse raster model."""
    W, H = 48, 27
    eng_pbr = Engine(scene, width=W, height=H, path="raster_pbr",
                     max_layers=2, shadow_layers=1)
    a = np.asarray(eng_pbr.frame(1.0 / 60.0, InputFrame(),
                                 with_overlay=False))
    assert a.max() > 0
    # the PBR raster must NOT equal the wrap-diffuse raster path (it
    # carries GGX/SH/IBL terms the fragment model lacks)
    eng_w = Engine(scene, width=W, height=H, path="raster", max_layers=2,
                   shadow_layers=1)
    b = np.asarray(eng_w.frame(1.0 / 60.0, InputFrame(), with_overlay=False))
    assert not np.array_equal(a, b)
