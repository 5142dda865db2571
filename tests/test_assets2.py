"""Tests for procedural meshes/textures, materials, static + skinned loaders."""

import numpy as np
import pytest

from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu.assets import procedural_textures as pt
from swift_game_engine_tpu.assets.materials import load_materials, Material
from swift_game_engine_tpu.assets.static_mesh import load_static_mesh
from swift_game_engine_tpu.assets.mesh_api import compute_tangents
from swift_game_engine_tpu.assets import player_rig

pytestmark = pytest.mark.fast


def _reference(name):
    """The reference project's own asset file, or skip (not in this repo)."""
    path = player_rig.reference_file(name)
    if path is None:
        pytest.skip(f"reference asset {name} not available "
                    f"(set ${player_rig.REFERENCE_DIR_ENV})")
    return path


def closed_surface_checks(mesh, allow_degenerate_frac=0.0):
    # Triangles non-degenerate (pole fans in lathed meshes collapse a few,
    # exactly as in the reference generators), normals unit length.
    tri = mesh.indices.reshape(-1, 3)
    p = mesh.positions
    e1 = p[tri[:, 1]] - p[tri[:, 0]]
    e2 = p[tri[:, 2]] - p[tri[:, 0]]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    frac = (areas <= 1e-9).mean()
    assert frac <= allow_degenerate_frac + 1e-9, f"degenerate fraction {frac}"
    n = np.linalg.norm(mesh.normals, axis=1)
    np.testing.assert_allclose(n, 1.0, atol=1e-4)


def test_plane():
    m = pm.plane(20.0)
    assert m.vertex_count == 4 and m.triangle_count == 2
    assert m.positions[:, 1].max() == 0
    assert abs(m.positions[:, 0]).max() == 10.0


def test_box():
    m = pm.box(4.0)
    assert m.vertex_count == 24 and m.triangle_count == 12
    closed_surface_checks(m)
    lo, hi = m.bounds()
    np.testing.assert_allclose(lo, [-2, -2, -2])
    np.testing.assert_allclose(hi, [2, 2, 2])


def test_tetra_prism_ramp():
    for m in (pm.tetrahedron(4.0), pm.triangular_prism(4.0, 3.0), pm.ramp(8, 8, 4)):
        closed_surface_checks(m)
    r = pm.ramp(8, 8, 4)
    # slope normal points up-forward (+y, +z)
    slope_n = r.normals[8 + 4]  # sloped-top quad is the 3rd face group
    assert r.triangle_count == 8


def test_dome():
    m = pm.dome(4.0, 32, 12)
    closed_surface_checks(m, allow_degenerate_frac=0.05)
    lo, hi = m.bounds()
    assert hi[1] == pytest.approx(4.0, abs=1e-5)
    assert lo[1] == pytest.approx(0.0, abs=1e-5)


def test_capsule_geometry():
    r, hh = 1.5, 1.0
    m = pm.capsule(r, hh, 24, 8)
    closed_surface_checks(m, allow_degenerate_frac=0.07)
    lo, hi = m.bounds()
    assert hi[1] == pytest.approx(hh + r, abs=1e-5)
    assert lo[1] == pytest.approx(-hh - r, abs=1e-5)
    radial = np.linalg.norm(m.positions[:, [0, 2]], axis=1)
    assert radial.max() == pytest.approx(r, abs=1e-5)
    # every vertex is within radius r of the core segment
    core_y = np.clip(m.positions[:, 1], -hh, hh)
    d = np.sqrt(radial ** 2 + (m.positions[:, 1] - core_y) ** 2)
    assert d.max() <= r + 1e-4


def test_humanoid_skinned():
    m = pm.humanoid_skinned()
    assert m.vertex_count > 0
    wsum = m.weights.sum(axis=1)
    np.testing.assert_allclose(wsum, 1.0, atol=1e-5)
    assert m.joints.max() <= 7


def test_skeleton_capsules():
    sk = player_rig.load_player_rig()[0]
    m = pm.skeleton_capsules(sk, radius=0.03)
    assert m.vertex_count > 1000
    np.testing.assert_allclose(m.weights.sum(axis=1), 1.0, atol=1e-4)
    assert m.joints.max() < sk.bone_count


def test_tangents():
    m = pm.box(2.0).with_tangents()
    assert m.tangents.shape == (24, 4)
    # tangent orthogonal to normal, unit length
    dots = (m.tangents[:, :3] * m.normals).sum(axis=1)
    np.testing.assert_allclose(dots, 0.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(m.tangents[:, :3], axis=1), 1.0, atol=1e-4)


# --- textures ---

def test_checkerboard():
    t = pt.checkerboard(64, 64, 16, 230, 40)
    assert t.pixels.shape == (64, 64, 4)
    assert t.pixels[0, 0, 0] == 230
    assert t.pixels[0, 16, 0] == 40
    assert t.pixels[16, 16, 0] == 230
    assert (t.pixels[..., 3] == 255).all()


def test_digits_atlas():
    t = pt.digits_atlas()
    assert t.pixels.shape == (12, 80, 4)
    # "1" glyph column: cell 1, has some lit pixels
    cell1 = t.pixels[:, 8:16]
    assert (cell1[..., 3] == 255).any()
    # "0" has a hole at glyph row 1 ("10001"): atlas row pad_y+1, col pad_x+2
    cell0 = t.pixels[:, 0:8]
    assert cell0[2 + 1, 1 + 2, 3] == 0


def test_metallic_roughness_packing():
    t = pt.metallic_roughness(metallic=1.0, roughness=0.5)
    px = t.pixels[0, 0]
    assert px[2] == 255  # B = metallic
    assert px[1] == 127  # G = roughness
    assert px[0] == 0


def test_normal_maps():
    t = pt.normal_map_from_height(64, 64, 1.0, 6.0)
    n = t.pixels[..., :3].astype(np.float32) / 255.0 * 2 - 1
    ln = np.linalg.norm(n, axis=-1)
    assert (np.abs(ln - 1.0) < 0.05).mean() > 0.99
    t2 = pt.normal_map_noise(32, 32)
    assert t2.pixels.shape == (32, 32, 4)
    t3 = pt.occlusion_grime(32, 32)
    assert t3.pixels[..., 0].min() >= 255 * (1 - 0.85) - 1


# --- materials + static mesh ---

def test_load_materials_ybot():
    mats = load_materials(_reference("YBot.materials.json"))
    assert "Alpha_Body_MAT" in mats
    m = mats["Alpha_Body_MAT"]
    assert m.metallic_factor == 0.0
    assert m.roughness_factor == pytest.approx(0.5527864)
    assert m.ior == 1.5
    joints = mats["Alpha_Joints_MAT"]
    assert joints.metallic_factor == 0.5


def test_load_materials_with_textures():
    mats = load_materials(_reference("ornate-mirror.materials.json"))
    assert len(mats) >= 1
    m = next(iter(mats.values()))
    # ornate mirror references diffuse/normal/ao textures next to the json
    if m.base_color_texture is not None:
        assert m.base_color_texture.pixels.ndim == 3
        assert m.base_color_texture.srgb


def test_load_static_mesh():
    asset = load_static_mesh(_reference("ornate_mirror.static.json"))
    assert len(asset.parts) == 1
    part = asset.parts[0]
    assert part.mesh.triangle_count == 42738 // 3
    assert len(part.collision_hulls) == 2
    assert part.transform.shape == (4, 4)
    for h in part.collision_hulls:
        assert h.triangle_count > 0
