"""DemoScene: the reference demo world, assembled for the engine.

Entity-for-entity rebuild of Game/DemoScene.swift:78-695 +
Game/CharacterFactory.swift:12-135:

  * 80x80 ground plane at y=-3 (muS .9/.8)
  * imported static assets: 17-Cheese, Semla (+18,0,10, layer 1<<3), ornate
    mirror (-10,1,4, scale 8, layer 1<<4) — render parts + translucent
    collision-hull entities; assets missing from the bundle are skipped with
    a diagnostic, exactly like the reference
  * elevator + horizontal kinematic platforms (box 4, scale (1.5,.2,1.5))
  * oscillating NPC capsule (mass 500), 3 separation-test NPCs
  * player: physics body + controller (r 1.5, hh 1.0) + agent(mass 3) +
    locomotion profiles (runEnter 6/exit 5, fallMinDrop 50, idleExit 0.3) +
    dodge action (34 frames @sample_fps, distance 8) + skinned mesh group +
    translucent capsule overlay following the player
  * red mirror-test wall (roughness 0.02), blue flattenGround ramp, green
    dome, emissive step, FPS overlay, 2 directional lights

The player's skeleton and motion profiles come from
``assets.player_rig``: derived from ``assets/YBot.skinned.json`` with
synthetic profiles, unless ``asset_dir`` holds the reference's own files.
Without a skinned mesh the body falls back to the procedural
skeleton-capsule skin (ProceduralMeshes.skeletonCapsules).
"""

from __future__ import annotations

import os
from ..config import knob
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..assets import procedural_meshes as pm
from ..assets import procedural_textures as pt
from ..assets.materials import Material, load_materials
from ..assets.mesh_api import MeshDescriptor
from ..assets.static_mesh import load_static_mesh
from ..assets.motion_profile import pack_profile
from ..assets.player_rig import load_player_rig, reference_game_dir
from ..assets.skinned_mesh import load_skinned_mesh, dense_weight_matrix
from ..ecs.world import WorldBuilder, BODY_STATIC, BODY_KINEMATIC, BODY_DYNAMIC
from ..physics.collision_world import CollisionWorldBuilder
from ..anim.pose import PoseEngine
from ..render.scene_geometry import RenderGeometryBuilder
from ..render.rt import DirectionalLights
from .step import Stepper

GROUND_Y = -3.0


def _solid_mat(name, rgb, roughness, metallic=0.0, alpha=1.0, unlit=False,
               emissive=(0, 0, 0), emissive_factor=None):
    """Materials the reference builds from 4x4 solid procedural textures —
    folded into factors here (identical shading inputs)."""
    return Material(name=name,
                    base_color_factor=tuple(np.asarray(rgb, np.float32) / 255.0),
                    metallic_factor=metallic, roughness_factor=roughness,
                    alpha=alpha, unlit=unlit,
                    emissive_factor=tuple(emissive_factor or (0.0, 0.0, 0.0)))


@dataclass
class DemoScene:
    """Builds (spec, state, stepper, geometry, camera defaults, lights)."""

    # The reference project's Game/ directory, when one is at hand: its
    # skeleton, motion profiles, materials and mirror asset are used where
    # present. None = the repository's own assets only.
    asset_dir: Optional[str] = field(default_factory=reference_game_dir)
    # Generated assets (tools/fbx_to_*.py output) searched first.
    generated_dir: str = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      "..", "..", "assets")
    include_imported_assets: bool = True
    # Render-mesh triangle budget per imported part (SGE_IMPORT_TRI_BUDGET=0
    # disables decimation: full fidelity). Collision always uses the exact
    # hulls regardless.
    import_tri_budget: int = knob("SGE_IMPORT_TRI_BUDGET") or (1 << 30)
    # Pad the entity table with dormant slots to a multiple of this count
    # (entity-axis sharding needs divisible leading dims; 0/1 = no pad).
    pad_entities_to: int = 1

    def build(self):
        """Assemble the scene. The build is hundreds of small eager array
        ops, so it is staged on the host CPU device; the finished arrays
        then move to the default device in one bulk transfer. Jitted frame
        programs close over the geometry (texture_usage needs it concrete),
        and a device-resident capture keeps those arrays out of the
        compiled program as literals."""
        import contextlib
        import jax
        ctx = contextlib.nullcontext()
        on_accel = jax.default_backend() != "cpu"
        if on_accel:
            ctx = jax.default_device(jax.devices("cpu")[0])
        with ctx:
            scene = self._build_impl()
        if on_accel:
            dev = jax.devices()[0]
            scene = jax.tree.map(
                lambda x: jax.device_put(x, dev) if isinstance(x, jax.Array)
                else x, scene)
            # the stepper closes over its own arrays (collision soup, pose
            # bank ...) — move those too
            scene["stepper"] = scene["stepper"].device_put(dev)
        return scene

    def _build_impl(self):
        wb = WorldBuilder()
        cb = CollisionWorldBuilder()
        rb = RenderGeometryBuilder(texture_size=knob("SGE_TEX_SIZE"))

        def add_static(e, mesh: MeshDescriptor, surface=(0.8, 0.6, False),
                       layer=1, collision_mesh=None, transform_scale=None):
            src = collision_mesh if collision_mesh is not None else mesh
            pos = src.positions if transform_scale is None else src.positions * transform_scale
            cb.add_mesh(pos, src.indices, entity=e, mu_s=surface[0],
                        mu_k=surface[1], flatten=bool(surface[2]), layer=layer)

        # --- lights (DemoScene.swift:88-99)
        lights = DirectionalLights(
            direction=jnp.array([[0.6, -0.7, -0.1], [-0.3, -0.6, 0.6]]),
            intensity=jnp.array([2.0, 0.4]),
            color=jnp.array([[1.0, 0.86, 0.68], [0.95, 0.85, 0.75]]),
            enabled=jnp.array([True, True]),
            max_distance=jnp.array([450.0, 300.0]))

        # --- ground
        ground = wb.create_entity("ground")
        ground_mesh = pm.plane(80.0)
        wb.add(ground, "transform", translation=[0, GROUND_Y, 0])
        wb.add(ground, "world_position")
        wb.add(ground, "body", body_type=BODY_STATIC, position=[0, GROUND_Y, 0])
        add_static(ground, ground_mesh, surface=(0.9, 0.8, False))
        rb.add_static_mesh(ground_mesh, _solid_mat("GroundMat", (80, 80, 80), 0.8),
                           instance=ground)

        # --- imported static assets
        if self.include_imported_assets:
            self._add_imported(wb, cb, rb, "17-Cheese.static.json",
                               "17-Cheese.materials.json", offset=(0, 0, 0),
                               layer=1, hull_color=(80, 180, 255))
            self._add_imported(wb, cb, rb, "Semla.static.json",
                               "Semla.materials.json", offset=(18, 0, 10),
                               layer=1 << 3, hull_color=(120, 220, 180))
            self._add_imported(wb, cb, rb, "ornate_mirror.static.json",
                               "ornate-mirror.materials.json", offset=(-10, 1, 4),
                               layer=1 << 4, hull_color=(200, 160, 255),
                               scale=8.0, upright_flip=True)

        # --- kinematic platforms
        plat_mesh = pm.box(4.0)
        plat_scale = np.array([1.5, 0.2, 1.5], np.float32)
        local_aabb = (plat_mesh.positions * plat_scale)
        aabb_min, aabb_max = local_aabb.min(axis=0), local_aabb.max(axis=0)
        for name, pos, axis, amp, speed, phase, color in (
                ("elevator", [16, -1.0, 0], [0, 1, 0], 2.0, 1.1, 0.0, (120, 200, 255)),
                ("ground_mover", [-16, -2.0, 12], [1, 0, 0], 4.0, 0.9, 0.7, (160, 255, 140))):
            e = wb.create_entity(name)
            wb.add(e, "transform", translation=pos, scale=plat_scale)
            wb.add(e, "world_position")
            wb.add(e, "body", body_type=BODY_KINEMATIC, position=pos)
            wb.add(e, "platform", origin=pos, axis=axis, amplitude=amp,
                   speed=speed, phase=phase, aabb_min=aabb_min, aabb_max=aabb_max)
            add_static(e, plat_mesh, surface=(0.9, 0.7, False))
            rb.add_static_mesh(plat_mesh, _solid_mat(f"{name}Mat", color, 0.6),
                               instance=e)

        # --- oscillating NPC capsule (DemoScene.swift:457-500)
        cap_mesh = pm.capsule(1.5, 1.0)
        osc = wb.create_entity("osc_npc")
        osc_pos = [24.0, GROUND_Y + 2.5 + 2.0, 16.0]
        wb.add(osc, "transform", translation=osc_pos)
        wb.add(osc, "world_position")
        wb.add(osc, "body", body_type=BODY_DYNAMIC, position=osc_pos)
        wb.add(osc, "intent")
        wb.add(osc, "movement", max_acceleration=14.0, max_deceleration=28.0)
        wb.add(osc, "controller", radius=1.5, half_height=1.0, skin_width=0.3,
               ground_snap_skin=0.05)
        wb.add(osc, "agent", mass_weight=500.0)
        wb.add(osc, "oscillate", origin=osc_pos, axis=[1, 0, 0], amplitude=6.0,
               speed=0.6)
        rb.add_static_mesh(cap_mesh, _solid_mat("KinematicCapsuleMat",
                                                (220, 120, 255), 0.5, alpha=0.2),
                           instance=osc)

        # --- player (CharacterFactory.swift:12-135)
        player, pose_engine, bank, action_prof = self._add_player(wb, rb)

        # --- separation-test NPCs
        for i, pos in enumerate([[-16.0, 0.9, 12.0], [8.0, 3.5, -2.5],
                                 [0.0, 5.5, -10.0]]):
            e = wb.create_entity(f"npc_{i}")
            wb.add(e, "transform", translation=pos)
            wb.add(e, "world_position")
            wb.add(e, "body", body_type=BODY_DYNAMIC, position=pos)
            wb.add(e, "controller", radius=1.5, half_height=1.0, skin_width=0.3,
                   ground_snap_skin=0.05)
            wb.add(e, "agent", mass_weight=1.0)
            rb.add_static_mesh(cap_mesh, _solid_mat("NPCMat", (255, 180, 80),
                                                    0.5, alpha=0.2), instance=e)

        # --- test wall (mirror-smooth red)
        wall = wb.create_entity("test_wall")
        wall_mesh = pm.box(6.0)
        wb.add(wall, "transform", translation=[0, 0, -10])
        wb.add(wall, "world_position")
        wb.add(wall, "body", body_type=BODY_STATIC, position=[0, 0, -10])
        add_static(wall, wall_mesh)
        rb.add_static_mesh(wall_mesh,
                           _solid_mat("WallMat", (255, 80, 80), 0.02, metallic=1.0),
                           instance=wall)

        # --- flattenGround ramp
        ramp = wb.create_entity("test_ramp")
        ramp_mesh = pm.ramp(8.0, 10.0, 4.0)
        ramp_pos = [8, GROUND_Y + 2.0, 0]
        wb.add(ramp, "transform", translation=ramp_pos)
        wb.add(ramp, "world_position")
        wb.add(ramp, "body", body_type=BODY_STATIC, position=ramp_pos)
        add_static(ramp, ramp_mesh, surface=(0.35, 0.25, True))
        rb.add_static_mesh(ramp_mesh, _solid_mat("RampMat", (80, 160, 255), 0.6),
                           instance=ramp)

        # --- dome
        dome = wb.create_entity("test_dome")
        dome_mesh = pm.dome(4.0, 12, 6)
        wb.add(dome, "transform", translation=[-10, GROUND_Y, -6])
        wb.add(dome, "world_position")
        wb.add(dome, "body", body_type=BODY_STATIC, position=[-10, GROUND_Y, -6])
        add_static(dome, dome_mesh, surface=(0.3, 0.2, False))
        rb.add_static_mesh(dome_mesh, _solid_mat("DomeMat", (120, 200, 140), 0.5),
                           instance=dome)

        # --- emissive step
        step = wb.create_entity("test_step")
        step_mesh = pm.box(2.0)
        wb.add(step, "transform", translation=[-6, -2, 4])
        wb.add(step, "world_position")
        wb.add(step, "body", body_type=BODY_STATIC, position=[-6, -2, 4])
        add_static(step, step_mesh)
        rb.add_static_mesh(step_mesh,
                           _solid_mat("StepMat", (255, 220, 120), 0.8,
                                      emissive_factor=(2.5, 2.0, 1.2)),
                           instance=step)

        # Pad the entity table to a device-count multiple with dormant
        # slots: entity-axis sharding (parallel.sharding.shard_world_state)
        # device_puts concrete arrays, which requires divisibility. Dormant
        # slots are skipped by every system (alive mask) and reusable by
        # runtime spawn_entity.
        if self.pad_entities_to > 1:
            while wb.n % self.pad_entities_to:
                wb.create_entity(alive=False)
        spec, state = wb.build()
        collision = cb.build()
        geometry = rb.build()
        stepper = Stepper(spec, collision, pose_engine, bank, action_prof,
                          inv_bind_override=self._inv_bind_override)
        return dict(spec=spec, state=state, stepper=stepper, geometry=geometry,
                    lights=lights, player=player, collision=collision,
                    pose_engine=pose_engine)

    # ------------------------------------------------------------------

    def _asset(self, name):
        gen = os.path.join(self.generated_dir, name)
        if os.path.exists(gen) or not self.asset_dir:
            return gen
        return os.path.join(self.asset_dir, name)

    def _add_imported(self, wb, cb, rb, static_name, materials_name, offset,
                      layer, hull_color, scale=None, upright_flip=False):
        path = self._asset(static_name)
        if not os.path.exists(path):
            print(f"DemoScene: missing static mesh asset: {static_name}")
            return
        asset = load_static_mesh(path)
        materials = load_materials(self._asset(materials_name)) \
            if os.path.exists(self._asset(materials_name)) else {}
        fallback = Material(name="fallback")
        hull_mat = _solid_mat("CollisionMat", hull_color, 0.5, alpha=0.25, unlit=True)

        for part in asset.parts:
            # part transform decomposition + scene placement
            # (DemoScene.swift:718-735 + per-asset offset/scale/rotation).
            m = part.transform.copy()
            t = m[:3, 3].copy()
            basis = m[:3, :3]
            s = np.linalg.norm(basis, axis=0)
            s = np.where(s > 0, s, 1.0)
            rot3 = basis / s
            from ..assets.nputil import quat_from_mat
            m4 = np.eye(4, dtype=np.float32)
            m4[:3, :3] = rot3
            q = quat_from_mat(m4)
            if upright_flip:
                # rotation * (upright 90deg X) * (flip 180deg X)
                from .. import math3d as m3
                upright = np.asarray(m3.quat_from_axis_angle(np.pi * 0.5, jnp.array([1.0, 0, 0])))
                flip = np.asarray(m3.quat_from_axis_angle(np.pi, jnp.array([1.0, 0, 0])))
                q = np.asarray(m3.quat_mul(jnp.asarray(q),
                                           m3.quat_mul(jnp.asarray(upright),
                                                       jnp.asarray(flip))))
            if scale is not None:
                s = s * scale
            t = t + np.asarray(offset, np.float32)

            e = wb.create_entity(f"{static_name}:{part.name}")
            wb.add(e, "transform", translation=t, rotation=q, scale=s)
            wb.add(e, "world_position")
            mesh = part.mesh
            if mesh.triangle_count > self.import_tri_budget and \
                    len(part.submeshes) == 1:
                from ..assets.mesh_api import simplify_mesh
                mesh = simplify_mesh(mesh.with_tangents() if mesh.uvs is not None
                                     and mesh.normals is not None else mesh,
                                     self.import_tri_budget)
                sub0 = part.submeshes[0]
                rb.add_static_mesh(mesh, materials.get(sub0.material, fallback),
                                   instance=e)
            else:
                for sub in part.submeshes:
                    mat = materials.get(sub.material, fallback)
                    rb.add_static_mesh(mesh, mat, instance=e,
                                       tri_range=(sub.start, sub.count))
            for i, hull in enumerate(part.collision_hulls):
                he = wb.create_entity(f"{static_name}:{part.name}:hull{i}")
                wb.add(he, "transform", translation=t, rotation=q, scale=s)
                wb.add(he, "world_position")
                wb.add(he, "body", body_type=BODY_STATIC, position=t, rotation=q)
                cb.add_mesh(hull.positions, hull.indices, entity=he,
                            mu_s=0.6, mu_k=0.5, layer=layer)
                rb.add_static_mesh(hull, hull_mat, instance=he)

    def _add_player(self, wb, rb):
        skeleton, profiles = load_player_rig(self.asset_dir)
        engine = PoseEngine(skeleton)
        bank = engine.make_bank(pack_profile(profiles["Idle"], skeleton),
                                pack_profile(profiles["Walking"], skeleton),
                                pack_profile(profiles["Running"], skeleton),
                                pack_profile(profiles["FallingIdle"], skeleton))
        action = engine.make_action(
            pack_profile(profiles["StandingDodgeBackward"], skeleton))

        e = wb.create_entity("player")
        start = [0.0, GROUND_Y + 2.5 + 8.0, 0.0]
        wb.add(e, "transform", translation=start)
        wb.add(e, "world_position")
        wb.add(e, "player")
        wb.add(e, "body", body_type=BODY_DYNAMIC, position=start)
        wb.add(e, "intent")
        wb.add(e, "movement", max_acceleration=20.0, max_deceleration=36.0)
        wb.add(e, "controller", radius=1.5, half_height=1.0, skin_width=0.3,
               ground_snap_skin=0.05)
        wb.add(e, "agent", mass_weight=3.0)
        wb.add(e, "motion_profile", playback_rate=1.0, loop=True, in_place=True)
        wb.add(e, "locomotion", idle_enter_speed=0.15, idle_exit_speed=0.3,
               run_enter_speed=6.0, run_exit_speed=5.0, fall_min_drop_height=50.0)
        dodge_prof = profiles["StandingDodgeBackward"]
        fps = max(dodge_prof.sample_fps, 1)
        end_time = 34.0 / fps
        wb.add(e, "action", cycle=dodge_prof.cycle, blend_in=0.08, blend_out=0.18)
        wb.add(e, "dodge", duration=end_time, distance=8.0, start_time=0.0,
               end_time=end_time)
        wb.add(e, "character", slot=0, bone_count=skeleton.bone_count)

        # Skinned body: YBot.skinned.json if present, else the procedural
        # skeleton-capsule skin (keeps the full LBS path active).
        skinned_path = self._asset("YBot.skinned.json")
        ybot_mats = load_materials(self._asset("YBot.materials.json")) \
            if os.path.exists(self._asset("YBot.materials.json")) else {}
        self._inv_bind_override = None
        if os.path.exists(skinned_path):
            from ..assets.mesh_api import simplify_skinned
            sm = load_skinned_mesh(skinned_path, skeleton)
            budget = self.import_tri_budget
            for s in sm.submeshes:
                mat = ybot_mats.get(s.material, Material(name=s.material))
                idx = sm.indices[s.start:s.start + s.count]
                used = np.unique(idx)
                remap = np.full(sm.vertex_count, -1, np.int64)
                remap[used] = np.arange(len(used))
                part_target = max(int(budget * s.count / len(sm.indices)), 2000)
                pos, nrm, uv, tri, j4, w4 = simplify_skinned(
                    sm.positions[used], sm.normals[used], sm.uvs[used],
                    remap[idx].astype(np.int32), sm.joints[used],
                    sm.weights[used], part_target)
                dense = dense_weight_matrix(j4, w4, skeleton.bone_count)
                rb.add_skinned_mesh(pos, nrm, uv, tri, dense, [mat],
                                    [(0, len(tri))], instance=e, character=0,
                                    inv_bind_override=sm.inv_bind_model)
            self._inv_bind_override = sm.inv_bind_model[None]  # (1,B,4,4)
        else:
            print("DemoScene: missing YBot.skinned.json — using skeletonCapsules body")
            sk_mesh = pm.skeleton_capsules(skeleton, radius=0.05)
            dense = dense_weight_matrix(sk_mesh.joints, sk_mesh.weights,
                                        skeleton.bone_count)
            body_mat = ybot_mats.get("Alpha_Body_MAT", _solid_mat(
                "YBotBody", (25, 107, 133), 0.55))
            rb.add_skinned_mesh(sk_mesh.positions, sk_mesh.normals, sk_mesh.uvs,
                                sk_mesh.indices, dense, [body_mat],
                                [(0, len(sk_mesh.indices))], instance=e,
                                character=0)

        # translucent capsule overlay following the player
        overlay = wb.create_entity("player_overlay")
        wb.add(overlay, "transform", translation=start)
        wb.add(overlay, "follow", target=e)
        rb.add_static_mesh(pm.capsule(1.5, 1.0),
                           _solid_mat("PlayerCapsuleOverlayMat", (120, 160, 255),
                                      0.4, alpha=0.2), instance=overlay)
        return e, engine, bank, action
