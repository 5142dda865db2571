"""Engine: the host frame loop tying simulation to rendering.

Equivalent of Renderer.draw(in:) + DemoScene.update
(reference: Game/Renderer.swift:156-225, Game/DemoScene.swift:697-712):
dt clamp <= 0.1, time accumulation with <= 4 fixed substeps at 60 Hz,
input -> intents, substeps, chase camera, render extraction, then the
RT (or raster) frame + composite + FPS overlay.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ecs.world import chunk_local_to_world
from ..render.camera import Camera
from ..render.scene_geometry import flatten_frame
from ..render import rt as RT
from ..render.raster import render_frame_raster
from ..render.composite import composite_frame, FPSOverlay, overlay_blit_device
from ..render.ibl import IBL
from .input import InputSystem, InputFrame

FIXED_DT = 1.0 / 60.0
MAX_SUBSTEPS = 4


def save_world_state(path: str, state, **scalars):
    """Checkpoint a WorldState pytree (+ host scalars) to one .npz."""
    flat, _ = jax.tree.flatten(state)
    np.savez(path, *[np.asarray(x) for x in flat], **scalars)


def load_world_state(path: str, like_state):
    """Restore a WorldState saved by save_world_state.

    ``like_state`` provides the pytree structure. Returns (state, npz_data)
    so callers can read back their scalars.
    """
    data = np.load(path)
    flat, treedef = jax.tree.flatten(like_state)
    arrays = [jnp.asarray(data[f"arr_{i}"]) for i in range(len(flat))]
    return jax.tree.unflatten(treedef, arrays), data


class Engine:
    def __init__(self, scene: dict, width=640, height=360, path="rt",
                 rt_resolution_scale=1.0, max_layers=3, shadow_layers=4,
                 pipeline_depth: int = 1):
        # pipeline_depth > 1 keeps that many frame dispatches in flight and
        # returns the oldest completed frame (the reference's
        # maxBuffersInFlight=3 frame pacing, RendererConstants.swift:13):
        # the image fetch of frame N-1 then overlaps the device computing
        # frame N, and the chase camera reads a (depth-1)-frame-old player
        # snapshot exactly as the reference CPU writes uniforms while older
        # frames are still on the GPU.
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._pending = []
        self.spec = scene["spec"]
        self.state = scene["state"]
        self.stepper = scene["stepper"]
        self.geometry = scene["geometry"]
        self.lights = scene["lights"]
        self.player = scene["player"]
        self.width = width
        self.height = height
        self.path = path
        self.rt_scale = max(rt_resolution_scale, 0.25)  # Renderer.swift:175
        self.camera = Camera()
        self.camera.position = np.array([0.0, 0.0, 8.0], np.float32)
        self.input = InputSystem()
        self.ibl = IBL.build()
        self.overlay = FPSOverlay()
        self.accumulator = 0.0
        # TimeComponent bookkeeping (Components.swift:512-534 /
        # TimeSystem, Systems.swift:24-49): `time` advances by dt *
        # time_scale, `unscaled_time` by raw dt; the fixed-step
        # accumulator consumes SCALED time (FixedStepRunner,
        # Systems.swift:65-93), so time_scale=0 freezes simulation while
        # input/camera/overlay — driven by unscaled dt — keep animating.
        self.time = 0.0
        self.unscaled_time = 0.0
        self.time_scale = 1.0
        self.delta_time = 0.0
        self.unscaled_delta_time = 0.0
        self.frame_index = 0
        self.tone_mapping_enabled = True
        self.tone_mapping_exposure = 1.0
        # NaN/inf values in the float image of the last presented frame.
        self.nonfinite_values = 0
        self._max_layers = max_layers
        self._shadow_layers = shadow_layers
        self._snap = None

        self._program_cache = {}
        self._build_programs()

    def set_rt_resolution_scale(self, scale: float):
        """Runtime rtResolutionScale change (Renderer.swift:232-258: the
        reference reallocates the RT target when the scene's scale changes).
        Under jit the RT size is a static shape, so each distinct size is a
        distinct executable — built lazily on first use and cached on the
        Engine (plus the persistent compile cache across runs), so toggling
        between scales after warm-up costs no recompilation."""
        scale = max(float(scale), 0.25)  # Renderer.swift:175
        if scale == self.rt_scale:
            return
        self.rt_scale = scale
        # in-flight frames belong to the old program's shapes
        self._pending.clear()
        self._snap = None
        self._build_programs()

    def _build_programs(self):
        """(Re)build the jitted frame programs for the current rt_scale."""
        width, height = self.width, self.height
        path = self.path
        max_layers, shadow_layers = self._max_layers, self._shadow_layers
        geo = self.geometry
        lights = self.lights
        ibl = self.ibl
        rw = max(int(width * self.rt_scale), 1)
        rh = max(int(height * self.rt_scale), 1)
        self.rt_size = (rw, rh)
        cached = self._program_cache.get((rw, rh))
        if cached is not None:
            (self._fused, self._fetch_player_init, self.graph) = cached
            return

        def _upscale(img):
            """RT target -> drawable size, bilinear — the reference samples
            the rtResolutionScale-sized RT texture from a fullscreen quad
            onto the full drawable (Renderer.swift:232-258, 260-290). The
            tone map runs after sampling, per drawable pixel, like the
            composite fragment shader."""
            if (rw, rh) == (width, height):
                return img
            return jax.image.resize(img, (height, width, img.shape[-1]),
                                    method="bilinear")

        # path="raster_pbr" (SURVEY §2.7 directive): full-PBR raster of
        # scene items — the RT material model (GGX direct + alpha-filtered
        # shadows + SH ambient + split-sum IBL) minus the bounce passes a
        # raster pipeline has no rays for. Implementation IS the RT shading
        # path with bounces disabled, so shading parity with the RT path
        # holds by construction. path="raster" remains the reference-parity
        # wrap-diffuse fragment model (ShadersRaster.metalinc:56-101).
        bounce = path == "rt"
        pbr = path in ("rt", "raster_pbr")

        @jax.jit
        def _render_rt(transforms, palettes, ivp, cam_pos):
            fg = flatten_frame(geo, transforms, palettes)
            img = RT.render_frame(geo, fg, ibl, lights, ivp, cam_pos, rw, rh,
                                  max_layers=max_layers,
                                  shadow_layers=shadow_layers,
                                  enable_mirror=bounce,
                                  enable_refraction=bounce)
            return _upscale(img)

        @jax.jit
        def _render_raster(transforms, palettes, ivp, cam_pos):
            fg = flatten_frame(geo, transforms, palettes)
            return _upscale(render_frame_raster(geo, fg, ivp, cam_pos, rw, rh))

        comp = jax.jit(lambda img, exposure: composite_frame(img, exposure, True))

        # Frame passes through the render graph (prune + dependency sort —
        # the reference's RenderGraph semantics, Game/RenderGraph.swift:183-368).
        from ..render.graph import RenderGraph, RenderPass
        self.graph = RenderGraph()
        render_fn = _render_rt if pbr else _render_raster

        def rt_pass(res):
            return {"rt_output": render_fn(res["transforms"], res["palettes"],
                                           res["ivp"], res["cam_pos"])}

        def composite_pass(res):
            img = res["rt_output"]
            if pbr and self.tone_mapping_enabled:
                img = comp(img, res["exposure"])
            return {"view": img}

        self.graph.add_pass(RenderPass("rt", rt_pass,
                                       reads=("transforms", "palettes", "ivp",
                                              "cam_pos"),
                                       writes=("rt_output",)))
        self.graph.add_pass(RenderPass("composite", composite_pass,
                                       reads=("rt_output", "exposure"),
                                       target="view"))

        # -- fused frame program ------------------------------------------
        # The per-frame pipeline (intent -> substeps -> extract -> flatten ->
        # render -> composite -> u8 quantize -> player snapshot) is traced
        # into ONE program: one dispatch + one small host read per frame. The chase camera consumes the previous
        # frame's player snapshot (one-frame lag, invisible through the
        # smoothed third-person camera). Substep count is a traced scalar
        # (fori_loop), so 0..MAX_SUBSTEPS frames share one executable.
        e = self.player
        stepper = self.stepper
        tone_on = pbr  # composite applies when tone mapping enabled

        @jax.jit
        def _fused(state, vel, yaw, has_yaw, jump, dodge, n_substeps, alpha,
                   ivp, cam_pos, cam_world, exposure, fps):
            state = state._replace(
                intent_vel=state.intent_vel.at[e].set(vel),
                intent_yaw=state.intent_yaw.at[e].set(yaw),
                intent_has_yaw=state.intent_has_yaw.at[e].set(has_yaw),
                intent_jump=state.intent_jump.at[e].set(state.intent_jump[e] | jump),
                intent_dodge=state.intent_dodge.at[e].set(state.intent_dodge[e] | dodge))
            state = jax.lax.fori_loop(
                0, n_substeps,
                lambda _, s: stepper._substep_impl(s, jnp.float32(FIXED_DT)),
                state)
            transforms, palettes = stepper._extract(state, alpha, cam_world)
            fg = flatten_frame(geo, transforms, palettes)
            if pbr:
                img = RT.render_frame(geo, fg, ibl, lights, ivp, cam_pos,
                                      rw, rh, max_layers=max_layers,
                                      shadow_layers=shadow_layers,
                                      enable_mirror=bounce,
                                      enable_refraction=bounce)
                img = _upscale(img)
                if tone_on:
                    img = composite_frame(img, exposure, True)
            else:
                img = _upscale(render_frame_raster(geo, fg, ivp, cam_pos,
                                                   rw, rh))
            # Health counter: u8 quantization would hide NaN/inf pixels.
            nonfinite = jnp.sum(~jnp.isfinite(img)).astype(jnp.float32)
            u8 = (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)
            # UIPass: FPS digits composited in-device (fps < 0 disables).
            u8 = overlay_blit_device(u8, fps)
            prev = chunk_local_to_world(state.wp_prev_chunk[e],
                                        state.wp_prev_local[e])
            curr = chunk_local_to_world(state.wp_chunk[e], state.wp_local[e])
            snap = jnp.concatenate([
                prev.astype(jnp.float32), curr.astype(jnp.float32),
                state.dodge.active[e].astype(jnp.float32)[None],
                nonfinite[None]])
            return state, u8, snap

        @jax.jit
        def _fetch0(state):
            prev = chunk_local_to_world(state.wp_prev_chunk[e],
                                        state.wp_prev_local[e])
            curr = chunk_local_to_world(state.wp_chunk[e], state.wp_local[e])
            return jnp.concatenate([
                prev.astype(jnp.float32), curr.astype(jnp.float32),
                state.dodge.active[e].astype(jnp.float32)[None],
                jnp.zeros(1, jnp.float32)])

        self._fused = _fused
        self._fetch_player_init = lambda: _fetch0(self.state)
        self._program_cache[(rw, rh)] = (self._fused,
                                         self._fetch_player_init, self.graph)

    # ------------------------------------------------------------------

    def _advance_time(self, dt: float) -> float:
        """TimeSystem.update (Systems.swift:24-49): returns the SCALED dt
        that feeds the fixed-step accumulator."""
        sdt = dt * self.time_scale
        self.unscaled_delta_time = dt
        self.delta_time = sdt
        self.unscaled_time += dt
        self.time += sdt
        self.frame_index += 1
        return sdt

    def _apply_exposure_input(self, dt: float):
        """DemoScene.swift:700-703: integrate the pad's exposure axis into
        toneMappingExposure, clamped [0.1, 2.0]. Uses UNSCALED dt — the
        reference applies it before the fixed runner, from real frame dt."""
        delta = self.input.exposure_delta
        if delta:
            self.tone_mapping_exposure = min(
                max(self.tone_mapping_exposure + delta * dt, 0.1), 2.0)

    def _player_intent(self, pad: InputFrame, dt: float):
        """One jitted state update per frame (not five .at[].set
        dispatches + bool()/float() device reads). Scene constants are
        cached at init; dodge_active rides back with the previous frame's
        camera fetch (one read per frame)."""
        e = self.player
        if not hasattr(self, "_mv_cache"):
            mv = self.spec.movement
            self._mv_cache = (float(mv["walk_speed"][e]),
                              float(mv["run_speed"][e]),
                              float(mv["run_threshold"][e]))
            self._dodge_active = False
        if not hasattr(self, "_apply_intent"):
            @jax.jit
            def apply_intent(st, vel, yaw, has_yaw, jump, dodge):
                return st._replace(
                    intent_vel=st.intent_vel.at[e].set(vel),
                    intent_yaw=st.intent_yaw.at[e].set(yaw),
                    intent_has_yaw=st.intent_has_yaw.at[e].set(has_yaw),
                    intent_jump=st.intent_jump.at[e].set(
                        st.intent_jump[e] | jump),
                    intent_dodge=st.intent_dodge.at[e].set(
                        st.intent_dodge[e] | dodge))

            self._apply_intent = apply_intent
        walk, run, thresh = self._mv_cache
        intent = self.input.update(pad, dt, self._dodge_active,
                                   walk, run, thresh)
        self.state = self._apply_intent(
            self.state,
            jnp.asarray(intent["desired_velocity"], jnp.float32),
            jnp.float32(intent["facing_yaw"]),
            bool(intent["has_facing_yaw"]),
            bool(intent["jump_requested"]),
            bool(intent["dodge_requested"]))

    def update(self, dt: float, pad: Optional[InputFrame] = None):
        """Simulation update: time, input, fixed substeps, chase camera."""
        dt = min(max(dt, 0.0), 0.1)  # Renderer.swift:161-163
        sdt = self._advance_time(dt)
        self._player_intent(pad or InputFrame(), dt)
        self._apply_exposure_input(dt)

        self.accumulator += sdt
        steps = 0
        while self.accumulator >= FIXED_DT and steps < MAX_SUBSTEPS:
            self.state = self.stepper.substep(self.state, FIXED_DT)
            self.accumulator -= FIXED_DT
            steps += 1
        if steps == MAX_SUBSTEPS and self.accumulator >= FIXED_DT:
            self.accumulator = 0.0

        # chase camera from interpolated player world position (one device
        # read per frame: prev/curr world pos + dodge flag ride together)
        alpha = min(max(self.accumulator / FIXED_DT, 0.0), 1.0)
        e = self.player
        if not hasattr(self, "_fetch_player"):
            @jax.jit
            def fetch(st):
                prev = chunk_local_to_world(st.wp_prev_chunk[e],
                                            st.wp_prev_local[e])
                curr = chunk_local_to_world(st.wp_chunk[e], st.wp_local[e])
                return jnp.concatenate([
                    prev.astype(jnp.float32), curr.astype(jnp.float32),
                    st.dodge.active[e].astype(jnp.float32)[None]])
            self._fetch_player = fetch
        snap = np.asarray(self._fetch_player(self.state))
        self._dodge_active = bool(snap[6] > 0.5)
        p = snap[0:3] + (snap[3:6] - snap[0:3]) * alpha
        self.input.update_camera(self.camera, p)
        return alpha

    def render(self, alpha: float):
        """Render extraction + graph execution. Returns (H,W,3) float array."""
        cam_world = self.camera.world_position.astype(np.float32)
        transforms, palettes = self.stepper.extract(self.state, alpha, cam_world)
        ivp = self.camera.inv_view_proj(self.rt_size[0], self.rt_size[1])
        res = self.graph.execute(dict(
            transforms=transforms, palettes=palettes, ivp=ivp,
            cam_pos=jnp.asarray(self.camera.position),
            exposure=jnp.float32(self.tone_mapping_exposure)))
        return res["view"]

    # -- checkpoint / resume --------------------------------------------
    # The reference has no save-game (SURVEY §5); the pytree world state
    # makes it trivial here. One .npz holds the entire simulation.

    def save_state(self, path: str):
        save_world_state(path, self.state,
                         accumulator=self.accumulator, time=self.time)

    def load_state(self, path: str):
        self.state, data = load_world_state(path, self.state)
        self.accumulator = float(data["accumulator"])
        self.time = float(data["time"])

    def frame(self, dt: float, pad: Optional[InputFrame] = None,
              with_overlay: bool = True):
        """Full frame via the fused one-dispatch program. Returns u8 (H,W,3)."""
        e = self.player
        if not hasattr(self, "_mv_cache"):
            mv = self.spec.movement
            self._mv_cache = (float(mv["walk_speed"][e]),
                              float(mv["run_speed"][e]),
                              float(mv["run_threshold"][e]))
            self._dodge_active = False
        dt = min(max(dt, 0.0), 0.1)  # Renderer.swift:161-163
        sdt = self._advance_time(dt)
        walk, run, thresh = self._mv_cache
        intent = self.input.update(pad or InputFrame(), dt,
                                   self._dodge_active, walk, run, thresh)
        self._apply_exposure_input(dt)

        self.accumulator += sdt
        n = 0
        while self.accumulator >= FIXED_DT and n < MAX_SUBSTEPS:
            self.accumulator -= FIXED_DT
            n += 1
        if n == MAX_SUBSTEPS and self.accumulator >= FIXED_DT:
            self.accumulator = 0.0
        alpha = min(max(self.accumulator / FIXED_DT, 0.0), 1.0)

        # chase camera from the PREVIOUS frame's player snapshot
        if self._snap is None:
            self._snap = np.asarray(self._fetch_player_init())
        snap = self._snap
        p = snap[0:3] + (snap[3:6] - snap[0:3]) * alpha
        self.input.update_camera(self.camera, p)
        ivp = self.camera.inv_view_proj(self.rt_size[0], self.rt_size[1])
        cam_world = self.camera.world_position.astype(np.float32)

        # FPS overlay rides the fused program (UIPass in-device); EMA state
        # stays host-side. fps = -1 disables the blit without recompiling.
        fps = self.overlay.update(dt) if with_overlay else -1

        # All args are host numpy/python values: a single transfer rides the
        # one fused dispatch (no eager per-argument device ops).
        self.state, u8_dev, snap_dev = self._fused(
            self.state,
            np.asarray(intent["desired_velocity"], np.float32),
            np.float32(intent["facing_yaw"]),
            bool(intent["has_facing_yaw"]),
            bool(intent["jump_requested"]),
            bool(intent["dodge_requested"]),
            np.int32(n), np.float32(alpha), np.asarray(ivp, np.float32),
            np.asarray(self.camera.position, np.float32),
            np.asarray(cam_world, np.float32),
            np.float32(self.tone_mapping_exposure), np.int32(fps))
        # Start the host copies NOW: the pop below happens pipeline_depth
        # frames later, so the image transfer overlaps newer frames'
        # compute instead of serializing with them at pop time (np.asarray
        # then reads the cached copy).
        u8_dev.copy_to_host_async()
        snap_dev.copy_to_host_async()
        self._pending.append((u8_dev, snap_dev))
        if len(self._pending) < self.pipeline_depth:
            # warm-up: nothing completed yet — present a black frame rather
            # than stalling the pipeline.
            u8 = np.zeros((self.height, self.width, 3), np.uint8)
        else:
            u8_done, snap_done = self._pending.pop(0)
            u8 = np.asarray(u8_done)
            self._snap = np.asarray(snap_done)
            self._dodge_active = bool(self._snap[6] > 0.5)
            self.nonfinite_values = int(self._snap[7])
        return u8
