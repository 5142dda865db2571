"""Input system: gamepad-style intents + third-person chase camera.

reference: Game/InputSystem.swift:11-228. The reference reads a GameController
pad; headless runs take the same axes/buttons from an `InputFrame`
(scripted, replayed, or wired to any host input source):

  * deadzone 0.12 on each stick
  * camera yaw/pitch from the right stick (lookSpeed 2.5, pitch clamped
    [-0.6, 0.6])
  * camera-relative movement from the left stick with two-speed walk/run by
    stick magnitude vs MovementComponent.runThreshold
  * turn-rate-limited facing yaw (turnSpeed 16)
  * jump/dodge edge triggers
  * third-person chase camera at distance 8, height 1.5, in f64-equivalent
    world space with fixed-step interpolation
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ecs.world import chunk_local_to_world


@dataclass
class InputFrame:
    """One frame of pad state (already in [-1, 1])."""

    lx: float = 0.0
    ly: float = 0.0
    rx: float = 0.0
    ry: float = 0.0
    jump: bool = False
    dodge: bool = False
    # Exposure adjust axis in [-1, 1] (InputSystem.swift:24 exposureDelta):
    # the engine integrates it as exposure += delta * dt, clamped to
    # [0.1, 2.0] exactly like DemoScene.swift:700-703.
    exposure_delta: float = 0.0


@dataclass
class InputSystem:
    look_speed: float = 2.5
    turn_speed: float = 16.0
    camera_distance: float = 8.0
    camera_height: float = 1.5
    deadzone: float = 0.12
    pitch_min: float = -0.6
    pitch_max: float = 0.6

    yaw: float = 0.0
    pitch: float = -0.1
    facing_yaw: float = 0.0
    exposure_delta: float = 0.0
    _last_jump: bool = False
    _last_dodge: bool = False

    @staticmethod
    def _wrap(a):
        v = np.fmod(a, 2 * np.pi)
        return v + 2 * np.pi if v < 0 else v

    def _axis(self, v):
        return 0.0 if abs(v) < self.deadzone else v

    def update(self, pad: InputFrame, dt: float, dodge_active: bool,
               walk_speed: float, run_speed: float, run_threshold: float):
        """Compute the player MoveIntent fields for this frame.

        Returns dict(desired_velocity (3,), facing_yaw, has_facing_yaw,
        jump_requested, dodge_requested). Axis sign conventions follow
        InputSystem.swift:97-101.
        """
        lx = self._axis(-pad.lx)
        ly = self._axis(pad.ly)
        rx = self._axis(-pad.rx)
        ry = self._axis(-pad.ry)
        # Published like the reference's read-only exposureDelta property;
        # the engine consumes it once per frame (DemoScene.swift:700-703).
        self.exposure_delta = float(pad.exposure_delta)

        self.yaw = self._wrap(self.yaw + rx * self.look_speed * dt)
        self.pitch = float(np.clip(self.pitch + ry * self.look_speed * dt,
                                   self.pitch_min, self.pitch_max))

        forward = np.array([-np.sin(self.yaw), 0.0, -np.cos(self.yaw)])
        right = np.array([forward[2], 0.0, -forward[0]])
        move = forward * ly + right * lx
        move_len = np.linalg.norm(move)

        out = dict(desired_velocity=np.zeros(3, np.float32),
                   facing_yaw=self.facing_yaw, has_facing_yaw=False,
                   jump_requested=False, dodge_requested=False)
        if not dodge_active and move_len > self.deadzone:
            d = move / move_len
            thr = max(run_threshold, self.deadzone)
            speed = run_speed if move_len >= thr else walk_speed
            out["desired_velocity"] = (d * speed).astype(np.float32)
            target = self._wrap(np.arctan2(-d[0], -d[2]))
            diff = self._wrap(target - self.facing_yaw)
            if diff > np.pi:
                diff -= 2 * np.pi
            step = np.clip(diff, -self.turn_speed * dt, self.turn_speed * dt)
            self.facing_yaw = self._wrap(self.facing_yaw + step)
            out["facing_yaw"] = self.facing_yaw
            out["has_facing_yaw"] = True
        elif dodge_active:
            out["facing_yaw"] = self.facing_yaw
            out["has_facing_yaw"] = True

        if pad.jump and not self._last_jump:
            out["jump_requested"] = True
        if pad.dodge and not self._last_dodge:
            out["dodge_requested"] = True
        self._last_jump = pad.jump
        self._last_dodge = pad.dodge
        return out

    def update_camera(self, camera, player_world_interp):
        """Third-person chase camera (InputSystem.swift:151-197).

        ``player_world_interp``: interpolated player position (3,) f64.
        Updates camera chunk/local anchor + render-space position/target.
        """
        target_world = np.asarray(player_world_interp, np.float64) + \
            np.array([0.0, self.camera_height, 0.0])
        d = np.array([np.sin(self.yaw) * np.cos(self.pitch),
                      np.sin(self.pitch),
                      np.cos(self.yaw) * np.cos(self.pitch)])
        camera_world = target_world + d * self.camera_distance
        shift = np.floor((camera_world + 256.0) / 512.0)
        camera.world_chunk = shift.astype(np.int64)
        camera.world_local = camera_world - shift * 512.0
        camera.position = np.zeros(3, np.float32)
        camera.target = (target_world - camera_world).astype(np.float32)
