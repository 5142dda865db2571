#!/usr/bin/env python
"""Crowd scaling: physics substep throughput vs agent count.

The entity axis of SURVEY §5: the mover/separation pipeline is vmapped over
agents, so substep cost should grow sub-linearly until the (agents x
triangles) work saturates the device. Spawns N controller agents on a ground
plane with obstacles and measures scan-fused substeps/s per N.

Usage: python examples/bench_crowd.py [counts ...]   (default 4 16 64 1024)
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax

import jax.numpy as jnp

from swift_game_engine_tpu.assets import procedural_meshes as pm
from swift_game_engine_tpu.compile_cache import enable_compile_cache
from swift_game_engine_tpu.ecs.world import WorldBuilder, BODY_STATIC, BODY_DYNAMIC
from swift_game_engine_tpu.physics.collision_world import CollisionWorldBuilder
from swift_game_engine_tpu.scene.step import Stepper

K = 32


def build(n_agents: int):
    rng = np.random.default_rng(11)
    wb = WorldBuilder()
    cb = CollisionWorldBuilder()

    ground = wb.create_entity("ground")
    gm = pm.plane(400.0)
    wb.add(ground, "transform", translation=[0, -3, 0])
    wb.add(ground, "world_position")
    wb.add(ground, "body", body_type=BODY_STATIC, position=[0, -3, 0])
    cb.add_mesh(gm.positions, gm.indices, entity=ground, mu_s=0.9, mu_k=0.8)

    box = pm.box(4.0)
    for i in range(8):
        e = wb.create_entity(f"obstacle_{i}")
        pos = [float(rng.uniform(-60, 60)), -1.0, float(rng.uniform(-60, 60))]
        wb.add(e, "transform", translation=pos)
        wb.add(e, "world_position")
        wb.add(e, "body", body_type=BODY_STATIC, position=pos)
        cb.add_mesh(box.positions, box.indices, entity=e)

    player = wb.create_entity("player")
    wb.add(player, "transform", translation=[0, 0, 0])
    wb.add(player, "world_position")
    wb.add(player, "player")
    wb.add(player, "body", body_type=BODY_DYNAMIC, position=[0, 0, 0])
    wb.add(player, "intent")
    wb.add(player, "movement")
    wb.add(player, "controller", radius=1.5, half_height=1.0)
    wb.add(player, "agent", mass_weight=3.0)

    for i in range(n_agents - 1):
        e = wb.create_entity(f"agent_{i}")
        pos = [float(rng.uniform(-70, 70)), float(rng.uniform(0, 4)),
               float(rng.uniform(-70, 70))]
        wb.add(e, "transform", translation=pos)
        wb.add(e, "world_position")
        wb.add(e, "body", body_type=BODY_DYNAMIC, position=pos)
        wb.add(e, "intent")
        wb.add(e, "movement")
        wb.add(e, "controller", radius=1.5, half_height=1.0)
        wb.add(e, "agent", mass_weight=1.0)
        wb.add(e, "oscillate", origin=pos,
               axis=[float(rng.uniform(-1, 1)), 0, float(rng.uniform(-1, 1))],
               amplitude=6.0, speed=float(rng.uniform(0.4, 1.2)))

    spec, state = wb.build()
    return Stepper(spec, cb.build()), state


def main():
    counts = [int(a) for a in sys.argv[1:]] or [4, 16, 64, 1024]
    enable_compile_cache()
    print(f"{'agents':>7} {'ms/substep':>11} {'substeps/s':>11} "
          f"{'agent-steps/s':>14}")
    for n in counts:
        stepper, state = build(n)

        @jax.jit
        def chunk(st):
            def body(st, _):
                return stepper._substep_impl(st, jnp.float32(1 / 60)), 0
            st, _ = jax.lax.scan(body, st, None, length=K)
            return st

        jax.block_until_ready(chunk(state).body_pos)
        t0 = time.perf_counter()
        jax.block_until_ready(chunk(state).body_pos)
        dt = (time.perf_counter() - t0) / K
        print(f"{n:7d} {dt*1e3:11.2f} {1/dt:11.1f} {n/dt:14.0f}")


if __name__ == "__main__":
    main()
