#!/usr/bin/env python
"""Benchmark: DemoScene simulate + RT render throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The headline metric is full DemoScene frames/sec on the RT path (fixed-step
physics + pose + skinning + per-frame geometry flatten + ray-traced frame)
at the benchmark resolution — on the FULL-FIDELITY scene (no import
decimation; 195,662 render triangles — the reference renders its imports
un-decimated, Game/StaticMeshLoader.swift:30-197). vs_baseline is measured
against the driver's north-star of 60 FPS at 1080p (BASELINE.md),
normalized by pixel count: vs = fps * (pixels / 1080p_pixels) / 60.

All five BASELINE.md measurement configs are tracked per round (stderr):
  #1 FitMotion Idle parity      -> tests/test_fit_motion.py (golden; cited)
  #2 batched pose eval          -> char-steps/s, 64 characters
  #3 capsule-CCD physics        -> substeps/s on the demo scene
  #4 raster path @1080p+overlay -> raster_pbr fps (full-PBR raster mode)
  #5 full RT path @1080p        -> fps (subprocess; BVH/skin refit incl.)

Env knobs: BENCH_WIDTH/BENCH_HEIGHT (default 960x540), BENCH_FRAMES,
BENCH_LAYERS, BENCH_SHADOW_LAYERS, BENCH_PATH (rt|raster|raster_pbr),
BENCH_DECIMATED=1 re-enables the old 20k/part import decimation,
BENCH_SECONDARY=0 skips the subprocess probes (1080p RT/raster, pose).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


POSE_PROBE = r"""
import time
import numpy as np
import jax, jax.numpy as jnp
from swift_game_engine_tpu.compile_cache import enable_compile_cache
from swift_game_engine_tpu.assets.motion_profile import pack_profile
from swift_game_engine_tpu.assets.player_rig import load_player_rig
from swift_game_engine_tpu.anim import pose as P

enable_compile_cache()
sk, rig = load_player_rig()
profs = [rig[n] for n in ("Idle", "Walking", "Running", "FallingIdle")]
act_p = rig["StandingDodgeBackward"]
eng = P.PoseEngine(sk)
bank = eng.make_bank(*[pack_profile(p, sk) for p in profs])
act = eng.make_action(pack_profile(act_p, sk))

N, STEPS = 64, 120
loco = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)),
                    P.LocoState(state=jnp.int32(1), from_state=jnp.int32(0),
                                times=jnp.zeros(4), blend_t=jnp.float32(0.4),
                                idle_inertia=jnp.float32(0.0),
                                is_blending=jnp.asarray(True)))
params = P.LocoParams.default()
astate = jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + jnp.shape(x)),
                      P.ActionState.inactive())
inputs = P.PoseInputs.default()

@jax.jit
def run(loco, astate):
    def body(c, _):
        loco, astate = c
        r = jax.vmap(lambda l, a: eng.step_character(
            bank, act, l, params, a, inputs, jnp.float32(1 / 60)))(loco, astate)
        return (r.loco, astate), r.palette.sum()
    (loco, astate), s = jax.lax.scan(body, (loco, astate), None, length=STEPS)
    return loco, s.sum()

out = run(loco, astate)
jax.block_until_ready(out[1])
t0 = time.perf_counter()
out = run(loco, astate)
jax.block_until_ready(out[1])
dt = time.perf_counter() - t0
print(f"POSE {N * STEPS / dt:.0f} char-steps/s ({N} chars, "
      f"{dt / STEPS * 1e3:.2f} ms/step)")
"""


def run_probe(env_extra, timeout, tag):
    env = dict(os.environ, BENCH_WARM="0", **env_extra)
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
        got = False
        for line in r.stderr.splitlines():
            if line.startswith("frames:"):
                log(f"{tag}: " + line[len("frames:"):].strip())
                got = True
        if not got:
            log(f"{tag}: probe failed (rc={r.returncode}): "
                + " | ".join(r.stderr.splitlines()[-2:]))
    except subprocess.TimeoutExpired:
        log(f"{tag}: probe timed out")


def main():
    width = int(os.environ.get("BENCH_WIDTH", 960))
    height = int(os.environ.get("BENCH_HEIGHT", 540))
    frames = int(os.environ.get("BENCH_FRAMES", 8))

    # Full-fidelity scene by default (decimation is the opt-in now).
    if os.environ.get("BENCH_DECIMATED", "0") == "1":
        os.environ.setdefault("SGE_IMPORT_TRI_BUDGET", "20000")
    else:
        os.environ.setdefault("SGE_IMPORT_TRI_BUDGET", "0")

    secondary = os.environ.get("BENCH_SECONDARY", "1") == "1"
    # Secondary probes run FIRST, each in a SUBPROCESS, before this process
    # initializes JAX: one JAX process per device at a time (a JAX process
    # reserves most of the card's memory when it starts).
    if secondary:
        # config #2: batched pose eval (pose engine only, no scene)
        try:
            r = subprocess.run([sys.executable, "-c", POSE_PROBE],
                               env=dict(os.environ), capture_output=True,
                               text=True, timeout=600)
            for line in r.stdout.splitlines():
                if line.startswith("POSE"):
                    log("pose eval (config #2): " + line[5:])
        except subprocess.TimeoutExpired:
            log("pose eval: probe timed out")
        # config #5: full RT @1080p
        run_probe(dict(BENCH_WIDTH="1920", BENCH_HEIGHT="1080",
                       BENCH_SECONDARY="0", BENCH_FRAMES=str(max(frames // 2, 3)),
                       BENCH_PHYSICS="0"), 1200, "1080p rt (config #5)")
        # config #4: full-PBR raster @1080p with FPS overlay
        run_probe(dict(BENCH_WIDTH="1920", BENCH_HEIGHT="1080",
                       BENCH_SECONDARY="0", BENCH_FRAMES=str(max(frames // 2, 3)),
                       BENCH_PHYSICS="0", BENCH_PATH="raster_pbr",
                       BENCH_OVERLAY="1"), 1200, "1080p raster_pbr (config #4)")
        # the decimated scene (20k render triangles per imported part)
        run_probe(dict(BENCH_SECONDARY="0", BENCH_PHYSICS="0",
                       BENCH_DECIMATED="1", SGE_IMPORT_TRI_BUDGET="20000"),
                  1200, "decimated 960x540")
        log("FitMotion parity (config #1): tests/test_fit_motion.py (golden "
            "round-trip vs checked-in Idle/Walking profiles)")

    # Two-phase warm run: seed the persistent compile cache in a SUBPROCESS with the exact headline
    # frame program, so the measurement below always runs against a warm
    # cache. The seed pass's own warmup time is the honest cold-compile
    # number (reported separately); on unchanged code the cache is already
    # hot and the seed pass costs scene build + cache load only (~30 s).
    if os.environ.get("BENCH_WARM", "1") == "1":
        t0 = time.time()
        try:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=dict(os.environ, BENCH_SECONDARY="0", BENCH_FRAMES="1",
                         BENCH_PHYSICS="0", BENCH_WARM="0"),
                capture_output=True, text=True, timeout=1800)
            seed_warm = next((ln.split(":", 1)[1].strip()
                              for ln in r.stderr.splitlines()
                              if ln.startswith("warmup/compile:")), "?")
            log(f"cache seed pass: {time.time()-t0:.1f}s total, "
                f"headline-program compile {seed_warm} "
                f"(cold if code changed, warm otherwise); the measurement "
                f"below is always warm-cache")
        except subprocess.TimeoutExpired:
            log("cache seed pass: timed out (measurement below may pay "
                "a cold compile)")

    import jax
    from swift_game_engine_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    layers = int(os.environ.get("BENCH_LAYERS", 3))
    shadow_layers = int(os.environ.get("BENCH_SHADOW_LAYERS", 4))
    path = os.environ.get("BENCH_PATH", "rt")
    overlay = os.environ.get("BENCH_OVERLAY", "0") == "1"

    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    from swift_game_engine_tpu.scene.engine import Engine
    from swift_game_engine_tpu.scene.input import InputFrame

    t0 = time.time()
    scene = DemoScene().build()
    log(f"scene build: {time.time()-t0:.1f}s  "
        f"render_tris={scene['geometry'].tri.shape[0]} "
        f"collision_tris={int(np.asarray(scene['collision'].valid).sum())}")

    pipeline = int(os.environ.get("BENCH_PIPELINE", 3))
    eng = Engine(scene, width=width, height=height, path=path,
                 max_layers=layers, shadow_layers=shadow_layers,
                 pipeline_depth=pipeline)

    # warmup (compile)
    t0 = time.time()
    eng.frame(1.0 / 60.0, InputFrame(ly=1.0), with_overlay=overlay)
    log(f"warmup/compile: {time.time()-t0:.1f}s")

    # full frames — steady-state pipelined throughput (pipeline warm-up
    # frames are excluded; frame N's image fetch overlaps frame N+1's
    # device work, matching the reference's 3-frames-in-flight pacing).
    for i in range(pipeline):
        eng.frame(1.0 / 60.0, InputFrame(ly=1.0), with_overlay=overlay)
    t0 = time.time()
    for i in range(frames):
        eng.frame(1.0 / 60.0, InputFrame(ly=1.0), with_overlay=overlay)
    wall = time.time() - t0
    fps = frames / wall
    px = width * height
    rays_per_s = fps * px / 1e6
    log(f"frames: {fps:.3f} fps @ {width}x{height} ({wall/frames*1000:.0f} ms/frame, "
        f"{rays_per_s:.2f} Mprimary-rays/s, path={path}, "
        f"tris={scene['geometry'].tri.shape[0]})")

    # config #3: capsule-CCD physics throughput (scan-fused device time),
    # after the frame measurement. Skippable with BENCH_PHYSICS=0.
    if os.environ.get("BENCH_PHYSICS", "1") == "1":
        import jax.numpy as jnp
        n_sim = 120

        @jax.jit
        def sim_chunk(st):
            def body(st, _):
                return (eng.stepper._substep_impl(st, jnp.float32(1.0 / 60.0)),
                        0)
            st, _ = jax.lax.scan(body, st, None, length=n_sim)
            return st

        jax.block_until_ready(sim_chunk(eng.state).body_pos)  # compile
        t0 = time.time()
        end_state = sim_chunk(eng.state)
        jax.block_until_ready(end_state.body_pos)
        sim_dt = time.time() - t0
        log(f"physics (config #3): {n_sim/sim_dt:.1f} substeps/s "
            f"({sim_dt/n_sim*1000:.2f} ms/substep; 60 Hz x4 worst case needs "
            f">= 240/s)")
        qc = np.asarray(end_state.ctrl.query_candidates)
        qs = np.asarray(end_state.ctrl.query_casts)
        log(f"collision stats (last substep): casts={int(qs.sum())} "
            f"candidates={int(qc.sum())} (max/agent {int(qc.max()) if len(qc) else 0})")

    vs = fps * (px / (1920.0 * 1080.0)) / 60.0
    print(json.dumps({
        "metric": f"demo_{path}_fps_{width}x{height}",
        "value": round(fps, 4),
        "unit": "frames/s",
        "vs_baseline": round(vs, 6),
    }), flush=True)


if __name__ == "__main__":
    main()
