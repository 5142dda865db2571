#!/usr/bin/env python
"""Smoke test: the DemoScene frame on one NVIDIA GPU, through the entry
points a user calls (``DemoScene().build()`` -> ``Engine(...).frame(...)``).

Run from the repository root on a machine with a card:

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded frame only

Phases (each prints its seconds; any failure exits non-zero):

  1. device: the card's name and power limit (nvidia-smi), JAX platform,
     device kind and count. Every later number carries the card's name and
     power limit.
  2. scene: the full-fidelity DemoScene (no import decimation).
  3. kernel parity: the traversal kernel against the plain vmapped walk
     (render.bvh.traverse) on the 1920x1080 primary rays and one shadow
     batch, with both times.
  4. frame: Engine(1920x1080, path="rt", 3 layers, 4 shadow layers, mirror
     and refraction on, pipeline_depth=3): cold compile seconds, the
     program's memory analysis, warm ms/frame (not a benchmark), a finite
     non-constant image, and how many primary-layer lanes took a mirror or
     a refraction bounce.
  5. GPU vs CPU: the first frame of a small scene (no imported assets,
     320x180) on the GPU and on the host CPU device.
  6. raster: one path="raster" frame at 1920x1080.
  Phases 5 and 6 compile and run in worker threads while phase 4 compiles.
  --multi: the sharded fused step (parallel.sharding) over a 4-GPU mesh at
     1920x1080 against a 1-device mesh.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
It is printed only when every phase passed. Without a GPU the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# The full-fidelity scene: no render-mesh decimation of imported assets.
os.environ.setdefault("SGE_IMPORT_TRI_BUDGET", "0")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from swift_game_engine_tpu.compile_cache import enable_compile_cache  # noqa: E402
from swift_game_engine_tpu.ops.rt_kernel import trace_rays  # noqa: E402
from swift_game_engine_tpu.render import bvh as B  # noqa: E402
from swift_game_engine_tpu.render import rt as RT  # noqa: E402
from swift_game_engine_tpu.render.camera import generate_rays_tiled  # noqa: E402
from swift_game_engine_tpu.render.scene_geometry import flatten_frame  # noqa: E402
from swift_game_engine_tpu.scene.demo_scene import DemoScene  # noqa: E402
from swift_game_engine_tpu.scene.engine import Engine  # noqa: E402
from swift_game_engine_tpu.scene.input import InputFrame  # noqa: E402

WIDTH, HEIGHT = 1920, 1080
LAYERS, SHADOW_LAYERS = 3, 4
WARM_FRAMES = 10
DT = 1.0 / 60.0

CARD = "unknown card"


def say(msg):
    print(f"{msg}  [{CARD}]", flush=True)


class Phase:
    """Times one phase; exceptions propagate (no phase is swallowed)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            say(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def timed(fn, *args, reps=3):
    """(result, best seconds of ``reps`` warm calls) — first call compiles."""
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def frame_inputs(scene, width, height):
    """World transforms, palettes and a camera for the scene's first
    frame (the standard demo view)."""
    from swift_game_engine_tpu.render.camera import Camera
    transforms, palettes = scene["stepper"].extract(
        scene["state"], 0.0, np.zeros(3, np.float32))
    cam = Camera()
    cam.position = np.array([0.0, 4.0, 14.0], np.float32)
    cam.target = np.array([0.0, 0.0, 0.0], np.float32)
    ivp = jnp.asarray(cam.inv_view_proj(width, height))
    return transforms, palettes, ivp, jnp.asarray(cam.position)


def compare_hits(name, t_k, tri_k, t_p, tri_p, min_equal=0.9999):
    """Kernel vs plain hit records: ``tri`` equal on >= min_equal of lanes;
    where it differs both must hit within 1e-4 relative t (shared edges)."""
    t_k, tri_k, t_p, tri_p = map(np.asarray, (t_k, tri_k, t_p, tri_p))
    same = tri_k == tri_p
    rel = np.abs(t_k - t_p) / np.maximum(np.abs(t_p), 1e-6)
    tie = (tri_k >= 0) & (tri_p >= 0) & (rel <= 1e-4)
    frac = float(same.mean())
    say(f"{name}: {tri_k.size} rays, hits {int((tri_p >= 0).sum())}, "
        f"tri equal on {frac:.6f} of lanes, {int((~same).sum())} differ, "
        f"of which {int((~same & tie).sum())} tie within 1e-4 relative t")
    if frac < min_equal or not (same | tie).all():
        raise AssertionError(f"{name}: kernel and plain walk disagree")


def phase_kernel_parity(scene, width, height, interpret=False):
    geo = scene["geometry"]
    transforms, palettes, ivp, cam_pos = frame_inputs(scene, width, height)
    fg = jax.jit(lambda t, p: flatten_frame(geo, t, p))(transforms, palettes)
    bvh = fg.bvh
    o, d, _, _ = generate_rays_tiled(ivp, cam_pos, width, height)
    t_max = jnp.full(o.shape[0], B.BIG, jnp.float32)

    kernel = jax.jit(lambda o, d, tm: trace_rays(bvh.rows, o, d, tm,
                                                  interpret=interpret))
    plain = jax.jit(lambda o, d, tm: RT.trace_plain(bvh, o, d, tm))
    (t_k, tri_k), sec_k = timed(kernel, o, d, t_max)
    (t_p, tri_p), sec_p = timed(plain, o, d, t_max, reps=1)
    compare_hits("primary rays", t_k, tri_k, t_p, tri_p)
    say(f"primary {width}x{height}: kernel {sec_k * 1e3:.2f} ms, "
        f"plain vmap(bvh.traverse) {sec_p * 1e3:.2f} ms")

    # One shadow batch: from every primary hit toward light 0.
    hit = tri_p >= 0
    l = -scene["lights"].direction[0]
    l = l / jnp.linalg.norm(l)
    n = fg.tri_nrm[jnp.maximum(tri_p, 0)]
    n = jnp.where(jnp.sum(n * d, axis=-1, keepdims=True) > 0, -n, n)
    t_hit = jnp.where(hit, t_p, 1.0)
    o_sh = o + d * t_hit[:, None] + n * 1e-2
    d_sh = jnp.broadcast_to(l, o_sh.shape)
    tm_sh = jnp.where(hit, B.BIG, 0.0)
    (t_ks, tri_ks), sec_ks = timed(kernel, o_sh, d_sh, tm_sh)
    (t_ps, tri_ps), sec_ps = timed(plain, o_sh, d_sh, tm_sh, reps=1)
    compare_hits("shadow rays", t_ks, tri_ks, t_ps, tri_ps)
    say(f"shadow batch ({int(hit.sum())} live of {hit.size}): kernel "
        f"{sec_ks * 1e3:.2f} ms, plain {sec_ps * 1e3:.2f} ms")


def bounce_lane_counts(scene, width, height):
    """Primary-layer lanes whose hit takes the mirror bounce
    (roughness <= 0.08, metallic >= 0.8) or the refraction bounce
    (transmission > 0.001 with a non-TIR refracted direction)."""
    geo = scene["geometry"]
    transforms, palettes, ivp, cam_pos = frame_inputs(scene, width, height)

    @jax.jit
    def counts(transforms, palettes):
        fg = flatten_frame(geo, transforms, palettes)
        o, d, _, _ = generate_rays_tiled(ivp, cam_pos, width, height)
        t, tri, u, v, found = RT._trace_batch(fg.bvh, o, d,
                                              jnp.ones(o.shape[0], bool))
        m, n, _, _ = RT._gbuffer(geo, fg, o, d, t, tri, u, v, found,
                                 RT.texture_usage(geo))
        mirror = found & (m["roughness"] <= 0.08) & (m["metallic"] >= 0.8)
        _, t_len, _ = RT.refraction_setup(d, n, m["ior"])
        refr = found & (m["transmission"] > 0.001) & (t_len > 0)
        return jnp.sum(mirror), jnp.sum(refr), jnp.sum(found)

    return [int(x) for x in counts(transforms, palettes)]


def check_image(name, u8, shape):
    u8 = np.asarray(u8)
    if u8.shape != shape:
        raise AssertionError(f"{name}: shape {u8.shape} != {shape}")
    if u8.min() == u8.max():
        raise AssertionError(f"{name}: constant image")
    say(f"{name}: {u8.shape} u8, mean {u8.mean():.2f}, std {u8.std():.2f}")


def check_finite(name, eng):
    """The engine counts NaN/inf values of the float image inside the frame
    program (u8 quantization would hide them)."""
    if eng.nonfinite_values:
        raise AssertionError(f"{name}: {eng.nonfinite_values} non-finite "
                             f"values in the float image")
    say(f"{name}: float image finite")


def first_frame(eng, dev=None):
    """(u8 first frame, seconds incl. compile) of a pipeline_depth=1
    engine, run with ``dev`` as the default device when given."""
    t0 = time.perf_counter()
    if dev is None:
        u8 = eng.frame(DT, InputFrame(), with_overlay=False)
    else:
        with jax.default_device(dev):
            u8 = eng.frame(DT, InputFrame(), with_overlay=False)
    return np.asarray(u8), time.perf_counter() - t0


def to_device(scene, dev):
    moved = jax.tree.map(lambda x: jax.device_put(x, dev)
                         if isinstance(x, jax.Array) else x, scene)
    moved["stepper"] = scene["stepper"].device_put(dev)
    return moved


def start_side_frames(pool, scene, width, height, small_w, small_h):
    """Submit the frames of the GPU-vs-CPU and raster phases to ``pool``:
    their programs compile on the host in parallel with the main 1080p
    frame. Engines are built here, in the calling thread."""
    small = DemoScene(include_imported_assets=False).build()
    cpu = jax.devices("cpu")[0]
    eng_gpu = Engine(small, width=small_w, height=small_h, path="rt",
                     max_layers=LAYERS, shadow_layers=SHADOW_LAYERS)
    with jax.default_device(cpu):
        eng_cpu = Engine(to_device(small, cpu), width=small_w,
                         height=small_h, path="rt", max_layers=LAYERS,
                         shadow_layers=SHADOW_LAYERS)
    eng_raster = Engine(scene, width=width, height=height, path="raster",
                        max_layers=2)
    return {
        "gpu": (eng_gpu, pool.submit(first_frame, eng_gpu)),
        "cpu": (eng_cpu, pool.submit(first_frame, eng_cpu, cpu)),
        "raster": (eng_raster, pool.submit(first_frame, eng_raster)),
    }


def phase_frame(scene, width, height, side):
    eng = Engine(scene, width=width, height=height, path="rt",
                 max_layers=LAYERS, shadow_layers=SHADOW_LAYERS,
                 pipeline_depth=3)
    calls = []
    fused = eng._fused

    def recording(*args):
        calls.append(args)
        return fused(*args)

    eng._fused = recording
    t0 = time.perf_counter()
    eng.frame(DT, InputFrame(ly=1.0), with_overlay=True)
    jax.block_until_ready(eng._pending[-1])
    say(f"frame program cold compile + first frame: "
        f"{time.perf_counter() - t0:.1f} s (other phases' programs compile "
        f"in parallel threads meanwhile)")
    mem = fused.lower(*calls[0]).compile().memory_analysis()
    say(f"frame program memory_analysis: {mem}")

    # Time warm frames only once the side frames are done with the card.
    for _, fut in side.values():
        fut.result()
    for _ in range(eng.pipeline_depth):
        eng.frame(DT, InputFrame(ly=1.0), with_overlay=True)
    t0 = time.perf_counter()
    for _ in range(WARM_FRAMES):
        u8 = eng.frame(DT, InputFrame(ly=1.0), with_overlay=True)
    ms = (time.perf_counter() - t0) / WARM_FRAMES * 1e3
    say(f"warm frames: {ms:.1f} ms/frame over {WARM_FRAMES} pipelined "
        f"frames at {width}x{height} (not a benchmark)")
    check_image("rt frame", u8, (height, width, 3))
    check_finite("rt frame", eng)
    t0 = time.perf_counter()
    mirror, refr, found = bounce_lane_counts(scene, width, height)
    say(f"bounce lane counts: {time.perf_counter() - t0:.1f} s incl. compile")
    say(f"primary-layer lanes: {found} hits, {mirror} take a mirror bounce, "
        f"{refr} take a refraction bounce"
        + ("" if mirror else " (mirror path NOT exercised)")
        + ("" if refr else " (refraction path NOT exercised)"))


def phase_gpu_vs_cpu(side, width, height):
    (eng_a, fut_a), (eng_b, fut_b) = side["gpu"], side["cpu"]
    a, sec_a = fut_a.result()
    b, sec_b = fut_b.result()
    say(f"gpu first frame {width}x{height} (compile + run): {sec_a:.1f} s")
    say(f"cpu first frame {width}x{height} (compile + run): {sec_b:.1f} s")
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    frac = float((diff > 2).mean())
    say(f"gpu vs cpu first frame {width}x{height}: {frac * 100:.4f}% of u8 "
        f"values differ by > 2 levels (max diff {int(diff.max())})")
    if frac > 1e-3:
        raise AssertionError("gpu vs cpu frames disagree")
    check_image("gpu frame", a, (height, width, 3))
    check_finite("gpu frame", eng_a)
    check_finite("cpu frame", eng_b)


def phase_raster(side, width, height):
    eng, fut = side["raster"]
    u8, sec = fut.result()
    say(f"raster frame {width}x{height} (compile + run): {sec:.1f} s")
    check_image("raster frame", u8, (height, width, 3))
    check_finite("raster frame", eng)


def phase_multi(width, height, n_dev=4):
    """The sharded fused step (substep + extract + flatten + image-plane
    sharded render, parallel.sharding, with its default 1 layer and 1 shadow
    layer) over an n_dev-GPU mesh against a 1-device mesh. The two programs
    compile in parallel threads."""
    from swift_game_engine_tpu.parallel.sharding import (
        make_mesh, shard_world_state, sharded_fused_step)
    from swift_game_engine_tpu.render.ibl import IBL
    devices = jax.devices()[:n_dev]
    if len(devices) < n_dev:
        raise RuntimeError(f"--multi needs {n_dev} devices, "
                           f"JAX sees {len(jax.devices())}")
    scene = DemoScene(pad_entities_to=n_dev).build()
    ibl = IBL.build()
    _, _, ivp, cam_pos = frame_inputs(scene, width, height)

    def run(devs):
        mesh = make_mesh(devs)
        step = sharded_fused_step(mesh, scene, ibl, width, height)
        t0 = time.perf_counter()
        _, img = step(shard_world_state(mesh, scene["state"]), ivp, cam_pos,
                      jnp.zeros(3))
        return np.asarray(img), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(run, devs) for devs in (devices, devices[:1])]
        imgs = []
        for devs, fut in zip((devices, devices[:1]), futs):
            img, sec = fut.result()
            say(f"sharded fused step on {len(devs)} device(s), "
                f"{width}x{height}: {sec:.1f} s (compile + run)")
            if not np.isfinite(img).all():
                raise AssertionError(f"{len(devs)}-device image not finite")
            imgs.append(img)
    err = float(np.abs(imgs[0] - imgs[1]).max())
    say(f"{n_dev}-GPU mesh vs 1-device mesh: max image diff {err:.3e}, "
        f"image mean {imgs[0].mean():.4f}")
    if err > 1e-3:
        raise AssertionError("sharded frame disagrees with one device")
    if imgs[0].std() == 0:
        raise AssertionError("sharded frame is constant")


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU sharded frame and its "
                         "1-device comparison")
    args = ap.parse_args()

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    with Phase("device"):
        CARD = card_line()
        print(CARD, flush=True)
        say(f"jax {jax.__version__}: platform {dev.platform}, kind "
            f"{dev.device_kind!r}, count {len(devices)}")
        say(f"compile cache: {enable_compile_cache()}")

    if args.multi:
        with Phase("multi"):
            phase_multi(WIDTH, HEIGHT)
        count = 4
    else:
        with Phase("scene"):
            t0 = time.perf_counter()
            scene = DemoScene().build()
            geo = scene["geometry"]
            transforms, palettes, _, _ = frame_inputs(scene, 64, 64)
            rows = jax.jit(lambda t, p: flatten_frame(geo, t, p))(
                transforms, palettes).bvh.rows
            say(f"DemoScene build {time.perf_counter() - t0:.1f} s: "
                f"{geo.tri.shape[0]} render tris, "
                f"{int(np.asarray(scene['collision'].valid).sum())} collision "
                f"tris, {geo.topo.node_count} BVH nodes, tree "
                f"{rows.nbytes / 2**20:.1f} MiB")
        with Phase("kernel parity"):
            phase_kernel_parity(scene, WIDTH, HEIGHT)
        # The frame, GPU-vs-CPU and raster programs are large: the side
        # frames compile in worker threads while the main thread compiles
        # the 1080p frame (host compile time dominates a cold run).
        with ThreadPoolExecutor(max_workers=3) as pool:
            side = start_side_frames(pool, scene, WIDTH, HEIGHT, 320, 180)
            with Phase("frame"):
                phase_frame(scene, WIDTH, HEIGHT, side)
            with Phase("gpu vs cpu"):
                phase_gpu_vs_cpu(side, 320, 180)
            with Phase("raster"):
                phase_raster(side, WIDTH, HEIGHT)
        count = len(devices)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
