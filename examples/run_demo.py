#!/usr/bin/env python
"""Run the DemoScene headless: simulate + render frames to PNG.

Usage:
  python examples/run_demo.py --frames 4 --width 320 --height 180 \
      --path rt --out demo_frames

Needs Pillow (only this example does).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--path", choices=["rt", "raster"], default="rt")
    ap.add_argument("--out", default="demo_frames")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--shadow-layers", type=int, default=4)
    ap.add_argument("--no-assets", action="store_true",
                    help="skip imported static assets (smaller scene)")
    args = ap.parse_args()

    from swift_game_engine_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    from swift_game_engine_tpu.scene.engine import Engine
    from swift_game_engine_tpu.scene.input import InputFrame

    t0 = time.time()
    scene = DemoScene(include_imported_assets=not args.no_assets).build()
    print(f"scene build: {time.time()-t0:.1f}s — "
          f"{scene['geometry'].tri.shape[0]} render tris, "
          f"{int(np.asarray(scene['collision'].valid).sum())} collision tris, "
          f"{scene['spec'].n_entities} entities", flush=True)

    eng = Engine(scene, width=args.width, height=args.height, path=args.path,
                 max_layers=args.layers, shadow_layers=args.shadow_layers)

    os.makedirs(args.out, exist_ok=True)
    from PIL import Image
    dt = 1.0 / 60.0
    # Scripted input: push forward, then turn.
    for i in range(args.frames):
        pad = InputFrame(ly=1.0 if i > 0 else 0.0, rx=0.2 if i > 2 else 0.0)
        t0 = time.time()
        u8 = eng.frame(dt, pad)
        wall = time.time() - t0
        p = os.path.join(args.out, f"frame_{i:03d}.png")
        Image.fromarray(u8).save(p)
        print(f"frame {i}: {wall*1000:.0f} ms -> {p}", flush=True)
    # report sim state sanity
    e = eng.player
    print("player pos:", np.asarray(eng.state.body_pos[e]),
          "grounded:", bool(eng.state.ctrl.grounded[e]),
          "loco state:", int(eng.state.loco.state[e]), flush=True)


if __name__ == "__main__":
    main()
