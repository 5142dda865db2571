#!/usr/bin/env python
"""Interactive demo shell: live keyboard input -> engine frames -> terminal.

The analog of the reference's app shell (GameViewController.viewDidLoad
wiring MTKView -> Renderer -> DemoScene + GameController input,
reference: Game/GameViewController.swift:24-62, Game/InputSystem.swift:70-149):
a host loop polls the keyboard in raw mode, builds an InputFrame per frame,
drives Engine.frame, and presents each frame as 24-bit ANSI half-blocks
(2 pixels per character cell) with a host-measured FPS readout.

Keys:
  w/a/s/d  move (camera-relative)     arrows   camera look
  space    jump                       x        dodge
  r        toggle run (hold-style)    q / ESC  quit

Usage:
  python examples/play.py [--width 192] [--height 108] [--path rt]
  python examples/play.py --frames 60          # scripted, no TTY needed
"""

import argparse
import os
import select
import sys
import termios
import time
import tty

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def ansi_frame(img: np.ndarray) -> str:
    """(H,W,3) u8 -> ANSI half-block string (H/2 rows)."""
    h = img.shape[0] - (img.shape[0] % 2)
    top = img[0:h:2]
    bot = img[1:h:2]
    rows = []
    for ti, bi in zip(top, bot):
        cells = []
        prev = None
        for (tr, tg, tb), (br, bg, bb) in zip(ti, bi):
            code = (f"\x1b[38;2;{tr};{tg};{tb}m"
                    f"\x1b[48;2;{br};{bg};{bb}m")
            cells.append((code if code != prev else "") + "▀")
            prev = code
        rows.append("".join(cells))
    return "\x1b[H" + "\x1b[0m\n".join(rows) + "\x1b[0m"


class Keyboard:
    """Raw-mode non-blocking key poller with hold emulation.

    A terminal delivers key *repeats*, not press/release, so a key counts as
    held for `hold_s` after its last repeat."""

    def __init__(self, hold_s=0.25):
        self.hold_s = hold_s
        self.last = {}
        self.edges = set()
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)

    def restore(self):
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def poll(self):
        now = time.time()
        while select.select([sys.stdin], [], [], 0)[0]:
            c = os.read(self.fd, 1).decode(errors="ignore")
            if c == "\x1b":  # escape or arrow sequence
                seq = ""
                while select.select([sys.stdin], [], [], 0)[0] and len(seq) < 2:
                    seq += os.read(self.fd, 1).decode(errors="ignore")
                c = {"[A": "UP", "[B": "DOWN", "[C": "RIGHT", "[D": "LEFT"}.get(
                    seq, "ESC")
            if c in (" ",):
                c = "SPACE"
            self.last[c] = now
            self.edges.add(c)

    def held(self, key):
        return time.time() - self.last.get(key, -1e9) < self.hold_s

    def edge(self, key):
        if key in self.edges:
            self.edges.discard(key)
            return True
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=108)
    ap.add_argument("--path", choices=["rt", "raster"], default="rt")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--shadow-layers", type=int, default=4)
    ap.add_argument("--no-assets", action="store_true")
    ap.add_argument("--frames", type=int, default=0,
                    help="scripted frame count (no TTY; for CI/smoke)")
    args = ap.parse_args()

    from swift_game_engine_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    from swift_game_engine_tpu.scene.demo_scene import DemoScene
    from swift_game_engine_tpu.scene.engine import Engine
    from swift_game_engine_tpu.scene.input import InputFrame

    print("building scene...", flush=True)
    scene = DemoScene(include_imported_assets=not args.no_assets).build()
    eng = Engine(scene, width=args.width, height=args.height, path=args.path,
                 max_layers=args.layers, shadow_layers=args.shadow_layers)
    print("compiling frame program...", flush=True)
    eng.frame(1.0 / 60.0, InputFrame())

    if args.frames:  # scripted smoke path
        t0 = time.time()
        for i in range(args.frames):
            eng.frame(1.0 / 60.0, InputFrame(ly=1.0))
        print(f"{args.frames} frames, {args.frames/(time.time()-t0):.2f} fps")
        return

    kb = Keyboard()
    ema = None
    try:
        sys.stdout.write("\x1b[2J")  # clear
        last = time.time()
        run_mode = False
        while True:
            kb.poll()
            if kb.edge("q") or kb.edge("ESC"):
                break
            if kb.edge("r"):
                run_mode = not run_mode
            mag = 1.0 if run_mode else 0.6
            pad = InputFrame(
                lx=(kb.held("d") - kb.held("a")) * mag,
                ly=(kb.held("w") - kb.held("s")) * mag,
                rx=(kb.held("RIGHT") - kb.held("LEFT")) * 1.0,
                ry=(kb.held("UP") - kb.held("DOWN")) * 1.0,
                jump=kb.edge("SPACE"),
                dodge=kb.edge("x"),
                # +/- drive the exposure axis (InputSystem.exposureDelta):
                # integrated as exposure += delta * dt, clamped [0.1, 2.0]
                exposure_delta=(kb.held("=") or kb.held("+")) * 1.0
                - kb.held("-") * 1.0)
            now = time.time()
            dt, last = now - last, now
            u8 = np.asarray(eng.frame(dt, pad))
            # EMA FPS (FPSOverlaySystem 0.9/0.1 smoothing)
            inst = 1.0 / max(time.time() - now, 1e-6)
            ema = inst if ema is None else 0.9 * ema + 0.1 * inst
            sys.stdout.write(ansi_frame(u8))
            sys.stdout.write(f"\x1b[0m\n{ema:5.1f} fps   wasd move, arrows look, "
                             f"space jump, x dodge, r run[{'on' if run_mode else 'off'}], "
                             f"+/- exposure[{eng.tone_mapping_exposure:.2f}], q quit  ")
            sys.stdout.flush()
    finally:
        kb.restore()
        sys.stdout.write("\x1b[0m\n")


if __name__ == "__main__":
    main()
