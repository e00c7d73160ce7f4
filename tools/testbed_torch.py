#!/usr/bin/env python3
"""Headless testbed driver of the PyTorch port (box2d_mt_tpu_torch), the
counterpart of tools/testbed.py (Testbed/Framework/Main.cpp's analog).

Steps any scene of the port's models/scenes.py and renders it through the
port's draw.py: per-step SVG frames, one SMIL-animated SVG, or a step-rate
report. It runs on the card unless `--device cpu` is given:

    python3 tools/testbed_torch.py pyramid --steps 240 --animate /tmp/pyramid.svg
    python3 tools/testbed_torch.py car --frames /tmp/car_frames
    python3 tools/testbed_torch.py tumbler --steps 600 --report
    python3 tools/testbed_torch.py edge_shapes --args '(8,)' --device cpu --report

Positional scene arguments go through --args (a Python literal tuple).
"""

import argparse
import ast
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def animate(frames, every, hz, width, height) -> str:
    """One SMIL-animated SVG of `frames` (SVG strings rendered every
    `every` steps at `hz`), each shown in turn by one repeating timer."""
    period = len(frames) * every / hz
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}">',
             f'<rect width="0" height="0"><animate id="anim" attributeName="x" from="0" '
             f'to="0" begin="0s;anim.end" dur="{period:.3f}s"/></rect>']
    for k, svg in enumerate(frames):
        inner = svg.split(">", 1)[1].rsplit("</svg>", 1)[0]
        parts.append(f'<g visibility="hidden"><set attributeName="visibility" to="visible" '
                     f'begin="anim.begin+{k * every / hz:.3f}s" dur="{every / hz:.3f}s"/>'
                     + inner + "</g>")
    parts.append("</svg>")
    return "".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", help="scene function name in models/scenes.py")
    ap.add_argument("--args", default="()",
                    help="Python literal: positional args tuple, e.g. '(8,)'")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--hz", type=float, default=60.0)
    ap.add_argument("--vel-iters", type=int, default=8)
    ap.add_argument("--pos-iters", type=int, default=3)
    ap.add_argument("--frames", default=None, help="directory for per-step SVG frames")
    ap.add_argument("--every", type=int, default=4, help="render every Nth step")
    ap.add_argument("--animate", default=None,
                    help="write ONE SMIL-animated SVG to this path")
    ap.add_argument("--report", action="store_true",
                    help="print steps/sec + body stats, render nothing")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from box2d_mt_tpu_torch import draw, settings, world
    from box2d_mt_tpu_torch.models import scenes

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("testbed_torch: no CUDA device (use --device cpu)")
    build = getattr(scenes, args.scene, None)
    if build is None or args.scene.startswith("_"):
        names = [n for n in dir(scenes) if not n.startswith("_")
                 and callable(getattr(scenes, n)) and n[0].islower()]
        sys.exit(f"unknown scene '{args.scene}'; available: " + ", ".join(sorted(names)))
    sargs = ast.literal_eval(args.args)
    if not isinstance(sargs, tuple):
        sargs = (sargs,)
    built = build(*sargs, device=args.device)
    st = built[0] if isinstance(built, tuple) else built
    aux = built[1] if isinstance(built, tuple) else None

    kinds = world.possible_kinds(st)
    dt = 1.0 / args.hz
    if args.frames:
        pathlib.Path(args.frames).mkdir(parents=True, exist_ok=True)
    frames = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        if aux is not None and "floater" in aux:
            st = scenes.floater_drive(st, aux, dt)
        st, _ = world.step(st, dt, velocity_iterations=args.vel_iters,
                           position_iterations=args.pos_iters, kinds=kinds)
        if args.report or i % args.every:
            continue
        svg = draw.draw_svg(st, width=args.width, height=args.height, scale=args.scale)
        if args.frames:
            (pathlib.Path(args.frames) / f"frame_{i:05d}.svg").write_text(svg)
        if args.animate:
            frames.append(svg)
    if st.bodies.c.is_cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0

    b = st.bodies
    awake = int((b.awake & (b.body_type == settings.DYNAMIC_BODY)).sum())
    live = int((b.body_type >= 0).sum())
    print(f"{args.scene}: {args.steps} steps in {elapsed:.2f}s "
          f"({args.steps / elapsed:.1f} steps/s, first use included), "
          f"{live} bodies, {awake} awake at end")
    if args.animate and frames:
        pathlib.Path(args.animate).write_text(
            animate(frames, args.every, args.hz, args.width, args.height))
        print(f"wrote {args.animate} ({len(frames)} frames, "
              f"{len(frames) * args.every / args.hz:.1f}s loop)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
