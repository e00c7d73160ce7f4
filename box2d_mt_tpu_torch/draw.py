"""Headless draw-data export, the b2Draw interface analog
(Box2D/Common/b2Draw.h:52-57, b2World::DrawDebugData, b2World.cpp:1928).

Port of `box2d_mt_tpu.draw`. There is no GUI: `draw_data(state)` returns
plain tensors with a leading world axis that a host renderer can consume,
and `draw_svg(state, world)` renders one world to a standalone SVG string.
"""

from typing import NamedTuple

import torch

from . import settings
from .math2d import body_xf, rot_vec, take
from .state import State


class DrawData(NamedTuple):
    """World-space geometry per fixture slot (mask with `exists`)."""
    exists: torch.Tensor      # (W, F) bool
    shape_type: torch.Tensor  # (W, F) i32
    verts: torch.Tensor       # (W, F, 8, 2) world space (circle: center at [0])
    nverts: torch.Tensor      # (W, F) i32
    radius: torch.Tensor      # (W, F)
    body: torch.Tensor        # (W, F) i32
    awake: torch.Tensor       # (W, F) bool, of the owning body
    sensor: torch.Tensor      # (W, F) bool
    aabb_lo: torch.Tensor     # (W, F, 2) fat AABBs (the e_aabbBit analog)
    aabb_hi: torch.Tensor


def draw_data(state: State) -> DrawData:
    """World-space draw data of every world."""
    fx, b = state.fixtures, state.bodies
    p, q = body_xf(b.c, b.a, b.local_center)
    fb = fx.body.clamp_min(0).long()
    verts = rot_vec(take(q, fb)[:, :, None, :], fx.verts) + take(p, fb)[:, :, None, :]
    return DrawData(exists=fx.body >= 0, shape_type=fx.shape_type, verts=verts,
                    nverts=fx.nverts, radius=fx.radius, body=fx.body,
                    awake=take(b.awake, fb), sensor=fx.is_sensor,
                    aabb_lo=fx.aabb_lo, aabb_hi=fx.aabb_hi)


def draw_svg(state: State, world: int = 0, width=640, height=480, scale=10.0,
             center=(0.0, 10.0)) -> str:
    """Render world `world` of the batch to a standalone SVG string."""
    d = DrawData(*(x[world].cpu().numpy() for x in draw_data(state)))
    cx, cy = center
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" viewBox="0 0 {width} {height}">',
             '<rect width="100%" height="100%" fill="#10141a"/>']

    def to_px(x, y):
        return width / 2 + (x - cx) * scale, height / 2 - (y - cy) * scale

    for i in range(len(d.exists)):
        if not d.exists[i]:
            continue
        color = "#8bc34a" if d.awake[i] else "#607d8b"
        if d.sensor[i]:
            color = "#ffc107"
        st = int(d.shape_type[i])
        if st == settings.SHAPE_CIRCLE:
            x, y = to_px(d.verts[i, 0, 0], d.verts[i, 0, 1])
            parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" '
                         f'r="{d.radius[i] * scale:.1f}" fill="none" '
                         f'stroke="{color}"/>')
        elif st == settings.SHAPE_EDGE:
            x1, y1 = to_px(d.verts[i, 0, 0], d.verts[i, 0, 1])
            x2, y2 = to_px(d.verts[i, 1, 0], d.verts[i, 1, 1])
            parts.append(f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
                         f'y2="{y2:.1f}" stroke="{color}"/>')
        else:
            pts = " ".join("{:.1f},{:.1f}".format(*to_px(d.verts[i, k, 0], d.verts[i, k, 1]))
                           for k in range(int(d.nverts[i])))
            parts.append(f'<polygon points="{pts}" fill="none" stroke="{color}"/>')
    parts.append("</svg>")
    return "\n".join(parts)
