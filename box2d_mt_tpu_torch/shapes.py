"""Host-side shape definitions used at world-construction time.

A copy of `box2d_mt_tpu.shapes`: circles, edges with ghost vertices,
polygons (box helper, weld + gift-wrap hull, mass) and chains. numpy
only; `WorldBuilder.freeze()` packs them into the dense `Fixtures`
tensors. Chains are decomposed into edge children here (reference:
b2ChainShape::GetChildEdge), so the device only sees circle, edge and
polygon rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from . import settings


@dataclasses.dataclass
class MassData:
    """Equivalent of b2MassData (b2Shape.h:28-42)."""
    mass: float
    center: Tuple[float, float]
    inertia: float  # about the body origin


@dataclasses.dataclass
class Circle:
    """b2CircleShape (Shapes/b2CircleShape.h)."""
    radius: float
    center: Tuple[float, float] = (0.0, 0.0)

    def compute_mass(self, density: float) -> MassData:
        # b2CircleShape::ComputeMass (b2CircleShape.cpp:73-80)
        mass = density * math.pi * self.radius * self.radius
        cx, cy = self.center
        inertia = mass * (0.5 * self.radius * self.radius + cx * cx + cy * cy)
        return MassData(mass, (cx, cy), inertia)


@dataclasses.dataclass
class Edge:
    """b2EdgeShape with optional ghost vertices (Shapes/b2EdgeShape.h)."""
    v1: Tuple[float, float]
    v2: Tuple[float, float]
    v0: Optional[Tuple[float, float]] = None  # ghost preceding v1
    v3: Optional[Tuple[float, float]] = None  # ghost following v2

    radius: float = settings.POLYGON_RADIUS

    def compute_mass(self, density: float) -> MassData:
        # b2EdgeShape::ComputeMass (b2EdgeShape.cpp:123-129): massless.
        del density
        cx = 0.5 * (self.v1[0] + self.v2[0])
        cy = 0.5 * (self.v1[1] + self.v2[1])
        return MassData(0.0, (cx, cy), 0.0)


@dataclasses.dataclass
class Polygon:
    """b2PolygonShape (Shapes/b2PolygonShape.h). Construct via `box()` or
    `from_vertices()` (which runs the reference's weld + gift-wrap hull,
    b2PolygonShape.cpp Set())."""
    vertices: np.ndarray  # (n, 2) f32, CCW hull
    normals: np.ndarray   # (n, 2) f32
    centroid: np.ndarray  # (2,) f32
    radius: float = settings.POLYGON_RADIUS

    @staticmethod
    def box(hx: float, hy: float, center=(0.0, 0.0), angle: float = 0.0) -> "Polygon":
        # b2PolygonShape::SetAsBox (b2PolygonShape.cpp:23-60)
        verts = np.array([[-hx, -hy], [hx, -hy], [hx, hy], [-hx, hy]], np.float32)
        norms = np.array([[0, -1], [1, 0], [0, 1], [-1, 0]], np.float32)
        c = np.asarray(center, np.float32)
        if angle != 0.0 or np.any(c != 0.0):
            s, co = math.sin(angle), math.cos(angle)
            rot = np.array([[co, -s], [s, co]], np.float32)
            verts = verts @ rot.T + c
            norms = norms @ rot.T
        return Polygon(verts, norms, c)

    @staticmethod
    def from_vertices(points: Sequence[Tuple[float, float]]) -> "Polygon":
        # b2PolygonShape::Set (b2PolygonShape.cpp): weld near-duplicate
        # vertices, gift-wrap convex hull, CCW order, compute normals+centroid.
        pts = np.asarray(points, np.float32)
        if not 3 <= len(pts) <= settings.MAX_POLYGON_VERTICES:
            raise ValueError(f"a polygon takes 3..{settings.MAX_POLYGON_VERTICES} "
                             f"vertices, got {len(pts)}")
        weld_tol2 = (0.5 * settings.LINEAR_SLOP) ** 2
        ps = []
        for v in pts:
            if all(np.sum((v - p) ** 2) >= weld_tol2 for p in ps):
                ps.append(v)
        ps = np.asarray(ps, np.float32)
        n = len(ps)
        if n < 3:
            raise ValueError("degenerate polygon")
        # right-most (then lowest) start point
        i0 = 0
        for i in range(1, n):
            if ps[i, 0] > ps[i0, 0] or (ps[i, 0] == ps[i0, 0] and ps[i, 1] < ps[i0, 1]):
                i0 = i
        hull = []
        ih = i0
        while True:
            hull.append(ih)
            ie = 0
            for j in range(1, n):
                if ie == ih:
                    ie = j
                    continue
                r = ps[ie] - ps[hull[-1]]
                v = ps[j] - ps[hull[-1]]
                c = r[0] * v[1] - r[1] * v[0]
                if c < 0.0 or (c == 0.0 and np.dot(v, v) > np.dot(r, r)):
                    ie = j
            ih = ie
            if ie == i0:
                break
        verts = ps[hull]
        m = len(verts)
        normals = np.zeros((m, 2), np.float32)
        for i in range(m):
            edge = verts[(i + 1) % m] - verts[i]
            ln = math.sqrt(float(edge @ edge))
            normals[i] = np.array([edge[1], -edge[0]]) / ln
        return Polygon(verts, normals, _polygon_centroid(verts))

    def compute_mass(self, density: float) -> MassData:
        # b2PolygonShape::ComputeMass (b2PolygonShape.cpp): triangle fan about
        # the vertex mean, area-weighted centroid, parallel-axis inertia.
        verts = np.asarray(self.vertices, np.float64)
        s = verts.mean(axis=0)
        center = np.zeros(2)
        area = 0.0
        inertia = 0.0
        m = len(verts)
        for i in range(m):
            e1 = verts[i] - s
            e2 = verts[(i + 1) % m] - s
            d = e1[0] * e2[1] - e1[1] * e2[0]
            tri_area = 0.5 * d
            area += tri_area
            center += tri_area / 3.0 * (e1 + e2)
            intx2 = e1[0] ** 2 + e2[0] * e1[0] + e2[0] ** 2
            inty2 = e1[1] ** 2 + e2[1] * e1[1] + e2[1] ** 2
            inertia += (0.25 / 3.0 * d) * (intx2 + inty2)
        mass = density * area
        center /= area
        com = center + s
        inertia = density * inertia + mass * (com @ com - center @ center)
        return MassData(float(mass), (float(com[0]), float(com[1])), float(inertia))


@dataclasses.dataclass
class Chain:
    """b2ChainShape (Shapes/b2ChainShape.h). `children()` yields per-edge
    Edge shapes with ghost vertices from neighbors, replicating
    b2ChainShape::GetChildEdge (b2ChainShape.cpp:148-180)."""
    vertices: Sequence[Tuple[float, float]]
    loop: bool = False
    # CreateChain's optional explicit ghosts (b2ChainShape.h:79-87)
    prev_vertex: Optional[Tuple[float, float]] = None
    next_vertex: Optional[Tuple[float, float]] = None

    def children(self):
        v = [tuple(map(float, p)) for p in self.vertices]
        n = len(v)
        if self.loop:
            # b2ChainShape::CreateLoop: n children, wraparound ghosts
            for i in range(n):
                yield Edge(v1=v[i], v2=v[(i + 1) % n],
                           v0=v[(i - 1) % n], v3=v[(i + 2) % n])
        else:
            for i in range(n - 1):
                v0 = v[i - 1] if i > 0 else self.prev_vertex
                v3 = v[i + 2] if i < n - 2 else self.next_vertex
                yield Edge(v1=v[i], v2=v[i + 1], v0=v0, v3=v3)


def _polygon_centroid(verts: np.ndarray) -> np.ndarray:
    # b2PolygonShape ComputeCentroid (b2PolygonShape.cpp)
    verts = np.asarray(verts, np.float64)
    c = np.zeros(2)
    area = 0.0
    p_ref = verts.mean(axis=0)
    for i in range(len(verts)):
        p1 = verts[i] - p_ref
        p2 = verts[(i + 1) % len(verts)] - p_ref
        d = p1[0] * p2[1] - p1[1] * p2[0]
        tri_area = 0.5 * d
        area += tri_area
        c += tri_area / 3.0 * (p1 + p2)
    return np.asarray(c / area + p_ref, np.float32)
