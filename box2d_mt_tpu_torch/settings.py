"""Global tuning constants.

Functional equivalents of the reference's compile-time tuning constants
(reference: Box2D/Common/b2Settings.h:55-178). Values are kept verbatim —
they define solver behavior (slop, Baumgarte, thresholds) and therefore
trajectory parity with the reference.

Unlike the reference (C preprocessor defines), these are plain Python module
constants baked into jitted programs as compile-time scalars.
"""

import math

# ---------------------------------------------------------------- collision
# b2Settings.h:59 — max contact points between two convex shapes.
MAX_MANIFOLD_POINTS = 2
# b2Settings.h:63 — max vertices of a convex polygon.
MAX_POLYGON_VERTICES = 8
# b2Settings.h:68 — AABB fattening margin (meters).
AABB_EXTENSION = 0.1
# b2Settings.h:73 — predictive AABB displacement multiplier.
AABB_MULTIPLIER = 2.0
# b2Settings.h:77 — collision/constraint tolerance (meters).
LINEAR_SLOP = 0.005
# b2Settings.h:81 — angular tolerance (radians).
ANGULAR_SLOP = 2.0 / 180.0 * math.pi
# b2Settings.h:86 — polygon/edge skin radius.
POLYGON_RADIUS = 2.0 * LINEAR_SLOP
# b2Settings.h:89 — max CCD sub-steps per contact.
MAX_SUB_STEPS = 8

# ----------------------------------------------------------------- dynamics
# b2Settings.h:95 — max contacts handled per TOI impact island.
MAX_TOI_CONTACTS = 32
# b2Settings.h:99 — relative-velocity threshold for restitution.
VELOCITY_THRESHOLD = 1.0
# b2Settings.h:103 — max linear position correction per NGS iteration.
MAX_LINEAR_CORRECTION = 0.2
# b2Settings.h:107 — max angular position correction per NGS iteration.
MAX_ANGULAR_CORRECTION = 8.0 / 180.0 * math.pi
# b2Settings.h:111-117 — velocity integration clamps.
MAX_TRANSLATION = 2.0
MAX_TRANSLATION_SQUARED = MAX_TRANSLATION * MAX_TRANSLATION
MAX_ROTATION = 0.5 * math.pi
MAX_ROTATION_SQUARED = MAX_ROTATION * MAX_ROTATION
# b2Settings.h:122-123 — position-correction scale factors.
BAUMGARTE = 0.2
TOI_BAUMGARTE = 0.75

# -------------------------------------------------------------------- sleep
# b2Settings.h:129 — stillness time before sleep (seconds).
TIME_TO_SLEEP = 0.5
# b2Settings.h:132 — linear sleep tolerance (m/s).
LINEAR_SLEEP_TOLERANCE = 0.01
# b2Settings.h:135 — angular sleep tolerance (rad/s).
ANGULAR_SLEEP_TOLERANCE = 2.0 / 180.0 * math.pi

# -------------------------------------------------- TPU-build specific knobs
# The reference's MT constants (b2Settings.h:162-174) have no referent here:
# parallelism is vector lanes + vmapped worlds, not threads. The analogous
# capacity knobs for the fixed-shape TPU state are below; they are *defaults*
# used by the world builder, overridable per world.

# Default max graph colors for the colored Gauss-Seidel solver. Constraints
# that fail to color within this budget fall into the final color and are
# solved with averaged (Jacobi) impulses; diagnostics report overflow.
MAX_COLORS = 24

# Body type codes (reference: b2Body.h:40-45 enum b2BodyType).
STATIC_BODY = 0
KINEMATIC_BODY = 1
DYNAMIC_BODY = 2

# Shape type codes (reference: b2Shape.h:46-52).
SHAPE_CIRCLE = 0
SHAPE_EDGE = 1
SHAPE_POLYGON = 2
# Chain shapes are decomposed into edge child fixtures at build time
# (reference: b2ChainShape::GetChildEdge), so no runtime chain type exists.

# Manifold type codes (reference: b2Collision.h:99 b2Manifold::Type).
MANIFOLD_CIRCLES = 0
MANIFOLD_FACE_A = 1
MANIFOLD_FACE_B = 2

# Sentinel for empty contact slots.
NULL_PAIR = -1
