"""The benchmark's plain reference, written from Box2D 2.3.1's semantics
and sharing no code with the program: `geometry.py` (shapes, masses and
manifolds), `world.py` (one step of a batch of worlds) and `step.py` (its
builder, the control, and how the check follows the program)."""
