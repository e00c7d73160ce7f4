"""Joint packing and the joint-solver entry points.

Port of `box2d_mt_tpu.joints`: joints are typed structure-of-arrays blocks
(state.py), each with a leading world axis, all eleven of the JAX
package's types. The block order is the JAX package's, which fixes the
order of the joint coloring, of the island edges and of the cache
signatures.
"""

import dataclasses

import numpy as np
import torch

from .. import state as st

_BLOCK_NAMES = tuple(name for name, _ in st.JOINT_BLOCKS)

_BOOL_FIELDS = ("collide_connected", "enable_limit", "enable_motor")
_INT_FIELDS = ("body_a", "body_b", "body_c", "body_d", "joint1_type",
               "joint1_index", "joint2_type", "joint2_index", "limit_state")
_VEC2_FIELDS = ("local_anchor_a", "local_anchor_b", "local_anchor_c",
                "local_anchor_d", "local_axis_a", "local_axis_c",
                "local_axis_d", "target", "linear_offset", "ground_anchor_a",
                "ground_anchor_b")
# blocks whose `impulse` is (x, y, angular), and the (x, y) impulses
_VEC3_IMPULSE = (st.RevoluteJoints, st.PrismaticJoints, st.WeldJoints)
_VEC2_IMPULSE = {st.MouseJoints: "impulse", st.FrictionJoints: "linear_impulse",
                 st.MotorJoints: "linear_impulse"}
# scalar defaults other than 0 (b2MotorJointDef, b2PulleyJointDef,
# b2GearJointDef)
_DEFAULTS = {"correction_factor": 0.3, "ratio": 1.0}


def _pack(cls, defs, capacity=0, device="cuda"):
    """Pack a list of joint-def dicts into a one-world typed block, padded
    to `capacity` inactive slots. Impulses and limit states start at 0."""
    n = len(defs)
    cap = max(n, capacity)

    def padded(vals, dtype, width=0):
        a = np.zeros((cap,) + ((width,) if width else ()), dtype)
        if n:
            a[:n] = vals
        return a

    kw = {}
    for f in dataclasses.fields(cls):
        name = f.name
        if name == "active":
            arr = padded([True] * n, bool)
        elif name in _BOOL_FIELDS:
            arr = padded([bool(d.get(name, False)) for d in defs], bool)
        elif name in _INT_FIELDS:
            arr = padded([int(d.get(name, 0)) for d in defs], np.int32)
        elif name == "impulse" and cls in _VEC3_IMPULSE:
            arr = np.zeros((cap, 3), np.float32)
        elif name == _VEC2_IMPULSE.get(cls):
            arr = np.zeros((cap, 2), np.float32)
        elif name in _VEC2_FIELDS:
            arr = padded([d.get(name, (0.0, 0.0)) for d in defs], np.float32, 2)
        elif name.endswith("impulse"):
            arr = np.zeros(cap, np.float32)
        else:
            arr = padded([float(d.get(name, _DEFAULTS.get(name, 0.0))) for d in defs],
                         np.float32)
        kw[name] = torch.from_numpy(arr[None]).to(device)
    return cls(**kw)


def build_joints(joint_defs: dict, joint_capacity: dict = None,
                 device="cuda") -> st.Joints:
    """One-world `Joints` from {kind: [def dict, ...]}; `joint_capacity`
    maps a kind to the slots to preallocate."""
    cap = joint_capacity or {}
    for kind in list(joint_defs) + list(cap):
        if kind not in _BLOCK_NAMES:
            raise ValueError(f"unknown joint kind: {kind}")
    return st.Joints(**{
        name: _pack(cls, joint_defs.get(name, []), int(cap.get(name, 0)), device)
        for name, cls in st.JOINT_BLOCKS})


def make_empty_joints(device="cuda") -> st.Joints:
    return build_joints({}, device=device)


def blocks(joints: st.Joints):
    """The non-empty blocks as (name, block), in `_BLOCK_NAMES` order."""
    return [(n, getattr(joints, n)) for n in _BLOCK_NAMES
            if getattr(joints, n).body_a.shape[-1] > 0]


def joints_present(joints: st.Joints) -> bool:
    return bool(blocks(joints))


def build_joint_arrays(joints: st.Joints):
    """(body_a, body_b, active), each (W, J), concatenated over the blocks
    for island merging and the cache signatures; None when there is no
    joint slot."""
    bl = blocks(joints)
    if not bl:
        return None, None, None
    return (torch.cat([b.body_a for _, b in bl], 1),
            torch.cat([b.body_b for _, b in bl], 1),
            torch.cat([b.active for _, b in bl], 1))


from .solver import (init_joints, solve_joint_position,  # noqa: E402,F401
                     solve_joint_velocity, store_joint_impulses,
                     warm_start_joints)
