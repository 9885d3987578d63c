"""Generic serial-chain forward kinematics + geometric Jacobian (pure JAX).

JAX replacement for the reference's Pinocchio + pinocchio.casadi
kinematics generator (`/root/reference/biped_pympc/casadi/t1_kinematics.py`):
instead of building CasADi graphs from a URDF through a C++ rigid-body
library, a serial chain is described by per-joint (origin, axis) constants and
evaluated directly in JAX — batched, jit-able, differentiable.

The Jacobian convention matches Pinocchio's LOCAL_WORLD_ALIGNED frame Jacobian
(`t1_kinematics.py:56-75`): linear rows at the frame origin expressed in world
axes, angular rows = world-frame joint axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from biped_pympc_tpu.utils.maths import rot_x, rot_y, rot_z


class SerialChain(NamedTuple):
    """Fixed-topology serial chain: all joints revolute about x, y, or z.

    base_offset: (3,) translation from the root frame to the first joint's
        parent frame; joint_offsets: (n, 3) translation from joint i-1 frame
        to joint i; axes: length-n string over {'x','y','z'}; tip_offset:
        (3,) fixed transform from the last joint frame to the end-effector.
    """

    base_offset: np.ndarray
    joint_offsets: np.ndarray  # (n, 3)
    axes: str
    tip_offset: np.ndarray  # (3,)

    @property
    def num_dof(self) -> int:
        return len(self.axes)


_ROT = {"x": rot_x, "y": rot_y, "z": rot_z}


def forward_kinematics(chain: SerialChain, q: jnp.ndarray):
    """q: (n,) -> (p_tip (3,), (origins (n, 3), axes_world (n, 3)))."""
    dtype = q.dtype
    axis_vecs = {
        "x": jnp.asarray([1.0, 0.0, 0.0], dtype),
        "y": jnp.asarray([0.0, 1.0, 0.0], dtype),
        "z": jnp.asarray([0.0, 0.0, 1.0], dtype),
    }
    r = jnp.eye(3, dtype=dtype)
    t = jnp.asarray(chain.base_offset, dtype)
    origins = []
    axes_world = []
    for i, ax in enumerate(chain.axes):
        t = t + r @ jnp.asarray(chain.joint_offsets[i], dtype)
        origins.append(t)
        r = r @ _ROT[ax](q[i])
        axes_world.append(r @ axis_vecs[ax])
    p_tip = t + r @ jnp.asarray(chain.tip_offset, dtype)
    return p_tip, (jnp.stack(origins), jnp.stack(axes_world))


def tip_position(chain: SerialChain, q: jnp.ndarray) -> jnp.ndarray:
    return forward_kinematics(chain, q)[0]


def geometric_jacobian(chain: SerialChain, q: jnp.ndarray) -> jnp.ndarray:
    """(6, n) LOCAL_WORLD_ALIGNED frame Jacobian at the tip."""
    p_tip, (origins, axes) = forward_kinematics(chain, q)
    lin = jnp.cross(axes, p_tip[None, :] - origins)
    return jnp.concatenate([lin.T, axes.T], axis=0)
