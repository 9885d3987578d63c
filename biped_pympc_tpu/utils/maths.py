"""Batched rotation / quaternion / skew utilities (pure JAX).

JAX re-expression of the reference's torch utilities
(`/root/reference/biped_pympc/utils/math_utils.py:3-177`). All functions are
written single-sample and are `jax.vmap`/`jax.jit` friendly; most callers vmap
them over a leading env-batch axis. Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import jax.numpy as jnp


def rot_x(angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation about x. angle: scalar or (...,) -> (..., 3, 3).

    Parity: `math_utils.py:4-18`.
    """
    c, s = jnp.cos(angle), jnp.sin(angle)
    o, z = jnp.ones_like(angle), jnp.zeros_like(angle)
    return jnp.stack(
        [
            jnp.stack([o, z, z], axis=-1),
            jnp.stack([z, c, -s], axis=-1),
            jnp.stack([z, s, c], axis=-1),
        ],
        axis=-2,
    )


def rot_y(angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation about y (`math_utils.py:21-34`)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    o, z = jnp.ones_like(angle), jnp.zeros_like(angle)
    return jnp.stack(
        [
            jnp.stack([c, z, s], axis=-1),
            jnp.stack([z, o, z], axis=-1),
            jnp.stack([-s, z, c], axis=-1),
        ],
        axis=-2,
    )


def rot_z(angle: jnp.ndarray) -> jnp.ndarray:
    """Rotation about z (`math_utils.py:37-50`)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    o, z = jnp.ones_like(angle), jnp.zeros_like(angle)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], axis=-1),
            jnp.stack([s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )


def quat_to_rotmat(quat: jnp.ndarray) -> jnp.ndarray:
    """Unit-normalized (w,x,y,z) quaternion -> (..., 3, 3) rotation matrix.

    Parity: `math_utils.py:53-108` (normalizes before converting).
    """
    quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = jnp.stack(
        [
            jnp.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], axis=-1),
        ],
        axis=-2,
    )
    return r


def quat_to_euler(quat: jnp.ndarray) -> jnp.ndarray:
    """(w,x,y,z) quaternion -> (..., 3) roll/pitch/yaw.

    Parity: `math_utils.py:111-148` (including the extra atan2(sin, cos)
    wrap, which is an identity on atan2 output but kept for bit-parity).
    """
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = jnp.arctan2(sinr_cosp, cosr_cosp)

    sinp = jnp.clip(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = jnp.arcsin(sinp)

    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = jnp.arctan2(siny_cosp, cosy_cosp)
    return jnp.stack([roll, pitch, yaw], axis=-1)


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix.

    Parity: `math_utils.py:153-167`.
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-1),
            jnp.stack([z, o, -x], axis=-1),
            jnp.stack([-y, x, o], axis=-1),
        ],
        axis=-2,
    )


def unskew(m: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) skew matrix -> (..., 3) (`math_utils.py:170-177`)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)
