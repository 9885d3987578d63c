"""Batched small-matrix linear algebra written as elementwise steps.

The solver inverts many tiny stage blocks per env. Instead of XLA's
generic batched LU (`jnp.linalg.inv` / `lu_factor`), which lowers to a
sequential, dynamically-sliced loop, Gauss-Jordan elimination with partial
pivoting runs every step as a batched elementwise operation over the whole
(batch, n, 2n) tableau:

  * pivot search: masked |column| argmax over rows — one reduction
  * row swap: two one-hot masked selects (no gather/scatter of rows)
  * elimination: one rank-1 update of the full tableau

n sequential steps remain (inherent); each is wide, regular work that XLA
fuses across the batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inverse_3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 inverse (adjugate / determinant), batch-friendly.

    Pure elementwise math — no LU custom call, no sequential loop; the
    right tool for inertia tensors and Gauss-Newton normal matrices.
    Accepts (..., 3, 3).
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack([
        jnp.stack([co_a, c * h - b * i, b * f - c * e], axis=-1),
        jnp.stack([co_b, a * i - c * g, c * d - a * f], axis=-1),
        jnp.stack([co_c, b * g - a * h, a * e - b * d], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


def gauss_jordan_inverse(a: jnp.ndarray) -> jnp.ndarray:
    """Invert a batch of small square matrices with partial pivoting.

    a: (..., n, n) -> (..., n, n). All operations vectorize over the batch;
    per-env pivot choices differ freely (data, not control flow).
    """
    n = a.shape[-1]
    batch_shape = a.shape[:-2]
    dtype = a.dtype

    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), batch_shape + (n, n))
    aug = jnp.concatenate([a, eye], axis=-1)  # (..., n, 2n)
    row_idx = jnp.arange(n)

    def body(k, aug):
        # --- pivot selection: largest |entry| in column k, rows >= k ---
        col = jnp.abs(
            jax.lax.dynamic_index_in_dim(aug, k, axis=-1, keepdims=False)
        )  # (..., n)
        cand = jnp.where(row_idx >= k, col, -1.0)
        p = jnp.argmax(cand, axis=-1)  # (...,)

        # --- swap rows k <-> p via masked selects ---
        onehot_p = row_idx == p[..., None]  # (..., n)
        is_k = row_idx == k  # (n,)
        row_k = jax.lax.dynamic_index_in_dim(aug, k, axis=-2, keepdims=False)
        row_p = jnp.sum(
            jnp.where(onehot_p[..., None], aug, 0.0), axis=-2
        )  # (..., 2n)
        aug = jnp.where(
            is_k[:, None], row_p[..., None, :],
            jnp.where(onehot_p[..., None], row_k[..., None, :], aug),
        )

        # --- normalize pivot row, eliminate every other row ---
        # pivot = aug[..., k, k] after the swap (= row_p's entry k).
        pivot = jax.lax.dynamic_index_in_dim(row_p, k, axis=-1, keepdims=False)
        pivot_row = row_p / pivot[..., None]  # (..., 2n)
        aug = jnp.where(is_k[:, None], pivot_row[..., None, :], aug)
        factors = jnp.where(
            is_k,
            0.0,
            jax.lax.dynamic_index_in_dim(aug, k, axis=-1, keepdims=False),
        )  # (..., n)
        aug = aug - factors[..., None] * pivot_row[..., None, :]
        return aug

    aug = jax.lax.fori_loop(0, n, body, aug)
    return aug[..., n:]
