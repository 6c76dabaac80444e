"""Sparse matrix-vector / matrix-matrix products.

This is the universal hot kernel of the whole framework: every solver's inner
loop reduces to it (reference hot kernels: CSR matvec at
/root/reference/src/matrix/sparse.rs:187, the 8-way unrolled unsafe matvec at
/root/reference/src/ultra_fast.rs:49-97, the AVX2 SIMD matvec at
/root/reference/src/simd_ops.rs:20-91, and the TS CSR matvec at
/root/reference/src/mcp/tools/solver-optimized.ts:50-67).

Device design (plain XLA, no hand-written kernel):
  * slot-major ELL: ``values``/``cols`` of shape (K, n_pad).  One SpMV = K
    vector gathers ``x[cols[k]]`` + a fused multiply-accumulate over slots —
    no scalar loops, no data-dependent shapes, fully fusable by XLA.  On a
    GPU each gathered index costs one cache sector; x stays L2-resident up
    to a few million rows.
  * COO tail for hub rows (power-law degree): entries beyond the ELL slot cap
    go to a flat COO block reduced with ``segment_sum`` (sorted rows).
  * dense path: small/dense operators use ``jnp.dot``, which streams the
    n x n matrix once per matvec at memory bandwidth.

All functions operate in the *padded* domain: vectors have length
n_pad = round_up(n, 128) with zero padding; padded ELL slots point at column 0
with value 0, so no masking is needed inside the loop.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


# All contractions use HIGHEST precision: true f32 products.  XLA:GPU may
# otherwise run f32 dots in TF32 (10-bit mantissa, ~1e-3 relative error),
# which stalls solver residuals far above the 1e-6 tolerances served here.
_PREC = jax.lax.Precision.HIGHEST


def ell_matvec(values: jax.Array, cols: jax.Array, x: jax.Array) -> jax.Array:
    """y = A @ x for slot-major ELL. values/cols: (K, n_pad); x: (m_pad,)."""
    # gather -> (K, n_pad); FMA and reduce over slots
    gathered = jnp.take(x, cols, axis=0)
    return jnp.einsum("kn,kn->n", values, gathered, precision=_PREC)


def ell_matmat(values: jax.Array, cols: jax.Array, X: jax.Array) -> jax.Array:
    """Y = A @ X for batched RHS.  X: (m_pad, B) -> (n_pad, B).

    Replaces the reference's sequential batch solve loop
    (/root/reference/src/mcp/tools/solver.ts:291-321) with one fused product.
    """
    gathered = jnp.take(X, cols, axis=0)  # (K, n_pad, B)
    return jnp.einsum("kn,knb->nb", values, gathered, precision=_PREC)


def ell_matmat_bmajor(values: jax.Array, cols: jax.Array, XT: jax.Array) -> jax.Array:
    """YT = (A @ X)^T for batch-major RHS.  XT: (B, m_pad) -> (B, n_pad).

    The batched Neumann driver keeps ALL iteration state in this layout;
    only solve entry/exit transposes."""
    g = jnp.take(XT, cols, axis=1)        # (B, K, n_pad)
    return jnp.einsum("kn,bkn->bn", values, g, precision=_PREC)


def coo_matmat_bmajor(
    vals: jax.Array, rows: jax.Array, cols: jax.Array, XT: jax.Array, n_pad: int
) -> jax.Array:
    """Tail product in batch-major layout: (B, m_pad) -> (B, n_pad)."""
    prod = vals[None, :] * jnp.take(XT, cols, axis=1)   # (B, T)
    yT = jax.ops.segment_sum(prod.T, rows, num_segments=n_pad,
                             indices_are_sorted=True)   # (n_pad, B)
    return yT.T


def coo_matvec(
    vals: jax.Array, rows: jax.Array, cols: jax.Array, x: jax.Array, n_pad: int
) -> jax.Array:
    """Tail COO product via segment_sum (rows sorted ascending at pack time)."""
    prod = vals * jnp.take(x, cols, axis=0)
    return jax.ops.segment_sum(
        prod, rows, num_segments=n_pad, indices_are_sorted=True
    )


def coo_matmat(
    vals: jax.Array, rows: jax.Array, cols: jax.Array, X: jax.Array, n_pad: int
) -> jax.Array:
    prod = vals[:, None] * jnp.take(X, cols, axis=0)
    return jax.ops.segment_sum(
        prod, rows, num_segments=n_pad, indices_are_sorted=True
    )


def dense_matvec(data: jax.Array, x: jax.Array) -> jax.Array:
    return jnp.dot(data, x, preferred_element_type=data.dtype, precision=_PREC)


def dense_matmat(data: jax.Array, X: jax.Array) -> jax.Array:
    return jnp.dot(data, X, preferred_element_type=data.dtype, precision=_PREC)
