"""Compensated (Kahan/Neumaier) reductions.

Parity-plus: the reference accumulates in f64 natively; on the device (f32 compute)
compensated summation recovers most of the lost accumulation accuracy for
long reductions — used where a single dot product's rounding matters (e.g.
residual certification of very large systems).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def kahan_sum(x: jax.Array) -> jax.Array:
    """Neumaier-compensated sum: pairwise within 1024-element blocks,
    compensated scan across blocks.

    Guarantee: across-block accumulation error is eliminated (the dominant
    term for long sums of similar magnitudes — the solver residual/dot use
    case).  Adversarial cancellation WITHIN a block is bounded by pairwise
    summation only; per-element compensation would serialize the VPU."""
    flat = x.reshape(-1)
    BLOCK = 1024
    pad = (-flat.shape[0]) % BLOCK
    flat = jnp.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK).sum(axis=1)  # pairwise within blocks

    def body(carry, b):
        s, c = carry
        t = s + b
        c_new = jnp.where(
            jnp.abs(s) >= jnp.abs(b), (s - t) + b, (b - t) + s
        )
        return (t, c + c_new), None

    (s, c), _ = jax.lax.scan(body, (jnp.asarray(0.0, x.dtype), jnp.asarray(0.0, x.dtype)), blocks)
    return s + c


def compensated_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return kahan_sum(a * b)


def compensated_norm(v: jax.Array) -> jax.Array:
    # scale for overflow safety, then compensated sum of squares
    m = jnp.maximum(jnp.max(jnp.abs(v)), 1e-30)
    w = v / m
    return m * jnp.sqrt(kahan_sum(w * w))
