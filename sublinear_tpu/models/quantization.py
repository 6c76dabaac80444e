"""Weight quantization for the temporal models.

Reference semantics: `QuantizedModel` / `QuantizationScheme` {Int8, Int4,
Binary} with scale/zero-point arrays and quantize/dequantize round-trips
(/root/reference/neural-network-implementation/src/models/quantization.rs).
The reference quantizes a flat f64 weight vector with one global scale; here
the device-native form quantizes a whole flax parameter pytree with symmetric
per-output-channel scales (tighter error, and the layout XLA wants: int8
weights stream from device memory at 4x the density of f32, and dequantize
fuses into the consuming matmul).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

SCHEMES = {"int8": 127.0, "int4": 7.0, "binary": 1.0}


@dataclass
class QuantizedParams:
    """Quantized parameter pytree + per-tensor (per-channel) scales."""

    q: Any        # pytree of int8 arrays (int4 stored in int8, binary in int8 ±1)
    scale: Any    # pytree of f32 scale arrays broadcastable against q
    scheme: str

    def size_bytes(self) -> int:
        leaves = jax.tree_util.tree_leaves(self.q)
        # logical export sizes: int4 packs 2/byte, binary packs 8/byte
        bits = {"int8": 8, "int4": 4, "binary": 1}[self.scheme]
        return sum(int(np.prod(x.shape)) * bits for x in leaves) // 8

    def dequantize(self):
        return jax.tree_util.tree_map(
            lambda qw, s: qw.astype(jnp.float32) * s, self.q, self.scale
        )


def _quantize_leaf(w, scheme: str, per_channel: bool):
    w = jnp.asarray(w, jnp.float32)
    if scheme == "binary":
        # W ~ scale * sign(W), scale = mean(|W|) (XNOR-net style)
        axes = tuple(range(w.ndim - 1)) if (per_channel and w.ndim >= 2) else None
        scale = jnp.mean(jnp.abs(w), axis=axes, keepdims=True)
        scale = jnp.where(scale > 0, scale, 1.0)
        q = jnp.where(w >= 0, 1, -1).astype(jnp.int8)
        return q, scale
    qmax = SCHEMES[scheme]
    axes = tuple(range(w.ndim - 1)) if (per_channel and w.ndim >= 2) else None
    absmax = jnp.max(jnp.abs(w), axis=axes, keepdims=True)
    scale = jnp.where(absmax > 0, absmax / qmax, 1.0)
    q = jnp.clip(jnp.round(w / scale), -qmax - 1, qmax).astype(jnp.int8)
    return q, scale


def quantize_tree(params, scheme: str = "int8", per_channel: bool = True) -> QuantizedParams:
    """Quantize every array leaf of a parameter pytree (symmetric, zero-point
    0 — the reference's zero_points are always 0 for its symmetric path)."""
    if scheme not in SCHEMES:
        from ..errors import InvalidParametersError

        raise InvalidParametersError(
            f"unknown quantization scheme {scheme!r}; choose from {sorted(SCHEMES)}"
        )
    leaves = jax.tree_util.tree_leaves(params)
    if not leaves:
        from ..errors import InvalidParametersError

        raise InvalidParametersError("cannot quantize an empty parameter tree")
    qs, scales = [], []
    flat, treedef = jax.tree_util.tree_flatten(params)
    for w in flat:
        q, s = _quantize_leaf(w, scheme, per_channel)
        qs.append(q)
        scales.append(s)
    return QuantizedParams(
        q=jax.tree_util.tree_unflatten(treedef, qs),
        scale=jax.tree_util.tree_unflatten(treedef, scales),
        scheme=scheme,
    )


def quantization_error(params, qp: QuantizedParams) -> dict:
    """Relative L2 reconstruction error per scheme (reference reports the
    same round-trip metric in its quantization tests)."""
    deq = qp.dequantize()
    num = 0.0
    den = 0.0
    for w, d in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(deq)):
        w = np.asarray(w, np.float64)
        d = np.asarray(d, np.float64)
        num += float(np.sum((w - d) ** 2))
        den += float(np.sum(w**2))
    rel = float(np.sqrt(num / den)) if den > 0 else 0.0
    return {"scheme": qp.scheme, "relative_l2_error": rel, "size_bytes": qp.size_bytes()}


def quantized_apply(apply_fn, qp: QuantizedParams, *args, **kwargs):
    """Run `apply_fn({'params': dequantized}, ...)` with dequantization traced
    under jit so XLA fuses scale-multiply into the consuming ops; int8
    weights are what lives in HBM."""

    @jax.jit
    def _run(q, scale, *a):
        deq = jax.tree_util.tree_map(lambda qw, s: qw.astype(jnp.float32) * s, q, scale)
        return apply_fn({"params": deq}, *a, **kwargs)

    return _run(qp.q, qp.scale, *args)
