"""Device-mesh helpers.

The reference has no distributed compute (SURVEY.md §2.7 — its only scale
mechanisms are SIMD/rayon/worker-threads).  This module is the device-mesh
scale story: a 2-D ``jax.sharding.Mesh`` over

  - ``rows``  — model-parallel axis: A's rows (and the output vector) are
                partitioned across it; the TP analog for SpMV
  - ``batch`` — data-parallel axis: independent RHS columns (batched solves,
                walker populations) are partitioned across it; the DP analog

The cards of one host reach each other all to all at one rate, so the
mesh follows the algorithm alone: by default every device sits on
``rows`` (a single-RHS solve has nothing to split over ``batch``); pass
``shape`` to give batched solves a ``batch`` axis.

PP/SP/EP do not apply to a sparse-solver workload (no layer pipeline, no
sequence dimension, no experts) — documented in SURVEY.md §2.7.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS, BATCH = "rows", "batch"


def make_mesh(devices: Optional[Sequence] = None, shape: Optional[tuple[int, int]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    rows, batch = shape if shape is not None else (n, 1)
    if rows * batch != n:
        raise ValueError(f"mesh shape {rows}x{batch} != device count {n}")
    dev_array = np.array(devices).reshape(rows, batch)
    return Mesh(dev_array, (ROWS, BATCH))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Vectors sharded over the row axis (lane-aligned blocks)."""
    return NamedSharding(mesh, P(ROWS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ell_sharding(mesh: Mesh) -> NamedSharding:
    """Slot-major ELL (K, n_pad): shard the row (lane) axis."""
    return NamedSharding(mesh, P(None, ROWS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Multi-RHS (n_pad, B): shard the batch axis."""
    return NamedSharding(mesh, P(None, BATCH))
