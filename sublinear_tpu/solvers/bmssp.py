"""BMSSP — bounded multi-source shortest-path approximate solver.

Reference: /root/reference/src/bmssp.rs — treats the matrix as a graph with
edge cost 1/|a_ij|, runs multi-source bounded Dijkstra from the nonzero RHS
entries, sets x_i = b_src/(1+dist_i), auto-selects CG for small/dense
matrices (:79-90) and falls back to CG when more than n/2 nodes are visited
(:133-138); classifier at :205-219.  The JS port is
/root/reference/js/bmssp-solver.js.

Device re-design (SURVEY.md §7 hard-parts): priority-queue Dijkstra is
sequential, so the solve becomes *bulk frontier relaxation* (Bellman-Ford
sweeps): every sweep relaxes ALL in-edges at once on the VPU,

    dist_j = min(dist_j, min_k dist[src_k(j)] + cost_k(j))    (bounded)

which reaches the same fixed point as Dijkstra in <= diameter sweeps.  The
source value rides along with the distance (take_along_axis on the argmin),
giving x_i = b_src/(1+dist_i) exactly as the reference computes it.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..config import resolve_dtype
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base, cg as _cg

INF = 1e30
MAX_SWEEPS = 128  # diameter cap; random sparse graphs have tiny diameters


class InEdgeTables:
    def __init__(self, srcs, costs, n_pad):
        self.srcs = srcs    # (n_pad, K) int32 — source node of each in-edge
        self.costs = costs  # (n_pad, K) — 1/|a_ij|, INF padding
        self.n_pad = n_pad


from ..utils.lru import LRUCache

_TABLE_CACHE = LRUCache(maxsize=32)


def in_edge_tables(matrix: Matrix, dtype=None) -> InEdgeTables:
    key = (matrix.uid, str(resolve_dtype(dtype)))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    dt = resolve_dtype(dtype)
    csc = matrix.T_csr()  # rows of A^T = in-edges of A's graph
    n = csc.shape[0]
    op = matrix.op(dtype)
    n_pad = op.n_pad

    rows = csc.row_of_entry()  # target node j
    off = csc.indices != rows
    t_rows, t_srcs, t_vals = rows[off], csc.indices[off], csc.data[off]

    cnt = np.zeros(n, dtype=np.int64)
    np.add.at(cnt, t_rows, 1)
    K = max(int(cnt.max()) if cnt.size else 1, 1)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=starts[1:])
    pos = np.arange(t_rows.size) - starts[t_rows]

    srcs = np.zeros((n_pad, K), dtype=np.int32)
    costs = np.full((n_pad, K), INF)
    srcs[t_rows, pos] = t_srcs
    with np.errstate(divide="ignore"):
        costs[t_rows, pos] = 1.0 / np.maximum(np.abs(t_vals), 1e-30)

    tables = InEdgeTables(jnp.asarray(srcs), jnp.asarray(costs, dt), n_pad)
    _TABLE_CACHE.put(key, tables)
    return tables


@jax.jit
def _bmssp_run(srcs, costs, dist0, srcval0, bound):
    def cond(carry):
        dist, srcval, changed, sweeps = carry
        return changed & (sweeps < MAX_SWEEPS)

    def body(carry):
        dist, srcval, _, sweeps = carry
        cand = jnp.take(dist, srcs, axis=0) + costs          # (n_pad, K)
        k_best = jnp.argmin(cand, axis=1)
        best = jnp.take_along_axis(cand, k_best[:, None], axis=1)[:, 0]
        improved = (best < dist) & (best <= bound)
        sv_cand = jnp.take(srcval, srcs, axis=0)
        sv_best = jnp.take_along_axis(sv_cand, k_best[:, None], axis=1)[:, 0]
        dist = jnp.where(improved, best, dist)
        srcval = jnp.where(improved, sv_best, srcval)
        return dist, srcval, jnp.any(improved), sweeps + 1

    dist, srcval, _, sweeps = jax.lax.while_loop(
        cond, body, (dist0, srcval0, jnp.bool_(True), jnp.int32(0))
    )
    visited = jnp.sum(dist < INF * 0.5)
    x = jnp.where(dist < INF * 0.5, srcval / (1.0 + dist), 0.0)
    return x, dist, visited, sweeps


def shortest_paths(matrix: Matrix, sources, source_values=None, bound: float = INF, dtype=None):
    """Bounded multi-source shortest paths over the matrix graph (edge cost
    1/|a_ij|).  Returns (dist, carried_source_value, sweeps)."""
    tables = in_edge_tables(matrix, dtype)
    dt = resolve_dtype(dtype)
    n_pad = tables.n_pad
    dist0 = np.full(n_pad, INF)
    srcval0 = np.zeros(n_pad)
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    vals = (
        np.asarray(source_values, dtype=np.float64).reshape(-1)
        if source_values is not None
        else np.ones(sources.size)
    )
    dist0[sources] = 0.0
    srcval0[sources] = vals
    x, dist, visited, sweeps = _bmssp_run(
        tables.srcs, tables.costs, jnp.asarray(dist0, dt), jnp.asarray(srcval0, dt),
        jnp.asarray(bound, dt),
    )
    return (
        np.asarray(jax.device_get(dist), dtype=np.float64),
        np.asarray(jax.device_get(x), dtype=np.float64),
        int(jax.device_get(sweeps)),
    )




# ---------------------------------------------------------------- batched

@jax.jit
def _dist_batch_run(srcs, costs, dist0):
    """Batched multi-source Bellman-Ford: dist0 (n_pad, S) -> relaxed
    distances, all sources advanced in ONE device program (round-1 weak
    spot: closeness dispatched one shortest_paths per node).

    Layout note: the batch axis is MINOR so each gather pulls a contiguous
    S-float row; a batch-major layout would make every gather a strided
    column slice."""

    def cond(carry):
        dist, changed, sweeps = carry
        return changed & (sweeps < MAX_SWEEPS)

    def body(carry):
        dist, _, sweeps = carry
        # cand[w, s] = min_k dist[srcs[w, k], s] + costs[w, k]
        gathered = jnp.take(dist, srcs, axis=0)              # (n_pad, K, S)
        cand = jnp.min(gathered + costs[:, :, None], axis=1)
        improved = cand < dist
        dist = jnp.where(improved, cand, dist)
        return dist, jnp.any(improved), sweeps + 1

    dist, _, sweeps = jax.lax.while_loop(
        cond, body, (dist0, jnp.bool_(True), jnp.int32(0))
    )
    return dist, sweeps


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _dist_from_sources(srcs, costs, cs, n_pad):
    """Device-built dist0 (no host upload of the (n_pad, S) grid) + sweeps."""
    S = cs.shape[0]
    dist0 = jnp.full((n_pad, S), INF, costs.dtype)
    dist0 = dist0.at[cs, jnp.arange(S)].set(0.0)
    return _dist_batch_run(srcs, costs, dist0)


def _unit_costs(tables, unit_weights: bool):
    costs = tables.costs
    if unit_weights:
        costs = jnp.where(costs < INF * 0.5, jnp.asarray(1.0, costs.dtype), costs)
    return costs


def batched_distances_device(matrix: Matrix, sources_chunk, unit_weights: bool = False, dtype=None):
    """Single-chunk distances kept ON DEVICE: (n_pad, S) — a building block
    with no host round trip (uploads S ints, downloads nothing)."""
    tables = in_edge_tables(matrix, dtype)
    costs = _unit_costs(tables, unit_weights)
    cs = jnp.asarray(np.asarray(sources_chunk, dtype=np.int32))
    dist, _ = _dist_from_sources(tables.srcs, costs, cs, tables.n_pad)
    return dist


def batched_distances(matrix: Matrix, sources, unit_weights: bool = False,
                      dtype=None, chunk: int = 64):
    """Distances from many sources in chunked single-dispatch sweeps.
    Returns (S, n) float64.  unit_weights=True treats every edge as cost 1
    (BFS levels) regardless of values."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    n = matrix.shape[0]
    out = np.empty((sources.size, n), dtype=np.float64)
    for c0 in range(0, sources.size, chunk):
        cs = sources[c0 : c0 + chunk]
        dist = batched_distances_device(matrix, cs, unit_weights, dtype)
        out[c0 : c0 + len(cs)] = np.asarray(jax.device_get(dist), dtype=np.float64)[:n].T
    return out


def solve_bmssp(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    n = matrix.shape[0]
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    threshold = base.threshold_for(b, options)

    # auto-select CG for small or dense systems (bmssp.rs:79-90)
    if n < 100 or matrix.density > 0.1:
        r = _cg.solve_cg(matrix, b, options, raise_on_fail=False)
        if not r.converged:
            r = _cg.solve_bicgstab(matrix, b, options, raise_on_fail=raise_on_fail)
        r.method = "bmssp(cg)"
        return r

    sources = np.nonzero(np.abs(b) > 1e-12)[0]
    if sources.size == 0:
        return SolverResult(np.zeros(n), 0, 0.0, True, "bmssp")

    with base.SolveTimer() as t:
        dist, x, sweeps = shortest_paths(matrix, sources, b[sources], dtype=options.dtype)
    visited = int(np.sum(dist[:n] < INF * 0.5))
    if visited > n // 2 and sources.size > n // 100:
        # dense reach -> the graph heuristic explores everything; CG is better
        # (bmssp.rs:133-138)
        r = _cg.solve_bicgstab(matrix, b, options, raise_on_fail=raise_on_fail)
        r.method = "bmssp(cg-fallback)"
        return r

    x = x[:n]
    res = float(np.linalg.norm(matrix.csr.matvec(x) - b))
    return SolverResult(
        solution=x,
        iterations=sweeps,
        residual=res,
        converged=res <= threshold,
        method="bmssp",
        compute_time_ms=t.ms,
    )
