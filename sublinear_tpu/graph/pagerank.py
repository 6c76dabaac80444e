"""PageRank / personalized PageRank on the device.

Reference semantics: ``SublinearSolver.computePageRank``
(/root/reference/src/core/solver.ts:664-722) builds the system
(I - alpha P^T) x = (1-alpha) v and solves it with the configured method;
``GraphTools.pageRank`` (/root/reference/src/mcp/tools/graph.ts:22-92) wraps
it with ranking statistics.  Defaults: damping 0.85, epsilon 1e-6,
max_iterations 1000.

Device re-design: the linear system is solved by an on-device power/Richardson
iteration x <- (1-a) v + a (P^T x + dangling_mass * v), which is exactly the
Neumann series of the PageRank system and runs entirely in one
``lax.while_loop`` (no per-iteration host syncs).  The column-stochastic
operator P^T is materialized host-side once (out-degree normalization).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import InvalidParametersError
from ..matrix import Matrix
from ..solvers import base


@dataclasses.dataclass
class PageRankResult:
    scores: np.ndarray
    iterations: int
    residual: float
    converged: bool
    damping: float
    personalized: bool = False

    def to_dict(self) -> dict:
        return {
            "pageRankVector": self.scores.tolist(),
            "iterations": self.iterations,
            "residual": self.residual,
            "converged": self.converged,
            "damping": self.damping,
            "personalized": self.personalized,
        }


def _transition_matrix(adjacency: Matrix) -> Matrix:
    """Column-stochastic P^T as a Matrix (host-side, one O(nnz) pass)."""
    csr = adjacency.csr
    out_deg = np.zeros(csr.shape[0])
    rows = csr.row_of_entry()
    np.add.at(out_deg, rows, csr.data)
    safe = np.where(out_deg > 0, out_deg, 1.0)
    # P[i, j] = a_ij / outdeg_i ; we store P^T so matvec(P^T, x) is row-form
    r, c, v = csr.to_coo()
    return Matrix.from_coo(c, r, v / safe[r], (csr.shape[1], csr.shape[0]))


@functools.partial(jax.jit, static_argnames=("check_every",))
def _pagerank_run(opT, v, dangling_mask, alpha, threshold, max_iters, check_every):
    def step(x):
        dangling = jnp.sum(jnp.where(dangling_mask, x, 0.0))
        return (1.0 - alpha) * v + alpha * (opT.matvec(x) + dangling * v)

    def residual_of(x):
        return jnp.linalg.norm(step(x) - x)

    x0 = v
    x, k, res, _ = base.while_iterate(
        base.repeat_steps(step, check_every), residual_of, x0, threshold, max_iters, check_every
    )
    x = x / jnp.maximum(jnp.sum(x), 1e-30)
    return x, k, res


def pagerank(
    adjacency: Matrix,
    damping: float = 0.85,
    personalized: Optional[np.ndarray] = None,
    epsilon: float = 1e-6,
    max_iterations: int = 1000,
    dtype=None,
) -> PageRankResult:
    if not adjacency.is_square():
        raise InvalidParametersError("Adjacency matrix must be square")
    if not (0.0 < damping < 1.0):
        raise InvalidParametersError(f"damping must be in (0,1), got {damping}")
    n = adjacency.shape[0]

    PT = _transition_matrix(adjacency)
    opT = PT.op(dtype)

    if personalized is not None:
        v = np.asarray(personalized, dtype=np.float64).reshape(-1)
        if v.size != n:
            raise InvalidParametersError("personalization vector length mismatch")
        s = v.sum()
        v = v / s if s > 0 else np.full(n, 1.0 / n)
    else:
        v = np.full(n, 1.0 / n)

    out_deg = np.zeros(n)
    rows = adjacency.csr.row_of_entry()
    np.add.at(out_deg, rows, adjacency.csr.data)
    dangling = np.zeros(opT.n_pad, dtype=bool)
    dangling[:n] = out_deg == 0

    from ..formats.ell import pad_vector

    v_pad = pad_vector(v, opT.n_pad, opT.dtype)
    with base.SolveTimer() as t:
        x, k, res = _pagerank_run(
            opT, v_pad, jnp.asarray(dangling), jnp.asarray(damping, opT.dtype),
            float(epsilon), jnp.int32(max_iterations), 5,
        )
        jax.block_until_ready(x)
    scores = np.asarray(jax.device_get(x), dtype=np.float64)[:n]
    res_f = float(jax.device_get(res))
    return PageRankResult(
        scores=scores,
        iterations=int(jax.device_get(k)),
        residual=res_f,
        converged=bool(res_f <= epsilon * 1.0000001),
        damping=damping,
        personalized=personalized is not None,
    )


def personalized_pagerank(
    adjacency: Matrix, personalize_nodes, **kwargs
) -> PageRankResult:
    """Reference: GraphTools.personalizedPageRank (graph.ts:93-123)."""
    n = adjacency.shape[0]
    nodes = np.asarray(personalize_nodes, dtype=np.int64).reshape(-1)
    if nodes.size == 0 or nodes.min() < 0 or nodes.max() >= n:
        raise InvalidParametersError("personalization nodes out of bounds")
    v = np.zeros(n)
    v[nodes] = 1.0 / nodes.size
    result = pagerank(adjacency, personalized=v, **kwargs)
    return result


def pagerank_statistics(result: PageRankResult, top_k: int = 10) -> dict:
    """Ranking/statistics block mirroring graph.ts:45-88."""
    scores = result.scores
    order = np.argsort(-scores)
    total = float(scores.sum())
    mean = total / max(scores.size, 1)
    var = float(np.mean((scores - mean) ** 2))
    pos = scores[scores > 0]
    entropy = float(-(pos * np.log(pos)).sum()) if pos.size else 0.0
    qs = {f"q{int(q * 100)}": float(np.quantile(scores, q)) for q in (0.1, 0.25, 0.5, 0.75, 0.9)}
    k10 = max(1, int(np.ceil(scores.size * 0.1)))
    return {
        "topNodes": [{"node": int(i), "score": float(scores[i])} for i in order[:top_k]],
        "bottomNodes": [{"node": int(i), "score": float(scores[i])} for i in order[-top_k:][::-1]],
        "statistics": {
            "totalScore": total,
            "maxScore": float(scores.max()) if scores.size else 0.0,
            "minScore": float(scores.min()) if scores.size else 0.0,
            "mean": mean,
            "standardDeviation": float(np.sqrt(var)),
            "entropy": entropy,
            "convergenceInfo": {"damping": result.damping, "personalized": result.personalized},
        },
        "distribution": {
            "quantiles": qs,
            "concentrationRatio": float(scores[order[:k10]].sum() / total) if total > 0 else 0.0,
        },
    }
