"""PageRank-based active sample selection.

Reference: /root/reference/neural-network-implementation/src/solvers/pagerank_selector.rs:21-453
— build a similarity graph over training samples, run PageRank, select the
top-scoring samples for training.

Device re-design: the kNN similarity graph is built with one batched distance
matmul; PageRank runs through the library's on-device power
iteration (graph/pagerank.py).
"""
from __future__ import annotations

import numpy as np

from ..graph.pagerank import pagerank
from ..matrix import Matrix


def similarity_graph(features: np.ndarray, k: int = 8, sigma: float | None = None) -> Matrix:
    """kNN graph with Gaussian edge weights over sample feature vectors."""
    import jax.numpy as jnp

    X = jnp.asarray(np.asarray(features, dtype=np.float32))
    n = X.shape[0]
    sq = jnp.sum(X * X, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (X @ X.T)  # distance matrix in one matmul
    d2 = jnp.maximum(d2, 0.0)
    d2_np = np.asarray(d2, dtype=np.float64)
    np.fill_diagonal(d2_np, np.inf)
    k = min(k, n - 1)
    nbr = np.argpartition(d2_np, k, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    cols = nbr.reshape(-1)
    if sigma is None:
        med = np.median(d2_np[np.isfinite(d2_np)])
        sigma = np.sqrt(max(med, 1e-12))
    w = np.exp(-d2_np[rows, cols] / (2.0 * sigma**2))
    # symmetrize
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([w, w])
    return Matrix.from_coo(r, c, v, (n, n))


def select_samples(
    features: np.ndarray,
    num_select: int,
    k: int = 8,
    damping: float = 0.85,
    seed: int = 0,
) -> dict:
    """Top PageRank-scored samples (pagerank_selector.rs select API)."""
    n = len(features)
    num_select = min(num_select, n)
    g = similarity_graph(features, k=k)
    pr = pagerank(g, damping=damping, epsilon=1e-8)
    order = np.argsort(-pr.scores)
    selected = order[:num_select]
    return {
        "selected": selected.tolist(),
        "scores": pr.scores[selected].tolist(),
        "allScores": pr.scores.tolist(),
        "graphEdges": g.nnz,
        "converged": pr.converged,
    }
