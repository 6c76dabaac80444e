"""Solver gate: certificate verification of predictions.

Reference: /root/reference/neural-network-implementation/src/solvers/solver_gate.rs:24-444
— a prediction passes the gate when a cheap solver certificate (residual of a
local DD system around the predicted state) is within tolerance and the work
budget is respected; the gate tracks pass-rate / certificate error / work.

Device re-design: the certificate solve is a fixed-iteration batched Jacobi/CG
program (static shapes, vmapped over a batch of predictions) so gating an
entire batch is ONE device dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class GateConfig:
    """Mirrors solver_gate.rs config: tolerance + work budget."""

    tolerance: float = 1e-3
    max_iterations: int = 8  # work budget per certificate (gate <= 0.20ms target)
    min_pass_rate: float = 0.8


@dataclasses.dataclass
class GateStats:
    total: int = 0
    passed: int = 0
    cert_error_sum: float = 0.0
    work_sum: int = 0

    @property
    def pass_rate(self) -> float:
        return self.passed / self.total if self.total else 1.0

    @property
    def avg_cert_error(self) -> float:
        return self.cert_error_sum / self.total if self.total else 0.0


class SolverGate:
    """Gate predictions through a certificate solve on a fixed DD system.

    The certificate system ties consecutive state coordinates (tridiagonal DD
    operator A); a prediction x_hat is certified by checking how well the
    budgeted solve of A y = A x_hat reproduces x_hat — an O(d * iters)
    self-consistency certificate, exactly the reference's verification role.
    """

    def __init__(self, dim: int, config: Optional[GateConfig] = None):
        self.config = config or GateConfig()
        self.dim = dim
        # tridiagonal DD certificate operator (diag 4, off -1)
        diag = 4.0 * jnp.ones(dim)
        off = -1.0 * jnp.ones(dim - 1)
        self.A = jnp.diag(diag) + jnp.diag(off, 1) + jnp.diag(off, -1)
        self.inv_diag = 1.0 / diag
        self.stats = GateStats()
        self._verify = jax.jit(self._verify_batch)

    def _verify_batch(self, X_hat):
        """X_hat: (B, d) -> (cert_err: (B,), passed: (B,))."""
        B_rhs = X_hat @ self.A.T  # b = A x_hat (batched)

        def jacobi(b):
            def body(_, y):
                return self.inv_diag * (b - (self.A @ y - 4.0 * y))

            y = jax.lax.fori_loop(0, self.config.max_iterations, body, jnp.zeros_like(b))
            return y

        Y = jax.vmap(jacobi)(B_rhs)
        err = jnp.linalg.norm(Y - X_hat, axis=1) / jnp.maximum(
            jnp.linalg.norm(X_hat, axis=1), 1e-12
        )
        return err, err <= self.config.tolerance

    def verify(self, x_hat) -> tuple[np.ndarray, np.ndarray]:
        X = jnp.atleast_2d(jnp.asarray(x_hat))
        err, passed = self._verify(X)
        err = np.asarray(err)
        passed = np.asarray(passed)
        self.stats.total += err.size
        self.stats.passed += int(passed.sum())
        self.stats.cert_error_sum += float(err.sum())
        self.stats.work_sum += err.size * self.config.max_iterations
        return err, passed

    def gate(self, x_hat, fallback) -> np.ndarray:
        """Return x_hat where certified, fallback prediction otherwise
        (System B behavior: gate failures fall back to the Kalman prior)."""
        X = np.atleast_2d(np.asarray(x_hat))
        F = np.atleast_2d(np.asarray(fallback))
        _, passed = self.verify(X)
        out = np.where(passed[:, None], X, F)
        return out if np.asarray(x_hat).ndim > 1 else out[0]

    def healthy(self) -> bool:
        return self.stats.pass_rate >= self.config.min_pass_rate
