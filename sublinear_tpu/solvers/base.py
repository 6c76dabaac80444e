"""Shared solver driver machinery.

The reference drives every algorithm with a host-side loop
(``SolverAlgorithm::solve`` /root/reference/src/solver/mod.rs:223-333, the TS
loops in /root/reference/src/core/solver.ts).  Device-first re-design: the whole
iteration runs on-device inside one ``lax.while_loop`` — residuals are
measured every ``check_every`` iterations (reference's every-5 pattern,
src/core/solver.ts:166) without any host round-trips, and the host gets back
(x, iterations, residual) in a single transfer.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

from ..errors import ConvergenceError, NumericalInstabilityError
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult, SolverStats

HUGE_RES = 1e30


def norm_mode_of(options: SolverOptions) -> str:
    """Map ConvergenceMode (reference: src/types.rs:10-34) to a norm tag."""
    from ..types import ConvergenceMode

    mode = options.convergence_mode
    if mode in (ConvergenceMode.L1_RESIDUAL,):
        return "l1"
    if mode in (ConvergenceMode.MAX_RESIDUAL,):
        return "max"
    return "l2"  # RELATIVE_CHANGE/COMBINED report the l2 residual; their
    # convergence tests run on iterate change inside while_iterate


def device_norm(v, mode: str):
    import jax.numpy as jnp

    if mode == "l1":
        return jnp.sum(jnp.abs(v))
    if mode == "max":
        return jnp.max(jnp.abs(v))
    return jnp.linalg.norm(v)


def host_norm(v, mode: str) -> float:
    v = np.asarray(v, dtype=np.float64)
    if mode == "l1":
        return float(np.abs(v).sum())
    if mode == "max":
        return float(np.abs(v).max()) if v.size else 0.0
    return float(np.linalg.norm(v))


def threshold_for(b: np.ndarray, options: SolverOptions) -> float:
    """Absolute threshold (in the configured norm) implementing
    relative/absolute convergence."""
    if options.convergence == "absolute":
        return float(options.epsilon)
    nb = host_norm(b, norm_mode_of(options))
    return float(options.epsilon) * max(nb, 1e-30)


def while_iterate(step_block: Callable, residual_of: Callable, state0, threshold, max_iters: int, check_every: int, x_of: Callable | None = None, mode: str = "residual", change_tol: float = 0.0):
    """Generic on-device driver.

    ``step_block(state)``   advances the iterate by ``check_every`` steps
    ``residual_of(state)``  returns the residual norm of the current iterate
    ``x_of(state)``         extracts the iterate (required for the
                            RELATIVE_CHANGE / COMBINED convergence modes,
                            reference src/types.rs:10-34)

    Carry is (state, k, res, change).  ``mode``:
      'residual'        stop on res <= threshold (L1/L2/MAX pick the norm
                        via ``residual_of``)
      'relative_change' stop on ||x_new - x_old|| / ||x_old|| <= change_tol
      'combined'        require BOTH conditions
    Stops on convergence, divergence (non-finite or exploding residual — the
    reference's NumericalInstability check, src/solver/mod.rs:272-279), or
    iteration budget.  Returns (state, k, res, change).
    """
    res0 = residual_of(state0)
    big = jnp.asarray(jnp.inf, res0.dtype)

    def not_done(res, change):
        if mode == "relative_change":
            return change > change_tol
        if mode == "combined":
            return (res > threshold) | (change > change_tol)
        return res > threshold

    def cond(carry):
        _, k, res, change = carry
        ok = not_done(res, change) & (k < max_iters)
        finite = jnp.isfinite(res) & (res < HUGE_RES)
        return ok & finite

    def body(carry):
        state, k, _, _ = carry
        new_state = step_block(state)
        if x_of is not None and mode in ("relative_change", "combined"):
            x_old, x_new = x_of(state), x_of(new_state)
            change = jnp.linalg.norm(x_new - x_old) / jnp.maximum(
                jnp.linalg.norm(x_old), 1e-30
            )
        else:
            change = big
        return new_state, k + check_every, residual_of(new_state), change

    return jax.lax.while_loop(cond, body, (state0, jnp.int32(0), res0, big))


def driver_mode_of(options: SolverOptions) -> str:
    from ..types import ConvergenceMode

    mode = options.convergence_mode
    if mode is ConvergenceMode.RELATIVE_CHANGE:
        return "relative_change"
    if mode is ConvergenceMode.COMBINED:
        return "combined"
    return "residual"


def repeat_steps(step: Callable, n: int) -> Callable:
    """Compose ``n`` single steps into one block (n is static)."""

    def block(state):
        return jax.lax.fori_loop(0, n, lambda _, s: step(s), state)

    return block


def dd_error_bounds(matrix: Matrix, residual_norm: float):
    """Deterministic solution-error bound for strictly DD matrices via the
    Varah bound ||A^-1||_inf <= 1/alpha, alpha = min_i(|a_ii| - sum|a_ij|):
    ||x - x*||_inf <= ||r|| / alpha  (||r||_inf <= any reported norm here).
    Reference computes a bound on every solve (src/solver/neumann.rs:321-347,
    src/types.rs:60); None when A is not strictly DD or the residual is
    non-finite."""
    from ..types import ErrorBounds

    alpha = matrix.dominance_gap()
    if alpha <= 0.0 or not np.isfinite(residual_norm):
        return None
    return ErrorBounds(
        lower_bound=0.0,
        upper_bound=float(residual_norm) / alpha,
        method="deterministic",
    )


def neumann_truncation_bounds(matrix: Matrix, terms: int, term_norm: float, rhs_norm: float, residual: float):
    """Geometric-series truncation bound, mirroring
    /root/reference/src/solver/neumann.rs:321-347: estimate q = ||M|| from the
    last term's decay, bound the tail q^k/(1-q) * ||D^-1 b||.  Falls back to
    the deterministic Varah bound when q >= 1 or too few terms."""
    from ..types import ErrorBounds

    if terms > 1 and rhs_norm > 0 and term_norm > 0 and np.isfinite(term_norm):
        q = (term_norm / rhs_norm) ** (1.0 / (terms - 1))
        if 0.0 < q < 1.0:
            tail = (q ** terms) / (1.0 - q) * rhs_norm
            det = dd_error_bounds(matrix, residual)
            if det is not None and det.upper_bound < tail:
                return det
            return ErrorBounds(lower_bound=0.0, upper_bound=float(tail),
                               method="neumann_truncation")
    return dd_error_bounds(matrix, residual)


class SolveTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def finalize(
    matrix: Matrix,
    x_pad: jax.Array,
    iterations,
    residual,
    method: str,
    options: SolverOptions,
    elapsed_ms: float,
    matvec_count: int = 0,
    error_bounds=None,
) -> SolverResult:
    n = matrix.shape[0]
    x = np.asarray(jax.device_get(x_pad), dtype=np.float64)[:n]
    res = float(jax.device_get(residual))
    thr = 0.0  # converged flag is decided by the caller via residual
    result = SolverResult(
        solution=x,
        iterations=int(jax.device_get(iterations)),
        residual=res,
        converged=bool(np.isfinite(res)),
        method=method,
        compute_time_ms=elapsed_ms,
        error_bounds=error_bounds if error_bounds is not None else dd_error_bounds(matrix, res),
    )
    if options.collect_stats:
        nnz = matrix.nnz
        secs = max(elapsed_ms / 1e3, 1e-12)
        result.stats = SolverStats(
            total_time_ms=elapsed_ms,
            matvec_count=matvec_count,
            flops=2 * nnz * matvec_count,
            nnz_per_second=nnz * matvec_count / secs,
            backend=jax.default_backend(),
            device_count=jax.device_count(),
        )
    return result


def check_outcome(result: SolverResult, threshold: float, options: SolverOptions, raise_on_fail: bool, change: float | None = None):
    from ..types import ConvergenceMode

    mode = options.convergence_mode
    res_ok = bool(np.isfinite(result.residual) and result.residual <= threshold * 1.0000001)
    if change is not None and mode in (ConvergenceMode.RELATIVE_CHANGE, ConvergenceMode.COMBINED):
        chg_ok = bool(np.isfinite(change) and change <= options.epsilon * 1.0000001)
        result.converged = (
            chg_ok if mode is ConvergenceMode.RELATIVE_CHANGE else (chg_ok and res_ok)
        )
    else:
        result.converged = res_ok
    if not result.converged and raise_on_fail:
        if not np.isfinite(result.residual) or result.residual >= HUGE_RES:
            raise NumericalInstabilityError(
                f"{result.method} diverged (residual={result.residual})",
                {"iterations": result.iterations},
            )
        raise ConvergenceError(
            f"{result.method} failed to converge after {result.iterations} iterations; "
            f"residual {result.residual:.3e} > threshold {threshold:.3e}",
            {"residual": result.residual, "iterations": result.iterations, "threshold": threshold},
        )
    return result
