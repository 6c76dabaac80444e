"""Mixed-precision iterative refinement.

SURVEY.md §7 flags f32 device arithmetic vs the f64 reference as "the
single biggest precision risk": plain f32 solves floor at ~2e-7 relative
residual.  This module implements classic iterative refinement:

    repeat:  r = b - A x      (compensated double-float, ON DEVICE)
             solve A d = r    (fast, f32 on device, warm compiled program)
             x = x + d        (double-float accumulation on device)

The exact residual runs on the device: the matrix rides as an exact
(hi, lo) f32 pair in slot-major ELL and the residual is evaluated with
Dekker products + TwoSum accumulation (utils/doublefloat.py) — no host
O(nnz) work, so refinement scales to operators that exceed host memory
(BASELINE config #5).  ``residual="host"`` keeps the host f64 path as a
cross-check.  Achievable relative residual ~1e-12, matching the
reference's f64 tolerances (/root/reference/src/optimized_solver.rs).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from .dispatch import solve


def _device_residual_state(matrix: Matrix, b64: np.ndarray):
    """Build the double-float ELL residual evaluator state (device)."""
    import jax.numpy as jnp

    from ..formats.ell import choose_slot_cap
    from ..utils import doublefloat as df

    csr = matrix.csr
    n = csr.shape[0]
    # full-coverage ELL (slot cap = max degree): the residual must include
    # EVERY entry; memory is (hi+lo+col) * K_max * n
    row_nnz = csr.row_nnz()
    K = max(int(row_nnz.max()), 1)
    rows = csr.row_of_entry()
    pos = np.arange(csr.nnz, dtype=np.int64) - csr.indptr[rows]
    vals64 = np.zeros((K, n), dtype=np.float64)
    cols = np.zeros((K, n), dtype=np.int32)
    vals64[pos, rows] = csr.data
    cols[pos, rows] = csr.indices
    vh, vl = df.split_f64(vals64)
    bh, bl = df.split_f64(b64)
    return (jnp.asarray(vh), jnp.asarray(vl), jnp.asarray(cols),
            jnp.asarray(bh), jnp.asarray(bl))


def solve_refined(
    matrix: Matrix,
    b,
    options: Optional[SolverOptions] = None,
    method: Optional[str] = None,
    max_refinements: int = 4,
    raise_on_fail: bool = True,
    residual: str = "device",
) -> SolverResult:
    """Solve to ``options.epsilon`` in f64-exact residual terms.

    ``residual="device"`` evaluates the exact residual on the accelerator in
    compensated double-float (no host O(nnz) work); ``"host"`` keeps the
    classic host f64 CSR matvec.  The CPU backend always takes the host
    path: XLA:CPU's simplifier cancels the TwoSum compensation (~1e-7
    error), and there the host f64 matvec is the native exact evaluator."""
    import jax
    import jax.numpy as jnp

    from ..utils import doublefloat as df

    options = options or SolverOptions()
    b64 = np.asarray(b, dtype=np.float64).reshape(-1)
    nb = max(float(np.linalg.norm(b64)), 1e-300)
    target_abs = (
        float(options.epsilon) * nb if options.convergence == "relative" else float(options.epsilon)
    )

    # inner f32 solves run to their own floor (slightly looser inner epsilon)
    inner = dataclasses.replace(options, convergence="relative", epsilon=max(options.epsilon, 1e-6))

    from ..config import backend

    if residual not in ("device", "host"):
        from ..errors import InvalidParametersError

        raise InvalidParametersError(
            f"residual must be 'device' or 'host', got {residual!r}")
    use_device = residual == "device" and backend() != "cpu"
    if use_device:
        vh, vl, cols_d, bh, bl = _device_residual_state(matrix, b64)

    t0 = time.perf_counter()
    total_iters = 0
    inner_method = method
    res_norm = float("inf")
    if use_device:
        n = matrix.shape[0]
        xh = jnp.zeros(n, jnp.float32)
        xl = jnp.zeros(n, jnp.float32)
        for step in range(max_refinements + 1):
            rh, rl = df.ell_residual_df(vh, vl, cols_d, bh, bl, xh, xl)
            res_norm = float(jax.device_get(df.df_norm(rh, rl)))
            if res_norm <= target_abs:
                break
            r_host = np.asarray(jax.device_get(rh), np.float64) \
                + np.asarray(jax.device_get(rl), np.float64)
            step_opts = dataclasses.replace(inner, x0=None)
            result = solve(matrix, r_host, step_opts, method=inner_method,
                           raise_on_fail=False)
            inner_method = result.method if inner_method is None else inner_method
            total_iters += result.iterations
            d32 = np.asarray(result.solution, np.float32)[:n]
            if not np.all(np.isfinite(d32)):
                break
            xh, xl = df.df_add(xh, xl, jnp.asarray(d32), jnp.zeros_like(xl))
        x = np.asarray(jax.device_get(xh), np.float64) \
            + np.asarray(jax.device_get(xl), np.float64)
        residual_val = res_norm
    else:
        x = np.zeros_like(b64)
        residual_val = float("inf")
        for step in range(max_refinements + 1):
            r = b64 - matrix.csr.matvec(x)  # exact f64 residual
            residual_val = float(np.linalg.norm(r))
            if residual_val <= target_abs:
                break
            step_opts = dataclasses.replace(inner, x0=None)
            result = solve(matrix, r, step_opts, method=inner_method, raise_on_fail=False)
            inner_method = result.method if inner_method is None else inner_method
            total_iters += result.iterations
            if not np.all(np.isfinite(result.solution)):
                break
            x = x + result.solution
    residual_norm = residual_val

    wall = (time.perf_counter() - t0) * 1e3
    out = SolverResult(
        solution=x,
        iterations=total_iters,
        residual=residual_norm,
        converged=residual_norm <= target_abs * 1.0000001,
        method=f"refined({inner_method})",
        compute_time_ms=wall,
    )
    if not out.converged and raise_on_fail:
        from ..errors import ConvergenceError

        raise ConvergenceError(
            f"iterative refinement stalled at residual {residual_norm:.3e} (target {target_abs:.3e})",
            {"residual": residual_norm, "target": target_abs, "iterations": total_iters},
        )
    return out
