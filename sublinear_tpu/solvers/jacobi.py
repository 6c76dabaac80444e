"""Jacobi, Gauss-Seidel and SOR solvers.

Parity target: the JS ``JSSolver`` family (Jacobi/Gauss-Seidel/CG/adaptive,
/root/reference/src/solver.js:164-652) and the WASM JacobiSolver
(/root/reference/src/solver_core.rs:39-247).

Device re-design of Gauss-Seidel/SOR: the textbook sweep is sequential per row
(useless on a vector machine), so we re-express it as *multicolor* GS — a
greedy graph coloring of the sparsity pattern is computed host-side once, and
one sweep updates each color class in parallel on the VPU.  Same fixed point,
hardware-friendly schedule.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base


@functools.partial(jax.jit, static_argnames=("check_every", "norm_mode", "mode"))
def _jacobi_run(op, b, x0, threshold, max_iters, check_every, norm_mode="l2", mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def step(x):
        return inv_d * (b - op.offdiag_matvec(x))

    def residual_of(x):
        return base.device_norm(op.matvec(x) - b, norm_mode)

    state, k, res, change = base.while_iterate(
        base.repeat_steps(step, check_every), residual_of, x0, threshold,
        max_iters, check_every, x_of=lambda x: x, mode=mode, change_tol=change_tol
    )
    return state, k, res, change


def greedy_coloring(matrix: Matrix) -> np.ndarray:
    """Greedy graph coloring of the symmetrized sparsity pattern (host-side,
    O(nnz)).  Rows of the same color have no mutual coupling, so a GS update
    of one color class is exact and parallel."""
    csr = matrix.csr
    n = csr.shape[0]
    # symmetrize pattern
    t = matrix.T_csr()
    if n > 2000:
        try:
            from .. import native

            if native.available():
                return native.greedy_coloring(csr.indptr, csr.indices, t.indptr, t.indices, n)
        except Exception:
            pass
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        banned = set()
        for idx in range(csr.indptr[i], csr.indptr[i + 1]):
            j = csr.indices[idx]
            if j != i and colors[j] >= 0:
                banned.add(int(colors[j]))
        for idx in range(t.indptr[i], t.indptr[i + 1]):
            j = t.indices[idx]
            if j != i and colors[j] >= 0:
                banned.add(int(colors[j]))
        c = 0
        while c in banned:
            c += 1
        colors[i] = c
    return colors


@functools.partial(jax.jit, static_argnames=("check_every", "num_colors", "mode"))
def _sor_run(op, b, x0, color_masks, omega, threshold, max_iters, check_every, num_colors, mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def sweep(x):
        for c in range(num_colors):  # static unroll over color classes
            gs = inv_d * (b - op.offdiag_matvec(x))
            x = jnp.where(color_masks[c], (1.0 - omega) * x + omega * gs, x)
        return x

    def residual_of(x):
        return jnp.linalg.norm(op.matvec(x) - b)

    state, k, res, change = base.while_iterate(
        base.repeat_steps(sweep, check_every), residual_of, x0, threshold,
        max_iters, check_every, x_of=lambda x: x, mode=mode, change_tol=change_tol
    )
    return state, k, res, change


def _prepare(matrix: Matrix, b, options: SolverOptions):
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    x0 = (
        matrix.pad_vector(options.x0, options.dtype)
        if options.x0 is not None
        else jnp.zeros_like(b_pad)
    )
    return op, b_pad, x0, base.threshold_for(b, options)


def solve_jacobi(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    op, b_pad, x0, threshold = _prepare(matrix, b, options)
    with base.SolveTimer() as t:
        x, k, res, change = _jacobi_run(op, b_pad, x0, threshold, jnp.int32(options.max_iterations), options.check_every, base.norm_mode_of(options), base.driver_mode_of(options), options.epsilon)
        jax.block_until_ready(x)
    result = base.finalize(matrix, x, k, res, "jacobi", options, t.ms, matvec_count=int(jax.device_get(k)))
    return base.check_outcome(result, threshold, options, raise_on_fail, change=float(jax.device_get(change)))


def solve_sor(
    matrix: Matrix, b, options: SolverOptions, omega: float = 1.0, raise_on_fail: bool = True,
    method_name: str = "sor",
) -> SolverResult:
    op, b_pad, x0, threshold = _prepare(matrix, b, options)
    colors = greedy_coloring(matrix)
    num_colors = int(colors.max()) + 1 if colors.size else 1
    n_pad = op.n_pad
    masks = np.zeros((num_colors, n_pad), dtype=bool)
    for c in range(num_colors):
        masks[c, : colors.size] = colors == c
    masks_dev = jnp.asarray(masks)
    with base.SolveTimer() as t:
        x, k, res, change = _sor_run(
            op, b_pad, x0, masks_dev, jnp.asarray(omega, op.dtype), threshold,
            jnp.int32(options.max_iterations), options.check_every, num_colors,
            base.driver_mode_of(options), options.epsilon,
        )
        jax.block_until_ready(x)
    result = base.finalize(
        matrix, x, k, res, method_name, options, t.ms,
        matvec_count=int(jax.device_get(k)) * num_colors,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail, change=float(jax.device_get(change)))


def solve_gauss_seidel(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    return solve_sor(matrix, b, options, omega=1.0, raise_on_fail=raise_on_fail, method_name="gauss-seidel")
