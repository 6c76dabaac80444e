"""Forward/backward/bidirectional push solvers — dense masked frontier form.

Reference semantics: Gauss-Southwell coordinate push for linear systems
(/root/reference/src/core/solver.ts:437-522 — pick the max-|residual| node,
x_i += r_i/a_ii, subtract column i of A from the residual) and the
WorkQueue-ordered graph push (/root/reference/src/solver/forward_push.rs:150-216)
with threshold r_i >= eps * deg_i.

Device re-design: a sequential priority queue is useless on a vector machine, so
each sweep pushes *every* node whose residual passes the threshold at once:

    frontier  m = |r| >= max(theta_abs, eta * max|r|)
    delta     = where(m, r / diag, 0)
    x        += delta ;  r -= A @ delta

Same fixed point (it is Jacobi restricted to the frontier, convergent for
strictly DD systems); "push count" semantics become sweep counts — parity is
validated on residuals, as SURVEY.md §7 prescribes.  The threshold keeps the
touched set localized when b is sparse, matching push's O(1/eps) locality.
Backward push runs the same sweep on A^T (used for adjoint/entry queries;
for a full solve the reference's TS backward push simply delegates forward,
solver.ts:527 — we honor that for the full-RHS API).  Bidirectional improves
on the reference's alias by finishing the push phase with a Krylov polish.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base

# fraction of the max residual a node needs to enter the frontier; 0 would be
# plain Jacobi, 1 would be single-node Gauss-Southwell.
FRONTIER_ETA = 0.1


@functools.partial(jax.jit, static_argnames=("check_every", "norm_mode", "mode"))
def _push_run(op, b, x0, threshold, max_iters, check_every, norm_mode="l2", mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def sweep(state):
        x, r = state
        rmax = jnp.max(jnp.abs(r))
        theta = jnp.maximum(FRONTIER_ETA * rmax, 0.0)
        frontier = jnp.abs(r) >= theta
        delta = jnp.where(frontier, r * inv_d, 0.0)
        x = x + delta
        r = r - op.matvec(delta)
        return x, r

    def residual_of(state):
        _, r = state
        return base.device_norm(r, norm_mode)

    r0 = b - op.matvec(x0)
    state, k, res, change = base.while_iterate(
        base.repeat_steps(sweep, check_every), residual_of, (x0, r0), threshold,
        max_iters, check_every, x_of=lambda st: st[0], mode=mode, change_tol=change_tol
    )
    x, r = state
    return x, k, res, change


def solve_push(
    matrix: Matrix,
    b,
    options: SolverOptions,
    direction: str = "forward-push",
    raise_on_fail: bool = True,
) -> SolverResult:
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    x0 = (
        matrix.pad_vector(options.x0, options.dtype)
        if options.x0 is not None
        else jnp.zeros_like(b_pad)
    )
    threshold = base.threshold_for(b, options)

    if direction == "bidirectional":
        # push phase with a loose budget, then Krylov polish from the iterate
        with base.SolveTimer() as t:
            x, k, res, _ = _push_run(
                op, b_pad, x0, threshold, jnp.int32(max(options.max_iterations // 4, 8)),
                options.check_every, base.norm_mode_of(options),
            )
            jax.block_until_ready(x)
        import dataclasses

        from . import cg as _cg

        polish_opts = dataclasses.replace(
            options, x0=np.asarray(jax.device_get(x))[: matrix.shape[0]], method=options.method
        )
        polish = _cg.solve_bicgstab(matrix, b, polish_opts, raise_on_fail=raise_on_fail)
        polish.method = "bidirectional"
        polish.iterations += int(jax.device_get(k))
        polish.compute_time_ms += t.ms
        return polish

    with base.SolveTimer() as t:
        x, k, res, change = _push_run(
            op, b_pad, x0, threshold, jnp.int32(options.max_iterations), options.check_every,
            base.norm_mode_of(options), base.driver_mode_of(options), options.epsilon,
        )
        jax.block_until_ready(x)
    result = base.finalize(
        matrix, x, k, res, direction, options, t.ms, matvec_count=int(jax.device_get(k))
    )
    return base.check_outcome(result, threshold, options, raise_on_fail, change=float(jax.device_get(change)))


@functools.partial(jax.jit, static_argnames=("check_every",))
def _push_adjoint_run(opT, e, threshold, max_iters, check_every):
    """Backward push: frontier sweeps on A^T e (adjoint solve) — used by
    single-entry queries x_i = (A^-T e_i) . b (reference:
    src/solver/backward_push.rs:60-230, pushes along in-edges)."""
    x0 = jnp.zeros_like(e)
    return _push_run(opT, e, x0, threshold, max_iters, check_every)


def adjoint_solve(matrix: Matrix, e, options: SolverOptions):
    """Solve A^T y = e with backward (adjoint) push sweeps.  Returns padded y."""
    opT = matrix.op(options.dtype, transpose=True)
    e_pad = matrix.pad_vector(e, options.dtype, transpose=True)
    threshold = base.threshold_for(e, options)
    y, k, res, _ = _push_adjoint_run(
        opT, e_pad, threshold, jnp.int32(options.max_iterations), options.check_every
    )
    return y, int(jax.device_get(k)), float(jax.device_get(res))
