"""Truncated Neumann-series solver.

Semantics follow the Rust canonical implementation
(/root/reference/src/solver/neumann.rs:252-299): with A = D + R_off, the
iteration matrix is M = I - D^-1 A and

    x = sum_k M^k D^-1 b,   term_{k+1} = -D^-1 R_off term_k.

(The TS port at src/core/solver.ts:117-258 drops the minus sign; we follow the
mathematically correct Rust form.)

Device design: the entire series accumulates on-device in one
``lax.while_loop``; warm restart (``update_rhs``/initial_guess, reference
neumann.rs:436-462) is expressed by running the series on the residual
b - A x0 and adding x0.
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
def _neumann_run(op, b, x0, threshold, max_iters, check_every, norm_mode="l2", mode="residual", change_tol=0.0):
    inv_d = op.inv_diag
    r0 = b - op.matvec(x0)
    term0 = inv_d * r0

    def step(state):
        x, term = state
        term = -inv_d * op.offdiag_matvec(term)
        return x + term, term

    def residual_of(state):
        x, _ = state
        return base.device_norm(op.matvec(x) - b, norm_mode)

    step_block = base.repeat_steps(step, check_every)

    state0 = (x0 + term0, term0)
    (state, k, res, change) = base.while_iterate(
        step_block, residual_of, state0, threshold,
        max_iters, check_every, x_of=lambda st: st[0], mode=mode,
        change_tol=change_tol,
    )
    x, term = state
    # geometric-tail data for the truncation error bound
    # (reference: src/solver/neumann.rs:321-347)
    return x, k, res, change, jnp.linalg.norm(term), jnp.linalg.norm(term0)


def solve_neumann(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    if options.x0 is not None:
        x0 = matrix.pad_vector(options.x0, options.dtype)
    else:
        x0 = jnp.zeros_like(b_pad)
    threshold = base.threshold_for(b, options)

    with base.SolveTimer() as t:
        x, k, res, change, term_n, rhs_n = _neumann_run(
            op, b_pad, x0, threshold, jnp.int32(options.max_iterations), options.check_every,
            base.norm_mode_of(options), base.driver_mode_of(options), options.epsilon,
        )
        jax.block_until_ready(x)
    eb = base.neumann_truncation_bounds(
        matrix, int(jax.device_get(k)), float(jax.device_get(term_n)),
        float(jax.device_get(rhs_n)), float(jax.device_get(res)),
    )
    result = base.finalize(
        matrix, x, k, res, "neumann", options, t.ms,
        matvec_count=int(np.ceil(int(jax.device_get(k)) * (1 + 1 / max(options.check_every, 1)))),
        error_bounds=eb,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=float(jax.device_get(change)))
