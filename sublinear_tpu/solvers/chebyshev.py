"""Chebyshev semi-iterative acceleration of the Jacobi/Neumann iteration.

Beyond-reference capability: the reference's Neumann series converges like
rho^k (rho = spectral radius of D^-1 R).  Chebyshev acceleration over the
same preconditioned operator converges like (rho / (1 + sqrt(1-rho^2)))^k —
roughly squaring the effective rate — using only one extra vector and the
same SpMV per iteration.  Eigenvalue bounds for the preconditioned system
D^-1 A come for free from diagonal dominance (Gershgorin):
lambda in [1-rho, 1+rho] with rho < 1.

Hot path: identical to Neumann (one SpMV + AXPYs per iteration inside a
lax.while_loop), so every large-n SpMV optimization (ELL gather, dense matvec)
applies unchanged.  Valid for DD systems whose preconditioned spectrum is
(approximately) real — the same regime the reference's methods target.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..analysis import analyze
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base


@functools.partial(jax.jit, static_argnames=("check_every", "norm_mode", "mode"))
def _chebyshev_run(op, b, x0, rho, threshold, max_iters, check_every, norm_mode="l2", mode="residual", change_tol=0.0):
    """Chebyshev iteration on D^-1 A x = D^-1 b with spectrum in
    [1-rho, 1+rho]."""
    inv_d = op.inv_diag
    # preconditioned spectrum interval: center theta = 1, half-width delta = rho
    theta = 1.0
    delta = rho
    sigma1 = theta / delta

    def prec_residual(x):
        return inv_d * (b - op.matvec(x))

    # Saad, Iterative Methods (alg. 12.1):
    #   d_k = alpha_k r_k + beta_k d_{k-1};  x_{k+1} = x_k + d_k
    #   alpha_0 = 1/theta, beta_0 = 0, rho_0 = delta/theta
    #   rho_k = 1/(2 sigma1 - rho_{k-1}); alpha_k = 2 rho_k/delta;
    #   beta_k = rho_k rho_{k-1}
    def block(state):
        def one(carry, _):
            x, d, rho_prev, k = carry
            r = prec_residual(x)
            rho_cur = jax.lax.select(
                k == 0,
                jnp.asarray(delta / theta, b.dtype),
                1.0 / (2.0 * sigma1 - rho_prev),
            )
            alpha = jax.lax.select(
                k == 0, jnp.asarray(1.0 / theta, b.dtype), 2.0 * rho_cur / delta
            )
            beta = jax.lax.select(
                k == 0, jnp.asarray(0.0, b.dtype), rho_cur * rho_prev
            )
            d_new = alpha * r + beta * d
            return (x + d_new, d_new, rho_cur, k + 1), None

        carry, _ = jax.lax.scan(one, state, None, length=check_every)
        return carry

    def residual_of(state):
        x, _, _, _ = state
        return base.device_norm(op.matvec(x) - b, norm_mode)

    state0 = (x0, jnp.zeros_like(x0), jnp.asarray(0.0, b.dtype), jnp.int32(0))
    state, kk, res, change = base.while_iterate(
        block, residual_of, state0, threshold, max_iters, check_every,
        x_of=lambda st: st[0], mode=mode, change_tol=change_tol,
    )
    x = state[0]
    return x, kk, res, change


def solve_chebyshev(
    matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True
) -> SolverResult:
    a = analyze(matrix, estimate_condition=False)
    rho = min(max(float(a.spectral_radius_estimate or 0.9), 1e-3), 0.999)
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    x0 = (
        matrix.pad_vector(options.x0, options.dtype)
        if options.x0 is not None
        else jnp.zeros_like(b_pad)
    )
    threshold = base.threshold_for(b, options)
    with base.SolveTimer() as t:
        x, k, res, change = _chebyshev_run(
            op, b_pad, x0, rho, threshold, jnp.int32(options.max_iterations),
            options.check_every, base.norm_mode_of(options),
            base.driver_mode_of(options), options.epsilon,
        )
        jax.block_until_ready(x)
    result = base.finalize(
        matrix, x, k, res, "chebyshev", options, t.ms, matvec_count=int(jax.device_get(k))
    )
    return base.check_outcome(result, threshold, options, raise_on_fail, change=float(jax.device_get(change)))
