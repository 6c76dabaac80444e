"""Conjugate-gradient solver (the reference's real workhorse) + BiCGSTAB.

Parity targets: the optimized CSR+CG fast path
(/root/reference/src/mcp/tools/solver-optimized.ts:68-130, the "MCP dense
190x-regression fix"), the Rust OptimizedConjugateGradientSolver
(/root/reference/src/optimized_solver.rs:167-350) and UltraFastCG
(/root/reference/src/ultra_fast.rs:99-158).

Device design: one fused ``lax.while_loop`` — each CG step is two vector
dots (psum-ready for the sharded variant in parallel/), one SpMV and three
AXPYs, all fused by XLA.  Jacobi (diagonal) preconditioning is available and
used by default for DD systems; BiCGSTAB covers asymmetric systems where CG's
theory does not apply (the reference applies plain CG regardless).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base

_TINY = 1e-30


@functools.partial(jax.jit, static_argnames=("precondition", "mode"))
def _cg_run(op, b, x0, threshold, max_iters, precondition, mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def M(v):  # Jacobi preconditioner
        return inv_d * v if precondition else v

    r0 = b - op.matvec(x0)
    z0 = M(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)

    def not_done(res, change):
        if mode == "relative_change":
            return change > change_tol
        if mode == "combined":
            return (res > threshold) | (change > change_tol)
        return res > threshold

    def cond(carry):
        x, r, p, rz, k, res, change = carry
        return not_done(res, change) & (k < max_iters) & jnp.isfinite(res) & (res < base.HUGE_RES)

    def body(carry):
        x, r, p, rz, k, _, _ = carry
        Ap = op.matvec(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, Ap), _TINY)
        x_new = x + alpha * p
        change = jnp.abs(alpha) * jnp.linalg.norm(p) / jnp.maximum(jnp.linalg.norm(x), _TINY)
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, _TINY)
        p = z + beta * p
        return x_new, r, p, rz_new, k + 1, jnp.linalg.norm(r), change

    big = jnp.asarray(jnp.inf, b.dtype)
    carry0 = (x0, r0, p0, rz0, jnp.int32(0), jnp.linalg.norm(r0), big)
    x, r, p, rz, k, res, change = jax.lax.while_loop(cond, body, carry0)
    return x, k, res, change


@functools.partial(jax.jit, static_argnames=("mode",))
def _bicgstab_run(op, b, x0, threshold, max_iters, mode="residual", change_tol=0.0):
    r0 = b - op.matvec(x0)
    rhat = r0

    def not_done(res, change):
        if mode == "relative_change":
            return change > change_tol
        if mode == "combined":
            return (res > threshold) | (change > change_tol)
        return res > threshold

    def cond(carry):
        x, r, p, v, rho, alpha, omega, k, res, change = carry
        return not_done(res, change) & (k < max_iters) & jnp.isfinite(res) & (res < base.HUGE_RES)

    def body(carry):
        x, r, p, v, rho, alpha, omega, k, _, _ = carry
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / jnp.where(jnp.abs(rho) > _TINY, rho, _TINY)) * (
            alpha / jnp.where(jnp.abs(omega) > _TINY, omega, _TINY)
        )
        p = r + beta * (p - omega * v)
        v = op.matvec(p)
        alpha = rho_new / jnp.where(jnp.abs(jnp.vdot(rhat, v)) > _TINY, jnp.vdot(rhat, v), _TINY)
        s = r - alpha * v
        t = op.matvec(s)
        tt = jnp.vdot(t, t)
        omega = jnp.vdot(t, s) / jnp.where(tt > _TINY, tt, _TINY)
        dx = alpha * p + omega * s
        x_new = x + dx
        change = jnp.linalg.norm(dx) / jnp.maximum(jnp.linalg.norm(x), _TINY)
        r = s - omega * t
        return x_new, r, p, v, rho_new, alpha, omega, k + 1, jnp.linalg.norm(r), change

    z = jnp.zeros_like(b)
    one = jnp.asarray(1.0, b.dtype)
    big = jnp.asarray(jnp.inf, b.dtype)
    carry0 = (x0, r0, z, z, one, one, one, jnp.int32(0), jnp.linalg.norm(r0), big)
    out = jax.lax.while_loop(cond, body, carry0)
    return out[0], out[7], out[8], out[9]


def _prepare(matrix: Matrix, b, options: SolverOptions):
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    x0 = (
        matrix.pad_vector(options.x0, options.dtype)
        if options.x0 is not None
        else jnp.zeros_like(b_pad)
    )
    return op, b_pad, x0, base.threshold_for(b, options)


def solve_cg(
    matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True, precondition: bool = True
) -> SolverResult:
    op, b_pad, x0, threshold = _prepare(matrix, b, options)
    with base.SolveTimer() as t:
        x, k, res, change = _cg_run(op, b_pad, x0, threshold, jnp.int32(options.max_iterations), precondition, base.driver_mode_of(options), options.epsilon)
        jax.block_until_ready(x)
    k_host = int(jax.device_get(k))
    result = base.finalize(
        matrix, x, k, res, "conjugate-gradient", options, t.ms, matvec_count=k_host + 1
    )
    return base.check_outcome(result, threshold, options, raise_on_fail, change=float(jax.device_get(change)))


def solve_bicgstab(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    op, b_pad, x0, threshold = _prepare(matrix, b, options)
    with base.SolveTimer() as t:
        x, k, res, change = _bicgstab_run(op, b_pad, x0, threshold, jnp.int32(options.max_iterations), base.driver_mode_of(options), options.epsilon)
        jax.block_until_ready(x)
    result = base.finalize(
        matrix, x, k, res, "bicgstab", options, t.ms, matvec_count=2 * int(jax.device_get(k)) + 1
    )
    return base.check_outcome(result, threshold, options, raise_on_fail, change=float(jax.device_get(change)))
