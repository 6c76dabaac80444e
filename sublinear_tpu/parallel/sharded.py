"""Distributed solvers: row-partitioned SpMV over a device mesh.

The device-mesh replacement for the reference's single-node scale story
(SURVEY.md §2.7, §5.8): A's rows are partitioned across the ``rows`` mesh
axis, batched RHS across ``batch``.  Two execution modes:

  1. ``auto`` (GSPMD): operator arrays are placed with NamedShardings and the
     SAME jitted solver programs run unchanged — XLA's SPMD partitioner
     inserts the all-gathers/psums.  This is the idiomatic pjit path and
     works for every solver in the library.
  2. ``explicit`` (shard_map): a hand-scheduled CG where the search direction
     is re-replicated with one ``all_gather`` per iteration (the halo
     exchange) and dot products are ``psum``-reduced over shards — the
     scheme SURVEY.md §5.7/§5.8 calls for; XLA hands the collectives to
     NCCL, over NVLink between the cards of one host.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import LANE, round_up
from ..formats import ell as _ell
from ..matrix import Matrix
from ..solvers import base
from ..types import SolverOptions, SolverResult
from . import mesh as mesh_mod
from .mesh import BATCH, ROWS


def shard_operator(matrix: Matrix, mesh: Mesh, dtype=None) -> _ell.EllOperator:
    """Build an ELL operator padded to the mesh row-count and place its arrays
    (GSPMD path: XLA partitions the kernels, including the hub-row COO tail —
    slot_cap stays at the 98th-percentile default so power-law matrices don't
    blow ELL memory up to K_max * n_pad per shard)."""
    n_rows_axis = mesh.shape[ROWS]
    csr = matrix.csr
    n = csr.shape[0]
    op = _ell.ell_from_csr(csr, dtype)

    target = round_up(max(n, 1), LANE * n_rows_axis)
    if op.n_pad != target:
        # re-pad to a shard-divisible width
        pad = target - op.n_pad

        def pad_row_axis(a):
            return jnp.pad(a, ((0, 0), (0, pad)))

        op = _ell.EllOperator(
            pad_row_axis(op.values), pad_row_axis(op.cols),
            op.tail_vals, op.tail_rows, op.tail_cols,
            jnp.pad(op.diag, (0, pad)), jnp.pad(op.inv_diag, (0, pad)),
            shape=op.shape, n_pad=target, m_pad=target,
        )

    ell_sh = NamedSharding(mesh, P(None, ROWS))
    vec_sh = NamedSharding(mesh, P(ROWS))
    return _ell.EllOperator(
        jax.device_put(op.values, ell_sh),
        jax.device_put(op.cols, ell_sh),
        op.tail_vals, op.tail_rows, op.tail_cols,
        jax.device_put(op.diag, vec_sh),
        jax.device_put(op.inv_diag, vec_sh),
        shape=op.shape, n_pad=op.n_pad, m_pad=op.m_pad,
    )


class SplitShardedOperator:
    """Row-partitioned operator for the explicit shard_map solvers.

    Per shard, the owned row block is split into
      - a *local* ELL block (columns owned by the same shard, local indices)
        whose matvec needs no communication,
      - a *remote* ELL block (global column indices into the gathered vector),
      - a per-shard COO tail (local rows, global columns) absorbing hub-row
        overflow so slot caps stay at the 98th percentile even on power-law
        degree distributions (the round-2 `slot_cap = max(row_nnz)` scheme
        made one hub row cost K*n_pad/D per shard).

    The local/remote split makes the p all_gather overlappable with the
    communication-free local SpMV (SURVEY.md §5.7/§5.8; the reference's rayon
    row-chunk parallel matvec /root/reference/src/matrix/optimized.rs:397-449
    has no equivalent overlap structure).  Whether the backend actually
    overlaps the gather with the local product is a scheduling decision
    of XLA; the structural independence this split provides is what
    enables it.
    """

    def __init__(self, vals_loc, cols_loc, vals_rem, cols_rem, tail_vals,
                 tail_rows, tail_cols, diag, inv_diag, *, shape, n_pad,
                 shards, tail_per_shard):
        self.vals_loc = vals_loc        # (K_loc, n_pad) sharded P(None, ROWS)
        self.cols_loc = cols_loc        # int32, LOCAL column indices
        self.vals_rem = vals_rem        # (K_rem, n_pad) sharded P(None, ROWS)
        self.cols_rem = cols_rem        # int32, GLOBAL column indices
        self.tail_vals = tail_vals      # (D*T,) sharded P(ROWS)
        self.tail_rows = tail_rows      # (D*T,) LOCAL row idx, sorted per shard
        self.tail_cols = tail_cols      # (D*T,) GLOBAL col idx
        self.diag = diag                # (n_pad,) sharded P(ROWS)
        self.inv_diag = inv_diag        # (n_pad,) sharded P(ROWS)
        self.shape = shape
        self.n_pad = n_pad
        self.shards = shards
        self.tail_per_shard = tail_per_shard

    @property
    def dtype(self):
        return self.vals_loc.dtype

    def bytes_per_shard(self) -> int:
        """Device bytes held per shard (memory accounting for scaling runs)."""
        per = 0
        for a in (self.vals_loc, self.cols_loc, self.vals_rem, self.cols_rem):
            per += a.size * a.dtype.itemsize // self.shards
        for a in (self.tail_vals, self.tail_rows, self.tail_cols,
                  self.diag, self.inv_diag):
            per += a.size * a.dtype.itemsize // self.shards
        return per

    def comm_bytes_per_gather(self) -> int:
        """Bytes received per device by one tiled all_gather of the iterate."""
        S = self.n_pad // self.shards
        return (self.n_pad - S) * self.dtype.itemsize


def shard_operator_split(matrix: Matrix, mesh: Mesh, dtype=None) -> SplitShardedOperator:
    """Build the local/remote split operator for explicit shard_map solvers."""
    from ..config import resolve_dtype

    dt = resolve_dtype(dtype)
    D = int(mesh.shape[ROWS])
    csr = matrix.csr
    n, m = csr.shape
    n_pad = round_up(max(n, 1), LANE * D)
    S = n_pad // D

    rows = csr.row_of_entry().astype(np.int64)
    cols = csr.indices.astype(np.int64)
    data = csr.data
    owner = rows // S
    is_loc = (cols // S) == owner

    # per-row slot position within each class (entries are CSR row-sorted)
    def class_positions(mask):
        idx = np.flatnonzero(mask)
        r = rows[idx]
        # position of each entry within its row, in CSR order
        start = np.r_[0, np.flatnonzero(np.diff(r)) + 1]
        counts = np.diff(np.r_[start, len(r)])
        pos = np.arange(len(r)) - np.repeat(start, counts)
        cnt = np.bincount(r, minlength=n)
        return idx, pos, cnt

    li, lpos, lcnt = class_positions(is_loc)
    ri, rpos, rcnt = class_positions(~is_loc)
    K_loc = _ell.choose_slot_cap(lcnt)
    K_rem = _ell.choose_slot_cap(rcnt) if len(ri) else 1

    vals_loc = np.zeros((K_loc, n_pad), dtype=np.float64)
    cols_loc = np.zeros((K_loc, n_pad), dtype=np.int32)
    sel = lpos < K_loc
    vals_loc[lpos[sel], rows[li][sel]] = data[li][sel]
    cols_loc[lpos[sel], rows[li][sel]] = (cols[li][sel] - owner[li][sel] * S)

    vals_rem = np.zeros((K_rem, n_pad), dtype=np.float64)
    cols_rem = np.zeros((K_rem, n_pad), dtype=np.int32)
    selr = rpos < K_rem
    vals_rem[rpos[selr], rows[ri][selr]] = data[ri][selr]
    cols_rem[rpos[selr], rows[ri][selr]] = cols[ri][selr]

    # hub-row overflow -> per-shard COO tail, padded to a uniform length
    ti = np.concatenate([li[~sel], ri[~selr]])
    t_owner = owner[ti]
    T = int(np.bincount(t_owner, minlength=D).max()) if len(ti) else 0
    T = max(T, 1)
    tail_vals = np.zeros(D * T, dtype=np.float64)
    tail_rows = np.full(D * T, S - 1, dtype=np.int32)   # keep rows sorted
    tail_cols = np.zeros(D * T, dtype=np.int32)
    for d in range(D):
        e = ti[t_owner == d]
        e = e[np.argsort(rows[e], kind="stable")]
        tail_vals[d * T:d * T + len(e)] = data[e]
        tail_rows[d * T:d * T + len(e)] = (rows[e] - d * S).astype(np.int32)
        tail_cols[d * T:d * T + len(e)] = cols[e].astype(np.int32)

    diag, inv_diag = _ell._diag_arrays(csr, n_pad, dt)

    ell_sh = NamedSharding(mesh, P(None, ROWS))
    vec_sh = NamedSharding(mesh, P(ROWS))
    put = jax.device_put
    return SplitShardedOperator(
        put(jnp.asarray(vals_loc, dt), ell_sh), put(jnp.asarray(cols_loc), ell_sh),
        put(jnp.asarray(vals_rem, dt), ell_sh), put(jnp.asarray(cols_rem), ell_sh),
        put(jnp.asarray(tail_vals, dt), vec_sh), put(jnp.asarray(tail_rows), vec_sh),
        put(jnp.asarray(tail_cols), vec_sh),
        put(diag, vec_sh), put(inv_diag, vec_sh),
        shape=(n, m), n_pad=n_pad, shards=D, tail_per_shard=T,
    )


def _split_matvec(vals_loc, cols_loc, vals_rem, cols_rem, tv, tr, tc, p_l):
    """Per-shard SpMV: communication-free local block first, then the remote
    block + tail over the gathered vector.  The all_gather's only consumer is
    the second term, so XLA overlaps it with the local SpMV."""
    from ..ops import spmv

    S = p_l.shape[0]
    p_full = jax.lax.all_gather(p_l, ROWS, tiled=True)
    y_l = spmv.ell_matvec(vals_loc, cols_loc, p_l)
    y_l = y_l + spmv.ell_matvec(vals_rem, cols_rem, p_full)
    y_l = y_l + spmv.coo_matvec(tv, tr, tc, p_full, S)
    return y_l


# ------------------------------------------------------------------ explicit

def _explicit_cg_factory(mesh: Mesh):
    """shard_map CG with FULLY row-sharded state: x, r, z, p all live as
    per-shard blocks (O(n/D) persistent memory per chip); the gathered search
    direction exists only transiently inside the matvec, overlapped with the
    communication-free local-block SpMV.  Dot products psum over shards."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, ROWS), P(None, ROWS),            # local ELL block
            P(None, ROWS), P(None, ROWS),            # remote ELL block
            P(ROWS), P(ROWS), P(ROWS),               # tail vals/rows/cols
            P(ROWS), P(ROWS), P(ROWS),               # inv_diag, b_l, x0_l
            P(), P(),                                # threshold, max_iters
        ),
        out_specs=(P(ROWS), P(), P()),
        check_vma=False,
    )
    def cg_shard(vl, cl, vr, cr, tv, tr, tc, invd_l, b_l, x0_l,
                 threshold, max_iters):
        def matvec(p_l):
            return _split_matvec(vl, cl, vr, cr, tv, tr, tc, p_l)

        def pdot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), ROWS)

        r_l = b_l - matvec(x0_l)
        z_l = invd_l * r_l
        p_l = z_l
        rz0 = pdot(r_l, z_l)
        res0 = jnp.sqrt(pdot(r_l, r_l))

        def cond(carry):
            x_l, r_l, p_l, rz, k, res = carry
            return (res > threshold) & (k < max_iters) & jnp.isfinite(res) & (res < base.HUGE_RES)

        def body(carry):
            x_l, r_l, p_l, rz, k, _ = carry
            Ap_l = matvec(p_l)
            pAp = pdot(p_l, Ap_l)
            alpha = rz / jnp.maximum(pAp, 1e-30)
            x_l = x_l + alpha * p_l
            r_l = r_l - alpha * Ap_l
            z_l = invd_l * r_l
            rz_new = pdot(r_l, z_l)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p_l = z_l + beta * p_l
            res = jnp.sqrt(pdot(r_l, r_l))
            return x_l, r_l, p_l, rz_new, k + 1, res

        carry0 = (x0_l, r_l, p_l, rz0, jnp.int32(0), res0)
        x_l, r_l, p_l, rz, k, res = jax.lax.while_loop(cond, body, carry0)
        return x_l, k, res

    return jax.jit(cg_shard)


from ..utils.lru import LRUCache

# keyed by mesh signature (not matrix): a handful of program factories
_EXPLICIT_CACHE = LRUCache(maxsize=8)


def _check_mode(mode: str, allowed: tuple) -> None:
    if mode not in allowed:
        from ..errors import InvalidParametersError

        raise InvalidParametersError(
            f"unknown sharded mode {mode!r}; expected one of {list(allowed)}",
            {"mode": mode},
        )


def lower_explicit_cg_text(matrix: Matrix, b, mesh: Optional[Mesh] = None,
                           options: Optional[SolverOptions] = None) -> str:
    """Optimized-HLO text of the compiled explicit CG — lets callers assert
    its collectives (parallel/hlo.py): one all-gather per iteration."""
    options = options or SolverOptions()
    mesh = mesh or mesh_mod.make_mesh()
    op = shard_operator_split(matrix, mesh, options.dtype)
    vec_sh = NamedSharding(mesh, P(ROWS))
    b_local = jax.device_put(
        _ell.pad_vector(np.asarray(b, np.float64), op.n_pad, op.dtype), vec_sh)
    x0 = jax.device_put(jnp.zeros(op.n_pad, op.dtype), vec_sh)
    lowered = _explicit_cg_factory(mesh).lower(
        op.vals_loc, op.cols_loc, op.vals_rem, op.cols_rem,
        op.tail_vals, op.tail_rows, op.tail_cols,
        op.inv_diag, b_local, x0,
        jnp.asarray(base.threshold_for(b, options), op.dtype),
        jnp.int32(options.max_iterations))
    return lowered.compile().as_text()


def solve_cg_sharded(
    matrix: Matrix,
    b,
    mesh: Optional[Mesh] = None,
    options: Optional[SolverOptions] = None,
    mode: str = "explicit",
    raise_on_fail: bool = True,
) -> SolverResult:
    """Distributed (preconditioned) CG over a row-partitioned operator.

    ``mode``: 'auto' (GSPMD placement, XLA partitions the standard solver)
    or 'explicit' (hand-scheduled shard_map with split local/remote
    blocks)."""
    _check_mode(mode, ("auto", "explicit"))
    options = options or SolverOptions()
    mesh = mesh or mesh_mod.make_mesh()
    n = matrix.shape[0]
    threshold = base.threshold_for(b, options)

    if mode == "auto":
        from ..solvers.cg import _cg_run

        op = shard_operator(matrix, mesh, options.dtype)
        b_full = _ell.pad_vector(np.asarray(b, dtype=np.float64), op.n_pad, op.dtype)
        b_local = jax.device_put(b_full, NamedSharding(mesh, P(ROWS)))
        x0_np = np.zeros(op.n_pad) if options.x0 is None else np.pad(
            np.asarray(options.x0, dtype=np.float64), (0, op.n_pad - n)
        )
        x0 = jax.device_put(jnp.asarray(x0_np, op.dtype), NamedSharding(mesh, P()))
        with base.SolveTimer() as t:
            x, k, res, _ = _cg_run(op, b_local, x0, threshold, jnp.int32(options.max_iterations), True)
            jax.block_until_ready(x)
    else:
        op = shard_operator_split(matrix, mesh, options.dtype)
        vec_sh = NamedSharding(mesh, P(ROWS))
        b_full = _ell.pad_vector(np.asarray(b, dtype=np.float64), op.n_pad, op.dtype)
        b_local = jax.device_put(b_full, vec_sh)
        x0_np = np.zeros(op.n_pad) if options.x0 is None else np.pad(
            np.asarray(options.x0, dtype=np.float64), (0, op.n_pad - n)
        )
        x0 = jax.device_put(jnp.asarray(x0_np, op.dtype), vec_sh)
        key = (tuple(mesh.shape.items()), tuple(d.id for d in mesh.devices.flat), "cg")
        fn = _EXPLICIT_CACHE.get(key)
        if fn is None:
            fn = _EXPLICIT_CACHE.put(key, _explicit_cg_factory(mesh))
        with base.SolveTimer() as t:
            x, k, res = fn(
                op.vals_loc, op.cols_loc, op.vals_rem, op.cols_rem,
                op.tail_vals, op.tail_rows, op.tail_cols,
                op.inv_diag, b_local, x0,
                jnp.asarray(threshold, op.dtype), jnp.int32(options.max_iterations),
            )
            jax.block_until_ready(x)

    result = base.finalize(
        matrix, x, k, res, f"cg-sharded-{mode}", options, t.ms,
        matvec_count=int(jax.device_get(k)) + 1,
    )
    if mode != "auto":
        result.distribution = {
            "shards": op.shards,
            "bytes_per_shard": op.bytes_per_shard(),
            "comm_bytes_per_iter": op.comm_bytes_per_gather(),
        }
    return base.check_outcome(result, threshold, options, raise_on_fail)


def _explicit_neumann_factory(mesh: Mesh):
    """shard_map Neumann series with row-sharded x/term state; the gathered
    term vector exists only transiently inside the split matvec (overlapped
    with the local-block SpMV), and the residual check psum-reduces partial
    norms — the overlapped halo-exchange schedule of SURVEY.md §5.7."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, ROWS), P(None, ROWS),            # local ELL block
            P(None, ROWS), P(None, ROWS),            # remote ELL block
            P(ROWS), P(ROWS), P(ROWS),               # tail vals/rows/cols
            P(ROWS), P(ROWS),                        # diag, inv_diag
            P(ROWS), P(ROWS),                        # b_local, x0_local
            P(), P(), P(),                           # threshold, max_iters, check_every
        ),
        out_specs=(P(ROWS), P(), P()),
        check_vma=False,
    )
    def neumann_shard(vl, cl, vr, cr, tv, tr, tc, diag_l, invd_l, b_l, x0_l,
                      threshold, max_iters, check_every):
        def matvec(v_l):
            return _split_matvec(vl, cl, vr, cr, tv, tr, tc, v_l)

        def pnorm(v_l):
            return jnp.sqrt(jax.lax.psum(jnp.vdot(v_l, v_l), ROWS))

        r0_l = b_l - matvec(x0_l)
        term0_l = invd_l * r0_l
        x_l = x0_l + term0_l

        def cond(carry):
            x_l, term_l, k, res = carry
            return (res > threshold) & (k < max_iters) & jnp.isfinite(res) & (res < base.HUGE_RES)

        def body(carry):
            x_l, term_l, k, _ = carry

            def inner(i, st):
                x_l, term_l, _ = st
                at_l = matvec(term_l) - diag_l * term_l
                term_l = -invd_l * at_l
                return x_l + term_l, term_l, at_l

            x_l, term_l, at_l = jax.lax.fori_loop(
                0, check_every, inner, (x_l, term_l, jnp.zeros_like(term_l)))
            # Neumann residual identity: at_l = R_off t_last is the exact
            # residual (negated) of the previous iterate — a strict upper
            # bound for the current x_l, saving one full matvec (and its
            # all_gather) per convergence check
            res = pnorm(at_l)
            return x_l, term_l, k + check_every, res

        res0 = pnorm(matvec(x_l) - b_l)
        x_l, term_l, k, res = jax.lax.while_loop(
            cond, body, (x_l, term0_l, jnp.int32(0), res0)
        )
        return x_l, k, res

    return jax.jit(neumann_shard)


def solve_neumann_sharded(
    matrix: Matrix,
    b,
    mesh: Optional[Mesh] = None,
    options: Optional[SolverOptions] = None,
    raise_on_fail: bool = True,
    mode: str = "explicit",
) -> SolverResult:
    """Distributed Neumann series over a row-partitioned operator
    (``mode="explicit"``: the shard_map schedule with split local/remote
    blocks)."""
    _check_mode(mode, ("explicit",))
    options = options or SolverOptions()
    mesh = mesh or mesh_mod.make_mesh()
    op = shard_operator_split(matrix, mesh, options.dtype)
    n = matrix.shape[0]
    vec_sh = NamedSharding(mesh, P(ROWS))
    b_full = _ell.pad_vector(np.asarray(b, dtype=np.float64), op.n_pad, op.dtype)
    b_local = jax.device_put(b_full, vec_sh)
    x0_np = np.zeros(op.n_pad) if options.x0 is None else np.pad(
        np.asarray(options.x0, dtype=np.float64), (0, op.n_pad - n)
    )
    x0 = jax.device_put(jnp.asarray(x0_np, op.dtype), vec_sh)
    threshold = base.threshold_for(b, options)

    key = (tuple(mesh.shape.items()), tuple(d.id for d in mesh.devices.flat), "neumann")
    fn = _EXPLICIT_CACHE.get(key)
    if fn is None:
        fn = _EXPLICIT_CACHE.put(key, _explicit_neumann_factory(mesh))
    with base.SolveTimer() as t:
        x, k, res = fn(
            op.vals_loc, op.cols_loc, op.vals_rem, op.cols_rem,
            op.tail_vals, op.tail_rows, op.tail_cols,
            op.diag, op.inv_diag, b_local, x0,
            jnp.asarray(threshold, op.dtype), jnp.int32(options.max_iterations),
            jnp.int32(options.check_every),
        )
        jax.block_until_ready(x)
    result = base.finalize(
        matrix, x, k, res, "neumann-sharded", options, t.ms,
        matvec_count=int(jax.device_get(k)),
    )
    result.distribution = {
        "shards": op.shards,
        "bytes_per_shard": op.bytes_per_shard(),
        "comm_bytes_per_iter": op.comm_bytes_per_gather(),
    }
    return base.check_outcome(result, threshold, options, raise_on_fail)


# ------------------------------------------------------------------ batched

@functools.partial(jax.jit, static_argnames=("precondition",))
def _cg_batch_run(op, B, X0, thresholds, max_iters, precondition):
    """CG over a block of RHS columns with PER-COLUMN convergence thresholds
    (``thresholds``: (nrhs,)) — a column with a tiny RHS norm is held to its
    own relative tolerance, not the loosest column's.
    Replaces the reference's sequential batch loop (tools/solver.ts:291-321)."""
    inv_d = op.inv_diag

    def M(V):
        return inv_d[:, None] * V if precondition else V

    R0 = B - op.matmat(X0)
    Z0 = M(R0)
    P0 = Z0
    rz0 = jnp.sum(R0 * Z0, axis=0)

    def col_res(R):
        return jnp.sqrt(jnp.sum(R * R, axis=0))

    def cond(carry):
        X, R, Pd, rz, k, res = carry
        return jnp.any(res > thresholds) & (k < max_iters) & jnp.all(jnp.isfinite(res))

    def body(carry):
        X, R, Pd, rz, k, _ = carry
        AP = op.matmat(Pd)
        pAp = jnp.sum(Pd * AP, axis=0)
        alpha = rz / jnp.maximum(pAp, 1e-30)
        X = X + alpha[None, :] * Pd
        R = R - alpha[None, :] * AP
        Z = M(R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        Pd = Z + beta[None, :] * Pd
        return X, R, Pd, rz_new, k + 1, col_res(R)

    carry0 = (X0, R0, P0, rz0, jnp.int32(0), col_res(R0))
    X, R, Pd, rz, k, res = jax.lax.while_loop(cond, body, carry0)
    return X, k, col_res(R)


@functools.partial(jax.jit, static_argnames=("x0_zero",))
def _neumann_batch_run(op, B, X0, thresholds, max_iters, x0_zero: bool = False):
    """Batched Neumann series over a RHS block with per-column convergence
    thresholds — the DD-convergent batch driver for asymmetric systems where
    plain CG has no guarantee.

    Structure:
      - ALL iteration state rides batch-major (B, n), so the hot SpMM
        gathers whole x columns per index (``ell_matmat_bmajor``);
      - the Neumann residual identity r(X_k) = -R_off T_k makes the per-
        iteration convergence check FREE (no second matmat per iteration);
      - with ``x0_zero`` (static) the two startup matmats (initial residual
        + first convergence check) are skipped: A @ 0 is zero and the first
        res check is forced into the loop with an inf seed.
    The returned residuals are the EXACT final B - A X column norms,
    measured once after the loop."""
    inv_d = op.inv_diag
    diag = op.diag

    if hasattr(op, "matmat_bmajor"):
        matmatT = op.matmat_bmajor

        def col_res(RT):
            return jnp.sqrt(jnp.sum(RT * RT, axis=1))

        BT = B.T
        if x0_zero:
            T0 = inv_d[None, :] * BT
            X0T = jnp.zeros_like(BT)
        else:
            X0T = X0.T
            T0 = inv_d[None, :] * (BT - matmatT(X0T))

        def cond(carry):
            X, T, k, res = carry
            return jnp.any(res > thresholds) & (k < max_iters) & jnp.all(jnp.isfinite(res))

        def body(carry):
            X, T, k, _ = carry
            RT = matmatT(T) - diag[None, :] * T
            res = col_res(RT)
            T = -inv_d[None, :] * RT
            X = X + T
            return X, T, k + 1, res

        # large FINITE seed: the cond's non-finite guard must not trip on it
        res0 = jnp.full((BT.shape[0],), jnp.finfo(BT.dtype).max / 4, BT.dtype)
        carry0 = (X0T + T0, T0, jnp.int32(1), res0)
        XT, T, k, _ = jax.lax.while_loop(cond, body, carry0)
        RT = BT - matmatT(XT)
        return XT.T, k, col_res(RT)

    # n-major path for operators without a batch-major product (sharded
    # operators: the (n, B) layout carries the mesh sharding, so keep it)
    def col_res_n(R):
        return jnp.sqrt(jnp.sum(R * R, axis=0))

    if x0_zero:
        T0 = inv_d[:, None] * B
        X0 = jnp.zeros_like(B)
    else:
        T0 = inv_d[:, None] * (B - op.matmat(X0))

    def cond_n(carry):
        X, T, k, res = carry
        return jnp.any(res > thresholds) & (k < max_iters) & jnp.all(jnp.isfinite(res))

    def body_n(carry):
        X, T, k, _ = carry
        RT = op.matmat(T) - diag[:, None] * T
        res = col_res_n(RT)
        T = -inv_d[:, None] * RT
        X = X + T
        return X, T, k + 1, res

    res0 = jnp.full((B.shape[1],), jnp.finfo(B.dtype).max / 4, B.dtype)
    carry0 = (X0 + T0, T0, jnp.int32(1), res0)
    X, T, k, _ = jax.lax.while_loop(cond_n, body_n, carry0)
    R = B - op.matmat(X)
    return X, k, col_res_n(R)


def solve_batch(
    matrix: Matrix,
    B,
    options: Optional[SolverOptions] = None,
    mesh: Optional[Mesh] = None,
    raise_on_fail: bool = False,
    method: str = "auto",
):
    """Solve A X = B for many RHS at once (B: (n, nrhs)).  With a mesh, the
    RHS block is sharded over the ``batch`` axis and rows over ``rows``.

    ``method``: 'cg' | 'neumann' | 'auto' (CG when symmetric, else the
    DD-convergent batched Neumann series)."""
    options = options or SolverOptions()
    n = matrix.shape[0]
    B = np.asarray(B, dtype=np.float64)
    if B.ndim != 2 or B.shape[0] != n:
        from ..errors import DimensionMismatchError

        raise DimensionMismatchError(f"batch RHS must be (n, k), got {B.shape}")

    nrhs = B.shape[1]
    if mesh is not None:
        op = shard_operator(matrix, mesh, options.dtype)
        B_pad = np.zeros((op.n_pad, nrhs))
        B_pad[:n] = B
        B_dev = jax.device_put(
            jnp.asarray(B_pad, op.dtype), NamedSharding(mesh, P(None, BATCH))
        )
    else:
        op = matrix.op(options.dtype)
        B_pad = np.zeros((op.n_pad, nrhs))
        B_pad[:n] = B
        B_dev = jnp.asarray(B_pad, op.dtype)

    X0 = jnp.zeros_like(B_dev)
    norms = np.linalg.norm(B, axis=0)
    # Per-column thresholds: eps * ||b_j|| for 'relative', so a column whose
    # RHS norm is 6 orders of magnitude below its neighbours still meets its
    # OWN relative tolerance (not eps * max_j ||b_j||).
    if options.convergence == "relative":
        thr_cols = float(options.epsilon) * np.maximum(norms, 1e-30)
    else:
        thr_cols = np.full(nrhs, float(options.epsilon))
    thresholds = jnp.asarray(thr_cols, op.dtype)

    if method == "auto":
        from ..analysis import analyze

        a = analyze(matrix, estimate_condition=False)
        method = "cg" if a.is_symmetric else (
            "neumann" if a.is_diagonally_dominant else "cg"
        )
    with base.SolveTimer() as t:
        if method == "neumann":
            X, k, col_res = _neumann_batch_run(op, B_dev, X0, thresholds, jnp.int32(options.max_iterations), x0_zero=True)
        else:
            X, k, col_res = _cg_batch_run(op, B_dev, X0, thresholds, jnp.int32(options.max_iterations), True)
        jax.block_until_ready(X)

    X_host = np.asarray(jax.device_get(X), dtype=np.float64)[:n]
    res = np.asarray(jax.device_get(col_res), dtype=np.float64)
    results = []
    for j in range(B.shape[1]):
        results.append(
            SolverResult(
                solution=X_host[:, j],
                iterations=int(jax.device_get(k)),
                residual=float(res[j]),
                converged=bool(res[j] <= thr_cols[j] * 1.0000001),
                method=f"{method}-batch",
                compute_time_ms=t.ms,
            )
        )
    return results
