"""Device-side operator pytrees (slot-major ELL + COO tail, and dense).

These are the objects the jitted solver programs consume.  Array leaves are
pytree children; shape metadata is static so jit caches per (shape, K, tail)
signature.

Replaces the reference's storage layer (CSRStorage/CSCStorage/COOStorage,
/root/reference/src/matrix/sparse.rs:16-905) with a device format: slot-major
ELL with the row axis minor, zero-padded to a multiple of 128 rows so
kernels need no masks (see ops/spmv.py for the kernel rationale).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import LANE, resolve_dtype, round_up
from ..ops import spmv
from .csr import CSR


@jax.tree_util.register_pytree_node_class
class EllOperator:
    """Slot-major ELL + COO-tail sparse operator in the padded domain."""

    def __init__(self, values, cols, tail_vals, tail_rows, tail_cols, diag, inv_diag, *, shape, n_pad, m_pad):
        self.values = values        # (K, n_pad)
        self.cols = cols            # (K, n_pad) int32 into padded column domain
        self.tail_vals = tail_vals  # (T,)
        self.tail_rows = tail_rows  # (T,) int32, sorted ascending
        self.tail_cols = tail_cols  # (T,) int32
        self.diag = diag            # (n_pad,) zero-padded
        self.inv_diag = inv_diag    # (n_pad,) zero-padded (0 where diag==0)
        self.shape = shape          # logical (n, m)
        self.n_pad = n_pad
        self.m_pad = m_pad

    # pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        children = (self.values, self.cols, self.tail_vals, self.tail_rows,
                    self.tail_cols, self.diag, self.inv_diag)
        aux = (self.shape, self.n_pad, self.m_pad)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, n_pad, m_pad = aux
        return cls(*children, shape=shape, n_pad=n_pad, m_pad=m_pad)

    # properties -----------------------------------------------------------
    @property
    def dtype(self):
        return self.values.dtype

    @property
    def slot_count(self) -> int:
        return int(self.values.shape[0])

    @property
    def tail_nnz(self) -> int:
        return int(self.tail_vals.shape[0])

    @property
    def nnz(self) -> int:
        # padded slots hold zeros; count is approximate upper bound on device.
        return int(self.values.shape[0] * self.values.shape[1]) + self.tail_nnz

    # products -------------------------------------------------------------
    def matvec(self, x: jax.Array) -> jax.Array:
        y = spmv.ell_matvec(self.values, self.cols, x)
        if self.tail_nnz:
            y = y + spmv.coo_matvec(self.tail_vals, self.tail_rows, self.tail_cols, x, self.n_pad)
        return y

    def matmat(self, X: jax.Array) -> jax.Array:
        Y = spmv.ell_matmat(self.values, self.cols, X)
        if self.tail_nnz:
            Y = Y + spmv.coo_matmat(self.tail_vals, self.tail_rows, self.tail_cols, X, self.n_pad)
        return Y

    def matmat_bmajor(self, XT: jax.Array) -> jax.Array:
        """Batch-major product (B, m_pad) -> (B, n_pad); see
        spmv.ell_matmat_bmajor for why this layout is faster."""
        YT = spmv.ell_matmat_bmajor(self.values, self.cols, XT)
        if self.tail_nnz:
            YT = YT + spmv.coo_matmat_bmajor(
                self.tail_vals, self.tail_rows, self.tail_cols, XT, self.n_pad)
        return YT

    def offdiag_matvec(self, x: jax.Array) -> jax.Array:
        """(A - D) @ x — the Neumann-series iteration product
        (reference: src/core/solver.ts:263-273, src/solver/neumann.rs:280-299)."""
        return self.matvec(x) - self.diag * x

    def as_dense(self) -> jax.Array:
        """Materialize padded dense (n_pad, m_pad) — for small operators only."""
        out = jnp.zeros((self.n_pad, self.m_pad), self.dtype)
        k, npad = self.values.shape
        rows = jax.lax.broadcasted_iota(jnp.int32, (k, npad), 1)
        out = out.at[rows.reshape(-1), self.cols.reshape(-1)].add(self.values.reshape(-1))
        if self.tail_nnz:
            out = out.at[self.tail_rows, self.tail_cols].add(self.tail_vals)
        return out


@jax.tree_util.register_pytree_node_class
class DenseOperator:
    """Dense padded operator — the path for small or dense matrices."""

    def __init__(self, data, diag, inv_diag, *, shape, n_pad, m_pad):
        self.data = data          # (n_pad, m_pad)
        self.diag = diag          # (n_pad,)
        self.inv_diag = inv_diag  # (n_pad,)
        self.shape = shape
        self.n_pad = n_pad
        self.m_pad = m_pad

    def tree_flatten(self):
        return (self.data, self.diag, self.inv_diag), (self.shape, self.n_pad, self.m_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        shape, n_pad, m_pad = aux
        return cls(*children, shape=shape, n_pad=n_pad, m_pad=m_pad)

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x: jax.Array) -> jax.Array:
        return spmv.dense_matvec(self.data, x)

    def matmat(self, X: jax.Array) -> jax.Array:
        return spmv.dense_matmat(self.data, X)

    def offdiag_matvec(self, x: jax.Array) -> jax.Array:
        return self.matvec(x) - self.diag * x

    def as_dense(self) -> jax.Array:
        return self.data


# --------------------------------------------------------------------- build

def _diag_arrays(csr: CSR, n_pad: int, dtype):
    n = csr.shape[0]
    diag = np.zeros(n_pad, dtype=np.float64)
    diag[: min(csr.shape)] = csr.diagonal_vector()
    inv = np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag), 0.0)
    return jnp.asarray(diag, dtype), jnp.asarray(inv, dtype)


def choose_slot_cap(row_nnz: np.ndarray) -> int:
    """ELL slot cap minimizing a byte-count cost model: every slot moves
    its value and column index whether or not it is padding (K*n slot
    entries), and a COO-tail entry moves value, row and column plus a
    segment_sum scatter, counted as 3 slot entries.  Minimize
    K*n + 3*tail(K) over K via degree-histogram suffix sums."""
    if row_nnz.size == 0:
        return 1
    mx = int(row_nnz.max())
    if mx <= 1:
        return max(mx, 1)
    hist = np.bincount(row_nnz.astype(np.int64), minlength=mx + 1).astype(np.int64)
    d = np.arange(mx + 1, dtype=np.int64)
    # suffix sums: S1[k] = #entries' rows with deg >= k, S2[k] = sum of degs
    s1 = np.cumsum(hist[::-1])[::-1]          # S1[k] = sum_{d>=k} hist[d]
    s2 = np.cumsum((d * hist)[::-1])[::-1]    # S2[k] = sum_{d>=k} d*hist[d]
    ks = np.arange(1, mx + 1)
    # tail(K) = sum_{d>K} (d-K)*hist[d] = S2[K+1] - K*S1[K+1]
    s1p = np.append(s1, 0)[ks + 1]            # S1[k+1]
    s2p = np.append(s2, 0)[ks + 1]
    tail = s2p - ks * s1p
    cost = ks * int(row_nnz.size) + 3 * tail
    return int(ks[np.argmin(cost)])


def ell_from_csr(csr: CSR, dtype=None, slot_cap: int | None = None) -> EllOperator:
    dtype = resolve_dtype(dtype)
    n, m = csr.shape
    n_pad, m_pad = round_up(max(n, 1), LANE), round_up(max(m, 1), LANE)

    row_nnz = csr.row_nnz()
    K = slot_cap if slot_cap is not None else choose_slot_cap(row_nnz)
    K = max(int(K), 1)

    rows = csr.row_of_entry()
    pos = np.arange(csr.nnz, dtype=np.int64) - csr.indptr[rows]
    in_ell = pos < K

    values = np.zeros((K, n_pad), dtype=np.float64)
    cols = np.zeros((K, n_pad), dtype=np.int32)
    values[pos[in_ell], rows[in_ell]] = csr.data[in_ell]
    cols[pos[in_ell], rows[in_ell]] = csr.indices[in_ell]

    t_rows = rows[~in_ell].astype(np.int32)  # CSR order => sorted by row
    t_cols = csr.indices[~in_ell].astype(np.int32)
    t_vals = csr.data[~in_ell]

    diag, inv_diag = _diag_arrays(csr, n_pad, dtype)
    return EllOperator(
        jnp.asarray(values, dtype),
        jnp.asarray(cols),
        jnp.asarray(t_vals, dtype),
        jnp.asarray(t_rows),
        jnp.asarray(t_cols),
        diag,
        inv_diag,
        shape=(n, m),
        n_pad=n_pad,
        m_pad=m_pad,
    )


def dense_from_csr(csr: CSR, dtype=None) -> DenseOperator:
    dtype = resolve_dtype(dtype)
    n, m = csr.shape
    n_pad, m_pad = round_up(max(n, 1), LANE), round_up(max(m, 1), LANE)
    data = np.zeros((n_pad, m_pad), dtype=np.float64)
    data[:n, :m] = csr.to_dense()
    diag, inv_diag = _diag_arrays(csr, n_pad, dtype)
    return DenseOperator(
        jnp.asarray(data, dtype), diag, inv_diag, shape=(n, m), n_pad=n_pad, m_pad=m_pad
    )


def pad_vector(v, n_pad: int, dtype=None) -> jax.Array:
    dtype = resolve_dtype(dtype)
    v = np.asarray(v, dtype=np.float64).reshape(-1)
    out = np.zeros(n_pad, dtype=np.float64)
    out[: v.size] = v
    return jnp.asarray(out, dtype)
