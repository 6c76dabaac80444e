"""DIA (diagonal-storage) operator — the zero-gather SpMV path.

For banded matrices (tridiagonal, banded, 1-D Laplacians — half the
reference's test-matrix catalog, scripts/linear_systems/test_matrices/ and
matrix.ts:146-417 generators) every nonzero lies on one of a few diagonals.
Storing A as (D, n_pad) diagonal vectors turns SpMV into D shifted
multiply-adds:

    y[i] = sum_d data[d, i] * x[i + offset_d]

where each shift is a STATIC slice of a zero-padded x — no gather at all.
Each diagonal is read once and x is read as D contiguous shifted slices,
so the matvec streams at memory bandwidth with no index traffic: it moves
4 B per stored diagonal entry against ELL's 8 B per slot plus a gathered
sector of x.

Selection is automatic (Matrix.op): a square matrix whose nonzeros occupy at
most MAX_DIAGS distinct offsets gets a DiaOperator.  Matrices that are
*almost* banded can first be permuted with utils/reorder.rcm_ordering to
shrink their bandwidth.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..config import resolve_dtype, round_up, LANE
from .csr import CSR

# An exact DIA representation must cover every distinct offset.  128
# diagonals of length n cost 128n elements of streaming work — still far
# cheaper than gather for any matrix with >= n/3 nonzeros, and a natural
# lane-width cap.
MAX_DIAGS = 128


def dia_offsets(csr: CSR) -> np.ndarray | None:
    """Distinct nonzero offsets (col - row), or None if the matrix is not
    *usefully* diagonal-representable: square, at most MAX_DIAGS offsets,
    and genuinely banded (D small relative to n and diagonals reasonably
    full) — a small random matrix technically fits in <=128 diagonals but
    each is nearly empty, which wastes D*n work and loses the accumulation-
    order stability of the dense path."""
    n = csr.shape[0]
    if n != csr.shape[1] or csr.nnz == 0:
        return None
    rows = csr.row_of_entry()
    offs = csr.indices.astype(np.int64) - rows.astype(np.int64)
    uniq = np.unique(offs)
    D = uniq.size
    if D > min(MAX_DIAGS, max(n // 4, 3)):
        return None
    if csr.nnz < 0.25 * D * n:  # diagonals must be reasonably full
        return None
    return uniq


@jax.tree_util.register_pytree_node_class
class DiaOperator:
    """Shifted-diagonal operator over the padded domain."""

    def __init__(self, data, diag, inv_diag, *, offsets, shape, n_pad, m_pad, source_nnz=None):
        self.data = data          # (D, n_pad); data[d, i] = A[i, i + offsets[d]]
        self.diag = diag          # (n_pad,)
        self.inv_diag = inv_diag  # (n_pad,)
        self.offsets = offsets    # static tuple of python ints, sorted
        self.shape = shape
        self.n_pad = n_pad
        self.m_pad = m_pad
        # true nonzero count of the source matrix (padded diagonal storage
        # holds D * n_pad slots, which is not a work/stats estimate)
        self.source_nnz = source_nnz

    # pytree protocol ------------------------------------------------------
    def tree_flatten(self):
        return (self.data, self.diag, self.inv_diag), (self.offsets, self.shape, self.n_pad, self.m_pad, self.source_nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        offsets, shape, n_pad, m_pad, source_nnz = aux
        data, diag, inv_diag = children
        return cls(data, diag, inv_diag, offsets=offsets, shape=shape,
                   n_pad=n_pad, m_pad=m_pad, source_nnz=source_nnz)

    # properties -----------------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        if self.source_nnz is not None:
            return int(self.source_nnz)
        return int(self.data.shape[0] * self.data.shape[1])

    # products -------------------------------------------------------------
    def _pad_width(self):
        lo = max(-min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        return lo, hi

    def matvec(self, x: jax.Array) -> jax.Array:
        lo, hi = self._pad_width()
        xp = jnp.pad(x, (lo, hi))
        y = jnp.zeros(self.n_pad, self.dtype)
        for d, off in enumerate(self.offsets):  # static unroll, D <= 128
            seg = lax.dynamic_slice_in_dim(xp, lo + off, self.n_pad)
            y = y + self.data[d] * seg
        return y

    def matmat(self, X: jax.Array) -> jax.Array:
        lo, hi = self._pad_width()
        Xp = jnp.pad(X, ((lo, hi), (0, 0)))
        Y = jnp.zeros((self.n_pad, X.shape[1]), self.dtype)
        for d, off in enumerate(self.offsets):
            seg = lax.dynamic_slice_in_dim(Xp, lo + off, self.n_pad, axis=0)
            Y = Y + self.data[d][:, None] * seg
        return Y

    def offdiag_matvec(self, x: jax.Array) -> jax.Array:
        """(A - D) @ x — the Neumann-series iteration product."""
        return self.matvec(x) - self.diag * x

    def as_dense(self) -> jax.Array:
        out = jnp.zeros((self.n_pad, self.m_pad), self.dtype)
        i = jnp.arange(self.n_pad)
        for d, off in enumerate(self.offsets):
            j = i + off
            ok = (j >= 0) & (j < self.m_pad)
            out = out.at[i, jnp.clip(j, 0, self.m_pad - 1)].add(
                jnp.where(ok, self.data[d], 0.0)
            )
        return out


def dia_from_csr(csr: CSR, dtype=None, offsets: np.ndarray | None = None) -> DiaOperator:
    """Build a DiaOperator; raises ValueError when the matrix is not
    diagonal-representable (use dia_offsets to test first)."""
    from .ell import _diag_arrays

    dt = resolve_dtype(dtype)
    if offsets is None:
        offsets = dia_offsets(csr)
    if offsets is None:
        raise ValueError("matrix is not representable with <= MAX_DIAGS diagonals")
    n = csr.shape[0]
    n_pad = round_up(max(n, 1), LANE)

    rows = csr.row_of_entry().astype(np.int64)
    offs = csr.indices.astype(np.int64) - rows
    slot = np.searchsorted(offsets, offs)
    data = np.zeros((len(offsets), n_pad))
    data[slot, rows] = csr.data  # CSR has unique (row, col) entries

    diag, inv_diag = _diag_arrays(csr, n_pad, dt)
    return DiaOperator(
        jnp.asarray(data, dt), diag, inv_diag,
        offsets=tuple(int(o) for o in offsets),
        shape=csr.shape, n_pad=n_pad, m_pad=n_pad, source_nnz=csr.nnz,
    )
