"""Public host-side Matrix wrapper.

One class replaces the reference's triplicated matrix stacks (Rust
SparseMatrix /root/reference/src/matrix/mod.rs:123-373, TS
MatrixOperations /root/reference/src/core/matrix.ts, JS FastCSRMatrix
/root/reference/js/fast-solver.js): host CSR for construction/analysis plus
lazily-built device operators (ELL or dense, see formats/ell.py) that the
jitted solvers consume.  The device-operator choice is a static decision made
host-side so every jitted program sees fixed shapes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .config import DENSE_THRESHOLD
from .errors import DimensionMismatchError, InvalidMatrixError
from .formats.csr import CSR
from .formats import ell as _ell


import itertools

_UID = itertools.count()

# device operator kinds a caller may force with ``prefer`` (None = automatic)
OPERATOR_KINDS = (None, "dense", "ell", "dia")


class Matrix:
    """Square-or-rectangular sparse/dense matrix with device-operator cache."""

    def __init__(self, csr: CSR, prefer: Optional[str] = None):
        if prefer not in OPERATOR_KINDS:
            from .errors import InvalidParametersError

            raise InvalidParametersError(
                f"unknown operator kind {prefer!r}; expected one of "
                f"{[k for k in OPERATOR_KINDS if k]} or None",
                {"prefer": prefer},
            )
        self.csr = csr
        self._prefer = prefer
        self._ops: dict = {}
        self._dia_offsets: Optional[tuple] = ()  # () = unprobed, None = ineligible
        self._dom_gap: Optional[float] = None
        self._transpose_csr: Optional[CSR] = None
        # serving layers share Matrix objects across threads
        import threading

        self._lock = threading.Lock()
        # process-unique id for external caches (id() is reused after GC)
        self.uid = next(_UID)

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_coo(cls, rows, cols, vals, shape, **kw) -> "Matrix":
        return cls(CSR.from_coo(rows, cols, vals, shape), **kw)

    @classmethod
    def from_dense(cls, data, **kw) -> "Matrix":
        return cls(CSR.from_dense(data), **kw)

    @classmethod
    def from_csr_arrays(cls, indptr, indices, data, shape, **kw) -> "Matrix":
        return cls(CSR(indptr, indices, data, shape), **kw)

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "Matrix":
        """Parse the reference's JSON matrix format
        (/root/reference/src/core/types.ts:6-23): COO triplets
        {rows, cols, values, rowIndices, colIndices, format:'coo'} or dense
        {rows, cols, data, format:'dense'}."""
        if not isinstance(d, dict):
            raise InvalidMatrixError("matrix must be an object")
        fmt = d.get("format", "dense" if "data" in d else "coo")
        rows, cols = d.get("rows"), d.get("cols")
        if fmt == "dense":
            data = np.asarray(d["data"], dtype=np.float64)
            if rows is not None and data.shape != (rows, cols):
                raise DimensionMismatchError(
                    f"dense data shape {data.shape} != declared ({rows}, {cols})"
                )
            return cls.from_dense(data, **kw)
        if fmt in ("coo", "csr", "csc"):
            if rows is None or cols is None:
                raise InvalidMatrixError("sparse matrix requires rows/cols fields")
            ri = d.get("rowIndices", d.get("row_indices"))
            ci = d.get("colIndices", d.get("col_indices"))
            vals = d.get("values")
            if ri is None or ci is None or vals is None:
                raise InvalidMatrixError("sparse matrix requires values/rowIndices/colIndices")
            return cls.from_coo(ri, ci, vals, (rows, cols), **kw)
        raise InvalidMatrixError(f"unknown matrix format: {fmt}")

    @classmethod
    def identity(cls, n: int, **kw) -> "Matrix":
        return cls(CSR.identity(n), **kw)

    @classmethod
    def diagonal(cls, d, **kw) -> "Matrix":
        return cls(CSR.diagonal(d), **kw)

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    @property
    def density(self) -> float:
        n, m = self.shape
        return self.nnz / max(n * m, 1)

    def is_square(self) -> bool:
        return self.shape[0] == self.shape[1]

    # ------------------------------------------------------------ device ops
    def _use_dense(self) -> bool:
        n, m = self.shape
        if max(n, m) <= DENSE_THRESHOLD:
            return True
        # moderately sized but dense enough that ELL would be dense anyway
        return max(n, m) <= 4 * DENSE_THRESHOLD and self.density > 0.25

    def _dia_eligible(self):
        """Distinct-offset tuple when A is exactly diagonal-representable
        (banded/tridiagonal/Laplacian), else None.  Probed once."""
        if self._dia_offsets == ():
            from .formats.dia import dia_offsets

            offs = dia_offsets(self.csr)
            self._dia_offsets = None if offs is None else tuple(int(o) for o in offs)
        return self._dia_offsets

    def _op_kind(self) -> str:
        """Operator kind for this matrix; single- and multi-RHS products
        share it (every operator kind has both)."""
        if self._prefer is not None:
            return self._prefer
        # DIA beats both dense and gather paths whenever it applies: the
        # matvec is D shifted streaming multiply-adds with zero gathers.
        if self._dia_eligible() is not None:
            return "dia"
        return "dense" if self._use_dense() else "ell"

    def op(self, dtype=None, transpose: bool = False):
        """Device operator (cached per (dtype, transpose, kind))."""
        from .config import resolve_dtype

        dt = resolve_dtype(dtype)
        kind = self._op_kind()
        key = (str(dt), bool(transpose), kind)
        if key not in self._ops:
            with self._lock:
                if key not in self._ops:
                    csr = self.T_csr() if transpose else self.csr
                    # memory guard: estimate device bytes BEFORE packing and
                    # raise E007 instead of OOMing (reference taxonomy; the
                    # streaming path in formats/streaming.py has no ceiling)
                    from .formats.streaming import check_memory_budget

                    check_memory_budget(csr, kind)
                    if kind == "dia":
                        from .formats.dia import dia_from_csr

                        self._ops[key] = dia_from_csr(csr, dt)
                    elif kind == "dense":
                        self._ops[key] = _ell.dense_from_csr(csr, dt)
                    else:
                        self._ops[key] = _ell.ell_from_csr(csr, dt)
        return self._ops[key]

    def reorder_rcm(self):
        """Bandwidth-reducing symmetric permutation (reverse Cuthill-McKee,
        host-side C++ with NumPy fallback).

        Returns ``(B, perm)`` where ``B = P A P^T`` (``B[i, j] =
        A[perm[i], perm[j]]``).  To solve ``A x = b``: solve
        ``B y = b[perm]`` then ``x[perm] = y``.  Pairs with the DIA
        operator: RCM often shrinks a mesh/graph matrix's bandwidth enough
        that the zero-gather diagonal path applies (ARCHITECTURE.md
        "gather wall", escape #2)."""
        if not self.is_square():
            from .errors import InvalidMatrixError

            raise InvalidMatrixError("RCM reordering requires a square matrix")
        from .native import rcm_ordering

        csr, t = self.csr, self.T_csr()
        n = csr.shape[0]
        perm = rcm_ordering(csr.indptr, csr.indices, t.indptr, t.indices, n)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        rows, cols, vals = csr.to_coo()
        return Matrix.from_coo(inv[rows], inv[cols], vals, self.shape), perm

    def T_csr(self) -> CSR:
        if self._transpose_csr is None:
            t = self.csr.transpose()
            self._transpose_csr = t
        return self._transpose_csr

    def pad_vector(self, v, dtype=None, transpose: bool = False):
        """Pad a row-space vector (e.g. the RHS b) to the operator's padded
        row dimension.  With ``transpose=True`` pads to the transpose
        operator's row space (i.e. this matrix's column space)."""
        op = self.op(dtype, transpose=transpose)
        n = self.shape[1] if transpose else self.shape[0]
        v = np.asarray(v, dtype=np.float64).reshape(-1)
        if v.size != n:
            raise DimensionMismatchError(f"vector length {v.size} != matrix dim {n}")
        return _ell.pad_vector(v, op.n_pad, op.dtype)

    # ------------------------------------------------------------ host ops
    def matvec(self, x) -> np.ndarray:
        return self.csr.matvec(x)

    def to_dense(self) -> np.ndarray:
        return self.csr.to_dense()

    def to_dict(self, fmt: str = "coo") -> dict:
        n, m = self.shape
        if fmt == "dense":
            return {"rows": n, "cols": m, "data": self.to_dense().tolist(), "format": "dense"}
        r, c, v = self.csr.to_coo()
        return {
            "rows": n,
            "cols": m,
            "values": v.tolist(),
            "rowIndices": r.tolist(),
            "colIndices": c.tolist(),
            "format": "coo",
        }

    def transpose(self) -> "Matrix":
        return Matrix(self.T_csr(), prefer=self._prefer)

    def diagonal_vector(self) -> np.ndarray:
        return self.csr.diagonal_vector()

    def dominance_gap(self) -> float:
        """alpha = min_i (|a_ii| - sum_{j!=i} |a_ij|); > 0 iff strictly row
        diagonally dominant.  1/alpha bounds ||A^-1||_inf (Varah), used for
        the deterministic ErrorBounds on solve results."""
        if self._dom_gap is None:
            n, m = self.shape
            if n != m or n == 0:
                self._dom_gap = 0.0
            else:
                d = np.abs(self.csr.diagonal_vector())
                off = self.csr.offdiag_abs_row_sums()
                self._dom_gap = float(np.min(d - off))
        return self._dom_gap
