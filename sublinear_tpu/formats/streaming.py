"""Streaming (larger-than-HBM) matrix operation + device-memory budgeting.

Reference parity: StreamingMatrix's chunked processing
(/root/reference/src/matrix/optimized.rs:451+) and the memory-limit error
taxonomy (E007).  Device design: the matrix is packed into row-block panels
held in HOST memory as slot-major ELL arrays; a matvec streams one panel at
a time through the device (device_put -> fused gather/FMA -> fetch y-block),
so peak device residency is ONE panel + x + y regardless of total nnz.
Trade: host<->device transfer per matvec — this is the graceful-degradation
path for matrices whose packed operator exceeds the device budget, not a
fast path.

Memory policy ("documented max-n policy"):
  * every operator build estimates its device bytes (estimate_op_bytes); a
    build above ``memory_budget_bytes()`` raises MemoryLimitError (E007)
    BEFORE allocating — no silent OOM;
  * ``StreamingOperator`` has no device ceiling (panels sized to
    ``panel_budget`` bytes); host RAM is the only limit;
  * the budget is ``SLT_MEMORY_LIMIT_BYTES`` when set, else the device's
    reported bytes_limit minus a 20% headroom (on the CPU backend the
    device memory is host RAM, read from the OS).  There is no built-in
    default: a device that reports no limit raises E007.
"""
from __future__ import annotations

import os

import numpy as np

from ..errors import MemoryLimitError
from .csr import CSR


def memory_budget_bytes() -> int:
    env = os.environ.get("SLT_MEMORY_LIMIT_BYTES")
    if env:
        return int(env)
    import jax

    device = jax.local_devices()[0]
    stats = device.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"] * 0.8)
    if device.platform == "cpu":
        return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") * 0.8)
    raise MemoryLimitError(
        f"device {device.device_kind!r} reports no memory limit; set "
        f"SLT_MEMORY_LIMIT_BYTES to the bytes an operator may occupy",
        {"device": device.device_kind},
    )


def estimate_op_bytes(csr: CSR, kind: str) -> int:
    """Device bytes a packed operator of ``kind`` would occupy (upper-ish
    bound; 128-padded domains, f32 values + i32 indices)."""
    n, m = csr.shape
    n_pad = -(-max(n, 1) // 128) * 128
    m_pad = -(-max(m, 1) // 128) * 128
    vec = 2 * n_pad * 4  # diag + inv_diag
    if kind == "dense":
        return n_pad * m_pad * 4 + vec
    if kind == "dia":
        from .dia import dia_offsets

        offs = dia_offsets(csr)
        d = len(offs) if offs is not None else 1
        return d * n_pad * 4 + vec
    # ell: K slots of (vals f32 + cols i32) over n_pad
    row_nnz = csr.row_nnz()
    K = int(row_nnz.max()) if row_nnz.size else 1
    K = max(min(K, 64), 1)  # ell_from_csr caps slots and tails the rest
    return K * m_pad * 8 + vec


def check_memory_budget(csr: CSR, kind: str, budget: int | None = None) -> int:
    need = estimate_op_bytes(csr, kind)
    limit = budget if budget is not None else memory_budget_bytes()
    if need > limit:
        raise MemoryLimitError(
            f"packed '{kind}' operator needs ~{need/1e9:.2f} GB > device "
            f"budget {limit/1e9:.2f} GB; use StreamingOperator / "
            f"solve_streaming (chunked row panels) or raise "
            f"SLT_MEMORY_LIMIT_BYTES",
            {"requiredBytes": need, "budgetBytes": limit, "kind": kind},
        )
    return need


class StreamingOperator:
    """Row-panel streamed operator: host-resident ELL panels, device-streamed
    products.  API mirrors the device operators (matvec/offdiag_matvec/diag)
    but operates on host numpy vectors."""

    def __init__(self, csr: CSR, panel_budget: int = 256 * 1024 * 1024, dtype=None):
        import jax.numpy as jnp

        self.shape = csr.shape
        n, m = csr.shape
        self.m_pad = -(-max(m, 1) // 128) * 128
        self.dtype = jnp.float32 if dtype is None else jnp.dtype(dtype)
        diag = np.zeros(n)
        dv = csr.diagonal_vector()
        diag[: len(dv)] = dv
        self.diag = diag
        self.inv_diag = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)

        row_nnz = csr.row_nnz()
        K = max(int(row_nnz.max()) if row_nnz.size else 1, 1)
        # panel rows sized so one panel's ELL (vals+cols, 8 B/slot) fits the
        # panel budget
        rows_per_panel = max(128, int(panel_budget // max(K * 8, 1)) // 128 * 128)
        self.panels = []
        indptr, indices, data = csr.indptr, csr.indices, csr.data
        for r0 in range(0, n, rows_per_panel):
            r1 = min(r0 + rows_per_panel, n)
            rows = r1 - r0
            rows_pad = -(-rows // 128) * 128
            pK = int((indptr[r0 + 1 : r1 + 1] - indptr[r0:r1]).max()) if rows else 1
            pK = max(pK, 1)
            vals = np.zeros((pK, rows_pad), dtype=np.float32)
            cols = np.zeros((pK, rows_pad), dtype=np.int32)
            for i in range(rows):
                lo, hi = indptr[r0 + i], indptr[r0 + i + 1]
                cnt = hi - lo
                vals[:cnt, i] = data[lo:hi]
                cols[:cnt, i] = indices[lo:hi]
            self.panels.append((r0, rows, vals, cols))

    @property
    def n_panels(self) -> int:
        return len(self.panels)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x streaming one panel at a time through the device."""
        import jax
        import jax.numpy as jnp

        from ..ops import spmv

        n, m = self.shape
        x_pad = np.zeros(self.m_pad, dtype=np.float32)
        x_pad[:m] = np.asarray(x, dtype=np.float64)[:m]
        x_dev = jnp.asarray(x_pad)
        y = np.zeros(n, dtype=np.float64)
        for r0, rows, vals, cols in self.panels:
            yb = spmv.ell_matvec(jnp.asarray(vals), jnp.asarray(cols), x_dev)
            y[r0 : r0 + rows] = np.asarray(jax.device_get(yb), dtype=np.float64)[:rows]
        return y

    def offdiag_matvec(self, x: np.ndarray) -> np.ndarray:
        return self.matvec(x) - self.diag * np.asarray(x, dtype=np.float64)[: self.shape[0]]


def solve_streaming(matrix, b, options=None, raise_on_fail: bool = True):
    """Host-driven Neumann solve over a StreamingOperator — converges for DD
    systems of any size that fits host RAM (the reference's StreamingMatrix
    use case, optimized.rs:451+)."""
    import time as _time

    from ..types import SolverOptions, SolverResult
    from ..solvers import base

    options = options or SolverOptions()
    op = StreamingOperator(matrix.csr, dtype=options.dtype)
    b64 = np.asarray(b, dtype=np.float64)
    threshold = base.threshold_for(b64, options)
    t0 = _time.perf_counter()
    term = op.inv_diag * b64
    x = term.copy()
    res = float("inf")
    k = 0
    check = max(options.check_every, 1)
    while k < options.max_iterations:
        for _ in range(check):
            term = -op.inv_diag * (op.matvec(term) - op.diag * term)
            x = x + term
            k += 1
        res = float(np.linalg.norm(op.matvec(x) - b64))
        if not np.isfinite(res) or res <= threshold:
            break
    result = SolverResult(
        solution=x, iterations=k, residual=res,
        converged=bool(np.isfinite(res) and res <= threshold * 1.0000001),
        method="neumann-streaming",
        compute_time_ms=(_time.perf_counter() - t0) * 1e3,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail)
