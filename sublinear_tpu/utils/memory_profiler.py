"""Device + host memory profiling per solve.

Reference parity: /root/reference/scripts/performance/memory_profiler.py
(psutil/tracemalloc host snapshots around each operation).  Device re-design:
the numbers that matter live on the chip — ``device.memory_stats()``
(bytes_in_use / peak_bytes_in_use) captured around the operation, plus host
tracemalloc for the packing side.
"""
from __future__ import annotations

import dataclasses
import gc
import tracemalloc
from contextlib import contextmanager
from typing import Any, Callable, Optional


@dataclasses.dataclass
class MemoryProfile:
    operation: str
    n: int = 0
    nnz: int = 0
    device_bytes_before: int = 0
    device_bytes_after: int = 0
    device_peak_bytes: int = 0
    device_delta_bytes: int = 0
    host_peak_mb: float = 0.0
    backend: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _device_stats() -> tuple:
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        return int(stats.get("bytes_in_use", 0)), int(stats.get("peak_bytes_in_use", 0))
    except Exception:
        return 0, 0


@contextmanager
def profile_memory(operation: str, n: int = 0, nnz: int = 0):
    """Context manager yielding a MemoryProfile filled on exit."""
    import jax

    gc.collect()
    tracing = tracemalloc.is_tracing()
    if not tracing:
        tracemalloc.start()
    tracemalloc.reset_peak()
    before, _ = _device_stats()
    prof = MemoryProfile(operation=operation, n=n, nnz=nnz,
                         device_bytes_before=before,
                         backend=jax.default_backend())
    try:
        yield prof
    finally:
        after, peak = _device_stats()
        _, host_peak = tracemalloc.get_traced_memory()
        if not tracing:
            tracemalloc.stop()
        prof.device_bytes_after = after
        prof.device_peak_bytes = peak
        prof.device_delta_bytes = after - before
        prof.host_peak_mb = host_peak / 1e6


def profile_solve(matrix, b, options=None, method: str = "auto") -> MemoryProfile:
    """Profile one solve end-to-end (operator build + iteration)."""
    from ..solvers.dispatch import solve
    from ..types import SolverOptions

    options = options or SolverOptions()
    with profile_memory(f"solve[{method}]", n=matrix.shape[0], nnz=matrix.nnz) as prof:
        r = solve(matrix, b, options, method=None if method == "auto" else method,
                  raise_on_fail=False)
        prof.operation = f"solve[{r.method}]"
    return prof


def memory_sweep(sizes=(200, 500, 1000), density: float = 0.02, seed: int = 0) -> list:
    """Catalog sweep mirroring the reference profiler's per-size loop."""
    import numpy as np

    from .. import generate, rhs

    out = []
    for n in sizes:
        A = generate("random-sparse", n, seed=seed, density=density)
        b = rhs(n, seed=seed)
        out.append(profile_solve(A, b).to_dict())
    return out
