"""Structured per-solve observability records.

Parity: ``SolverStats``/``ProfileData`` (/root/reference/src/types.rs:88-251),
``PerformanceMonitor`` (/root/reference/src/core/utils.ts:173-218), the
bandwidth/ops counters (/root/reference/src/matrix/optimized.rs:373-394), in
the device-native form SURVEY.md §5.5 prescribes:
{method, n, nnz, iters, residual, wall, nnz/s, chips}.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional


@dataclasses.dataclass
class SolveRecord:
    method: str
    n: int
    nnz: int
    iterations: int
    residual: float
    converged: bool
    wall_ms: float
    nnz_per_second: float
    matvec_count: int
    backend: str
    chips: int
    timestamp: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def record_solve(matrix, result, matvec_count: Optional[int] = None) -> SolveRecord:
    import jax

    mv = matvec_count if matvec_count is not None else max(result.iterations, 1)
    secs = max(result.compute_time_ms / 1e3, 1e-12)
    return SolveRecord(
        method=result.method,
        n=matrix.shape[0],
        nnz=matrix.nnz,
        iterations=result.iterations,
        residual=result.residual,
        converged=result.converged,
        wall_ms=result.compute_time_ms,
        nnz_per_second=matrix.nnz * mv / secs,
        matvec_count=mv,
        backend=jax.default_backend(),
        chips=jax.device_count(),
        timestamp=time.time(),
    )


def memory_info() -> dict:
    """Device/host memory report (reference: MemoryInfo, src/types.rs:213+).
    Per-device stats come from the backend when available."""
    import jax

    devices = []
    for d in jax.devices():
        stats = {}
        try:
            s = d.memory_stats() or {}
            stats = {
                "bytesInUse": s.get("bytes_in_use"),
                "bytesLimit": s.get("bytes_limit"),
                "peakBytesInUse": s.get("peak_bytes_in_use"),
            }
        except Exception:
            pass
        devices.append({"id": d.id, "platform": d.platform, **stats})
    try:
        import resource

        host_rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:
        host_rss_kb = None
    return {"devices": devices, "hostPeakRssKb": host_rss_kb}


class device_trace:
    """JAX profiler trace context (SURVEY.md §5.1 device equivalent of the
    reference's ProfileData): writes a TensorBoard-compatible trace.

        with device_trace("/tmp/slt-trace"):
            slt.solve(A, b)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        import jax

        jax.profiler.start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        import jax

        jax.profiler.stop_trace()
        return False


class ProfileLog:
    """Append-only JSONL log of SolveRecords (observability sink)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: list[SolveRecord] = []

    def add(self, matrix, result, matvec_count: Optional[int] = None) -> SolveRecord:
        rec = record_solve(matrix, result, matvec_count)
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(rec.to_json() + "\n")
        return rec
