"""Unified benchmark runner across the framework's domains.

Parity: /root/reference/scripts/performance/unified_benchmark.py
(BenchmarkResult dataclass :22-40, cross-domain runner) and the per-domain
harnesses (pagerank, linear systems, flow).  Timing is steady-state: one
warmup call compiles, then the median of `reps` timed calls.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass
class BenchmarkResult:
    name: str
    domain: str
    n: int
    nnz: int
    wall_ms: float
    iterations: int
    residual: float
    converged: bool
    extra: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _timed(fn: Callable, reps: int = 3):
    fn()  # warmup/compile
    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def bench_linear_system(n: int = 1000, density: float = 0.001, method: str = "neumann",
                        epsilon: float = 1e-6, reps: int = 3, seed: int = 7) -> BenchmarkResult:
    import sublinear_tpu as slt

    A = slt.generate("random-sparse", n, seed=seed, density=density)
    b = slt.rhs(n, seed=seed)
    result, ms = _timed(lambda: slt.solve(A, b, method=method, epsilon=epsilon, raise_on_fail=False), reps)
    return BenchmarkResult(
        name=f"solve-{method}-n{n}", domain="linear_systems", n=n, nnz=A.nnz,
        wall_ms=ms, iterations=result.iterations, residual=result.residual,
        converged=result.converged, extra={"density": density, "method": result.method},
    )


def bench_pagerank(n: int = 1000, p: float = 0.01, reps: int = 3, seed: int = 3) -> BenchmarkResult:
    import sublinear_tpu as slt
    from sublinear_tpu.graph import pagerank

    rng = np.random.default_rng(seed)
    count = rng.binomial(n * n, p)
    rows = rng.integers(0, n, count)
    cols = rng.integers(0, n, count)
    A = slt.Matrix.from_coo(rows, cols, np.ones(count), (n, n))
    result, ms = _timed(lambda: pagerank(A, epsilon=1e-8), reps)
    return BenchmarkResult(
        name=f"pagerank-n{n}", domain="pagerank", n=n, nnz=A.nnz,
        wall_ms=ms, iterations=result.iterations, residual=result.residual,
        converged=result.converged, extra={"edgeProb": p},
    )


def bench_entry_estimation(n: int = 1000, entries: int = 64, reps: int = 3, seed: int = 5) -> BenchmarkResult:
    import sublinear_tpu as slt
    from sublinear_tpu.queries import estimate_entries

    A = slt.Matrix(slt.generate("random-sparse", n, seed=seed, density=0.005).csr.add_diagonal(2.0))
    b = slt.rhs(n, seed=seed)
    rows = np.linspace(0, n - 1, entries).astype(int)
    opts = slt.SolverOptions(num_walks=256, seed=seed)
    est, ms = _timed(lambda: estimate_entries(A, b, rows, options=opts), reps)
    return BenchmarkResult(
        name=f"estimate-{entries}entries-n{n}", domain="queries", n=n, nnz=A.nnz,
        wall_ms=ms, iterations=entries, residual=0.0, converged=True,
        extra={"entries": entries, "walksPerEntry": 256},
    )


def bench_batch_solve(n: int = 1000, nrhs: int = 16, reps: int = 3, seed: int = 9) -> BenchmarkResult:
    import sublinear_tpu as slt
    from sublinear_tpu.parallel.sharded import solve_batch

    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, nrhs))
    opts = slt.SolverOptions(epsilon=1e-6)
    results, ms = _timed(lambda: solve_batch(A, B, opts), reps)
    return BenchmarkResult(
        name=f"batch{nrhs}-n{n}", domain="batch", n=n, nnz=A.nnz, wall_ms=ms,
        iterations=results[0].iterations, residual=max(r.residual for r in results),
        converged=all(r.converged for r in results), extra={"nrhs": nrhs},
    )


# Published peak device-memory bandwidth, bytes/s, keyed by
# ``jax.Device.device_kind`` (NVIDIA H200 data sheet, SXM part).  A device that
# is not listed gets no roofline share: no peak is assumed for it.
PEAK_BYTES_PER_S = {
    "NVIDIA H200": 4.8e12,
}


def peak_bytes_per_s(device_kind: str):
    """Peak memory bandwidth of ``device_kind``, or None when unknown."""
    return PEAK_BYTES_PER_S.get(device_kind)


def ell_spmv_bytes(op, nnz: int) -> int:
    """Bytes one ELL SpMV must move, computed from shapes: every stored slot
    streams its f32 value and i32 column (padding included), every real
    entry gathers one 32-byte sector of x, and y is written once; COO-tail
    entries add value, row and column."""
    k, n_pad = op.values.shape
    return 8 * k * n_pad + 32 * nnz + 4 * n_pad + 12 * op.tail_nnz


def bench_spmv(n: int = 100_000, nnz_per_row: int = 100, reps: int = 5, seed: int = 11) -> BenchmarkResult:
    """ELL SpMV throughput in nnz/s and its share of the device's memory
    roofline (``ell_spmv_bytes`` over ``PEAK_BYTES_PER_S``).  Measured as K
    back-to-back matvecs inside one jitted scan (no dispatch overhead),
    input varied per rep."""
    import jax
    import jax.numpy as jnp

    import sublinear_tpu as slt

    density = nnz_per_row / n
    A = slt.generate("random-sparse", n, seed=seed, density=density)
    A._prefer = "ell"
    op = A.op()
    x = A.pad_vector(slt.rhs(n, seed=seed))
    K = 32

    # Timing protocol: operator passed as a jit ARGUMENT (not baked into
    # the executable as constants); synchronization via a host fetch of a
    # dependent scalar; cost derived from the DIFFERENCE of two chain
    # lengths so dispatch and transfer overheads cancel.
    import functools

    @functools.partial(jax.jit, static_argnames=("steps",))
    def many(op, x, steps):
        def body(carry, _):
            y = op.matvec(carry)
            # renormalize to keep values finite across the chain
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30), None
        out, _ = jax.lax.scan(body, x, None, length=steps)
        return jnp.sum(out[0])

    walls = {}
    for steps in (K // 4, K):
        float(many(op, x, steps))  # compile + warm
        ts = []
        for rep in range(reps):
            xv = x * (1.0 + 0.01 * (rep + 1))
            t0 = time.perf_counter()
            float(many(op, xv, steps))
            ts.append(time.perf_counter() - t0)
        walls[steps] = min(ts)
    per_matvec = max((walls[K] - walls[K // 4]) / (K - K // 4), 1e-9)
    nnz = A.nnz
    bytes_per_s = ell_spmv_bytes(op, nnz) / per_matvec
    device = jax.devices()[0]
    peak = peak_bytes_per_s(device.device_kind)
    return BenchmarkResult(
        name=f"spmv-n{n}", domain="kernels", n=n, nnz=nnz,
        wall_ms=per_matvec * 1e3, iterations=K, residual=0.0, converged=True,
        extra={
            "nnzPerSecond": nnz / per_matvec,
            "bandwidthGBs": bytes_per_s / 1e9,
            "rooflineShare": None if peak is None else bytes_per_s / peak,
            "deviceKind": device.device_kind,
            "slotCount": op.slot_count,
            "tailNnz": op.tail_nnz,
        },
    )


def bench_solve_scaling_reference_sizes(reps: int = 3) -> list:
    """The reference's headline size ladder (README.md:357-361):
    1k / 10k / 100k sparse DD solves."""
    out = []
    for n, density in ((1000, 0.001), (10_000, 0.001), (100_000, 0.0001)):
        out.append(bench_linear_system(n=n, density=density, method="neumann", reps=reps))
    return out


def run_all(sizes=(1000,), reps: int = 3) -> list:
    out = []
    for n in sizes:
        out.append(bench_linear_system(n=n, reps=reps))
        out.append(bench_pagerank(n=min(n, 2000), reps=reps))
        out.append(bench_entry_estimation(n=min(n, 2000), reps=reps))
        out.append(bench_batch_solve(n=min(n, 2000), reps=reps))
    return out


def scaling_study(sizes=(100, 300, 1000, 3000), method: str = "conjugate-gradient") -> dict:
    """Timing-vs-n with a complexity fit (complexity_validator.py parity)."""
    from .utils.complexity import fit_power_law

    results = [bench_linear_system(n=n, method=method) for n in sizes]
    fit = fit_power_law([r.n for r in results], [max(r.wall_ms, 1e-3) for r in results])
    return {
        "results": [r.to_dict() for r in results],
        "fit": dataclasses.asdict(fit),
    }




# ------------------------------------------------------------ accuracy

def accuracy_validation(sizes=(50, 100, 200), methods=("neumann", "conjugate-gradient", "jacobi", "bicgstab"), seed: int = 0) -> list:
    """Solution accuracy vs the NumPy dense oracle across the matrix catalog
    (reference: scripts/performance/accuracy_validator.py — per size/kind/
    method residual + forward error with pass/fail at tolerance)."""
    import numpy as np

    from .generate import CATALOG_KINDS, catalog_matrix, rhs
    from .solvers.dispatch import solve
    from .types import SolverOptions

    out = []
    for kind in CATALOG_KINDS:
        for n in sizes:
            A = catalog_matrix(kind, n, seed=seed)
            b = rhs(n, seed=seed)
            try:
                x_ref = np.linalg.solve(A.to_dense(), b)
            except np.linalg.LinAlgError:
                continue
            nb = float(np.linalg.norm(b))
            for method in methods:
                try:
                    r = solve(A, b, SolverOptions(epsilon=1e-6), method=method,
                              raise_on_fail=False)
                    res = float(np.linalg.norm(A.csr.matvec(r.solution) - b))
                    refined = False
                    if not (r.converged and res <= 1.5e-6 * nb):
                        # ill-conditioned f32 floor: mixed-precision
                        # refinement is the library's documented path to
                        # f64-grade residuals (solvers/refine.py)
                        from .solvers.refine import solve_refined

                        r2 = solve_refined(A, b, SolverOptions(epsilon=1e-6),
                                           method=method, raise_on_fail=False)
                        res2 = float(np.linalg.norm(A.csr.matvec(r2.solution) - b))
                        if res2 < res:
                            r, res, refined = r2, res2, True
                    fwd = float(np.linalg.norm(r.solution - x_ref) /
                                max(np.linalg.norm(x_ref), 1e-30))
                    # pass = the solve contract (1e-6 relative residual);
                    # forwardError is informational — it scales with the
                    # condition number and is NOT what the solver promises
                    out.append({
                        "kind": kind, "n": n, "method": method,
                        "converged": bool(r.converged),
                        "residual": res,
                        "relativeResidual": res / max(nb, 1e-30),
                        "forwardError": fwd,
                        "iterations": r.iterations,
                        "refined": refined,
                        # the residual here is recomputed exactly on host;
                        # it IS the contract (converged flags of inner
                        # refinement steps measure inner thresholds)
                        "passed": bool(res <= 1.5e-6 * nb),
                    })
                except Exception as e:
                    # method preconditions (e.g. E001 non-DD for Neumann) are
                    # "not applicable", not accuracy failures
                    skipped = type(e).__name__ == "NotDiagonallyDominantError"
                    out.append({"kind": kind, "n": n, "method": method,
                                "converged": False, "error": type(e).__name__,
                                "skipped": skipped, "passed": False})
    return out


# ------------------------------------------------------------ dashboard

def dashboard(full: bool = False) -> dict:
    """Unified performance report: timing benchmarks, complexity fits,
    accuracy validation and memory profiles in one JSON document
    (reference: scripts/performance/performance_dashboard.py +
    unified_benchmark.py aggregation)."""
    import time as _time

    import jax

    from .utils.memory_profiler import memory_sweep

    t0 = _time.perf_counter()
    sizes = (1000,) if not full else (500, 1000, 2000)
    timing = [r.to_dict() for r in run_all(sizes=sizes)]
    acc_sizes = (50, 100) if not full else (50, 100, 200)
    accuracy = accuracy_validation(sizes=acc_sizes)
    memory = memory_sweep(sizes=(200, 500) if not full else (200, 500, 1000))
    comp = scaling_study(sizes=(100, 300, 1000) if not full else (100, 300, 1000, 3000))
    applicable = [a for a in accuracy if not a.get("skipped")]
    n_pass = sum(1 for a in applicable if a.get("passed"))
    report = {
        "generated": _time.strftime("%Y-%m-%dT%H:%M:%S"),
        "backend": jax.default_backend(),
        "deviceCount": jax.device_count(),
        "timing": timing,
        "accuracy": {
            "results": accuracy,
            "passed": n_pass,
            "total": len(applicable),
            "skipped": len(accuracy) - len(applicable),
            "passRate": n_pass / max(len(applicable), 1),
        },
        "memory": memory,
        "complexity": comp,
        "wallSeconds": _time.perf_counter() - t0,
    }
    return report


def print_dashboard(report: dict):
    """Human-readable text rendering of the dashboard JSON."""
    print(f"== sublinear_tpu performance dashboard ({report['backend']}, "
          f"{report['deviceCount']} device(s)) ==")
    print("-- timing --")
    for r in report["timing"]:
        print(f"  {r['name']:<28} {r['wall_ms']:.3f} ms  converged={r['converged']}")
    a = report["accuracy"]
    print(f"-- accuracy -- {a['passed']}/{a['total']} passed "
          f"({100*a['passRate']:.1f}%)")
    for row in a["results"]:
        if not row.get("passed") and not row.get("skipped"):
            print(f"  FAIL {row['kind']} n={row['n']} {row['method']}: "
                  f"{row.get('error', row.get('relativeResidual'))}")
    print("-- memory --")
    for m in report["memory"]:
        print(f"  {m['operation']:<28} n={m['n']:<7} device peak "
              f"{m['device_peak_bytes']/1e6:.1f} MB  delta "
              f"{m['device_delta_bytes']/1e6:+.1f} MB  host peak {m['host_peak_mb']:.1f} MB")
    fit = report["complexity"]["fit"]
    print(f"-- complexity -- fitted exponent {fit.get('exponent', '?')}")
    print(f"(wall {report['wallSeconds']:.0f}s)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="sublinear_tpu benchmark corpus")
    ap.add_argument("--full", action="store_true",
                    help="full unified report (timing+accuracy+memory+complexity)")
    ap.add_argument("--dashboard", action="store_true",
                    help="quick unified report")
    ap.add_argument("--json", action="store_true", help="emit JSON instead of text")
    args = ap.parse_args()
    if args.full or args.dashboard:
        report = dashboard(full=args.full)
        if args.json:
            print(json.dumps(report))
        else:
            print_dashboard(report)
    else:
        for r in run_all():
            print(json.dumps(r.to_dict()))
