#!/usr/bin/env python3
"""Run the solver service's main path on an NVIDIA GPU and check every answer.

    python chip_smoke.py          # one GPU: phases 0-6
    python chip_smoke.py --four   # four GPUs of one host: sharded path only

One process drives the card(s); every answer is checked in host float64
against a plain reference (``HostOperator``: a bincount SpMV over the
matrix's own triplets, and a NumPy power iteration for PageRank).

  0. JAX must find a GPU, else exit 2 before any other work.  Prints the
     card's name and power limit as nvidia-smi gives them, the JAX/jaxlib
     versions and the compile-cache directory.
  1. ``slt.solve`` at n=1,000 with 30% dense off-diagonals (dense
     operator), at n=100,000 with density
     1e-4 (~1.1M nnz; ``neumann``, and ``cg`` on a symmetric DD system) and
     at n=1,000,000 (~11M nnz; ``neumann``).  Prints the operator kind,
     iterations and warm wall time of each.
  2. ``solve_batch`` with 100,000 rows x 128 RHS, every column checked.
  3. The functional query t^T A^-1 b at n=100,000 against t^T x of the
     checked solve.
  4. PageRank on a 100,000-node random graph against a host power iteration.
  5. The MCP JSON-RPC handler (initialize, tools/list, tools/call solve at
     n=10,000) and the HTTP server on a thread at port 0 (POST
     /api/v1/solve), both answers checked.
  6. Card-only measurements, each printed with the card's name and power
     limit: the double-float device residual against host f64; ELL SpMV
     with the narrow gather against the 8-wide row-gather container the
     library no longer uses, with its share of the bandwidth roofline; the
     dense/ELL crossover; dense Neumann time per iteration.

``--four``: ``solve_cg_sharded(mode="explicit")`` and
``solve_neumann_sharded`` on a (4, 1) mesh for a symmetric DD system of
4,000,000 rows (1,000,000 per card), each checked against host f64 and
against the one-card ``slt.solve`` of the same system, and the explicit
CG's all-gathers counted in its compiled HLO (one per iteration).

Tolerances.  Device storage and arithmetic are f32 with every product at
``Precision.HIGHEST`` (true f32, no TF32):
  * a solve at epsilon=1e-6 passes when its host f64 relative residual is
    <= 1e-5 (f32 rounding of the iterate costs up to ~1e-6 on top of the
    device's own 1e-6 criterion);
  * the functional query passes when |q - t^T x| <= 1e-5 |t^T x|;
  * PageRank passes when ||x - x_ref||_1 <= 1e-6 and |sum(x) - 1| <= 1e-6
    (the scores are a probability vector, so L1 is the relative error);
  * sharded and one-card solutions agree to 1e-4 relative (each is within
    1e-6 relative residual; the systems' condition number is below ~10);
  * iteration counts: GPU sums run in another order than the CPU's, so a
    residual may cross its threshold one check later or sooner.  Neumann
    counts may differ from the CPU's by one check block (check_every=5
    iterations), CG counts by 2.  ``CPU_ITERATIONS`` holds the CPU counts.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed check raises: the process exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np

EPS = 1e-6
RES_TOL = 1e-5
SEED = 7
# iteration counts of the same seeded solves on the CPU backend
CPU_ITERATIONS = {
    "neumann n=1000": 5,
    "neumann n=100000": 10,
    "cg n=100000": 9,
}
ITERATION_SLACK = {"neumann": 5, "cg": 2}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- references

class HostOperator:
    """Plain float64 reference SpMV from the matrix's own triplets."""

    def __init__(self, A):
        csr = A.csr
        self.n = csr.shape[0]
        self.rows = np.repeat(np.arange(self.n), np.diff(csr.indptr))
        self.cols = csr.indices.astype(np.int64)
        self.vals = csr.data

    def matvec(self, x):
        return np.bincount(self.rows, weights=self.vals * x[self.cols],
                           minlength=self.n)

    def rel_residual(self, x, b) -> float:
        return float(np.linalg.norm(self.matvec(x) - b) / np.linalg.norm(b))


def symmetric_dd(n: int, per_row: int, seed: int):
    """Symmetric strictly diagonally dominant system (SPD): random
    off-diagonals in (-1, 1), ~per_row per row, diag = 1.5 * |row| + 1."""
    import sublinear_tpu as slt

    rng = np.random.default_rng(seed)
    m = n * per_row // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.uniform(-1.0, 1.0, r.size)
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    off = np.concatenate([v, v])
    diag = 1.5 * np.bincount(rows, weights=np.abs(off), minlength=n) + 1.0
    d = np.arange(n)
    return slt.Matrix.from_coo(np.concatenate([rows, d]), np.concatenate([cols, d]),
                               np.concatenate([off, diag]), (n, n))


def host_pagerank(A, damping: float, tol: float = 1e-15, max_iter: int = 2000):
    """float64 power iteration x <- (1-a) v + a (P^T x + dangling mass v)."""
    csr = A.csr
    n = csr.shape[0]
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    cols = csr.indices.astype(np.int64)
    out_deg = np.bincount(rows, weights=csr.data, minlength=n)
    dangling = out_deg == 0
    w = csr.data / np.where(out_deg > 0, out_deg, 1.0)[rows]
    v = np.full(n, 1.0 / n)
    x = v.copy()
    for _ in range(max_iter):
        y = (1 - damping) * v + damping * (
            np.bincount(cols, weights=w * x[rows], minlength=n) + x[dangling].sum() * v)
        if np.abs(y - x).sum() < tol:
            return y
        x = y
    raise AssertionError("host PageRank reference did not converge")


# ------------------------------------------------------------------ helpers

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def warm_call(fn):
    """(result, warm wall ms): one call to compile, one timed call."""
    fn()
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def solve_checked(label, A, b, method, expect_kind, host=None):
    import sublinear_tpu as slt

    kind = A._op_kind()
    check(kind == expect_kind, f"{label}: operator kind {kind}, expected {expect_kind}")
    r, ms = warm_call(lambda: slt.solve(A, b, method=method, epsilon=EPS))
    host = host or HostOperator(A)
    rel = host.rel_residual(r.solution, b)
    log(f"phase1 {label}: kind={kind} nnz={A.nnz} method={r.method} "
        f"iterations={r.iterations} warm_ms={ms:.3f} host_rel_residual={rel:.3e}")
    check(r.converged, f"{label}: not converged (residual {r.residual})")
    check(rel <= RES_TOL, f"{label}: host f64 relative residual {rel} > {RES_TOL}")
    expect = CPU_ITERATIONS.get(label)
    if expect is not None:
        slack = ITERATION_SLACK[method]
        check(abs(r.iterations - expect) <= slack,
              f"{label}: {r.iterations} iterations, CPU takes {expect} (slack {slack})")
    return r


def per_step_ms(step, op, x0, lo=20, hi=120, reps=5) -> float:
    """Device time of one ``step(op, x)`` from a host-clock slope: jitted
    fori_loops of ``lo`` and ``hi`` steps, each ended by block_until_ready;
    (t_hi - t_lo) / (hi - lo) cancels dispatch and transfer."""
    import jax

    def timed(k):
        f = jax.jit(lambda op, x: jax.lax.fori_loop(0, k, lambda i, v: step(op, v), x))
        jax.block_until_ready(f(op, x0))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(op, x0))
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(hi) - timed(lo)) / (hi - lo) * 1e3


# ------------------------------------------------------------------- phases

def phase_library(n_small=1_000, n_mid=100_000, n_big=1_000_000):
    import sublinear_tpu as slt

    # 30% dense off-diagonals: the dense operator's regime
    A = slt.generate("diagonally-dominant", n_small, seed=SEED)
    solve_checked(f"neumann n={n_small}", A, slt.rhs(n_small, seed=SEED), "neumann", "dense")

    A = slt.generate("random-sparse", n_mid, seed=SEED, density=1e-4)
    b = slt.rhs(n_mid, seed=SEED)
    host = HostOperator(A)
    solve_checked(f"neumann n={n_mid}", A, b, "neumann", "ell", host)

    S = symmetric_dd(n_mid, 10, seed=SEED + 1)
    solve_checked(f"cg n={n_mid}", S, slt.rhs(n_mid, seed=SEED + 1), "cg", "ell")

    big = slt.generate("random-sparse", n_big, seed=SEED, density=10.0 / n_big)
    solve_checked(f"neumann n={n_big}", big, slt.rhs(n_big, seed=SEED), "neumann", "ell")
    return A, host


def phase_batch(A, host, nrhs=128):
    import sublinear_tpu as slt
    from sublinear_tpu.parallel.sharded import solve_batch

    n = A.shape[0]
    B = np.random.default_rng(SEED).standard_normal((n, nrhs))
    results, ms = warm_call(lambda: solve_batch(A, B, slt.SolverOptions(epsilon=EPS)))
    check(len(results) == nrhs, f"batch: {len(results)} results for {nrhs} RHS")
    worst = 0.0
    for j, r in enumerate(results):
        rel = host.rel_residual(r.solution, B[:, j])
        worst = max(worst, rel)
        check(r.converged, f"batch column {j}: not converged ({r.residual})")
        check(rel <= RES_TOL, f"batch column {j}: host relative residual {rel}")
    log(f"phase2 solve_batch {n}x{nrhs}: method={results[0].method} "
        f"iterations={results[0].iterations} warm_ms={ms:.3f} "
        f"worst_host_rel_residual={worst:.3e}")


def phase_query(A, host):
    import sublinear_tpu as slt
    from sublinear_tpu.queries import estimate_functional

    n = A.shape[0]
    rng = np.random.default_rng(SEED + 2)
    b = rng.uniform(0.5, 1.5, n)
    t = rng.uniform(0.0, 1.0, n)
    x = slt.solve(A, b, method="neumann", epsilon=EPS).solution
    rel = host.rel_residual(x, b)
    check(rel <= RES_TOL, f"query: reference solve host residual {rel}")
    exact = float(t @ x)
    opts = slt.SolverOptions(epsilon=EPS)
    q, ms = warm_call(lambda: estimate_functional(A, b, t, opts))
    diff = abs(q["estimate"] - exact) / abs(exact)
    log(f"phase3 functional n={n}: estimate={q['estimate']:.9e} t.x={exact:.9e} "
        f"rel_diff={diff:.3e} warm_ms={ms:.3f} sweeps={q['sweeps']}")
    check(diff <= RES_TOL, f"query: functional differs from t.x by {diff}")


def phase_pagerank(n=100_000, out_degree=10):
    import sublinear_tpu as slt
    from sublinear_tpu.graph import pagerank

    rng = np.random.default_rng(SEED + 3)
    m = n * out_degree
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    G = slt.Matrix.from_coo(r[keep], c[keep], np.ones(int(keep.sum())), (n, n))
    res, ms = warm_call(lambda: pagerank(G, damping=0.85, epsilon=1e-9,
                                         max_iterations=1000))
    ref = host_pagerank(G, 0.85)
    l1 = float(np.abs(res.scores - ref).sum())
    mass = abs(float(res.scores.sum()) - 1.0)
    log(f"phase4 pagerank n={n} edges={G.nnz}: iterations={res.iterations} "
        f"converged={res.converged} warm_ms={ms:.3f} l1_vs_host={l1:.3e} "
        f"mass_error={mass:.3e}")
    check(l1 <= 1e-6, f"pagerank: L1 distance to host reference {l1}")
    check(mass <= 1e-6, f"pagerank: mass off by {mass}")


def phase_served(n=10_000):
    import urllib.request

    import sublinear_tpu as slt
    from sublinear_tpu.interfaces.http_server import make_server
    from sublinear_tpu.interfaces.mcp_server import MCPServer

    A = slt.generate("random-sparse", n, seed=SEED, density=1e-3)
    b = slt.rhs(n, seed=SEED)
    host = HostOperator(A)
    args = {"matrix": A.to_dict(), "vector": b.tolist(), "method": "neumann",
            "epsilon": EPS}

    server = MCPServer()
    init = server.handle_request({"jsonrpc": "2.0", "id": 1, "method": "initialize"})
    check("result" in init, f"mcp initialize: {init}")
    tools = server.handle_request({"jsonrpc": "2.0", "id": 2, "method": "tools/list"})
    names = {t["name"] for t in tools["result"]["tools"]}
    check("solve" in names, f"mcp tools/list lacks solve: {sorted(names)}")
    t0 = time.perf_counter()
    resp = server.handle_request({"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                                  "params": {"name": "solve", "arguments": args}})
    mcp_ms = (time.perf_counter() - t0) * 1e3
    check("result" in resp, f"mcp tools/call solve failed: {str(resp)[:500]}")
    out = json.loads(resp["result"]["content"][0]["text"])
    rel = host.rel_residual(np.asarray(out["solution"]), b)
    log(f"phase5 mcp solve n={n}: backend={out['metadata']['backend']} "
        f"iterations={out['iterations']} call_ms={mcp_ms:.1f} host_rel_residual={rel:.3e}")
    check(out["converged"] and rel <= RES_TOL, f"mcp solve: residual {rel}")

    httpd = make_server(port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1/solve"
        req = urllib.request.Request(url, data=json.dumps(args).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as f:
            out = json.loads(f.read())
        http_ms = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    rel = host.rel_residual(np.asarray(out["solution"]), b)
    log(f"phase5 http solve n={n}: iterations={out['iterations']} "
        f"request_ms={http_ms:.1f} host_rel_residual={rel:.3e}")
    check(out["converged"] and rel <= RES_TOL, f"http solve: residual {rel}")


def wide_gather_matvec(op, aux, x):
    """The 8-wide row-gather container SpMV the library replaced: x rides
    as column 0 of an (m_pad, 8) array and the gather fetches whole rows."""
    import jax
    import jax.numpy as jnp

    from sublinear_tpu.ops import spmv

    X = jnp.concatenate([x[:, None], aux], axis=1)
    w = jnp.concatenate([jnp.ones((1,), x.dtype), jnp.full((7,), 1e-30, x.dtype)])
    y = jnp.einsum("kns,s,kn->n", jnp.take(X, op.cols, axis=0), w, op.values,
                   precision=jax.lax.Precision.HIGHEST)
    if op.tail_nnz:
        y = y + spmv.coo_matvec(op.tail_vals, op.tail_rows, op.tail_cols, x, op.n_pad)
    return y


def phase_measure(card: str, spmv_sizes=(100_000, 1_000_000),
                  crossover_sizes=(256, 512, 768, 1024, 1536, 2048, 4096, 8192, 16384),
                  neumann_sizes=(768, 1536)):
    import jax
    import jax.numpy as jnp

    import sublinear_tpu as slt
    from sublinear_tpu.benchmarks import ell_spmv_bytes, peak_bytes_per_s
    from sublinear_tpu.formats import ell as ell_mod

    kind = jax.devices()[0].device_kind
    peak = peak_bytes_per_s(kind)

    def jacobi_matvec(op, x):
        return op.inv_diag * op.matvec(x)

    # ELL SpMV: narrow gather vs the 8-wide container
    for n in spmv_sizes:
        A = slt.generate("random-sparse", n, seed=SEED, density=10.0 / n)
        op = ell_mod.ell_from_csr(A.csr)
        x0 = ell_mod.pad_vector(slt.rhs(n, seed=SEED), op.m_pad, op.dtype)
        aux = jnp.asarray(np.random.default_rng(0).standard_normal((op.m_pad, 7)), op.dtype)
        narrow = per_step_ms(jacobi_matvec, op, x0)
        wide = per_step_ms(lambda oa, v: oa[0].inv_diag * wide_gather_matvec(*oa, v),
                           (op, aux), x0)
        nbytes = ell_spmv_bytes(op, A.nnz)
        share = "not in peak table" if peak is None else f"{nbytes / (narrow * 1e-3) / peak:.4f}"
        log(f"phase6 ell spmv n={n} nnz={A.nnz} K={op.slot_count} tail={op.tail_nnz}: "
            f"narrow_ms={narrow:.5f} wide_ms={wide:.5f} bytes={nbytes} "
            f"narrow_roofline_share={share} card=[{card}]")

    # dense vs ELL matvec at density 1e-3
    for n in crossover_sizes:
        A = slt.generate("random-sparse", n, seed=SEED, density=1e-3)
        x = slt.rhs(n, seed=SEED)
        times = {}
        for name, op in (("dense", ell_mod.dense_from_csr(A.csr)),
                         ("ell", ell_mod.ell_from_csr(A.csr))):
            times[name] = per_step_ms(jacobi_matvec, op,
                                      ell_mod.pad_vector(x, op.m_pad, op.dtype))
        log(f"phase6 crossover n={n} nnz={A.nnz}: dense_ms={times['dense']:.5f} "
            f"ell_ms={times['ell']:.5f} faster={min(times, key=times.get)} card=[{card}]")

    # dense Neumann iteration (the body solve_neumann runs per step)
    def neumann_step(op, st):
        x, term = st
        term = -op.inv_diag * op.offdiag_matvec(term)
        return x + term, term

    for n in neumann_sizes:
        A = slt.generate("random-sparse", n, seed=SEED, density=0.05)
        op = ell_mod.dense_from_csr(A.csr)
        t0 = op.inv_diag * ell_mod.pad_vector(slt.rhs(n, seed=SEED), op.m_pad, op.dtype)
        ms = per_step_ms(neumann_step, op, (t0, t0))
        log(f"phase6 dense neumann n_pad={op.n_pad}: per_iteration_ms={ms:.5f} card=[{card}]")

    # double-float device residual: raw kernel vs host f64, then refinement
    from sublinear_tpu.solvers.refine import _device_residual_state, solve_refined
    from sublinear_tpu.utils import doublefloat as df

    A = slt.generate("random-sparse", 512, seed=33, density=0.02)
    b = slt.rhs(512, seed=33)
    host = HostOperator(A)
    x = np.random.default_rng(1).standard_normal(512)
    vh, vl, cols, bh, bl = _device_residual_state(A, b)
    xh, xl = df.split_f64(x)
    rh, rl = df.ell_residual_df(vh, vl, cols, bh, bl, jnp.asarray(xh), jnp.asarray(xl))
    r_dev = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    kernel_err = float(np.abs(r_dev - (b - host.matvec(x))).max() / np.linalg.norm(b))
    r = solve_refined(A, b, slt.SolverOptions(epsilon=1e-12), max_refinements=6,
                      residual="device")
    rel = host.rel_residual(r.solution, b)
    reported = r.residual / np.linalg.norm(b)
    log(f"phase6 double-float residual: kernel_err={kernel_err:.3e} "
        f"refined_host_rel_residual={rel:.3e} reported={reported:.3e} "
        f"converged={r.converged} card=[{card}]")
    check(kernel_err <= 1e-11, f"double-float kernel error {kernel_err} > 1e-11")
    check(r.converged and rel <= 5e-12, f"device refinement reached {rel}")
    check(abs(reported - rel) <= 1e-10, f"device residual {reported} vs host {rel}")


def run_four(card: str, n: int = 4_000_000):
    import jax

    import sublinear_tpu as slt
    from sublinear_tpu.parallel.hlo import count_defs, while_body
    from sublinear_tpu.parallel.mesh import make_mesh
    from sublinear_tpu.parallel.sharded import (
        lower_explicit_cg_text, solve_cg_sharded, solve_neumann_sharded)

    devices = jax.devices()
    check(len(devices) == 4, f"--four needs 4 GPUs, JAX finds {len(devices)}")
    mesh = make_mesh(devices)
    check(dict(mesh.shape) == {"rows": 4, "batch": 1}, f"mesh {dict(mesh.shape)}")
    t0 = time.perf_counter()
    S = symmetric_dd(n, 10, seed=SEED + 4)
    b = slt.rhs(n, seed=SEED + 4)
    host = HostOperator(S)
    log(f"four: system n={n} nnz={S.nnz} built in {time.perf_counter() - t0:.1f}s")
    opts = slt.SolverOptions(epsilon=EPS)
    for method, sharded in (
            ("cg", lambda: solve_cg_sharded(S, b, mesh=mesh, mode="explicit", options=opts)),
            ("neumann", lambda: solve_neumann_sharded(S, b, mesh=mesh, options=opts))):
        r, ms = warm_call(sharded)
        rel = host.rel_residual(r.solution, b)
        one, one_ms = warm_call(lambda: slt.solve(S, b, method=method, epsilon=EPS))
        rel_one = host.rel_residual(one.solution, b)
        agree = float(np.linalg.norm(r.solution - one.solution) / np.linalg.norm(one.solution))
        log(f"four {method}: sharded iterations={r.iterations} warm_ms={ms:.3f} "
            f"host_rel_residual={rel:.3e} | one-card iterations={one.iterations} "
            f"warm_ms={one_ms:.3f} host_rel_residual={rel_one:.3e} | "
            f"relative_difference={agree:.3e} card=[{card}]")
        check(r.converged and rel <= RES_TOL, f"sharded {method}: residual {rel}")
        check(one.converged and rel_one <= RES_TOL, f"one-card {method}: residual {rel_one}")
        check(agree <= 1e-4, f"sharded {method} differs from one-card by {agree}")
    txt = lower_explicit_cg_text(S, b, mesh, opts)
    body = while_body(txt)
    gathers_body, gathers_all = count_defs(body, "all-gather"), count_defs(txt, "all-gather")
    log(f"four hlo: all-gathers in CG while body={gathers_body} in program={gathers_all} "
        f"all-reduces in body={count_defs(body, 'all-reduce')}")
    check(gathers_body == 1, f"explicit CG body has {gathers_body} all-gathers, expected 1")
    check(gathers_all == 2, f"explicit CG has {gathers_all} all-gathers, expected 2")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path and its comparisons")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX finds no GPU (default backend {backend!r})", file=sys.stderr)
        return 2

    import jaxlib

    card = card_line()
    log(card)
    log(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"compile cache {jax.config.jax_compilation_cache_dir}")
    devices = jax.devices()
    log(f"devices: {len(devices)} x {devices[0].device_kind}")

    t_start = time.perf_counter()
    if args.four:
        run_four(card)
    else:
        A, host = phase_library()
        phase_batch(A, host)
        phase_query(A, host)
        phase_pagerank()
        phase_served()
        phase_measure(card)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
