"""The XLA operator paths every solve runs on: ELL (gather + FMA, COO tail
for hub rows), dense and DIA, the choice among them, and the solvers over
them — each checked against a float64 NumPy oracle.

The structured matrices (random, banded, 2-D stencil, hub column, hub row,
rectangular) are the sparsity patterns the sparse paths must get right.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import sublinear_tpu as slt
from sublinear_tpu.errors import InvalidParametersError
from sublinear_tpu.formats import ell as ell_mod
from sublinear_tpu.matrix import Matrix
from sublinear_tpu.parallel.sharded import solve_batch


def _random_coo(n, deg, seed=0, m=None):
    m = m or n
    rng = np.random.default_rng(seed)
    cnt = n * deg
    r = rng.integers(0, n, cnt)
    c = rng.integers(0, m, cnt)
    v = rng.uniform(-1, 1, cnt)
    _, ui = np.unique(r.astype(np.int64) * m + c, return_index=True)
    return r[ui], c[ui], v[ui]


def _with_dd_diagonal(rows, cols, vals, n, strength=1.5):
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    diag = np.zeros(n)
    np.add.at(diag, rows, np.abs(vals))
    d = np.arange(n)
    return np.r_[rows, d], np.r_[cols, d], np.r_[vals, diag * strength + 1.0]


def _structured(kind, n, deg):
    """(rows, cols, vals, n) for one sparsity pattern; DD by construction."""
    rng = np.random.default_rng(n + deg)
    if kind == "random":
        rows, cols, vals = _random_coo(n, deg, seed=n)
    elif kind == "banded":
        rows, cols, vals = [], [], []
        for off in range(1, deg + 1):
            idx = np.arange(n - off)
            w = rng.uniform(-1, 1, n - off)
            rows += [idx, idx + off]
            cols += [idx + off, idx]
            vals += [w, w]
        rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    elif kind == "stencil2d":
        side = int(np.sqrt(n))
        n = side * side
        idx = np.arange(n).reshape(side, side)
        rows, cols, vals = [], [], []
        for dr, dc in ((0, 1), (1, 0)):
            a = idx[:side - dr, :side - dc].ravel()
            b = idx[dr:, dc:].ravel()
            rows += [a, b]
            cols += [b, a]
            vals += [np.full(len(a), -1.0)] * 2
        rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    elif kind == "hubcol":  # one column with n entries + random background
        rows, cols, vals = _random_coo(n, deg, seed=n)
        rows = np.r_[rows, np.arange(n)]
        cols = np.r_[cols, np.zeros(n, np.int64)]
        vals = np.r_[vals, np.full(n, 0.01)]
    elif kind == "hubrow":  # one row with n/2 entries + random background
        rows, cols, vals = _random_coo(n, deg, seed=n)
        hub = np.arange(1, n // 2)
        rows = np.r_[rows, np.full(hub.size, 3)]
        cols = np.r_[cols, hub]
        vals = np.r_[vals, np.full(hub.size, 0.01)]
    else:
        raise ValueError(kind)
    rows, cols, vals = _with_dd_diagonal(np.asarray(rows), np.asarray(cols),
                                         np.asarray(vals), n)
    return rows, cols, vals, n


def _dense(rows, cols, vals, shape):
    D = np.zeros(shape)
    np.add.at(D, (rows, cols), vals)
    return D


def _apply(op, x, n_out):
    x_pad = ell_mod.pad_vector(x, op.m_pad, op.dtype)
    return np.asarray(op.matvec(x_pad), np.float64)[:n_out]


PATTERNS = [
    ("random", 300, 4), ("random", 1100, 7), ("random", 3000, 11),
    ("banded", 900, 3), ("stencil2d", 1024, 0), ("hubcol", 700, 5),
]


# ---------------------------------------------------------------- products

@pytest.mark.parametrize("case", PATTERNS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_ell_matvec_structured_matches_oracle(case):
    rows, cols, vals, n = _structured(*case)
    op = ell_mod.ell_from_csr(Matrix.from_coo(rows, cols, vals, (n, n)).csr)
    x = np.random.default_rng(1).standard_normal(n)
    y_ref = _dense(rows, cols, vals, (n, n)) @ x
    scale = max(1.0, np.abs(y_ref).max())
    np.testing.assert_allclose(_apply(op, x, n), y_ref, rtol=3e-5, atol=3e-5 * scale)


@pytest.mark.parametrize("case", PATTERNS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_ell_rmatvec_structured_matches_oracle(case):
    """A^T x through the transpose operator (the adjoint push and the
    PageRank transition use it)."""
    rows, cols, vals, n = _structured(*case)
    A = Matrix.from_coo(rows, cols, vals, (n, n), prefer="ell")
    opT = A.op(transpose=True)
    assert isinstance(opT, ell_mod.EllOperator)
    x = np.random.default_rng(2).standard_normal(n)
    y_ref = _dense(rows, cols, vals, (n, n)).T @ x
    scale = max(1.0, np.abs(y_ref).max())
    np.testing.assert_allclose(_apply(opT, x, n), y_ref, rtol=3e-5, atol=3e-5 * scale)


@pytest.mark.parametrize("n,m", [(300, 900), (900, 300)])
def test_ell_rectangular_matvec_and_transpose(n, m):
    rows, cols, vals = _random_coo(n, 5, seed=3, m=m)
    A = Matrix.from_coo(rows, cols, vals, (n, m), prefer="ell")
    D = _dense(rows, cols, vals, (n, m))
    rng = np.random.default_rng(4)
    x, z = rng.standard_normal(m), rng.standard_normal(n)
    np.testing.assert_allclose(_apply(A.op(), x, n), D @ x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_apply(A.op(transpose=True), z, m), D.T @ z,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["hubrow", "hubcol"])
def test_ell_hub_patterns_use_tail_correctly(kind):
    rows, cols, vals, n = _structured(kind, 800, 4)
    op = ell_mod.ell_from_csr(Matrix.from_coo(rows, cols, vals, (n, n)).csr)
    if kind == "hubrow":
        assert op.tail_nnz > 0 and op.slot_count < 40  # hub overflow -> COO tail
    x = np.random.default_rng(5).standard_normal(n)
    y_ref = _dense(rows, cols, vals, (n, n)) @ x
    np.testing.assert_allclose(_apply(op, x, n), y_ref, rtol=3e-5,
                               atol=3e-5 * max(1.0, np.abs(y_ref).max()))


@pytest.mark.parametrize("layout", ["n-major", "batch-major"])
def test_ell_spmm_hub_rows_matches_oracle(layout):
    rows, cols, vals, n = _structured("hubrow", 600, 5)
    op = ell_mod.ell_from_csr(Matrix.from_coo(rows, cols, vals, (n, n)).csr)
    assert op.tail_nnz > 0
    X = np.random.default_rng(6).standard_normal((n, 9))
    X_pad = np.zeros((op.m_pad, 9))
    X_pad[:n] = X
    Xd = jnp.asarray(X_pad, op.dtype)
    if layout == "n-major":
        Y = np.asarray(op.matmat(Xd))[:n]
    else:
        Y = np.asarray(op.matmat_bmajor(Xd.T)).T[:n]
    Y_ref = _dense(rows, cols, vals, (n, n)) @ X
    np.testing.assert_allclose(Y, Y_ref, rtol=3e-5, atol=3e-5 * np.abs(Y_ref).max())


# ----------------------------------------------------------------- routing

@pytest.mark.parametrize("case,kind", [
    (("random", 5000, 6), "ell"),
    (("random", 300, 4), "dense"),
    (("banded", 5000, 3), "dia"),
    (("hubcol", 4500, 5), "ell"),
])
def test_op_kind_by_structure(case, kind):
    rows, cols, vals, n = _structured(*case)
    A = Matrix.from_coo(rows, cols, vals, (n, n))
    assert A._op_kind() == kind
    # single- and multi-RHS products share the operator
    assert type(A.op()).__name__.lower().startswith(kind)


@pytest.mark.parametrize("call", ["prefer", "cg-sharded", "neumann-sharded"])
def test_removed_crossbar_options_rejected(call):
    from sublinear_tpu.parallel.mesh import make_mesh
    from sublinear_tpu.parallel.sharded import solve_cg_sharded, solve_neumann_sharded

    rows, cols, vals, n = _structured("random", 300, 4)
    b = np.ones(n)
    with pytest.raises(InvalidParametersError) as e:
        if call == "prefer":
            Matrix.from_coo(rows, cols, vals, (n, n), prefer="xbar")
        else:
            A = Matrix.from_coo(rows, cols, vals, (n, n))
            import jax

            mesh = make_mesh(jax.devices()[:2])
            fn = solve_cg_sharded if call == "cg-sharded" else solve_neumann_sharded
            fn(A, b, mesh=mesh, mode="explicit-xbar")
    assert e.value.code == "E008"


# ------------------------------------------------------------------ solves

@pytest.mark.parametrize("case,method", [
    (("random", 5000, 6), "neumann"),
    (("hubcol", 4500, 5), "neumann"),
    (("hubrow", 4200, 5), "bicgstab"),
    (("stencil2d", 4096, 0), "cg"),
])
def test_solve_large_sparse_matches_oracle(case, method):
    rows, cols, vals, n = _structured(*case)
    A = Matrix.from_coo(rows, cols, vals, (n, n))
    assert n >= 4096 and A._op_kind() in ("ell", "dia")
    b = np.random.default_rng(7).standard_normal(n)
    r = slt.solve(A, b, method=method, epsilon=1e-6)
    assert r.converged
    rel = np.linalg.norm(A.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("method", ["neumann", "cg"])
@pytest.mark.parametrize("prefer", ["dense", "ell"])
def test_check_every_1_vs_8(method, prefer):
    """Checking convergence every iteration or every 8 reaches the same
    solution; Neumann overshoots by less than one check block, CG checks
    every iteration whatever check_every says."""
    rows, cols, vals, n = _structured("random", 500, 5)
    sym = method == "cg"
    if sym:
        rows, cols, vals = np.r_[rows, cols], np.r_[cols, rows], np.r_[vals, vals]
    A = Matrix.from_coo(rows, cols, vals, (n, n), prefer=prefer)
    b = np.random.default_rng(8).standard_normal(n)
    r1 = slt.solve(A, b, method=method, epsilon=1e-6, check_every=1)
    r8 = slt.solve(A, b, method=method, epsilon=1e-6, check_every=8)
    assert r1.converged and r8.converged
    np.testing.assert_allclose(r8.solution, r1.solution, rtol=1e-4, atol=1e-5)
    if method == "neumann":
        assert r1.iterations <= r8.iterations < r1.iterations + 8
    else:
        assert r1.iterations == r8.iterations


# ----------------------------------------- dense XLA path at n_pad 768, 1536

def _dense_system(n, seed):
    A = slt.generate("random-sparse", n, seed=seed, density=0.05)
    A = Matrix(A.csr, prefer="dense")
    b = slt.rhs(n, seed=seed)
    return A, b, np.linalg.solve(A.to_dense(), b)


DENSE_N = [(700, 768), (1500, 1536)]


@pytest.mark.parametrize("n,n_pad", DENSE_N)
def test_dense_neumann_matches_oracle(n, n_pad):
    A, b, x_ref = _dense_system(n, seed=0)
    assert A.op().n_pad == n_pad
    r = slt.solve(A, b, method="neumann", epsilon=1e-6)
    assert r.converged
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,n_pad", DENSE_N)
def test_dense_neumann_warm_restart(n, n_pad):
    A, b, x_ref = _dense_system(n, seed=3)
    part = slt.solve(A, b, method="neumann", epsilon=1e-6, max_iterations=3,
                     check_every=1, raise_on_fail=False)
    assert not part.converged
    r = slt.solve(A, b, method="neumann", epsilon=1e-6, x0=part.solution)
    assert r.converged
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,n_pad", DENSE_N)
def test_dense_jacobi_matches_oracle(n, n_pad):
    A, b, x_ref = _dense_system(n, seed=1)
    r = slt.solve(A, b, method="jacobi", epsilon=1e-6)
    assert r.converged
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,n_pad", DENSE_N)
def test_dense_batched_rhs_matches_oracle(n, n_pad):
    A, _, _ = _dense_system(n, seed=2)
    B = np.random.default_rng(0).normal(size=(n, 4))
    results = solve_batch(A, B, slt.SolverOptions(epsilon=1e-6), method="neumann")
    X_ref = np.linalg.solve(A.to_dense(), B)
    for j, r in enumerate(results):
        assert r.converged
        np.testing.assert_allclose(r.solution, X_ref[:, j], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,n_pad", DENSE_N)
def test_dense_pagerank_matches_power_iteration(n, n_pad):
    from sublinear_tpu.graph.pagerank import _transition_matrix, pagerank

    rng = np.random.default_rng(4)
    dense = (rng.random((n, n)) < 0.3).astype(float)
    np.fill_diagonal(dense, 0.0)
    dense[5] = 0.0  # one dangling node
    G = Matrix.from_dense(dense)
    assert _transition_matrix(G)._op_kind() == "dense"
    out = dense.sum(axis=1)
    P = dense / np.where(out > 0, out, 1.0)[:, None]
    v = np.full(n, 1.0 / n)
    x = v.copy()
    for _ in range(200):
        x = 0.15 * v + 0.85 * (P.T @ x + x[out == 0].sum() * v)
    res = pagerank(G, epsilon=1e-9)
    assert res.converged
    np.testing.assert_allclose(res.scores, x, rtol=1e-4, atol=1e-8)
    assert abs(res.scores.sum() - 1.0) < 1e-6


# ------------------------------------------------------------ small batches

@pytest.mark.parametrize("nrhs", [1, 3, 20])
def test_solve_batch_small_batches(nrhs):
    """Few RHS run through the batched Neumann driver itself, one column
    per RHS, each held to its own tolerance."""
    rows, cols, vals, n = _structured("random", 600, 5)
    A = Matrix.from_coo(rows, cols, vals, (n, n), prefer="ell")
    B = np.random.default_rng(21).standard_normal((n, nrhs))
    res = solve_batch(A, B, slt.SolverOptions(epsilon=1e-6), method="neumann")
    assert len(res) == nrhs and all(r.converged for r in res)
    assert all(r.method == "neumann-batch" for r in res)
    for j, r in enumerate(res):
        rel = np.linalg.norm(A.csr.matvec(r.solution) - B[:, j]) / np.linalg.norm(B[:, j])
        assert rel < 5e-6, (j, rel)
