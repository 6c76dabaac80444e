"""Format layer: CSR construction, ELL packing, device matvec vs NumPy oracle.

Mirrors the reference's matrix unit tests
(/root/reference/src/matrix/mod.rs:574-628, sparse.rs:906+): construction,
duplicate handling, transpose, diagonal extraction, matvec parity.
"""
import numpy as np
import pytest

import sublinear_tpu as slt
from sublinear_tpu.formats.csr import CSR
from sublinear_tpu.formats import ell as ell_mod


def test_csr_from_coo_and_dense_roundtrip():
    dense = np.array([[4.0, -1.0, 0.0], [0.0, 3.0, -2.0], [-1.0, 0.0, 5.0]])
    csr = CSR.from_dense(dense)
    assert csr.nnz == 6
    np.testing.assert_allclose(csr.to_dense(), dense)
    m = slt.Matrix.from_dense(dense)
    np.testing.assert_allclose(m.diagonal_vector(), [4.0, 3.0, 5.0])


def test_coo_duplicates_are_summed():
    csr = CSR.from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 1.0], (2, 2))
    assert csr.nnz == 2
    np.testing.assert_allclose(csr.to_dense(), [[0.0, 5.0], [1.0, 0.0]])


def test_csr_matvec_matches_dense():
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(17, 13)) * (rng.random((17, 13)) < 0.3)
    csr = CSR.from_dense(dense)
    x = rng.normal(size=13)
    np.testing.assert_allclose(csr.matvec(x), dense @ x, rtol=1e-12)


def test_transpose():
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(9, 11)) * (rng.random((9, 11)) < 0.4)
    csr = CSR.from_dense(dense)
    np.testing.assert_allclose(csr.transpose().to_dense(), dense.T)


@pytest.mark.parametrize("n,density", [(50, 0.2), (200, 0.02), (64, 0.9)])
def test_ell_matvec_matches_oracle(n, density):
    A = slt.generate("random-sparse", n, seed=3, density=density)
    x = slt.rhs(n, seed=5)
    oracle = A.to_dense() @ x

    op = ell_mod.ell_from_csr(A.csr)
    x_pad = ell_mod.pad_vector(x, op.m_pad, op.dtype)
    y = np.asarray(op.matvec(x_pad))[:n]
    np.testing.assert_allclose(y, oracle, rtol=2e-5, atol=1e-4)


def test_ell_hub_rows_go_to_tail():
    # one hub row with 80 nnz, everyone else 2 — slot cap must stay small
    n = 100
    rows = [0] * 80 + list(range(1, n))
    cols = list(range(1, 81)) + [0] * (n - 1)
    vals = [0.1] * 80 + [0.2] * (n - 1)
    d = list(range(n))
    A = slt.Matrix.from_coo(rows + d, cols + d, vals + [10.0] * n, (n, n))
    op = ell_mod.ell_from_csr(A.csr)
    assert op.slot_count < 40
    assert op.tail_nnz > 0
    x = np.ones(n)
    x_pad = ell_mod.pad_vector(x, op.m_pad, op.dtype)
    np.testing.assert_allclose(
        np.asarray(op.matvec(x_pad))[:n], A.to_dense() @ x, rtol=1e-5, atol=1e-5
    )


def test_dense_operator_matches():
    A = slt.generate("diagonally-dominant", 30, seed=2)
    x = slt.rhs(30, seed=1)
    op = ell_mod.dense_from_csr(A.csr)
    x_pad = ell_mod.pad_vector(x, op.m_pad, op.dtype)
    np.testing.assert_allclose(
        np.asarray(op.matvec(x_pad))[:30], A.to_dense() @ x, rtol=2e-5, atol=1e-4
    )


def test_matmat_batched_rhs():
    A = slt.generate("random-sparse", 40, seed=9, density=0.15)
    X = np.random.default_rng(4).normal(size=(40, 7))
    op = ell_mod.ell_from_csr(A.csr)
    X_pad = np.zeros((op.m_pad, 7))
    X_pad[:40] = X
    import jax.numpy as jnp

    Y = np.asarray(op.matmat(jnp.asarray(X_pad, op.dtype)))[:40]
    np.testing.assert_allclose(Y, A.to_dense() @ X, rtol=2e-5, atol=1e-4)


def test_from_dict_reference_formats():
    d_coo = {
        "rows": 2,
        "cols": 2,
        "values": [4.0, 1.0, 3.0],
        "rowIndices": [0, 0, 1],
        "colIndices": [0, 1, 1],
        "format": "coo",
    }
    m = slt.Matrix.from_dict(d_coo)
    np.testing.assert_allclose(m.to_dense(), [[4.0, 1.0], [0.0, 3.0]])
    d_dense = {"rows": 2, "cols": 2, "data": [[4.0, 1.0], [0.0, 3.0]], "format": "dense"}
    m2 = slt.Matrix.from_dict(d_dense)
    np.testing.assert_allclose(m2.to_dense(), m.to_dense())
    # round trip
    m3 = slt.Matrix.from_dict(m.to_dict())
    np.testing.assert_allclose(m3.to_dense(), m.to_dense())


def test_padding_is_lane_aligned():
    A = slt.generate("tridiagonal", 100)
    op = A.op()
    assert op.n_pad % 128 == 0


def test_one_by_one_matrix():
    A = slt.Matrix.from_dense(np.array([[4.0]]))
    r = slt.solve(A, [8.0], method="neumann")
    assert abs(r.solution[0] - 2.0) < 1e-5


def test_rectangular_solve_rejected():
    A = slt.Matrix.from_coo([0, 1], [0, 1], [1.0, 1.0], (3, 2))
    with pytest.raises(slt.InvalidMatrixError):
        slt.solve(A, [1.0, 1.0, 1.0])


def test_empty_coo_matrix():
    A = slt.Matrix.from_coo([], [], [], (4, 4))
    assert A.nnz == 0
    a = slt.analyze(A)
    assert not a.is_diagonally_dominant  # zero diagonal


def test_nan_rhs_detected():
    A = slt.generate("tridiagonal", 8)
    b = np.ones(8)
    b[3] = np.nan
    r = slt.solve(A, b, method="conjugate-gradient", raise_on_fail=False)
    assert not r.converged


def test_duplicate_and_unsorted_triplets():
    # unsorted + duplicated COO input is normalized
    A = slt.Matrix.from_coo([1, 0, 1, 0], [0, 1, 0, 0], [1.0, 2.0, 3.0, 5.0], (2, 2))
    np.testing.assert_allclose(A.to_dense(), [[5.0, 2.0], [4.0, 0.0]])


# ------------------------------------------------------------------- DIA
def test_dia_eligibility():
    from sublinear_tpu.formats.dia import dia_offsets

    tri = slt.generate("tridiagonal", 64)
    offs = dia_offsets(tri.csr)
    assert offs is not None and set(offs) == {-1, 0, 1}
    rnd = slt.generate("random-sparse", 512, seed=1, density=0.05)
    assert dia_offsets(rnd.csr) is None  # too many distinct offsets


def test_dia_matvec_matches_csr_oracle():
    import jax.numpy as jnp

    from sublinear_tpu.formats.dia import dia_from_csr

    from sublinear_tpu.generate import catalog_matrix

    for name, n in [("tridiagonal", 100), ("banded", 130), ("laplacian_1d", 96)]:
        A = catalog_matrix(name, n, seed=2)
        op = dia_from_csr(A.csr)
        x = slt.rhs(n, seed=3)
        xp = A.pad_vector(x)
        y = np.asarray(op.matvec(xp))[:n]
        np.testing.assert_allclose(y, A.csr.matvec(x), rtol=1e-5, atol=1e-6)
        # offdiag + matmat
        yo = np.asarray(op.offdiag_matvec(xp))[:n]
        D = A.csr.diagonal_vector()
        np.testing.assert_allclose(yo, A.csr.matvec(x) - D * x, rtol=1e-5, atol=1e-6)
        X = np.stack([x, -x, 2 * x], axis=1)
        Xp = np.zeros((op.n_pad, 3)); Xp[:n] = X
        Y = np.asarray(op.matmat(jnp.asarray(Xp, op.dtype)))[:n]
        np.testing.assert_allclose(Y, A.csr.to_dense() @ X, rtol=1e-5, atol=1e-5)


def test_dia_autoselected_and_solves():
    from sublinear_tpu.formats.dia import DiaOperator

    A = slt.Matrix(slt.generate("tridiagonal", 300).csr.add_diagonal(0.5))
    assert isinstance(A.op(), DiaOperator)
    b = slt.rhs(300, seed=4)
    for method in ["neumann", "conjugate-gradient", "jacobi"]:
        r = slt.solve(A, b, method=method, epsilon=1e-6)
        assert r.converged, method
        rel = np.linalg.norm(A.csr.matvec(r.solution) - b) / np.linalg.norm(b)
        assert rel < 1e-5, (method, rel)


def test_dia_asymmetric_offsets():
    # strictly upper bidiagonal + diag: offsets {0, 3}
    n = 40
    rows = list(range(n)) + list(range(n - 3))
    cols = list(range(n)) + [i + 3 for i in range(n - 3)]
    vals = [4.0] * n + [-1.0] * (n - 3)
    A = slt.Matrix.from_coo(rows, cols, vals, (n, n))
    from sublinear_tpu.formats.dia import DiaOperator

    op = A.op()
    assert isinstance(op, DiaOperator) and op.offsets == (0, 3)
    x = slt.rhs(n, seed=5)
    y = np.asarray(op.matvec(A.pad_vector(x)))[:n]
    np.testing.assert_allclose(y, A.csr.matvec(x), rtol=1e-5, atol=1e-6)
