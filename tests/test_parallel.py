"""Distributed solver tests on the 8-device virtual CPU mesh.

The reference has no multi-node tests (SURVEY.md §4: "Multi-node testing:
none") — these tests are this build's addition: row-partitioned CG via
GSPMD placement and via explicit shard_map collectives, plus batched RHS
sharded over the batch axis.
"""
import numpy as np
import pytest

import jax

import sublinear_tpu as slt
from conftest import make_dd_system
from sublinear_tpu.parallel.mesh import make_mesh
from sublinear_tpu.parallel.sharded import solve_batch, solve_cg_sharded


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(jax.devices()[:8])


def spd_system(n=300, seed=0):
    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    b = slt.rhs(n, seed=seed)
    x_ref = np.linalg.solve(A.to_dense(), b)
    return A, b, x_ref


def test_mesh_axes(mesh8):
    # the default mesh puts every device on the row axis
    assert mesh8.shape == {"rows": 8, "batch": 1}


@pytest.mark.parametrize("mode", ["auto", "explicit"])
def test_sharded_cg_matches_oracle(mesh8, mode):
    A, b, x_ref = spd_system()
    r = solve_cg_sharded(A, b, mesh=mesh8, mode=mode,
                         options=slt.SolverOptions(epsilon=1e-8))
    assert r.converged, f"residual {r.residual}"
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-3, atol=1e-4)


def test_sharded_matches_single_device():
    A, b, x_ref = spd_system(n=200, seed=3)
    single = slt.solve(A, b, method="conjugate-gradient", epsilon=1e-8)
    mesh = make_mesh(jax.devices()[:4], shape=(4, 1))
    multi = solve_cg_sharded(A, b, mesh=mesh, mode="explicit",
                             options=slt.SolverOptions(epsilon=1e-8))
    np.testing.assert_allclose(multi.solution, single.solution, rtol=1e-4, atol=1e-5)


def test_batch_solve_single_device():
    A, _, _ = spd_system(n=150, seed=1)
    rng = np.random.default_rng(0)
    B = rng.normal(size=(150, 5))
    results = solve_batch(A, B, slt.SolverOptions(epsilon=1e-8))
    assert len(results) == 5
    dense = A.to_dense()
    for j, r in enumerate(results):
        assert r.converged
        np.testing.assert_allclose(r.solution, np.linalg.solve(dense, B[:, j]), rtol=1e-3, atol=1e-4)


def test_batch_solve_per_column_tolerance():
    """Columns whose RHS norms span 6 orders of magnitude must EACH meet
    their own relative tolerance eps*||b_j|| — not just eps*max_j||b_j||
    (the round-3 behavior this guards against)."""
    n, eps = 150, 1e-6  # f32 compute: rel-residual floor ~4e-7, so 1e-6 is the honest ask
    A, _, _ = spd_system(n=n, seed=4)
    rng = np.random.default_rng(2)
    scales = np.array([1e-6, 1e-3, 1.0, 1e3, 1e6])
    B = rng.normal(size=(n, len(scales))) * scales[None, :]
    for method in ("cg", "neumann"):
        results = solve_batch(A, B, slt.SolverOptions(epsilon=eps), method=method)
        for j, r in enumerate(results):
            bn = np.linalg.norm(B[:, j])
            assert r.converged, f"{method} col {j} (scale {scales[j]}) not converged"
            rel = np.linalg.norm(B[:, j] - A.to_dense() @ r.solution) / bn
            assert rel <= 10 * eps, f"{method} col {j}: relative residual {rel}"


def test_batch_solve_sharded(mesh8):
    A, _, _ = spd_system(n=150, seed=2)
    rng = np.random.default_rng(1)
    B = rng.normal(size=(150, 6))
    results = solve_batch(A, B, slt.SolverOptions(epsilon=1e-8), mesh=mesh8)
    dense = A.to_dense()
    for j, r in enumerate(results):
        assert r.converged
        np.testing.assert_allclose(r.solution, np.linalg.solve(dense, B[:, j]), rtol=1e-3, atol=1e-4)


def test_shard_operator_padding(mesh8):
    from sublinear_tpu.parallel.sharded import shard_operator

    A, _, _ = spd_system(n=100)
    op = shard_operator(A, mesh8)
    assert op.n_pad % (128 * 8) == 0
    assert op.tail_nnz == 0


def test_sharded_auto_mode_neumann(mesh8):
    """GSPMD placement works for the other solvers too: the same jitted
    neumann program runs over a row-sharded operator."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sublinear_tpu.formats.ell import pad_vector
    from sublinear_tpu.parallel.sharded import shard_operator
    from sublinear_tpu.solvers import base as sbase
    from sublinear_tpu.solvers.neumann import _neumann_run

    A = slt.Matrix(slt.generate("tridiagonal", 256).csr.add_diagonal(0.5))
    b = slt.rhs(256, seed=4)
    op = shard_operator(A, mesh8)
    b_pad = jax.device_put(
        pad_vector(b, op.n_pad, op.dtype), NamedSharding(mesh8, P("rows"))
    )
    thr = sbase.threshold_for(b, slt.SolverOptions(epsilon=1e-5))
    x, k, res = _neumann_run(op, b_pad, jnp.zeros_like(b_pad), thr, jnp.int32(1000), 5)[:3]
    x_host = np.asarray(jax.device_get(x))[:256]
    x_ref = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(x_host, x_ref, rtol=1e-3, atol=1e-4)


def test_collect_stats():
    A = slt.Matrix(slt.generate("tridiagonal", 128).csr.add_diagonal(0.5))
    b = slt.rhs(128, seed=5)
    r = slt.solve(A, b, method="conjugate-gradient", collect_stats=True)
    assert r.stats is not None
    assert r.stats.matvec_count > 0
    assert r.stats.nnz_per_second > 0
    assert r.stats.device_count >= 1


def test_multihost_helpers_single_process():
    from sublinear_tpu.parallel.multihost import global_mesh, host_row_block, init_distributed

    info = init_distributed()  # no coordinator -> single-process no-op
    assert info["process_count"] == 1
    assert info["global_devices"] >= 8
    mesh = global_mesh()
    assert set(mesh.shape) == {"rows", "batch"}
    lo, hi = host_row_block(1000)
    assert (lo, hi) == (0, 1000)


def test_large_scale_sharded_smoke(mesh8):
    """BASELINE config #5 shape (scaled down): large sparse ADD system,
    row-partitioned explicit-collective CG on the 8-device mesh."""
    n = 50_000
    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    b = slt.rhs(n, seed=9)
    r = solve_cg_sharded(A, b, mesh=mesh8, mode="explicit",
                         options=slt.SolverOptions(epsilon=1e-5, max_iterations=200))
    assert r.converged
    rel = np.linalg.norm(A.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert rel < 1e-4


def test_batch_solve_small_batch_padded_ell():
    """nrhs < 8 on an ELL operator solves exactly the columns given (no
    padding columns) with correct results."""
    n = 300
    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5), prefer="ell")
    rng = np.random.default_rng(3)
    B = rng.normal(size=(n, 3))
    results = solve_batch(A, B, slt.SolverOptions(epsilon=1e-7))
    assert len(results) == 3
    dense = A.to_dense()
    for j, r in enumerate(results):
        assert r.converged
        np.testing.assert_allclose(r.solution, np.linalg.solve(dense, B[:, j]), rtol=1e-3, atol=1e-4)


def test_sharded_neumann_matches_oracle(mesh8):
    from sublinear_tpu.parallel.sharded import solve_neumann_sharded

    A, b, x_ref = spd_system(n=256, seed=6)
    r = solve_neumann_sharded(A, b, mesh=mesh8, options=slt.SolverOptions(epsilon=1e-6))
    assert r.converged, f"residual {r.residual}"
    assert r.method == "neumann-sharded"
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-3, atol=1e-4)


def _sharded_setup(mesh8, n=256, seed=4):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sublinear_tpu.formats.ell import pad_vector
    from sublinear_tpu.parallel.sharded import shard_operator
    from sublinear_tpu.solvers import base as sbase

    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    b = slt.rhs(n, seed=seed)
    op = shard_operator(A, mesh8)
    b_pad = jax.device_put(
        pad_vector(b, op.n_pad, op.dtype), NamedSharding(mesh8, P("rows"))
    )
    thr = sbase.threshold_for(b, slt.SolverOptions(epsilon=1e-5))
    x_ref = np.linalg.solve(A.to_dense(), b)
    return A, b, op, b_pad, thr, x_ref


def test_sharded_auto_mode_push(mesh8):
    """GSPMD auto mode covers the push family (round-1 gap: only CG and
    Neumann were mesh-tested)."""
    import jax.numpy as jnp
    from sublinear_tpu.solvers.push import _push_run

    A, b, op, b_pad, thr, x_ref = _sharded_setup(mesh8, seed=6)
    x, k, res, _ = _push_run(op, b_pad, jnp.zeros_like(b_pad), thr, jnp.int32(2000), 5)
    x_host = np.asarray(jax.device_get(x))[:256]
    np.testing.assert_allclose(x_host, x_ref, rtol=1e-3, atol=1e-3)


def test_sharded_auto_mode_chebyshev(mesh8):
    import jax.numpy as jnp
    from sublinear_tpu.solvers.chebyshev import _chebyshev_run

    A, b, op, b_pad, thr, x_ref = _sharded_setup(mesh8, seed=7)
    x, k, res, _ = _chebyshev_run(op, b_pad, jnp.zeros_like(b_pad), 0.8, thr,
                                  jnp.int32(2000), 5)
    x_host = np.asarray(jax.device_get(x))[:256]
    np.testing.assert_allclose(x_host, x_ref, rtol=1e-3, atol=1e-3)


def test_sharded_auto_mode_random_walk(mesh8):
    """Walker tables are device arrays; under GSPMD they run replicated —
    the estimate program must still compile and produce a sane estimate on
    a mesh."""
    from sublinear_tpu.solvers import random_walk as _rw

    A, b, op, b_pad, thr, x_ref = _sharded_setup(mesh8, seed=8)
    opts = slt.SolverOptions(epsilon=5e-2, num_walks=512, seed=3)
    est, var, steps = _rw.walk_estimate(A, b, np.arange(16), opts)
    assert np.all(np.isfinite(est))
    # MC estimate: loose statistical agreement on the first entries
    assert np.abs(est[:16] - x_ref[:16]).max() < 0.5 * max(1.0, np.abs(x_ref).max())


# ------------------------------------------------------------ explicit sharded
# round-3: full family coverage over the mesh (VERDICT r2 items 2-3)

def test_split_operator_hub_rows_bounded(mesh8):
    """Power-law-ish hub rows must NOT inflate the ELL slot cap: the split
    operator absorbs overflow into per-shard COO tails (round-2 weakness:
    slot_cap = max(row_nnz))."""
    from sublinear_tpu.parallel.sharded import shard_operator_split

    n = 512
    rng = np.random.default_rng(0)
    r = rng.integers(0, n, 4 * n)
    c = rng.integers(0, n, 4 * n)
    v = rng.uniform(-1, 1, 4 * n)
    # one hub row with 300 entries
    r = np.r_[r, np.full(300, 7)]
    c = np.r_[c, np.arange(300)]
    v = np.r_[v, np.full(300, 0.001)]
    diag = np.zeros(n)
    np.add.at(diag, r, np.abs(v))
    A = slt.Matrix.from_coo(np.r_[r, np.arange(n)], np.r_[c, np.arange(n)],
                            np.r_[v, diag * 1.5 + 1], (n, n))
    op = shard_operator_split(A, mesh8)
    assert op.vals_loc.shape[0] + op.vals_rem.shape[0] < 100  # slot caps stay small
    assert op.tail_per_shard >= 1
    b = slt.rhs(n, seed=1)
    # asymmetric DD system -> the sharded Neumann family
    from sublinear_tpu.parallel.sharded import solve_neumann_sharded

    res = solve_neumann_sharded(A, b, mesh=mesh8,
                                options=slt.SolverOptions(epsilon=1e-6, max_iterations=3000))
    r_vec = A.to_dense() @ res.solution - b
    assert np.linalg.norm(r_vec) <= 1e-5 * np.linalg.norm(b)
    assert res.distribution["bytes_per_shard"] > 0
    assert res.distribution["comm_bytes_per_iter"] > 0


def test_sharded_neumann_split(mesh8):
    from sublinear_tpu.parallel.sharded import solve_neumann_sharded

    A, b, x_ref = spd_system(n=280, seed=5)
    r = solve_neumann_sharded(A, b, mesh=mesh8,
                              options=slt.SolverOptions(epsilon=1e-5))
    assert r.converged
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-3, atol=1e-4)


def test_sharded_push_explicit(mesh8):
    from sublinear_tpu.parallel.graph_sharded import solve_push_sharded

    A, b, x_ref = spd_system(n=260, seed=9)
    r = solve_push_sharded(A, b, mesh=mesh8,
                           options=slt.SolverOptions(epsilon=1e-7, max_iterations=4000))
    assert r.converged
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-3, atol=1e-3)


def test_sharded_pagerank_matches_single(mesh8):
    from sublinear_tpu.graph.pagerank import pagerank
    from sublinear_tpu.parallel.graph_sharded import pagerank_sharded

    n = 200
    rng = np.random.default_rng(4)
    r = rng.integers(0, n, 5 * n)
    c = rng.integers(0, n, 5 * n)
    keep = r != c
    A = slt.Matrix.from_coo(r[keep], c[keep], np.ones(keep.sum()), (n, n))
    single = pagerank(A, damping=0.85, epsilon=1e-8)
    multi = pagerank_sharded(A, mesh=mesh8, alpha=0.85, epsilon=1e-8)
    assert multi.converged
    np.testing.assert_allclose(multi.scores, single.scores, rtol=1e-3, atol=1e-6)


def test_sharded_pagerank_weighted_dangling(mesh8):
    """Weighted graph + dangling nodes: the sharded dangling mass must come
    from the WEIGHTED out-degree (graph/pagerank.py:107-111 semantics), not
    the stored-entry count — they disagree on weighted graphs."""
    from sublinear_tpu.graph.pagerank import pagerank
    from sublinear_tpu.parallel.graph_sharded import pagerank_sharded

    n = 220
    rng = np.random.default_rng(12)
    rows, cols, vals = [], [], []
    for i in range(n - 15):  # last 15 nodes dangling
        for j in rng.choice(n, size=int(rng.integers(1, 6)), replace=False):
            rows.append(i)
            cols.append(int(j))
            vals.append(float(rng.uniform(0.1, 2.0)))
    A = slt.Matrix.from_coo(np.array(rows), np.array(cols), np.array(vals), (n, n))
    single = pagerank(A, damping=0.85, epsilon=1e-8)
    multi = pagerank_sharded(A, mesh=mesh8, alpha=0.85, epsilon=1e-8)
    assert multi.converged and single.converged
    np.testing.assert_allclose(multi.scores, single.scores, rtol=1e-3, atol=1e-6)


def test_sharded_walkers_all_to_all(mesh8):
    from sublinear_tpu.parallel.graph_sharded import walk_estimate_sharded

    A, b, x_ref = spd_system(n=192, seed=11)
    opts = slt.SolverOptions(epsilon=5e-2, num_walks=4096, seed=5,
                             max_walk_length=64)
    est, steps = walk_estimate_sharded(A, b, np.arange(8), mesh=mesh8, options=opts)
    assert np.all(np.isfinite(est))
    assert steps > 0
    assert np.abs(est - x_ref[:8]).max() < 0.5 * max(1.0, np.abs(x_ref).max())


def test_sharded_walkers_compute_scale(mesh8):
    """Owner re-bucketing: per-device query load and comm bytes must FALL as
    D grows at fixed global walker count (the round-3 broadcast engine was
    O(W) per device at every D), while the estimate stays correct."""
    from sublinear_tpu.parallel.graph_sharded import walk_estimate_sharded

    A, b, x_ref = spd_system(n=512, seed=11)
    opts = slt.SolverOptions(epsilon=5e-2, num_walks=16384, seed=7,
                             max_walk_length=64)
    loads = {}
    for d in (2, 8):
        mesh = make_mesh(jax.devices()[:d], shape=(d, 1))
        est, steps, stats = walk_estimate_sharded(
            A, b, np.arange(6), mesh=mesh, options=opts, return_stats=True)
        assert np.all(np.isfinite(est))
        assert np.abs(est - x_ref[:6]).max() < 0.5 * max(1.0, np.abs(x_ref).max())
        loads[d] = stats
    # 4x the devices -> per-device walker count drops 4x; query and comm
    # load per device must drop accordingly (bucket capacity is ~2*W_l/D,
    # lane-aligned, so allow the 128-slot floor)
    assert loads[8]["walkers_per_device"] * 4 == loads[2]["walkers_per_device"]
    assert (loads[8]["queries_per_device_per_step"]
            < loads[2]["queries_per_device_per_step"])
    assert (loads[8]["comm_bytes_per_device_per_step"]
            < loads[2]["comm_bytes_per_device_per_step"])


def test_sharded_bmssp_matches_single(mesh8):
    from sublinear_tpu.parallel.graph_sharded import bmssp_sharded
    from sublinear_tpu.solvers.bmssp import shortest_paths

    A, b, _ = spd_system(n=220, seed=13)
    dist_s, x_s, _ = shortest_paths(A, [0, 5])
    dist_m, x_m, sweeps = bmssp_sharded(A, [0, 5], mesh=mesh8)
    n = A.shape[0]
    np.testing.assert_allclose(dist_m[:n], dist_s[:n], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x_m[:n], x_s[:n], rtol=1e-4, atol=1e-5)
    assert sweeps > 0


def test_sharded_bmssp_frontier_compressed_comm(mesh8):
    """Long-diameter path graph: the per-sweep exchange must be the fixed
    frontier slab (D*F triplets), NOT the full O(n) distance vectors — and
    doubling n must leave comm bytes/sweep bounded by the slab size while
    the full-gather cost doubles."""
    from sublinear_tpu.parallel.graph_sharded import bmssp_sharded
    from sublinear_tpu.solvers.bmssp import shortest_paths

    def path_graph(n):
        i = np.arange(n - 1)
        w = np.full(n - 1, 1.0)
        return slt.Matrix.from_coo(np.r_[i, i + 1], np.r_[i + 1, i],
                                   np.r_[w, w], (n, n))

    stats = {}
    for n in (2048, 4096):
        A = path_graph(n)
        dist_s, x_s, _ = shortest_paths(A, [0])
        dist_m, x_m, sweeps, st = bmssp_sharded(A, [0], mesh=mesh8,
                                                return_stats=True)
        np.testing.assert_allclose(dist_m, dist_s[:n], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(x_m, x_s[:n], rtol=1e-5, atol=1e-5)
        stats[n] = st
    # path frontier is O(1) per sweep; the slab stays at its 128-row floor
    # while the round-3 full gather would double with n
    assert stats[2048]["comm_bytes_per_sweep"] == stats[4096]["comm_bytes_per_sweep"]
    assert (stats[4096]["full_gather_bytes_per_sweep"]
            == 2 * stats[2048]["full_gather_bytes_per_sweep"])
    assert (stats[4096]["comm_bytes_per_sweep"]
            < stats[4096]["full_gather_bytes_per_sweep"])


def test_ring_halo_banded_cg(mesh8):
    """ppermute ring-halo CG on a banded SPD system: O(bandwidth) comm per
    iteration instead of an O(n) all_gather (SURVEY.md §5.8 ring pattern)."""
    from sublinear_tpu.parallel.banded import solve_cg_banded_sharded

    n = 4096
    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    b = slt.rhs(n, seed=11)
    r = solve_cg_banded_sharded(A, b, mesh=mesh8,
                                options=slt.SolverOptions(epsilon=1e-6))
    assert r.converged, r.residual
    x_ref = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(r.solution, x_ref, rtol=1e-3, atol=1e-4)
    # comm accounting: two halo slabs, independent of n
    d = r.distribution
    assert d["comm_bytes_per_iter"] == 2 * d["halo_rows"] * 4
    assert d["comm_bytes_per_iter"] < n  # << the all_gather's n*4 bytes


def test_ring_halo_rejects_unbanded(mesh8):
    from sublinear_tpu.errors import InvalidMatrixError
    from sublinear_tpu.parallel.banded import solve_cg_banded_sharded

    A, b, _ = make_dd_system(n=256, density=0.05, seed=3)
    with pytest.raises(InvalidMatrixError):
        solve_cg_banded_sharded(A, b, mesh=mesh8)


def test_sharded_walkers_hotspot_unbiased_or_accounted(mesh8):
    """Adversarial hotspot (round-4 verdict weak #5): ALL walkers start on
    ONE node at D=8 — the multi-walk estimateEntry pattern.  Overflowing
    walkers wait-and-retry; the estimate must stay unbiased within a loose
    MC interval, and any walker mass still alive when the 2*max_len wall
    budget expires must be REPORTED in stats (never silently truncated)."""
    from sublinear_tpu.parallel.graph_sharded import walk_estimate_sharded

    A, b, x_ref = spd_system(n=512, seed=13)
    hot = 3
    opts = slt.SolverOptions(epsilon=5e-2, num_walks=32768, seed=11,
                             max_walk_length=64)
    mesh = make_mesh(jax.devices()[:8], shape=(8, 1))
    est, steps, stats = walk_estimate_sharded(
        A, b, [hot], mesh=mesh, options=opts, return_stats=True)
    assert np.isfinite(est[0])
    assert "unserved_walker_mass" in stats
    if stats["unserved_walker_mass"] <= 1e-9:
        # fully served: the estimate must be unbiased within a loose CI
        scale = max(1.0, float(np.abs(x_ref).max()))
        assert abs(est[0] - x_ref[hot]) < 0.5 * scale, (est[0], x_ref[hot])
    else:
        # truncation happened and was accounted — the contract holds
        assert stats["unserved_walker_mass"] <= stats["total_walker_mass"]
