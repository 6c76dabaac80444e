"""Compiled-HLO collective assertions: the sharded solvers' communication
pattern as a regression-proof invariant.

Without multi-chip hardware, the strongest checkable evidence that the
sharded solvers communicate as designed is the *compiled program itself*:
these tests compile the explicit shard_map solvers on the 8-device virtual
mesh and assert the optimized HLO contains exactly the claimed collectives
per iteration —

* `solve_cg_sharded` (explicit): ONE all-gather in the while body (the p
  re-replication halo exchange) + psum all-reduces; no all-to-all, no
  collective-permute.
* `solve_cg_banded_sharded`: ZERO all-gathers anywhere — the ring halo moves
  by collective-permute only (2 ppermutes per matvec).
* `pagerank_sharded`: ONE all-gather per power iteration + psums.

Reference scale story being pinned down: SURVEY.md §5.7/§5.8 (the reference's
rayon row-chunk matvec, /root/reference/src/matrix/optimized.rs:397-449, has
no distributed analog to check against).
"""
import pytest

import jax

import sublinear_tpu as slt
from sublinear_tpu.parallel.hlo import count_defs as _count_defs
from sublinear_tpu.parallel.hlo import while_body as _while_body
from sublinear_tpu.parallel.mesh import make_mesh
from sublinear_tpu.parallel.sharded import lower_explicit_cg_text


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(jax.devices()[:8])


def _compile_explicit_cg(mesh, n=512, density=0.02):
    A = slt.generate("random-sparse", n, seed=0, density=density)
    return lower_explicit_cg_text(A, slt.rhs(n, seed=0), mesh,
                                  slt.SolverOptions(max_iterations=100))


# -------------------------------------------------------------------- tests

def test_explicit_cg_one_allgather_per_iteration(mesh8):
    txt = _compile_explicit_cg(mesh8)
    body = _while_body(txt)
    assert _count_defs(body, "all-gather") == 1, \
        "explicit CG body must re-replicate p with exactly ONE all-gather"
    # psum(pAp), psum(rz_new), psum(res) — XLA may merge adjacent psums,
    # so bound rather than pin: at least 1, at most 3
    ar = _count_defs(body, "all-reduce")
    assert 1 <= ar <= 3, f"unexpected all-reduce count in CG body: {ar}"
    # nothing else moves data between shards
    assert _count_defs(body, "all-to-all") == 0
    assert _count_defs(body, "collective-permute") == 0
    # whole program: prologue matvec adds exactly one more all-gather
    assert _count_defs(txt, "all-gather") == 2


def test_ring_banded_cg_ppermute_only(mesh8):
    from sublinear_tpu.parallel import banded

    n = 1024
    A = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    txt = banded.lower_ring_cg_text(A, slt.rhs(n, seed=1), mesh8)
    body = _while_body(txt)
    assert _count_defs(body, "all-gather") == 0, \
        "ring CG must not all-gather — halo rides collective-permute"
    assert _count_defs(txt, "all-gather") == 0
    cp = _count_defs(body, "collective-permute")
    assert 1 <= cp <= 2, f"ring CG body should carry 1-2 ppermutes, got {cp}"
    assert _count_defs(body, "all-to-all") == 0


def test_pagerank_sharded_one_allgather_per_iteration(mesh8):
    from sublinear_tpu.parallel import graph_sharded as gs

    n = 512
    A = slt.generate("random-sparse", n, seed=3, density=0.02)
    txt = gs.lower_pagerank_text(A, mesh8)
    body = _while_body(txt)
    assert _count_defs(body, "all-gather") == 1, \
        "PageRank body must gather x exactly once per power iteration"
    assert _count_defs(body, "all-to-all") == 0
    assert _count_defs(body, "collective-permute") == 0
    ar = _count_defs(body, "all-reduce")
    assert 1 <= ar <= 2, f"dangling-mass + residual psums, got {ar}"
