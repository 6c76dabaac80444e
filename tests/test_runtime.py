"""Process-level configuration: the compile-cache path, the device-memory
budget, the roofline peak table, the default mesh, and ``chip_smoke.py``'s
refusal to report a result without a GPU."""
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

import sublinear_tpu as slt
from sublinear_tpu import config
from sublinear_tpu.errors import InvalidParametersError, MemoryLimitError
from sublinear_tpu.formats import streaming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ compile cache

@pytest.fixture()
def cache_config():
    """Run enable_compilation_cache's body afresh, restoring jax's config."""
    saved = jax.config.jax_compilation_cache_dir
    yield config.enable_compilation_cache.__wrapped__
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_uses_env_dir(cache_config, monkeypatch, tmp_path):
    monkeypatch.delenv("SLT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    cache_config()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()


def test_compile_cache_defaults_to_repo_dir(cache_config, monkeypatch):
    monkeypatch.delenv("SLT_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache_config()
    assert jax.config.jax_compilation_cache_dir == os.path.join(REPO, ".jax_cache")


def test_compile_cache_opt_out(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("SLT_NO_COMPILE_CACHE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "never"))
    cache_config()
    assert not (tmp_path / "never").exists()


# ------------------------------------------------------------ memory budget

def _fake_device(platform, stats):
    return types.SimpleNamespace(platform=platform, device_kind=f"fake {platform}",
                                 memory_stats=lambda: stats)


@pytest.mark.parametrize("platform,stats,env,expect", [
    ("gpu", {"bytes_limit": 100 * 2**30}, None, int(80 * 2**30)),
    ("gpu", None, "12345", 12345),
    ("cpu", None, None, "host"),
])
def test_memory_budget_sources(monkeypatch, platform, stats, env, expect):
    monkeypatch.setattr(jax, "local_devices", lambda: [_fake_device(platform, stats)])
    if env is None:
        monkeypatch.delenv("SLT_MEMORY_LIMIT_BYTES", raising=False)
    else:
        monkeypatch.setenv("SLT_MEMORY_LIMIT_BYTES", env)
    if expect == "host":
        host = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        assert streaming.memory_budget_bytes() == int(host * 0.8)
    else:
        assert streaming.memory_budget_bytes() == expect


def test_memory_budget_without_device_stats_raises(monkeypatch):
    """An accelerator that reports no memory limit gets no assumed budget."""
    monkeypatch.setattr(jax, "local_devices", lambda: [_fake_device("gpu", None)])
    monkeypatch.delenv("SLT_MEMORY_LIMIT_BYTES", raising=False)
    with pytest.raises(MemoryLimitError) as e:
        streaming.memory_budget_bytes()
    assert e.value.code == "E007"
    assert "SLT_MEMORY_LIMIT_BYTES" in e.value.message


# --------------------------------------------------------------- peak table

def test_peak_table_knows_h200():
    from sublinear_tpu.benchmarks import peak_bytes_per_s

    assert peak_bytes_per_s("NVIDIA H200") == 4.8e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-40GB", ""])
def test_peak_table_unknown_device_has_no_peak(kind):
    from sublinear_tpu.benchmarks import peak_bytes_per_s

    assert peak_bytes_per_s(kind) is None


def test_ell_spmv_bytes_counts_slots_sectors_and_tail():
    from sublinear_tpu.benchmarks import ell_spmv_bytes

    A = slt.generate("random-sparse", 500, seed=1, density=0.02)
    op = slt.Matrix(A.csr, prefer="ell").op()
    k, n_pad = op.values.shape
    assert ell_spmv_bytes(op, A.nnz) == (8 * k * n_pad + 32 * A.nnz + 4 * n_pad
                                         + 12 * op.tail_nnz)


# --------------------------------------------------------------------- mesh

@pytest.mark.parametrize("d", [2, 4])
def test_default_mesh_puts_every_device_on_rows(d):
    from sublinear_tpu.parallel.mesh import make_mesh

    assert dict(make_mesh(jax.devices()[:d]).shape) == {"rows": d, "batch": 1}
    assert dict(make_mesh(jax.devices()[:d], shape=(d // 2, 2)).shape) == {
        "rows": d // 2, "batch": 2}


# ------------------------------------------------------------- refinement

def test_refine_rejects_unknown_residual_mode():
    from sublinear_tpu.solvers.refine import solve_refined

    A = slt.generate("random-sparse", 50, seed=2, density=0.1)
    with pytest.raises(InvalidParametersError):
        solve_refined(A, np.ones(50), residual="remote")


# --------------------------------------------------------------- chip_smoke

def _no_ok_line(out: str) -> bool:
    return '"ok": true' not in out


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert _no_ok_line(r.stdout)
