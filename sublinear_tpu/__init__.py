"""sublinear_tpu — GPU-native sparse linear-algebra framework.

A ground-up JAX/XLA re-design of the capabilities of
ruvnet/sublinear-time-solver (reference mounted at /root/reference): solvers
for asymmetric diagonally-dominant systems (Neumann series, forward/backward
push, random-walk Monte Carlo, hybrid, CG family, BMSSP), single-entry and
functional queries, PageRank/graph algorithms, matrix analysis/generation,
multi-chip sharded execution over jax meshes, and CLI/MCP/HTTP interfaces.
"""

__version__ = "0.1.0"

from .config import enable_compilation_cache as _enable_cache

_enable_cache()

from .analysis import MatrixAnalysis, analyze
from .errors import (
    ConvergenceError,
    DimensionMismatchError,
    InvalidMatrixError,
    InvalidParametersError,
    NotDiagonallyDominantError,
    NumericalInstabilityError,
    SolverError,
)
from .generate import generate, rhs
from .matrix import Matrix
from .solvers.dispatch import select_method, solve
from .types import Method, SolverOptions, SolverResult, SolverStats

__all__ = [
    "Matrix",
    "MatrixAnalysis",
    "Method",
    "SolverOptions",
    "SolverResult",
    "SolverStats",
    "analyze",
    "generate",
    "rhs",
    "select_method",
    "solve",
    "SolverError",
    "ConvergenceError",
    "DimensionMismatchError",
    "InvalidMatrixError",
    "InvalidParametersError",
    "NotDiagonallyDominantError",
    "NumericalInstabilityError",
]
