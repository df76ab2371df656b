"""hybrid_fem_lssvr_tpu_torch — the hybrid FEM + LSSVR solver in PyTorch.

A port of ``hybrid_fem_lssvr_tpu`` (JAX) to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper GPUs.  A coarse finite-element solve gives nodal
values; an independent least-squares (LSSVR) problem per element, with a
Legendre basis and its boundary pinned to the FEM values, reconstructs a
high-order solution.  This package covers the 1D solver (``HybridSolver``)
and the 2D structured-quad solver (``HybridSolver2D``); the JAX package
remains the reference for everything else.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on a
machine without a GPU they raise instead of falling back.
"""

from .models import problems
from .models.hybrid import HybridSolver, Solution, SolverConfig, hybrid_solve
from .models.hybrid2d import (HybridSolver2D, Problem2D, Solution2D,
                              Solver2DConfig, get_problem_2d,
                              hybrid_solve_2d)
from .models.problem import Problem1D

__version__ = "0.2.0"

__all__ = [
    "HybridSolver",
    "SolverConfig",
    "Solution",
    "hybrid_solve",
    "Problem1D",
    "problems",
    "HybridSolver2D",
    "Solver2DConfig",
    "Solution2D",
    "Problem2D",
    "get_problem_2d",
    "hybrid_solve_2d",
]
