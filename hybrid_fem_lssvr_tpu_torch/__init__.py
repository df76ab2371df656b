"""hybrid_fem_lssvr_tpu_torch — the hybrid FEM + LSSVR solver in PyTorch.

A port of ``hybrid_fem_lssvr_tpu`` (JAX) to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper GPUs.  A coarse finite-element solve gives nodal
values; an independent least-squares (LSSVR) problem per element, with a
Legendre basis and its boundary pinned to the FEM values, reconstructs a
high-order solution.  This package covers the 1D solver (``HybridSolver``),
the 2D structured-quad solver (``HybridSolver2D``), its graded-mesh variant
(``HybridSolver2DGraded``) and the 3D structured-hex solver
(``HybridSolver3D``) with its graded variant (``HybridSolver3DGraded``),
linear elasticity in 2D and 3D (``ElasticSolver2D``, ``ElasticSolver3D``),
parametric families solved as one batch (``solve_family``,
``solve_groups``), slack-driven and goal-oriented adaptivity
(``adaptive_solve``, ``goal_adaptive_solve[_2d|_3d]``), semilinear
problems (``models.nonlinear``), the biharmonic and eigenvalue families
(``models.biharmonic``, ``models.eigen``) and the 1D and 2D time marches
with checkpointed resume (``models.transient``, ``utils.checkpoint``); the
JAX package remains the reference for everything else.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on a
machine without a GPU they raise instead of falling back.
"""

from .models import problems
from .models.adaptive import adaptive_solve
from .models.batched import ParametricFamily1D, solve_family, solve_groups
from .models.elastic import (ElasticConfig2D, ElasticProblem2D,
                             ElasticSolution2D, ElasticSolver2D,
                             get_elastic_problem, hybrid_solve_elastic)
from .models.elastic3d import (ElasticConfig3D, ElasticProblem3D,
                               ElasticSolution3D, ElasticSolver3D,
                               get_elastic_problem_3d,
                               hybrid_solve_elastic_3d)
from .models.goal import (goal_adaptive_solve, goal_adaptive_solve_2d,
                          goal_adaptive_solve_3d)
from .models.hybrid import HybridSolver, Solution, SolverConfig, hybrid_solve
from .models.hybrid2d import (HybridSolver2D, Problem2D, Solution2D,
                              Solver2DConfig, get_problem_2d,
                              hybrid_solve_2d, poisson_2d)
from .models.hybrid2d_graded import HybridSolver2DGraded
from .models.hybrid3d import (HybridSolver3D, Problem3D, Solution3D,
                              Solver3DConfig, get_problem_3d,
                              hybrid_solve_3d)
from .models.hybrid3d_graded import HybridSolver3DGraded
from .models.problem import Problem1D

__version__ = "0.5.0"

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
    "poisson_2d",
    "HybridSolver2DGraded",
    "HybridSolver3D",
    "Solver3DConfig",
    "Solution3D",
    "Problem3D",
    "get_problem_3d",
    "hybrid_solve_3d",
    "ElasticSolver2D",
    "ElasticConfig2D",
    "ElasticSolution2D",
    "ElasticProblem2D",
    "get_elastic_problem",
    "hybrid_solve_elastic",
    "ElasticSolver3D",
    "ElasticConfig3D",
    "ElasticSolution3D",
    "ElasticProblem3D",
    "get_elastic_problem_3d",
    "hybrid_solve_elastic_3d",
    "HybridSolver3DGraded",
    "adaptive_solve",
    "goal_adaptive_solve",
    "goal_adaptive_solve_2d",
    "goal_adaptive_solve_3d",
    "ParametricFamily1D",
    "solve_family",
    "solve_groups",
]
