"""Adaptive mesh refinement driven by the per-element slack diagnostics.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/adaptive.py``.  The
slack (the LSSVR's own PDE residual at the collocation points) is an
a-posteriori error indicator: elements where the constrained polynomial
cannot satisfy the PDE are under-resolved.  Each round bisects the worst
fraction and re-solves on the graded mesh through the per-element
(general) path, which on a CUDA float32 run is the graded mode of
``fused_enhance_varcoeff``.

The refinement itself stays numpy on the host: ``np.argsort``'s order of
ties decides which elements are bisected, and ``torch.argsort`` breaks
ties differently, so the mesh sequences would part from the JAX package's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .hybrid import HybridSolver, SolverConfig, Solution
from .problem import Problem1D


class AdaptiveResult(NamedTuple):
    solution: Solution
    nodes: torch.Tensor
    history: List[dict]  # per-round {elements, max_slack, linf?}


def refine_nodes(nodes: np.ndarray, indicator: np.ndarray,
                 refine_frac: float = 0.3) -> np.ndarray:
    """Bisect the worst ``refine_frac`` of elements by ``indicator``."""
    E = nodes.shape[0] - 1
    n_ref = max(1, int(np.ceil(refine_frac * E)))
    worst = np.argsort(indicator)[-n_ref:]
    mids = 0.5 * (nodes[worst] + nodes[worst + 1])
    return np.sort(np.concatenate([nodes, mids]))


def uniform_nodes_host(domain, num_nodes: int, dtype) -> np.ndarray:
    """The uniform starting mesh as ``uniform_nodes`` makes it, on the
    host (``torch.linspace`` in the run dtype)."""
    x0, x1 = domain
    return torch.linspace(x0, x1, num_nodes, dtype=dtype).numpy()


def adaptive_solve(problem: Problem1D, cfg: SolverConfig,
                   rounds: int = 4, refine_frac: float = 0.3,
                   eval_points: Optional[np.ndarray] = None,
                   device=None) -> AdaptiveResult:
    """Solve-estimate-refine loop starting from cfg.num_nodes uniform nodes,
    on ``device`` (None: the GPU)."""
    dtype = cfg.torch_dtype()
    nodes = uniform_nodes_host(problem.domain, cfg.num_nodes, dtype)
    history = []
    solver = None
    for r in range(rounds + 1):
        solver = HybridSolver(problem, cfg, nodes=torch.as_tensor(nodes),
                              device=device)
        sol = solver.solve()
        indicator = sol.max_slack.detach().cpu().numpy()
        rec = {
            "round": r,
            "elements": int(sol.coeffs.shape[0]),
            "max_slack": float(indicator.max()),
        }
        if problem.exact is not None and eval_points is not None:
            linf, _ = solver.errors(eval_points)
            rec["linf"] = float(linf)
        history.append(rec)
        if r == rounds:
            break
        nodes = refine_nodes(nodes, indicator, refine_frac)
    return AdaptiveResult(solution=solver.solution,
                          nodes=torch.as_tensor(nodes, device=solver.device),
                          history=history)
