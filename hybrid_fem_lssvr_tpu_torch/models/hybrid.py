"""Hybrid FEM + LSSVR orchestration: the 1D solver's entry point.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/hybrid.py``:

* ``fem_solve``      — P1 assembly + tridiagonal solve (Thomas up to 8192
                       rows, blocked SPIKE above).
* ``lssvr_enhance``  — one batched enhancement of all elements: the fused
                       CUDA kernels of ``ops.kernels`` on a CUDA float32
                       run, batched torch algebra (``ops.kkt``) otherwise.
* ``HybridSolver``   — the stateful facade, with evaluation and errors.

The stages run inside named ``torch.profiler.record_function`` spans
(``SPANS``), so a profiler run of the public API reads where a solve
spends its time; without a profiler the spans cost a few microseconds.

PyTorch runs eagerly, so ``hybrid_solve`` is a plain function (JAX jits
it).  ``backend`` takes 'auto', 'torch' (the counterpart of JAX's 'xla':
batched tensor ops) or 'cuda' (the hand-written kernels); 'auto' picks
'cuda' for CUDA tensors in float32, as JAX picks Pallas for float32 on the
TPU.  A kernel raises for an (M, n_colloc) it was not compiled for; such a
run asks for backend='torch'.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import assembly, eval as ops_eval, kernels, kkt, legendre, tridiag
from ..utils.device import resolve as resolve_device
from .problem import Problem1D

_span = torch.profiler.record_function
SPANS = ("prepare_shared_host", "fem_solve.assembly", "fem_solve.tridiag",
         "lssvr_enhance", "evaluate_solution")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver settings (the same fields as the JAX ``SolverConfig``)."""

    num_nodes: int = 25
    M: int = 8  # Legendre coefficients per element
    gamma: float = 1.0e4  # regularisation
    n_colloc: int = 12  # PDE collocation points per element
    formulation: str = "primal"  # 'primal' | 'dual'
    kkt_method: str = "auto"  # 'auto' | 'cholesky' | 'qr' | 'dual_aug'
    backend: str = "auto"  # 'auto' | 'torch' | 'cuda'
    diagnostics: bool = True  # slack/bc residual outputs
    tridiag_method: str = "auto"  # 'auto'|'thomas'|'pcr'|'spike'|'dense'
    fem_quad_order: int = 3
    refine_steps: int = 0  # iterative refinement on f32 paths
    dtype: Optional[str] = None  # 'float32' | 'float64' | None (= float64)
    # Coarse-stage dtype override: the FEM system's conditioning grows like
    # N^2, so beyond ~1e3 elements an f32 coarse solve loses all accuracy.
    # 'float64' runs the FEM stage in f64 and casts nodal values back to
    # the run dtype; the enhancement stays in the run dtype.
    fem_dtype: Optional[str] = None

    def __post_init__(self):
        if self.num_nodes < 2:
            raise ValueError(f"num_nodes must be >= 2, got {self.num_nodes}")
        if self.M < 1:
            raise ValueError(f"M must be >= 1, got {self.M}")
        if self.n_colloc < 2:
            raise ValueError(f"n_colloc must be >= 2, got {self.n_colloc}")
        if self.n_colloc + 2 < self.M:
            raise ValueError(
                f"n_colloc={self.n_colloc} under-determines M={self.M} "
                f"coefficients (need n_colloc + 2 >= M)"
            )
        if self.gamma <= 0:
            raise ValueError(f"gamma must be positive, got {self.gamma}")
        if self.formulation not in ("primal", "dual"):
            raise ValueError(f"unknown formulation: {self.formulation!r}")
        if self.kkt_method not in ("auto", "cholesky", "qr", "dual_aug"):
            raise ValueError(f"unknown kkt_method: {self.kkt_method!r}")
        if self.backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown backend: {self.backend!r}")
        if self.tridiag_method not in ("auto", "thomas", "pcr", "spike",
                                       "dense"):
            raise ValueError(
                f"unknown tridiag_method: {self.tridiag_method!r}"
            )

    def torch_dtype(self) -> torch.dtype:
        """The run dtype; float64 when unset (JAX's default under x64)."""
        return getattr(torch, self.dtype or "float64")


class Solution(NamedTuple):
    nodes: torch.Tensor  # [N]
    fem_values: torch.Tensor  # [N] coarse P1 nodal values
    coeffs: torch.Tensor  # [E, M] per-element Legendre coefficients
    max_slack: torch.Tensor  # [E]
    bc_violation: torch.Tensor  # [E]
    solve_ok: torch.Tensor  # [E] bool fallback mask
    cond_estimate: Optional[torch.Tensor] = None


def uniform_nodes(problem: Problem1D, num_nodes: int, dtype,
                  device=None) -> torch.Tensor:
    """Uniform node array on ``device`` (None: the GPU, see
    ``utils.device``)."""
    x0, x1 = problem.domain
    return torch.linspace(x0, x1, num_nodes, dtype=dtype,
                          device=resolve_device(device))


def fem_solve(problem: Problem1D, nodes: torch.Tensor, cfg: SolverConfig):
    """Coarse P1 FEM nodal values (P1 dofs ARE nodal values)."""
    with _span("fem_solve.assembly"):
        sub, main, sup, rhs = assembly.assemble_p1(
            nodes, problem.a, problem.b, problem.c, problem.f,
            quad_order=cfg.fem_quad_order,
        )
        sub, main, sup, rhs = assembly.apply_bcs(sub, main, sup, rhs,
                                                 problem)
    with _span("fem_solve.tridiag"):
        return tridiag.solve(sub, main, sup, rhs, method=cfg.tridiag_method)


def _element_data(problem: Problem1D, nodes, fem_values, cfg: SolverConfig,
                  touches_left: bool = True, touches_right: bool = True):
    """Per-element collocation data: mapped points, rhs, endpoint values
    (nodes [..., N]: leading axes are a family of meshes).

    Boundary elements pin to the global Dirichlet data (by position, not
    float equality); Neumann / Robin ends keep the FEM nodal value.
    ``touches_left``/``touches_right``: whether the first/last local element
    touches the domain boundary (a shard of the distributed solve owns a
    boundary element only at an edge of the mesh).
    """
    dtype, device = nodes.dtype, nodes.device
    xl, xr = nodes[..., :-1], nodes[..., 1:]
    h = xr - xl  # [E]
    t = legendre.collocation_points(cfg.n_colloc, dtype=dtype, device=device)
    x_colloc = 0.5 * (xl + xr)[..., None] + 0.5 * h[..., None] * t
    f_colloc = problem.f(x_colloc) * torch.ones_like(x_colloc)  # [E, C]

    u_left = fem_values[..., :-1].clone()
    u_right = fem_values[..., 1:].clone()
    if problem.bc_left == "dirichlet" and touches_left:
        u_left[..., 0] = problem.g_left
    if problem.bc_right == "dirichlet" and touches_right:
        u_right[..., -1] = problem.g_right
    bc = torch.stack([u_left, u_right], dim=-1)  # [E, 2]
    return x_colloc, f_colloc, bc, h, u_left, u_right


def prepare_shared_host(problem: Problem1D, cfg: SolverConfig):
    """Setup-time float64 precompute of the shared affine enhancement map.

    Valid when the mesh is uniform and the operator coefficients are
    x-independent: every element shares one collocation matrix D, so
    (f, bc) -> w is one affine operator, factorised here in numpy f64.
    Returns CPU tensors (``hybrid_solve`` moves them to the run device) or
    None.
    """
    if not problem.constant_coeffs:
        return None
    x0, x1 = problem.domain
    h = (x1 - x0) / (cfg.num_nodes - 1)
    V0, V1, V2 = legendre.collocation_vandermonde_host(cfg.M, cfg.n_colloc)
    t = np.linspace(-1.0, 1.0, cfg.n_colloc)
    xc = x0 + (t + 1.0) * 0.5 * h  # element-0 collocation points
    a2, a1, a0 = (v.numpy() for v in
                  problem.colloc_coeffs(torch.from_numpy(xc)))
    scale = 2.0 / h
    D0 = (
        a2[:, None] * scale**2 * V2
        + a1[:, None] * scale * V1
        + a0[:, None] * V0
    )
    B = np.stack([V0[0], V0[-1]])
    rhs_factors = None
    if problem.f_colloc_factors is not None:
        rhs_factors = problem.f_colloc_factors((t + 1.0) * 0.5 * h)
    dtype = cfg.torch_dtype()
    if cfg.formulation == "dual":
        # The extracted dual operator is accurate to ~1e-3 relative: dtype
        # noise in f32, but it would cap f64 dual accuracy at ~1e-7, so
        # f64 keeps the per-element augmented LU.
        if dtype == torch.float32:
            return kkt.precompute_shared_dual_host(
                D0, B, cfg.gamma, dtype, rhs_colloc_factors=rhs_factors)
        return None
    return kkt.precompute_shared_host(D0, B, cfg.gamma, dtype,
                                      rhs_colloc_factors=rhs_factors)


def _resolve_backend(cfg: SolverConfig, device) -> str:
    device = torch.device(device)
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    if cfg.backend != "auto":
        return cfg.backend
    if device.type == "cuda" and cfg.torch_dtype() == torch.float32:
        return "cuda"
    return "torch"


def _dirichlet_consistent(problem, fem_values):
    """Nodal values with boundary nodes pinned to the Dirichlet data;
    Neumann / Robin ends keep their FEM value."""
    fv = fem_values.clone()
    if problem.bc_left == "dirichlet":
        fv[..., 0] = problem.g_left
    if problem.bc_right == "dirichlet":
        fv[..., -1] = problem.g_right
    return fv


def _kernel_finalize(w, slack, bcv, u_left, u_right, cfg, cond=None):
    """Diagnostics gate + fallback after a fused kernel (JAX
    ``_pallas_finalize``); the tolerance scales with the boundary data."""
    E = w.shape[0]
    if cond is not None:
        cond = cond.expand(E)
    if cfg.diagnostics:
        finite = torch.isfinite(slack) & torch.isfinite(bcv)
        scale = 1.0 + torch.maximum(torch.abs(u_left), torch.abs(u_right))
        ok = finite & (bcv <= 1e-2 * scale)
        diags = kkt.KKTDiagnostics(slack, bcv, ok, cond)
    else:
        ok = torch.all(torch.isfinite(w), dim=-1)
        z = torch.zeros(E, dtype=w.dtype, device=w.device)
        diags = kkt.KKTDiagnostics(z, z, ok, cond)
    return kkt.apply_fallback(w, diags, u_left, u_right), diags


def lssvr_enhance(problem: Problem1D, nodes, fem_values, cfg: SolverConfig,
                  shared_ops=None, uniform_geom=None, touches_left=True,
                  touches_right=True):
    """Batched enhancement of all elements -> (w [E, M], KKTDiagnostics).

    ``touches_left``/``touches_right`` (torch route): whether the first /
    last element touches the domain boundary, as in ``_element_data``.

    ``uniform_geom``: (x0, h) Python floats when the mesh is uniform; with
    the 'cuda' backend it selects the shared-operator kernels (constant
    coefficients) or the uniform mode of the per-element kernel.

    ``nodes`` and ``fem_values`` [P, N] are a family of P meshes (the
    problem's callables then see points with P leading) enhanced as one
    batch of P E elements, on the card in one kernel launch; w is then
    [P, E, M] and the diagnostics [P, E].  Families take per-element
    operators only (``shared_ops`` None).
    """
    E = nodes.shape[-1] - 1  # elements (of each mesh of a family)
    lead = nodes.shape[:-1]
    if lead and shared_ops is not None:
        raise ValueError("a family of meshes takes per-element operators "
                         "(shared_ops=None)")
    backend = _resolve_backend(cfg, nodes.device)
    if (shared_ops is not None and uniform_geom is not None
            and backend == "cuda"):
        x0, h = uniform_geom
        fv = _dirichlet_consistent(problem, fem_values)
        if shared_ops.WfF is not None and problem.f_elem_factors is not None:
            if cfg.diagnostics:
                # Gate + fallback fused in the kernel.
                w, slack, bcv, okf = kernels.fused_enhance_separable(
                    fv, shared_ops, problem.f_elem_factors, x0, h,
                    with_fallback=True,
                )
                cond = None if shared_ops.cond is None else \
                    shared_ops.cond.expand(E)
                return w, kkt.KKTDiagnostics(slack, bcv, okf > 0.5, cond)
            w, slack, bcv = kernels.fused_enhance_separable(
                fv, shared_ops, problem.f_elem_factors, x0, h,
                with_diagnostics=False,
            )
        else:
            w, slack, bcv = kernels.fused_enhance_shared(
                fv, shared_ops, problem.f, x0, h, cfg.n_colloc,
                with_diagnostics=cfg.diagnostics,
                f_shifted_fn=problem.f_shifted,
            )
        return _kernel_finalize(w, slack, bcv, fv[:-1], fv[1:], cfg,
                                cond=shared_ops.cond)
    if (shared_ops is None and cfg.kkt_method in ("auto", "qr")
            and cfg.M >= 3 and backend == "cuda"):
        # Per-element operators: the same null-space CGS2-QR algebra as the
        # torch route below, in one kernel.  Without uniform_geom the
        # kernel runs in graded-mesh mode from the node array.
        fv = _dirichlet_consistent(problem, fem_values).contiguous()
        if uniform_geom is not None:
            x0, h = uniform_geom
            graded_nodes = None
        else:
            x0d, x1d = problem.domain
            x0, h = x0d, (x1d - x0d) / E  # h = reference (mean) width
            graded_nodes = nodes
        host = kernels.VarCoeffOperators.host(
            cfg.M, cfg.n_colloc, h, fv.dtype).to(fv.device)
        w, slack, bcv, cond = kernels.fused_enhance_varcoeff(
            fv, problem, host, x0, h, cfg.n_colloc,
            with_diagnostics=cfg.diagnostics,
            f_shifted_fn=problem.f_shifted, nodes=graded_nodes,
        )
        # Each element's gate and fallback from its own family's values.
        return _unflatten(*_kernel_finalize(
            w, slack, bcv, fv[..., :-1].reshape(-1), fv[..., 1:].reshape(-1),
            cfg, cond=cond), lead)

    x_colloc, f_colloc, bc, h, u_left, u_right = _element_data(
        problem, nodes, fem_values, cfg, touches_left, touches_right)
    if shared_ops is not None:
        w, diags = kkt.solve_primal_shared(shared_ops, f_colloc, bc)
    else:
        dtype, device = nodes.dtype, nodes.device
        V0, V1, V2 = legendre.collocation_vandermonde(
            cfg.M, cfg.n_colloc, dtype, device)
        B = kkt.boundary_rows(V0)
        a2, a1, a0 = problem.colloc_coeffs(x_colloc)  # each [E, C]
        scale = (2.0 / h)[..., None, None]
        D = (
            a2[..., None] * scale**2 * V2
            + a1[..., None] * scale * V1
            + a0[..., None] * V0
        )
        V0h, _, _ = legendre.collocation_vandermonde_host(cfg.M,
                                                          cfg.n_colloc)
        Z_np, Pbc_np = kkt.nullspace_host(np.stack([V0h[0], V0h[-1]]))
        ZP = (torch.as_tensor(Z_np, dtype=dtype, device=device),
              torch.as_tensor(Pbc_np, dtype=dtype, device=device))
        C, M = D.shape[-2:]
        w, diags = kkt.solve_batched(
            D.reshape(-1, C, M), B, f_colloc.reshape(-1, C),
            bc.reshape(-1, 2), cfg.gamma,
            formulation=cfg.formulation, method=cfg.kkt_method,
            refine_steps=cfg.refine_steps, ZP=ZP,
        )
    return _unflatten(kkt.apply_fallback(w, diags, u_left.reshape(-1),
                                         u_right.reshape(-1)), diags, lead)


def _unflatten(w, diags, lead):
    """(w [..., E, M], diagnostics [..., E]) from a batch of P E elements."""
    if not lead:
        return w, diags
    return (w.reshape(*lead, -1, w.shape[-1]), kkt.KKTDiagnostics(
        *(None if v is None else v.reshape(*lead, -1) for v in diags)))


def hybrid_solve(problem: Problem1D, cfg: SolverConfig, nodes: torch.Tensor,
                 shared_ops=None, uniform: bool = False,
                 device=None) -> Solution:
    """Coarse FEM then batched LSSVR enhancement.

    ``shared_ops`` (from ``prepare_shared_host``) requires a uniform mesh;
    ``uniform=True`` asserts uniformity for variable-coefficient problems
    too.  ``nodes`` and ``shared_ops`` are moved to ``device`` first (None:
    the GPU; a machine without one raises — pass ``device='cpu'``).
    """
    nodes = nodes.to(resolve_device(device))
    if shared_ops is not None:
        shared_ops = shared_ops.to(nodes.device)
    if cfg.fem_dtype is not None:
        fd = getattr(torch, cfg.fem_dtype)
        fem_values = fem_solve(problem, nodes.to(fd), cfg).to(nodes.dtype)
    else:
        fem_values = fem_solve(problem, nodes, cfg)
    x0, x1 = problem.domain
    geom = (x0, (x1 - x0) / (cfg.num_nodes - 1)) \
        if (shared_ops is not None or uniform) else None
    with _span("lssvr_enhance"):
        w, diags = lssvr_enhance(problem, nodes, fem_values, cfg,
                                 shared_ops=shared_ops, uniform_geom=geom)
    return Solution(
        nodes=nodes,
        fem_values=fem_values,
        coeffs=w,
        max_slack=diags.max_slack,
        bc_violation=diags.bc_violation,
        solve_ok=diags.solve_ok,
        cond_estimate=diags.cond_estimate,
    )


def hybrid_solve_general(problem: Problem1D, cfg: SolverConfig,
                         nodes: torch.Tensor, device=None) -> Solution:
    """Non-uniform-mesh path: always per-element operators."""
    return hybrid_solve(problem, cfg, nodes, shared_ops=None, device=device)


def sweep_solve(problem: Problem1D, cfgs, device=None) -> list:
    """Solve several configurations one after another; on a GPU the host
    precompute of config k+1 overlaps the device work of config k, since
    nothing here synchronises."""
    device = resolve_device(device)
    sols = []
    for cfg in cfgs:
        shared = prepare_shared_host(problem, cfg)
        nodes = uniform_nodes(problem, cfg.num_nodes, cfg.torch_dtype(),
                              device)
        sols.append(hybrid_solve(problem, cfg, nodes, shared, uniform=True,
                                 device=device))
    return sols


def _interp(x, xp, fp):
    """np.interp / jnp.interp for strictly increasing xp."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    f = fp[i - 1] + ((x - xp[i - 1]) / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class HybridSolver:
    """Stateful facade with the reference class's API shape.

    ``device`` is where the whole solve runs: the GPU by default (a machine
    without one raises), the CPU only on ``device='cpu'``.
    """

    def __init__(self, problem: Problem1D,
                 config: SolverConfig = SolverConfig(), nodes=None,
                 device=None):
        self.problem = problem
        self.config = config
        self.device = resolve_device(device)
        if nodes is not None:
            if not isinstance(nodes, torch.Tensor):
                nodes = torch.as_tensor(nodes, dtype=config.torch_dtype())
            nodes = nodes.to(self.device)
        self._custom_nodes = nodes
        self.solution: Optional[Solution] = None

    @property
    def nodes(self):
        if self._custom_nodes is not None:
            return self._custom_nodes
        return uniform_nodes(self.problem, self.config.num_nodes,
                             self.config.torch_dtype(), self.device)

    def solve(self) -> Solution:
        if self._custom_nodes is not None:
            self.solution = hybrid_solve_general(
                self.problem, self.config, self._custom_nodes,
                device=self.device)
        else:
            with _span("prepare_shared_host"):
                shared = prepare_shared_host(self.problem, self.config)
            self.solution = hybrid_solve(
                self.problem, self.config, self.nodes, shared, uniform=True,
                device=self.device)
        return self.solution

    @property
    def fem_nodes(self):
        return self.solution.nodes if self.solution else None

    @property
    def fem_values(self):
        return self.solution.fem_values if self.solution else None

    def _points(self, x_points):
        return torch.as_tensor(x_points, dtype=self.solution.nodes.dtype,
                               device=self.device)

    def evaluate_solution(self, x_points):
        if self.solution is None:
            raise RuntimeError("call solve() first")
        x = self._points(x_points)
        with _span("evaluate_solution"):
            if self._custom_nodes is None:
                x0, x1 = self.problem.domain
                h = (x1 - x0) / (self.config.num_nodes - 1)
                return ops_eval.evaluate_uniform(x0, h, self.solution.coeffs,
                                                 x)
            return ops_eval.evaluate(self.solution.nodes,
                                     self.solution.coeffs, x)

    def evaluate_fem(self, x_points):
        """Piecewise-linear coarse solution (for FEM-vs-hybrid comparisons)."""
        if self.solution is None:
            raise RuntimeError("call solve() first")
        return _interp(self._points(x_points), self.solution.nodes,
                       self.solution.fem_values)

    def errors(self, x_points):
        """(linf, l2) of the hybrid solution vs the problem's exact oracle."""
        from ..utils import metrics

        if self.problem.exact is None:
            raise ValueError(f"problem {self.problem.name} has no exact "
                             f"solution")
        u = self.evaluate_solution(x_points)
        ue = self.problem.exact(self._points(x_points))
        return metrics.linf_error(u, ue), metrics.l2_error(u, ue)
