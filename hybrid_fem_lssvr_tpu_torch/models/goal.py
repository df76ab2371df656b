"""Goal-oriented (dual-weighted-residual) adaptivity in 1D, 2D and 3D.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/goal.py``, where the
identity is derived in full.  For L u = -(a u')' + b u' + c u = f with
Dirichlet data matched at the domain ends, the adjoint problem is

    L* z = -(a z')' - (b z)' + c z = j,    z(x0) = z(x1) = 0,

and, because the enhanced solution u_h is continuous while u_h' jumps at
the faces, integration by parts gives

    J(u) - J(u_h) = sum_e  int_e R(u_h) z
                  + sum_i  z(x_i) a(x_i) [u_h'](x_i),

with R(u_h) = f - L u_h the strong residual and [u_h'] the face jump of the
derivative.  Both terms come from the per-element Legendre series (R at
Gauss points, the jumps from V'(+-1)); z ~ z_h is the enhanced adjoint.
The signed cell terms plus half of each adjacent face term drive
refinement; their sum is the goal-error estimate.

In 2D and 3D the weight z is solved on a once- or twice-bisected mesh (an
equal-mesh adjoint has its largest error on the primal element edges where
the edge terms sample it) and read pointwise on the graded mesh.  The
semilinear family (``models/nonlinear.py``) takes the linearised adjoint
-a0 z'' + s'(u_h) z = j.

Every contraction runs in the run dtype with no reduced-precision matmul
(the JAX package's ``precision=HIGHEST``): float64 on a CPU, float32 on the
GPU with TF32 off (``torch.backends.cuda.matmul.allow_tf32``, False by
default).  The adjoint solves go through the ordinary hybrid pipeline, so
on a CUDA float32 run they take its kernels.  Entry points run on the GPU
unless given ``device='cpu'``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import eval as ops_eval
from ..ops import legendre
from .adaptive import refine_nodes, uniform_nodes_host
from .hybrid import HybridSolver, Solution, SolverConfig
from .hybrid2d import Problem2D, Solution2D
from .hybrid2d_graded import (HybridSolver2DGraded, evaluate_2d_graded,
                              refine_axis)
from .hybrid3d import Problem3D, Solution3D
from .hybrid3d_graded import HybridSolver3DGraded, evaluate_3d_graded
from .problem import Problem1D


def _derivative(fn):
    """x -> d fn / dx elementwise, by autograd (``fn + 0 x`` keeps x in the
    graph when fn is constant)."""
    def d(x):
        with torch.enable_grad():
            xg = x.detach().clone().requires_grad_(True)
            (g,) = torch.autograd.grad((fn(xg) + 0.0 * xg).sum(), xg)
        return g
    return d


def adjoint_problem(problem: Problem1D, j: Callable,
                    name: Optional[str] = None) -> Problem1D:
    """The adjoint BVP L* z = j with homogeneous Dirichlet data.

    L* keeps the diffusion pair (a, a'), negates the advection b, and
    shifts the reaction c -> c - b' (zero shift when ``constant_coeffs``;
    otherwise b' by autograd).  Only Dirichlet-Dirichlet primal problems
    are supported: the DWR identity pins z = 0 at the ends."""
    if problem.bc_left != "dirichlet" or problem.bc_right != "dirichlet":
        raise ValueError(
            "goal-oriented adaptivity needs Dirichlet-Dirichlet problems "
            f"(got {problem.bc_left}/{problem.bc_right})")
    b = problem.b
    if problem.constant_coeffs:
        c_adj = problem.c
    else:
        db = _derivative(b)
        c_orig = problem.c

        def c_adj(x):
            return c_orig(x) - db(x)
    return Problem1D(
        name=name or f"adjoint({problem.name})",
        f=j,
        a=problem.a,
        da=problem.da,
        b=lambda x: -b(x),
        c=c_adj,
        domain=problem.domain,
        g_left=0.0,
        g_right=0.0,
        constant_coeffs=problem.constant_coeffs,
    )


def _gauss(q: int, dtype, device):
    tq, wq = np.polynomial.legendre.leggauss(q)  # host float64
    return (torch.as_tensor(tq, dtype=dtype, device=device),
            torch.as_tensor(wq, dtype=dtype, device=device))


def _series_on_gauss(nodes, coeffs, tq):
    """(x, u, ux, uxx) of the element Legendre series at the mapped Gauss
    points, [E, q] each."""
    M = coeffs.shape[1]
    V0, V1, V2 = legendre.legendre_vandermonde(tq, M)
    xl = nodes[:-1]
    h = nodes[1:] - nodes[:-1]
    x = xl[:, None] + 0.5 * (tq + 1.0)[None, :] * h[:, None]
    chain = (2.0 / h)[:, None]
    return (x, coeffs @ V0.T, chain * (coeffs @ V1.T),
            chain * chain * (coeffs @ V2.T))


def goal_value(nodes, coeffs, j: Callable, q: int = 8):
    """J(u_h) = int j u_h by per-element Gauss quadrature."""
    tq, wq = _gauss(q, coeffs.dtype, coeffs.device)
    x, u, _, _ = _series_on_gauss(nodes, coeffs, tq)
    h = nodes[1:] - nodes[:-1]
    return torch.sum(0.5 * h * ((j(x) * u) @ wq))


class DWREstimate(NamedTuple):
    total: torch.Tensor  # scalar signed estimate of J(u) - J(u_h)
    cell: torch.Tensor  # [E] signed cell residual terms
    face: torch.Tensor  # [E-1] signed interior-face jump terms
    indicator: torch.Tensor  # [E] refinement indicator (|cell| + half faces)


def _face_terms_1d(nodes, coeffs, zc, a_face):
    """Interior-face terms z a [u_h'] (u_h' from the right element at t = -1
    minus the left element's at t = +1; z from the left element)."""
    M = coeffs.shape[1]
    h = nodes[1:] - nodes[:-1]
    ends = torch.tensor([-1.0, 1.0], dtype=coeffs.dtype, device=coeffs.device)
    V0e, V1e = legendre.legendre_vandermonde(ends, M, num_derivs=1)
    ux_ends = (2.0 / h)[:, None] * (coeffs @ V1e.T)  # [E, 2]
    z_ends = zc @ V0e.T
    jump = ux_ends[1:, 0] - ux_ends[:-1, 1]  # [E-1]
    return z_ends[:-1, 1] * a_face * jump


def _dwr_1d(cell, face):
    half = 0.5 * torch.abs(face)
    indicator = torch.abs(cell).clone()
    indicator[:-1] += half
    indicator[1:] += half
    return DWREstimate(total=torch.sum(cell) + torch.sum(face), cell=cell,
                       face=face, indicator=indicator)


def dwr_estimate(problem: Problem1D, primal: Solution, adjoint: Solution,
                 q: int = 8) -> DWREstimate:
    """Dual-weighted residual estimate of J(u) - J(u_h) (module docstring).
    ``primal`` and ``adjoint`` must share ``nodes`` (the same mesh)."""
    nodes, coeffs, zc = primal.nodes, primal.coeffs, adjoint.coeffs
    tq, wq = _gauss(q, coeffs.dtype, coeffs.device)
    x, u, ux, uxx = _series_on_gauss(nodes, coeffs, tq)
    a2, a1, a0 = problem.colloc_coeffs(x)
    R = problem.f(x) * torch.ones_like(x) - (a2 * uxx + a1 * ux + a0 * u)
    _, z, _, _ = _series_on_gauss(nodes, zc, tq)
    h = nodes[1:] - nodes[:-1]
    cell = 0.5 * h * ((R * z) @ wq)
    xi = nodes[1:-1]
    face = _face_terms_1d(nodes, coeffs, zc,
                          problem.a(xi) * torch.ones_like(xi))
    return _dwr_1d(cell, face)


class GoalAdaptiveResult(NamedTuple):
    solution: Solution
    adjoint: Solution
    nodes: torch.Tensor
    history: List[dict]  # per-round {elements, goal, est_error, ...}


def goal_adaptive_solve(problem: Problem1D, j: Callable, cfg: SolverConfig,
                        rounds: int = 4, refine_frac: float = 0.3,
                        exact_goal: Optional[float] = None, q: int = 8,
                        device=None) -> GoalAdaptiveResult:
    """Solve-estimate-refine driven by the |DWR| indicators.

    Each round solves primal and adjoint on the current mesh through the
    full hybrid pipeline, computes J(u_h), the signed estimate and the
    per-element indicators, then bisects the worst ``refine_frac`` of
    elements (``adaptive.refine_nodes``, on the host)."""
    adj = adjoint_problem(problem, j)
    nodes = uniform_nodes_host(problem.domain, cfg.num_nodes,
                               cfg.torch_dtype())
    history: List[dict] = []
    psol = asol = None
    for r in range(rounds + 1):
        tn = torch.as_tensor(nodes)
        psolver = HybridSolver(problem, cfg, nodes=tn, device=device)
        psol = psolver.solve()
        asol = HybridSolver(adj, cfg, nodes=tn, device=device).solve()
        est = dwr_estimate(problem, psol, asol, q=q)
        goal = goal_value(psol.nodes, psol.coeffs, j, q=q)
        rec = {
            "round": r,
            "elements": int(psol.coeffs.shape[0]),
            "goal": float(goal),
            "est_error": float(est.total),
        }
        if exact_goal is not None:
            rec["true_error"] = float(exact_goal) - rec["goal"]
        history.append(rec)
        if r == rounds:
            break
        nodes = refine_nodes(nodes, est.indicator.detach().cpu().numpy(),
                             refine_frac)
    return GoalAdaptiveResult(solution=psol, adjoint=asol,
                              nodes=torch.as_tensor(nodes,
                                                    device=psol.nodes.device),
                              history=history)


# --------------------------------------------------------------------- 2D
#
# The same identity on the structured-quad mesh, with the interior-edge
# flux-jump terms int_e z a [du_h/dn]; the [u_h] and (u_h - g) terms are of
# the size of the bc violation and dropped, as in the JAX package.


def adjoint_problem_2d(problem: Problem2D, j: Callable,
                       name: Optional[str] = None) -> Problem2D:
    """Adjoint BVP on the same domain: b -> -b (constant, so the reaction
    is unchanged), variable diffusion carried as is (self-adjoint)."""
    if any(bc != "dirichlet" for bc in problem.bc_edges):
        raise ValueError(
            "2D goal-oriented adaptivity needs all-Dirichlet problems "
            f"(got {problem.bc_edges})")
    bx, by = problem.b
    return Problem2D(
        name=name or f"adjoint({problem.name})",
        f=j,
        g=lambda x, y: torch.zeros_like(x + y),
        domain=problem.domain,
        a0=problem.a0,
        c=problem.c,
        b=(-bx, -by),
        a_var=problem.a_var,
        grad_a=problem.grad_a,
    )


def _gauss_points(nodes, tq):
    """[n, q]: the Gauss points of each interval of a node array."""
    h = nodes[1:] - nodes[:-1]
    return nodes[:-1, None] + 0.5 * (tq + 1.0)[None, :] * h[:, None]


def _tensor_series_on_gauss(sol: Solution2D, tq):
    """(x, y, u, ux, uy, uxx, uyy) at the tensor Gauss grid, [ny, nx, qy,
    qx] each."""
    xs, ys, Cf = sol.xs, sol.ys, sol.coeffs
    M = Cf.shape[-1]
    V0, V1, V2 = legendre.legendre_vandermonde(tq, M)
    cx = (2.0 / (xs[1:] - xs[:-1]))[None, :, None, None]
    cy = (2.0 / (ys[1:] - ys[:-1]))[:, None, None, None]

    def con(Vy, Vx):
        return torch.einsum("YXkl,pk,ql->YXpq", Cf, Vy, Vx)

    x = _gauss_points(xs, tq)[None, :, None, :]
    y = _gauss_points(ys, tq)[:, None, :, None]
    return (x, y, con(V0, V0), cx * con(V0, V1), cy * con(V1, V0),
            cx * cx * con(V0, V2), cy * cy * con(V2, V0))


def _edge_traces(sol: Solution2D, tq):
    """Element values and normal derivatives on the 4 element edges at the
    along-edge Gauss points: (u_xe, ux_xe, u_ye, uy_ye), u_xe[Y, X, s, p]
    the trace at the x-end s in {left, right}, p along y (and the same for
    the y-ends)."""
    xs, ys, Cf = sol.xs, sol.ys, sol.coeffs
    M = Cf.shape[-1]
    V0, _ = legendre.legendre_vandermonde(tq, M, num_derivs=1)
    ends = torch.tensor([-1.0, 1.0], dtype=Cf.dtype, device=Cf.device)
    E0, E1 = legendre.legendre_vandermonde(ends, M, num_derivs=1)
    hx = xs[1:] - xs[:-1]
    hy = ys[1:] - ys[:-1]
    u_xe = torch.einsum("YXkl,pk,sl->YXsp", Cf, V0, E0)
    ux_xe = (2.0 / hx)[None, :, None, None] * torch.einsum(
        "YXkl,pk,sl->YXsp", Cf, V0, E1)
    u_ye = torch.einsum("YXkl,sk,ql->YXsq", Cf, E0, V0)
    uy_ye = (2.0 / hy)[:, None, None, None] * torch.einsum(
        "YXkl,sk,ql->YXsq", Cf, E1, V0)
    return u_xe, ux_xe, u_ye, uy_ye


def goal_value_2d(sol: Solution2D, j: Callable, q: int = 8):
    """J(u_h) = int j u_h by tensor Gauss quadrature per element."""
    tq, wq = _gauss(q, sol.coeffs.dtype, sol.coeffs.device)
    x, y, u, *_ = _tensor_series_on_gauss(sol, tq)
    hx = sol.xs[1:] - sol.xs[:-1]
    hy = sol.ys[1:] - sol.ys[:-1]
    area4 = 0.25 * hy[:, None] * hx[None, :]
    cell = torch.einsum("YXpq,p,q->YX", j(x, y) * u, wq, wq)
    return torch.sum(area4 * cell)


class DWREstimate2D(NamedTuple):
    total: torch.Tensor  # scalar signed estimate of J(u) - J(u_h)
    cell: torch.Tensor  # [ny, nx] signed cell residual terms
    indicator: torch.Tensor  # [ny, nx] |cell| + half adjacent edge terms


def _coefficient_fns_2d(problem: Problem2D):
    if problem.a_var is not None:
        ax_fn, ay_fn = problem.grad_a
        return problem.a_var, ax_fn, ay_fn

    def a_fn(x, y):
        return problem.a0 * torch.ones_like(x + y)

    def zero(x, y):
        return torch.zeros_like(x + y)

    return a_fn, zero, zero


def dwr_estimate_2d(problem: Problem2D, primal: Solution2D,
                    adjoint: Solution2D, q: int = 8) -> DWREstimate2D:
    """Dual-weighted residual estimate on the (possibly graded) quad mesh.

    ``adjoint`` may live on any mesh of the same domain and should be a
    once- or twice-bisected refinement of the primal mesh; its value is
    read pointwise (``evaluate_2d_graded``)."""
    xs, ys = primal.xs, primal.ys
    tq, wq = _gauss(q, primal.coeffs.dtype, primal.coeffs.device)
    hx = xs[1:] - xs[:-1]
    hy = ys[1:] - ys[:-1]
    bx, by = problem.b
    a_fn, ax_fn, ay_fn = _coefficient_fns_2d(problem)

    # Cell residual terms, z sampled from the (finer) adjoint solution.
    x, y, u, ux, uy, uxx, uyy = _tensor_series_on_gauss(primal, tq)
    ones = torch.ones_like(u)
    a = a_fn(x, y) * ones
    R = (problem.f(x, y) * ones
         - (-(a * (uxx + uyy) + ax_fn(x, y) * ux + ay_fn(x, y) * uy)
            + bx * ux + by * uy + problem.c * u))
    z = evaluate_2d_graded(adjoint, (x * ones).reshape(-1),
                           (y * ones).reshape(-1)).reshape(u.shape)
    area4 = 0.25 * hy[:, None] * hx[None, :]
    cell = area4 * torch.einsum("YXpq,p,q->YX", R * z, wq, wq)

    # Interior-edge flux-jump terms int_e z a [du_h/dn].
    _, ux_xe, _, uy_ye = _edge_traces(primal, tq)
    ypts, xpts = _gauss_points(ys, tq), _gauss_points(xs, tq)
    ny, nx = cell.shape

    # Vertical edges i = 1..nx-1 (normal +x): z at (xs[i], ypts[Y, :]).
    xv = xs[1:-1][None, :, None].expand(ny, nx - 1, q)
    yv = ypts[:, None, :].expand(ny, nx - 1, q)
    zv = evaluate_2d_graded(adjoint, xv.reshape(-1),
                            yv.reshape(-1)).reshape(ny, nx - 1, q)
    a_v = a_fn(xv, yv) * torch.ones_like(zv)
    jump_v = ux_xe[:, 1:, 0] - ux_xe[:, :-1, 1]
    Fv = 0.5 * hy[:, None] * ((zv * a_v * jump_v) @ wq)  # [ny, nx-1]

    # Horizontal edges (normal +y): z at (xpts[X, :], ys[i]).
    xh = xpts[None, :, :].expand(ny - 1, nx, q)
    yh = ys[1:-1][:, None, None].expand(ny - 1, nx, q)
    zh = evaluate_2d_graded(adjoint, xh.reshape(-1),
                            yh.reshape(-1)).reshape(ny - 1, nx, q)
    a_h = a_fn(xh, yh) * torch.ones_like(zh)
    jump_h = uy_ye[1:, :, 0] - uy_ye[:-1, :, 1]
    Fh = 0.5 * hx[None, :] * ((zh * a_h * jump_h) @ wq)  # [ny-1, nx]

    total = torch.sum(cell) + torch.sum(Fv) + torch.sum(Fh)
    halfv, halfh = 0.5 * torch.abs(Fv), 0.5 * torch.abs(Fh)
    indicator = torch.abs(cell).clone()
    indicator[:, :-1] += halfv
    indicator[:, 1:] += halfv
    indicator[:-1, :] += halfh
    indicator[1:, :] += halfh
    return DWREstimate2D(total=total, cell=cell, indicator=indicator)


def _bisect(nodes: np.ndarray, levels: int = 1) -> np.ndarray:
    """Insert interval midpoints ``levels`` times (keeps the grading)."""
    for _ in range(levels):
        nodes = np.sort(np.concatenate(
            [nodes, 0.5 * (nodes[1:] + nodes[:-1])]))
    return nodes


class GoalAdaptiveResult2D(NamedTuple):
    solution: Solution2D
    adjoint: Solution2D
    xs: np.ndarray
    ys: np.ndarray
    history: List[dict]


def _goal_record(r, est, goal, exact_goal):
    rec = {"round": r, "elements": int(est.cell.numel()),
           "goal": float(goal), "est_error": float(est.total)}
    if exact_goal is not None:
        rec["true_error"] = float(exact_goal) - rec["goal"]
    return rec


def goal_adaptive_solve_2d(problem: Problem2D, j: Callable, cfg,
                           rounds: int = 3, refine_frac: float = 0.3,
                           exact_goal: Optional[float] = None, q: int = 8,
                           adjoint_zoom: int = 1,
                           device=None) -> GoalAdaptiveResult2D:
    """Tensor-product goal-oriented adaptivity: per round a primal solve on
    the current graded mesh and an adjoint solve on its
    ``adjoint_zoom``-times-bisected refinement (both through
    ``HybridSolver2DGraded``); the DWR indicators summed along strips drive
    the per-axis bisection (``hybrid2d_graded.refine_axis``)."""
    adj = adjoint_problem_2d(problem, j)
    x0, x1, y0, y1 = problem.domain
    xs = np.linspace(x0, x1, cfg.nx + 1)
    ys = np.linspace(y0, y1, cfg.ny + 1)
    history: List[dict] = []
    psolver = asolver = None
    for r in range(rounds + 1):
        psolver = HybridSolver2DGraded(problem, cfg, xs, ys, device=device)
        psol = psolver.solve()
        asolver = HybridSolver2DGraded(adj, cfg, _bisect(xs, adjoint_zoom),
                                       _bisect(ys, adjoint_zoom),
                                       device=device)
        asol = asolver.solve()
        est = dwr_estimate_2d(problem, psol, asol, q=q)
        history.append(_goal_record(r, est, goal_value_2d(psol, j, q=q),
                                    exact_goal))
        if r == rounds:
            break
        ind = est.indicator.detach().cpu().numpy()
        xs = refine_axis(xs, ind.sum(axis=0), refine_frac)
        ys = refine_axis(ys, ind.sum(axis=1), refine_frac)
    return GoalAdaptiveResult2D(solution=psolver.solution,
                                adjoint=asolver.solution, xs=xs, ys=ys,
                                history=history)


# --------------------------------------------------------------------- 3D
#
# The tensor lift of the 2D estimator to structured hexes: cell residuals at
# the tensor Gauss grid, face flux-jump terms int_F z a [du_h/dn] on the
# three interior-face families, z from an adjoint on a bisected mesh.


def adjoint_problem_3d(problem: Problem3D, j: Callable,
                       name: Optional[str] = None) -> Problem3D:
    """Adjoint BVP: b -> -b (constant advection), diffusion and reaction
    carried as is (self-adjoint)."""
    if any(bc != "dirichlet" for bc in problem.bc_faces):
        raise ValueError(
            "3D goal-oriented adaptivity needs all-Dirichlet problems "
            f"(got {problem.bc_faces})")
    bx, by, bz = problem.b
    return Problem3D(
        name=name or f"adjoint({problem.name})",
        f=j,
        g=lambda x, y, z: torch.zeros_like(x + y + z),
        domain=problem.domain,
        a0=problem.a0,
        c=problem.c,
        b=(-bx, -by, -bz),
        a_var=problem.a_var,
        grad_a=problem.grad_a,
    )


def _tensor_series_on_gauss_3d(sol: Solution3D, tq):
    """(x, y, z, u, ux, uy, uz, lap) at the tensor Gauss grid, each [nz, ny,
    nx, qz, qy, qx]."""
    xs, ys, zs, Cf = sol.xs, sol.ys, sol.zs, sol.coeffs
    M = Cf.shape[-1]
    V0, V1, V2 = legendre.legendre_vandermonde(tq, M)
    cx = (2.0 / (xs[1:] - xs[:-1]))[None, None, :, None, None, None]
    cy = (2.0 / (ys[1:] - ys[:-1]))[None, :, None, None, None, None]
    cz = (2.0 / (zs[1:] - zs[:-1]))[:, None, None, None, None, None]

    def con(Vz, Vy, Vx):
        return torch.einsum("ZYXabc,pa,qb,rc->ZYXpqr", Cf, Vz, Vy, Vx)

    x = _gauss_points(xs, tq)[None, None, :, None, None, :]
    y = _gauss_points(ys, tq)[None, :, None, None, :, None]
    z = _gauss_points(zs, tq)[:, None, None, :, None, None]
    u = con(V0, V0, V0)
    ux = cx * con(V0, V0, V1)
    uy = cy * con(V0, V1, V0)
    uz = cz * con(V1, V0, V0)
    lap = (cx * cx * con(V0, V0, V2) + cy * cy * con(V0, V2, V0)
           + cz * cz * con(V2, V0, V0))
    return x, y, z, u, ux, uy, uz, lap


def _hex_volumes8(sol: Solution3D):
    hx = sol.xs[1:] - sol.xs[:-1]
    hy = sol.ys[1:] - sol.ys[:-1]
    hz = sol.zs[1:] - sol.zs[:-1]
    return 0.125 * (hz[:, None, None] * hy[None, :, None]
                    * hx[None, None, :])


def goal_value_3d(sol: Solution3D, j: Callable, q: int = 6):
    """J(u_h) = int j u_h by tensor Gauss quadrature per hex."""
    tq, wq = _gauss(q, sol.coeffs.dtype, sol.coeffs.device)
    x, y, z, u, *_ = _tensor_series_on_gauss_3d(sol, tq)
    cell = torch.einsum("ZYXpqr,p,q,r->ZYX",
                        j(x, y, z) * torch.ones_like(u) * u, wq, wq, wq)
    return torch.sum(_hex_volumes8(sol) * cell)


def _face_normal_derivs_3d(sol: Solution3D, tq):
    """Normal derivatives of the element series on its 6 faces at the face
    tensor Gauss points: (ux_f, uy_f, uz_f), ux_f[Z, Y, X, s, pz, py] at
    the x-end s (and cyclically)."""
    xs, ys, zs, Cf = sol.xs, sol.ys, sol.zs, sol.coeffs
    M = Cf.shape[-1]
    V0, _ = legendre.legendre_vandermonde(tq, M, num_derivs=1)
    ends = torch.tensor([-1.0, 1.0], dtype=Cf.dtype, device=Cf.device)
    _, E1 = legendre.legendre_vandermonde(ends, M, num_derivs=1)
    hx = xs[1:] - xs[:-1]
    hy = ys[1:] - ys[:-1]
    hz = zs[1:] - zs[:-1]
    ux_f = (2.0 / hx)[None, None, :, None, None, None] * torch.einsum(
        "ZYXabc,pa,qb,sc->ZYXspq", Cf, V0, V0, E1)
    uy_f = (2.0 / hy)[None, :, None, None, None, None] * torch.einsum(
        "ZYXabc,pa,sb,qc->ZYXspq", Cf, V0, E1, V0)
    uz_f = (2.0 / hz)[:, None, None, None, None, None] * torch.einsum(
        "ZYXabc,sa,pb,qc->ZYXspq", Cf, E1, V0, V0)
    return ux_f, uy_f, uz_f


class DWREstimate3D(NamedTuple):
    total: torch.Tensor
    cell: torch.Tensor  # [nz, ny, nx]
    indicator: torch.Tensor  # [nz, ny, nx]


def _coefficient_fns_3d(problem: Problem3D):
    if problem.a_var is not None:
        ax_fn, ay_fn, az_fn = problem.grad_a
        return problem.a_var, ax_fn, ay_fn, az_fn

    def a_fn(x, y, z):
        return problem.a0 * torch.ones_like(x + y + z)

    def zero(x, y, z):
        return torch.zeros_like(x + y + z)

    return a_fn, zero, zero, zero


def dwr_estimate_3d(problem: Problem3D, primal: Solution3D,
                    adjoint: Solution3D, q: int = 6) -> DWREstimate3D:
    """3D dual-weighted residual estimate; ``adjoint`` should live on a
    bisected refinement of the primal mesh (see the 2D section)."""
    xs, ys, zs = primal.xs, primal.ys, primal.zs
    tq, wq = _gauss(q, primal.coeffs.dtype, primal.coeffs.device)
    hx = xs[1:] - xs[:-1]
    hy = ys[1:] - ys[:-1]
    hz = zs[1:] - zs[:-1]
    bx, by, bz = problem.b
    a_fn, ax_fn, ay_fn, az_fn = _coefficient_fns_3d(problem)

    x, y, z_, u, ux, uy, uz, lap = _tensor_series_on_gauss_3d(primal, tq)
    ones = torch.ones_like(u)
    a = a_fn(x, y, z_) * ones
    R = (problem.f(x, y, z_) * ones
         - (-(a * lap + ax_fn(x, y, z_) * ux + ay_fn(x, y, z_) * uy
              + az_fn(x, y, z_) * uz)
            + bx * ux + by * uy + bz * uz + problem.c * u))
    zval = evaluate_3d_graded(adjoint, (x * ones).reshape(-1),
                              (y * ones).reshape(-1),
                              (z_ * ones).reshape(-1)).reshape(u.shape)
    cell = _hex_volumes8(primal) * torch.einsum("ZYXpqr,p,q,r->ZYX",
                                                R * zval, wq, wq, wq)

    ux_f, uy_f, uz_f = _face_normal_derivs_3d(primal, tq)
    xpts, ypts, zpts = (_gauss_points(v, tq) for v in (xs, ys, zs))

    def face_sum(jump, w1, w2, xq, yq, zq):
        """int_F z a [du/dn] over one interior-face family; jump and the
        coordinates arrive as [n1, n2, nf, q, q]."""
        zv = evaluate_3d_graded(adjoint, xq.reshape(-1), yq.reshape(-1),
                                zq.reshape(-1)).reshape(jump.shape)
        av = a_fn(xq, yq, zq) * torch.ones_like(jump)
        return 0.25 * w1 * w2 * torch.einsum("ZYXpq,p,q->ZYX",
                                             zv * av * jump, wq, wq)

    # x-normal interior faces i=1..nx-1: points (xs[i], ypts, zpts).
    jx = ux_f[:, :, 1:, 0] - ux_f[:, :, :-1, 1]  # [nz, ny, nx-1, qz, qy]
    Fx = face_sum(jx, hz[:, None, None], hy[None, :, None],
                  xs[1:-1][None, None, :, None, None].expand(jx.shape),
                  ypts[None, :, None, None, :].expand(jx.shape),
                  zpts[:, None, None, :, None].expand(jx.shape))
    # y-normal interior faces: points (xpts, ys[i], zpts).
    jy = uy_f[:, 1:, :, 0] - uy_f[:, :-1, :, 1]  # [nz, ny-1, nx, qz, qx]
    Fy = face_sum(jy, hz[:, None, None], hx[None, None, :],
                  xpts[None, None, :, None, :].expand(jy.shape),
                  ys[1:-1][None, :, None, None, None].expand(jy.shape),
                  zpts[:, None, None, :, None].expand(jy.shape))
    # z-normal interior faces: points (xpts, ypts, zs[i]).
    jz = uz_f[1:, :, :, 0] - uz_f[:-1, :, :, 1]  # [nz-1, ny, nx, qy, qx]
    Fz = face_sum(jz, hy[None, :, None], hx[None, None, :],
                  xpts[None, None, :, None, :].expand(jz.shape),
                  ypts[None, :, None, :, None].expand(jz.shape),
                  zs[1:-1][:, None, None, None, None].expand(jz.shape))

    total = torch.sum(cell) + torch.sum(Fx) + torch.sum(Fy) + torch.sum(Fz)
    hfx, hfy, hfz = (0.5 * torch.abs(F) for F in (Fx, Fy, Fz))
    indicator = torch.abs(cell).clone()
    indicator[:, :, :-1] += hfx
    indicator[:, :, 1:] += hfx
    indicator[:, :-1, :] += hfy
    indicator[:, 1:, :] += hfy
    indicator[:-1, :, :] += hfz
    indicator[1:, :, :] += hfz
    return DWREstimate3D(total=total, cell=cell, indicator=indicator)


class GoalAdaptiveResult3D(NamedTuple):
    solution: Solution3D
    adjoint: Solution3D
    xs: np.ndarray
    ys: np.ndarray
    zs: np.ndarray
    history: List[dict]


def goal_adaptive_solve_3d(problem: Problem3D, j: Callable, cfg,
                           rounds: int = 2, refine_frac: float = 0.3,
                           exact_goal: Optional[float] = None, q: int = 6,
                           adjoint_zoom: int = 1,
                           device=None) -> GoalAdaptiveResult3D:
    """3D goal-oriented tensor-product adaptivity (the 2D loop on
    ``HybridSolver3DGraded``; the bisected adjoint costs 8x the primal per
    zoom level)."""
    adj = adjoint_problem_3d(problem, j)
    x0, x1, y0, y1, z0, z1 = problem.domain
    xs = np.linspace(x0, x1, cfg.nx + 1)
    ys = np.linspace(y0, y1, cfg.ny + 1)
    zs = np.linspace(z0, z1, cfg.nz + 1)
    history: List[dict] = []
    psolver = asolver = None
    for r in range(rounds + 1):
        psolver = HybridSolver3DGraded(problem, cfg, xs, ys, zs,
                                       device=device)
        psol = psolver.solve()
        asolver = HybridSolver3DGraded(
            adj, cfg, _bisect(xs, adjoint_zoom), _bisect(ys, adjoint_zoom),
            _bisect(zs, adjoint_zoom), device=device)
        asol = asolver.solve()
        est = dwr_estimate_3d(problem, psol, asol, q=q)
        history.append(_goal_record(r, est, goal_value_3d(psol, j, q=q),
                                    exact_goal))
        if r == rounds:
            break
        ind = est.indicator.detach().cpu().numpy()
        xs = refine_axis(xs, ind.sum(axis=(0, 1)), refine_frac)
        ys = refine_axis(ys, ind.sum(axis=(0, 2)), refine_frac)
        zs = refine_axis(zs, ind.sum(axis=(1, 2)), refine_frac)
    return GoalAdaptiveResult3D(solution=psolver.solution,
                                adjoint=asolver.solution, xs=xs, ys=ys,
                                zs=zs, history=history)


# ------------------------------------------------------- semilinear (1D)
#
# The first-order adjoint of -a0 u'' + s(u) = f is the linearised operator
# at the computed solution, -a0 z'' + s'(u_h) z = j with z = 0 at the ends,
# solved through the linear hybrid pipeline with c(x) = s'(u_h(x)) read from
# the element polynomials; R = f + a0 u_h'' - s(u_h).


def adjoint_problem_semilinear(problem, sol, j: Callable) -> Problem1D:
    """Linearised adjoint BVP of a ``SemilinearProblem1D`` at the computed
    ``SemilinearSolution``."""
    ds = problem.ds
    nodes, coeffs = sol.nodes, sol.coeffs

    def c_lin(x):
        return ds(ops_eval.evaluate(nodes, coeffs, torch.atleast_1d(x)))

    a0 = problem.a0
    return Problem1D(
        name=f"adjoint({problem.name})",
        f=j,
        a=lambda x: a0 * torch.ones_like(x),
        c=c_lin,
        domain=problem.domain,
        g_left=0.0,
        g_right=0.0,
    )


def dwr_estimate_semilinear(problem, primal, adjoint: Solution,
                            q: int = 8) -> DWREstimate:
    """DWR estimate for a semilinear solve: cell residuals
    R = f + a0 u'' - s(u) at the Gauss points plus the face flux-jump terms
    (``adjoint`` from ``adjoint_problem_semilinear`` on the same mesh)."""
    nodes, coeffs, zc = primal.nodes, primal.coeffs, adjoint.coeffs
    tq, wq = _gauss(q, coeffs.dtype, coeffs.device)
    x, u, ux, uxx = _series_on_gauss(nodes, coeffs, tq)
    R = problem.f(x) * torch.ones_like(x) + problem.a0 * uxx - problem.s(u)
    _, z, _, _ = _series_on_gauss(nodes, zc, tq)
    h = nodes[1:] - nodes[:-1]
    cell = 0.5 * h * ((R * z) @ wq)
    return _dwr_1d(cell, _face_terms_1d(nodes, coeffs, zc, problem.a0))


def goal_error_semilinear(problem, sol, cfg, j: Callable, q: int = 8,
                          device=None):
    """One-call goal-error estimate for a semilinear solve: the linearised
    adjoint through the linear hybrid pipeline on the same (uniform) mesh.
    Returns (J(u_h), DWREstimate, adjoint Solution)."""
    adj = adjoint_problem_semilinear(problem, sol, j)
    asol = HybridSolver(adj, cfg, nodes=sol.nodes,
                        device=sol.nodes.device if device is None
                        else device).solve()
    est = dwr_estimate_semilinear(problem, sol, asol, q=q)
    return goal_value(sol.nodes, sol.coeffs, j, q=q), est, asol
