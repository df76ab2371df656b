"""Graded (non-uniform tensor-product) 2D meshes and slack-driven adaptivity.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/hybrid2d_graded.py``.
The mesh stays a tensor product ``xs [nx+1] x ys [ny+1]`` with arbitrary
monotone spacings, so every per-element operator is a per-element-scalar
combination of shared reference matrices:

- coarse Q1: ``K_e = a0 (hy/hx) Cxx + a0 (hx/hy) Cyy + c (hx hy/4) Mhat
  + bx (hy/2) Chatx + by (hx/2) Chaty`` (``assembly2d.q1_reference_parts``),
  applied matrix-free through ``apply_stiffness_var`` with the reference
  parts as the S_q stack and the geometric scalars as the coefficient maps;
  variable diffusion samples a(x, y) at each element's own quadrature points
  (``q1_reference_quad_parts``);
- enhancement: ``D_e = -a_e (sx_e^2 W20 + sy_e^2 W02) - ax_e sx_e W10
  - ay_e sy_e W01 + bx sx_e W10 + by sy_e W01 + c W00`` with chain factors
  ``sx_e = 2/hx_e`` and shared tensor-Legendre collocation matrices, solved
  per element by the batched null-space QR (``kkt.solve_batched``), or on a
  CUDA float32 run by the fused kernel of ``ops.kernels2d_graded``.

Adaptivity refines the worst x-intervals and y-intervals independently
(per-axis max of the per-element slack), keeping the tensor product.  Only
all-Dirichlet problems run here, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import assembly2d, cg, kernels2d_graded, kkt, legendre
from ..utils.device import resolve as resolve_device
from .hybrid2d import (Problem2D, Solution2D, Solver2DConfig,
                       _bilinear_fallback_coeffs, _boundary_coords,
                       _element_data_2d, _kernel_solve_ok, _resolve_backend)

_span = torch.profiler.record_function
SPANS = ("prepare_shared_2d_graded", "fem_solve_2d_graded",
         "enhance_2d_graded", "evaluate_2d_graded")


@dataclasses.dataclass(frozen=True)
class Graded2DOperators:
    """Shared host-f64 reference collocation operators (unit chain factors;
    the per-element scaling is applied at solve time)."""

    W20: torch.Tensor  # [C^2, M^2]  V0y (x) V2x
    W02: torch.Tensor  # [C^2, M^2]  V2y (x) V0x
    W10: torch.Tensor  # [C^2, M^2]  V0y (x) V1x
    W01: torch.Tensor  # [C^2, M^2]  V1y (x) V0x
    W00: torch.Tensor  # [C^2, M^2]  V0y (x) V0x
    B: torch.Tensor  # [4M-4, M^2] shared trace rows
    Z: torch.Tensor  # [M^2, K] null basis of B
    Pbc: torch.Tensor  # [M^2, 4M-4] min-norm particular map
    # Fused-kernel precompute: the five reference parts projected on the
    # null basis / the particular map, stacked [W20; W02; W10; W01; W00] at
    # unit scale; the kernel applies the per-element chain factors and the
    # per-element row scale 1/(sx^2 + sy^2).
    AZ: Optional[torch.Tensor] = None  # [5 C^2, K]
    AP: Optional[torch.Tensor] = None  # [5 C^2, 4M-4]

    def to(self, device=None, dtype=None) -> "Graded2DOperators":
        return kkt.bundle_to(self, device, dtype)


def prepare_shared_2d_graded(problem: Problem2D, cfg: Solver2DConfig):
    """Host float64 precompute of the reference-coordinate operator parts
    (graded analog of ``prepare_shared_2d``; interior collocation points).
    Returns (``Graded2DOperators`` of CPU tensors in the run dtype,
    (t_int, bpts) numpy)."""
    if any(t != "dirichlet" for t in problem.bc_edges):
        raise NotImplementedError(
            "this path eliminates all boundary edges structurally "
            "(Dirichlet only); mixed-BC problems run on the uniform path "
            "(HybridSolver2D)")
    M, C = cfg.M, cfg.n_colloc
    dtype = cfg.torch_dtype()
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)

    def tensor(Vy, Vx):
        return np.einsum("yk,xl->yxkl", Vy, Vx).reshape(C * C, M * M)

    W20, W02, W10 = tensor(V0, V2), tensor(V2, V0), tensor(V0, V1)
    W01, W00 = tensor(V1, V0), tensor(V0, V0)
    bpts = _boundary_coords(M)
    V0y_b = legendre.vandermonde_host(bpts[:, 0], M)[0]
    V0x_b = legendre.vandermonde_host(bpts[:, 1], M)[0]
    B = np.einsum("pk,pl->pkl", V0y_b, V0x_b).reshape(-1, M * M)
    Z, Pbc = kkt.nullspace_host(B)
    Wstack = np.concatenate([W20, W02, W10, W01, W00])  # [5 C^2, M^2]

    def tt(v):
        return torch.as_tensor(v, dtype=dtype)

    ops = Graded2DOperators(
        W20=tt(W20), W02=tt(W02), W10=tt(W10), W01=tt(W01), W00=tt(W00),
        B=tt(B), Z=tt(Z), Pbc=tt(Pbc), AZ=tt(Wstack @ Z), AP=tt(Wstack @ Pbc))
    return ops, (t_int, bpts)


def graded_fem_parts(problem: Problem2D, xs, ys):
    """Matrix-free per-element operator parts on a graded tensor-product
    mesh: the stacked reference 4x4 blocks Sq (host numpy) and their
    per-element scalar maps [n, ny, nx]."""
    dtype, device = xs.dtype, xs.device
    hx = xs[1:] - xs[:-1]  # [nx]
    hy = ys[1:] - ys[:-1]  # [ny]
    HX = hx[None, :] * torch.ones_like(hy)[:, None]  # [ny, nx]
    HY = hy[:, None] * torch.ones_like(hx)[None, :]
    bx, by = problem.b
    Sq_list, map_list = [], []
    Cxx, Cyy, Mh, Chx, Chy = assembly2d.q1_reference_parts()
    if problem.a_var is not None:
        # Variable diffusion: a at each element's own quadrature points; the
        # per-point gradient parts carry the geometric scalars.
        Sxx, Syy, tq = assembly2d.q1_reference_quad_parts()
        Q = tq.shape[0]
        t0 = torch.as_tensor(tq[:, 0], dtype=dtype, device=device)
        t1 = torch.as_tensor(tq[:, 1], dtype=dtype, device=device)
        xq = (0.5 * (xs[1:] + xs[:-1])[None, :] + 0.5 * hx[None, :]
              * t0[:, None])
        yq = (0.5 * (ys[1:] + ys[:-1])[None, :] + 0.5 * hy[None, :]
              * t1[:, None])
        A = problem.a_var(xq[:, None, :], yq[:, :, None])  # [Q, ny, nx]
        A = A * torch.ones((Q, hy.shape[0], hx.shape[0]), dtype=dtype,
                           device=device)
        Sq_list += [Sxx[q] for q in range(Q)]
        map_list += [A[q] * HY / HX for q in range(Q)]
        Sq_list += [Syy[q] for q in range(Q)]
        map_list += [A[q] * HX / HY for q in range(Q)]
    else:
        Sq_list += [Cxx, Cyy]
        map_list += [problem.a0 * HY / HX, problem.a0 * HX / HY]
    if problem.c != 0.0:
        Sq_list.append(Mh)
        map_list.append(problem.c * HX * HY / 4.0)
    if bx != 0.0:
        Sq_list.append(Chx)
        map_list.append(bx * HY / 2.0 + torch.zeros_like(HX))
    if by != 0.0:
        Sq_list.append(Chy)
        map_list.append(by * HX / 2.0 + torch.zeros_like(HX))
    return np.stack(Sq_list), torch.stack(map_list)


def fem_solve_2d_graded(problem: Problem2D, cfg: Solver2DConfig, xs, ys):
    """Coarse Q1 solve on the graded tensor-product mesh: matrix-free
    per-element operators through reference-part scalar maps; Jacobi-CG
    (SPD) or Jacobi-BiCGStab (nonsymmetric / indefinite).  Multigrid needs
    nested uniform coarsenings, so graded meshes use Jacobi."""
    dtype = xs.dtype
    bx, by = problem.b
    Sq, a_maps = graded_fem_parts(problem, xs, ys)
    ny1, nx1 = ys.shape[0], xs.shape[0]
    interior = torch.zeros((ny1, nx1), dtype=torch.bool, device=xs.device)
    interior[1:-1, 1:-1] = True
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    u_bc = torch.where(interior, 0.0, problem.g(X, Y) * torch.ones_like(X))
    b = assembly2d.assemble_load(xs, ys, problem.f)

    def apply_op(v):
        return assembly2d.apply_stiffness_var(v, Sq, a_maps)

    def apply_free(v):
        return torch.where(interior, apply_op(v * interior), 0.0)

    rhs = torch.where(interior, b - apply_op(u_bc), 0.0)
    diag = assembly2d.stiffness_var_diag((ny1, nx1), Sq, a_maps, dtype)
    M_inv = torch.where(interior, 1.0 / diag, 1.0)
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    spd = bx == 0.0 and by == 0.0 and problem.c >= 0.0
    solver = cg.cg if spd else cg.bicgstab
    res = solver(apply_free, rhs, M_inv=M_inv, tol=tol,
                 maxiter=cfg.cg_maxiter)
    return u_bc + torch.where(interior, res.x, 0.0), res


def _graded_element_operators(problem: Problem2D, cfg: Solver2DConfig,
                              xs, ys, gops: Graded2DOperators, t_int):
    """Batched per-element collocation operators D [E, C^2, M^2] on the
    graded mesh: per-element chain factors (and the coefficient fields
    sampled at the collocation points for variable diffusion; grad_a by
    ``torch.autograd`` when the problem has none) against the shared
    reference parts."""
    dtype, device = xs.dtype, xs.device
    nx, ny = xs.shape[0] - 1, ys.shape[0] - 1
    E = nx * ny
    C = cfg.n_colloc
    hx = xs[1:] - xs[:-1]
    hy = ys[1:] - ys[:-1]
    SX = (2.0 / hx)[None, :].expand(ny, nx).reshape(E, 1, 1)
    SY = (2.0 / hy)[:, None].expand(ny, nx).reshape(E, 1, 1)
    bx, by = problem.b
    if problem.a_var is not None:
        t = torch.tensor(np.asarray(t_int), dtype=dtype, device=device)
        xq = xs[:-1][:, None] + 0.5 * hx[:, None] * (t[None, :] + 1.0)
        yq = ys[:-1][:, None] + 0.5 * hy[:, None] * (t[None, :] + 1.0)
        ones = torch.ones((ny, nx, C, C), dtype=dtype, device=device)
        Xq = xq[None, :, None, :] * ones
        Yq = yq[:, None, :, None] * ones

        def samp(fn, X=Xq, Y=Yq):
            return (fn(X, Y) * ones).reshape(E, C * C, 1)

        a_e = samp(problem.a_var)
        if problem.grad_a is not None:
            ax_e, ay_e = samp(problem.grad_a[0]), samp(problem.grad_a[1])
        else:  # the chain-rule coefficients by autograd
            with torch.enable_grad():
                Xg = Xq.clone().requires_grad_(True)
                Yg = Yq.clone().requires_grad_(True)
                total = (problem.a_var(Xg, Yg) * ones).sum()
                gx, gy = torch.autograd.grad(total, (Xg, Yg),
                                             allow_unused=True)
            zero = torch.zeros_like(Xq)
            ax_e = (zero if gx is None else gx).reshape(E, C * C, 1)
            ay_e = (zero if gy is None else gy).reshape(E, C * C, 1)
    else:
        a_e, ax_e, ay_e = problem.a0, 0.0, 0.0
    D = -a_e * (SX * SX * gops.W20 + SY * SY * gops.W02)
    cx = bx - ax_e  # (b - grad a) . grad u chain rows
    cy = by - ay_e
    if problem.a_var is not None or bx != 0.0:
        D = D + cx * SX * gops.W10
    if problem.a_var is not None or by != 0.0:
        D = D + cy * SY * gops.W01
    if problem.c != 0.0:
        D = D + problem.c * gops.W00
    return D


def enhance_2d_graded(problem: Problem2D, cfg: Solver2DConfig, xs, ys,
                      fem_values, shared_bundle):
    """The enhancement stage alone on the graded mesh ``xs`` x ``ys``:
    per-element fits against the nodal values, through the fused kernel
    (``_resolve_backend``: CUDA float32, analytic ``grad_a`` where ``a_var``
    is set) or the batched torch algebra.  Returns (coeffs [ny, nx, M, M],
    KKTDiagnostics); failed elements carry the bilinear interpolant."""
    gops, (t_int, bpts) = shared_bundle
    nx, ny = xs.shape[0] - 1, ys.shape[0] - 1
    E, M = nx * ny, cfg.M
    if _resolve_backend(problem, cfg, fem_values.device) == "cuda":
        w, slack, bcv = kernels2d_graded.fused_enhance_graded_2d(
            fem_values, gops, problem, xs, ys, nx, ny, t_int, bpts,
            with_diagnostics=cfg.diagnostics)
        corners = (fem_values[:-1, :-1], fem_values[:-1, 1:],
                   fem_values[1:, :-1], fem_values[1:, 1:])
        if cfg.diagnostics:
            diags = kkt.KKTDiagnostics(slack, bcv,
                                       _kernel_solve_ok(slack, bcv, corners))
        else:
            z = torch.zeros(E, dtype=w.dtype, device=w.device)
            diags = kkt.KKTDiagnostics(z, z,
                                       torch.all(torch.isfinite(w), dim=-1))
    else:
        cfg = dataclasses.replace(cfg, nx=nx, ny=ny)
        f_rows, bc_rows, corners = _element_data_2d(
            problem, cfg, xs, ys, fem_values, t_int, bpts)
        D = _graded_element_operators(problem, cfg, xs, ys, gops, t_int)
        w, diags = kkt.solve_batched(
            D, gops.B, f_rows, bc_rows, cfg.gamma,
            formulation=cfg.formulation, ZP=(gops.Z, gops.Pbc))
    coeffs = w.reshape(ny, nx, M, M)
    fb = _bilinear_fallback_coeffs(*corners, M)
    ok = diags.solve_ok.reshape(ny, nx)
    coeffs = torch.where(ok[..., None, None],
                         torch.where(torch.isfinite(coeffs), coeffs, 0.0), fb)
    return coeffs, diags._replace(solve_ok=ok)


def hybrid_solve_2d_graded(problem: Problem2D, cfg: Solver2DConfig,
                           shared_bundle, xs, ys, device=None) -> Solution2D:
    """Graded coarse Q1 solve, then the per-element enhancement, on
    ``device`` (None: the GPU; a machine without one raises).  ``xs``/``ys``
    are the node arrays (numpy or torch); the config's nx/ny are ignored.
    With dtype float32 and fem_dtype float64 the coarse stage runs on the
    float32 node positions, as in the reference."""
    device = resolve_device(device)
    gops, pts = shared_bundle
    shared_bundle = (gops.to(device), pts)
    dtype = cfg.torch_dtype()
    xs, ys = (v.to(device=device, dtype=dtype) if torch.is_tensor(v)
              else torch.tensor(np.asarray(v), dtype=dtype, device=device)
              for v in (xs, ys))
    nx, ny = xs.shape[0] - 1, ys.shape[0] - 1
    # The mesh is the node arrays: the element counts of the config follow
    # them, so the domain-boundary masks see the true extents.
    cfg = dataclasses.replace(cfg, nx=nx, ny=ny)
    with _span("fem_solve_2d_graded"):
        if cfg.fem_dtype is not None:
            fd = getattr(torch, cfg.fem_dtype)
            fem_values, cg_res = fem_solve_2d_graded(problem, cfg, xs.to(fd),
                                                     ys.to(fd))
            fem_values = fem_values.to(dtype)
        else:
            fem_values, cg_res = fem_solve_2d_graded(problem, cfg, xs, ys)
    with _span("enhance_2d_graded"):
        coeffs, diags = enhance_2d_graded(problem, cfg, xs, ys, fem_values,
                                          shared_bundle)
    return Solution2D(
        xs=xs, ys=ys, fem_values=fem_values, coeffs=coeffs,
        cg_iters=cg_res.iters, cg_residual=cg_res.residual,
        max_slack=diags.max_slack.reshape(ny, nx),
        bc_violation=diags.bc_violation.reshape(ny, nx),
        solve_ok=diags.solve_ok, cond_estimate=diags.cond_estimate)


def _locate_graded(sol: Solution2D, x, y):
    xs, ys = sol.xs, sol.ys
    nx, ny = xs.shape[0] - 1, ys.shape[0] - 1
    ix = torch.clamp(torch.searchsorted(xs, x, right=True) - 1, 0, nx - 1)
    iy = torch.clamp(torch.searchsorted(ys, y, right=True) - 1, 0, ny - 1)
    hx_e = xs[ix + 1] - xs[ix]
    hy_e = ys[iy + 1] - ys[iy]
    tx = (2.0 * x - xs[ix] - xs[ix + 1]) / hx_e
    ty = (2.0 * y - ys[iy] - ys[iy + 1]) / hy_e
    return ix, iy, tx, ty, hx_e, hy_e


def evaluate_2d_graded(sol: Solution2D, x: torch.Tensor, y: torch.Tensor):
    """u(x, y) on the graded mesh: ``torch.searchsorted`` element lookup per
    axis, then the batched tensor-Legendre evaluation; points outside the
    domain are evaluated in the nearest element."""
    ix, iy, tx, ty, _, _ = _locate_graded(sol, x, y)
    M = sol.coeffs.shape[-1]
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    W = sol.coeffs[iy, ix]  # [P, M, M]
    return torch.einsum("pk,pkl,pl->p", Vy, W, Vx)


def evaluate_2d_graded_gradient(sol: Solution2D, x: torch.Tensor,
                                y: torch.Tensor):
    """(du/dx, du/dy) on the graded mesh, with the per-element chain
    factors 2/hx_e, 2/hy_e."""
    ix, iy, tx, ty, hx_e, hy_e = _locate_graded(sol, x, y)
    M = sol.coeffs.shape[-1]
    Vx, Vx1 = legendre.legendre_vandermonde(tx, M, num_derivs=1)
    Vy, Vy1 = legendre.legendre_vandermonde(ty, M, num_derivs=1)
    W = sol.coeffs[iy, ix]  # [P, M(ky), M(kx)]
    ux = (2.0 / hx_e) * torch.einsum("pk,pkl,pl->p", Vy, W, Vx1)
    uy = (2.0 / hy_e) * torch.einsum("pk,pkl,pl->p", Vy1, W, Vx)
    return ux, uy


class HybridSolver2DGraded:
    """Facade for graded tensor-product meshes (mirrors ``HybridSolver2D``;
    the config's nx/ny are ignored: the mesh is the node arrays).  Runs on
    the GPU unless given ``device='cpu'``."""

    def __init__(self, problem: Problem2D, config: Solver2DConfig, xs, ys,
                 device=None):
        self.problem = problem
        self.config = config
        self.xs = np.asarray(xs, np.float64)
        self.ys = np.asarray(ys, np.float64)
        self.device = resolve_device(device)
        with _span("prepare_shared_2d_graded"):
            ops, pts = prepare_shared_2d_graded(problem, config)
            self._shared = (ops.to(self.device), pts)
        self.solution: Optional[Solution2D] = None

    def solve(self) -> Solution2D:
        self.solution = hybrid_solve_2d_graded(
            self.problem, self.config, self._shared, self.xs, self.ys,
            device=self.device)
        return self.solution

    def _points(self, x, y):
        if self.solution is None:
            raise RuntimeError("call solve() first")
        dtype = self.solution.xs.dtype
        return (torch.as_tensor(x, dtype=dtype, device=self.device),
                torch.as_tensor(y, dtype=dtype, device=self.device))

    def evaluate_solution(self, x, y):
        x, y = self._points(x, y)
        with _span("evaluate_2d_graded"):
            return evaluate_2d_graded(self.solution, x, y)

    def evaluate_gradient(self, x, y):
        return evaluate_2d_graded_gradient(self.solution,
                                           *self._points(x, y))

    def errors(self, x, y):
        """(linf, l2) of the hybrid solution against the exact oracle."""
        from ..utils import metrics

        u = self.evaluate_solution(x, y)
        ue = self.problem.exact(*self._points(x, y))
        return metrics.linf_error(u, ue), metrics.l2_error(u, ue)


class AdaptiveResult2D(NamedTuple):
    solution: Solution2D
    xs: np.ndarray
    ys: np.ndarray
    history: List[dict]


def refine_axis(nodes: np.ndarray, indicator: np.ndarray,
                refine_frac: float) -> np.ndarray:
    """Bisect the worst ``refine_frac`` of intervals along one axis."""
    E = nodes.shape[0] - 1
    n_ref = max(1, int(np.ceil(refine_frac * E)))
    worst = np.argsort(indicator)[-n_ref:]
    mids = 0.5 * (nodes[worst] + nodes[worst + 1])
    return np.sort(np.concatenate([nodes, mids]))


def adaptive_solve_2d(problem: Problem2D, cfg: Solver2DConfig,
                      rounds: int = 3, refine_frac: float = 0.3,
                      eval_points=None, device=None) -> AdaptiveResult2D:
    """Slack-driven tensor-product adaptivity: each round refines the worst
    x-intervals by the column-max slack and the worst y-intervals by the
    row-max slack (an interval refines across its whole strip).  Starts
    from the cfg.nx x cfg.ny uniform mesh."""
    x0, x1, y0, y1 = problem.domain
    xs = np.linspace(x0, x1, cfg.nx + 1)
    ys = np.linspace(y0, y1, cfg.ny + 1)
    history: List[dict] = []
    solver = None
    for r in range(rounds + 1):
        solver = HybridSolver2DGraded(problem, cfg, xs, ys, device=device)
        sol = solver.solve()
        slack = sol.max_slack.detach().cpu().numpy()  # [ny, nx]
        # Scale-normalised indicator: the raw slack is the PDE residual
        # against rows of size ~ sx^2 + sy^2, which grows ~ 1/h^2 on refined
        # elements; dividing by the row scale makes elements of different
        # sizes comparable (else refinement feeds back onto the smallest).
        hx, hy = np.diff(xs), np.diff(ys)
        row_scale = ((2.0 / hx) ** 2)[None, :] + ((2.0 / hy) ** 2)[:, None]
        slack = slack / row_scale
        rec = {"round": r, "elements": int(slack.size),
               "max_slack": float(slack.max())}
        if eval_points is not None:
            rec["linf"] = float(solver.errors(*eval_points)[0])
        history.append(rec)
        if r == rounds:
            break
        xs = refine_axis(xs, slack.max(axis=0), refine_frac)
        ys = refine_axis(ys, slack.max(axis=1), refine_frac)
    return AdaptiveResult2D(solution=solver.solution, xs=xs, ys=ys,
                            history=history)
