"""Semilinear elliptic problems: -a0 Lap u + s(u) = f by Newton at both
levels, in 1D, 2D and 3D.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/nonlinear.py``.

Stage 1, FEM Newton: each iteration assembles the linearised operator
-a0 w'' + s'(u_k) w with the reaction field sampled from the current P1
iterate (``assembly.assemble_p1`` takes coefficient callables; the field
enters as a piecewise-linear interpolant), solves the tridiagonal
correction and updates.  2D and 3D: matrix-free Q1 with the nonlinearity
mass-lumped at the nodes (or the tensor-Numerov compact rows), each
correction a Jacobi-CG solve.

Stage 2, element-level Newton enhancement: per element the polynomial
coefficients solve the nonlinear collocation system -a0 Lap u(x_j) +
s(u(x_j)) = f(x_j) with the element trace pinned to the FEM values; each
Newton step is one batched null-space solve (``kkt.solve_batched`` with
per-element D_k = -a0 Lap rows + diag(s'(u_j)) Mass rows), as in the JAX
package, which routes it to no kernel either.

JAX's fixed-length ``lax.scan`` Newton loops are Python loops of the same
length with no early exit, so the arithmetic is the scans'; each residual
stays on the device until the history is stacked.  Entry points run on the
GPU unless given ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import assembly, assembly2d, assembly3d, cg, kkt, legendre, \
    tridiag
from ..ops import eval as ops_eval
from ..utils.device import resolve as resolve_device
from .hybrid import SolverConfig, _interp
from .hybrid2d import (Solution2D, _bilinear_fallback_coeffs,
                       _boundary_coords, _element_data_2d, evaluate_2d)
from .hybrid3d import (Solution3D, _element_data_3d, _surface_coords,
                       _trilinear_fallback_coeffs, evaluate_3d)


@dataclasses.dataclass(frozen=True)
class SemilinearProblem1D:
    """-a0 u'' + s(u) = f on (x0, x1), Dirichlet u = g at both ends."""

    name: str
    s: Callable  # nonlinearity s(u)
    ds: Callable  # s'(u)
    f: Callable  # rhs f(x)
    a0: float = 1.0
    domain: Tuple[float, float] = (-1.0, 1.0)
    g_left: float = 0.0
    g_right: float = 0.0
    exact: Optional[Callable] = None


def bratu_1d(lam: float = 1.0) -> SemilinearProblem1D:
    """-u'' + lam e^u = f manufactured so u = sin(pi x) (a stabilised
    Bratu-type nonlinearity: +lam e^u is monotone, so Newton converges
    globally from zero)."""
    pi = torch.pi
    return SemilinearProblem1D(
        name=f"bratu_1d_lam{lam:g}",
        s=lambda u: lam * torch.exp(u),
        ds=lambda u: lam * torch.exp(u),
        f=lambda x: pi**2 * torch.sin(pi * x)
        + lam * torch.exp(torch.sin(pi * x)),
        exact=lambda x: torch.sin(pi * x),
    )


def cubic_1d() -> SemilinearProblem1D:
    """-u'' + u^3 = f manufactured so u = sin(pi x)."""
    pi = torch.pi
    return SemilinearProblem1D(
        name="cubic_1d",
        s=lambda u: u**3,
        ds=lambda u: 3.0 * u**2,
        f=lambda x: pi**2 * torch.sin(pi * x) + torch.sin(pi * x) ** 3,
        exact=lambda x: torch.sin(pi * x),
    )


class SemilinearSolution(NamedTuple):
    nodes: torch.Tensor
    fem_values: torch.Tensor  # [N] converged Newton iterate
    coeffs: torch.Tensor  # [E, M]
    newton_residuals: torch.Tensor  # [n_newton] FEM-level |R|_inf history
    colloc_residual: torch.Tensor  # scalar: final max |PDE residual|
    solve_ok: torch.Tensor  # [E]


def _shifted(v):
    """(v[i-1], v[i+1]) with zeros past the ends."""
    zero = torch.zeros_like(v[:1])
    return torch.cat([zero, v[:-1]]), torch.cat([v[1:], zero])


def _free_mask(nodes):
    free = torch.ones_like(nodes, dtype=torch.bool)
    free[0] = free[-1] = False
    return free


def _start(nodes, problem):
    u0 = torch.zeros_like(nodes)
    u0[0], u0[-1] = problem.g_left, problem.g_right
    return u0


def fem_newton(problem: SemilinearProblem1D, cfg: SolverConfig,
               n_newton: int = 8, scheme: str = "p1", device=None):
    """(nodes, converged Newton iterate, residual history [n_newton]).

    ``scheme="p1"``: consistent P1 FEM rows, O(h^2) nodal (the s(u) mass
    term breaks the linear-Poisson nodal exactness).  ``scheme="numerov"``:
    the compact rows -a0 delta^2 u / h^2 + (1, 10, 1)/12 (s(u) - f) = 0,
    O(h^4) nodal."""
    if scheme == "numerov":
        return _numerov_newton(problem, cfg, n_newton, device=device)
    dtype = cfg.torch_dtype()
    x0, x1 = problem.domain
    nodes = torch.linspace(x0, x1, cfg.num_nodes, dtype=dtype,
                           device=resolve_device(device))
    a0 = problem.a0

    def zero_f(x):
        return torch.zeros_like(x)

    sub0, main0, sup0, _ = assembly.assemble_p1(
        nodes, lambda x: a0 * torch.ones_like(x), None, None, zero_f,
        quad_order=cfg.fem_quad_order)
    _, _, _, b = assembly.assemble_p1(nodes, None, None, None, problem.f,
                                      quad_order=cfg.fem_quad_order)
    free = _free_mask(nodes)
    u = _start(nodes, problem)
    residuals = []
    for _ in range(n_newton):
        # residual R(u) = A0 u + int s(u_h) v - b  (free rows)
        _, _, _, load_s = assembly.assemble_p1(
            nodes, None, None, None,
            lambda x: problem.s(_interp(x, nodes, u)),
            quad_order=cfg.fem_quad_order)
        um, up = _shifted(u)
        R = torch.where(free, main0 * u + sub0 * um + sup0 * up + load_s - b,
                        0.0)
        # Jacobian: A0 + the mass-weighted s'(u_h) field
        sub_c, main_c, sup_c, _ = assembly.assemble_p1(
            nodes, None, None, lambda x: problem.ds(_interp(x, nodes, u)),
            zero_f, quad_order=cfg.fem_quad_order)
        sub_j = torch.where(free, sub0 + sub_c, 0.0)
        sup_j = torch.where(free, sup0 + sup_c, 0.0)
        main_j = torch.where(free, main0 + main_c, 1.0)
        # boundary columns: delta = 0 there, so zero the couplings
        sub_j[-1] = 0.0
        sup_j[0] = 0.0
        delta = tridiag.solve(sub_j, main_j, sup_j, R,
                              method=cfg.tridiag_method)
        u = u - torch.where(free, delta, 0.0)
        residuals.append(torch.abs(R).amax())
    return nodes, u, torch.stack(residuals)


def _numerov_newton(problem: SemilinearProblem1D, cfg: SolverConfig,
                    n_newton: int = 8, device=None):
    """Compact fourth-order Newton: rows
    -a0 (u_{i-1} - 2 u_i + u_{i+1})/h^2
    + (s(u)_{i-1} + 10 s(u)_i + s(u)_{i+1})/12
    = (f_{i-1} + 10 f_i + f_{i+1})/12  at interior nodes."""
    dtype = cfg.torch_dtype()
    x0, x1 = problem.domain
    nodes = torch.linspace(x0, x1, cfg.num_nodes, dtype=dtype,
                           device=resolve_device(device))
    h = nodes[1] - nodes[0]
    f_n = problem.f(nodes) * torch.ones_like(nodes)
    free = _free_mask(nodes)

    def w112(v):  # (1, 10, 1)/12 weighting (interior rows only used)
        vm, vp = _shifted(v)
        return (vm + 10.0 * v + vp) / 12.0

    def d2(v):
        vm, vp = _shifted(v)
        return (vm - 2.0 * v + vp) / (h * h)

    u = _start(nodes, problem)
    residuals = []
    for _ in range(n_newton):
        R = torch.where(free, -problem.a0 * d2(u) + w112(problem.s(u))
                        - w112(f_n), 0.0)
        c = problem.ds(u)
        cm, cp = _shifted(c)
        a = problem.a0 / (h * h)
        sub = torch.where(free, -a + cm / 12.0, 0.0)
        sub[-1] = 0.0
        sup = torch.where(free, -a + cp / 12.0, 0.0)
        sup[0] = 0.0
        main = torch.where(free, 2.0 * a + 10.0 * c / 12.0, 1.0)
        delta = tridiag.solve(sub, main, sup, R, method=cfg.tridiag_method)
        u = u - torch.where(free, delta, 0.0)
        residuals.append(torch.abs(R).amax())
    return nodes, u, torch.stack(residuals)


def hybrid_solve_semilinear(problem: SemilinearProblem1D,
                            cfg: SolverConfig, n_newton: int = 8,
                            n_newton_elem: int = 5, scheme: str = "p1",
                            device=None) -> SemilinearSolution:
    """Full semilinear hybrid solve: FEM Newton then the element-level
    Newton enhancement (module docstring)."""
    nodes, fem_values, fem_res = fem_newton(problem, cfg, n_newton,
                                            scheme=scheme, device=device)
    dtype, device = nodes.dtype, nodes.device
    M, C = cfg.M, cfg.n_colloc
    h = nodes[1] - nodes[0]
    # host float64 reference-coordinate operators
    V0h, _, V2h = legendre.collocation_vandermonde_host(M, C)
    B = np.stack([V0h[0], V0h[-1]])
    Z, Pbc = kkt.nullspace_host(B)
    V0, D2, Bt, Zt, Pt = (torch.as_tensor(v, dtype=dtype, device=device)
                          for v in (V0h, V2h, B, Z, Pbc))
    scale2 = (2.0 / h) ** 2
    t = legendre.collocation_points(C, dtype=dtype, device=device)
    xc = nodes[:-1][:, None] + 0.5 * h * (t[None, :] + 1.0)  # [E, C]
    f_c = problem.f(xc) * torch.ones_like(xc)
    u_left = fem_values[:-1].clone()
    u_left[0] = problem.g_left
    u_right = fem_values[1:].clone()
    u_right[-1] = problem.g_right
    bc = torch.stack([u_left, u_right], dim=-1)

    # start from the P1 interpolant's Legendre coefficients
    w = kkt.linear_fallback_coeffs(u_left, u_right, M)
    diags = None
    for _ in range(n_newton_elem):
        u_c = w @ V0.T  # [E, C]
        c_field = problem.ds(u_c)
        # linearised collocation rows: -a0 (2/h)^2 V2 + c V0
        D = (-problem.a0 * scale2) * D2[None] + c_field[..., None] * V0[None]
        rhs = f_c - problem.s(u_c) + c_field * u_c
        w, diags = kkt.solve_batched(D, Bt, rhs, bc, cfg.gamma, ZP=(Zt, Pt))
        del D
    # final nonlinear collocation residual (the real convergence check)
    u_c = w @ V0.T
    upp = scale2 * (w @ D2.T)
    res = torch.abs(-problem.a0 * upp + problem.s(u_c) - f_c).amax()
    return SemilinearSolution(nodes, fem_values, w, fem_res, res,
                              diags.solve_ok)


def evaluate_semilinear(sol: SemilinearSolution, x):
    return ops_eval.evaluate(sol.nodes, sol.coeffs, x)


# --------------------------------------------------------------------- 2D


@dataclasses.dataclass(frozen=True)
class SemilinearProblem2D:
    """-a0 Lap u + s(u) = f on a rectangle, Dirichlet u = g."""

    name: str
    s: Callable
    ds: Callable
    f: Callable  # f(x, y)
    g: Callable  # Dirichlet data
    a0: float = 1.0
    domain: Tuple[float, float, float, float] = (-1.0, 1.0, -1.0, 1.0)
    exact: Optional[Callable] = None


def cubic_2d() -> SemilinearProblem2D:
    """-Lap u + u^3 = f manufactured so u = sin(pi x) sin(pi y)."""
    pi = torch.pi

    def u(x, y):
        return torch.sin(pi * x) * torch.sin(pi * y)

    return SemilinearProblem2D(
        name="cubic_2d",
        s=lambda v: v**3,
        ds=lambda v: 3.0 * v**2,
        f=lambda x, y: 2.0 * pi**2 * u(x, y) + u(x, y) ** 3,
        g=lambda x, y: torch.zeros_like(x + y),
        exact=u,
    )


class SemilinearSolution2D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    fem_values: torch.Tensor
    coeffs: torch.Tensor  # [ny, nx, M, M]
    newton_residuals: torch.Tensor
    colloc_residual: torch.Tensor
    solve_ok: torch.Tensor


def _cg_tol(cfg, dtype):
    return (100.0 * float(torch.finfo(dtype).eps) if cfg.cg_tol is None
            else cfg.cg_tol)


def _newton_grid(problem, cfg, u_bc, interior, f_n, K0, K_M, m, n_newton,
                 apply, diag_of):
    """The coarse Newton loop shared by 2D and 3D: residual, Jacobi
    preconditioner and matrix-free Jacobian apply, one CG solve a step."""
    numerov = K_M is not None
    diag0 = diag_of(K0)
    if numerov:
        Mf = apply(f_n, K_M)
        diagM = diag_of(K_M)
    tol = _cg_tol(cfg, u_bc.dtype)
    u = u_bc
    residuals = []
    for _ in range(n_newton):
        if numerov:
            R = torch.where(interior, apply(u, K0) + apply(problem.s(u), K_M)
                            - Mf, 0.0)
        else:
            R = torch.where(interior, apply(u, K0) + m * (problem.s(u) - f_n),
                            0.0)
        c = problem.ds(u)

        def J_apply(v, c=c):
            vi = v * interior
            if numerov:
                return torch.where(interior,
                                   apply(vi, K0) + apply(c * vi, K_M), 0.0)
            return torch.where(interior, apply(vi, K0) + m * c * vi, 0.0)

        dj = diagM * c if numerov else m * c
        M_inv = torch.where(interior, 1.0 / (diag0 + dj), 1.0)
        res = cg.cg(J_apply, R, M_inv=M_inv, tol=tol, maxiter=cfg.cg_maxiter)
        u = u - torch.where(interior, res.x, 0.0)
        residuals.append(torch.abs(R).amax())
    return u, torch.stack(residuals)


def fem_newton_2d(problem: SemilinearProblem2D, cfg, n_newton: int = 8,
                  scheme: str = "p1", device=None):
    """Coarse Newton stage of the 2D semilinear solve.  Returns
    ``(xs, ys, fem, fem_res)``."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = problem.domain
    nx, ny = cfg.nx, cfg.ny
    hx, hy = float((x1 - x0) / nx), float((y1 - y0) / ny)
    xs = torch.linspace(x0, x1, nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, ny + 1, dtype=dtype, device=device)
    if scheme == "numerov":
        K0, K_M = assembly2d.q1_numerov_locals(hx, hy, problem.a0, 0.0)
    else:
        K0 = assembly2d.q1_local_operator(hx, hy, problem.a0, 0.0, 0.0, 0.0)
        K_M = None
    shape = (ny + 1, nx + 1)
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1] = True
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    u_bc = torch.where(interior, 0.0, problem.g(X, Y) * torch.ones_like(X))
    f_n = problem.f(X, Y) * torch.ones_like(X)
    fem, fem_res = _newton_grid(
        problem, cfg, u_bc, interior, f_n, K0, K_M, hx * hy, n_newton,
        assembly2d.apply_stiffness,
        lambda K: assembly2d.stiffness_diag(shape, K, dtype, device))
    return xs, ys, fem, fem_res


def _semilinear2d_element_parts_host(problem: SemilinearProblem2D, cfg,
                                     dtype):
    """Host-precomputed shared element operators for the 2D element-level
    Newton: (Lap rows scaled by -a0, Mass rows, trace matrix B, its
    null-space pair (Z, Pbc)) as CPU tensors in ``dtype``, then (t_int,
    bpts) numpy."""
    M_, C = cfg.M, cfg.n_colloc
    x0, x1, y0, y1 = problem.domain
    hx, hy = float((x1 - x0) / cfg.nx), float((y1 - y0) / cfg.ny)
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0h, _, V2h = legendre.vandermonde_host(t_int, M_)
    sx, sy = 2.0 / hx, 2.0 / hy
    Lap = (sx * sx * np.einsum("yk,xl->yxkl", V0h, V2h)
           + sy * sy * np.einsum("yk,xl->yxkl", V2h, V0h)
           ).reshape(C * C, M_ * M_)
    Mass = np.einsum("yk,xl->yxkl", V0h, V0h).reshape(C * C, M_ * M_)
    bpts = _boundary_coords(M_)
    V0y_b = legendre.vandermonde_host(bpts[:, 0], M_)[0]
    V0x_b = legendre.vandermonde_host(bpts[:, 1], M_)[0]
    B = np.einsum("pk,pl->pkl", V0y_b, V0x_b).reshape(-1, M_ * M_)
    Z, Pbc = kkt.nullspace_host(B)
    return tuple(torch.as_tensor(v, dtype=dtype) for v in (
        -problem.a0 * Lap, Mass, B, Z, Pbc)) + (t_int, bpts)


def _element_newton(problem, f_rows, bc_rows, w, parts, gamma,
                    n_newton_elem):
    """Element-level Newton on the nonlinear collocation system: each step
    one batched null-space solve with D = Lap rows + diag(s'(u_j)) Mass
    rows.  Returns (w, final collocation residual, solve_ok)."""
    Lap, Mass, B, Z, Pbc = parts
    diags = None
    for _ in range(n_newton_elem):
        u_c = w @ Mass.T  # values at the collocation points
        c_field = problem.ds(u_c)
        D = Lap[None] + c_field[..., None] * Mass[None]
        rhs = f_rows - problem.s(u_c) + c_field * u_c
        w, diags = kkt.solve_batched(D, B, rhs, bc_rows, gamma, ZP=(Z, Pbc))
        del D
    u_c = w @ Mass.T
    lap_u = w @ Lap.T
    res = torch.abs(lap_u + problem.s(u_c) - f_rows).amax()
    return w, res, diags.solve_ok


def hybrid_solve_semilinear_2d(problem: SemilinearProblem2D, cfg,
                               n_newton: int = 8, n_newton_elem: int = 5,
                               scheme: str = "p1", trace_lift: int = 0,
                               device=None) -> SemilinearSolution2D:
    """2D two-level Newton (lift of ``hybrid_solve_semilinear``).

    FEM level, ``scheme="p1"``: matrix-free Q1 with the nonlinearity
    mass-lumped at the nodes, R = A0 u + m (s(u) - f) with m the lumped Q1
    mass; J v = A0 v + m s'(u) v by Jacobi-CG.  ``scheme="numerov"``:
    tensor-Numerov compact rows A u + M s(u) = M f, O(h^4) nodal.  Element
    level: Newton on the nonlinear collocation system with the nonlinearity
    evaluated exactly at the interior collocation points.  ``trace_lift >=
    2`` replaces the bilinear element trace with the tangential Lagrange
    lift (``hybrid2d._lifted_trace_2d``)."""
    xs, ys, fem, fem_res = fem_newton_2d(problem, cfg, n_newton, scheme,
                                         device=device)
    dtype, device = xs.dtype, xs.device
    nx, ny = cfg.nx, cfg.ny
    x0, x1, y0, y1 = problem.domain
    hx, hy = float((x1 - x0) / nx), float((y1 - y0) / ny)
    M_, C = cfg.M, cfg.n_colloc
    *parts, t_int, bpts = _semilinear2d_element_parts_host(problem, cfg,
                                                           dtype)
    parts = tuple(v.to(device) for v in parts)
    E = nx * ny
    # traces from the converged FEM grid (g exact on domain edges)
    _, bc_rows, corners = _element_data_2d(
        _P2DStub(problem), cfg, xs, ys, fem, t_int, bpts,
        trace_lift=trace_lift, skip_f=True)
    t = torch.as_tensor(t_int, dtype=dtype, device=device)
    xm, ym = 0.5 * (xs[1:] + xs[:-1]), 0.5 * (ys[1:] + ys[:-1])
    xq = xm[:, None] + 0.5 * hx * t[None, :]
    yq = ym[:, None] + 0.5 * hy * t[None, :]
    F = problem.f(xq[None, :, None, :], yq[:, None, :, None])
    f_rows = (F * torch.ones((ny, nx, C, C), dtype=dtype,
                             device=device)).reshape(E, C * C)
    # initial fit: the bilinear interpolant
    w = _bilinear_fallback_coeffs(*corners, M_).reshape(E, M_ * M_)
    w, res, ok = _element_newton(problem, f_rows, bc_rows, w, parts,
                                 cfg.gamma, n_newton_elem)
    return SemilinearSolution2D(xs, ys, fem, w.reshape(ny, nx, M_, M_),
                                fem_res, res, ok.reshape(ny, nx))


class _P2DStub:
    """The Problem2D attributes ``_element_data_2d`` reads (all edges
    Dirichlet)."""

    def __init__(self, p):
        self.f = p.f
        self.g = p.g
        self.bc_edges = ("dirichlet",) * 4


def evaluate_semilinear_2d(sol: SemilinearSolution2D, x, y):
    s2 = Solution2D(sol.xs, sol.ys, sol.fem_values, sol.coeffs, 0, 0.0,
                    None, None, None)
    return evaluate_2d(s2, x, y)


# --------------------------------------------------------------------- 3D


@dataclasses.dataclass(frozen=True)
class SemilinearProblem3D:
    """-a0 Lap u + s(u) = f on a box, Dirichlet u = g."""

    name: str
    s: Callable
    ds: Callable
    f: Callable  # f(x, y, z)
    g: Callable  # Dirichlet data
    a0: float = 1.0
    domain: Tuple[float, ...] = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    exact: Optional[Callable] = None


def cubic_3d() -> SemilinearProblem3D:
    """-Lap u + u^3 = f manufactured so u = sin(pi x) sin(pi y) sin(pi z)."""
    pi = torch.pi

    def u(x, y, z):
        return torch.sin(pi * x) * torch.sin(pi * y) * torch.sin(pi * z)

    return SemilinearProblem3D(
        name="cubic_3d",
        s=lambda v: v**3,
        ds=lambda v: 3.0 * v**2,
        f=lambda x, y, z: 3.0 * pi**2 * u(x, y, z) + u(x, y, z) ** 3,
        g=lambda x, y, z: torch.zeros_like(x + y + z),
        exact=u,
    )


class SemilinearSolution3D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    fem_values: torch.Tensor  # [nz+1, ny+1, nx+1]
    coeffs: torch.Tensor  # [nz, ny, nx, M, M, M]
    newton_residuals: torch.Tensor
    colloc_residual: torch.Tensor
    solve_ok: torch.Tensor  # [nz, ny, nx]


def _spacings_3d(problem, cfg):
    x0, x1, y0, y1, z0, z1 = problem.domain
    return (float((x1 - x0) / cfg.nx), float((y1 - y0) / cfg.ny),
            float((z1 - z0) / cfg.nz))


def fem_newton_3d(problem: SemilinearProblem3D, cfg, n_newton: int = 8,
                  scheme: str = "p1", device=None):
    """Coarse Newton stage of the 3D semilinear solve.  Returns
    ``(xs, ys, zs, fem, fem_res)``."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1, z0, z1 = problem.domain
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    hx, hy, hz = _spacings_3d(problem, cfg)
    xs = torch.linspace(x0, x1, nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, ny + 1, dtype=dtype, device=device)
    zs = torch.linspace(z0, z1, nz + 1, dtype=dtype, device=device)
    if scheme == "numerov":
        K0, K_M = assembly3d.q1_numerov_locals_3d(hx, hy, hz, problem.a0,
                                                  0.0)
    else:
        K0 = assembly3d.q1_local_operator_3d(hx, hy, hz, problem.a0, 0.0,
                                             0.0, 0.0, 0.0)
        K_M = None
    shape = (nz + 1, ny + 1, nx + 1)
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1, 1:-1] = True
    X, Y, Z = xs[None, None, :], ys[None, :, None], zs[:, None, None]
    ones = torch.ones(shape, dtype=dtype, device=device)
    u_bc = torch.where(interior, 0.0, problem.g(X, Y, Z) * ones)
    f_n = problem.f(X, Y, Z) * ones
    fem, fem_res = _newton_grid(
        problem, cfg, u_bc, interior, f_n, K0, K_M, hx * hy * hz, n_newton,
        assembly3d.apply_stiffness_3d,
        lambda K: assembly3d.stiffness_diag_3d(shape, K, dtype, device))
    return xs, ys, zs, fem, fem_res


def _semilinear3d_element_parts_host(problem: SemilinearProblem3D, cfg,
                                     dtype):
    """Host-precomputed shared element operators for the 3D element-level
    Newton (the tensor lift of ``_semilinear2d_element_parts_host``): CPU
    tensors (-a0 Lap, Mass, B, Z, Pbc) in ``dtype``, then (t_int, spts)
    numpy."""
    M_, C = cfg.M, cfg.n_colloc
    hx, hy, hz = _spacings_3d(problem, cfg)
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0h, _, V2h = legendre.vandermonde_host(t_int, M_)
    sx, sy, sz = 2.0 / hx, 2.0 / hy, 2.0 / hz

    def t3(Az, Ay, Ax):
        return np.einsum("zk,yl,xm->zyxklm", Az, Ay, Ax).reshape(
            C * C * C, M_ * M_ * M_)

    Lap = (sx * sx * t3(V0h, V0h, V2h) + sy * sy * t3(V0h, V2h, V0h)
           + sz * sz * t3(V2h, V0h, V0h))
    Mass = t3(V0h, V0h, V0h)
    spts = _surface_coords(M_)
    Vz_b = legendre.vandermonde_host(spts[:, 0], M_)[0]
    Vy_b = legendre.vandermonde_host(spts[:, 1], M_)[0]
    Vx_b = legendre.vandermonde_host(spts[:, 2], M_)[0]
    B = np.einsum("pk,pl,pm->pklm", Vz_b, Vy_b, Vx_b).reshape(
        -1, M_ * M_ * M_)
    Z, Pbc = kkt.nullspace_host(B)
    return tuple(torch.as_tensor(v, dtype=dtype) for v in (
        -problem.a0 * Lap, Mass, B, Z, Pbc)) + (t_int, spts)


def hybrid_solve_semilinear_3d(problem: SemilinearProblem3D, cfg,
                               n_newton: int = 8, n_newton_elem: int = 5,
                               scheme: str = "p1", trace_lift: int = 0,
                               device=None) -> SemilinearSolution3D:
    """3D two-level Newton (tensor lift of ``hybrid_solve_semilinear_2d``:
    matrix-free Q1 hex Newton with the lumped-mass nonlinearity and
    Jacobi-CG inner solves, then element-level Newton on the nonlinear
    collocation system).  ``scheme="numerov"``: tensor-Numerov compact rows
    (O(h^4) nodal); ``trace_lift >= 2``: plane-lifted element traces."""
    xs, ys, zs, fem, fem_res = fem_newton_3d(problem, cfg, n_newton,
                                             scheme, device=device)
    dtype, device = xs.dtype, xs.device
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    M_ = cfg.M
    *parts, t_int, spts = _semilinear3d_element_parts_host(problem, cfg,
                                                           dtype)
    parts = tuple(v.to(device) for v in parts)
    E = nx * ny * nz
    # f at the interior collocation points and the traces from the
    # converged FEM grid (g exact on boundary faces)
    f_rows, bc_rows, cs = _element_data_3d(
        _P3DStub(problem), cfg, xs, ys, zs, fem, t_int, spts,
        trace_lift=trace_lift)
    w = _trilinear_fallback_coeffs(cs, M_).reshape(E, M_ * M_ * M_)
    w, res, ok = _element_newton(problem, f_rows, bc_rows, w, parts,
                                 cfg.gamma, n_newton_elem)
    return SemilinearSolution3D(xs, ys, zs, fem,
                                w.reshape(nz, ny, nx, M_, M_, M_), fem_res,
                                res, ok.reshape(nz, ny, nx))


class _P3DStub:
    """The Problem3D attributes ``_element_data_3d`` reads (all faces
    Dirichlet)."""

    def __init__(self, p):
        self.f = p.f
        self.g = p.g
        self.bc_faces = ("dirichlet",) * 6


def evaluate_semilinear_3d(sol: SemilinearSolution3D, x, y, z):
    s3 = Solution3D(sol.xs, sol.ys, sol.zs, sol.fem_values, sol.coeffs, 0,
                    0.0, None, None, None, None)
    return evaluate_3d(s3, x, y, z)
