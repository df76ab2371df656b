"""2D linear elasticity (plane strain): the first vector-valued family.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/elastic.py``.  It
extends the two-level hybrid scheme to the coupled elliptic system

    -div sigma(u) = f,   sigma = 2 mu eps(u) + lam tr(eps(u)) I,

for the displacement u = (u1, u2) on a rectangle with Dirichlet data on the
boundary (constant Lame coefficients lam, mu > 0).  Both stages reuse the
scalar machinery block-wise:

* Coarse stage: Q1 vector elements, matrix-free.  The block operator
  [[A11, A12], [A12^T, A22]] is applied through four calls to
  ``assembly2d.apply_stiffness`` with the shared local 4x4 gradient matrices
  (A11 = (lam+2mu) Kxx + mu Kyy, A12 = lam Kxy + mu Kxy^T,
  A22 = mu Kxx + (lam+2mu) Kyy), solved by CG on the stacked
  [2, ny+1, nx+1] grid.  The form is coercive (Korn), so CG applies; the
  preconditioner is block-diagonal: one geometric V-cycle per component on
  its own anisotropic diagonal block (pure-stiffness local operators are
  scale-invariant in 2D, so every level reuses the same 4x4), or Jacobi.
* Enhancement stage: per quad a coupled tensor-Legendre fit.  One shared
  block collocation operator D = [[D11, D12], [D12, D22]] of shape
  [2 C^2, 2 M^2] (the off-diagonal (lam+mu) d2/dxdy rows make the system
  non-separable) and the block-diagonal trace matrix diag(B, B) go through
  the same host-float64 null-space precompute as the scalar families
  (``kkt.precompute_shared_lse_host``); every quad is then one affine map.
  On a CUDA float32 run the fused kernel ``ops.kernels2d_elastic`` applies
  it (``ElasticConfig2D.backend``: 'auto', 'torch' or 'cuda').

``evaluate_stress_2d`` differentiates the element polynomials exactly
(chain factors 2/h); ``recover_stress_2d`` samples them at element centres
and interpolates across elements.  The stages run inside
``torch.profiler.record_function`` spans named in ``SPANS``.  The run has
one dtype (``ElasticConfig2D.dtype``), coarse stage included, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import assembly2d, cg, kernels2d_elastic, kkt, legendre, multigrid
from ..utils.device import resolve as resolve_device
from .hybrid2d import (Problem2D, _bilinear_fallback_coeffs,
                       _boundary_coords, _element_data_2d, _kernel_solve_ok,
                       _locate_2d)

_span = torch.profiler.record_function
SPANS = ("prepare_shared_elastic", "fem_solve_elastic.assemble",
         "fem_solve_elastic.precond_setup", "fem_solve_elastic.krylov",
         "enhance_elastic", "evaluate_elastic_2d")

pi = math.pi


@dataclasses.dataclass(frozen=True)
class ElasticProblem2D:
    """-div sigma(u) = f on a rectangle, u = g on the boundary.  All
    callables take and return torch tensors."""

    name: str
    f1: Callable  # body force components f(x, y)
    f2: Callable
    g1: Callable  # Dirichlet data per displacement component
    g2: Callable
    lam: float = 1.0  # Lame lambda
    mu: float = 1.0  # Lame mu (shear modulus)
    domain: Tuple[float, float, float, float] = (-1.0, 1.0, -1.0, 1.0)
    exact1: Optional[Callable] = None
    exact2: Optional[Callable] = None


def _zero(x, y):
    return torch.zeros_like(x + y)


def sin_elastic_2d(lam: float = 1.0, mu: float = 1.0) -> ElasticProblem2D:
    """Manufactured solution u1 = sin(pi x) sin(pi y),
    u2 = sin(pi x) sin(2 pi y) (both vanish on the boundary of [-1, 1]^2);
    the body force carries the full coupling:

        f1 = (lam+3mu) pi^2 u1 - 2 (lam+mu) pi^2 cos(pi x) cos(2 pi y)
        f2 = (4lam+9mu) pi^2 u2 - (lam+mu) pi^2 cos(pi x) cos(pi y)
    """
    def u1(x, y):
        return torch.sin(pi * x) * torch.sin(pi * y)

    def u2(x, y):
        return torch.sin(pi * x) * torch.sin(2 * pi * y)

    def f1(x, y):
        return pi ** 2 * ((lam + 3 * mu) * u1(x, y)
                          - 2 * (lam + mu) * torch.cos(pi * x)
                          * torch.cos(2 * pi * y))

    def f2(x, y):
        return pi ** 2 * ((4 * lam + 9 * mu) * u2(x, y)
                          - (lam + mu) * torch.cos(pi * x)
                          * torch.cos(pi * y))

    return ElasticProblem2D(name="sin_elastic_2d", f1=f1, f2=f2, g1=_zero,
                            g2=_zero, lam=lam, mu=mu, exact1=u1, exact2=u2)


def poly_elastic_2d(lam: float = 2.0, mu: float = 0.5) -> ElasticProblem2D:
    """Inhomogeneous-Dirichlet polynomial solution u1 = x^3 y, u2 = x y^3
    (g on every edge; the cubic is inside the element trial space, so the
    enhancement floor is set by the FEM traces alone)."""
    def u1(x, y):
        return x ** 3 * y

    def u2(x, y):
        return x * y ** 3

    # u1_xx = 6xy, u1_yy = 0, u2_xy = 3y^2; u2_xx = 0, u2_yy = 6xy,
    # u1_xy = 3x^2.
    def f1(x, y):
        return -((lam + 2 * mu) * 6 * x * y + (lam + mu) * 3 * y ** 2)

    def f2(x, y):
        return -((lam + 2 * mu) * 6 * x * y + (lam + mu) * 3 * x ** 2)

    return ElasticProblem2D(name="poly_elastic_2d", f1=f1, f2=f2, g1=u1,
                            g2=u2, lam=lam, mu=mu, exact1=u1, exact2=u2)


def get_elastic_problem(name: str, **kw) -> ElasticProblem2D:
    table = {"sin_elastic_2d": sin_elastic_2d,
             "poly_elastic_2d": poly_elastic_2d}
    if name not in table:
        raise KeyError(f"unknown elastic problem {name!r}; "
                       f"one of {sorted(table)}")
    return table[name](**kw)


@dataclasses.dataclass(frozen=True)
class ElasticConfig2D:
    """Solver settings (the fields of the JAX ``ElasticConfig2D``)."""

    nx: int = 16
    ny: int = 16
    M: int = 6  # per-dimension Legendre basis (M^2 coeffs per component)
    n_colloc: int = 6  # interior collocation grid per dimension
    cg_tol: Optional[float] = None  # None -> 100 * eps(dtype)
    cg_maxiter: int = 4000
    precond: str = "auto"  # 'auto' | 'jacobi' | 'mg' (block-diagonal
    # component-wise V-cycles; 'auto' picks mg on even >= 8 grids)
    diagnostics: bool = True
    dtype: Optional[str] = None  # 'float32' | 'float64' | None (= float64)
    coarse: str = "q1"  # 'q1' (O(h^2) nodal) | 'richardson' (two block Q1
    # solves at h and h/2 combined as (4 u_{h/2} - u_h)/3 at the coarse
    # nodes: O(h^4) nodal values; pair with trace_lift >= 4)
    trace_lift: int = 0  # 0: bilinear FEM element trace.  >= 2: tangential
    # Lagrange interpolation of nodal grid lines with this stencil width
    # (useful only with coarse='richardson'; forces the torch route)
    backend: str = "auto"  # 'auto' | 'torch' | 'cuda' (enhancement stage)

    def __post_init__(self):
        if self.precond not in ("auto", "jacobi", "mg"):
            raise ValueError(f"unknown precond: {self.precond!r}")
        if self.coarse not in ("q1", "richardson"):
            raise ValueError(f"unknown coarse: {self.coarse!r}")
        if self.trace_lift == 1 or self.trace_lift < 0:
            raise ValueError("trace_lift must be 0 or >= 2")
        if self.backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown backend: {self.backend!r}")

    def torch_dtype(self) -> torch.dtype:
        """The run dtype; float64 when unset (JAX's default under x64)."""
        return getattr(torch, self.dtype or "float64")


class ElasticSolution2D(NamedTuple):
    xs: torch.Tensor  # [nx+1]
    ys: torch.Tensor  # [ny+1]
    fem_values: torch.Tensor  # [2, ny+1, nx+1] nodal displacements
    coeffs: torch.Tensor  # [2, ny, nx, M(ky), M(kx)]
    cg_iters: int
    cg_residual: torch.Tensor
    max_slack: torch.Tensor  # [ny, nx]
    bc_violation: torch.Tensor  # [ny, nx]
    solve_ok: torch.Tensor  # [ny, nx]
    cond_estimate: Optional[torch.Tensor] = None
    lam: float = 1.0
    mu: float = 1.0


@functools.lru_cache(maxsize=None)
def _q1_grad_mats(hx: float, hy: float):
    """Host-f64 local 4x4 gradient Gram matrices on a Q1 rectangle:
    Kxx[a,b] = int dxN_a dxN_b, Kyy likewise, Kxy[a,b] = int dxN_a dyN_b
    (2x2 Gauss, exact for these bilinear integrands)."""
    t, w = assembly2d._rule(2)
    Kxx = np.zeros((4, 4))
    Kyy = np.zeros((4, 4))
    Kxy = np.zeros((4, 4))
    jac = (hx / 2) * (hy / 2)
    for xi, wx in zip(t, w):
        for eta, wy in zip(t, w):
            _, dN_dxi, dN_deta = assembly2d._q1_shape(xi, eta)
            dx = dN_dxi * (2.0 / hx)
            dy = dN_deta * (2.0 / hy)
            Kxx += wx * wy * jac * np.outer(dx, dx)
            Kyy += wx * wy * jac * np.outer(dy, dy)
            Kxy += wx * wy * jac * np.outer(dx, dy)
    return Kxx, Kyy, Kxy


def _block_locals(problem: ElasticProblem2D, hx: float, hy: float):
    """Local 4x4 blocks (A11, A12, A22) of the vector weak form
    int 2 mu eps(u):eps(v) + lam div u div v, host float64 (the port's
    local matrices stay numpy; ``assembly2d`` reads them as scalars)."""
    Kxx, Kyy, Kxy = _q1_grad_mats(hx, hy)
    lam, mu = problem.lam, problem.mu
    A11 = (lam + 2 * mu) * Kxx + mu * Kyy
    A22 = mu * Kxx + (lam + 2 * mu) * Kyy
    A12 = lam * Kxy + mu * Kxy.T
    return A11, A12, A22


def _block_colloc_host(problem: ElasticProblem2D, cfg: ElasticConfig2D):
    """Host-f64 block collocation operators on the shared element.

    Returns ``(D, B, Mass_s, t_int, bpts)``: the [2 C^2, 2 M^2]
    momentum-balance operator D = [[D11, D12], [D12, D22]], the
    block-diagonal trace matrix B = diag(B_s, B_s), and the scalar
    [C^2, M^2] value (mass) rows V0 (x) V0 that the elastodynamics march
    needs for its inertial term.  Interior collocation points, as in the
    scalar 2D path: at a corner every zero-trace tensor polynomial has
    vanishing second derivatives in both axes.
    """
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny
    M, C = cfg.M, cfg.n_colloc
    lam, mu = problem.lam, problem.mu
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)
    sx, sy = 2.0 / hx, 2.0 / hy

    def tens(Vy, Vx):
        return np.einsum("yk,xl->yxkl", Vy, Vx).reshape(C * C, M * M)

    Dxx = (sx * sx) * tens(V0, V2)
    Dyy = (sy * sy) * tens(V2, V0)
    Dxy = (sx * sy) * tens(V1, V1)
    D11 = -((lam + 2 * mu) * Dxx + mu * Dyy)
    D22 = -(mu * Dxx + (lam + 2 * mu) * Dyy)
    D12 = -(lam + mu) * Dxy
    D = np.block([[D11, D12], [D12, D22]])  # [2 C^2, 2 M^2]
    Mass_s = tens(V0, V0)
    bpts = _boundary_coords(M)
    V0y_b = legendre.vandermonde_host(bpts[:, 0], M)[0]
    V0x_b = legendre.vandermonde_host(bpts[:, 1], M)[0]
    Bs = np.einsum("pk,pl->pkl", V0y_b, V0x_b).reshape(-1, M * M)
    K = Bs.shape[0]
    B = np.zeros((2 * K, 2 * M * M))
    B[:K, :M * M] = Bs
    B[K:, M * M:] = Bs
    return D, B, Mass_s, t_int, bpts


def prepare_shared_elastic(problem: ElasticProblem2D, cfg: ElasticConfig2D):
    """Host-f64 shared-LSE precompute of the block operators.  Returns (CPU
    ``SharedOperators`` in the run dtype, (t_int, bpts) numpy)."""
    D, B, _, t_int, bpts = _block_colloc_host(problem, cfg)
    shared = kkt.precompute_shared_lse_host(D, B, cfg.torch_dtype())
    return shared, (t_int, bpts)


def fem_solve_elastic(problem: ElasticProblem2D, cfg: ElasticConfig2D,
                      xs, ys):
    """Vector Q1 nodal displacements [2, ny+1, nx+1] via block matrix-free
    CG (module docstring).  Returns (u, ``cg.CGResult``)."""
    dtype, device = xs.dtype, xs.device
    hx = float((problem.domain[1] - problem.domain[0]) / cfg.nx)
    hy = float((problem.domain[3] - problem.domain[2]) / cfg.ny)
    A11, A12, A22 = _block_locals(problem, hx, hy)
    ny1, nx1 = ys.shape[0], xs.shape[0]

    def apply_block(u):
        r1 = (assembly2d.apply_stiffness(u[0], A11)
              + assembly2d.apply_stiffness(u[1], A12))
        r2 = (assembly2d.apply_stiffness(u[0], A12.T)
              + assembly2d.apply_stiffness(u[1], A22))
        return torch.stack([r1, r2])

    with _span("fem_solve_elastic.assemble"):
        b = torch.stack([assembly2d.assemble_load(xs, ys, problem.f1),
                         assembly2d.assemble_load(xs, ys, problem.f2)])
        interior = multigrid._interior((ny1, nx1), device)
        Y, X = torch.meshgrid(ys, xs, indexing="ij")
        u_bc = torch.stack([
            torch.where(interior, 0.0, g(X, Y) * torch.ones_like(X))
            for g in (problem.g1, problem.g2)])

        def apply_free(v):
            return torch.where(interior, apply_block(v * interior), 0.0)

        rhs = torch.where(interior, b - apply_block(u_bc), 0.0)
    with _span("fem_solve_elastic.precond_setup"):
        precond = cfg.precond
        mg_ok = (cfg.nx % 2 == 0 and cfg.ny % 2 == 0
                 and min(cfg.nx, cfg.ny) >= 8)
        if precond == "auto":
            precond = "mg" if mg_ok else "jacobi"
        if precond == "mg":
            if not mg_ok:
                raise ValueError("precond='mg' needs an even >= 8 grid; "
                                 "use precond='jacobi'")
            # One V-cycle per component on its own anisotropic diagonal
            # block; pure-stiffness local operators are scale-invariant in
            # 2D, so every level reuses the fine 4x4.
            vc1 = multigrid.make_vcycle(ny1, nx1, A11, dtype,
                                        loc_for_level=lambda lvl: A11,
                                        device=device)
            vc2 = multigrid.make_vcycle(ny1, nx1, A22, dtype,
                                        loc_for_level=lambda lvl: A22,
                                        device=device)

            def M_inv(r):
                z1 = vc1(torch.where(interior, r[0], 0.0))
                z2 = vc2(torch.where(interior, r[1], 0.0))
                return torch.where(interior, torch.stack([z1, z2]), 0.0)
        else:
            diag = torch.stack([
                assembly2d.stiffness_diag((ny1, nx1), A, dtype, device)
                for A in (A11, A22)])
            M_inv = torch.where(interior, 1.0 / diag, 1.0)
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    with _span("fem_solve_elastic.krylov"):
        res = cg.cg(apply_free, rhs, M_inv=M_inv, tol=tol,
                    maxiter=cfg.cg_maxiter)
    u = u_bc + torch.where(interior, res.x, 0.0)
    return u, res


def _component_problem(problem: ElasticProblem2D, comp: int) -> Problem2D:
    """Scalar ``Problem2D`` view of one displacement component, just enough
    for ``hybrid2d._element_data_2d`` (f at the collocation points, g on the
    Dirichlet override)."""
    f = problem.f1 if comp == 0 else problem.f2
    g = problem.g1 if comp == 0 else problem.g2
    return Problem2D(name=f"{problem.name}:u{comp + 1}", f=f, g=g,
                     domain=problem.domain)


def _resolve_backend(cfg: ElasticConfig2D, device) -> str:
    """The enhancement route: 'cuda' (the fused kernel) or 'torch'.

    A lifted trace forces 'torch' (the kernel builds the bilinear trace
    itself); 'cuda' on CPU tensors raises; 'auto' takes the kernel for CUDA
    float32 tensors, where chip_smoke's same-run A/B test of
    ``enhance_elastic`` at 1024^2 quads, M = 6, has it faster than the
    torch route (PERF.md, PR 4).  An (M, n_colloc) the kernel was not
    compiled for then raises rather than running torch on the card."""
    if cfg.trace_lift != 0:
        return "torch"
    device = torch.device(device)
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    if cfg.backend != "auto":
        return cfg.backend
    if device.type == "cuda" and cfg.torch_dtype() == torch.float32:
        return "cuda"
    return "torch"


def enhance_elastic(problem: ElasticProblem2D, cfg: ElasticConfig2D, xs, ys,
                    fem_values, shared_bundle):
    """Coupled per-element vector fit: both components' collocation rhs and
    trace rows through the block LSE map, then the scalar families' gate and
    bilinear fallback per element.  Returns (coeffs [2, ny, nx, M, M],
    KKTDiagnostics, cond)."""
    shared, (t_int, bpts) = shared_bundle
    M = cfg.M
    E = cfg.nx * cfg.ny
    corners = [(fv[:-1, :-1], fv[:-1, 1:], fv[1:, :-1], fv[1:, 1:])
               for fv in fem_values]
    if _resolve_backend(cfg, fem_values.device) == "cuda":
        x0, x1, y0, y1 = problem.domain
        geom = (x0, (x1 - x0) / cfg.nx, y0, (y1 - y0) / cfg.ny)
        w, slack, bcv = kernels2d_elastic.fused_enhance_elastic_2d(
            fem_values, shared, (problem.f1, problem.f2),
            (problem.g1, problem.g2), geom, cfg.nx, cfg.ny, t_int, bpts,
            with_diagnostics=cfg.diagnostics)
        if cfg.diagnostics:
            # The tolerance scales with both components' corner magnitudes.
            ok = (_kernel_solve_ok(slack, bcv, corners[0])
                  & _kernel_solve_ok(slack, bcv, corners[1]))
            diags = kkt.KKTDiagnostics(slack, bcv, ok)
        else:
            z = torch.zeros(E, dtype=w.dtype, device=w.device)
            diags = kkt.KKTDiagnostics(
                z, z, torch.all(torch.isfinite(w), dim=-1))
    else:
        rows, traces = [], []
        for comp in range(2):
            f_rows, bc_rows, _ = _element_data_2d(
                _component_problem(problem, comp), cfg, xs, ys,
                fem_values[comp], t_int, bpts, trace_lift=cfg.trace_lift)
            rows.append(f_rows)
            traces.append(bc_rows)
        w, diags = kkt.solve_primal_shared(shared, torch.cat(rows, dim=1),
                                           torch.cat(traces, dim=1))
    coeffs = w.reshape(cfg.ny, cfg.nx, 2, M, M)
    ok = diags.solve_ok.reshape(cfg.ny, cfg.nx)[..., None, None]
    out = []
    for comp in range(2):
        c = coeffs[:, :, comp]
        fb = _bilinear_fallback_coeffs(*corners[comp], M)
        out.append(torch.where(
            ok, torch.where(torch.isfinite(c), c, 0.0), fb))
    return torch.stack(out), diags, shared.cond


def hybrid_solve_elastic(problem: ElasticProblem2D, cfg: ElasticConfig2D,
                         shared_bundle, device=None) -> ElasticSolution2D:
    """Coarse block Q1 solve then the enhancement, on ``device`` (None: the
    GPU; a machine without one raises — pass ``device='cpu'``).  The
    operator bundle of ``prepare_shared_elastic`` is moved there first."""
    device = resolve_device(device)
    shared, pts = shared_bundle
    shared_bundle = (shared.to(device), pts)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = problem.domain

    def nodes(nx, ny):
        return (torch.linspace(x0, x1, nx + 1, dtype=dtype, device=device),
                torch.linspace(y0, y1, ny + 1, dtype=dtype, device=device))

    xs, ys = nodes(cfg.nx, cfg.ny)
    if cfg.coarse == "richardson":
        # Two block Q1 solves (h, h/2): (4 u_{h/2} - u_h)/3 = u + O(h^4) at
        # the shared coarse nodes.  Boundary nodes carry g exactly in both,
        # so the combination keeps the Dirichlet data.
        cfg_f = dataclasses.replace(cfg, nx=2 * cfg.nx, ny=2 * cfg.ny)
        fem_f, cg_res = fem_solve_elastic(problem, cfg_f,
                                          *nodes(2 * cfg.nx, 2 * cfg.ny))
        fem_h, _ = fem_solve_elastic(problem, cfg, xs, ys)
        fem_values = (4.0 * fem_f[:, ::2, ::2] - fem_h) / 3.0
    else:
        fem_values, cg_res = fem_solve_elastic(problem, cfg, xs, ys)
    with _span("enhance_elastic"):
        coeffs, diags, cond = enhance_elastic(problem, cfg, xs, ys,
                                              fem_values, shared_bundle)
    return ElasticSolution2D(
        xs=xs, ys=ys, fem_values=fem_values, coeffs=coeffs,
        cg_iters=cg_res.iters, cg_residual=cg_res.residual,
        max_slack=diags.max_slack.reshape(cfg.ny, cfg.nx),
        bc_violation=diags.bc_violation.reshape(cfg.ny, cfg.nx),
        solve_ok=diags.solve_ok.reshape(cfg.ny, cfg.nx),
        cond_estimate=cond, lam=problem.lam, mu=problem.mu,
    )


def evaluate_elastic_2d(sol: ElasticSolution2D, x, y):
    """(u1, u2) at query points [P]: one tensor-Legendre contraction per
    component (the O(1) uniform lookup of ``hybrid2d.evaluate_2d``)."""
    ix, iy, tx, ty, _, _ = _locate_2d(sol, x, y)
    M = sol.coeffs.shape[-1]
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    return tuple(torch.einsum("pk,pkl,pl->p", Vy, sol.coeffs[comp][iy, ix],
                              Vx) for comp in range(2))


def evaluate_stress_2d(sol: ElasticSolution2D, x, y):
    """(sigma_11, sigma_22, sigma_12) at query points [P] from exact
    element-polynomial derivatives: sigma = 2 mu eps + lam tr(eps) I."""
    ix, iy, tx, ty, hx, hy = _locate_2d(sol, x, y)
    M = sol.coeffs.shape[-1]
    Vx, Vx1 = legendre.legendre_vandermonde(tx, M, num_derivs=1)
    Vy, Vy1 = legendre.legendre_vandermonde(ty, M, num_derivs=1)
    sx, sy = 2.0 / hx, 2.0 / hy
    grads = []
    for comp in range(2):
        W = sol.coeffs[comp][iy, ix]
        grads.append((sx * torch.einsum("pk,pkl,pl->p", Vy, W, Vx1),
                      sy * torch.einsum("pk,pkl,pl->p", Vy1, W, Vx)))
    (u1x, u1y), (u2x, u2y) = grads
    lam, mu = sol.lam, sol.mu
    div = u1x + u2y
    return (2 * mu * u1x + lam * div, 2 * mu * u2y + lam * div,
            mu * (u1y + u2x))


def _lagrange_weights_runtime(t, k: int):
    """[P, k] Lagrange basis weights at stencil-local coordinates t in
    [0, k-1] (runtime points; the static per-element analog is
    ``hybrid2d._lift_weights``)."""
    js = torch.arange(k, dtype=t.dtype, device=t.device)
    diff = t[:, None] - js[None, :]  # [P, k]
    cols = []
    for m in range(k):
        denom = 1.0
        for j in range(k):
            if j != m:
                denom *= (m - j)
        num = torch.prod(torch.where(js[None, :] == m, 1.0, diff), dim=1)
        cols.append(num / denom)
    return torch.stack(cols, dim=1)


def _center_grid_interp(V, x, y, x0, y0, hx, hy, k: int):
    """Tensor Lagrange interpolation of an element-centre grid V [ny, nx] at
    runtime query points (k-point stencil per axis, one-sided windows near
    the boundary)."""
    ny, nx = V.shape
    kx, ky = min(k, nx), min(k, ny)
    ux = (x - x0) / hx - 0.5  # centre-index coordinate
    uy = (y - y0) / hy - 0.5
    ix0 = torch.clamp(torch.floor(ux).to(torch.int64) - (kx - 1) // 2, 0,
                      nx - kx)
    iy0 = torch.clamp(torch.floor(uy).to(torch.int64) - (ky - 1) // 2, 0,
                      ny - ky)
    Wx = _lagrange_weights_runtime(ux - ix0.to(x.dtype), kx)
    Wy = _lagrange_weights_runtime(uy - iy0.to(y.dtype), ky)
    ar = functools.partial(torch.arange, device=V.device)
    win = V[iy0[:, None, None] + ar(ky)[None, :, None],
            ix0[:, None, None] + ar(kx)[None, None, :]]
    return torch.einsum("pa,pab,pb->p", Wy, win, Wx)


def recover_stress_2d(sol: ElasticSolution2D, x, y, stencil: int = 4):
    """Superconvergent stress recovery: (sigma_11, sigma_22, sigma_12) at
    query points from element-centre samples of ``evaluate_stress_2d``,
    interpolated across elements with a ``stencil``-point tensor Lagrange
    window.  The raw readout is O(h) near element edges; at the centres it
    superconverges at O(h^2), and the (cubic, for the default 4)
    interpolation keeps that order everywhere."""
    xs, ys = sol.xs, sol.ys
    nx, ny = xs.shape[0] - 1, ys.shape[0] - 1
    cx = 0.5 * (xs[:-1] + xs[1:])
    cy = 0.5 * (ys[:-1] + ys[1:])
    CY, CX = torch.meshgrid(cy, cx, indexing="ij")
    centres = evaluate_stress_2d(sol, CX.reshape(-1), CY.reshape(-1))
    hx, hy = xs[1] - xs[0], ys[1] - ys[0]
    return tuple(
        _center_grid_interp(c.reshape(ny, nx), x, y, xs[0], ys[0], hx, hy,
                            stencil)
        for c in centres)


class ElasticSolver2D:
    """Facade mirroring ``HybridSolver2D`` for the elasticity system.

    ``device`` is where the solve runs: the GPU by default (a machine
    without one raises), the CPU only on ``device='cpu'``.  The host
    precompute of the operators happens once, at construction."""

    def __init__(self, problem: ElasticProblem2D,
                 config: ElasticConfig2D = ElasticConfig2D(), device=None):
        self.problem = problem
        self.config = config
        self.device = resolve_device(device)
        with _span("prepare_shared_elastic"):
            shared, pts = prepare_shared_elastic(problem, config)
            self._shared = (shared.to(self.device), pts)
        self.solution: Optional[ElasticSolution2D] = None

    def solve(self) -> ElasticSolution2D:
        self.solution = hybrid_solve_elastic(self.problem, self.config,
                                             self._shared, device=self.device)
        return self.solution

    def _points(self, x, y):
        if self.solution is None:
            raise RuntimeError("call solve() first")
        dtype = self.solution.xs.dtype
        return (torch.as_tensor(x, dtype=dtype, device=self.device),
                torch.as_tensor(y, dtype=dtype, device=self.device))

    def evaluate_solution(self, x, y):
        x, y = self._points(x, y)
        with _span("evaluate_elastic_2d"):
            return evaluate_elastic_2d(self.solution, x, y)

    def evaluate_stress(self, x, y, recover: bool = False):
        """Raw derivative readout, or (recover=True) the superconvergent
        centre-sampled recovery (``recover_stress_2d``)."""
        fn = recover_stress_2d if recover else evaluate_stress_2d
        return fn(self.solution, *self._points(x, y))

    def errors(self, x, y):
        """Max over components of (Linf, L2) against the exact
        displacement."""
        from ..utils import metrics

        u1, u2 = self.evaluate_solution(x, y)
        xq, yq = self._points(x, y)
        e1 = self.problem.exact1(xq, yq)
        e2 = self.problem.exact2(xq, yq)
        linf = torch.maximum(metrics.linf_error(u1, e1),
                             metrics.linf_error(u2, e2))
        l2 = torch.maximum(metrics.l2_error(u1, e1),
                           metrics.l2_error(u2, e2))
        return linf, l2
