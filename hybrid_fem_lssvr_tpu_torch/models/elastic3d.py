"""3D linear elasticity on structured hexes: the vector family's tensor lift.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/elastic3d.py`` (2D
version: ``models/elastic.py``):

    -div sigma(u) = f,  sigma = 2 mu eps(u) + lam tr(eps(u)) I,
    u = (u1, u2, u3) on a box, Dirichlet data on all faces.

Block structure (d, e in {x, y, z}):

* Coarse stage: Q1 vector hexes, matrix-free.  The local 8x8 gradient Gram
  matrices K_de[a, b] = int dN_a/dd dN_b/de are tensor products of the 1D
  P1 factors (stiffness ~ 1/h, mass ~ h, convection h-free), so every block
  A^(dd) = (lam+2mu) K_dd + mu (K_ee + K_ff), A^(de) = lam K_de + mu K_de^T
  applies through ``assembly3d.apply_stiffness_3d``: nine calls per
  application on the stacked [3, nz+1, ny+1, nx+1] grid.  Pure-stiffness
  hex locals scale exactly as K(2^l h) = 2^l K(h), so the block-diagonal
  component-wise V-cycle preconditioner rediscretises by scaling.
* Enhancement stage: per hex a coupled fit of three tensor-Legendre
  expansions through one shared block null-space LSE, D^(dd) =
  -[mu Lap + (lam+mu) D_dd], D^(de) = -(lam+mu) D_de ([3 C^3, 3 M^3]) and
  B = diag(Bs, Bs, Bs) on the M^3 - (M-2)^3 surface points; then
  ``kkt.solve_primal_shared`` maps every hex.  The JAX package has no TPU
  kernel for it, so this stage is torch alone (its contraction is one
  ``torch.matmul``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import assembly3d, cg, kkt, legendre, multigrid
from ..utils.device import resolve as resolve_device
from .hybrid3d import (Problem3D, _element_data_3d, _locate_3d,
                       _surface_coords, _trilinear_fallback_coeffs)

_span = torch.profiler.record_function
SPANS = ("prepare_shared_elastic_3d", "fem_solve_elastic_3d.assemble",
         "fem_solve_elastic_3d.precond_setup", "fem_solve_elastic_3d.krylov",
         "enhance_elastic_3d", "evaluate_elastic_3d")

pi = math.pi
_AXES = ("x", "y", "z")


@dataclasses.dataclass(frozen=True)
class ElasticProblem3D:
    """-div sigma(u) = f on a box, u = g on the boundary.  All callables
    take and return torch tensors."""

    name: str
    f: Tuple[Callable, Callable, Callable]  # body force components
    g: Tuple[Callable, Callable, Callable]  # Dirichlet data per component
    lam: float = 1.0
    mu: float = 1.0
    domain: Tuple[float, ...] = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    exact: Optional[Tuple[Callable, Callable, Callable]] = None


def _zero(x, y, z):
    return torch.zeros_like(x + y + z)


def sin_elastic_3d(lam: float = 1.0, mu: float = 1.0) -> ElasticProblem3D:
    """Manufactured coupled solution (all components vanish on the boundary
    of [-1, 1]^3):

        u1 = sin(pi x) sin(pi y) sin(pi z)
        u2 = sin(2 pi x) sin(pi y) sin(pi z)
        u3 = sin(pi x) sin(2 pi y) sin(pi z)

    with f_d = -[mu Lap u_d + (lam+mu) d/dd (div u)] expanded analytically.
    """
    sin, cos = torch.sin, torch.cos

    def u1(x, y, z):
        return sin(pi * x) * sin(pi * y) * sin(pi * z)

    def u2(x, y, z):
        return sin(2 * pi * x) * sin(pi * y) * sin(pi * z)

    def u3(x, y, z):
        return sin(pi * x) * sin(2 * pi * y) * sin(pi * z)

    lm = lam + mu

    def f1(x, y, z):
        s1x, c1x = sin(pi * x), cos(pi * x)
        s1y, c1y = sin(pi * y), cos(pi * y)
        s1z, c1z = sin(pi * z), cos(pi * z)
        ddx_div = (-s1x * s1y * s1z + 2 * cos(2 * pi * x) * c1y * s1z
                   + c1x * sin(2 * pi * y) * c1z)
        return pi ** 2 * (3 * mu * s1x * s1y * s1z - lm * ddx_div)

    def f2(x, y, z):
        s1x, c1x = sin(pi * x), cos(pi * x)
        s1y, c1y = sin(pi * y), cos(pi * y)
        s1z, c1z = sin(pi * z), cos(pi * z)
        s2x = sin(2 * pi * x)
        ddy_div = (c1x * c1y * s1z - s2x * s1y * s1z
                   + 2 * s1x * cos(2 * pi * y) * c1z)
        return pi ** 2 * (6 * mu * s2x * s1y * s1z - lm * ddy_div)

    def f3(x, y, z):
        s1x, c1x = sin(pi * x), cos(pi * x)
        s1y, c1y = sin(pi * y), cos(pi * y)
        s1z, c1z = sin(pi * z), cos(pi * z)
        s2x, s2y = sin(2 * pi * x), sin(2 * pi * y)
        ddz_div = (c1x * s1y * c1z + s2x * c1y * c1z - s1x * s2y * s1z)
        return pi ** 2 * (6 * mu * s1x * s2y * s1z - lm * ddz_div)

    return ElasticProblem3D(name="sin_elastic_3d", f=(f1, f2, f3),
                            g=(_zero, _zero, _zero), lam=lam, mu=mu,
                            exact=(u1, u2, u3))


def poly_elastic_3d(lam: float = 2.0, mu: float = 0.5) -> ElasticProblem3D:
    """Coupled cubic exact solution with nonzero boundary data (inside the
    M >= 4 trial space):

        u1 = x^3 + y^2 z,  u2 = y^3 + z^2 x,  u3 = z^3 + x^2 y

    so div u = 3(x^2 + y^2 + z^2) and f_d = -[mu Lap u_d + (lam+mu) d_d
    div u] has the closed forms below."""

    def u1(x, y, z):
        return x ** 3 + y * y * z

    def u2(x, y, z):
        return y ** 3 + z * z * x

    def u3(x, y, z):
        return z ** 3 + x * x * y

    lm = lam + mu

    def f1(x, y, z):
        return -(mu * (6 * x + 2 * z) + lm * 6 * x)

    def f2(x, y, z):
        return -(mu * (6 * y + 2 * x) + lm * 6 * y)

    def f3(x, y, z):
        return -(mu * (6 * z + 2 * y) + lm * 6 * z)

    return ElasticProblem3D(name="poly_elastic_3d", f=(f1, f2, f3),
                            g=(u1, u2, u3), lam=lam, mu=mu,
                            exact=(u1, u2, u3))


def get_elastic_problem_3d(name: str, **kw) -> ElasticProblem3D:
    reg = {"sin_elastic_3d": sin_elastic_3d,
           "poly_elastic_3d": poly_elastic_3d}
    if name not in reg:
        raise ValueError(f"unknown 3D elastic problem: {name!r}")
    return reg[name](**kw)


@dataclasses.dataclass(frozen=True)
class ElasticConfig3D:
    """Solver settings (the fields of the JAX ``ElasticConfig3D``)."""

    nx: int = 8
    ny: int = 8
    nz: int = 8
    M: int = 4
    n_colloc: int = 4
    cg_tol: Optional[float] = None  # None -> 100 * eps(dtype)
    cg_maxiter: int = 4000
    precond: str = "auto"  # 'auto' | 'jacobi' | 'mg'
    # Damped-Jacobi weight inside the component V-cycles: the diagonal
    # blocks are anisotropic ((lam+2mu) : mu : mu), and at the Laplacian's
    # 0.8 the V-cycle loses mesh independence; 0.6 keeps it.
    mg_omega: float = 0.6
    diagnostics: bool = True
    dtype: Optional[str] = None  # 'float32' | 'float64' | None (= float64)
    coarse: str = "q1"  # 'q1' | 'richardson' ((4 u_{h/2} - u_h)/3 nodal
    # extrapolation -> O(h^4); pair with trace_lift >= 4)
    trace_lift: int = 0

    def __post_init__(self):
        if self.precond not in ("auto", "jacobi", "mg"):
            raise ValueError(f"unknown precond: {self.precond!r}")
        if self.coarse not in ("q1", "richardson"):
            raise ValueError(f"unknown coarse: {self.coarse!r}")
        if self.trace_lift == 1 or self.trace_lift < 0:
            raise ValueError("trace_lift must be 0 or >= 2")

    def torch_dtype(self) -> torch.dtype:
        """The run dtype; float64 when unset (JAX's default under x64)."""
        return getattr(torch, self.dtype or "float64")


class ElasticSolution3D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    fem_values: torch.Tensor  # [3, nz+1, ny+1, nx+1]
    coeffs: torch.Tensor  # [3, nz, ny, nx, M, M, M]
    cg_iters: int
    cg_residual: torch.Tensor
    max_slack: torch.Tensor
    bc_violation: torch.Tensor
    solve_ok: torch.Tensor  # [nz, ny, nx]
    cond_estimate: Optional[torch.Tensor] = None
    lam: float = 1.0
    mu: float = 1.0


@functools.lru_cache(maxsize=None)
def _hex_grad_mats(hx: float, hy: float, hz: float):
    """Host-f64 local 8x8 gradient Gram matrices K_de on a Q1 hex
    (separable 1D factors; corner order a = 4cz + 2cy + cx)."""
    k1, m1, c1 = assembly3d._k1, assembly3d._m1, assembly3d._c1

    def t8(Fz, Fy, Fx):
        return np.einsum("ij,kl,mn->ikmjln", Fz, Fy, Fx).reshape(8, 8)

    c = c1()  # c[i, j] = int n_i n_j' (h-free); int n_i' n_j = c.T
    return {
        "xx": t8(m1(hz), m1(hy), k1(hx)),
        "yy": t8(m1(hz), k1(hy), m1(hx)),
        "zz": t8(k1(hz), m1(hy), m1(hx)),
        "xy": t8(m1(hz), c, c.T),  # int dxN_a dyN_b
        "xz": t8(c, m1(hy), c.T),
        "yz": t8(c, c.T, m1(hx)),
    }


def _block_locals_3d(problem: ElasticProblem3D, hx, hy, hz):
    """({d: A^(dd)}, {de: A^(de)}) host float64 8x8 blocks."""
    K = _hex_grad_mats(hx, hy, hz)
    lam, mu = problem.lam, problem.mu
    diag = {
        "x": (lam + 2 * mu) * K["xx"] + mu * (K["yy"] + K["zz"]),
        "y": (lam + 2 * mu) * K["yy"] + mu * (K["xx"] + K["zz"]),
        "z": (lam + 2 * mu) * K["zz"] + mu * (K["xx"] + K["yy"]),
    }
    off = {de: lam * K[de] + mu * K[de].T for de in ("xy", "xz", "yz")}
    return diag, off


def _block_colloc_host_3d(problem: ElasticProblem3D, cfg: ElasticConfig3D):
    """Host-f64 block collocation operators on the shared hex:
    ``(D, B, Mass_s, t_int, spts)`` with D the [3 C^3, 3 M^3]
    momentum-balance operator, B = diag(Bs, Bs, Bs) the surface-trace
    matrix and Mass_s the scalar [C^3, M^3] value rows V0 (x) V0 (x) V0 (for
    the elastodynamics march)."""
    x0, x1, y0, y1, z0, z1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny
    hz = (z1 - z0) / cfg.nz
    M, C = cfg.M, cfg.n_colloc
    lam, mu = problem.lam, problem.mu
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)
    sx, sy, sz = 2.0 / hx, 2.0 / hy, 2.0 / hz

    def t3(Az, Ay, Ax):
        return np.einsum("zk,yl,xm->zyxklm", Az, Ay, Ax).reshape(
            C * C * C, M * M * M)

    Ddiag = {"x": sx * sx * t3(V0, V0, V2), "y": sy * sy * t3(V0, V2, V0),
             "z": sz * sz * t3(V2, V0, V0)}
    Lap = Ddiag["x"] + Ddiag["y"] + Ddiag["z"]
    Doff = {("x", "y"): sx * sy * t3(V0, V1, V1),
            ("x", "z"): sx * sz * t3(V1, V0, V1),
            ("y", "z"): sy * sz * t3(V1, V1, V0)}
    lm = lam + mu
    blocks = [[-(mu * Lap + lm * Ddiag[d]) if d == e
               else -lm * Doff[(d, e) if (d, e) in Doff else (e, d)]
               for e in _AXES] for d in _AXES]
    D = np.block(blocks)  # [3 C^3, 3 M^3]
    spts = _surface_coords(M)
    Vz_b = legendre.vandermonde_host(spts[:, 0], M)[0]
    Vy_b = legendre.vandermonde_host(spts[:, 1], M)[0]
    Vx_b = legendre.vandermonde_host(spts[:, 2], M)[0]
    Bs = np.einsum("pk,pl,pm->pklm", Vz_b, Vy_b, Vx_b).reshape(
        -1, M * M * M)
    S, M3 = Bs.shape
    B = np.zeros((3 * S, 3 * M3))
    for c_ in range(3):
        B[c_ * S:(c_ + 1) * S, c_ * M3:(c_ + 1) * M3] = Bs
    Mass_s = t3(V0, V0, V0)
    return D, B, Mass_s, t_int, spts


def prepare_shared_elastic_3d(problem: ElasticProblem3D,
                              cfg: ElasticConfig3D):
    """Host-f64 block LSE precompute.  Returns (CPU ``SharedOperators`` in
    the run dtype, (t_int, spts) numpy)."""
    D, B, _, t_int, spts = _block_colloc_host_3d(problem, cfg)
    shared = kkt.precompute_shared_lse_host(D, B, cfg.torch_dtype())
    return shared, (t_int, spts)


def fem_solve_elastic_3d(problem: ElasticProblem3D, cfg: ElasticConfig3D,
                         xs, ys, zs):
    """Vector Q1 hex nodal displacements [3, nz+1, ny+1, nx+1] via block
    matrix-free CG.  Returns (u, ``cg.CGResult``)."""
    dtype, device = xs.dtype, xs.device
    d = problem.domain
    hx = float((d[1] - d[0]) / cfg.nx)
    hy = float((d[3] - d[2]) / cfg.ny)
    hz = float((d[5] - d[4]) / cfg.nz)
    diag_loc, off_loc = _block_locals_3d(problem, hx, hy, hz)
    A = assembly3d.apply_stiffness_3d
    Axy, Axz, Ayz = off_loc["xy"], off_loc["xz"], off_loc["yz"]
    nz1, ny1, nx1 = zs.shape[0], ys.shape[0], xs.shape[0]

    def apply_block(u):
        r1 = A(u[0], diag_loc["x"]) + A(u[1], Axy) + A(u[2], Axz)
        r2 = A(u[0], Axy.T) + A(u[1], diag_loc["y"]) + A(u[2], Ayz)
        r3 = A(u[0], Axz.T) + A(u[1], Ayz.T) + A(u[2], diag_loc["z"])
        return torch.stack([r1, r2, r3])

    with _span("fem_solve_elastic_3d.assemble"):
        b = torch.stack([assembly3d.assemble_load_3d(xs, ys, zs, fc)
                         for fc in problem.f])
        interior = torch.zeros((nz1, ny1, nx1), dtype=torch.bool,
                               device=device)
        interior[1:-1, 1:-1, 1:-1] = True
        X = xs[None, None, :]
        Y = ys[None, :, None]
        Z = zs[:, None, None]
        ones = torch.ones((nz1, ny1, nx1), dtype=dtype, device=device)
        u_bc = torch.stack([torch.where(interior, 0.0, gc(X, Y, Z) * ones)
                            for gc in problem.g])

        def apply_free(v):
            return torch.where(interior, apply_block(v * interior), 0.0)

        rhs = torch.where(interior, b - apply_block(u_bc), 0.0)
    with _span("fem_solve_elastic_3d.precond_setup"):
        precond = cfg.precond
        mg_ok = (cfg.nx % 2 == 0 and cfg.ny % 2 == 0 and cfg.nz % 2 == 0
                 and min(cfg.nx, cfg.ny, cfg.nz) >= 8)
        if precond == "auto":
            precond = "mg" if mg_ok else "jacobi"
        if precond == "mg":
            if not mg_ok:
                raise ValueError("precond='mg' needs an even >= 8 grid; "
                                 "use precond='jacobi'")
            # Component-wise V-cycles on the anisotropic diagonal blocks;
            # pure-stiffness hex locals scale as 2^l per level.
            vcs = [
                multigrid.make_vcycle_3d(
                    nz1, ny1, nx1, diag_loc[ax], dtype, omega=cfg.mg_omega,
                    loc_for_level=lambda lvl, ax=ax: (2.0 ** lvl)
                    * diag_loc[ax], device=device)
                for ax in _AXES
            ]

            def M_inv(r):
                zs_ = [vc(torch.where(interior, r[c_], 0.0))
                       for c_, vc in enumerate(vcs)]
                return torch.where(interior, torch.stack(zs_), 0.0)
        else:
            diag = torch.stack([
                assembly3d.stiffness_diag_3d((nz1, ny1, nx1), diag_loc[ax],
                                             dtype, device)
                for ax in _AXES])
            M_inv = torch.where(interior, 1.0 / diag, 1.0)
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    with _span("fem_solve_elastic_3d.krylov"):
        res = cg.cg(apply_free, rhs, M_inv=M_inv, tol=tol,
                    maxiter=cfg.cg_maxiter)
    u = u_bc + torch.where(interior, res.x, 0.0)
    return u, res


def _component_problem_3d(problem: ElasticProblem3D,
                          comp: int) -> Problem3D:
    return Problem3D(name=f"{problem.name}:u{comp + 1}",
                     f=problem.f[comp], g=problem.g[comp],
                     domain=problem.domain)


def enhance_elastic_3d(problem: ElasticProblem3D, cfg: ElasticConfig3D, xs,
                       ys, zs, fem_values, shared_bundle):
    """Coupled vector fit: the three components' collocation and trace rows
    stacked through the block LSE map (3D mirror of
    ``elastic.enhance_elastic``'s torch route).  Returns (coeffs
    [3, nz, ny, nx, M, M, M], KKTDiagnostics, cond)."""
    shared, (t_int, spts) = shared_bundle
    M = cfg.M
    rows, traces, corners = [], [], []
    for comp in range(3):
        f_rows, bc_rows, cs = _element_data_3d(
            _component_problem_3d(problem, comp), cfg, xs, ys, zs,
            fem_values[comp], t_int, spts, trace_lift=cfg.trace_lift)
        rows.append(f_rows)
        traces.append(bc_rows)
        corners.append(cs)
    w, diags = kkt.solve_primal_shared(shared, torch.cat(rows, dim=1),
                                       torch.cat(traces, dim=1))
    shp = (cfg.nz, cfg.ny, cfg.nx)
    coeffs = w.reshape(*shp, 3, M, M, M)
    ok = diags.solve_ok.reshape(shp)[..., None, None, None]
    out = []
    for comp in range(3):
        c = coeffs[..., comp, :, :, :]
        fb = _trilinear_fallback_coeffs(corners[comp], M)
        out.append(torch.where(ok, torch.where(torch.isfinite(c), c, 0.0),
                               fb))
    return torch.stack(out), diags, shared.cond


def hybrid_solve_elastic_3d(problem: ElasticProblem3D, cfg: ElasticConfig3D,
                            shared_bundle, device=None) -> ElasticSolution3D:
    """Coarse block Q1 solve then the enhancement, on ``device`` (None: the
    GPU; a machine without one raises — pass ``device='cpu'``)."""
    device = resolve_device(device)
    shared, pts = shared_bundle
    shared_bundle = (shared.to(device), pts)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1, z0, z1 = problem.domain

    def nodes(n, lo, hi):
        return torch.linspace(lo, hi, n + 1, dtype=dtype, device=device)

    xs, ys, zs = (nodes(cfg.nx, x0, x1), nodes(cfg.ny, y0, y1),
                  nodes(cfg.nz, z0, z1))
    if cfg.coarse == "richardson":
        # (4 u_{h/2} - u_h)/3 at the shared coarse nodes -> O(h^4) nodal
        # values (2D rationale in ``elastic.hybrid_solve_elastic``).
        cfg_f = dataclasses.replace(cfg, nx=2 * cfg.nx, ny=2 * cfg.ny,
                                    nz=2 * cfg.nz)
        fem_f, cg_res = fem_solve_elastic_3d(
            problem, cfg_f, nodes(2 * cfg.nx, x0, x1),
            nodes(2 * cfg.ny, y0, y1), nodes(2 * cfg.nz, z0, z1))
        fem_h, _ = fem_solve_elastic_3d(problem, cfg, xs, ys, zs)
        fem_values = (4.0 * fem_f[:, ::2, ::2, ::2] - fem_h) / 3.0
    else:
        fem_values, cg_res = fem_solve_elastic_3d(problem, cfg, xs, ys, zs)
    with _span("enhance_elastic_3d"):
        coeffs, diags, cond = enhance_elastic_3d(
            problem, cfg, xs, ys, zs, fem_values, shared_bundle)
    shp = (cfg.nz, cfg.ny, cfg.nx)
    return ElasticSolution3D(
        xs=xs, ys=ys, zs=zs, fem_values=fem_values, coeffs=coeffs,
        cg_iters=cg_res.iters, cg_residual=cg_res.residual,
        max_slack=diags.max_slack.reshape(shp),
        bc_violation=diags.bc_violation.reshape(shp),
        solve_ok=diags.solve_ok.reshape(shp),
        cond_estimate=cond, lam=problem.lam, mu=problem.mu,
    )


def evaluate_elastic_3d(sol: ElasticSolution3D, x, y, z):
    """(u1, u2, u3) at query points [P]."""
    (ix, tx, _), (iy, ty, _), (iz, tz, _) = _locate_3d(sol, x, y, z)
    M = sol.coeffs.shape[-1]
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    (Vz,) = legendre.legendre_vandermonde(tz, M, num_derivs=0)
    return tuple(torch.einsum("pk,pklm,pl,pm->p", Vz,
                              sol.coeffs[comp][iz, iy, ix], Vy, Vx)
                 for comp in range(3))


def evaluate_stress_3d(sol: ElasticSolution3D, x, y, z):
    """(s11, s22, s33, s12, s13, s23) at query points [P] from exact
    element-polynomial derivatives: sigma = 2 mu eps + lam tr(eps) I."""
    (ix, tx, hx), (iy, ty, hy), (iz, tz, hz) = _locate_3d(sol, x, y, z)
    M = sol.coeffs.shape[-1]
    Vx, Vx1 = legendre.legendre_vandermonde(tx, M, num_derivs=1)
    Vy, Vy1 = legendre.legendre_vandermonde(ty, M, num_derivs=1)
    Vz, Vz1 = legendre.legendre_vandermonde(tz, M, num_derivs=1)
    grads = []
    for comp in range(3):
        W = sol.coeffs[comp][iz, iy, ix]
        grads.append((
            (2.0 / hx) * torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy, Vx1),
            (2.0 / hy) * torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy1, Vx),
            (2.0 / hz) * torch.einsum("pk,pklm,pl,pm->p", Vz1, W, Vy, Vx)))
    (u1x, u1y, u1z), (u2x, u2y, u2z), (u3x, u3y, u3z) = grads
    lam, mu = sol.lam, sol.mu
    div = u1x + u2y + u3z
    return (2 * mu * u1x + lam * div, 2 * mu * u2y + lam * div,
            2 * mu * u3z + lam * div, mu * (u1y + u2x), mu * (u1z + u3x),
            mu * (u2z + u3y))


class ElasticSolver3D:
    """Facade mirroring ``ElasticSolver2D`` on structured hexes.

    ``device`` is where the solve runs: the GPU by default (a machine
    without one raises), the CPU only on ``device='cpu'``."""

    def __init__(self, problem: ElasticProblem3D,
                 config: ElasticConfig3D = ElasticConfig3D(), device=None):
        self.problem = problem
        self.config = config
        self.device = resolve_device(device)
        with _span("prepare_shared_elastic_3d"):
            shared, pts = prepare_shared_elastic_3d(problem, config)
            self._shared = (shared.to(self.device), pts)
        self.solution: Optional[ElasticSolution3D] = None

    def solve(self) -> ElasticSolution3D:
        self.solution = hybrid_solve_elastic_3d(
            self.problem, self.config, self._shared, device=self.device)
        return self.solution

    def _points(self, *coords):
        if self.solution is None:
            raise RuntimeError("call solve() first")
        dtype = self.solution.xs.dtype
        return tuple(torch.as_tensor(c, dtype=dtype, device=self.device)
                     for c in coords)

    def evaluate_solution(self, x, y, z):
        pts = self._points(x, y, z)
        with _span("evaluate_elastic_3d"):
            return evaluate_elastic_3d(self.solution, *pts)

    def evaluate_stress(self, x, y, z):
        return evaluate_stress_3d(self.solution, *self._points(x, y, z))

    def errors(self, x, y, z):
        """Max over components of (Linf, L2) against the exact
        displacement."""
        from ..utils import metrics

        us = self.evaluate_solution(x, y, z)
        pts = self._points(x, y, z)
        linf = l2 = None
        for u, exact in zip(us, self.problem.exact):
            e = exact(*pts)
            a, b = metrics.linf_error(u, e), metrics.l2_error(u, e)
            linf = a if linf is None else torch.maximum(linf, a)
            l2 = b if l2 is None else torch.maximum(l2, b)
        return linf, l2
