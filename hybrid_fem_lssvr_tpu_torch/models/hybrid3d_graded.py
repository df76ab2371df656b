"""Graded (non-uniform tensor-product) 3D hex meshes and slack-driven
adaptivity.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/hybrid3d_graded.py``,
the 3D lift of ``hybrid2d_graded``.  The mesh stays a tensor product
``xs [nx+1] x ys [ny+1] x zs [nz+1]`` with arbitrary monotone spacings, so
every per-element operator is a per-element-scalar combination of shared
reference matrices:

- coarse Q1 hex: ``K_e = a0 [(hy hz/2hx) Cxx + (hx hz/2hy) Cyy
  + (hx hy/2hz) Czz] + c (hx hy hz/8) Mh + bx (hy hz/4) Chx + ...``
  (``assembly3d.q1_reference_parts_3d``), applied matrix-free through
  ``apply_stiffness_var_3d`` with the reference parts as the S_q stack and
  the geometric scalars as the coefficient maps; variable diffusion samples
  a(x, y, z) at each element's own quadrature points
  (``q1_reference_quad_parts_3d``);
- enhancement: ``D_e = -a_e (sx_e^2 W200 + sy_e^2 W020 + sz_e^2 W002)
  + (b - grad a)_e . (sx_e W100, sy_e W010, sz_e W001) + c W000`` with
  chain factors ``sx_e = 2/hx_e`` against shared reference tensor-Legendre
  collocation matrices, solved per element by the batched null-space QR
  (``kkt.solve_batched``).  The JAX package has no kernel for this path,
  so neither does the port: it runs batched torch algebra on any device.

D is [E, C^3, M^3]: 16 KB an element at M = C = 4 in float32.

Adaptivity refines the worst x-, y- and z-intervals independently (per-axis
max of the scale-normalised per-element slack), keeping the tensor
product.  Only all-Dirichlet problems run here, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import assembly3d, cg, kkt, legendre
from ..utils.device import resolve as resolve_device
from .hybrid2d_graded import refine_axis
from .hybrid3d import (Problem3D, Solution3D, Solver3DConfig,
                       _element_data_3d, _surface_coords,
                       _trilinear_fallback_coeffs)

_span = torch.profiler.record_function
SPANS = ("prepare_shared_3d_graded", "fem_solve_3d_graded",
         "enhance_3d_graded", "evaluate_3d_graded")


@dataclasses.dataclass(frozen=True)
class Graded3DOperators:
    """Shared host-f64 reference collocation operators (unit chain factors;
    the per-element scaling is applied at solve time).  W{abc}: derivative
    order (a, b, c) along (x, y, z)."""

    W200: torch.Tensor  # [C^3, M^3]  V0z (x) V0y (x) V2x
    W020: torch.Tensor  # [C^3, M^3]  V0z (x) V2y (x) V0x
    W002: torch.Tensor  # [C^3, M^3]  V2z (x) V0y (x) V0x
    W100: torch.Tensor  # [C^3, M^3]  V0z (x) V0y (x) V1x
    W010: torch.Tensor  # [C^3, M^3]  V0z (x) V1y (x) V0x
    W001: torch.Tensor  # [C^3, M^3]  V1z (x) V0y (x) V0x
    W000: torch.Tensor  # [C^3, M^3]  V0z (x) V0y (x) V0x
    B: torch.Tensor  # [S, M^3] shared trace rows (surface points)
    Z: torch.Tensor  # [M^3, (M-2)^3] null basis of B
    Pbc: torch.Tensor  # [M^3, S] min-norm particular map

    def to(self, device=None, dtype=None) -> "Graded3DOperators":
        return kkt.bundle_to(self, device, dtype)


def prepare_shared_3d_graded(problem: Problem3D, cfg: Solver3DConfig):
    """Host float64 precompute of the reference-coordinate operator parts
    (graded analog of ``prepare_shared_3d``; interior collocation points).
    Returns (``Graded3DOperators`` of CPU tensors in the run dtype,
    (t_int, spts) numpy)."""
    if any(t != "dirichlet" for t in problem.bc_faces):
        raise NotImplementedError(
            "this path eliminates all boundary faces structurally "
            "(Dirichlet only); mixed-BC problems run on the uniform path "
            "(HybridSolver3D)")
    M, C = cfg.M, cfg.n_colloc
    dtype = cfg.torch_dtype()
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)

    def t3(Az, Ay, Ax):
        # rows (iz, iy, ix) x cols (kz, ky, kx), both row-major, as
        # prepare_shared_3d.
        return np.einsum("zk,yl,xm->zyxklm", Az, Ay, Ax).reshape(
            C * C * C, M * M * M)

    spts = _surface_coords(M)
    Vz_b = legendre.vandermonde_host(spts[:, 0], M)[0]
    Vy_b = legendre.vandermonde_host(spts[:, 1], M)[0]
    Vx_b = legendre.vandermonde_host(spts[:, 2], M)[0]
    B = np.einsum("pk,pl,pm->pklm", Vz_b, Vy_b, Vx_b).reshape(-1, M * M * M)
    Z, Pbc = kkt.nullspace_host(B)

    def tt(v):
        return torch.as_tensor(v, dtype=dtype)

    gops = Graded3DOperators(
        W200=tt(t3(V0, V0, V2)), W020=tt(t3(V0, V2, V0)),
        W002=tt(t3(V2, V0, V0)), W100=tt(t3(V0, V0, V1)),
        W010=tt(t3(V0, V1, V0)), W001=tt(t3(V1, V0, V0)),
        W000=tt(t3(V0, V0, V0)), B=tt(B), Z=tt(Z), Pbc=tt(Pbc))
    return gops, (t_int, spts)


def _geom_grids(xs, ys, zs):
    """Per-element spacings broadcast to the element grid [nz, ny, nx]."""
    hx, hy, hz = xs[1:] - xs[:-1], ys[1:] - ys[:-1], zs[1:] - zs[:-1]
    shape = (hz.shape[0], hy.shape[0], hx.shape[0])
    return (hx[None, None, :].expand(shape), hy[None, :, None].expand(shape),
            hz[:, None, None].expand(shape))


def graded_fem_parts_3d(problem: Problem3D, xs, ys, zs):
    """Matrix-free per-element operator parts on a graded hex mesh: the
    stacked reference 8x8 blocks Sq (host numpy) and their per-element
    scalar maps [n, nz, ny, nx]."""
    dtype, device = xs.dtype, xs.device
    hx, hy, hz = xs[1:] - xs[:-1], ys[1:] - ys[:-1], zs[1:] - zs[:-1]
    HX, HY, HZ = _geom_grids(xs, ys, zs)
    bx, by, bz = problem.b
    Sq_list, map_list = [], []
    Cxx, Cyy, Czz, Mh, Chx, Chy, Chz = assembly3d.q1_reference_parts_3d()
    if problem.a_var is not None:
        Sxx, Syy, Szz, tq = assembly3d.q1_reference_quad_parts_3d()
        Q = tq.shape[0]

        def quad(v, h, k):
            t = torch.as_tensor(tq[:, k], dtype=dtype, device=device)
            return (0.5 * (v[1:] + v[:-1])[None, :]
                    + 0.5 * h[None, :] * t[:, None])

        xq, yq, zq = quad(xs, hx, 0), quad(ys, hy, 1), quad(zs, hz, 2)
        A = problem.a_var(xq[:, None, None, :], yq[:, None, :, None],
                          zq[:, :, None, None])  # [Q, nz, ny, nx]
        A = A * torch.ones((Q,) + tuple(HX.shape), dtype=dtype,
                           device=device)
        Sq_list += [Sxx[q] for q in range(Q)]
        map_list += [A[q] * HY * HZ / (2.0 * HX) for q in range(Q)]
        Sq_list += [Syy[q] for q in range(Q)]
        map_list += [A[q] * HX * HZ / (2.0 * HY) for q in range(Q)]
        Sq_list += [Szz[q] for q in range(Q)]
        map_list += [A[q] * HX * HY / (2.0 * HZ) for q in range(Q)]
    else:
        Sq_list += [Cxx, Cyy, Czz]
        map_list += [problem.a0 * HY * HZ / (2.0 * HX),
                     problem.a0 * HX * HZ / (2.0 * HY),
                     problem.a0 * HX * HY / (2.0 * HZ)]
    if problem.c != 0.0:
        Sq_list.append(Mh)
        map_list.append(problem.c * HX * HY * HZ / 8.0)
    if bx != 0.0:
        Sq_list.append(Chx)
        map_list.append(bx * HY * HZ / 4.0)
    if by != 0.0:
        Sq_list.append(Chy)
        map_list.append(by * HX * HZ / 4.0)
    if bz != 0.0:
        Sq_list.append(Chz)
        map_list.append(bz * HX * HY / 4.0)
    return np.stack(Sq_list), torch.stack(map_list)


def fem_solve_3d_graded(problem: Problem3D, cfg: Solver3DConfig, xs, ys,
                        zs):
    """Coarse Q1 solve on the graded hex mesh: matrix-free per-element
    operators through reference-part scalar maps; Jacobi-CG (SPD) or
    Jacobi-BiCGStab (nonsymmetric / indefinite).  Multigrid needs nested
    uniform coarsenings, so graded meshes use Jacobi (the 2D graded
    rule)."""
    dtype, device = xs.dtype, xs.device
    bx, by, bz = problem.b
    Sq, a_maps = graded_fem_parts_3d(problem, xs, ys, zs)
    shape = (zs.shape[0], ys.shape[0], xs.shape[0])
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1, 1:-1] = True
    X, Y, Z = xs[None, None, :], ys[None, :, None], zs[:, None, None]
    g_grid = problem.g(X, Y, Z) * torch.ones(shape, dtype=dtype,
                                              device=device)
    u_bc = torch.where(interior, 0.0, g_grid)
    b = assembly3d.assemble_load_3d(xs, ys, zs, problem.f)

    def apply_op(v):
        return assembly3d.apply_stiffness_var_3d(v, Sq, a_maps)

    def apply_free(v):
        return torch.where(interior, apply_op(v * interior), 0.0)

    rhs = torch.where(interior, b - apply_op(u_bc), 0.0)
    diag = assembly3d.stiffness_var_diag_3d(shape, Sq, a_maps, dtype)
    M_inv = torch.where(interior, 1.0 / diag, 1.0)
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    spd = bx == 0.0 and by == 0.0 and bz == 0.0 and problem.c >= 0.0
    solver = cg.cg if spd else cg.bicgstab
    res = solver(apply_free, rhs, M_inv=M_inv, tol=tol,
                 maxiter=cfg.cg_maxiter)
    return u_bc + torch.where(interior, res.x, 0.0), res


def _graded_element_operators_3d(problem: Problem3D, cfg: Solver3DConfig,
                                 xs, ys, zs, gops: Graded3DOperators,
                                 t_int):
    """Batched per-element collocation operators D [E, C^3, M^3] on the
    graded hex mesh: per-element chain factors (and the coefficient fields
    sampled at the collocation points for variable diffusion; grad_a by
    ``torch.autograd`` when the problem has none) against the shared
    reference parts."""
    dtype, device = xs.dtype, xs.device
    nx, ny, nz = xs.shape[0] - 1, ys.shape[0] - 1, zs.shape[0] - 1
    E = nx * ny * nz
    C = cfg.n_colloc
    hx, hy, hz = xs[1:] - xs[:-1], ys[1:] - ys[:-1], zs[1:] - zs[:-1]
    shape = (nz, ny, nx)
    SX = (2.0 / hx)[None, None, :].expand(shape).reshape(E, 1, 1)
    SY = (2.0 / hy)[None, :, None].expand(shape).reshape(E, 1, 1)
    SZ = (2.0 / hz)[:, None, None].expand(shape).reshape(E, 1, 1)
    bx, by, bz = problem.b
    if problem.a_var is not None:
        t = torch.tensor(np.asarray(t_int), dtype=dtype, device=device)
        xq = xs[:-1][:, None] + 0.5 * hx[:, None] * (t[None, :] + 1.0)
        yq = ys[:-1][:, None] + 0.5 * hy[:, None] * (t[None, :] + 1.0)
        zq = zs[:-1][:, None] + 0.5 * hz[:, None] * (t[None, :] + 1.0)
        # [nz, ny, nx, Cz, Cy, Cx], rows and columns row-major as t3.
        ones = torch.ones((nz, ny, nx, C, C, C), dtype=dtype, device=device)
        Xq = xq[None, None, :, None, None, :] * ones
        Yq = yq[None, :, None, None, :, None] * ones
        Zq = zq[:, None, None, :, None, None] * ones

        def samp(fn):
            return (fn(Xq, Yq, Zq) * ones).reshape(E, C * C * C, 1)

        a_e = samp(problem.a_var)
        if problem.grad_a is not None:
            ax_e, ay_e, az_e = (samp(fn) for fn in problem.grad_a)
        else:  # the chain-rule coefficients by autograd
            with torch.enable_grad():
                pts = [v.clone().requires_grad_(True) for v in (Xq, Yq, Zq)]
                total = (problem.a_var(*pts) * ones).sum()
                grads = torch.autograd.grad(total, pts, allow_unused=True)
            ax_e, ay_e, az_e = (
                (torch.zeros_like(Xq) if gv is None else gv).reshape(
                    E, C * C * C, 1) for gv in grads)
    else:
        a_e, ax_e, ay_e, az_e = problem.a0, 0.0, 0.0, 0.0
    D = -a_e * (SX * SX * gops.W200 + SY * SY * gops.W020
                + SZ * SZ * gops.W002)
    cx, cy, cz = bx - ax_e, by - ay_e, bz - az_e  # (b - grad a) . grad u
    if problem.a_var is not None or bx != 0.0:
        D = D + cx * SX * gops.W100
    if problem.a_var is not None or by != 0.0:
        D = D + cy * SY * gops.W010
    if problem.a_var is not None or bz != 0.0:
        D = D + cz * SZ * gops.W001
    if problem.c != 0.0:
        D = D + problem.c * gops.W000
    return D


def enhance_3d_graded(problem: Problem3D, cfg: Solver3DConfig, xs, ys, zs,
                      fem_values, shared_bundle):
    """The enhancement stage alone on the graded mesh: per-element fits
    against the nodal values by the batched null-space solve.  Returns
    (coeffs [nz, ny, nx, M, M, M], KKTDiagnostics); failed elements carry
    the trilinear interpolant."""
    gops, (t_int, spts) = shared_bundle
    nx, ny, nz = xs.shape[0] - 1, ys.shape[0] - 1, zs.shape[0] - 1
    M = cfg.M
    cfg = dataclasses.replace(cfg, nx=nx, ny=ny, nz=nz)
    f_rows, bc_rows, cs = _element_data_3d(problem, cfg, xs, ys, zs,
                                           fem_values, t_int, spts)
    D = _graded_element_operators_3d(problem, cfg, xs, ys, zs, gops, t_int)
    w, diags = kkt.solve_batched(D, gops.B, f_rows, bc_rows, cfg.gamma,
                                 formulation=cfg.formulation,
                                 ZP=(gops.Z, gops.Pbc))
    del D
    shp = (nz, ny, nx)
    coeffs = w.reshape(*shp, M, M, M)
    fb = _trilinear_fallback_coeffs(cs, M)
    ok = diags.solve_ok.reshape(shp)
    coeffs = torch.where(ok[..., None, None, None],
                         torch.where(torch.isfinite(coeffs), coeffs, 0.0), fb)
    return coeffs, diags._replace(solve_ok=ok)


def hybrid_solve_3d_graded(problem: Problem3D, cfg: Solver3DConfig,
                           shared_bundle, xs, ys, zs,
                           device=None) -> Solution3D:
    """Graded coarse Q1 hex solve, then the per-element enhancement, on
    ``device`` (None: the GPU; a machine without one raises).  ``xs``,
    ``ys``, ``zs`` are the node arrays (numpy or torch); the config's
    nx/ny/nz are replaced by their true extents, so the domain-boundary
    face masks see the grown mesh of an adaptive round."""
    device = resolve_device(device)
    gops, pts = shared_bundle
    shared_bundle = (gops.to(device), pts)
    dtype = cfg.torch_dtype()
    xs, ys, zs = (v.to(device=device, dtype=dtype) if torch.is_tensor(v)
                  else torch.tensor(np.asarray(v), dtype=dtype, device=device)
                  for v in (xs, ys, zs))
    nx, ny, nz = xs.shape[0] - 1, ys.shape[0] - 1, zs.shape[0] - 1
    cfg = dataclasses.replace(cfg, nx=nx, ny=ny, nz=nz)
    with _span("fem_solve_3d_graded"):
        if cfg.fem_dtype is not None:
            fd = getattr(torch, cfg.fem_dtype)
            fem_values, cg_res = fem_solve_3d_graded(
                problem, cfg, xs.to(fd), ys.to(fd), zs.to(fd))
            fem_values = fem_values.to(dtype)
        else:
            fem_values, cg_res = fem_solve_3d_graded(problem, cfg, xs, ys,
                                                     zs)
    with _span("enhance_3d_graded"):
        coeffs, diags = enhance_3d_graded(problem, cfg, xs, ys, zs,
                                          fem_values, shared_bundle)
    shp = (nz, ny, nx)
    return Solution3D(
        xs=xs, ys=ys, zs=zs, fem_values=fem_values, coeffs=coeffs,
        cg_iters=cg_res.iters, cg_residual=cg_res.residual,
        max_slack=diags.max_slack.reshape(shp),
        bc_violation=diags.bc_violation.reshape(shp),
        solve_ok=diags.solve_ok, cond_estimate=diags.cond_estimate)


def _locate_graded_3d(sol: Solution3D, x, y, z):
    out = []
    for nodes, p in ((sol.xs, x), (sol.ys, y), (sol.zs, z)):
        n = nodes.shape[0] - 1
        i = torch.clamp(torch.searchsorted(nodes, p.contiguous(),
                                           right=True) - 1, 0, n - 1)
        h = nodes[i + 1] - nodes[i]
        out.append((i, (2.0 * p - nodes[i] - nodes[i + 1]) / h, h))
    return out


def evaluate_3d_graded(sol: Solution3D, x, y, z):
    """u(x, y, z) on the graded hex mesh: ``torch.searchsorted`` element
    lookup per axis, then the batched tensor-Legendre contraction; points
    outside the domain are evaluated in the nearest element."""
    (ix, tx, _), (iy, ty, _), (iz, tz, _) = _locate_graded_3d(sol, x, y, z)
    M = sol.coeffs.shape[-1]
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    (Vz,) = legendre.legendre_vandermonde(tz, M, num_derivs=0)
    W = sol.coeffs[iz, iy, ix]  # [P, M, M, M]
    return torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy, Vx)


def evaluate_3d_graded_gradient(sol: Solution3D, x, y, z):
    """(du/dx, du/dy, du/dz) on the graded hex mesh, with the per-element
    chain factors 2/h_e per axis."""
    (ix, tx, hx), (iy, ty, hy), (iz, tz, hz) = _locate_graded_3d(sol, x, y,
                                                                 z)
    M = sol.coeffs.shape[-1]
    Vx, Vx1 = legendre.legendre_vandermonde(tx, M, num_derivs=1)
    Vy, Vy1 = legendre.legendre_vandermonde(ty, M, num_derivs=1)
    Vz, Vz1 = legendre.legendre_vandermonde(tz, M, num_derivs=1)
    W = sol.coeffs[iz, iy, ix]
    ux = (2.0 / hx) * torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy, Vx1)
    uy = (2.0 / hy) * torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy1, Vx)
    uz = (2.0 / hz) * torch.einsum("pk,pklm,pl,pm->p", Vz1, W, Vy, Vx)
    return ux, uy, uz


class HybridSolver3DGraded:
    """Facade for graded tensor-product hex meshes (mirrors
    ``HybridSolver3D``; the config's nx/ny/nz are ignored: the mesh is the
    node arrays).  Runs on the GPU unless given ``device='cpu'``."""

    def __init__(self, problem: Problem3D, config: Solver3DConfig, xs, ys,
                 zs, device=None):
        self.problem = problem
        self.config = config
        self.xs = np.asarray(xs, np.float64)
        self.ys = np.asarray(ys, np.float64)
        self.zs = np.asarray(zs, np.float64)
        self.device = resolve_device(device)
        with _span("prepare_shared_3d_graded"):
            ops, pts = prepare_shared_3d_graded(problem, config)
            self._shared = (ops.to(self.device), pts)
        self.solution: Optional[Solution3D] = None

    def solve(self) -> Solution3D:
        self.solution = hybrid_solve_3d_graded(
            self.problem, self.config, self._shared, self.xs, self.ys,
            self.zs, device=self.device)
        return self.solution

    def _points(self, *coords):
        if self.solution is None:
            raise RuntimeError("call solve() first")
        dtype = self.solution.xs.dtype
        return tuple(torch.as_tensor(c, dtype=dtype, device=self.device)
                     for c in coords)

    def evaluate_solution(self, x, y, z):
        pts = self._points(x, y, z)
        with _span("evaluate_3d_graded"):
            return evaluate_3d_graded(self.solution, *pts)

    def evaluate_gradient(self, x, y, z):
        return evaluate_3d_graded_gradient(self.solution,
                                           *self._points(x, y, z))

    def errors(self, x, y, z):
        """(linf, l2) of the hybrid solution against the exact oracle."""
        from ..utils import metrics

        u = self.evaluate_solution(x, y, z)
        ue = self.problem.exact(*self._points(x, y, z))
        return metrics.linf_error(u, ue), metrics.l2_error(u, ue)


class AdaptiveResult3D(NamedTuple):
    solution: Solution3D
    xs: np.ndarray
    ys: np.ndarray
    zs: np.ndarray
    history: List[dict]


def adaptive_solve_3d(problem: Problem3D, cfg: Solver3DConfig,
                      rounds: int = 2, refine_frac: float = 0.3,
                      eval_points=None, device=None) -> AdaptiveResult3D:
    """Slack-driven tensor-product adaptivity (3D analog of
    ``adaptive_solve_2d``): each round refines the worst intervals along
    each axis by the over-the-other-axes max of the scale-normalised slack
    (an interval refines across its whole slab).  Starts from the uniform
    cfg mesh."""
    x0, x1, y0, y1, z0, z1 = problem.domain
    xs = np.linspace(x0, x1, cfg.nx + 1)
    ys = np.linspace(y0, y1, cfg.ny + 1)
    zs = np.linspace(z0, z1, cfg.nz + 1)
    history: List[dict] = []
    solver = None
    for r in range(rounds + 1):
        solver = HybridSolver3DGraded(problem, cfg, xs, ys, zs,
                                      device=device)
        sol = solver.solve()
        slack = sol.max_slack.detach().cpu().numpy()  # [nz, ny, nx]
        # Scale-normalised indicator: the raw slack is the PDE residual
        # against rows of size ~ sx^2 + sy^2 + sz^2, which grows ~ 1/h^2 on
        # refined elements; dividing by the row scale keeps elements of
        # different sizes comparable (else refinement feeds back onto the
        # smallest).
        hx, hy, hz = np.diff(xs), np.diff(ys), np.diff(zs)
        row_scale = (((2.0 / hx) ** 2)[None, None, :]
                     + ((2.0 / hy) ** 2)[None, :, None]
                     + ((2.0 / hz) ** 2)[:, None, None])
        slack = slack / row_scale
        rec = {"round": r, "elements": int(slack.size),
               "max_slack": float(slack.max())}
        if eval_points is not None:
            rec["linf"] = float(solver.errors(*eval_points)[0])
        history.append(rec)
        if r == rounds:
            break
        xs = refine_axis(xs, slack.max(axis=(0, 1)), refine_frac)
        ys = refine_axis(ys, slack.max(axis=(0, 2)), refine_frac)
        zs = refine_axis(zs, slack.max(axis=(1, 2)), refine_frac)
    return AdaptiveResult3D(solution=solver.solution, xs=xs, ys=ys, zs=zs,
                            history=history)
