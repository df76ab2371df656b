"""Sturm–Liouville eigenvalue family: A u = lambda M u, hybrid-enhanced.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/eigen.py``.  The
symmetric eigenproblem

    L u = -(a(x) u')' + c(x) u = lambda u   on (x0, x1),   u(x0)=u(x1)=0

(and -a0 Lap u + c u = lambda u on a rectangle or a box, all-Dirichlet)
runs through the same two-level scheme as the source problems: given a FEM
eigenpair (lambda_h, u_h), each element fits the SHIFTED operator
L - lambda_h with zero rhs and traces pinned to the FEM nodal eigenvector,
i.e. the ordinary enhancement of a derived problem with c <- c - lambda_h
and f <- 0; the eigenvalue is re-read from the enhanced polynomial's
Rayleigh quotient, whose error is quadratic in the eigenfunction error.

1. ``fem_eigensolve`` (JAX :171-229) — the P1 (or Numerov) tridiagonal
   pencil on interior dofs by inverse subspace iteration: V <- A^{-1} (M V)
   (one multi-column tridiagonal solve a step), M-orthonormalisation
   through a Cholesky of the K x K Gram, then one host Rayleigh–Ritz.
2. ``enhance_eigenpair`` (:252) — the derived-problem enhancement: on a
   CUDA float32 run of a constant-coefficient problem it is
   ``fused_enhance_shared`` with f = 0, otherwise the per-element route.
3. ``rayleigh_quotient`` (:289) and ``hybrid_eigensolve`` (:296) — the
   per-pair fixed point, ``rq_iters`` rounds.
2D (:360-601) and 3D (:603-876): the Q1 (or tensor-Numerov) pencil with an
MG-CG (or Jacobi-CG) inner solve per subspace column, the enhancement
through ``hybrid2d.enhance_2d`` / ``hybrid3d.enhance_3d`` with the lifted
trace (``EigenConfig.trace_lift``); the mixed-precision routes (:893-998)
run the pencil and the quotient in float64 and the enhancement in float32,
where a lift of 0 puts it on the stacked 2D and 3D kernels; the quotient
there is the DG-corrected one (:1001-1113).

Dropped or changed from the JAX package:
* ``fem_eigensolve`` calls ``tridiag.solve(method='auto')`` where JAX
  calls ``tridiag.thomas`` inside a ``lax.scan``: Thomas up to 8,192 rows
  (the same arithmetic), SPIKE above, where the port's Thomas is a Python
  loop of 2n row steps on the card.
* JAX's ``lax.scan`` over iterations and subspace columns (and ``vmap``
  over columns) are Python loops; ``jax.jit`` has no counterpart.
* The Gram Cholesky goes through ``torch.linalg.cholesky_ex`` and gives
  NaNs for a Gram that is not positive definite, as JAX's does, where
  ``torch.linalg.cholesky`` would raise.
* The mixed routes' ``jax_enable_x64`` check (:903, :959) has no torch
  meaning (float64 is always there) and is gone.
The float32 gate of the 2D and 3D pencils (``_require_f64_eigen``) raises
the JAX package's ValueError.  Entry points run on the GPU unless given
``device='cpu'``; the pencil and the enhancement rounds run inside the
``torch.profiler`` spans named in ``SPANS``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import assembly, assembly2d, assembly3d, cg, legendre, \
    multigrid, tridiag
from ..ops import eval as ops_eval
from ..utils.device import resolve as resolve_device
from . import transient
from .hybrid import SolverConfig, lssvr_enhance, prepare_shared_host, \
    uniform_nodes
from .hybrid2d import (Solution2D, _lifted_trace_2d, enhance_2d,
                       evaluate_2d, prepare_shared_2d)
from .hybrid3d import (Solution3D, _lifted_trace_3d, enhance_3d,
                       evaluate_3d, prepare_shared_3d)
from .problem import Problem1D, _zero

_span = torch.profiler.record_function
SPANS = ("fem_eigensolve", "enhance_eigenpairs")


@dataclasses.dataclass(frozen=True)
class EigenConfig:
    """Eigensolver knobs (validated, frozen — like every config here)."""

    k: int = 4  # number of smallest eigenpairs
    iters: int = 40  # inverse subspace iterations
    mass: str = "consistent"  # 'consistent' | 'numerov'
    rq_iters: int = 2  # enhancement <-> Rayleigh-quotient rounds
    oversample: int = 2  # extra subspace vectors (guard the K-th pair)
    # 2D/3D: tangential-interpolation stencil width for the element-edge
    # trace lift (>= 2; 0 disables and keeps the O(h^2) bilinear trace).
    # Valid only because eigenvector NODAL values are high-order (exact on
    # tensor pencils), unlike source-problem solves.
    trace_lift: int = 6

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if self.mass not in ("consistent", "numerov"):
            raise ValueError(f"unknown mass: {self.mass!r}")
        if self.rq_iters < 0:
            raise ValueError(f"rq_iters must be >= 0, got {self.rq_iters}")
        if self.oversample < 0:
            raise ValueError(
                f"oversample must be >= 0, got {self.oversample}")


class EigenSolution(NamedTuple):
    nodes: torch.Tensor  # [N]
    lams: torch.Tensor  # [K] Rayleigh–Ritz eigenvalues, ascending
    vectors: torch.Tensor  # [N, K] M-orthonormal nodal eigenvectors
    residuals: torch.Tensor  # [K] ||A v - lam M v||_inf diagnostics


class HybridEigenSolution(NamedTuple):
    fem: EigenSolution
    coeffs: torch.Tensor  # [K, E, M] per-element Legendre coefficients
    lams: torch.Tensor  # [K] enhanced (Rayleigh-quotient) eigenvalues
    solve_ok: torch.Tensor  # [K, E] enhancement fallback mask


def _check_symmetric_dirichlet(problem: Problem1D, nodes):
    if problem.bc_left != "dirichlet" or problem.bc_right != "dirichlet":
        raise NotImplementedError(
            "eigensolver requires Dirichlet ends (natural-BC eigenproblems "
            "need the boundary mass terms in the pencil)")
    if problem.b is not None and problem.b is not _zero:
        if bool(torch.any(torch.as_tensor(problem.b(nodes)) != 0.0)):
            raise NotImplementedError(
                "eigensolver requires b == 0 (symmetric pencil)")


def _pencil(problem: Problem1D, nodes, cfg: SolverConfig, mass: str):
    """Interior-dof diagonals of the stiffness/mass pencil (A, M)."""
    def zero_f(x):
        return torch.zeros_like(x)

    if mass == "numerov":
        A, Mm, _, _ = transient._numerov_setup(
            problem, nodes, lambda x, t: torch.zeros_like(x))
    else:
        sub_a, main_a, sup_a, _ = assembly.assemble_p1(
            nodes, problem.a, None, problem.c, zero_f,
            quad_order=cfg.fem_quad_order)
        sub_m, main_m, sup_m, _ = assembly.assemble_p1(
            nodes, None, None, lambda x: torch.ones_like(x), zero_f,
            quad_order=cfg.fem_quad_order)
        A = (sub_a, main_a, sup_a)
        Mm = (sub_m, main_m, sup_m)

    def interior(trip):
        sub, main, sup = trip
        sub, sup = sub[1:-1].clone(), sup[1:-1].clone()
        sub[0] = 0.0
        sup[-1] = 0.0
        return sub, main[1:-1], sup

    return interior(A), interior(Mm)


def _tri_matvec(trip, V):
    """Tridiagonal multi-vector product, V: [n, K]."""
    sub, main, sup = trip
    zero = torch.zeros_like(V[:1])
    up = torch.cat([V[1:], zero])
    dn = torch.cat([zero, V[:-1]])
    return main[:, None] * V + sub[:, None] * dn + sup[:, None] * up


def _cholesky(G):
    """Lower Cholesky factor; NaNs where G is not positive definite (JAX's
    behaviour; ``torch.linalg.cholesky`` would raise)."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where(info != 0, torch.nan, L)


def _orthonormalize_rows(Vf, G):
    """Vf [K, n] <- L^{-1} Vf with L = chol(sym(G)): the rows made
    orthonormal in the inner product whose Gram is G."""
    L = _cholesky(0.5 * (G + G.T))
    return torch.linalg.solve_triangular(L, Vf, upper=False)


def _m_orthonormalize(Mt, V):
    """V <- V R^{-1} with R = chol(V^T M V)^T (Cholesky QR in the M inner
    product; K x K, well conditioned after the first iteration)."""
    return _orthonormalize_rows(V.T, V.T @ _tri_matvec(Mt, V)).T


def _rayleigh_ritz(H, G, K: int):
    """Host float64 Rayleigh–Ritz on the K_s x K_s projected pencil
    (setup-class work, as ``prepare_shared_host``): (w [K], Q [K_s, K])."""
    Hn = H.detach().cpu().numpy().astype(np.float64)
    Gn = G.detach().cpu().numpy().astype(np.float64)
    Ln = np.linalg.cholesky(Gn)
    Hs = np.linalg.solve(Ln, np.linalg.solve(Ln, Hn).T).T
    w, S = np.linalg.eigh(0.5 * (Hs + Hs.T))
    return w[:K], np.linalg.solve(Ln.T, S)[:, :K]


def _signs(first, dtype):
    """+-1 making each vector's first interior value non-negative."""
    return torch.where(first >= 0, 1.0, -1.0).to(dtype)


def _require_f64_eigen(dtype, where: str):
    """Loud float32 gate for the 2D/3D eigensolves: their float32
    inverse-iteration pencil residual floors at ~1e-2 at 32^2, so
    eigenvalues and vectors would be silently garbage.  The 1D path is not
    gated: its float32 pipeline reaches the float32 quotient floor."""
    if dtype == torch.float32:
        raise ValueError(
            f"{where} requires dtype='float64': the f32 inverse-iteration "
            "pencil residual floors at ~1e-2 (the mixed routes run the "
            "pencil in f64 and the enhancement in f32)")


def fem_eigensolve(problem: Problem1D, cfg: SolverConfig,
                   ecfg: EigenConfig = EigenConfig(),
                   nodes: Optional[torch.Tensor] = None,
                   device=None) -> EigenSolution:
    """K smallest eigenpairs of the P1 (or Numerov) pencil.

    Deterministic sine-sheet start (the exact eigenvectors of the
    constant-coefficient pencil on a uniform mesh), ``ecfg.iters`` inverse
    subspace iterations, host Rayleigh–Ritz.  ``nodes`` (default: uniform)
    are moved to ``device``.
    """
    dtype = cfg.torch_dtype()
    device = resolve_device(device)
    if nodes is None:
        nodes = uniform_nodes(problem, cfg.num_nodes, dtype, device)
    else:
        nodes = torch.as_tensor(nodes).to(device)
    _check_symmetric_dirichlet(problem, nodes)
    At, Mt = _pencil(problem, nodes, cfg, ecfg.mass)

    x0, x1 = problem.domain
    L = x1 - x0
    K = ecfg.k
    Ks = K + ecfg.oversample
    n = nodes.shape[0] - 2
    if Ks > n:
        raise ValueError(
            f"k + oversample = {Ks} exceeds interior dofs ({n})")
    xi = nodes[1:-1]
    js = torch.arange(1, Ks + 1, dtype=dtype, device=device)
    V = _m_orthonormalize(
        Mt, torch.sin(math.pi * js[None, :] * (xi[:, None] - x0) / L))
    for _ in range(ecfg.iters):
        W = tridiag.solve(*At, _tri_matvec(Mt, V), method="auto")
        V = _m_orthonormalize(Mt, W)
    H = V.T @ _tri_matvec(At, V)
    G = V.T @ _tri_matvec(Mt, V)
    w, Q = _rayleigh_ritz(0.5 * (H + H.T), 0.5 * (G + G.T), K)
    lams = torch.as_tensor(w, dtype=dtype, device=device)
    Vr = V @ torch.as_tensor(Q, dtype=dtype, device=device)  # [n, K]
    # Sign convention: positive slope at the left end (u[1] > 0), matching
    # sqrt(2/L) sin(j pi (x - x0)/L).
    Vr = Vr * _signs(Vr[0], dtype)[None, :]
    res = torch.abs(_tri_matvec(At, Vr)
                    - lams[None, :] * _tri_matvec(Mt, Vr)).amax(dim=0)
    vecs = torch.zeros((nodes.shape[0], K), dtype=dtype, device=device)
    vecs[1:-1, :] = Vr
    return EigenSolution(nodes, lams, vecs, res)


def _shifted_problem(problem: Problem1D, lam: float) -> Problem1D:
    """The enhancement's derived source problem: (L - lam) p = 0 with the
    FEM eigenvector traces as Dirichlet pins."""
    base_c = problem.c
    return dataclasses.replace(
        problem,
        name=f"{problem.name}_eig_shift",
        f=_zero,
        c=lambda x: base_c(x) - lam,
        g_left=0.0,
        g_right=0.0,
        f_shifted=None,
        f_elem_factors=None,
        f_colloc_factors=None,
        f_translation=None,
        exact=None,
        exact_dx=None,
    )


def enhance_eigenpair(problem: Problem1D, nodes, lam: float, u_nodal,
                      cfg: SolverConfig):
    """Per-element LSSVR fit of the shifted homogeneous operator, traces
    pinned to the FEM nodal eigenvector (f = 0, c -> c - lam), on the
    nodes' device -> (w [E, M], KKTDiagnostics)."""
    shifted = _shifted_problem(problem, float(lam))
    shared = prepare_shared_host(shifted, cfg)
    if shared is not None:
        shared = shared.to(nodes.device)
    x0, x1 = problem.domain
    h = (x1 - x0) / (cfg.num_nodes - 1)
    geom = (x0, h) if shifted.constant_coeffs else None
    return lssvr_enhance(shifted, nodes, u_nodal.contiguous(), cfg,
                         shared_ops=shared, uniform_geom=geom)


def _quadrature_forms(problem: Problem1D, nodes, coeffs, cfg: SolverConfig):
    """(int a p'^2 + c p^2, int p^2) over the piecewise polynomial, by
    per-element Gauss quadrature exact for the polynomial terms (degree
    2M-2 -> M+1 points; coefficient variation is smooth)."""
    dtype, device = coeffs.dtype, coeffs.device
    tq, wq = np.polynomial.legendre.leggauss(cfg.M + 2)
    t = torch.as_tensor(tq, dtype=dtype, device=device)
    w = torch.as_tensor(wq, dtype=dtype, device=device)
    V0, V1 = legendre.legendre_vandermonde(t, cfg.M, num_derivs=1)
    xl, xr = nodes[:-1], nodes[1:]
    h = (xr - xl)[:, None]  # [E, 1]
    xq = 0.5 * (xl + xr)[:, None] + 0.5 * h * t[None, :]  # [E, Q]
    P = coeffs @ V0.T  # [E, Q]
    dP = (coeffs @ V1.T) * (2.0 / h)
    a = problem.a(xq) * torch.ones_like(xq)
    c = problem.c(xq) * torch.ones_like(xq)
    dx = 0.5 * h * w[None, :]
    num = torch.sum(dx * (a * dP**2 + c * P**2))
    den = torch.sum(dx * P**2)
    return num, den


def rayleigh_quotient(problem: Problem1D, nodes, coeffs, cfg: SolverConfig):
    """lambda* — the quotient's error is quadratic in the eigenfunction
    error, which is what buys the enhanced eigenvalues their floor."""
    num, den = _quadrature_forms(problem, nodes, coeffs, cfg)
    return num / den


def hybrid_eigensolve(problem: Problem1D, cfg: SolverConfig,
                      ecfg: EigenConfig = EigenConfig(),
                      device=None) -> HybridEigenSolution:
    """FEM eigensolve, then per-pair enhancement with Rayleigh-quotient
    eigenvalue refinement.

    Each round enhances with the current lambda (a host float: it enters
    the shared-operator precompute) and re-reads lambda from the enhanced
    polynomial's quotient; ``rq_iters=2`` is saturated.  Output
    convention: unit continuous L2 norm.
    """
    with _span("fem_eigensolve"):
        fem = fem_eigensolve(problem, cfg, ecfg, device=device)
    coeffs_all, lams, oks = [], [], []
    with _span("enhance_eigenpairs"):
        for j in range(ecfg.k):
            lam = float(fem.lams[j])
            u = fem.vectors[:, j]
            coeffs, diags = None, None
            for _ in range(max(1, ecfg.rq_iters)):
                coeffs, diags = enhance_eigenpair(problem, fem.nodes, lam,
                                                  u, cfg)
                lam = float(rayleigh_quotient(problem, fem.nodes, coeffs,
                                              cfg))
            _, den = _quadrature_forms(problem, fem.nodes, coeffs, cfg)
            coeffs_all.append(coeffs / torch.sqrt(den))
            lams.append(lam)
            oks.append(diags.solve_ok)
    return HybridEigenSolution(
        fem, torch.stack(coeffs_all),
        torch.tensor(lams, dtype=fem.lams.dtype, device=fem.lams.device),
        torch.stack(oks))


def evaluate_eigenfunction(sol: HybridEigenSolution, j: int, x):
    """Enhanced eigenfunction j at query points x (the source problems'
    clamped read path)."""
    return ops_eval.evaluate(sol.fem.nodes, sol.coeffs[j], x)


def exact_eigenvalues(problem: Problem1D, k: int, c0: float = 0.0):
    """(j pi / L)^2 + c0 for the constant-coefficient pencil — the test
    oracle for poisson/helmholtz-type problems."""
    x0, x1 = problem.domain
    L = x1 - x0
    j = np.arange(1, k + 1)
    return (j * np.pi / L) ** 2 + c0


# ---------------------------------------------------------------------------
# 2D: -a0 Lap(u) + c u = lambda u on the rectangle, all-Dirichlet.
#
# The reaction term shifts the pencil EXACTLY (A(c) = A(0) + c Mass), so the
# iteration always runs on the SPD a0-Laplacian pencil and adds c afterwards.
# ---------------------------------------------------------------------------


class EigenSolution2D(NamedTuple):
    xs: torch.Tensor  # [nx+1]
    ys: torch.Tensor  # [ny+1]
    lams: torch.Tensor  # [K] ascending (includes the +c shift)
    vectors: torch.Tensor  # [K, ny+1, nx+1] Mass-orthonormal nodal grids
    residuals: torch.Tensor  # [K] ||A v - mu M v||_inf of the SPD pencil


class HybridEigenSolution2D(NamedTuple):
    fem: EigenSolution2D
    coeffs: torch.Tensor  # [K, ny, nx, M, M]
    lams: torch.Tensor  # [K] enhanced (Rayleigh-quotient) eigenvalues
    solve_ok: torch.Tensor  # [K, ny, nx]


def _check_2d_eligible(p):
    if any(t != "dirichlet" for t in p.bc_edges):
        raise NotImplementedError(
            "2D eigensolver requires all-Dirichlet edges")
    if tuple(p.b) != (0.0, 0.0):
        raise NotImplementedError(
            "2D eigensolver requires b == 0 (symmetric pencil)")
    if p.a_var is not None:
        raise NotImplementedError(
            "2D eigensolver requires constant diffusion")


def _mode_table(p, Ks: int):
    """First Ks tensor modes (i, j) of the a0-Laplacian, ascending."""
    x0, x1, y0, y1 = p.domain
    Lx, Ly = x1 - x0, y1 - y0
    cand = [(p.a0 * np.pi**2 * (i**2 / Lx**2 + j**2 / Ly**2), i, j)
            for i in range(1, Ks + 2) for j in range(1, Ks + 2)]
    cand.sort()
    return cand[:Ks], (x0, Lx, y0, Ly)


def _inverse_iteration(V0, interior, apply_free, apply_mass, M_inv, tol,
                       cfg, ecfg):
    """Subspace inverse iteration on a node grid (2D and 3D): V0 [Ks, ...]
    -> (V, H, G), the iterate and the projected pencil.  Each column is one
    preconditioned CG solve (JAX: ``lax.scan`` over columns inside a
    ``lax.scan`` over iterations)."""
    Ks = V0.shape[0]

    def dotg(A, B):
        return A.reshape(Ks, -1) @ B.reshape(Ks, -1).T

    def stack(fn, V):
        return torch.stack([fn(v) for v in V])

    def orthonormalize(V):
        G = dotg(V, stack(apply_mass, V))
        return _orthonormalize_rows(V.reshape(Ks, -1), G).reshape(V.shape)

    def col_solve(v):
        rhs = torch.where(interior, apply_mass(v), 0.0)
        return cg.cg(apply_free, rhs, M_inv=M_inv, tol=tol,
                     maxiter=cfg.cg_maxiter).x

    V = orthonormalize(V0)
    for _ in range(ecfg.iters):
        V = orthonormalize(stack(col_solve, V))
    H = dotg(V, stack(apply_free, V))
    G = dotg(V, stack(apply_mass, V))
    return V, 0.5 * (H + H.T), 0.5 * (G + G.T)


def _ritz_vectors(V, H, G, K, interior, apply_free, apply_mass, corner):
    """Rayleigh–Ritz pairs of the projected pencil: (mus [K], Vr [K, ...]
    signed by their value at ``corner``, residuals [K])."""
    dtype, device = V.dtype, V.device
    w, Q = _rayleigh_ritz(H, G, K)
    mus = torch.as_tensor(w, dtype=dtype, device=device)
    Ks = V.shape[0]
    Vr = (torch.as_tensor(Q, dtype=dtype, device=device).T
          @ V.reshape(Ks, -1)).reshape((K,) + V.shape[1:])
    Vr = Vr * _signs(Vr[(slice(None),) + corner], dtype).reshape(
        (K,) + (1,) * (V.ndim - 1))
    AV = torch.stack([apply_free(v) for v in Vr])
    MV = torch.stack([torch.where(interior, apply_mass(v), 0.0)
                      for v in Vr])
    shift = mus.reshape((K,) + (1,) * (V.ndim - 1))
    res = torch.abs(AV - shift * MV).reshape(K, -1).amax(dim=1)
    return mus, Vr, res


def _cg_tol(cfg, dtype):
    return cfg.cg_tol if cfg.cg_tol is not None else \
        100.0 * float(torch.finfo(dtype).eps)


def fem_eigensolve_2d(problem, cfg, ecfg: EigenConfig = EigenConfig(),
                      device=None) -> EigenSolution2D:
    """K smallest eigenpairs of the Q1 (or tensor-Numerov) pencil on the
    structured grid: inverse subspace iteration with an MG-CG (or
    Jacobi-CG) inner solve per subspace column, host Rayleigh–Ritz."""
    _check_2d_eligible(problem)
    dtype = cfg.torch_dtype()
    _require_f64_eigen(dtype, "fem_eigensolve_2d")
    device = resolve_device(device)
    x0, x1, y0, y1 = problem.domain
    nx, ny = cfg.nx, cfg.ny
    hx = float((x1 - x0) / nx)
    hy = float((y1 - y0) / ny)
    xs = torch.linspace(x0, x1, nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, ny + 1, dtype=dtype, device=device)
    if ecfg.mass == "numerov":
        K_A, K_M = transient._numerov_locals_2d(hx, hy, problem.a0, 0.0)
    else:
        K_A = assembly2d.q1_local_operator(hx, hy, problem.a0, 0.0, 0.0,
                                           0.0)
        K_M = assembly2d.q1_local_mass(hx, hy)
    interior = torch.zeros((ny + 1, nx + 1), dtype=torch.bool, device=device)
    interior[1:-1, 1:-1] = True

    def apply_free(v):
        return torch.where(interior,
                           assembly2d.apply_stiffness(v * interior, K_A), 0.0)

    def apply_mass(v):
        return assembly2d.apply_stiffness(v, K_M)

    if nx % 2 == 0 and ny % 2 == 0 and min(nx, ny) >= 8:
        M_inv = multigrid.make_vcycle(ny + 1, nx + 1, K_A, dtype,
                                      device=device)
    else:
        M_inv = 1.0 / assembly2d.stiffness_diag((ny + 1, nx + 1), K_A,
                                                dtype, device)
    K = ecfg.k
    Ks = K + ecfg.oversample
    modes, (mx0, Lx, my0, Ly) = _mode_table(problem, Ks)
    X, Y = torch.meshgrid(xs, ys, indexing="xy")
    V0 = torch.stack([
        torch.sin(i * math.pi * (X - mx0) / Lx)
        * torch.sin(j * math.pi * (Y - my0) / Ly)
        for _, i, j in modes
    ]) * interior[None]  # [Ks, ny+1, nx+1]
    V, H, G = _inverse_iteration(V0, interior, apply_free, apply_mass,
                                 M_inv, _cg_tol(cfg, dtype), cfg, ecfg)
    mus, Vr, res = _ritz_vectors(V, H, G, K, interior, apply_free,
                                 apply_mass, (1, 1))
    lams = mus + problem.c  # exact reaction shift
    return EigenSolution2D(xs, ys, lams, Vr, res)


def _shifted_problem_2d(problem, lam: float):
    def zero2(x, y):
        return torch.zeros_like(x + y)

    return dataclasses.replace(
        problem,
        name=f"{problem.name}_eig_shift",
        f=zero2,
        g=zero2,
        c=problem.c - lam,
        exact=None,
        f_shifted=None,
        f_elem_factors=None,
        f_colloc_factors=None,
    )


def _gauss(q: int, dtype, device):
    tq, wq = np.polynomial.legendre.leggauss(q)
    return (torch.as_tensor(tq, dtype=dtype, device=device),
            torch.as_tensor(wq, dtype=dtype, device=device))


def _quadrature_forms_2d(problem, xs, ys, coeffs, cfg):
    """(int a0 |grad p|^2 + c p^2, int p^2) by tensor Gauss quadrature."""
    t, w = _gauss(cfg.M + 2, coeffs.dtype, coeffs.device)
    V0, V1 = legendre.legendre_vandermonde(t, cfg.M, num_derivs=1)
    hx = float(xs[1] - xs[0])
    hy = float(ys[1] - ys[0])
    # coeffs: [ny, nx, M(ky), M(kx)]; values at (tq_y q, tq_x r)
    P = torch.einsum("abkl,qk,rl->abqr", coeffs, V0, V0)
    Px = torch.einsum("abkl,qk,rl->abqr", coeffs, V0, V1) * (2.0 / hx)
    Py = torch.einsum("abkl,qk,rl->abqr", coeffs, V1, V0) * (2.0 / hy)
    dA = (hx / 2.0) * (hy / 2.0) * (w[:, None] * w[None, :])
    num = torch.sum(dA[None, None] * (problem.a0 * (Px**2 + Py**2)
                                      + problem.c * P**2))
    den = torch.sum(dA[None, None] * P**2)
    return num, den


def rayleigh_quotient_2d(problem, xs, ys, coeffs, cfg):
    num, den = _quadrature_forms_2d(problem, xs, ys, coeffs, cfg)
    return num / den


def _enhance_pairs_2d(problem, cfg, ecfg, fem, mixed: bool):
    """Per-pair enhancement and quotient rounds on the FEM pairs ``fem``:
    in the run dtype with the plain quotient, or (``mixed``) in float32
    with the DG-corrected float64 quotient (``cfg`` then carries any
    dtype)."""
    cfg_e = dataclasses.replace(cfg, dtype="float32") if mixed else cfg
    cfg_q = dataclasses.replace(cfg, dtype="float64") if mixed else cfg
    quotient = rayleigh_quotient_2d_corrected if mixed else \
        rayleigh_quotient_2d
    dt = cfg_e.torch_dtype()
    xs, ys = fem.xs.to(dt), fem.ys.to(dt)
    coeffs_all, lams, oks = [], [], []
    with _span("enhance_eigenpairs"):
        for j in range(ecfg.k):
            lam = float(fem.lams[j])
            u = fem.vectors[j]
            bc_rows = None
            if ecfg.trace_lift >= 2:
                # Lift in the pencil's dtype, then cast: the lift windows
                # amplify nodal noise by the Lagrange constants.
                bc_rows = _lifted_trace_2d(u, cfg.M, cfg.nx, cfg.ny,
                                           stencil=ecfg.trace_lift).to(dt)
            coeffs, ok = None, None
            for _ in range(max(1, ecfg.rq_iters)):
                shifted = _shifted_problem_2d(problem, lam)
                shared, pts = prepare_shared_2d(shifted, cfg_e)
                c, diags, _ = enhance_2d(shifted, cfg_e, xs, ys, u.to(dt),
                                         (shared.to(u.device), pts),
                                         bc_rows_override=bc_rows)
                coeffs = c.to(fem.xs.dtype)
                # Mixed: the plain broken quotient is only LINEARLY
                # accurate in the f32 jump/boundary noise; the corrected
                # one is quadratic.
                lam = float(quotient(problem, fem.xs, fem.ys, coeffs, cfg_q))
                ok = diags.solve_ok.reshape(cfg.ny, cfg.nx)
            _, den = _quadrature_forms_2d(problem, fem.xs, fem.ys, coeffs,
                                          cfg_q)
            coeffs_all.append(coeffs / torch.sqrt(den))
            lams.append(lam)
            oks.append(ok)
    return HybridEigenSolution2D(
        fem, torch.stack(coeffs_all),
        torch.tensor(lams, dtype=fem.lams.dtype, device=fem.lams.device),
        torch.stack(oks))


def hybrid_eigensolve_2d(problem, cfg, ecfg: EigenConfig = EigenConfig(),
                         device=None) -> HybridEigenSolution2D:
    """2D analog of ``hybrid_eigensolve``: FEM pencil eigenpairs, then
    per-pair enhancement on the shifted operator c -> c - lambda with the
    (lifted) eigenvector grid as the trace data, eigenvalue re-read from
    the enhanced polynomial's Rayleigh quotient."""
    with _span("fem_eigensolve"):
        fem = fem_eigensolve_2d(problem, cfg, ecfg, device=device)
    return _enhance_pairs_2d(problem, cfg, ecfg, fem, mixed=False)


def evaluate_eigenfunction_2d(sol: HybridEigenSolution2D, j: int, x, y):
    stub = Solution2D(
        xs=sol.fem.xs, ys=sol.fem.ys, fem_values=sol.fem.vectors[j],
        coeffs=sol.coeffs[j], cg_iters=None, cg_residual=None,
        max_slack=None, bc_violation=None, solve_ok=sol.solve_ok[j])
    return evaluate_2d(stub, x, y)


def exact_eigenvalues_2d(problem, k: int):
    """Sorted a0 pi^2 (i^2/Lx^2 + j^2/Ly^2) + c — the rectangle oracle."""
    modes, _ = _mode_table(problem, k)
    return np.array([m[0] for m in modes]) + problem.c


# ---------------------------------------------------------------------------
# 3D: -a0 Lap u + c u = lambda u on a box, Q1 hex (or tensor-Numerov) pencil
# on the structured grid; the 2D architecture lifted tensorially (trace data
# from the tensor-Lagrange plane lift, hybrid3d._lifted_trace_3d).
# ---------------------------------------------------------------------------


class EigenSolution3D(NamedTuple):
    xs: torch.Tensor  # [nx+1]
    ys: torch.Tensor  # [ny+1]
    zs: torch.Tensor  # [nz+1]
    lams: torch.Tensor  # [K] ascending (includes the +c shift)
    vectors: torch.Tensor  # [K, nz+1, ny+1, nx+1] M-orthonormal grids
    residuals: torch.Tensor  # [K] ||A v - mu M v||_inf of the SPD pencil


class HybridEigenSolution3D(NamedTuple):
    fem: EigenSolution3D
    coeffs: torch.Tensor  # [K, nz, ny, nx, M, M, M]
    lams: torch.Tensor  # [K] enhanced (Rayleigh-quotient) eigenvalues
    solve_ok: torch.Tensor  # [K, nz, ny, nx]


def _check_3d_eligible(p):
    if any(t != "dirichlet" for t in p.bc_faces):
        raise NotImplementedError(
            "3D eigensolver requires all-Dirichlet faces")
    if tuple(p.b) != (0.0, 0.0, 0.0):
        raise NotImplementedError(
            "3D eigensolver requires b == 0 (symmetric pencil)")
    if p.a_var is not None:
        raise NotImplementedError(
            "3D eigensolver requires constant diffusion")


def _mode_table_3d(p, Ks: int):
    """First Ks tensor modes (i, j, k) of the a0-Laplacian, ascending."""
    x0, x1, y0, y1, z0, z1 = p.domain
    Lx, Ly, Lz = x1 - x0, y1 - y0, z1 - z0
    r = range(1, Ks + 2)
    cand = [
        (p.a0 * np.pi**2 * (i**2 / Lx**2 + j**2 / Ly**2 + k**2 / Lz**2),
         i, j, k)
        for i in r for j in r for k in r
    ]
    cand.sort()
    return cand[:Ks], (x0, Lx, y0, Ly, z0, Lz)


def fem_eigensolve_3d(problem, cfg, ecfg: EigenConfig = EigenConfig(),
                      device=None) -> EigenSolution3D:
    """K smallest eigenpairs of the Q1 hex (or tensor-Numerov) pencil:
    inverse subspace iteration with an MG-CG (or Jacobi-CG) inner solve per
    subspace column, host Rayleigh–Ritz (3D mirror of
    ``fem_eigensolve_2d``)."""
    _check_3d_eligible(problem)
    dtype = cfg.torch_dtype()
    _require_f64_eigen(dtype, "fem_eigensolve_3d")
    device = resolve_device(device)
    x0, x1, y0, y1, z0, z1 = problem.domain
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    hx = float((x1 - x0) / nx)
    hy = float((y1 - y0) / ny)
    hz = float((z1 - z0) / nz)
    xs = torch.linspace(x0, x1, nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, ny + 1, dtype=dtype, device=device)
    zs = torch.linspace(z0, z1, nz + 1, dtype=dtype, device=device)
    if ecfg.mass == "numerov":
        K_A, K_M = assembly3d.q1_numerov_locals_3d(hx, hy, hz, problem.a0,
                                                   0.0)
    else:
        K_A = assembly3d.q1_local_operator_3d(hx, hy, hz, problem.a0, 0.0,
                                              0.0, 0.0, 0.0)

        def m1c(h):
            return (h / 6.0) * np.array([[2.0, 1.0], [1.0, 2.0]])

        K_M = np.kron(m1c(hz), np.kron(m1c(hy), m1c(hx)))
    # Both pencil operators scale exactly like h per coarsening level in 3D,
    # which is make_vcycle_3d's automatic pure-Laplacian scaling.
    shape = (nz + 1, ny + 1, nx + 1)
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1, 1:-1] = True

    def apply_free(v):
        return torch.where(
            interior, assembly3d.apply_stiffness_3d(v * interior, K_A), 0.0)

    def apply_mass(v):
        return assembly3d.apply_stiffness_3d(v, K_M)

    if (nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0
            and min(nx, ny, nz) >= 8):
        M_inv = multigrid.make_vcycle_3d(*shape, K_A, dtype, device=device)
    else:
        M_inv = 1.0 / assembly3d.stiffness_diag_3d(shape, K_A, dtype,
                                                   device)
    K = ecfg.k
    Ks = K + ecfg.oversample
    modes, (mx0, Lx, my0, Ly, mz0, Lz) = _mode_table_3d(problem, Ks)
    X = xs[None, None, :]
    Y = ys[None, :, None]
    Z = zs[:, None, None]
    V0 = torch.stack([
        torch.sin(i * math.pi * (X - mx0) / Lx)
        * torch.sin(j * math.pi * (Y - my0) / Ly)
        * torch.sin(k * math.pi * (Z - mz0) / Lz)
        for _, i, j, k in modes
    ]) * interior[None]  # [Ks, nz+1, ny+1, nx+1]
    V, H, G = _inverse_iteration(V0, interior, apply_free, apply_mass,
                                 M_inv, _cg_tol(cfg, dtype), cfg, ecfg)
    mus, Vr, res = _ritz_vectors(V, H, G, K, interior, apply_free,
                                 apply_mass, (1, 1, 1))
    lams = mus + problem.c  # exact reaction shift
    return EigenSolution3D(xs, ys, zs, lams, Vr, res)


def _shifted_problem_3d(problem, lam: float):
    def zero3(x, y, z):
        return torch.zeros_like(x + y + z)

    return dataclasses.replace(
        problem,
        name=f"{problem.name}_eig_shift",
        f=zero3,
        g=zero3,
        c=problem.c - lam,
        exact=None,
        f_shifted=None,
    )


def _quadrature_forms_3d(problem, xs, ys, zs, coeffs, cfg):
    """(int a0 |grad p|^2 + c p^2, int p^2) by tensor Gauss quadrature
    (exact for the degree-(M-1) tensor polynomials)."""
    t, w = _gauss(cfg.M + 2, coeffs.dtype, coeffs.device)
    V0, V1 = legendre.legendre_vandermonde(t, cfg.M, num_derivs=1)
    hx = float(xs[1] - xs[0])
    hy = float(ys[1] - ys[0])
    hz = float(zs[1] - zs[0])
    eq = "eabklm,qk,rl,sm->eabqrs"  # coeffs [nz, ny, nx, kz, ky, kx]
    P = torch.einsum(eq, coeffs, V0, V0, V0)
    Px = torch.einsum(eq, coeffs, V0, V0, V1) * (2.0 / hx)
    Py = torch.einsum(eq, coeffs, V0, V1, V0) * (2.0 / hy)
    Pz = torch.einsum(eq, coeffs, V1, V0, V0) * (2.0 / hz)
    dV = ((hx / 2.0) * (hy / 2.0) * (hz / 2.0)
          * (w[:, None, None] * w[None, :, None] * w[None, None, :]))
    num = torch.sum(dV[None, None, None]
                    * (problem.a0 * (Px**2 + Py**2 + Pz**2)
                       + problem.c * P**2))
    den = torch.sum(dV[None, None, None] * P**2)
    return num, den


def rayleigh_quotient_3d(problem, xs, ys, zs, coeffs, cfg):
    num, den = _quadrature_forms_3d(problem, xs, ys, zs, coeffs, cfg)
    return num / den


def _enhance_pairs_3d(problem, cfg, ecfg, fem, mixed: bool):
    """3D mirror of ``_enhance_pairs_2d``."""
    cfg_e = dataclasses.replace(cfg, dtype="float32") if mixed else cfg
    cfg_q = dataclasses.replace(cfg, dtype="float64") if mixed else cfg
    quotient = rayleigh_quotient_3d_corrected if mixed else \
        rayleigh_quotient_3d
    dt = cfg_e.torch_dtype()
    xs, ys, zs = fem.xs.to(dt), fem.ys.to(dt), fem.zs.to(dt)
    shp = (cfg.nz, cfg.ny, cfg.nx)
    coeffs_all, lams, oks = [], [], []
    with _span("enhance_eigenpairs"):
        for j in range(ecfg.k):
            lam = float(fem.lams[j])
            u = fem.vectors[j]
            bc_rows = None
            if ecfg.trace_lift >= 2:
                bc_rows = _lifted_trace_3d(u, cfg.M, cfg.nx, cfg.ny, cfg.nz,
                                           stencil=ecfg.trace_lift).to(dt)
            coeffs, ok = None, None
            for _ in range(max(1, ecfg.rq_iters)):
                shifted = _shifted_problem_3d(problem, lam)
                shared, pts = prepare_shared_3d(shifted, cfg_e)
                c, diags, _ = enhance_3d(shifted, cfg_e, xs, ys, zs, u.to(dt),
                                         (shared.to(u.device), pts),
                                         bc_rows_override=bc_rows)
                coeffs = c.to(fem.xs.dtype)
                lam = float(quotient(problem, fem.xs, fem.ys, fem.zs, coeffs,
                                     cfg_q))
                ok = diags.solve_ok.reshape(shp)
            _, den = _quadrature_forms_3d(problem, fem.xs, fem.ys, fem.zs,
                                          coeffs, cfg_q)
            coeffs_all.append(coeffs / torch.sqrt(den))
            lams.append(lam)
            oks.append(ok)
    return HybridEigenSolution3D(
        fem, torch.stack(coeffs_all),
        torch.tensor(lams, dtype=fem.lams.dtype, device=fem.lams.device),
        torch.stack(oks))


def hybrid_eigensolve_3d(problem, cfg, ecfg: EigenConfig = EigenConfig(),
                         device=None) -> HybridEigenSolution3D:
    """3D analog of ``hybrid_eigensolve_2d``: FEM pencil eigenpairs, then
    per-pair enhancement on the shifted operator c -> c - lambda with the
    (plane-lifted) eigenvector grid as the trace data, eigenvalue re-read
    from the enhanced polynomial's Rayleigh quotient."""
    with _span("fem_eigensolve"):
        fem = fem_eigensolve_3d(problem, cfg, ecfg, device=device)
    return _enhance_pairs_3d(problem, cfg, ecfg, fem, mixed=False)


def evaluate_eigenfunction_3d(sol: HybridEigenSolution3D, j: int, x, y, z):
    stub = Solution3D(
        xs=sol.fem.xs, ys=sol.fem.ys, zs=sol.fem.zs,
        fem_values=sol.fem.vectors[j], coeffs=sol.coeffs[j],
        cg_iters=None, cg_residual=None, max_slack=None,
        bc_violation=None, solve_ok=sol.solve_ok[j], cond_estimate=None)
    return evaluate_3d(stub, x, y, z)


def exact_eigenvalues_3d(problem, k: int):
    """Sorted a0 pi^2 (i^2/Lx^2 + j^2/Ly^2 + k^2/Lz^2) + c — the box
    oracle."""
    modes, _ = _mode_table_3d(problem, k)
    return np.array([m[0] for m in modes]) + problem.c


# ------------------------------------------------- mixed-precision route
#
# The 2D/3D float32 gate exists because the float32 inverse-iteration
# PENCIL floors at ~1e-2 residual, but the pencil is the cheap stage.  The
# mixed route runs the pencil in float64, the per-pair enhancement in
# float32 (on a CUDA run with trace_lift=0 through the stacked kernels),
# and re-reads the eigenvalues from the float64 DG-corrected quotient,
# which is stationary at the true eigenfunction: the float32 coefficient
# noise enters only quadratically.


def hybrid_eigensolve_2d_mixed(problem, cfg,
                               ecfg: EigenConfig = EigenConfig(),
                               device=None) -> HybridEigenSolution2D:
    """float64 pencil + float32 enhancement + float64 corrected quotient
    (section comment above).  ``cfg`` may carry any dtype."""
    with _span("fem_eigensolve"):
        fem = fem_eigensolve_2d(problem,
                                dataclasses.replace(cfg, dtype="float64"),
                                ecfg, device=device)
    return _enhance_pairs_2d(problem, cfg, ecfg, fem, mixed=True)


def hybrid_eigensolve_3d_mixed(problem, cfg,
                               ecfg: EigenConfig = EigenConfig(),
                               device=None) -> HybridEigenSolution3D:
    """3D mirror of ``hybrid_eigensolve_2d_mixed``."""
    with _span("fem_eigensolve"):
        fem = fem_eigensolve_3d(problem,
                                dataclasses.replace(cfg, dtype="float64"),
                                ecfg, device=device)
    return _enhance_pairs_3d(problem, cfg, ecfg, fem, mixed=True)


def _face_correction_2d(coeffs, hx: float, hy: float, q: int):
    """DG-consistency face term J(p) = 2 sum_F int_F {d_nu p} [[p]] ds for
    the elementwise tensor-Legendre field p (coeffs [ny, nx, M(ky),
    M(kx)]), interior faces with [[p]] = p^- - p^+ (nu from - to +) and
    domain-boundary faces with the one-sided outward flux and [[p]] = p.

    The broken-H^1 Rayleigh quotient loses its stationarity at the true
    eigenfunction through terms LINEAR in the inter-element jumps and
    boundary traces of the error: invisible at float64 jump sizes, but the
    dominant floor of the mixed float32 route.  Subtracting J restores
    RQ - lambda = O(e^2) for elementwise-smooth p."""
    dtype, device = coeffs.dtype, coeffs.device
    M = coeffs.shape[-1]
    t, w = _gauss(q, dtype, device)
    V0q, _ = legendre.legendre_vandermonde(t, M, num_derivs=1)
    Ve0, Ve1 = legendre.legendre_vandermonde(
        torch.tensor([-1.0, 1.0], dtype=dtype, device=device), M,
        num_derivs=1)

    def pair_terms(c, h_norm, h_face):
        """c: [*, n, M(kt), M(kn)] with kn the normal direction and kt
        tangential; returns the face-term sum over the n-axis faces."""
        # edge values / derivatives: [..., n, q, side]
        vals = torch.einsum("...kl,qk,sl->...qs", c, V0q, Ve0)
        ders = torch.einsum("...kl,qk,sl->...qs", c, V0q, Ve1) * (
            2.0 / h_norm)
        pL = vals[..., :-1, :, 1]  # element i at +1 (left of face i+1)
        pR = vals[..., 1:, :, 0]  # element i+1 at -1
        dL = ders[..., :-1, :, 1]
        dR = ders[..., 1:, :, 0]
        inner = torch.sum(w * 0.5 * (dL + dR) * (pL - pR)) * (h_face / 2.0)
        # domain boundary: outward normal is -n at face 0, +n at face n
        lo = torch.sum(w * (-ders[..., 0, :, 0]) * vals[..., 0, :, 0]) \
            * (h_face / 2.0)
        hi = torch.sum(w * ders[..., -1, :, 1] * vals[..., -1, :, 1]) \
            * (h_face / 2.0)
        return inner + lo + hi

    # vertical faces (normal x): n-axis is nx, tangential ky along hy
    Jx = pair_terms(coeffs, hx, hy)
    # horizontal faces (normal y): swap the roles
    cT = coeffs.permute(1, 0, 3, 2)  # [nx, ny, kx, ky]
    Jy = pair_terms(cT, hy, hx)
    return 2.0 * (Jx + Jy)


def rayleigh_quotient_2d_corrected(problem, xs, ys, coeffs, cfg):
    """Broken Rayleigh quotient with the DG-consistency face correction
    (``_face_correction_2d``): quadratic in the eigenfunction error even
    when p carries inter-element jumps / boundary-trace noise."""
    num, den = _quadrature_forms_2d(problem, xs, ys, coeffs, cfg)
    J = _face_correction_2d(coeffs, float(xs[1] - xs[0]),
                            float(ys[1] - ys[0]), cfg.M + 2)
    return (num - problem.a0 * J) / den


def _face_correction_3d(coeffs, hx: float, hy: float, hz: float, q: int):
    """3D mirror of ``_face_correction_2d``: J(p) = 2 sum_F int_F
    {d_nu p} [[p]] dA over the three face orientations of the hex grid
    (coeffs [nz, ny, nx, M(kz), M(ky), M(kx)])."""
    dtype, device = coeffs.dtype, coeffs.device
    M = coeffs.shape[-1]
    t, w = _gauss(q, dtype, device)
    V0q, _ = legendre.legendre_vandermonde(t, M, num_derivs=1)
    Ve0, Ve1 = legendre.legendre_vandermonde(
        torch.tensor([-1.0, 1.0], dtype=dtype, device=device), M,
        num_derivs=1)
    W2 = w[:, None] * w[None, :]

    def pair_terms(c, h_norm, area):
        """c: [*, n, M(kt1), M(kt2), M(kn)]; faces along the n axis."""
        vals = torch.einsum("...kml,qk,rm,sl->...qrs", c, V0q, V0q, Ve0)
        ders = torch.einsum("...kml,qk,rm,sl->...qrs", c, V0q, V0q,
                            Ve1) * (2.0 / h_norm)
        inner = torch.sum(
            W2 * 0.5 * (ders[..., :-1, :, :, 1] + ders[..., 1:, :, :, 0])
            * (vals[..., :-1, :, :, 1] - vals[..., 1:, :, :, 0])) * area
        lo = torch.sum(W2 * (-ders[..., 0, :, :, 0])
                       * vals[..., 0, :, :, 0]) * area
        hi = torch.sum(W2 * ders[..., -1, :, :, 1]
                       * vals[..., -1, :, :, 1]) * area
        return inner + lo + hi

    # x-normal faces: c already [nz, ny, nx, kz, ky, kx]
    Jx = pair_terms(coeffs, hx, (hy / 2.0) * (hz / 2.0))
    # y-normal: [nz, nx, ny, kz, kx, ky]
    Jy = pair_terms(coeffs.permute(0, 2, 1, 3, 5, 4), hy,
                    (hx / 2.0) * (hz / 2.0))
    # z-normal: [ny, nx, nz, ky, kx, kz]
    Jz = pair_terms(coeffs.permute(1, 2, 0, 4, 5, 3), hz,
                    (hx / 2.0) * (hy / 2.0))
    return 2.0 * (Jx + Jy + Jz)


def rayleigh_quotient_3d_corrected(problem, xs, ys, zs, coeffs, cfg):
    """Broken Rayleigh quotient with the DG-consistency face correction
    (3D mirror of ``rayleigh_quotient_2d_corrected``)."""
    num, den = _quadrature_forms_3d(problem, xs, ys, zs, coeffs, cfg)
    J = _face_correction_3d(coeffs, float(xs[1] - xs[0]),
                            float(ys[1] - ys[0]), float(zs[1] - zs[0]),
                            cfg.M + 2)
    return (num - problem.a0 * J) / den
