"""2D problems on structured quad meshes: Q1 FEM + tensor-product LSSVR.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/hybrid2d.py``.  The 1D
architecture generalises directly:

* coarse stage: matrix-free Q1 stiffness (``ops.assembly2d``) with a
  preconditioned Krylov solve (``ops.cg``) instead of a banded solve;
* enhancement: per quad a tensor-product Legendre expansion
  u = sum_{ky,kx} w[ky,kx] P_ky(ty) P_kx(tx), constrained by L u = f at a
  C x C interior collocation grid and by pinning the element-boundary trace
  to the Q1 FEM trace (bilinear on each quad), which keeps the enhanced
  solution globally continuous.  On Dirichlet edges of the domain the trace
  is pinned to the data g instead.
* On a uniform mesh with constant coefficients every quad shares the same
  D [C^2, M^2] and B [4M-4, M^2], so the whole enhancement is one affine map
  precomputed on the host in float64 (``ops.kkt.precompute_shared_lse_host``).
  With variable diffusion (``Problem2D.a_var``) each quad has its own
  operator and its own null-space least-squares solve.

The enhancement runs in the fused CUDA kernels of ``ops.kernels2d`` on a
CUDA float32 run and in batched torch algebra (``ops.kkt``) otherwise:
``Solver2DConfig.backend`` takes 'auto', 'torch' (JAX's 'xla') or 'cuda'
(JAX's 'pallas').  The stages run inside ``torch.profiler.record_function``
spans named in ``SPANS``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import assembly2d, cg, kernels2d, kkt, legendre
from ..utils.device import resolve as resolve_device

_span = torch.profiler.record_function
SPANS = ("prepare_shared_2d", "fem_solve_2d.assemble",
         "fem_solve_2d.precond_setup", "fem_solve_2d.krylov", "enhance_2d",
         "evaluate_2d")

pi = math.pi


@dataclasses.dataclass(frozen=True)
class Problem2D:
    """L u = -a0 Lap(u) + b . grad(u) + c u = f on a rectangle, u = g on the
    boundary.  Constant coefficients (a0, b, c) keep the per-element
    operators shared across the uniform mesh, so every family rides the
    same precomputed-affine-map enhancement as Poisson; the defaults give
    the pure Poisson operator.  c < 0 is Helmholtz, b != 0 is
    advection-diffusion.  All callables take and return torch tensors."""

    name: str
    f: Callable  # f(x, y)
    g: Callable  # Dirichlet data g(x, y)
    domain: Tuple[float, float, float, float] = (-1.0, 1.0, -1.0, 1.0)
    # Per-edge BC type (left, right, bottom, top): "dirichlet" (u = g),
    # "neumann" (a0 du/dn = g_natural) or "robin" (a0 du/dn + robin_alpha u
    # = g_natural).  Natural edges keep their boundary nodes as unknowns
    # (weak boundary term assembled by ``fem_solve_2d``); the enhancement
    # pins those element traces to the FEM trace instead of exact data.
    bc_edges: Tuple[str, str, str, str] = ("dirichlet",) * 4
    g_natural: Optional[Callable] = None  # natural data on non-Dirichlet edges
    robin_alpha: float = 0.0
    exact: Optional[Callable] = None
    a0: float = 1.0  # diffusion coefficient (constant)
    c: float = 0.0  # reaction coefficient (c < 0: Helmholtz)
    b: Tuple[float, float] = (0.0, 0.0)  # advection velocity (bx, by)
    # Variable diffusion: L u = -div(a(x,y) grad u) + c u.  When set, the
    # per-element operators differ and the enhancement solves a null-space
    # least-squares problem per quad; grad_a = (da/dx, da/dy) callables for
    # the chain-rule collocation rows (derived by autograd when None).
    a_var: Optional[Callable] = None
    grad_a: Optional[Tuple[Callable, Callable]] = None
    # Optional structured rhs: f_shifted(xl, dx, yl, dy) == f(xl+dx, yl+dy)
    # with the per-quad transcendental work factored out.
    f_shifted: Optional[Callable] = None
    # Optional separable rhs: f((xl, yl) + (dx, dy)) ==
    # sum_r f_elem_factors(xl, yl)[r] * colloc_r(dx, dy), with
    # f_colloc_factors(dx, dy) static (numpy f64 [C^2] in, list of [C^2]
    # out); contracted with the shared affine map on the host in float64.
    f_elem_factors: Optional[Callable] = None
    f_colloc_factors: Optional[Callable] = None


def _zeros_g(x, y):
    return torch.zeros_like(x + y)


def _sin_sin(x, y):
    return torch.sin(pi * x) * torch.sin(pi * y)


def _cos_cos(x, y):
    return torch.cos(pi * x) * torch.cos(pi * y)


def _trig_colloc_factors(dx, dy):
    cdx, sdx = np.cos(np.pi * dx), np.sin(np.pi * dx)
    cdy, sdy = np.cos(np.pi * dy), np.sin(np.pi * dy)
    return [cdx * cdy, cdx * sdy, sdx * cdy, sdx * sdy]


def poisson_2d() -> Problem2D:
    """-Lap u = 2 pi^2 sin(pi x) sin(pi y), exact u = sin(pi x) sin(pi y)."""

    def f_shifted(xl, dx, yl, dy):
        # Separable trig rhs via angle addition: 4 transcendental vectors
        # over the quads instead of C^2 per quad.
        sx = torch.sin(pi * xl) * torch.cos(pi * dx) \
            + torch.cos(pi * xl) * torch.sin(pi * dx)
        sy = torch.sin(pi * yl) * torch.cos(pi * dy) \
            + torch.cos(pi * yl) * torch.sin(pi * dy)
        return 2.0 * pi**2 * sx * sy

    def f_elem_factors(xl, yl):
        amp = 2.0 * pi**2
        sx, cx = torch.sin(pi * xl), torch.cos(pi * xl)
        sy, cy = torch.sin(pi * yl), torch.cos(pi * yl)
        return [amp * sx * sy, amp * sx * cy, amp * cx * sy, amp * cx * cy]

    return Problem2D(
        name="poisson_2d",
        f=lambda x, y: 2.0 * pi**2 * torch.sin(pi * x) * torch.sin(pi * y),
        g=_zeros_g,
        exact=_sin_sin,
        f_shifted=f_shifted,
        f_elem_factors=f_elem_factors,
        f_colloc_factors=_trig_colloc_factors,
    )


def poisson_2d_inhomogeneous() -> Problem2D:
    """-Lap u = 2 pi^2 cos(pi x) cos(pi y), exact u = cos(pi x) cos(pi y).

    Nonzero Dirichlet trace (g = -cos(pi y) on x = +/-1 etc.): exercises
    the domain-boundary g-override masks and the boundary-magnitude
    solve_ok gate end to end."""

    def f_shifted(xl, dx, yl, dy):
        cx = torch.cos(pi * xl) * torch.cos(pi * dx) \
            - torch.sin(pi * xl) * torch.sin(pi * dx)
        cy = torch.cos(pi * yl) * torch.cos(pi * dy) \
            - torch.sin(pi * yl) * torch.sin(pi * dy)
        return 2.0 * pi**2 * cx * cy

    def f_elem_factors(xl, yl):
        amp = 2.0 * pi**2
        sx, cx = torch.sin(pi * xl), torch.cos(pi * xl)
        sy, cy = torch.sin(pi * yl), torch.cos(pi * yl)
        return [amp * cx * cy, -amp * cx * sy, -amp * sx * cy,
                amp * sx * sy]

    return Problem2D(
        name="poisson_2d_inhomogeneous",
        f=lambda x, y: 2.0 * pi**2 * torch.cos(pi * x) * torch.cos(pi * y),
        g=_cos_cos,
        exact=_cos_cos,
        f_shifted=f_shifted,
        f_elem_factors=f_elem_factors,
        f_colloc_factors=_trig_colloc_factors,
    )


def _trig_tensor_rhs(a1, a2, a3, a4):
    """(f, f_shifted, f_elem_factors, f_colloc_factors) for the rhs family
    f = a1 SxSy + a2 CxSy + a3 SxCy + a4 CxCy with Sx = sin(pi x) etc. —
    every constant-coefficient operator applied to u = sin(pi x) sin(pi y)
    lands in this 4-term tensor basis, so all 2D families share one
    separable-rhs expansion."""

    def f(x, y):
        sx, cx = torch.sin(pi * x), torch.cos(pi * x)
        sy, cy = torch.sin(pi * y), torch.cos(pi * y)
        return a1 * sx * sy + a2 * cx * sy + a3 * sx * cy + a4 * cx * cy

    def f_shifted(xl, dx, yl, dy):
        return f(xl + dx, yl + dy)

    def f_elem_factors(xl, yl):
        sx, cx = torch.sin(pi * xl), torch.cos(pi * xl)
        sy, cy = torch.sin(pi * yl), torch.cos(pi * yl)
        # coefficients of [cdx*cdy, cdx*sdy, sdx*cdy, sdx*sdy]
        return [
            a1 * sx * sy + a2 * cx * sy + a3 * sx * cy + a4 * cx * cy,
            a1 * sx * cy + a2 * cx * cy - a3 * sx * sy - a4 * cx * sy,
            a1 * cx * sy - a2 * sx * sy + a3 * cx * cy - a4 * sx * cy,
            a1 * cx * cy - a2 * sx * cy - a3 * cx * sy + a4 * sx * sy,
        ]

    return f, f_shifted, f_elem_factors, _trig_colloc_factors


def helmholtz_2d(k: float = 2.0) -> Problem2D:
    """-Lap u - k^2 u = (2 pi^2 - k^2) sin(pi x) sin(pi y), exact
    u = sin(pi x) sin(pi y).

    The continuous operator's smallest Dirichlet eigenvalue on (-1,1)^2 is
    pi^2/2 ~ 4.93, so k > ~2.2 makes the coarse system indefinite; the
    coarse stage routes to BiCGStab for any k."""
    amp = 2.0 * pi * pi - k * k
    f, f_shifted, f_ef, f_cf = _trig_tensor_rhs(amp, 0.0, 0.0, 0.0)
    return Problem2D(
        name="helmholtz_2d", f=f, g=_zeros_g, exact=_sin_sin, c=-k * k,
        f_shifted=f_shifted, f_elem_factors=f_ef, f_colloc_factors=f_cf,
    )


def advection_diffusion_2d(bx: float = 3.0, by: float = 1.5) -> Problem2D:
    """-Lap u + b . grad u = f with exact u = sin(pi x) sin(pi y); the
    coarse Q1 system is nonsymmetric (BiCGStab) and the collocation rows
    gain first-derivative terms."""
    f, f_shifted, f_ef, f_cf = _trig_tensor_rhs(
        2.0 * pi * pi, bx * pi, by * pi, 0.0
    )
    return Problem2D(
        name="advection_diffusion_2d", f=f, g=_zeros_g, exact=_sin_sin,
        b=(bx, by), f_shifted=f_shifted, f_elem_factors=f_ef,
        f_colloc_factors=f_cf,
    )


def reaction_diffusion_2d(c: float = 10.0) -> Problem2D:
    """-Lap u + c u = f (c > 0: SPD coarse system, exercises the mass term
    on the CG path), exact u = sin(pi x) sin(pi y)."""
    f, f_shifted, f_ef, f_cf = _trig_tensor_rhs(
        2.0 * pi * pi + c, 0.0, 0.0, 0.0
    )
    return Problem2D(
        name="reaction_diffusion_2d", f=f, g=_zeros_g, exact=_sin_sin, c=c,
        f_shifted=f_shifted, f_elem_factors=f_ef, f_colloc_factors=f_cf,
    )


def variable_coeff_elliptic_2d() -> Problem2D:
    """-div(a grad u) = f with a(x, y) = 1 + xy/2 (positive on the square),
    exact u = sin(pi x) sin(pi y).  Expanding the divergence:
    f = 2 pi^2 a u - da/dx u_x - da/dy u_y."""

    def a(x, y):
        return 1.0 + 0.5 * x * y

    def ax(x, y):
        return 0.5 * y * torch.ones_like(x + y)

    def ay(x, y):
        return 0.5 * x * torch.ones_like(x + y)

    def f(x, y):
        sx, cx = torch.sin(pi * x), torch.cos(pi * x)
        sy, cy = torch.sin(pi * y), torch.cos(pi * y)
        return (2.0 * pi * pi * a(x, y) * sx * sy
                - ax(x, y) * pi * cx * sy
                - ay(x, y) * pi * sx * cy)

    def f_shifted(xl, dx, yl, dy):
        # Angle addition against the static in-element offsets: 4
        # transcendentals per quad instead of 4 C^2.
        sxl, cxl = torch.sin(pi * xl), torch.cos(pi * xl)
        syl, cyl = torch.sin(pi * yl), torch.cos(pi * yl)
        sdx, cdx = torch.sin(pi * dx), torch.cos(pi * dx)
        sdy, cdy = torch.sin(pi * dy), torch.cos(pi * dy)
        sx = sxl * cdx + cxl * sdx
        cx = cxl * cdx - sxl * sdx
        sy = syl * cdy + cyl * sdy
        cy = cyl * cdy - syl * sdy
        x = xl + dx
        y = yl + dy
        return (2.0 * pi * pi * (1.0 + 0.5 * x * y) * sx * sy
                - 0.5 * y * pi * cx * sy
                - 0.5 * x * pi * sx * cy)

    return Problem2D(
        name="variable_coeff_elliptic_2d", f=f, g=_zeros_g, exact=_sin_sin,
        a_var=a, grad_a=(ax, ay), f_shifted=f_shifted,
    )


def poisson_2d_neumann() -> Problem2D:
    """-Lap u = 2 pi^2 sin sin with a Neumann right edge:
    du/dn|_{x=1} = -pi sin(pi y); Dirichlet (g = 0) on the other three.
    Exact u = sin(pi x) sin(pi y): exercises the natural-BC weak boundary
    term and the FEM-trace pin on the right-edge elements."""
    return Problem2D(
        name="poisson_2d_neumann",
        f=lambda x, y: 2.0 * pi**2 * torch.sin(pi * x) * torch.sin(pi * y),
        g=_zeros_g,
        bc_edges=("dirichlet", "neumann", "dirichlet", "dirichlet"),
        g_natural=lambda x, y: -pi * torch.sin(pi * y) * torch.ones_like(x),
        exact=_sin_sin,
    )


def robin_2d(alpha: float = 1.0) -> Problem2D:
    """-Lap u + u = (2 pi^2 + 1) cos cos with Robin right and top edges
    (du/dn + alpha u = g_natural; du/dn = 0 there, so g_natural =
    alpha u_exact), Dirichlet left and bottom.  Exact u = cos(pi x)
    cos(pi y): nonzero boundary values including the free corner where
    the two Robin edges meet."""
    return Problem2D(
        name=f"robin_2d_alpha{alpha:g}",
        f=lambda x, y: (2.0 * pi**2 + 1.0) * _cos_cos(x, y),
        g=_cos_cos,
        c=1.0,
        bc_edges=("dirichlet", "robin", "dirichlet", "robin"),
        g_natural=lambda x, y: alpha * _cos_cos(x, y),
        robin_alpha=alpha,
        exact=_cos_cos,
    )


_PROBLEMS_2D = {
    "poisson_2d": poisson_2d,
    "poisson_2d_inhomogeneous": poisson_2d_inhomogeneous,
    "helmholtz_2d": helmholtz_2d,
    "advection_diffusion_2d": advection_diffusion_2d,
    "reaction_diffusion_2d": reaction_diffusion_2d,
    "variable_coeff_elliptic_2d": variable_coeff_elliptic_2d,
    "poisson_2d_neumann": poisson_2d_neumann,
    "robin_2d": robin_2d,
}


def get_problem_2d(name: str, **kwargs) -> Problem2D:
    """Registry lookup mirroring ``problems.get`` for the 2D families."""
    try:
        return _PROBLEMS_2D[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown 2D problem {name!r}; available: "
            f"{sorted(_PROBLEMS_2D)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Solver2DConfig:
    """Solver settings (the same fields as the JAX ``Solver2DConfig``)."""

    nx: int = 16  # elements per dimension
    ny: int = 16
    M: int = 6  # Legendre basis size per dimension (M^2 coefficients)
    gamma: float = 1.0e4
    n_colloc: int = 6  # collocation grid per dimension (C^2 PDE rows)
    formulation: str = "primal"  # 'primal' (null-space LSE algebra) |
    # 'dual' (augmented quasi-definite kernel system); the same QP
    cg_tol: Optional[float] = None  # None -> 100 * dtype eps (relative)
    cg_maxiter: int = 2000
    precond: str = "auto"  # 'auto' | 'jacobi' | 'mg' (geometric V-cycle)
    # | 'adi' (Peaceman-Rachford line sweeps, for strongly anisotropic
    # hx/hy) | 'shifted' (V-cycle of the SPD-shifted operator c -> |c|, for
    # indefinite Helmholtz; 'auto' picks it when c < 0 and the grid is
    # MG-eligible)
    backend: str = "auto"  # 'auto' | 'torch' | 'cuda' (enhancement stage)
    varcoeff_method: str = "sne"  # per-element LSE algorithm of the CUDA
    # kernel: 'sne' (semi-normal equations + refinement) | 'qr' (CGS2);
    # the torch route always uses the QR algebra
    diagnostics: bool = True
    dtype: Optional[str] = None  # 'float32' | 'float64' | None (= float64)
    fem_dtype: Optional[str] = None  # 'float64' runs the coarse Krylov
    # stage in float64 and casts the nodal values back to the run dtype
    coarse: str = "q1"  # 'q1' (O(h^2) nodal) | 'compact' (tensor-Numerov
    # 9-point scheme A u = M f_nodal, O(h^4) nodal: uniform mesh, constant
    # diffusion, b == 0, all-Dirichlet edges)
    trace_lift: int = 0  # 0: bilinear FEM element trace.  >= 2: tangential
    # Lagrange interpolation of nodal grid lines with this stencil width (6
    # typical): with coarse='compact' the O(h^4) nodal values carry through
    # to an O(h^4) hybrid solution (forces the torch enhancement route)

    def __post_init__(self):
        if self.formulation not in ("primal", "dual"):
            raise ValueError(f"unknown formulation: {self.formulation!r}")
        if self.coarse not in ("q1", "compact"):
            raise ValueError(f"unknown coarse scheme: {self.coarse!r}")
        if self.trace_lift == 1 or self.trace_lift < 0:
            raise ValueError("trace_lift must be 0 or >= 2")
        if self.backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown backend: {self.backend!r}")
        if self.varcoeff_method not in kernels2d.METHODS:
            raise ValueError(
                f"unknown varcoeff_method: {self.varcoeff_method!r}")

    def torch_dtype(self) -> torch.dtype:
        """The run dtype; float64 when unset (JAX's default under x64)."""
        return getattr(torch, self.dtype or "float64")


class Solution2D(NamedTuple):
    xs: torch.Tensor  # [nx+1]
    ys: torch.Tensor  # [ny+1]
    fem_values: torch.Tensor  # [ny+1, nx+1]
    coeffs: torch.Tensor  # [ny, nx, M, M]  (ky, kx ordering)
    cg_iters: int
    cg_residual: torch.Tensor
    max_slack: torch.Tensor  # [ny, nx]
    bc_violation: torch.Tensor  # [ny, nx]
    solve_ok: torch.Tensor  # [ny, nx]
    cond_estimate: Optional[torch.Tensor] = None  # monitor (see ops.kkt)


def _boundary_coords(M: int):
    """(ty, tx) pairs pinning the element trace: M points per edge, corners
    shared -> 4M-4 constraints, exactly the trace space's dimension, so B is
    square-on-the-trace and full rank."""
    tb = np.linspace(-1.0, 1.0, M)
    pts = [(-1.0, tx) for tx in tb]  # bottom edge
    pts += [(1.0, tx) for tx in tb]  # top edge
    pts += [(ty, -1.0) for ty in tb[1:-1]]  # left edge sans corners
    pts += [(ty, 1.0) for ty in tb[1:-1]]  # right edge sans corners
    return np.array(pts)  # [4M-4, 2]


def _lift_weights(n_nodes: int, t_pts, stencil: int = 6):
    """Static Lagrange interpolation of grid-line nodal values to element
    edge points: for element b, interpolate through ``stencil`` consecutive
    nodes (one-sided near the boundary) at local coords t in [-1, 1].

    Returns numpy (idx [n_el, stencil] node indices, w [n_el, P, stencil]).
    The interpolation reproduces nodal values exactly, so homogeneous
    Dirichlet lines lift to exactly zero with no special-casing."""
    n_el = n_nodes - 1
    s = min(stencil, n_nodes)
    starts = np.clip(np.arange(n_el) - (s - 1) // 2, 0, n_nodes - s)
    idx = starts[:, None] + np.arange(s)[None, :]
    t_pts = np.asarray(t_pts, np.float64)
    w = np.empty((n_el, t_pts.shape[0], s))
    nodes = np.arange(s, dtype=np.float64)
    for b in range(n_el):
        xi = (b - starts[b]) + 0.5 * (t_pts + 1.0)  # stencil-local coords
        for j in range(s):
            others = np.delete(nodes, j)
            w[b, :, j] = np.prod(
                (xi[:, None] - others[None, :]) / (nodes[j] - others),
                axis=1)
    return idx, w


def _lifted_trace_2d(fem, M: int, nx: int, ny: int, stencil: int = 6):
    """[E, 4M-4] element-edge trace values from high-order tangential
    interpolation of the nodal grid along each edge's grid line — replaces
    the O(h^2) bilinear trace that caps the 2D enhancement floor.  Valid
    whenever the nodal values are themselves high-order (the steady
    ``coarse='compact'`` scheme).  Row order matches ``_boundary_coords``:
    bottom M points (ty=-1), top M, left tb[1:-1], right tb[1:-1]."""
    dtype, device = fem.dtype, fem.device
    tb = np.linspace(-1.0, 1.0, M)
    idxx, wxf = _lift_weights(nx + 1, tb, stencil)
    idxy, wyi = _lift_weights(ny + 1, tb[1:-1], stencil)
    wx = torch.as_tensor(wxf, dtype=dtype, device=device)
    wy = torch.as_tensor(wyi, dtype=dtype, device=device)
    ix = torch.as_tensor(idxx, device=device)
    iy = torch.as_tensor(idxy, device=device)
    Ux = fem[:, ix]  # [ny+1, nx, S] tangential windows on each row
    bottom = torch.einsum("bmj,abj->abm", wx, Ux[:-1])
    top = torch.einsum("bmj,abj->abm", wx, Ux[1:])
    Uy = fem[iy]  # [ny, S, nx+1] windows down each column
    left = torch.einsum("amj,ajb->abm", wy, Uy[:, :, :-1])
    right = torch.einsum("amj,ajb->abm", wy, Uy[:, :, 1:])
    rows = torch.cat([bottom, top, left, right], dim=-1)
    return rows.reshape(ny * nx, 4 * M - 4)


@dataclasses.dataclass(frozen=True)
class VarCoeff2DOperators:
    """Shared host-f64-precomputed operator parts for the per-element
    variable-coefficient 2D enhancement: D_e = -a_e * Lap - ax_e * Gx
    - ay_e * Gy + Dconst, batched over elements with the coefficient fields
    sampled at each element's collocation points."""

    Lap: torch.Tensor  # [C^2, M^2]  sx^2 V0(x)V2 + sy^2 V2(x)V0 (positive)
    Gx: torch.Tensor  # [C^2, M^2]  sx V0 (x) V1
    Gy: torch.Tensor  # [C^2, M^2]  sy V1 (x) V0
    Dconst: torch.Tensor  # [C^2, M^2]  bx Gx + by Gy + c Mass
    B: torch.Tensor  # [4M-4, M^2] shared trace rows
    Z: torch.Tensor  # [M^2, M^2-(4M-4)] null basis of B
    Pbc: torch.Tensor  # [M^2, 4M-4] min-norm particular map
    # Fused-kernel precompute (host f64, statically scaled by 1/s2 so every
    # f32 intermediate is O(1)): the four operator parts projected onto the
    # null basis / particular map, stacked [Lap; Gx; Gy; Dconst].
    AZ: Optional[torch.Tensor] = None  # [4 C^2, K]  (K = null-space dim)
    AP: Optional[torch.Tensor] = None  # [4 C^2, 4M-4]
    s2: float = 1.0  # the static row scale sx^2 + sy^2
    # Pair-symmetrised products of the AZ blocks: N = G^T G = NZ contracted
    # against the coefficient pair-product fields.  The JAX package's TPU
    # kernel uses it; the CUDA kernel accumulates N directly and does not.
    # Pairs (s, t), s <= t < n_terms, lexicographic; n_terms = 3 when
    # Dconst vanishes (pure -div(a grad u)) else 4.
    NZ: Optional[torch.Tensor] = None  # [K^2, P C^2], P = n_terms (n_terms+1)/2
    n_terms: int = 3

    def to(self, device=None, dtype=None) -> "VarCoeff2DOperators":
        return kkt.bundle_to(self, device, dtype)


def prepare_shared_2d(problem: Problem2D, cfg: Solver2DConfig):
    """Host float64 precompute of the shared 2D operators (D, B, Wf, Wbc);
    for variable-coefficient problems (``problem.a_var``), the shared
    operator parts + null-space basis instead (``VarCoeff2DOperators``).
    Returns (bundle of CPU tensors in the run dtype, (t_int, bpts) numpy).

    PDE collocation uses interior points only: at element corners
    Lap(p) == 0 for every zero-trace polynomial p, so corner rows are
    structurally unfittable and would only pollute the least-squares fit.
    """
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny
    M, C = cfg.M, cfg.n_colloc
    dtype = cfg.torch_dtype()
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)
    bpts = _boundary_coords(M)
    V0y_b = legendre.vandermonde_host(bpts[:, 0], M)[0]  # [Kb, M]
    V0x_b = legendre.vandermonde_host(bpts[:, 1], M)[0]
    B = np.einsum("pk,pl->pkl", V0y_b, V0x_b).reshape(-1, M * M)
    sx, sy = 2.0 / hx, 2.0 / hy
    bx, by = problem.b

    def tens(Vy, Vx):
        return np.einsum("yk,xl->yxkl", Vy, Vx)

    if problem.a_var is not None:
        Lap = (sx * sx * tens(V0, V2)
               + sy * sy * tens(V2, V0)).reshape(C * C, M * M)
        Gx = (sx * tens(V0, V1)).reshape(C * C, M * M)
        Gy = (sy * tens(V1, V0)).reshape(C * C, M * M)
        Mass = tens(V0, V0).reshape(C * C, M * M)
        Dconst = bx * Gx + by * Gy + problem.c * Mass
        Z, Pbc = kkt.nullspace_host(B)
        s2 = sx * sx + sy * sy
        AZ = np.concatenate([Lap @ Z, Gx @ Z, Gy @ Z, Dconst @ Z]) / s2
        AP = np.concatenate([Lap @ Pbc, Gx @ Pbc, Gy @ Pbc,
                             Dconst @ Pbc]) / s2
        C2 = C * C
        K = Z.shape[1]
        n_terms = 4 if (bx != 0.0 or by != 0.0 or problem.c != 0.0) else 3
        AZb = AZ.reshape(4, C2, K)
        pairs = [(s, t) for s in range(n_terms) for t in range(s, n_terms)]
        NZ = np.zeros((K * K, len(pairs) * C2))
        for p, (s, t) in enumerate(pairs):
            blk = np.einsum("qj,qk->jkq", AZb[s], AZb[t])
            if s != t:
                blk = blk + np.einsum("qj,qk->jkq", AZb[t], AZb[s])
            NZ[:, p * C2:(p + 1) * C2] = blk.reshape(K * K, C2)

        def tt(v):
            return torch.as_tensor(v, dtype=dtype)

        ops = VarCoeff2DOperators(
            Lap=tt(Lap), Gx=tt(Gx), Gy=tt(Gy), Dconst=tt(Dconst), B=tt(B),
            Z=tt(Z), Pbc=tt(Pbc), AZ=tt(AZ), AP=tt(AP), s2=float(s2),
            NZ=tt(NZ), n_terms=n_terms,
        )
        return ops, (t_int, bpts)
    # D[(iy, ix), (ky, kx)] = rows of L = -a0 Lap + b . grad + c applied to
    # the tensor-product basis P_ky(ty) P_kx(tx) with chain factors 2/h.
    Dt = -problem.a0 * (sx * sx * tens(V0, V2) + sy * sy * tens(V2, V0))
    if bx != 0.0:
        Dt = Dt + bx * sx * tens(V0, V1)
    if by != 0.0:
        Dt = Dt + by * sy * tens(V1, V0)
    if problem.c != 0.0:
        Dt = Dt + problem.c * tens(V0, V0)
    D = Dt.reshape(C * C, M * M)
    rhs_factors = None
    if problem.f_colloc_factors is not None:
        # Static in-element offsets matching D's row-major (iy, ix) rows.
        dx = (np.tile(t_int, C) + 1.0) * 0.5 * hx
        dy = (np.repeat(t_int, C) + 1.0) * 0.5 * hy
        rhs_factors = problem.f_colloc_factors(dx, dy)
    if cfg.formulation == "dual":
        # The augmented quasi-definite kernel system, extracted once in
        # host f64; finite gamma makes it differ from the LSE
        # (gamma -> inf) primal by O(1/gamma).
        shared = kkt.precompute_shared_dual_host(
            D, B, cfg.gamma, dtype, rhs_colloc_factors=rhs_factors)
    else:
        # LSE precompute: the 2D Laplacian's discrete-harmonic null space
        # makes the gamma-form normal equations unsolvable even in f64.
        shared = kkt.precompute_shared_lse_host(
            D, B, dtype, rhs_colloc_factors=rhs_factors)
    return shared, (t_int, bpts)


def _varcoeff_mg_levels(problem: Problem2D, hx: float, hy: float, dtype,
                        device=None, lvl_offset: int = 0,
                        c_override: float = None):
    """``apply_diag_for_level(lvl, shape)`` factory for
    ``multigrid.make_vcycle`` with variable diffusion: exact per-level
    rediscretisation by re-sampling the coefficient callable at each
    level's own quadrature points.  Level ``lvl`` sits at spacing
    ``h * 2**(lvl + lvl_offset)``.  ``c_override`` replaces the reaction
    coefficient (shifted-Laplacian preconditioning uses c -> |c|)."""
    x0d, y0d = problem.domain[0], problem.domain[2]
    bx, by = problem.b
    c_eff = problem.c if c_override is None else c_override
    has_const = c_eff != 0.0 or bx != 0.0 or by != 0.0

    def apply_diag_for_level(lvl, shape):
        s = float(2 ** (lvl + lvl_offset))
        Sq_l, dxq_l, dyq_l = assembly2d.q1_varcoeff_parts(hx * s, hy * s)
        xs_l = x0d + hx * s * torch.arange(shape[1], dtype=dtype,
                                           device=device)
        ys_l = y0d + hy * s * torch.arange(shape[0], dtype=dtype,
                                           device=device)
        am = assembly2d.coeff_maps(xs_l, ys_l, problem.a_var, dxq_l, dyq_l)
        Kc = None
        if has_const:
            Kc = assembly2d.q1_local_operator(hx * s, hy * s, 0.0, c_eff,
                                              bx, by)

        def apply_l(v):
            y = assembly2d.apply_stiffness_var(v, Sq_l, am)
            if Kc is not None:
                y = y + assembly2d.apply_stiffness(v, Kc)
            return y

        d = assembly2d.stiffness_var_diag(shape, Sq_l, am, dtype)
        if Kc is not None:
            d = d + assembly2d.stiffness_diag(shape, Kc, dtype, device)
        return apply_l, d

    return apply_diag_for_level


def _edge_mass_apply(g, h):
    """Consistent P1 edge-mass product M @ g on a uniform edge: interior
    rows h/6 (g_{i-1} + 4 g_i + g_{i+1}), end rows h/6 (2 g_end + g_nb)."""
    core = (g[:-2] + 4.0 * g[1:-1] + g[2:]) * (h / 6.0)
    e0 = ((2.0 * g[0] + g[1]) * (h / 6.0))[None]
    e1 = ((g[-2] + 2.0 * g[-1]) * (h / 6.0))[None]
    return torch.cat([e0, core, e1])


def _edge_mass_diag(n, h, dtype, device):
    d = torch.full((n,), 4.0 * h / 6.0, dtype=dtype, device=device)
    d[0] = d[-1] = 2.0 * h / 6.0
    return d


# Grid slices of the four rectangle edges in bc_edges order (left, right,
# bottom, top).
_EDGE_SLICES = ((slice(None), 0), (slice(None), -1), (0, slice(None)),
                (-1, slice(None)))


def _edge_add(arr, e, vals):
    out = arr.clone()
    out[_EDGE_SLICES[e]] += vals
    return out


def fem_solve_2d(problem: Problem2D, cfg: Solver2DConfig, xs, ys):
    """Coarse Q1 nodal values on the grid via preconditioned CG (SPD
    operators) or BiCGStab (advection / indefinite Helmholtz).  Returns
    (u [ny+1, nx+1], ``cg.CGResult``)."""
    dtype, device = xs.dtype, xs.device
    hx = float((problem.domain[1] - problem.domain[0]) / cfg.nx)
    hy = float((problem.domain[3] - problem.domain[2]) / cfg.ny)
    bx, by = problem.b
    var = problem.a_var is not None
    compact = cfg.coarse == "compact"
    if compact:
        if var:
            raise ValueError(
                "coarse='compact' needs constant diffusion (a_var is set); "
                "use coarse='q1'")
        if bx != 0.0 or by != 0.0:
            raise ValueError("coarse='compact' requires b == (0, 0)")
        if any(t != "dirichlet" for t in problem.bc_edges):
            raise ValueError(
                "coarse='compact' requires all-Dirichlet edges (the "
                "Numerov rhs weighting assumes value-pinned boundaries)")

    def local_op(hx_, hy_, c_):
        """Shared local 4x4 at spacing (hx_, hy_): the Q1 weak form, or the
        tensor-Numerov compact operator (same 9-point sparsity, so the
        matrix-free/MG machinery below is scheme-agnostic)."""
        if compact:
            return assembly2d.q1_numerov_locals(hx_, hy_, problem.a0, c_)[0]
        return assembly2d.q1_local_operator(hx_, hy_, problem.a0, c_, bx, by)

    with _span("fem_solve_2d.assemble"):
        if var:
            # Per-element stiffness K_e = sum_q a(x_q) S_q; the reaction /
            # advection terms stay shared and compose additively.
            Sq, dxq, dyq = assembly2d.q1_varcoeff_parts(hx, hy)
            a_maps = assembly2d.coeff_maps(xs, ys, problem.a_var, dxq, dyq)
            K_const = None
            if problem.c != 0.0 or bx != 0.0 or by != 0.0:
                K_const = assembly2d.q1_local_operator(hx, hy, 0.0,
                                                       problem.c, bx, by)

            def apply_op(v):
                y = assembly2d.apply_stiffness_var(v, Sq, a_maps)
                if K_const is not None:
                    y = y + assembly2d.apply_stiffness(v, K_const)
                return y
        else:
            K_loc = local_op(hx, hy, problem.c)

            def apply_op(v):
                return assembly2d.apply_stiffness(v, K_loc)
        # CG requires SPD: symmetric needs b == 0; definiteness can fail
        # for c < 0 (Helmholtz), so those go to BiCGStab.
        spd = bx == 0.0 and by == 0.0 and problem.c >= 0.0

        Y, X = torch.meshgrid(ys, xs, indexing="ij")
        if compact:
            # Numerov-weighted load M f_nodal (nodal samples, not
            # quadrature): the pair (A, M f) makes the scheme O(h^4).
            K_M = assembly2d.q1_numerov_locals(hx, hy, problem.a0,
                                               problem.c)[1]
            F_nodes = problem.f(X, Y) * torch.ones_like(X)
            b = assembly2d.apply_stiffness(F_nodes, K_M)
        else:
            b = assembly2d.assemble_load(xs, ys, problem.f)
        ny1, nx1 = ys.shape[0], xs.shape[0]
        bcs = problem.bc_edges
        mixed = any(t != "dirichlet" for t in bcs)
        robin_edges = []
        edge_h = (hy, hy, hx, hx)
        if not mixed:
            interior = torch.zeros((ny1, nx1), dtype=torch.bool,
                                   device=device)
            interior[1:-1, 1:-1] = True
        else:
            # Natural (Neumann/Robin) edges keep their boundary nodes as
            # unknowns; only Dirichlet edges are eliminated.  A corner
            # between a Dirichlet and a natural edge is Dirichlet.
            interior = torch.ones((ny1, nx1), dtype=torch.bool,
                                  device=device)
            for e, t in enumerate(bcs):
                if t == "dirichlet":
                    interior[_EDGE_SLICES[e]] = False
            # Weak boundary term of -(a0 Lap u) on natural edges:
            # [a0 du/dn] v = (g_natural - robin_alpha u) v integrated along
            # the edge -> consistent edge load into b, Robin edge mass into
            # the operator.
            edge_xy = ((torch.full_like(ys, float(xs[0])), ys),
                       (torch.full_like(ys, float(xs[-1])), ys),
                       (xs, torch.full_like(xs, float(ys[0]))),
                       (xs, torch.full_like(xs, float(ys[-1]))))
            for e, t in enumerate(bcs):
                if t == "dirichlet":
                    continue
                gx, gy = edge_xy[e]
                gv = problem.g_natural(gx, gy) * torch.ones_like(gx)
                b = _edge_add(b, e, _edge_mass_apply(gv, edge_h[e]))
                if t == "robin":
                    robin_edges.append(e)
            if robin_edges:
                alpha = problem.robin_alpha
                base_apply = apply_op

                def apply_op(v):
                    y = base_apply(v)
                    for e in robin_edges:
                        y[_EDGE_SLICES[e]] += alpha * _edge_mass_apply(
                            v[_EDGE_SLICES[e]], edge_h[e])
                    return y

        u_bc = torch.where(interior, 0.0, problem.g(X, Y) * torch.ones_like(X))

        def apply_free(v):
            return torch.where(interior, apply_op(v * interior), 0.0)

        rhs = torch.where(interior, b - apply_op(u_bc), 0.0)

    def robin_diag(diag):
        for e in robin_edges:
            diag = _edge_add(
                diag, e,
                problem.robin_alpha * _edge_mass_diag(
                    ny1 if e < 2 else nx1, edge_h[e], dtype, device))
        return diag

    with _span("fem_solve_2d.precond_setup"):
        precond = cfg.precond
        mg_grid = (cfg.nx % 2 == 0 and cfg.ny % 2 == 0
                   and min(cfg.nx, cfg.ny) >= 8)
        if mixed:
            if precond in ("shifted", "adi"):
                raise ValueError(
                    f"precond={precond!r} assumes all-Dirichlet edges; "
                    f"mixed-BC problems run with precond='mg'|'jacobi' "
                    f"(or 'auto')"
                )
            mg_ok = mg_grid and problem.c >= 0.0 and not var
            if precond == "auto":
                precond = "mg" if mg_ok else "jacobi"
            if precond == "mg" and not mg_ok:
                raise ValueError(
                    "mixed-BC 'mg' needs an even >= 8 grid, c >= 0 and "
                    "constant coefficients; use precond='jacobi'"
                )
        elif precond == "auto":
            # The V-cycle needs 2-divisible grids; Jacobi-CG iterations
            # grow O(N), so prefer multigrid.  For indefinite Helmholtz
            # (c < 0) damped-Jacobi smoothing amplifies the near-null modes
            # of the true operator, so BiCGStab is preconditioned with the
            # SPD-shifted operator's V-cycle instead (c -> |c|).
            if mg_grid:
                precond = "mg" if problem.c >= 0.0 else "shifted"
            else:
                precond = "jacobi"
        if precond in ("mg", "shifted"):
            from ..ops import multigrid

            c_mg = abs(problem.c) if precond == "shifted" else problem.c
            if var:
                # Exact rediscretisation per level from the true a_var.
                vcyc = multigrid.make_vcycle(
                    ny1, nx1, None, dtype, device=device,
                    apply_diag_for_level=_varcoeff_mg_levels(
                        problem, hx, hy, dtype, device,
                        c_override=c_mg if precond == "shifted" else None),
                )
            elif mixed:
                # As the reference: the fine local matrix on every level.
                vcyc = multigrid.make_vcycle(ny1, nx1, K_loc, dtype,
                                             device=device)
            else:
                # Rediscretise the full operator per level: the stiffness
                # part is scale-invariant but mass / convection parts scale
                # with h.
                def loc_for_level(lvl):
                    s = float(2 ** lvl)
                    return local_op(hx * s, hy * s, c_mg)

                vcyc = multigrid.make_vcycle(
                    ny1, nx1, loc_for_level(0), dtype, device=device,
                    loc_for_level=loc_for_level)
            if mixed:
                # Composite preconditioner: the all-Dirichlet V-cycle on
                # the inner subspace + Jacobi on the natural-edge unknowns
                # (the V-cycle hierarchy assumes zero-trace grids).
                inner = torch.zeros((ny1, nx1), dtype=torch.bool,
                                    device=device)
                inner[1:-1, 1:-1] = True
                diag_m = robin_diag(assembly2d.stiffness_diag(
                    (ny1, nx1), K_loc, dtype, device))
                edge_free = interior & ~inner

                def M_inv(r):
                    return (torch.where(inner, vcyc(r * inner), 0.0)
                            + torch.where(edge_free, r / diag_m, 0.0))
            else:
                M_inv = vcyc
        elif precond == "adi":
            from ..parallel.transpose import make_adi_preconditioner

            M_inv = make_adi_preconditioner(ny1, nx1, hx, hy, dtype)
        elif precond == "jacobi":
            if var:
                diag = assembly2d.stiffness_var_diag((ny1, nx1), Sq, a_maps,
                                                     dtype)
                if K_const is not None:
                    diag = diag + assembly2d.stiffness_diag(
                        (ny1, nx1), K_const, dtype, device)
            else:
                diag = assembly2d.stiffness_diag((ny1, nx1), K_loc, dtype,
                                                 device)
            M_inv = torch.where(interior, 1.0 / robin_diag(diag), 1.0)
        else:
            raise ValueError(f"unknown precond: {precond!r}")
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    solver = cg.cg if spd else cg.bicgstab
    with _span("fem_solve_2d.krylov"):
        res = solver(apply_free, rhs, M_inv=M_inv, tol=tol,
                     maxiter=cfg.cg_maxiter)
    u = u_bc + torch.where(interior, res.x, 0.0)
    return u, res


def _element_data_2d(problem: Problem2D, cfg: Solver2DConfig, xs, ys,
                     fem_values, t_int, bpts, row_offset=0, col_offset=0,
                     trace_lift: int = 0, skip_f: bool = False,
                     trace_rows=None):
    """Per-element collocation rhs [E, C^2] (interior points) and
    boundary-trace values [E, 4M-4] (FEM bilinear trace, overridden by g on
    the Dirichlet edges of the domain).

    ``ys``/``fem_values`` may be a local y-slab; then ``row_offset`` is the
    slab's global first element row, used for the domain-boundary masks;
    ``col_offset`` likewise for column blocks.  ``trace_lift >= 2`` replaces
    the bilinear trace with the tangential Lagrange lift
    (``_lifted_trace_2d``; whole-grid callers only); slab callers pass
    ``trace_rows`` [ny_loc, nx, K] precomputed on the full grid instead.
    Domain-boundary points still take g exactly.  ``skip_f=True`` skips the
    collocation rows (returned as None) for trace-only callers.
    """
    dtype, device = xs.dtype, xs.device
    C = cfg.n_colloc
    nx_loc = xs.shape[0] - 1
    ny_loc = ys.shape[0] - 1
    t = torch.tensor(np.asarray(t_int), dtype=dtype, device=device)
    hx = xs[1:] - xs[:-1]
    hy = ys[1:] - ys[:-1]
    xm = 0.5 * (xs[1:] + xs[:-1])
    ym = 0.5 * (ys[1:] + ys[:-1])
    xq = xm[:, None] + 0.5 * hx[:, None] * t[None, :]
    yq = ym[:, None] + 0.5 * hy[:, None] * t[None, :]
    if skip_f:
        f_rows = None
    else:
        # f on [ny, nx, C(y), C(x)] -> flatten rows row-major (iy, ix)
        F = problem.f(xq[None, :, None, :], yq[:, None, :, None])
        F = F * torch.ones((ny_loc, nx_loc, C, C), dtype=dtype,
                           device=device)
        f_rows = F.reshape(ny_loc * nx_loc, C * C)

    u00 = fem_values[:-1, :-1]
    u10 = fem_values[:-1, 1:]
    u01 = fem_values[1:, :-1]
    u11 = fem_values[1:, 1:]
    b = torch.tensor(np.asarray(bpts), dtype=dtype, device=device)
    ty, tx = b[:, 0], b[:, 1]  # [K]
    N00 = 0.25 * (1 - tx) * (1 - ty)
    N10 = 0.25 * (1 + tx) * (1 - ty)
    N01 = 0.25 * (1 - tx) * (1 + ty)
    N11 = 0.25 * (1 + tx) * (1 + ty)
    if trace_rows is not None:
        trace = trace_rows  # [ny_loc, nx, K] precomputed (global windows)
    elif trace_lift >= 2:
        trace = _lifted_trace_2d(
            fem_values, cfg.M, nx_loc, ny_loc, stencil=trace_lift
        ).reshape(ny_loc, nx_loc, -1)
    else:
        trace = (
            u00[..., None] * N00 + u10[..., None] * N10
            + u01[..., None] * N01 + u11[..., None] * N11
        )  # [ny, nx, K]

    # Domain-boundary override: boundary points on Dirichlet edges of
    # boundary elements take g(x, y) exactly.  Natural (Neumann/Robin)
    # edges have no exact boundary value: those element traces keep the
    # FEM trace.
    ex = col_offset + torch.arange(nx_loc, device=device)  # global columns
    ey = row_offset + torch.arange(ny_loc, device=device)  # global rows
    xp = (xm[:, None] + 0.5 * hx[:, None] * tx[None, :])[None, :, :]
    yp = (ym[:, None] + 0.5 * hy[:, None] * ty[None, :])[:, None, :]
    on_edge = (
        (ex[None, :, None] == 0) & (tx[None, None, :] == -1.0),
        (ex[None, :, None] == cfg.nx - 1) & (tx[None, None, :] == 1.0),
        (ey[:, None, None] == 0) & (ty[None, None, :] == -1.0),
        (ey[:, None, None] == cfg.ny - 1) & (ty[None, None, :] == 1.0),
    )
    on_domain_bdry = functools.reduce(
        torch.logical_or,
        [m for m, t in zip(on_edge, problem.bc_edges) if t == "dirichlet"],
        torch.zeros((1, 1, 1), dtype=torch.bool, device=device),
    )
    gvals = problem.g(xp, yp) * torch.ones_like(trace)
    bc_rows = torch.where(on_domain_bdry, gvals, trace)
    return (f_rows, bc_rows.reshape(ny_loc * nx_loc, -1),
            (u00, u10, u01, u11))


def _bilinear_fallback_coeffs(u00, u10, u01, u11, M):
    """Tensor-Legendre coefficients of the Q1 bilinear interpolant: the 2D
    analog of the linear fallback."""
    ny, nx = u00.shape
    c = torch.zeros((ny, nx, M, M), dtype=u00.dtype, device=u00.device)
    c[:, :, 0, 0] = 0.25 * (u00 + u10 + u01 + u11)
    c[:, :, 0, 1] = 0.25 * (-u00 + u10 - u01 + u11)
    c[:, :, 1, 0] = 0.25 * (-u00 - u10 + u01 + u11)
    c[:, :, 1, 1] = 0.25 * (u00 - u10 - u01 + u11)
    return c


def _kernel_solve_ok(slack, bcv, corners):
    """Per-element acceptance gate after a fused kernel (JAX
    ``_pallas_solve_ok``).

    The tolerance scales with the boundary-data magnitude (the corner
    values bound the bilinear trace, and boundary nodes hold g exactly).
    It must not scale with the violation itself: a self-referential gate
    lets a broken element inflate its own threshold and skip the fallback.
    """
    u00, u10, u01, u11 = corners
    finite = torch.isfinite(slack) & torch.isfinite(bcv)
    scale = 1.0 + torch.maximum(
        torch.maximum(torch.abs(u00), torch.abs(u10)),
        torch.maximum(torch.abs(u01), torch.abs(u11)),
    ).reshape(bcv.shape)
    return finite & (bcv <= 1e-2 * scale)


def _varcoeff_element_operators(problem: Problem2D, cfg: Solver2DConfig,
                                xs, ys, vb: VarCoeff2DOperators, t_int):
    """Batched per-element collocation operators D [E, C^2, M^2]: sample
    the coefficient fields (a, da/dx, da/dy) at each element's collocation
    grid and combine the shared host-f64 parts.  grad_a analytic when
    supplied, else derived by ``torch.autograd`` (the fused kernel requires
    analytic grad_a).  Element counts come from the node arrays, so a
    caller may pass a local slab or block."""
    dtype, device = xs.dtype, xs.device
    nx_l = xs.shape[0] - 1
    ny_l = ys.shape[0] - 1
    E = nx_l * ny_l
    C = cfg.n_colloc
    t = torch.tensor(np.asarray(t_int), dtype=dtype, device=device)
    hx = xs[1] - xs[0]
    hy = ys[1] - ys[0]
    xq = xs[:-1][:, None] + 0.5 * hx * (t[None, :] + 1.0)  # [nx_l, C]
    yq = ys[:-1][:, None] + 0.5 * hy * (t[None, :] + 1.0)  # [ny_l, C]
    ones = torch.ones((ny_l, nx_l, C, C), dtype=dtype, device=device)
    Xq = xq[None, :, None, :] * ones
    Yq = yq[:, None, :, None] * ones

    def samp(fn):
        return (fn(Xq, Yq) * ones).reshape(E, C * C)

    a_e = samp(problem.a_var)
    if problem.grad_a is not None:
        ax_e, ay_e = samp(problem.grad_a[0]), samp(problem.grad_a[1])
    else:  # derive the chain-rule coefficients by autograd
        with torch.enable_grad():
            Xg = Xq.clone().requires_grad_(True)
            Yg = Yq.clone().requires_grad_(True)
            total = (problem.a_var(Xg, Yg) * ones).sum()
            gx, gy = torch.autograd.grad(total, (Xg, Yg), allow_unused=True)
        zero = torch.zeros_like(Xq)
        ax_e = (zero if gx is None else gx).reshape(E, C * C)
        ay_e = (zero if gy is None else gy).reshape(E, C * C)
    return (
        -a_e[..., None] * vb.Lap
        - ax_e[..., None] * vb.Gx
        - ay_e[..., None] * vb.Gy
        + vb.Dconst
    )


def _resolve_backend(problem: Problem2D, cfg: Solver2DConfig, device,
                     forced_torch: bool = False) -> str:
    """The enhancement route: 'cuda' (fused kernels) or 'torch'.

    A lifted trace or ``bc_rows_override`` forces 'torch' (the kernels build
    the bilinear trace themselves).  'auto' takes the kernels for CUDA
    float32 tensors, except for an ``a_var`` problem without analytic
    ``grad_a``; an (M, n_colloc) the kernels were not compiled for then
    raises rather than running torch on the card."""
    if forced_torch:
        return "torch"
    device = torch.device(device)
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    if cfg.backend != "auto":
        return cfg.backend
    if (device.type == "cuda" and cfg.torch_dtype() == torch.float32
            and (problem.a_var is None or problem.grad_a is not None)):
        return "cuda"
    return "torch"


def enhance_2d(problem: Problem2D, cfg: Solver2DConfig, xs, ys, fem_values,
               shared_bundle, bc_rows_override=None):
    """Enhancement stage in isolation: per-element tensor-Legendre fit of
    the operator against arbitrary nodal trace data (the second half of
    ``hybrid_solve_2d``).  Returns (coeffs [ny, nx, M, M], KKTDiagnostics,
    cond).

    ``bc_rows_override``: [E, 4M-4] trace values replacing the FEM bilinear
    edge trace; forces the torch route, as ``cfg.trace_lift >= 2`` does.
    """
    shared, (t_int, bpts) = shared_bundle
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny
    E = cfg.nx * cfg.ny
    use_lift = bc_rows_override is None and cfg.trace_lift >= 2
    backend = _resolve_backend(
        problem, cfg, fem_values.device,
        forced_torch=bc_rows_override is not None or use_lift)
    if backend == "cuda":
        geom = (x0, hx, y0, hy)
        if problem.a_var is not None:
            sx, sy = 2.0 / hx, 2.0 / hy
            w, slack, bcv = kernels2d.fused_enhance_varcoeff_2d(
                fem_values, shared, problem.a_var, problem.grad_a,
                problem.f, problem.g, geom, cfg.nx, cfg.ny, t_int, bpts,
                s2=sx * sx + sy * sy, with_diagnostics=cfg.diagnostics,
                f_shifted_fn=problem.f_shifted, method=cfg.varcoeff_method,
            )
        else:
            fused = (kernels2d.fused_enhance_stacked_2d
                     if shared.Pres is not None
                     else kernels2d.fused_enhance_shared_2d)
            w, slack, bcv = fused(
                fem_values, shared, problem.f, problem.g, geom, cfg.nx,
                cfg.ny, t_int, bpts, with_diagnostics=cfg.diagnostics,
                f_shifted_fn=problem.f_shifted,
            )
        corners = (fem_values[:-1, :-1], fem_values[:-1, 1:],
                   fem_values[1:, :-1], fem_values[1:, 1:])
        if cfg.diagnostics:
            diags = kkt.KKTDiagnostics(
                slack, bcv, _kernel_solve_ok(slack, bcv, corners))
        else:
            z = torch.zeros(E, dtype=w.dtype, device=w.device)
            diags = kkt.KKTDiagnostics(
                z, z, torch.all(torch.isfinite(w), dim=-1))
    else:
        f_rows, bc_rows, corners = _element_data_2d(
            problem, cfg, xs, ys, fem_values, t_int, bpts,
            trace_lift=cfg.trace_lift if use_lift else 0,
        )
        if bc_rows_override is not None:
            bc_rows = bc_rows_override
        if problem.a_var is not None:
            # Per-element operators: assemble D_e from the shared parts,
            # then the batched null-space solve.
            D = _varcoeff_element_operators(problem, cfg, xs, ys, shared,
                                            t_int)
            w, diags = kkt.solve_batched(
                D, shared.B, f_rows, bc_rows, cfg.gamma,
                formulation=cfg.formulation, ZP=(shared.Z, shared.Pbc),
            )
        else:
            w, diags = kkt.solve_primal_shared(shared, f_rows, bc_rows)
    M = cfg.M
    coeffs = w.reshape(cfg.ny, cfg.nx, M, M)
    fb = _bilinear_fallback_coeffs(*corners, M)
    ok = diags.solve_ok.reshape(cfg.ny, cfg.nx)
    coeffs = torch.where(
        ok[..., None, None],
        torch.where(torch.isfinite(coeffs), coeffs, 0.0), fb)
    cond = (diags.cond_estimate if problem.a_var is not None
            else shared.cond)
    return coeffs, diags, cond


def hybrid_solve_2d(problem: Problem2D, cfg: Solver2DConfig, shared_bundle,
                    device=None) -> Solution2D:
    """Coarse Q1 solve then the batched enhancement, on ``device`` (None:
    the GPU; a machine without one raises — pass ``device='cpu'``).  The
    operator bundle of ``prepare_shared_2d`` is moved there first."""
    device = resolve_device(device)
    shared, pts = shared_bundle
    shared_bundle = (shared.to(device), pts)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = problem.domain
    xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)

    if cfg.fem_dtype is not None:
        fd = getattr(torch, cfg.fem_dtype)
        fem_values, cg_res = fem_solve_2d(problem, cfg, xs.to(fd), ys.to(fd))
        fem_values = fem_values.to(dtype)
    else:
        fem_values, cg_res = fem_solve_2d(problem, cfg, xs, ys)
    with _span("enhance_2d"):
        coeffs, diags, cond = enhance_2d(problem, cfg, xs, ys, fem_values,
                                         shared_bundle)
    return Solution2D(
        xs=xs, ys=ys, fem_values=fem_values, coeffs=coeffs,
        cg_iters=cg_res.iters, cg_residual=cg_res.residual,
        max_slack=diags.max_slack.reshape(cfg.ny, cfg.nx),
        bc_violation=diags.bc_violation.reshape(cfg.ny, cfg.nx),
        solve_ok=diags.solve_ok.reshape(cfg.ny, cfg.nx),
        cond_estimate=cond,
    )


def _locate_2d(sol: Solution2D, x, y):
    xs, ys = sol.xs, sol.ys
    nx = xs.shape[0] - 1
    ny = ys.shape[0] - 1
    hx = xs[1] - xs[0]
    hy = ys[1] - ys[0]
    ix = torch.clamp(torch.floor((x - xs[0]) / hx).to(torch.int64), 0,
                     nx - 1)
    iy = torch.clamp(torch.floor((y - ys[0]) / hy).to(torch.int64), 0,
                     ny - 1)
    tx = (2.0 * x - xs[ix] - xs[ix + 1]) / hx
    ty = (2.0 * y - ys[iy] - ys[iy + 1]) / hy
    return ix, iy, tx, ty, hx, hy


def evaluate_2d(sol: Solution2D, x: torch.Tensor, y: torch.Tensor):
    """u(x, y) at query points [P]: O(1) lookup on the uniform grid and a
    batched tensor-Legendre evaluation; points outside the domain are
    evaluated in the nearest element (clamped)."""
    ix, iy, tx, ty, _, _ = _locate_2d(sol, x, y)
    M = sol.coeffs.shape[-1]
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)  # [P, M]
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    W = sol.coeffs[iy, ix]  # [P, M(ky), M(kx)]
    return torch.einsum("pk,pkl,pl->p", Vy, W, Vx)


def evaluate_2d_gradient(sol: Solution2D, x: torch.Tensor, y: torch.Tensor):
    """(du/dx, du/dy) at query points [P]: tensor-Legendre derivative
    Vandermonde with the per-axis chain factors 2/hx, 2/hy."""
    ix, iy, tx, ty, hx, hy = _locate_2d(sol, x, y)
    M = sol.coeffs.shape[-1]
    Vx, Vx1 = legendre.legendre_vandermonde(tx, M, num_derivs=1)
    Vy, Vy1 = legendre.legendre_vandermonde(ty, M, num_derivs=1)
    W = sol.coeffs[iy, ix]  # [P, M(ky), M(kx)]
    ux = (2.0 / hx) * torch.einsum("pk,pkl,pl->p", Vy, W, Vx1)
    uy = (2.0 / hy) * torch.einsum("pk,pkl,pl->p", Vy1, W, Vx)
    return ux, uy


class HybridSolver2D:
    """Facade mirroring the 1D API for structured-quad 2D problems.

    ``device`` is where the solve runs: the GPU by default (a machine
    without one raises), the CPU only on ``device='cpu'``.  The host
    precompute of the operators happens once, at construction.
    """

    def __init__(self, problem: Problem2D,
                 config: Solver2DConfig = Solver2DConfig(), device=None):
        self.problem = problem
        self.config = config
        self.device = resolve_device(device)
        with _span("prepare_shared_2d"):
            shared, pts = prepare_shared_2d(problem, config)
            self._shared = (shared.to(self.device), pts)
        self.solution: Optional[Solution2D] = None

    def solve(self) -> Solution2D:
        self.solution = hybrid_solve_2d(self.problem, self.config,
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
        with _span("evaluate_2d"):
            return evaluate_2d(self.solution, x, y)

    def evaluate_gradient(self, x, y):
        x, y = self._points(x, y)
        return evaluate_2d_gradient(self.solution, x, y)

    def errors(self, x, y):
        """(linf, l2) of the hybrid solution vs the problem's exact
        oracle."""
        from ..utils import metrics

        u = self.evaluate_solution(x, y)
        ue = self.problem.exact(*self._points(x, y))
        return metrics.linf_error(u, ue), metrics.l2_error(u, ue)
