"""3D problems on structured hex meshes: Q1 FEM + tensor-product LSSVR.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/hybrid3d.py``.  The 2D
architecture (``models/hybrid2d.py``) extends tensorially:

* coarse stage: matrix-free Q1 hex stiffness (``ops.assembly3d``) with a
  Jacobi- or V-cycle-preconditioned Krylov solve (``ops.cg``,
  ``ops.multigrid.make_vcycle_3d``);
* enhancement: per hex a tensor-product Legendre expansion
  u = sum w[kz,ky,kx] P_kz(tz) P_ky(ty) P_kx(tx), constrained by L u = f at
  a C^3 interior collocation grid and by pinning the element-boundary trace
  to the Q1 trilinear trace at the surface points of the M^3 tensor grid.
  The trace space has dimension M^3 - (M-2)^3, exactly the number of
  surface points, so B is square and full rank on the trace.
* On a uniform mesh with constant coefficients every hex shares D
  [C^3, M^3] and B [S, M^3], so the enhancement is one affine map
  precomputed on the host in float64 through the null-space LSE algebra;
  with variable diffusion (``Problem3D.a_var``) each hex has its own
  operator and its own null-space least-squares solve.

The enhancement runs in the fused CUDA kernel of ``ops.kernels3d`` on a
CUDA float32 run with constant coefficients and in batched torch algebra
(``ops.kkt``) otherwise: ``Solver3DConfig.backend`` takes 'auto', 'torch'
(JAX's 'xla') or 'cuda' (JAX's 'pallas').  The stages run inside
``torch.profiler.record_function`` spans named in ``SPANS``.  Every entry
point runs on the GPU unless given ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import assembly3d, cg, kernels3d, kkt, legendre
from ..utils.device import resolve as resolve_device
from .hybrid2d import _lift_weights

_span = torch.profiler.record_function
SPANS = ("prepare_shared_3d", "fem_solve_3d.assemble",
         "fem_solve_3d.precond_setup", "fem_solve_3d.krylov", "enhance_3d",
         "evaluate_3d")

pi = math.pi


@dataclasses.dataclass(frozen=True)
class Problem3D:
    """L u = -a0 Lap(u) + b . grad(u) + c u = f on a box, u = g on the
    boundary.  Constant coefficients keep the per-element operators shared
    across the uniform mesh.  All callables take and return torch
    tensors."""

    name: str
    f: Callable  # f(x, y, z)
    g: Callable  # Dirichlet data g(x, y, z)
    domain: Tuple[float, ...] = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    # Per-face BC type (xlo, xhi, ylo, yhi, zlo, zhi): "dirichlet" (u = g),
    # "neumann" (a0 du/dn = g_natural) or "robin" (a0 du/dn + robin_alpha u
    # = g_natural).  Natural faces keep their boundary nodes as unknowns
    # (consistent Q1 face-mass boundary terms in ``fem_solve_3d``); the
    # enhancement pins those element traces to the FEM trace.
    bc_faces: Tuple[str, ...] = ("dirichlet",) * 6
    g_natural: Optional[Callable] = None
    robin_alpha: float = 0.0
    exact: Optional[Callable] = None
    a0: float = 1.0
    c: float = 0.0  # reaction (c < 0: Helmholtz -> BiCGStab coarse stage)
    b: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Variable diffusion -div(a(x,y,z) grad u); grad_a = (da/dx, da/dy,
    # da/dz) for the chain-rule collocation rows (autograd when None).
    a_var: Optional[Callable] = None
    grad_a: Optional[Tuple[Callable, Callable, Callable]] = None
    # Structured rhs: f_shifted(xl, dx, yl, dy, zl, dz) == f(xl+dx, yl+dy,
    # zl+dz) with the transcendentals on the element corners and the static
    # offsets only (angle addition).
    f_shifted: Optional[Callable] = None


def _zeros_g(x, y, z):
    return torch.zeros_like(x + y + z)


def _sincos_shift(xl, dx):
    """(sin, cos) of pi (xl + dx) by angle addition."""
    sxl, cxl = torch.sin(pi * xl), torch.cos(pi * xl)
    sd, cd = torch.sin(pi * dx), torch.cos(pi * dx)
    return sxl * cd + cxl * sd, cxl * cd - sxl * sd


def _sin3(x, y, z):
    return torch.sin(pi * x) * torch.sin(pi * y) * torch.sin(pi * z)


def _cos3(x, y, z):
    return torch.cos(pi * x) * torch.cos(pi * y) * torch.cos(pi * z)


def poisson_3d() -> Problem3D:
    """-Lap u = 3 pi^2 sin(pi x) sin(pi y) sin(pi z), exact
    u = sin(pi x) sin(pi y) sin(pi z)."""

    def f_shifted(xl, dx, yl, dy, zl, dz):
        sx, _ = _sincos_shift(xl, dx)
        sy, _ = _sincos_shift(yl, dy)
        sz, _ = _sincos_shift(zl, dz)
        return 3.0 * pi**2 * sx * sy * sz

    return Problem3D(
        name="poisson_3d",
        f=lambda x, y, z: 3.0 * pi**2 * _sin3(x, y, z),
        g=_zeros_g, exact=_sin3, f_shifted=f_shifted)


def poisson_3d_inhomogeneous() -> Problem3D:
    """-Lap u = 3 pi^2 cos(pi x) cos(pi y) cos(pi z), exact
    u = cos(pi x) cos(pi y) cos(pi z): a nonzero Dirichlet trace exercises
    the face g-override masks end to end."""

    def f_shifted(xl, dx, yl, dy, zl, dz):
        _, cx = _sincos_shift(xl, dx)
        _, cy = _sincos_shift(yl, dy)
        _, cz = _sincos_shift(zl, dz)
        return 3.0 * pi**2 * cx * cy * cz

    return Problem3D(
        name="poisson_3d_inhomogeneous",
        f=lambda x, y, z: 3.0 * pi**2 * _cos3(x, y, z),
        g=_cos3, exact=_cos3, f_shifted=f_shifted)


def helmholtz_3d(k: float = 2.0) -> Problem3D:
    """-Lap u - k^2 u with exact u = sin(pi x) sin(pi y) sin(pi z) (coarse
    stage: BiCGStab with the shifted-Laplacian V-cycle, as in 2D)."""
    amp = 3.0 * pi * pi - k * k

    def f_shifted(xl, dx, yl, dy, zl, dz):
        sx, _ = _sincos_shift(xl, dx)
        sy, _ = _sincos_shift(yl, dy)
        sz, _ = _sincos_shift(zl, dz)
        return amp * sx * sy * sz

    return Problem3D(
        name="helmholtz_3d", f=lambda x, y, z: amp * _sin3(x, y, z),
        g=_zeros_g, exact=_sin3, c=-k * k, f_shifted=f_shifted)


def advection_diffusion_3d(bx: float = 2.0, by: float = 1.0,
                           bz: float = 0.5) -> Problem3D:
    """-Lap u + b . grad u = f with exact u = sin(pi x) sin(pi y)
    sin(pi z) (nonsymmetric coarse system -> BiCGStab)."""

    def rhs(sx, cx, sy, cy, sz, cz):
        return (3.0 * pi**2 * sx * sy * sz + bx * pi * cx * sy * sz
                + by * pi * sx * cy * sz + bz * pi * sx * sy * cz)

    def f(x, y, z):
        return rhs(torch.sin(pi * x), torch.cos(pi * x), torch.sin(pi * y),
                   torch.cos(pi * y), torch.sin(pi * z), torch.cos(pi * z))

    def f_shifted(xl, dx, yl, dy, zl, dz):
        return rhs(*_sincos_shift(xl, dx), *_sincos_shift(yl, dy),
                   *_sincos_shift(zl, dz))

    return Problem3D(
        name="advection_diffusion_3d", f=f, g=_zeros_g, exact=_sin3,
        b=(bx, by, bz), f_shifted=f_shifted)


def variable_coeff_elliptic_3d() -> Problem3D:
    """-div(a grad u) = f with a(x,y,z) = 1 + 0.5 x y z (in [7/8, 9/8] on
    the cube: SPD coarse system), exact u = sin(pi x) sin(pi y) sin(pi z);
    f = 3 pi^2 a u - grad a . grad u with grad a = 0.5 (yz, xz, xy)."""

    def a(x, y, z):
        return 1.0 + 0.5 * x * y * z

    def ax(x, y, z):
        return 0.5 * y * z * torch.ones_like(x)

    def ay(x, y, z):
        return 0.5 * x * z * torch.ones_like(y)

    def az(x, y, z):
        return 0.5 * x * y * torch.ones_like(z)

    def f(x, y, z):
        sx, cx = torch.sin(pi * x), torch.cos(pi * x)
        sy, cy = torch.sin(pi * y), torch.cos(pi * y)
        sz, cz = torch.sin(pi * z), torch.cos(pi * z)
        return (3.0 * pi * pi * (1.0 + 0.5 * x * y * z) * sx * sy * sz
                - 0.5 * pi * (y * z * cx * sy * sz + x * z * sx * cy * sz
                              + x * y * sx * sy * cz))

    return Problem3D(
        name="variable_coeff_elliptic_3d", f=f, g=_zeros_g, exact=_sin3,
        a_var=a, grad_a=(ax, ay, az))


def poisson_3d_neumann() -> Problem3D:
    """-Lap u = 3 pi^2 sin sin sin with a Neumann x-hi face:
    du/dn|_{x=1} = -pi sin(pi y) sin(pi z); Dirichlet (g = 0) elsewhere.
    Exact u = sin(pi x) sin(pi y) sin(pi z)."""
    return Problem3D(
        name="poisson_3d_neumann",
        f=lambda x, y, z: 3.0 * pi**2 * _sin3(x, y, z),
        g=_zeros_g,
        bc_faces=("dirichlet", "neumann", "dirichlet", "dirichlet",
                  "dirichlet", "dirichlet"),
        g_natural=lambda x, y, z: -pi * torch.sin(pi * y) * torch.sin(pi * z)
        * torch.ones_like(x),
        exact=_sin3)


def robin_3d(alpha: float = 1.0) -> Problem3D:
    """-Lap u + u = (3 pi^2 + 1) cos cos cos with Robin x-hi and z-hi faces
    (du/dn = 0 there, so g_natural = alpha u_exact), Dirichlet on the other
    four.  Exact u = cos cos cos."""
    return Problem3D(
        name=f"robin_3d_alpha{alpha:g}",
        f=lambda x, y, z: (3.0 * pi**2 + 1.0) * _cos3(x, y, z),
        g=_cos3, c=1.0,
        bc_faces=("dirichlet", "robin", "dirichlet", "dirichlet",
                  "dirichlet", "robin"),
        g_natural=lambda x, y, z: alpha * _cos3(x, y, z),
        robin_alpha=alpha, exact=_cos3)


_PROBLEMS_3D = {
    "poisson_3d": poisson_3d,
    "poisson_3d_inhomogeneous": poisson_3d_inhomogeneous,
    "helmholtz_3d": helmholtz_3d,
    "advection_diffusion_3d": advection_diffusion_3d,
    "variable_coeff_elliptic_3d": variable_coeff_elliptic_3d,
    "poisson_3d_neumann": poisson_3d_neumann,
    "robin_3d": robin_3d,
}


def get_problem_3d(name: str, **kwargs) -> Problem3D:
    """Registry lookup mirroring ``get_problem_2d`` for the 3D families."""
    try:
        return _PROBLEMS_3D[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown 3D problem {name!r}; available: {sorted(_PROBLEMS_3D)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Solver3DConfig:
    """Solver settings (the same fields as the JAX ``Solver3DConfig``)."""

    nx: int = 8  # elements per dimension
    ny: int = 8
    nz: int = 8
    M: int = 4  # Legendre basis size per dimension (M^3 coefficients)
    gamma: float = 1.0e4  # kept for API parity; the LSE path is gamma-free
    n_colloc: int = 4  # collocation grid per dimension (C^3 PDE rows)
    cg_tol: Optional[float] = None  # None -> 100 * dtype eps (relative)
    cg_maxiter: int = 2000
    precond: str = "auto"  # 'auto' | 'jacobi' | 'mg' | 'shifted'
    backend: str = "auto"  # 'auto' | 'torch' | 'cuda' (enhancement stage)
    formulation: str = "primal"  # 'primal' | 'dual' (the same affine map,
    # derived through the augmented quasi-definite kernel system)
    diagnostics: bool = True
    dtype: Optional[str] = None  # 'float32' | 'float64' | None (= float64)
    fem_dtype: Optional[str] = None  # 'float64' runs the coarse stage in
    # float64 and casts the nodal values back to the run dtype
    coarse: str = "q1"  # 'q1' (O(h^2) nodal) | 'compact' (tensor-Numerov
    # 27-point scheme A u = M f_nodal, O(h^4) nodal: constant coefficients,
    # b == 0, all-Dirichlet faces)
    trace_lift: int = 0  # 0: trilinear FEM element trace.  >= 2:
    # tensor-Lagrange interpolation of each surface point's grid plane with
    # this stencil width (forces the torch enhancement route)

    def __post_init__(self):
        if self.formulation not in ("primal", "dual"):
            raise ValueError(f"unknown formulation: {self.formulation!r}")
        if self.coarse not in ("q1", "compact"):
            raise ValueError(f"unknown coarse scheme: {self.coarse!r}")
        if self.trace_lift == 1 or self.trace_lift < 0:
            raise ValueError("trace_lift must be 0 or >= 2")
        if self.backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown backend: {self.backend!r}")

    def torch_dtype(self) -> torch.dtype:
        """The run dtype; float64 when unset (JAX's default under x64)."""
        return getattr(torch, self.dtype or "float64")


class Solution3D(NamedTuple):
    xs: torch.Tensor  # [nx+1]
    ys: torch.Tensor  # [ny+1]
    zs: torch.Tensor  # [nz+1]
    fem_values: torch.Tensor  # [nz+1, ny+1, nx+1]
    coeffs: torch.Tensor  # [nz, ny, nx, M, M, M]  (kz, ky, kx ordering)
    cg_iters: int
    cg_residual: torch.Tensor
    max_slack: torch.Tensor  # [nz, ny, nx]
    bc_violation: torch.Tensor  # [nz, ny, nx]
    solve_ok: torch.Tensor  # [nz, ny, nx]
    cond_estimate: Optional[torch.Tensor] = None


def _surface_indices(M: int):
    """(iz, iy, ix) indices of the surface points of the M^3 tensor grid,
    lexicographic: M^3 - (M-2)^3 points, the dimension of the trace
    space."""
    return [(iz, iy, ix) for iz in range(M) for iy in range(M)
            for ix in range(M)
            if iz in (0, M - 1) or iy in (0, M - 1) or ix in (0, M - 1)]


def _surface_coords(M: int):
    """Surface points of the M^3 tensor grid on [-1, 1]^3, (tz, ty, tx),
    in ``_surface_indices`` order: [M^3 - (M-2)^3, 3]."""
    tb = np.linspace(-1.0, 1.0, M)
    return np.array([(tb[iz], tb[iy], tb[ix])
                     for iz, iy, ix in _surface_indices(M)])


@functools.lru_cache(maxsize=32)
def _lift_tables_3d(nx: int, ny: int, nz: int, M: int, stencil: int):
    """((idx, w) along x, y, z) of ``_lifted_trace_3d``: ``_lift_weights``
    at the M surface-grid points of each axis, built once a shape (a time
    march lifts the same grid every step; building them is a host loop
    over the elements).  Callers must not write to the arrays."""
    tb = np.linspace(-1.0, 1.0, M)
    return tuple(_lift_weights(n + 1, tb, stencil) for n in (nx, ny, nz))


def _lifted_trace_3d(fem, M: int, nx: int, ny: int, nz: int,
                     stencil: int = 6):
    """[E, S] element surface-trace values from tensor-Lagrange
    interpolation of the nodal grid within each surface point's grid plane
    (z-faces first, then y-, then x- for points on edges and corners); the
    in-plane values come from two successive 1D lifts.  Row order matches
    ``_surface_coords``."""
    dtype, device = fem.dtype, fem.device
    (idxx, wx), (idxy, wy), (idxz, wz) = (
        (torch.as_tensor(idx, device=device),
         torch.as_tensor(w, dtype=dtype, device=device))
        for idx, w in _lift_tables_3d(nx, ny, nz, M, stencil))
    Ax = torch.einsum("bmj,cabj->cabm", wx, fem[:, :, idxx])
    Axy = torch.einsum("amj,cajbn->cabmn", wy, Ax[:, idxy])  # z-face planes
    Axz = torch.einsum("cmj,cjabn->cabmn", wz, Ax[idxz])  # y-face planes
    Ay = torch.einsum("amj,cajb->cabm", wy, fem[:, idxy])
    Ayz = torch.einsum("cmj,cjabn->cabmn", wz, Ay[idxz])  # x-face planes
    lo_hi = (slice(0, -1), slice(1, None))
    cols = []
    for iz, iy, ix in _surface_indices(M):
        if iz in (0, M - 1):
            cols.append(Axy[lo_hi[iz == M - 1], :, :, iy, ix])
        elif iy in (0, M - 1):
            cols.append(Axz[:, lo_hi[iy == M - 1], :, iz, ix])
        else:
            cols.append(Ayz[:, :, lo_hi[ix == M - 1], iz, iy])
    return torch.stack(cols, dim=-1).reshape(nz * ny * nx, -1)


@dataclasses.dataclass(frozen=True)
class VarCoeff3DOperators:
    """Shared host-f64 operator parts for 3D variable diffusion: the
    per-element collocation operator is D_e = -a_e Lap - ax_e Gx - ay_e Gy
    - az_e Gz + Dconst, with the coefficient fields sampled per element."""

    Lap: torch.Tensor  # [C^3, M^3] positive: sx^2 V0V0V2 + sy^2 V0V2V0 + ...
    Gx: torch.Tensor  # [C^3, M^3]  sx V0 (x) V0 (x) V1
    Gy: torch.Tensor  # [C^3, M^3]  sy V0 (x) V1 (x) V0
    Gz: torch.Tensor  # [C^3, M^3]  sz V1 (x) V0 (x) V0
    Dconst: torch.Tensor  # [C^3, M^3]  bx Gx + by Gy + bz Gz + c Mass
    B: torch.Tensor  # [S, M^3] shared trace rows
    Z: torch.Tensor  # [M^3, (M-2)^3] null basis of B
    Pbc: torch.Tensor  # [M^3, S] min-norm particular map

    def to(self, device=None, dtype=None) -> "VarCoeff3DOperators":
        return kkt.bundle_to(self, device, dtype)


def _spacings(problem: Problem3D, cfg: Solver3DConfig):
    x0, x1, y0, y1, z0, z1 = problem.domain
    return (x1 - x0) / cfg.nx, (y1 - y0) / cfg.ny, (z1 - z0) / cfg.nz


def prepare_shared_3d(problem: Problem3D, cfg: Solver3DConfig):
    """Host float64 precompute of the shared 3D operators: the affine map
    (f, bc) -> w by the null-space LSE algebra (``kkt.SharedOperators``);
    for variable coefficients the operator parts and null-space basis
    (``VarCoeff3DOperators``).  Returns (bundle of CPU tensors in the run
    dtype, (t_int, spts) numpy).  Collocation uses interior points only."""
    hx, hy, hz = _spacings(problem, cfg)
    M, C = cfg.M, cfg.n_colloc
    dtype = cfg.torch_dtype()
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)
    sx, sy, sz = 2.0 / hx, 2.0 / hy, 2.0 / hz

    def t3(Az, Ay, Ax):
        # rows (iz, iy, ix) x cols (kz, ky, kx), both row-major
        return np.einsum("zk,yl,xm->zyxklm", Az, Ay, Ax).reshape(
            C * C * C, M * M * M)

    spts = _surface_coords(M)
    Vz_b = legendre.vandermonde_host(spts[:, 0], M)[0]  # [S, M]
    Vy_b = legendre.vandermonde_host(spts[:, 1], M)[0]
    Vx_b = legendre.vandermonde_host(spts[:, 2], M)[0]
    B = np.einsum("pk,pl,pm->pklm", Vz_b, Vy_b, Vx_b).reshape(-1, M * M * M)
    bx, by, bz = problem.b
    if problem.a_var is not None:
        Lap = (sx * sx * t3(V0, V0, V2) + sy * sy * t3(V0, V2, V0)
               + sz * sz * t3(V2, V0, V0))
        Gx = sx * t3(V0, V0, V1)
        Gy = sy * t3(V0, V1, V0)
        Gz = sz * t3(V1, V0, V0)
        Dconst = bx * Gx + by * Gy + bz * Gz + problem.c * t3(V0, V0, V0)
        Z, Pbc = kkt.nullspace_host(B)

        def tt(v):
            return torch.as_tensor(v, dtype=dtype)

        ops = VarCoeff3DOperators(Lap=tt(Lap), Gx=tt(Gx), Gy=tt(Gy),
                                  Gz=tt(Gz), Dconst=tt(Dconst), B=tt(B),
                                  Z=tt(Z), Pbc=tt(Pbc))
        return ops, (t_int, spts)
    Dt = -problem.a0 * (sx * sx * t3(V0, V0, V2) + sy * sy * t3(V0, V2, V0)
                        + sz * sz * t3(V2, V0, V0))
    if bx != 0.0:
        Dt = Dt + bx * sx * t3(V0, V0, V1)
    if by != 0.0:
        Dt = Dt + by * sy * t3(V0, V1, V0)
    if bz != 0.0:
        Dt = Dt + bz * sz * t3(V1, V0, V0)
    if problem.c != 0.0:
        Dt = Dt + problem.c * t3(V0, V0, V0)
    if cfg.formulation == "dual":
        shared = kkt.precompute_shared_dual_host(Dt, B, cfg.gamma, dtype)
    else:
        shared = kkt.precompute_shared_lse_host(Dt, B, dtype)
    return shared, (t_int, spts)


def _varcoeff_mg_levels_3d(problem: Problem3D, hx: float, hy: float,
                           hz: float, dtype, device=None,
                           c_override: float = None):
    """``apply_diag_for_level(lvl, shape)`` factory for
    ``multigrid.make_vcycle_3d`` with variable diffusion: exact per-level
    rediscretisation by re-sampling the coefficient callable at each
    level's own quadrature points."""
    x0d, y0d, z0d = problem.domain[0], problem.domain[2], problem.domain[4]
    bx, by, bz = problem.b
    c_eff = problem.c if c_override is None else c_override
    has_const = c_eff != 0.0 or bx != 0.0 or by != 0.0 or bz != 0.0

    def apply_diag_for_level(lvl, shape):
        s = float(2 ** lvl)
        Sq_l, dxq, dyq, dzq = assembly3d.q1_varcoeff_parts_3d(
            hx * s, hy * s, hz * s)

        def axis(x0, h, n):
            return x0 + h * s * torch.arange(n, dtype=dtype, device=device)

        am = assembly3d.coeff_maps_3d(axis(x0d, hx, shape[2]),
                                      axis(y0d, hy, shape[1]),
                                      axis(z0d, hz, shape[0]),
                                      problem.a_var, dxq, dyq, dzq)
        Kc = None
        if has_const:
            Kc = assembly3d.q1_local_operator_3d(hx * s, hy * s, hz * s, 0.0,
                                                 c_eff, bx, by, bz)

        def apply_l(v):
            y = assembly3d.apply_stiffness_var_3d(v, Sq_l, am)
            if Kc is not None:
                y = y + assembly3d.apply_stiffness_3d(v, Kc)
            return y

        d = assembly3d.stiffness_var_diag_3d(shape, Sq_l, am, dtype)
        if Kc is not None:
            d = d + assembly3d.stiffness_diag_3d(shape, Kc, dtype, device)
        return apply_l, d

    return apply_diag_for_level


def _mass1d_apply(g, h):
    """Consistent P1 mass product along axis 0 (uniform spacing h):
    interior h/6 (g_{i-1} + 4 g_i + g_{i+1}), half-hat ends."""
    core = (g[:-2] + 4.0 * g[1:-1] + g[2:]) * (h / 6.0)
    e0 = ((2.0 * g[0] + g[1]) * (h / 6.0))[None]
    e1 = ((g[-2] + 2.0 * g[-1]) * (h / 6.0))[None]
    return torch.cat([e0, core, e1], dim=0)


def _face_mass_apply(G, h0, h1):
    """Q1 face mass M(h0) (x) M(h1) applied to a [n0, n1] face field."""
    return _mass1d_apply(_mass1d_apply(G, h0).T, h1).T


def _mass1d_diag(n, h, dtype, device):
    d = torch.full((n,), 4.0 * h / 6.0, dtype=dtype, device=device)
    d[0] = d[-1] = 2.0 * h / 6.0
    return d


# Grid slices of the six box faces in bc_faces order (xlo, xhi, ylo, yhi,
# zlo, zhi).
_FACE_SLICES = ((slice(None), slice(None), 0), (slice(None), slice(None), -1),
                (slice(None), 0, slice(None)), (slice(None), -1, slice(None)),
                (0, slice(None), slice(None)), (-1, slice(None), slice(None)))


def _face_add(arr, fc, vals):
    out = arr.clone()
    out[_FACE_SLICES[fc]] += vals
    return out


def fem_solve_3d(problem: Problem3D, cfg: Solver3DConfig, xs, ys, zs):
    """Coarse Q1 nodal values on the hex grid by preconditioned CG (SPD)
    or BiCGStab (advection / indefinite Helmholtz).  Returns
    (u [nz+1, ny+1, nx+1], ``cg.CGResult``)."""
    dtype, device = xs.dtype, xs.device
    hx, hy, hz = (float(h) for h in _spacings(problem, cfg))
    bx, by, bz = problem.b
    var = problem.a_var is not None
    compact = cfg.coarse == "compact"
    if compact:
        if var:
            raise ValueError(
                "coarse='compact' needs constant diffusion (a_var is set); "
                "use coarse='q1'")
        if bx != 0.0 or by != 0.0 or bz != 0.0:
            raise ValueError("coarse='compact' requires b == (0, 0, 0)")
        if any(t != "dirichlet" for t in problem.bc_faces):
            raise ValueError(
                "coarse='compact' requires all-Dirichlet faces (the Numerov "
                "rhs weighting assumes value-pinned boundaries)")

    def local_op(hx_, hy_, hz_, c_):
        """Shared local 8x8 at spacing (hx_, hy_, hz_): the Q1 weak form or
        the tensor-Numerov compact operator (same 27-point sparsity)."""
        if compact:
            return assembly3d.q1_numerov_locals_3d(hx_, hy_, hz_, problem.a0,
                                                   c_)[0]
        return assembly3d.q1_local_operator_3d(hx_, hy_, hz_, problem.a0, c_,
                                               bx, by, bz)

    with _span("fem_solve_3d.assemble"):
        if var:
            # Per-element stiffness K_e = sum_q a(x_q) S_q; constant
            # reaction / advection terms compose additively.
            Sq, dxq, dyq, dzq = assembly3d.q1_varcoeff_parts_3d(hx, hy, hz)
            a_maps = assembly3d.coeff_maps_3d(xs, ys, zs, problem.a_var, dxq,
                                              dyq, dzq)
            K_const = None
            if problem.c != 0.0 or bx != 0.0 or by != 0.0 or bz != 0.0:
                K_const = assembly3d.q1_local_operator_3d(
                    hx, hy, hz, 0.0, problem.c, bx, by, bz)

            def apply_op(v):
                y = assembly3d.apply_stiffness_var_3d(v, Sq, a_maps)
                if K_const is not None:
                    y = y + assembly3d.apply_stiffness_3d(v, K_const)
                return y
        else:
            K_loc = local_op(hx, hy, hz, problem.c)

            def apply_op(v):
                return assembly3d.apply_stiffness_3d(v, K_loc)

        spd = bx == 0.0 and by == 0.0 and bz == 0.0 and problem.c >= 0.0
        X, Y, Z = xs[None, None, :], ys[None, :, None], zs[:, None, None]
        nz1, ny1, nx1 = zs.shape[0], ys.shape[0], xs.shape[0]
        ones = torch.ones((nz1, ny1, nx1), dtype=dtype, device=device)
        if compact:
            # Numerov-weighted load M f_nodal (nodal samples): the pair
            # (A, M f) makes the scheme O(h^4).
            K_M = assembly3d.q1_numerov_locals_3d(hx, hy, hz, problem.a0,
                                                  problem.c)[1]
            b = assembly3d.apply_stiffness_3d(problem.f(X, Y, Z) * ones, K_M)
        else:
            b = assembly3d.assemble_load_3d(xs, ys, zs, problem.f)
        bcs = problem.bc_faces
        mixed = any(t != "dirichlet" for t in bcs)
        robin_faces = []
        # per-face (h0, h1) spacings and node counts of the [n0, n1] face
        face_h = ((hz, hy), (hz, hy), (hz, hx), (hz, hx), (hy, hx), (hy, hx))
        face_n = ((nz1, ny1), (nz1, ny1), (nz1, nx1), (nz1, nx1),
                  (ny1, nx1), (ny1, nx1))
        if not mixed:
            interior = torch.zeros((nz1, ny1, nx1), dtype=torch.bool,
                                   device=device)
            interior[1:-1, 1:-1, 1:-1] = True
        else:
            # Natural faces keep their boundary nodes as unknowns; only
            # Dirichlet faces are eliminated (edges and corners shared with
            # a Dirichlet face are Dirichlet).
            interior = torch.ones((nz1, ny1, nx1), dtype=torch.bool,
                                  device=device)
            for fc, t in enumerate(bcs):
                if t == "dirichlet":
                    interior[_FACE_SLICES[fc]] = False
            # Weak boundary term of -(a0 Lap u) on natural faces:
            # [a0 du/dn] v = (g_natural - robin_alpha u) v over the face.
            face_xyz = (
                (torch.full((nz1, ny1), float(xs[0]), dtype=dtype,
                            device=device), ys[None, :], zs[:, None]),
                (torch.full((nz1, ny1), float(xs[-1]), dtype=dtype,
                            device=device), ys[None, :], zs[:, None]),
                (xs[None, :], torch.full((nz1, nx1), float(ys[0]),
                                         dtype=dtype, device=device),
                 zs[:, None]),
                (xs[None, :], torch.full((nz1, nx1), float(ys[-1]),
                                         dtype=dtype, device=device),
                 zs[:, None]),
                (xs[None, :], ys[:, None],
                 torch.full((ny1, nx1), float(zs[0]), dtype=dtype,
                            device=device)),
                (xs[None, :], ys[:, None],
                 torch.full((ny1, nx1), float(zs[-1]), dtype=dtype,
                            device=device)),
            )
            for fc, t in enumerate(bcs):
                if t == "dirichlet":
                    continue
                gv = problem.g_natural(*face_xyz[fc]) * torch.ones(
                    face_n[fc], dtype=dtype, device=device)
                b = _face_add(b, fc, _face_mass_apply(gv, *face_h[fc]))
                if t == "robin":
                    robin_faces.append(fc)
            if robin_faces:
                alpha = problem.robin_alpha
                base_apply = apply_op

                def apply_op(v):
                    y = base_apply(v)
                    for fc in robin_faces:
                        y = _face_add(y, fc, alpha * _face_mass_apply(
                            v[_FACE_SLICES[fc]], *face_h[fc]))
                    return y
        u_bc = torch.where(interior, 0.0, problem.g(X, Y, Z) * ones)

        def apply_free(v):
            return torch.where(interior, apply_op(v * interior), 0.0)

        rhs = torch.where(interior, b - apply_op(u_bc), 0.0)

    def robin_diag(diag):
        for fc in robin_faces:
            (n0, n1), (h0, h1) = face_n[fc], face_h[fc]
            diag = _face_add(diag, fc, problem.robin_alpha * torch.outer(
                _mass1d_diag(n0, h0, dtype, device),
                _mass1d_diag(n1, h1, dtype, device)))
        return diag

    with _span("fem_solve_3d.precond_setup"):
        from ..ops import multigrid

        precond = cfg.precond
        mg_grid = (cfg.nx % 2 == 0 and cfg.ny % 2 == 0 and cfg.nz % 2 == 0
                   and min(cfg.nx, cfg.ny, cfg.nz) >= 8)
        if mixed:
            if precond == "shifted":
                raise ValueError(
                    "precond='shifted' assumes all-Dirichlet faces; mixed-BC "
                    "problems run with precond='mg'|'jacobi' (or 'auto')")
            mg_ok = mg_grid and problem.c >= 0.0 and not var
            if precond == "auto":
                precond = "mg" if mg_ok else "jacobi"
            if precond == "mg" and not mg_ok:
                raise ValueError(
                    "mixed-BC 'mg' needs even >= 8 grids, c >= 0 and "
                    "constant coefficients; use precond='jacobi'")
        elif precond == "auto":
            if mg_grid:
                precond = "mg" if problem.c >= 0.0 else "shifted"
            else:
                precond = "jacobi"
        if mixed and precond == "mg":
            # Composite preconditioner: the all-Dirichlet V-cycle on the
            # inner subspace + Jacobi on the natural-face unknowns.
            inner = torch.zeros((nz1, ny1, nx1), dtype=torch.bool,
                                device=device)
            inner[1:-1, 1:-1, 1:-1] = True
            diag_m = robin_diag(assembly3d.stiffness_diag_3d(
                (nz1, ny1, nx1), K_loc, dtype, device))
            vcyc = multigrid.make_vcycle_3d(nz1, ny1, nx1, K_loc, dtype,
                                            device=device)
            edge_free = interior & ~inner

            def M_inv(r):
                return (torch.where(inner, vcyc(r * inner), 0.0)
                        + torch.where(edge_free, r / diag_m, 0.0))
        elif precond in ("mg", "shifted"):
            c_eff = abs(problem.c) if precond == "shifted" else problem.c
            if var:
                # Exact rediscretisation per level from the true a_var.
                M_inv = multigrid.make_vcycle_3d(
                    nz1, ny1, nx1, None, dtype, device=device,
                    apply_diag_for_level=_varcoeff_mg_levels_3d(
                        problem, hx, hy, hz, dtype, device,
                        c_override=(abs(problem.c) if precond == "shifted"
                                    else None)))
            else:
                def loc_for_level(lvl):
                    s = float(2 ** lvl)
                    return local_op(hx * s, hy * s, hz * s, c_eff)

                M_inv = multigrid.make_vcycle_3d(
                    nz1, ny1, nx1, loc_for_level(0), dtype, device=device,
                    loc_for_level=loc_for_level)
        elif precond == "jacobi":
            if var:
                diag = assembly3d.stiffness_var_diag_3d((nz1, ny1, nx1), Sq,
                                                        a_maps, dtype)
                if K_const is not None:
                    diag = diag + assembly3d.stiffness_diag_3d(
                        (nz1, ny1, nx1), K_const, dtype, device)
            else:
                diag = assembly3d.stiffness_diag_3d((nz1, ny1, nx1), K_loc,
                                                    dtype, device)
            M_inv = torch.where(interior, 1.0 / robin_diag(diag), 1.0)
        else:
            raise ValueError(f"unknown precond: {precond!r}")
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    solver = cg.cg if spd else cg.bicgstab
    with _span("fem_solve_3d.krylov"):
        res = solver(apply_free, rhs, M_inv=M_inv, tol=tol,
                     maxiter=cfg.cg_maxiter)
    return u_bc + torch.where(interior, res.x, 0.0), res


def _element_data_3d(problem: Problem3D, cfg: Solver3DConfig, xs, ys, zs,
                     fem_values, t_int, spts, trace_lift: int = 0,
                     skip_f: bool = False):
    """Per-element collocation rhs [E, C^3] (interior points) and
    boundary-trace values [E, S]: the trilinear FEM trace at the surface
    points, overridden by g on the Dirichlet faces of the domain (natural
    faces keep the FEM trace); ``trace_lift >= 2`` replaces the trilinear
    trace with the plane lift (``_lifted_trace_3d``).  Also returns the
    eight corner-value views.  ``skip_f=True`` skips the collocation rows
    (returned as None) for trace-only callers such as the time marches."""
    dtype, device = xs.dtype, xs.device
    C = cfg.n_colloc
    nx, ny, nz = xs.shape[0] - 1, ys.shape[0] - 1, zs.shape[0] - 1
    E = nx * ny * nz
    t = torch.tensor(np.asarray(t_int), dtype=dtype, device=device)
    hx, hy, hz = xs[1:] - xs[:-1], ys[1:] - ys[:-1], zs[1:] - zs[:-1]
    xq = xs[:-1][:, None] + 0.5 * hx[:, None] * (t[None, :] + 1.0)
    yq = ys[:-1][:, None] + 0.5 * hy[:, None] * (t[None, :] + 1.0)
    zq = zs[:-1][:, None] + 0.5 * hz[:, None] * (t[None, :] + 1.0)
    # f on [nz, ny, nx, Cz, Cy, Cx]: rows (iz, iy, ix), columns (cz, cy, cx),
    # both row-major, as prepare_shared_3d's t3.
    if skip_f:
        f_rows = None
    else:
        F = problem.f(xq[None, None, :, None, None, :],
                      yq[None, :, None, None, :, None],
                      zq[:, None, None, :, None, None])
        F = F * torch.ones((nz, ny, nx, C, C, C), dtype=dtype,
                           device=device)
        f_rows = F.reshape(E, C * C * C)

    cs = assembly3d._corners_3d(fem_values)  # a = 4cz + 2cy + cx
    sp = torch.tensor(np.asarray(spts), dtype=dtype, device=device)
    tzp, typ, txp = sp[:, 0], sp[:, 1], sp[:, 2]
    if trace_lift >= 2:
        trace = _lifted_trace_3d(fem_values, cfg.M, nx, ny, nz,
                                 stencil=trace_lift).reshape(nz, ny, nx, -1)
    else:
        w1, w2, w3 = (1 - txp, 1 + txp), (1 - typ, 1 + typ), (1 - tzp,
                                                               1 + tzp)
        trace = 0.0
        a = 0
        for cz in range(2):
            for cy in range(2):
                for cx in range(2):
                    N = 0.125 * w3[cz] * w2[cy] * w1[cx]  # [S]
                    trace = trace + cs[a][..., None] * N
                    a += 1
    # Domain-boundary override: surface points on Dirichlet faces of
    # boundary elements take g exactly.
    ex = torch.arange(nx, device=device)
    ey = torch.arange(ny, device=device)
    ez = torch.arange(nz, device=device)
    xm, ym, zm = (0.5 * (v[1:] + v[:-1]) for v in (xs, ys, zs))
    xp = (xm[:, None] + 0.5 * hx[:, None] * txp[None, :])[None, None, :, :]
    yp = (ym[:, None] + 0.5 * hy[:, None] * typ[None, :])[None, :, None, :]
    zp = (zm[:, None] + 0.5 * hz[:, None] * tzp[None, :])[:, None, None, :]
    on_face = (
        (ex[None, None, :, None] == 0) & (txp == -1.0),
        (ex[None, None, :, None] == cfg.nx - 1) & (txp == 1.0),
        (ey[None, :, None, None] == 0) & (typ == -1.0),
        (ey[None, :, None, None] == cfg.ny - 1) & (typ == 1.0),
        (ez[:, None, None, None] == 0) & (tzp == -1.0),
        (ez[:, None, None, None] == cfg.nz - 1) & (tzp == 1.0),
    )
    on_bdry = functools.reduce(
        torch.logical_or,
        [m for m, t in zip(on_face, problem.bc_faces) if t == "dirichlet"],
        torch.zeros((1, 1, 1, 1), dtype=torch.bool, device=device))
    # g broadcasts against the trace in the where: a [nz, ny, nx, S] grid
    # of ones would add two ~1 GB passes at 128^3 in float64.
    bc_rows = torch.where(on_bdry, problem.g(xp, yp, zp), trace)
    return f_rows, bc_rows.reshape(E, -1), cs


def _kernel_solve_ok_3d(slack, bcv, corners):
    """Per-element acceptance gate after the fused kernel (JAX
    ``_pallas_solve_ok_3d``): the tolerance scales with the boundary-data
    magnitude (the eight corner values bound the trilinear trace), never
    with the violation itself."""
    finite = torch.isfinite(slack) & torch.isfinite(bcv)
    mags = [torch.abs(c).reshape(bcv.shape) for c in corners]
    scale = 1.0 + functools.reduce(torch.maximum, mags)
    return finite & (bcv <= 1e-2 * scale)


def _varcoeff_element_operators_3d(problem: Problem3D, cfg: Solver3DConfig,
                                   xs, ys, zs, vb: VarCoeff3DOperators,
                                   t_int):
    """Batched per-element collocation operators D [E, C^3, M^3]: the
    coefficient fields (a, da/dx, da/dy, da/dz) sampled at each element's
    collocation grid against the shared host-f64 parts; grad_a by
    ``torch.autograd`` when the problem has none."""
    dtype, device = xs.dtype, xs.device
    nx, ny, nz = xs.shape[0] - 1, ys.shape[0] - 1, zs.shape[0] - 1
    E = nx * ny * nz
    C = cfg.n_colloc
    t = torch.tensor(np.asarray(t_int), dtype=dtype, device=device)
    hx, hy, hz = xs[1:] - xs[:-1], ys[1:] - ys[:-1], zs[1:] - zs[:-1]
    xq = xs[:-1][:, None] + 0.5 * hx[:, None] * (t[None, :] + 1.0)
    yq = ys[:-1][:, None] + 0.5 * hy[:, None] * (t[None, :] + 1.0)
    zq = zs[:-1][:, None] + 0.5 * hz[:, None] * (t[None, :] + 1.0)
    ones = torch.ones((nz, ny, nx, C, C, C), dtype=dtype, device=device)
    Xq = xq[None, None, :, None, None, :] * ones
    Yq = yq[None, :, None, None, :, None] * ones
    Zq = zq[:, None, None, :, None, None] * ones

    def samp(fn):
        return (fn(Xq, Yq, Zq) * ones).reshape(E, C * C * C)

    a_e = samp(problem.a_var)
    if problem.grad_a is not None:
        ax_e, ay_e, az_e = (samp(fn) for fn in problem.grad_a)
    else:  # the chain-rule coefficients by autograd
        with torch.enable_grad():
            pts = [v.clone().requires_grad_(True) for v in (Xq, Yq, Zq)]
            total = (problem.a_var(*pts) * ones).sum()
            grads = torch.autograd.grad(total, pts, allow_unused=True)
        ax_e, ay_e, az_e = (
            (torch.zeros_like(Xq) if gv is None else gv).reshape(E, -1)
            for gv in grads)
    return (-a_e[..., None] * vb.Lap - ax_e[..., None] * vb.Gx
            - ay_e[..., None] * vb.Gy - az_e[..., None] * vb.Gz + vb.Dconst)


def _trilinear_fallback_coeffs(cs, M):
    """Tensor-Legendre coefficients of the Q1 trilinear interpolant (the 3D
    analog of the linear fallback).  Corner order a = 4cz + 2cy + cx.  With
    P0 = 1 and P1 = t, u = sum_a u_a prod_axis (1 + s_axis t_axis) / 2
    (s = -1 or +1) has nonzero coefficients only at degrees (kz, ky, kx) in
    {0, 1}^3: u_a / 8 times the product of the signs of the degree-1
    axes."""
    nz, ny, nx = cs[0].shape
    sign = [[-1.0, 1.0][(a >> shift) & 1] for shift in (2, 1, 0)
            for a in range(8)]
    S = torch.tensor(
        [[(sign[a] if kz else 1.0) * (sign[8 + a] if ky else 1.0)
          * (sign[16 + a] if kx else 1.0) * 0.125 for a in range(8)]
         for kz in range(2) for ky in range(2) for kx in range(2)],
        dtype=cs[0].dtype, device=cs[0].device)  # [degrees, corners]
    low = torch.einsum("da,azyx->zyxd", S, torch.stack(cs))
    c = torch.zeros((nz, ny, nx, M, M, M), dtype=cs[0].dtype,
                    device=cs[0].device)
    c[..., :2, :2, :2] = low.reshape(nz, ny, nx, 2, 2, 2)
    return c


def _resolve_backend(problem: Problem3D, cfg: Solver3DConfig, device,
                     forced_torch: bool = False) -> str:
    """The enhancement route: 'cuda' (the fused kernel) or 'torch'.

    'auto' takes the kernel for CUDA float32 tensors with constant
    coefficients, unless a lifted trace or ``bc_rows_override`` forces
    'torch'; an (M, n_colloc) the kernel was not compiled for then raises
    rather than running torch on the card.  Variable coefficients have no
    kernel and run on 'torch' whatever the config says."""
    if forced_torch or problem.a_var is not None:
        return "torch"
    device = torch.device(device)
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    if cfg.backend != "auto":
        return cfg.backend
    if device.type == "cuda" and cfg.torch_dtype() == torch.float32:
        return "cuda"
    return "torch"


def enhance_3d(problem: Problem3D, cfg: Solver3DConfig, xs, ys, zs,
               fem_values, shared_bundle, bc_rows_override=None):
    """Enhancement stage in isolation: per-element tensor-Legendre fit of
    the operator against arbitrary nodal trace data (the second half of
    ``hybrid_solve_3d``).  Returns (coeffs [nz, ny, nx, M, M, M],
    KKTDiagnostics, cond).

    ``bc_rows_override``: [E, S] surface-trace values replacing the FEM
    trilinear trace; forces the torch route, as ``cfg.trace_lift >= 2``
    does."""
    shared, (t_int, spts) = shared_bundle
    E = cfg.nx * cfg.ny * cfg.nz
    use_lift = bc_rows_override is None and cfg.trace_lift >= 2
    backend = _resolve_backend(
        problem, cfg, fem_values.device,
        forced_torch=bc_rows_override is not None or use_lift)
    if backend == "cuda":
        hx, hy, hz = _spacings(problem, cfg)
        x0, y0, z0 = problem.domain[0], problem.domain[2], problem.domain[4]
        w, slack, bcv = kernels3d.fused_enhance_stacked_3d(
            fem_values, shared, problem.f, problem.g,
            (x0, hx, y0, hy, z0, hz), cfg.nx, cfg.ny, cfg.nz, t_int, spts,
            with_diagnostics=cfg.diagnostics, f_shifted_fn=problem.f_shifted)
        cs = assembly3d._corners_3d(fem_values)
        if cfg.diagnostics:
            diags = kkt.KKTDiagnostics(slack, bcv,
                                       _kernel_solve_ok_3d(slack, bcv, cs))
        else:
            z = torch.zeros(E, dtype=w.dtype, device=w.device)
            diags = kkt.KKTDiagnostics(z, z,
                                       torch.all(torch.isfinite(w), dim=-1))
    else:
        f_rows, bc_rows, cs = _element_data_3d(
            problem, cfg, xs, ys, zs, fem_values, t_int, spts,
            trace_lift=cfg.trace_lift if use_lift else 0)
        if bc_rows_override is not None:
            bc_rows = bc_rows_override
        if problem.a_var is not None:
            D = _varcoeff_element_operators_3d(problem, cfg, xs, ys, zs,
                                               shared, t_int)
            w, diags = kkt.solve_batched(
                D, shared.B, f_rows, bc_rows, cfg.gamma,
                formulation=cfg.formulation, ZP=(shared.Z, shared.Pbc))
        else:
            w, diags = kkt.solve_primal_shared(shared, f_rows, bc_rows)
    M = cfg.M
    shp = (cfg.nz, cfg.ny, cfg.nx)
    coeffs = w.reshape(*shp, M, M, M)
    fb = _trilinear_fallback_coeffs(cs, M)
    ok = diags.solve_ok.reshape(shp)
    coeffs = torch.where(ok[..., None, None, None],
                         torch.where(torch.isfinite(coeffs), coeffs, 0.0), fb)
    cond = diags.cond_estimate if problem.a_var is not None else shared.cond
    return coeffs, kkt.KKTDiagnostics(diags.max_slack, diags.bc_violation,
                                      ok.reshape(-1)), cond


def hybrid_solve_3d(problem: Problem3D, cfg: Solver3DConfig, shared_bundle,
                    device=None) -> Solution3D:
    """Coarse Q1 solve then the batched enhancement, on ``device`` (None:
    the GPU; a machine without one raises — pass ``device='cpu'``).  The
    operator bundle of ``prepare_shared_3d`` is moved there first."""
    device = resolve_device(device)
    shared, pts = shared_bundle
    shared_bundle = (shared.to(device), pts)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1, z0, z1 = problem.domain
    xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)
    zs = torch.linspace(z0, z1, cfg.nz + 1, dtype=dtype, device=device)
    if cfg.fem_dtype is not None:
        fd = getattr(torch, cfg.fem_dtype)
        fem_values, cg_res = fem_solve_3d(problem, cfg, xs.to(fd), ys.to(fd),
                                          zs.to(fd))
        fem_values = fem_values.to(dtype)
    else:
        fem_values, cg_res = fem_solve_3d(problem, cfg, xs, ys, zs)
    with _span("enhance_3d"):
        coeffs, diags, cond = enhance_3d(problem, cfg, xs, ys, zs,
                                         fem_values, shared_bundle)
    shp = (cfg.nz, cfg.ny, cfg.nx)
    return Solution3D(
        xs=xs, ys=ys, zs=zs, fem_values=fem_values, coeffs=coeffs,
        cg_iters=cg_res.iters, cg_residual=cg_res.residual,
        max_slack=diags.max_slack.reshape(shp),
        bc_violation=diags.bc_violation.reshape(shp),
        solve_ok=diags.solve_ok.reshape(shp), cond_estimate=cond)


def _locate_3d(sol: Solution3D, x, y, z):
    out = []
    for nodes, p in ((sol.xs, x), (sol.ys, y), (sol.zs, z)):
        n = nodes.shape[0] - 1
        h = nodes[1] - nodes[0]
        i = torch.clamp(torch.floor((p - nodes[0]) / h).to(torch.int64), 0,
                        n - 1)
        out.append((i, (2.0 * p - nodes[i] - nodes[i + 1]) / h, h))
    return out


def evaluate_3d(sol: Solution3D, x, y, z):
    """u(x, y, z) at query points [P]: O(1) uniform-grid lookup and a
    batched tensor-Legendre contraction; points outside the domain are
    evaluated in the nearest element."""
    (ix, tx, _), (iy, ty, _), (iz, tz, _) = _locate_3d(sol, x, y, z)
    M = sol.coeffs.shape[-1]
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)  # [P, M]
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    (Vz,) = legendre.legendre_vandermonde(tz, M, num_derivs=0)
    W = sol.coeffs[iz, iy, ix]  # [P, M(kz), M(ky), M(kx)]
    return torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy, Vx)


def evaluate_3d_gradient(sol: Solution3D, x, y, z):
    """(du/dx, du/dy, du/dz) at query points [P]: derivative Vandermonde
    per axis with chain factors 2/h."""
    (ix, tx, hx), (iy, ty, hy), (iz, tz, hz) = _locate_3d(sol, x, y, z)
    M = sol.coeffs.shape[-1]
    Vx, Vx1 = legendre.legendre_vandermonde(tx, M, num_derivs=1)
    Vy, Vy1 = legendre.legendre_vandermonde(ty, M, num_derivs=1)
    Vz, Vz1 = legendre.legendre_vandermonde(tz, M, num_derivs=1)
    W = sol.coeffs[iz, iy, ix]
    ux = (2.0 / hx) * torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy, Vx1)
    uy = (2.0 / hy) * torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy1, Vx)
    uz = (2.0 / hz) * torch.einsum("pk,pklm,pl,pm->p", Vz1, W, Vy, Vx)
    return ux, uy, uz


class HybridSolver3D:
    """Facade mirroring the 1D / 2D API for structured-hex 3D problems.

    ``device`` is where the solve runs: the GPU by default (a machine
    without one raises), the CPU only on ``device='cpu'``.  The host
    precompute of the operators happens once, at construction."""

    def __init__(self, problem: Problem3D,
                 config: Solver3DConfig = Solver3DConfig(), device=None):
        self.problem = problem
        self.config = config
        self.device = resolve_device(device)
        with _span("prepare_shared_3d"):
            shared, pts = prepare_shared_3d(problem, config)
            self._shared = (shared.to(self.device), pts)
        self.solution: Optional[Solution3D] = None

    def solve(self) -> Solution3D:
        self.solution = hybrid_solve_3d(self.problem, self.config,
                                        self._shared, device=self.device)
        return self.solution

    def _points(self, *coords):
        if self.solution is None:
            raise RuntimeError("call solve() first")
        dtype = self.solution.xs.dtype
        return tuple(torch.as_tensor(c, dtype=dtype, device=self.device)
                     for c in coords)

    def evaluate_solution(self, x, y, z):
        pts = self._points(x, y, z)
        with _span("evaluate_3d"):
            return evaluate_3d(self.solution, *pts)

    def evaluate_gradient(self, x, y, z):
        return evaluate_3d_gradient(self.solution, *self._points(x, y, z))

    def errors(self, x, y, z):
        """(linf, l2) of the hybrid solution against the exact oracle."""
        from ..utils import metrics

        u = self.evaluate_solution(x, y, z)
        ue = self.problem.exact(*self._points(x, y, z))
        return metrics.linf_error(u, ue), metrics.l2_error(u, ue)
