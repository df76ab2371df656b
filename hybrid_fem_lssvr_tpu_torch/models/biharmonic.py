"""Fourth-order (biharmonic) problems by hybrid-solver composition, and the
clamped beam and plate.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/biharmonic.py``.

Simply supported (1D :28-80, 2D :99-152, 3D :168-228): u'''' = f with
u = u'' = 0 (Lap^2 u = f with u = Lap u = 0 on a rectangle or a box)
splits exactly into two Poisson solves: v = u'' (Lap u) solves -v'' = -f
with v = 0 on the boundary, then -u'' = -v with u = 0.  The second solve's
rhs is the ENHANCED v, read pointwise from the first solve's element
polynomials, so u rides the hybrid floor of the v-solve instead of an
O(h^2) rhs-interpolation floor.  Both stages are ordinary
``HybridSolver`` / ``HybridSolver2D`` / ``HybridSolver3D`` solves, so on a
CUDA float32 run each stage goes through the enhancement kernels.

Dropped from the JAX package: the u-stage's forced ``backend="xla"``
(:150, :226).  It exists because a traced ``searchsorted`` evaluation
cannot run inside the fused Pallas kernels (:91-93); the port's kernel
wrappers sample the rhs callable with torch before the launch, so the
u-stage keeps ``cfg.backend`` like the v-stage.

Clamped beam (:231-443): u'''' = f with u = g, u' = gp at both ends, by a
C^1 Hermite-cubic coarse stage (two dofs a node, block-tridiagonal 2x2
system, ``ops.tridiag.block_thomas_2x2``) and the shared null-space LSE
enhancement with a fourth-derivative collocation operator and four
boundary rows an element (values and slopes at both ends).

Clamped plate (:446-824): Lap^2 u = f, u = du/dn = 0 on a rectangle, by a
Bogner-Fox-Schmit coarse stage (bicubic Hermite, four dofs a node: u,
u_x, u_y, u_xy; matrix-free Jacobi-CG on the plate form
K16 = S2x (x) S0y + 2 S1x (x) S1y + S0x (x) S2y) and the shared LSE
enhancement against the C^1 element traces (values at the 4M-4 boundary
points plus normal slopes at M points an edge; the trace rows are rank
deficient by construction, so the precompute takes the SVD route).  The
element fit is two matmuls (``kkt.solve_primal_shared``), as the JAX
package computes it with XLA outside any Pallas kernel.

Both clamped solvers refuse float32 with the JAX package's ValueError: the
(2/h)^4 scaling and the h^-4 conditioning of the Hermite stiffness are
beyond float32.  Entry points run on the GPU unless given
``device='cpu'``; the stages run inside the ``torch.profiler`` spans named
in ``SPANS``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import numpy.polynomial.legendre as NL
import torch

from ..ops import cg as cgmod
from ..ops import eval as ops_eval
from ..ops import kkt, legendre, tridiag
from ..utils.device import resolve as resolve_device
from .hybrid import HybridSolver, Solution, SolverConfig
from .hybrid2d import (HybridSolver2D, Problem2D, Solution2D, Solver2DConfig,
                       _boundary_coords, evaluate_2d)
from .hybrid3d import (HybridSolver3D, Problem3D, Solution3D, Solver3DConfig,
                       evaluate_3d)
from .problem import Problem1D

pi = math.pi
_span = torch.profiler.record_function
SPANS = ("solve_biharmonic.v_stage", "solve_biharmonic.u_stage",
         "hermite_fem_solve_1d", "bfs_fem_solve_2d")

# Points a u-stage rhs evaluation reads at once: the gather of a [P, M^d]
# coefficient block is its largest temporary (at 128^3 hexes, M = C = 4,
# the kernel samples 134M points: 34 GB in float32 at once).  Each point is
# evaluated alone, so the chunking changes no number.
READ_CHUNK = 1 << 22


def _negated_reader(read, fields):
    """The u-stage rhs x -> -v_h(x) (one argument a coordinate).

    ``fields`` are the v-stage solution's tensors and ``read(fields, *flat
    coordinates)`` evaluates it at flat points.  The fields are cast once
    to the points' dtype (float64 when ``fem_dtype='float64'`` runs the
    coarse stage), as JAX promotes them; the points broadcast as the
    callable's caller passes them, and are evaluated READ_CHUNK at a
    time."""
    cast = {}

    def rhs(*coords):
        shp = torch.broadcast_shapes(*(c.shape for c in coords))
        dtype = functools.reduce(torch.promote_types,
                                 [c.dtype for c in coords], fields[-1].dtype)
        if dtype not in cast:
            cast[dtype] = [t.to(dtype) for t in fields]
        flat = [c.to(dtype).expand(shp).reshape(-1) for c in coords]
        n = flat[0].shape[0]
        parts = [read(cast[dtype], *(c[i:i + READ_CHUNK] for c in flat))
                 for i in range(0, n, READ_CHUNK)]
        out = torch.cat(parts) if parts else flat[0]
        return -out.reshape(shp)

    return rhs


# --------------------------------------------------------------------- 1D


@dataclasses.dataclass(frozen=True)
class BiharmonicProblem1D:
    """u'''' = f, simply supported (u = u'' = 0 at both ends)."""

    name: str
    f: Callable
    domain: tuple = (-1.0, 1.0)
    exact: Optional[Callable] = None
    exact_d2: Optional[Callable] = None  # u'' (the v-solve oracle)


def sin_biharmonic_1d() -> BiharmonicProblem1D:
    """u'''' = pi^4 sin(pi x), exact u = sin(pi x)."""
    return BiharmonicProblem1D(
        name="sin_biharmonic_1d",
        f=lambda x: pi ** 4 * torch.sin(pi * x),
        exact=lambda x: torch.sin(pi * x),
        exact_d2=lambda x: -pi ** 2 * torch.sin(pi * x),
    )


class BiharmonicSolution(NamedTuple):
    u: Solution  # displacement hybrid solution
    v: Solution  # moment (u'') hybrid solution


def solve_biharmonic_1d(problem: BiharmonicProblem1D, cfg: SolverConfig,
                        device=None) -> BiharmonicSolution:
    """Two chained hybrid solves (module docstring); evaluate the
    displacement with ``ops.eval.evaluate(sol.u.nodes, sol.u.coeffs, x)``
    and the moment from ``sol.v`` likewise (JAX :54-80)."""
    device = resolve_device(device)
    f = problem.f
    pv = Problem1D(
        name=f"{problem.name}:moment",
        f=lambda x: -f(x),
        domain=problem.domain,
        exact=problem.exact_d2,
    )
    with _span("solve_biharmonic.v_stage"):
        sol_v = HybridSolver(pv, cfg, device=device).solve()
    pu = Problem1D(
        name=f"{problem.name}:displacement",
        # rhs = -v_h read from the enhanced polynomials (searchsorted +
        # Legendre evaluation: spectral, not a nodal interpolant)
        f=_negated_reader(lambda fs, x: ops_eval.evaluate(fs[0], fs[1], x),
                          (sol_v.nodes, sol_v.coeffs)),
        domain=problem.domain,
        exact=problem.exact,
    )
    with _span("solve_biharmonic.u_stage"):
        sol_u = HybridSolver(pu, cfg, device=device).solve()
    return BiharmonicSolution(u=sol_u, v=sol_v)


# --------------------------------------------------------------------- 2D
#
# Simply-supported plate: Lap^2 u = f on a rectangle with u = Lap u = 0
# splits the same way (v = Lap u: -Lap v = -f, v = 0; then -Lap u = -v).
# With Solver2DConfig(coarse="compact", trace_lift=6) both stages run at
# O(h^4) (and on the torch route: a lifted trace forces it).


@dataclasses.dataclass(frozen=True)
class BiharmonicProblem2D:
    """Lap^2 u = f, simply supported (u = Lap u = 0 on the boundary)."""

    name: str
    f: Callable
    domain: tuple = (-1.0, 1.0, -1.0, 1.0)
    exact: Optional[Callable] = None
    exact_lap: Optional[Callable] = None


def sin_biharmonic_2d() -> BiharmonicProblem2D:
    """Lap^2 u = 4 pi^4 sin sin, exact u = sin(pi x) sin(pi y)."""
    def ss(x, y):
        return torch.sin(pi * x) * torch.sin(pi * y)

    return BiharmonicProblem2D(
        name="sin_biharmonic_2d",
        f=lambda x, y: 4.0 * pi ** 4 * ss(x, y),
        exact=ss,
        exact_lap=lambda x, y: -2.0 * pi ** 2 * ss(x, y),
    )


class BiharmonicSolution2D(NamedTuple):
    u: Solution2D
    v: Solution2D


def _zero2(x, y):
    return torch.zeros_like(x + y)


def solve_biharmonic_2d(problem: BiharmonicProblem2D, cfg: Solver2DConfig,
                        device=None) -> BiharmonicSolution2D:
    """Two chained 2D hybrid solves (section comment above; JAX
    :127-152); the u-stage keeps ``cfg.backend`` (module docstring)."""
    device = resolve_device(device)
    f = problem.f
    pv = Problem2D(
        name=f"{problem.name}:moment",
        f=lambda x, y: -f(x, y),
        g=_zero2,
        domain=problem.domain,
        exact=problem.exact_lap,
    )
    with _span("solve_biharmonic.v_stage"):
        sol_v = HybridSolver2D(pv, cfg, device=device).solve()

    def read(fs, x, y):
        return evaluate_2d(sol_v._replace(xs=fs[0], ys=fs[1], coeffs=fs[2]),
                           x, y)

    pu = Problem2D(
        name=f"{problem.name}:displacement",
        f=_negated_reader(read, (sol_v.xs, sol_v.ys, sol_v.coeffs)),
        g=_zero2,
        domain=problem.domain,
        exact=problem.exact,
    )
    with _span("solve_biharmonic.u_stage"):
        sol_u = HybridSolver2D(pu, cfg, device=device).solve()
    return BiharmonicSolution2D(u=sol_u, v=sol_v)


# --------------------------------------------------------------------- 3D
#
# The same splitting on a box (simply supported: u = Lap u = 0); with
# Solver3DConfig(coarse="compact", trace_lift=6) both stages run at O(h^4).


@dataclasses.dataclass(frozen=True)
class BiharmonicProblem3D:
    """Lap^2 u = f on a box, simply supported (u = Lap u = 0)."""

    name: str
    f: Callable
    domain: tuple = (-1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    exact: Optional[Callable] = None
    exact_lap: Optional[Callable] = None


def sin_biharmonic_3d() -> BiharmonicProblem3D:
    """Lap^2 u = 9 pi^4 sin sin sin, exact u = prod sin(pi .)."""
    def sss(x, y, z):
        return torch.sin(pi * x) * torch.sin(pi * y) * torch.sin(pi * z)

    return BiharmonicProblem3D(
        name="sin_biharmonic_3d",
        f=lambda x, y, z: 9.0 * pi ** 4 * sss(x, y, z),
        exact=sss,
        exact_lap=lambda x, y, z: -3.0 * pi ** 2 * sss(x, y, z),
    )


class BiharmonicSolution3D(NamedTuple):
    u: Solution3D
    v: Solution3D


def _zero3(x, y, z):
    return torch.zeros_like(x + y + z)


def solve_biharmonic_3d(problem: BiharmonicProblem3D, cfg: Solver3DConfig,
                        device=None) -> BiharmonicSolution3D:
    """Two chained 3D hybrid solves (section comment above; JAX
    :197-228); the u-stage keeps ``cfg.backend`` (module docstring)."""
    device = resolve_device(device)
    f = problem.f
    pv = Problem3D(
        name=f"{problem.name}:moment",
        f=lambda x, y, z: -f(x, y, z),
        g=_zero3,
        domain=problem.domain,
        exact=problem.exact_lap,
    )
    with _span("solve_biharmonic.v_stage"):
        sol_v = HybridSolver3D(pv, cfg, device=device).solve()

    def read(fs, x, y, z):
        return evaluate_3d(sol_v._replace(xs=fs[0], ys=fs[1], zs=fs[2],
                                          coeffs=fs[3]), x, y, z)

    pu = Problem3D(
        name=f"{problem.name}:displacement",
        f=_negated_reader(read, (sol_v.xs, sol_v.ys, sol_v.zs,
                                 sol_v.coeffs)),
        g=_zero3,
        domain=problem.domain,
        exact=problem.exact,
    )
    with _span("solve_biharmonic.u_stage"):
        sol_u = HybridSolver3D(pu, cfg, device=device).solve()
    return BiharmonicSolution3D(u=sol_u, v=sol_v)


# ------------------------------------------------------------- clamped 1D
#
# The splitting cannot represent the clamped beam u = u' = 0.  The clamped
# solver is direct: a C^1 Hermite-cubic coarse stage, whose nodal values
# and slopes are exact (the beam's nodal Green's function is itself a C^1
# cubic), then the null-space LSE enhancement with D = (2/h)^4 V4 and four
# boundary rows an element.  The error is pure collocation-fit truncation,
# spectral in M.


@dataclasses.dataclass(frozen=True)
class ClampedBiharmonicProblem1D:
    """u'''' = f on (x0, x1), clamped: u = g, u' = gp at both ends."""

    name: str
    f: Callable
    g: tuple = (0.0, 0.0)  # (u(x0), u(x1))
    gp: tuple = (0.0, 0.0)  # (u'(x0), u'(x1))
    domain: tuple = (-1.0, 1.0)
    exact: Optional[Callable] = None
    exact_d1: Optional[Callable] = None


def clamped_sin2_1d() -> ClampedBiharmonicProblem1D:
    """u = sin^2(pi x) = (1 - cos(2 pi x))/2: homogeneous clamped data
    (u = u' = 0 at both ends of [-1, 1]); u'''' = -(2 pi)^4 cos(2 pi x)/2."""
    return ClampedBiharmonicProblem1D(
        name="clamped_sin2_1d",
        f=lambda x: -0.5 * (2 * pi) ** 4 * torch.cos(2 * pi * x),
        exact=lambda x: torch.sin(pi * x) ** 2,
        exact_d1=lambda x: pi * torch.sin(2 * pi * x),
    )


def clamped_sin_slope_1d() -> ClampedBiharmonicProblem1D:
    """u = sin(pi x): zero end values but nonzero end slopes
    (u'(+-1) = -pi), which exercises the inhomogeneous gp rows."""
    return ClampedBiharmonicProblem1D(
        name="clamped_sin_slope_1d",
        f=lambda x: pi ** 4 * torch.sin(pi * x),
        g=(0.0, 0.0),
        gp=(float(-np.pi), float(-np.pi)),
        exact=lambda x: torch.sin(pi * x),
        exact_d1=lambda x: pi * torch.cos(pi * x),
    )


def _hermite_blocks(h: float):
    """Host-f64 Euler-Bernoulli element blocks: K_e = int H_a'' H_b'' on a
    length-h element, dof order (u_l, u'_l, u_r, u'_r); partitioned into
    (A, B, C) with A = K[:2, :2], B = K[:2, 2:], C = K[2:, 2:]."""
    K = np.array([
        [12.0, 6.0 * h, -12.0, 6.0 * h],
        [6.0 * h, 4.0 * h * h, -6.0 * h, 2.0 * h * h],
        [-12.0, -6.0 * h, 12.0, -6.0 * h],
        [6.0 * h, 2.0 * h * h, -6.0 * h, 4.0 * h * h],
    ]) / h ** 3
    return K[:2, :2], K[:2, 2:], K[2:, 2:]


def _hermite_load(problem, nodes, n_gauss: int = 6):
    """Per-node consistent load [N+1, 2] by Gauss quadrature of the four
    cubic Hermite shape functions against f (JAX :313-338)."""
    dtype, device = nodes.dtype, nodes.device
    tg, wg = np.polynomial.legendre.leggauss(n_gauss)
    xi = 0.5 * (tg + 1.0)  # [0, 1] element coordinate
    H1 = 1.0 - 3.0 * xi ** 2 + 2.0 * xi ** 3
    H2 = xi - 2.0 * xi ** 2 + xi ** 3  # times h below
    H3 = 3.0 * xi ** 2 - 2.0 * xi ** 3
    H4 = -xi ** 2 + xi ** 3  # times h

    def row(v):
        return torch.as_tensor(v, dtype=dtype, device=device)[None, :]

    xl, xr = nodes[:-1], nodes[1:]
    h = (xr - xl)[:, None]  # [E, 1]
    xq = xl[:, None] + h * row(xi)
    fq = problem.f(xq) * torch.ones_like(xq)  # [E, G]
    wj = row(wg) * (0.5 * h)
    Hs = [row(v) for v in (H1, H2, H3, H4)]
    le = torch.stack([
        torch.sum(wj * fq * Hs[0], dim=1),
        torch.sum(wj * fq * Hs[1] * h, dim=1),
        torch.sum(wj * fq * Hs[2], dim=1),
        torch.sum(wj * fq * Hs[3] * h, dim=1),
    ], dim=-1)  # [E, 4]
    load = torch.zeros((nodes.shape[0], 2), dtype=dtype, device=device)
    load[:-1] += le[:, :2]
    load[1:] += le[:, 2:]
    return load


def hermite_fem_solve_1d(problem: ClampedBiharmonicProblem1D, nodes):
    """C^1 Hermite-cubic coarse stage: (u, u') nodal arrays [N+1] each
    (JAX :341-367).

    Uniform mesh assumed (shared element blocks); the clamped dofs at both
    ends are eliminated exactly (moved to the rhs)."""
    dtype, device = nodes.dtype, nodes.device
    n_int = nodes.shape[0] - 2  # interior nodes carry (u, u') unknowns
    A, B, C = (torch.as_tensor(v, dtype=dtype, device=device)
               for v in _hermite_blocks(float(nodes[1] - nodes[0])))
    load = _hermite_load(problem, nodes)
    q0 = torch.tensor([problem.g[0], problem.gp[0]], dtype=dtype,
                      device=device)
    qN = torch.tensor([problem.g[1], problem.gp[1]], dtype=dtype,
                      device=device)
    rhs = load[1:-1].clone()
    rhs[0] += -(B.T @ q0)
    rhs[-1] += -(B @ qN)
    x = tridiag.block_thomas_2x2(B.T.expand(n_int, 2, 2),
                                 (A + C).expand(n_int, 2, 2),
                                 B.expand(n_int, 2, 2), rhs)  # [n_int, 2]
    full = torch.cat([q0[None], x, qN[None]])
    return full[:, 0], full[:, 1]


class ClampedBiharmonicSolution(NamedTuple):
    nodes: torch.Tensor  # [N+1]
    u_nodal: torch.Tensor  # [N+1] Hermite values
    up_nodal: torch.Tensor  # [N+1] Hermite slopes
    coeffs: torch.Tensor  # [E, M] enhanced element polynomials
    solve_ok: torch.Tensor
    max_slack: torch.Tensor


def _require_f64(cfg, what: str):
    if cfg.torch_dtype() != torch.float64:
        # A loud gate, not a silent downgrade: the (2/h)^4 collocation
        # scaling puts ~1e5-1e6 of dynamic range into the element algebra
        # and the Hermite stiffness conditions as h^-4 (the JAX package
        # measured float32 Linf 4.8 against 1e-13 in float64).
        raise ValueError(
            f"{what} requires dtype='float64': the (2/h)^4 "
            "fourth-derivative scaling is beyond f32 — measured f32 Linf "
            "~4.8 vs f64 ~1e-13")


def _fourth_derivative_rows(t, M: int):
    """V4[p, k] = P_k''''(t_p), host float64."""
    V4 = np.zeros((t.shape[0], M))
    for k in range(4, M):
        c = np.zeros(k + 1)
        c[k] = 1.0
        V4[:, k] = NL.legval(t, NL.legder(c, 4))
    return V4


def prepare_shared_clamped(problem: ClampedBiharmonicProblem1D,
                           cfg: SolverConfig):
    """Host-f64 shared LSE precompute for the fourth-order enhancement
    (JAX :379-419): D = (2/h)^4 V4 at the interior collocation points,
    B = 4 rows (values at t = -1, +1 and slopes (2/h) V1 at t = -1, +1).
    Returns (SharedOperators of CPU tensors, t_int numpy [C])."""
    M, C = cfg.M, cfg.n_colloc
    if M < 6:
        raise ValueError("clamped biharmonic needs M >= 6 (a quintic at "
                         "least: 4 boundary rows + nontrivial u'''')")
    _require_f64(cfg, "clamped biharmonic")
    x0, x1 = problem.domain
    h = (x1 - x0) / (cfg.num_nodes - 1)
    s = 2.0 / h
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    D = (s ** 4) * _fourth_derivative_rows(t_int, M)
    V0b, V1b, _ = legendre.vandermonde_host(np.array([-1.0, 1.0]), M)
    B = np.concatenate([V0b, s * V1b])  # rows: u(-1), u(1), u'(-1), u'(1)
    shared = kkt.precompute_shared_lse_host(D, B, cfg.torch_dtype())
    return shared, t_int


def solve_clamped_biharmonic_1d(problem: ClampedBiharmonicProblem1D,
                                cfg: SolverConfig, shared_bundle=None,
                                device=None) -> ClampedBiharmonicSolution:
    """Direct clamped-beam hybrid solve (section comment above; JAX
    :422-443) on ``device``."""
    device = resolve_device(device)
    if shared_bundle is None:
        shared_bundle = prepare_shared_clamped(problem, cfg)
    shared, t_int = shared_bundle
    shared = shared.to(device)
    dtype = cfg.torch_dtype()
    x0, x1 = problem.domain
    nodes = torch.linspace(x0, x1, cfg.num_nodes, dtype=dtype, device=device)
    with _span("hermite_fem_solve_1d"):
        u, up = hermite_fem_solve_1d(problem, nodes)
    xl, xr = nodes[:-1], nodes[1:]
    h = xr - xl
    t = torch.tensor(np.array(t_int, np.float64), dtype=dtype,
                     device=device)
    xq = 0.5 * (xl + xr)[:, None] + 0.5 * h[:, None] * t[None, :]
    f_rows = problem.f(xq) * torch.ones_like(xq)  # [E, C]
    bc = torch.stack([u[:-1], u[1:], up[:-1], up[1:]], dim=-1)  # [E, 4]
    w, diags = kkt.solve_primal_shared(shared, f_rows, bc)
    return ClampedBiharmonicSolution(
        nodes=nodes, u_nodal=u, up_nodal=up, coeffs=w,
        solve_ok=diags.solve_ok, max_slack=diags.max_slack,
    )


# ------------------------------------------------------------- clamped 2D
#
# The clamped plate Lap^2 u = f, u = du/dn = 0.  Coarse: the C^1 BFS
# rectangle; the plate form a(u, v) = int u_xx v_xx + 2 u_xy v_xy + u_yy v_yy
# (== int Lap u Lap v on H^2_0) separates into Kronecker products of the 1D
# Hermite matrices, so the stiffness apply is a gather / local product /
# scatter-add with a 16-wide local dof axis, solved by Jacobi-CG (SPD;
# kappa ~ h^-4).  Nodal dofs are O(h^4) (the 2D Green's function is not in
# the trial space).  Enhancement: a per-element tensor-Legendre fit of
# Lap^2 p = f against the BFS element trace (values at the 4M-4 boundary
# points, normal slopes at M points an edge), one shared LSE map.


@dataclasses.dataclass(frozen=True)
class ClampedBiharmonicProblem2D:
    """Lap^2 u = f on a rectangle, clamped: u = du/dn = 0 (homogeneous)."""

    name: str
    f: Callable
    domain: tuple = (-1.0, 1.0, -1.0, 1.0)
    exact: Optional[Callable] = None


def clamped_sin2_2d() -> ClampedBiharmonicProblem2D:
    """u = sin^2(pi x) sin^2(pi y): u = u_n = 0 on all four edges of
    [-1, 1]^2; f = a''''(x) a(y) + 2 a''(x) a''(y) + a(x) a''''(y) with
    a(t) = sin^2(pi t)."""
    def a(t):
        return torch.sin(pi * t) ** 2

    def a2(t):
        return 2.0 * pi ** 2 * torch.cos(2.0 * pi * t)

    def a4(t):
        return -8.0 * pi ** 4 * torch.cos(2.0 * pi * t)

    return ClampedBiharmonicProblem2D(
        name="clamped_sin2_2d",
        f=lambda x, y: (a4(x) * a(y) + 2.0 * a2(x) * a2(y)
                        + a(x) * a4(y)),
        exact=lambda x, y: a(x) * a(y),
    )


def _hermite_1d_mats_host(h: float):
    """Host-f64 1D Hermite-cubic element matrices on a length-h element,
    dof order (val_l, slope_l, val_r, slope_r), slope dofs carrying their
    h factor: S0 = int phi phi, S1 = int phi' phi', S2 = int phi'' phi''
    (S2 == _hermite_blocks' K)."""
    tg, wg = np.polynomial.legendre.leggauss(6)
    xi = 0.5 * (tg + 1.0)  # [0, 1]
    w = 0.5 * wg * h  # physical quadrature weights
    H = np.stack([
        1.0 - 3.0 * xi ** 2 + 2.0 * xi ** 3,
        h * (xi - 2.0 * xi ** 2 + xi ** 3),
        3.0 * xi ** 2 - 2.0 * xi ** 3,
        h * (-(xi ** 2) + xi ** 3),
    ])  # [4, G] values
    d1 = np.stack([
        (-6.0 * xi + 6.0 * xi ** 2) / h,
        1.0 - 4.0 * xi + 3.0 * xi ** 2,
        (6.0 * xi - 6.0 * xi ** 2) / h,
        -2.0 * xi + 3.0 * xi ** 2,
    ])  # physical first derivatives
    d2 = np.stack([
        (-6.0 + 12.0 * xi) / h ** 2,
        (-4.0 + 6.0 * xi) / h,
        (6.0 - 12.0 * xi) / h ** 2,
        (-2.0 + 6.0 * xi) / h,
    ])  # physical second derivatives
    S0 = np.einsum("ag,bg,g->ab", H, H, w)
    S1 = np.einsum("ag,bg,g->ab", d1, d1, w)
    S2 = np.einsum("ag,bg,g->ab", d2, d2, w)
    return S0, S1, S2


def _bfs_maps(hx: float, hy: float):
    """Index maps for the 16-dof BFS element: local dof l = 4 * corner +
    dtype with corner = cx + 2 cy and dtype = tx + 2 ty (tx/ty: 0 = value,
    1 = slope); the tensor factors are 1D Hermite dofs a = 2 cx + tx (x)
    and b = 2 cy + ty (y)."""
    amap = np.zeros(16, np.int64)
    bmap = np.zeros(16, np.int64)
    for c in range(4):
        cx, cy = c % 2, c // 2
        for d in range(4):
            tx, ty = d % 2, d // 2
            amap[4 * c + d] = 2 * cx + tx
            bmap[4 * c + d] = 2 * cy + ty
    return amap, bmap


def _bfs_local_stiffness_host(hx: float, hy: float):
    """[16, 16] BFS plate stiffness K16 = S2x*S0y + 2 S1x*S1y + S0x*S2y."""
    S0x, S1x, S2x = _hermite_1d_mats_host(hx)
    S0y, S1y, S2y = _hermite_1d_mats_host(hy)
    amap, bmap = _bfs_maps(hx, hy)
    A, B = amap[:, None], bmap[:, None]
    A2, B2 = amap[None, :], bmap[None, :]
    return (S2x[A, A2] * S0y[B, B2] + 2.0 * S1x[A, A2] * S1y[B, B2]
            + S0x[A, A2] * S2y[B, B2])


def _bfs_gather(v):
    """BFS element local dof vectors: v [ny+1, nx+1, 4] -> [ny, nx, 16]
    in the l = 4 * corner + dtype layout."""
    ny, nx = v.shape[0] - 1, v.shape[1] - 1
    parts = []
    for c in range(4):
        cx, cy = c % 2, c // 2
        parts.append(v[cy:cy + ny, cx:cx + nx, :])
    return torch.cat(parts, dim=-1)


def _bfs_scatter_add(e, shape):
    """Transpose of ``_bfs_gather``: e [ny, nx, 16] -> grid [*shape, 4].
    The four corner windows overlap; they are added in JAX's order."""
    ny, nx = e.shape[0], e.shape[1]
    out = torch.zeros(tuple(shape) + (4,), dtype=e.dtype, device=e.device)
    for c in range(4):
        cx, cy = c % 2, c // 2
        out[cy:cy + ny, cx:cx + nx, :] += e[..., 4 * c:4 * c + 4]
    return out


def _bfs_apply(v, K16):
    """Matrix-free BFS stiffness apply (the four-dof-a-node analog of
    ``assembly2d.apply_stiffness``)."""
    e = torch.einsum("yxl,ml->yxm", _bfs_gather(v), K16)
    return _bfs_scatter_add(e, (v.shape[0], v.shape[1]))


def _bfs_basis_host(hx: float, hy: float, xi_x, xi_y, dx: int = 0,
                    dy: int = 0):
    """BFS basis (physical (dx, dy)-derivatives) at reference points
    (xi_x[p], xi_y[p]) in [0, 1]^2 -> [P, 16]."""
    def h1d(h, xi, d):
        if d == 0:
            return np.stack([
                1.0 - 3.0 * xi ** 2 + 2.0 * xi ** 3,
                h * (xi - 2.0 * xi ** 2 + xi ** 3),
                3.0 * xi ** 2 - 2.0 * xi ** 3,
                h * (-(xi ** 2) + xi ** 3),
            ], axis=-1)  # [P, 4]
        return np.stack([
            (-6.0 * xi + 6.0 * xi ** 2) / h,
            1.0 - 4.0 * xi + 3.0 * xi ** 2,
            (6.0 * xi - 6.0 * xi ** 2) / h,
            -2.0 * xi + 3.0 * xi ** 2,
        ], axis=-1)

    X = h1d(hx, np.asarray(xi_x, float), dx)  # [P, 4]
    Y = h1d(hy, np.asarray(xi_y, float), dy)
    amap, bmap = _bfs_maps(hx, hy)
    return X[:, amap] * Y[:, bmap]  # [P, 16]


def bfs_fem_solve_2d(problem: ClampedBiharmonicProblem2D,
                     cfg: Solver2DConfig, device=None):
    """C^1 BFS coarse stage on ``device`` (JAX :626-678): (xs, ys, nodal
    dof grid [ny+1, nx+1, 4] of (u, u_x, u_y, u_xy), CGResult) by
    matrix-free Jacobi-CG on the SPD plate form.  All four dofs of every
    boundary node are eliminated exactly (u = 0 along an edge forces the
    tangential derivative, and the edge-tangential derivative of u_n)."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = problem.domain
    nx, ny = cfg.nx, cfg.ny
    hx = float((x1 - x0) / nx)
    hy = float((y1 - y0) / ny)
    xs = torch.linspace(x0, x1, nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, ny + 1, dtype=dtype, device=device)
    K16 = torch.as_tensor(_bfs_local_stiffness_host(hx, hy), dtype=dtype,
                          device=device)

    # Consistent load: Gauss quadrature of f against the 16 bicubics.
    q = 6
    tg, wg = np.polynomial.legendre.leggauss(q)
    xi = 0.5 * (tg + 1.0)
    XI_x, XI_y = np.meshgrid(xi, xi)  # [q(y), q(x)]
    Phi = _bfs_basis_host(hx, hy, XI_x.ravel(), XI_y.ravel())  # [q*q, 16]
    wq = np.outer(wg, wg).ravel() * 0.25 * hx * hy  # physical weights
    Phi_w = torch.as_tensor(Phi * wq[:, None], dtype=dtype, device=device)
    xit = torch.as_tensor(xi, dtype=dtype, device=device)
    xq = xs[:-1][:, None] + hx * xit[None, :]  # [nx, q]
    yq = ys[:-1][:, None] + hy * xit[None, :]
    F = problem.f(xq[None, :, None, :], yq[:, None, :, None])
    F = (F * torch.ones((ny, nx, q, q), dtype=dtype, device=device)
         ).reshape(ny, nx, q * q)
    le = torch.einsum("yxp,pl->yxl", F, Phi_w)
    b = _bfs_scatter_add(le, (ny + 1, nx + 1))

    interior = torch.zeros((ny + 1, nx + 1), dtype=torch.bool, device=device)
    interior[1:-1, 1:-1] = True
    interior = interior[..., None]

    def apply_free(v):
        return torch.where(interior, _bfs_apply(v * interior, K16), 0.0)

    # Jacobi diagonal by scatter-add of diag(K16).
    dloc = torch.diagonal(K16).expand(ny, nx, 16)
    diag = _bfs_scatter_add(dloc, (ny + 1, nx + 1))
    M_inv = torch.where(interior, 1.0 / diag, 1.0)
    rhs = torch.where(interior, b, 0.0)
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    maxiter = cfg.cg_maxiter if cfg.cg_maxiter else 20000
    res = cgmod.cg(apply_free, rhs, M_inv=M_inv, tol=tol, maxiter=maxiter)
    u = torch.where(interior, res.x, 0.0)
    return xs, ys, u, res


class ClampedBiharmonicSolution2D(NamedTuple):
    xs: torch.Tensor  # [nx+1]
    ys: torch.Tensor  # [ny+1]
    u_nodal: torch.Tensor  # [ny+1, nx+1, 4] BFS dofs (u, ux, uy, uxy)
    coeffs: torch.Tensor  # [ny, nx, M, M] enhanced element polynomials
    solve_ok: torch.Tensor  # [ny, nx]
    max_slack: torch.Tensor
    cg_iters: int
    cg_residual: torch.Tensor


def prepare_shared_clamped_2d(problem: ClampedBiharmonicProblem2D,
                              cfg: Solver2DConfig):
    """Host-f64 shared LSE precompute for the fourth-order 2D enhancement
    (JAX :692-778): D = Lap^2 collocation rows [C^2, M^2]; B = value rows
    at the 4M-4 boundary points + physical normal-slope rows at M points an
    edge [8M-4, M^2].  Returns (SharedOperators of CPU tensors, t_int
    numpy [C], T_all [8M-4, 16] the BFS trace at the same points, a CPU
    tensor in the run dtype)."""
    M, C = cfg.M, cfg.n_colloc
    if M < 6:
        raise ValueError("clamped biharmonic needs M >= 6 (4 boundary-row "
                         "kinds per direction + nontrivial Lap^2)")
    _require_f64(cfg, "clamped plate")
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny
    sx, sy = 2.0 / hx, 2.0 / hy
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0h, V1h, V2h = legendre.vandermonde_host(t_int, M)
    V4 = _fourth_derivative_rows(t_int, M)

    def t2(Ay, Ax):
        return np.einsum("yk,xl->yxkl", Ay, Ax).reshape(C * C, M * M)

    D = (sx ** 4 * t2(V0h, V4) + 2.0 * sx ** 2 * sy ** 2 * t2(V2h, V2h)
         + sy ** 4 * t2(V4, V0h))

    # Value rows at the shared 4M-4 boundary points.
    bpts = _boundary_coords(M)  # [(ty, tx)]
    V0y_b = legendre.vandermonde_host(bpts[:, 0], M)[0]
    V0x_b = legendre.vandermonde_host(bpts[:, 1], M)[0]
    B_val = np.einsum("pk,pl->pkl", V0y_b, V0x_b).reshape(-1, M * M)
    # Normal-slope rows: M points an edge, corners included (both normal
    # components are clamped data there).
    tb = np.linspace(-1.0, 1.0, M)
    V0t, _, _ = legendre.vandermonde_host(tb, M)
    _, V1m1, _ = legendre.vandermonde_host(np.array([-1.0, 1.0]), M)

    def rows_x(side):  # d/dx rows along edge tx = side
        Vx1 = V1m1[1 if side > 0 else 0][None, :]  # [1, M]
        return (sx * np.einsum("pk,pl->pkl", V0t,
                               np.broadcast_to(Vx1, (M, M)))
                ).reshape(M, M * M)

    def rows_y(side):  # d/dy rows along edge ty = side
        Vy1 = V1m1[1 if side > 0 else 0][None, :]
        return (sy * np.einsum("pk,pl->pkl",
                               np.broadcast_to(Vy1, (M, M)), V0t)
                ).reshape(M, M * M)

    B = np.concatenate([B_val, rows_x(-1.0), rows_x(+1.0),
                        rows_y(-1.0), rows_y(+1.0)])
    # B is rank deficient by construction (rank 8M - 16 of 8M - 4 rows:
    # the corner normal-derivative rows are tangential derivatives of the
    # value trace); the SVD route keeps the full (M-4)^2 bubble null space
    # and the pseudoinverse particular map.  The BFS trace data satisfies
    # the same dependencies exactly (it is the trace of a C^1 bicubic).
    shared = kkt.precompute_shared_lse_host(D, B, cfg.torch_dtype(),
                                            rcond=1e-10)

    # Data-side BFS trace matrices at the same points (physical units on
    # both sides).
    def ref(t):
        return 0.5 * (np.asarray(t) + 1.0)

    T_val = _bfs_basis_host(hx, hy, ref(bpts[:, 1]), ref(bpts[:, 0]))
    T_xl = _bfs_basis_host(hx, hy, np.zeros(M), ref(tb), dx=1)
    T_xr = _bfs_basis_host(hx, hy, np.ones(M), ref(tb), dx=1)
    T_yb = _bfs_basis_host(hx, hy, ref(tb), np.zeros(M), dy=1)
    T_yt = _bfs_basis_host(hx, hy, ref(tb), np.ones(M), dy=1)
    T_all = torch.as_tensor(
        np.concatenate([T_val, T_xl, T_xr, T_yb, T_yt]),
        dtype=cfg.torch_dtype())  # [4M-4 + 4M, 16]
    return shared, t_int, T_all


def solve_clamped_biharmonic_2d(problem: ClampedBiharmonicProblem2D,
                                cfg: Solver2DConfig, shared_bundle=None,
                                device=None) -> ClampedBiharmonicSolution2D:
    """Direct clamped-plate hybrid solve on ``device`` (section comment
    above; JAX :781-817): BFS coarse stage + fourth-order shared-LSE
    enhancement against the C^1 element traces."""
    device = resolve_device(device)
    if shared_bundle is None:
        shared_bundle = prepare_shared_clamped_2d(problem, cfg)
    shared, t_int, T_all = shared_bundle
    dtype = cfg.torch_dtype()
    shared = shared.to(device)
    T_all = torch.as_tensor(T_all, dtype=dtype, device=device)
    with _span("bfs_fem_solve_2d"):
        xs, ys, u, res = bfs_fem_solve_2d(problem, cfg, device=device)
    nx, ny, C = cfg.nx, cfg.ny, cfg.n_colloc
    hx = float(xs[1] - xs[0])
    hy = float(ys[1] - ys[0])
    t_j = torch.tensor(np.array(t_int, np.float64), dtype=dtype,
                       device=device)
    xm = 0.5 * (xs[1:] + xs[:-1])
    ym = 0.5 * (ys[1:] + ys[:-1])
    xq = xm[:, None] + 0.5 * hx * t_j[None, :]
    yq = ym[:, None] + 0.5 * hy * t_j[None, :]
    F = problem.f(xq[None, :, None, :], yq[:, None, :, None])
    f_rows = (F * torch.ones((ny, nx, C, C), dtype=dtype, device=device)
              ).reshape(ny * nx, C * C)
    bc = torch.einsum("yxl,pl->yxp", _bfs_gather(u), T_all
                      ).reshape(ny * nx, -1)
    w, diags = kkt.solve_primal_shared(shared, f_rows, bc)
    M = cfg.M
    return ClampedBiharmonicSolution2D(
        xs=xs, ys=ys, u_nodal=u,
        coeffs=w.reshape(ny, nx, M, M),
        solve_ok=diags.solve_ok.reshape(ny, nx),
        max_slack=diags.max_slack.reshape(ny, nx),
        cg_iters=res.iters, cg_residual=res.residual,
    )


def evaluate_clamped_2d(sol: ClampedBiharmonicSolution2D, x, y):
    """u(x, y) through the standard tensor-Legendre read path."""
    stub = Solution2D(sol.xs, sol.ys, None, sol.coeffs, sol.cg_iters,
                      sol.cg_residual, None, None, sol.solve_ok)
    return evaluate_2d(stub, x, y)
