"""2D and 3D elastodynamics: Newmark-beta marches for rho u_tt - div sigma = f.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/elastic_wave.py``,
with the same names, signatures (plus a trailing ``device=None``: the GPU
unless the caller asks for ``device='cpu'``) and arithmetic:

* Coarse march — Newmark-beta (default beta = 1/4, gamma = 1/2: the
  unconditionally stable, energy-conserving trapezoidal member) on the
  block Q1 system M_rho a + K u = F(t): per step one block matrix-free
  Jacobi-CG solve of (M_rho + beta dt^2 K) for the acceleration, with K
  the ``elastic._block_locals`` (2D) or ``elastic3d._block_locals_3d``
  (3D) operator and M_rho = rho x the scalar consistent mass per
  displacement component.
* Enhanced march — per-element tensor-Legendre (u, v, a) coefficient
  triples for all displacement components at once: each step collocates
  rho a^{n+1} - div sigma(u^{n+1}) = f^{n+1} under the Newmark closure
  u^{n+1} = pred + beta dt^2 a^{n+1}, one shared block LSE map of
  D_NM = rho Mass_blk + beta dt^2 D_blk for the acceleration
  coefficients, with the trace pinning transferred to the acceleration:
  a_trace = (u_trace(Q1 march) - pred_trace) / (beta dt^2).

Dirichlet data must be time-independent (the march pins u_bc once).  The
Jacobi-CG loop of both dimensions is ``transient._masked_cg``; the 2D and
3D marches share their bodies (``_fem_march``, ``_hybrid_march``) and
differ in their pieces.  No march runs a hand-written kernel (the JAX
package's run through XLA, outside its Pallas kernels).  The marches run
inside the spans ``transient.SPANS``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import assembly2d, assembly3d, kkt
from ..utils.device import resolve as resolve_device
from .elastic import (ElasticConfig2D, ElasticProblem2D, _block_colloc_host,
                      _block_locals, _component_problem, sin_elastic_2d)
from .hybrid2d import _element_data_2d
from .hybrid3d import _element_data_3d, _spacings
from .transient import (TransientConfig, _cg_tol, _colloc_rows_2d,
                        _colloc_rows_3d, _march_scan, _masked_cg,
                        _max_iters, _span, _time_axis, _tt)


@dataclasses.dataclass(frozen=True)
class ElasticWaveProblem2D:
    """rho u_tt - div sigma(u) = f(x, y, t); spatial operator, Lame
    coefficients and (time-independent) Dirichlet data from ``elastic``."""

    name: str
    elastic: ElasticProblem2D
    f1: Callable  # body force components f(x, y, t)
    f2: Callable
    u01: Callable  # initial displacement (x, y)
    u02: Callable
    v01: Callable  # initial velocity (x, y)
    v02: Callable
    rho: float = 1.0
    exact1: Optional[Callable] = None  # exact(x, y, t)
    exact2: Optional[Callable] = None


def _zero2(x, y):
    return torch.zeros_like(x + y)


def elastic_wave_2d(lam: float = 1.0, mu: float = 1.0, rho: float = 1.0,
                    omega: float = float(np.pi)) -> ElasticWaveProblem2D:
    """Manufactured forced motion: the steady ``sin_elastic_2d``
    displacement field oscillating as cos(omega t), so
    f_i = cos(omega t) (f_i^s - rho omega^2 u_i^s) with f_i^s the steady
    body force — the coupling terms are exercised at every step."""
    st = sin_elastic_2d(lam=lam, mu=mu)

    def make_f(fs, us):
        return lambda x, y, t: torch.cos(omega * _tt(t, x)) * (
            fs(x, y) - rho * omega ** 2 * us(x, y))

    def make_exact(us):
        return lambda x, y, t: torch.cos(omega * _tt(t, x)) * us(x, y)

    return ElasticWaveProblem2D(
        name="elastic_wave_2d", elastic=st,
        f1=make_f(st.f1, st.exact1), f2=make_f(st.f2, st.exact2),
        u01=st.exact1, u02=st.exact2, v01=_zero2, v02=_zero2, rho=rho,
        exact1=make_exact(st.exact1), exact2=make_exact(st.exact2),
    )


def elastic_free_vibration_2d(lam: float = 1.0, mu: float = 1.0,
                              rho: float = 1.0) -> ElasticWaveProblem2D:
    """Unforced release from the ``sin_elastic_2d`` displacement shape:
    f = 0, v0 = 0, no closed-form solution.  Newmark at (1/4, 1/2)
    conserves the discrete energy 1/2 v^T M_rho v + 1/2 u^T K u exactly
    for f = 0, which the energy-conservation check reads."""
    st = sin_elastic_2d(lam=lam, mu=mu)

    def zero3(x, y, t):
        return torch.zeros_like(x + y)

    return ElasticWaveProblem2D(
        name="elastic_free_vibration_2d", elastic=st,
        f1=zero3, f2=zero3, u01=st.exact1, u02=st.exact2,
        v01=_zero2, v02=_zero2, rho=rho,
    )


class ElasticWaveSolution2D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    fem_values: torch.Tensor  # [2, ny+1, nx+1] displacement at t_final
    velocity: torch.Tensor  # [2, ny+1, nx+1] at t_final
    coeffs: Optional[torch.Tensor]  # [2, ny, nx, M, M] (enhanced march)
    t_final: float
    cg_iters: int  # the most Jacobi-CG iterations of any step
    energy0: torch.Tensor  # discrete energy at t = 0 / t_final — the
    energyN: torch.Tensor  # conservation diagnostic (equal when f = 0)
    lam: float = 1.0
    mu: float = 1.0


class _Pieces(NamedTuple):
    """A coarse Newmark march's pieces, 2D or 3D: the node axes, the
    interior mask, the stacked Dirichlet lift, the block stiffness and
    mass operators on stacked [ncomp, ...] grids, the Jacobi diagonal of
    M_rho + s K as a function of s, the load at t, the initial grids and
    the CG tolerance."""

    dtype: torch.dtype
    axes: tuple  # (xs, ys) or (xs, ys, zs)
    interior: torch.Tensor
    u_bc: torch.Tensor
    apply_K: Callable
    apply_M: Callable
    lhs_diag: Callable  # s -> diag(M_rho + s K), stacked
    load_at: Callable
    u0g: torch.Tensor
    v0g: torch.Tensor
    tol: float


def _check_config(cfg):
    """The marches run Jacobi-CG on the q1 block system."""
    if cfg.precond == "mg":
        raise ValueError(
            "the elastodynamics marches use Jacobi-preconditioned CG "
            "(mass-dominated Newmark LHS); precond='mg' is not supported "
            "— use 'jacobi' or 'auto'"
        )
    if cfg.coarse != "q1":
        raise ValueError(
            "the elastodynamics marches run the q1 block coarse stage "
            "per step; coarse='richardson' applies only to the steady "
            "solves"
        )


def _march_pieces(problem: ElasticWaveProblem2D, cfg: ElasticConfig2D,
                  dt: float, device=None) -> _Pieces:
    """The 2D coarse march's pieces.  The per-step CG is Jacobi-
    preconditioned (the Newmark LHS M_rho + beta dt^2 K is mass-dominated
    at practical dt, so Jacobi converges in a handful of iterations);
    asking for 'mg' is an error, not a silent downgrade."""
    _check_config(cfg)
    p = problem.elastic
    dtype = cfg.torch_dtype()
    device = resolve_device(device)
    x0, x1, y0, y1 = p.domain
    hx = float((x1 - x0) / cfg.nx)
    hy = float((y1 - y0) / cfg.ny)
    A11, A12, A22 = _block_locals(p, hx, hy)
    Ms = problem.rho * assembly2d.q1_local_mass(hx, hy)
    xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)
    shape = (cfg.ny + 1, cfg.nx + 1)
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1] = True
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    A = assembly2d.apply_stiffness

    def on_grid(fns, outside):
        return torch.where(interior, torch.stack(
            [fn(X, Y) * torch.ones_like(X) for fn in fns]), outside)

    u_bc = torch.where(interior, 0.0, torch.stack(
        [g(X, Y) * torch.ones_like(X) for g in (p.g1, p.g2)]))

    def apply_K(u):
        return torch.stack([A(u[0], A11) + A(u[1], A12),
                            A(u[0], A12.T) + A(u[1], A22)])

    def apply_M(u):
        return torch.stack([A(u[0], Ms), A(u[1], Ms)])

    m_diag = assembly2d.stiffness_diag(shape, Ms, dtype, device)
    k_diag = [assembly2d.stiffness_diag(shape, Akk, dtype, device)
              for Akk in (A11, A22)]

    def lhs_diag(s):
        return torch.stack([m_diag + s * kd for kd in k_diag])

    def load_at(t):
        return torch.stack([
            assembly2d.assemble_load(xs, ys, lambda x, y: fc(x, y, t))
            for fc in (problem.f1, problem.f2)])

    u0g = u_bc + on_grid((problem.u01, problem.u02), 0.0)
    v0g = on_grid((problem.v01, problem.v02), 0.0)
    return _Pieces(dtype, (xs, ys), interior, u_bc, apply_K, apply_M,
                   lhs_diag, load_at, u0g.to(dtype), v0g.to(dtype),
                   _cg_tol(cfg, dtype))


def _vdot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _energy(apply_K, apply_M, u, v, u_bc):
    """Discrete energy 1/2 v^T M_rho v + 1/2 (u-u_bc)^T K (u-u_bc) + the
    boundary-coupling work term — for homogeneous Dirichlet data this is
    the standard conserved quadratic form of Newmark (1/4, 1/2)."""
    ud = u - u_bc
    return 0.5 * (_vdot(v, apply_M(v)) + _vdot(ud, apply_K(ud))
                  + 2.0 * _vdot(ud, apply_K(u_bc)))


def _make_free_solve(apply_full, diag, pc: _Pieces, cfg):
    """rhs -> (x, CG iterations): the Jacobi-CG solve of the block
    operator ``apply_full`` on every component's interior nodes."""
    M_inv = torch.where(pc.interior, 1.0 / diag, 1.0)
    return lambda rhs: _masked_cg(apply_full, rhs, pc.interior, M_inv, cfg,
                                  pc.tol)


def _newmark(pc: _Pieces, cfg, dt, beta, gamma_n):
    """(the coarse Newmark step (u, v, a, t) -> (u1, v1, a1, CG
    iterations), the initial acceleration grid)."""
    bdt2 = beta * dt * dt
    solve_lhs = _make_free_solve(
        lambda u: pc.apply_M(u) + bdt2 * pc.apply_K(u), pc.lhs_diag(bdt2),
        pc, cfg)
    solve_mass = _make_free_solve(pc.apply_M, pc.lhs_diag(0.0), pc, cfg)

    def fem_step(u, v, a, t):
        pred = u + dt * v + 0.5 * dt * dt * (1.0 - 2.0 * beta) * a
        a1, iters = solve_lhs(pc.load_at(t + dt) - pc.apply_K(pred))
        u1 = pc.u_bc + torch.where(pc.interior, pred + bdt2 * a1, 0.0)
        v1 = v + dt * ((1.0 - gamma_n) * a + gamma_n * a1)
        return u1, v1, a1, iters

    zero_t = torch.zeros((), dtype=pc.dtype, device=pc.u0g.device)
    a0g, _ = solve_mass(pc.load_at(zero_t) - pc.apply_K(pc.u0g))
    return fem_step, a0g


def _fem_march(problem, cfg, tcfg, beta, gamma_n, pieces_fn, tag, device):
    """The coarse Newmark march: (pieces, uN, vN, max CG iterations,
    energy0, energyN)."""
    with _span("march.setup"):
        dt = tcfg.t_final / tcfg.n_steps
        pc = pieces_fn(problem, cfg, dt, device)
        fem_step, a0g = _newmark(pc, cfg, dt, beta, gamma_n)
        _, ts = _time_axis(tcfg, pc.dtype, pc.u0g.device)

    def step(carry, t):
        with _span("march.fem_step"):
            u1, v1, a1, iters = fem_step(*carry, t)
        return (u1, v1, a1), iters

    (uN, vN, _), iters = _march_scan(step, (pc.u0g, pc.v0g, a0g), ts,
                                     problem, cfg, tcfg, tag)
    return (pc, uN, vN, _max_iters(iters),
            _energy(pc.apply_K, pc.apply_M, pc.u0g, pc.v0g, pc.u_bc),
            _energy(pc.apply_K, pc.apply_M, uN, vN, pc.u_bc))


def elastic_wave_march_2d(problem: ElasticWaveProblem2D,
                          cfg: ElasticConfig2D, tcfg: TransientConfig,
                          beta: float = 0.25, gamma_n: float = 0.5,
                          device=None) -> ElasticWaveSolution2D:
    """FEM Newmark-beta march on the block Q1 system (module docstring)."""
    pc, uN, vN, iters, e0, eN = _fem_march(
        problem, cfg, tcfg, beta, gamma_n, _march_pieces,
        "elastic_wave_march_2d", device)
    xs, ys = pc.axes
    return ElasticWaveSolution2D(
        xs=xs, ys=ys, fem_values=uN, velocity=vN, coeffs=None,
        t_final=tcfg.t_final, cg_iters=iters, energy0=e0, energyN=eN,
        lam=problem.elastic.lam, mu=problem.elastic.mu)


def _block_newmark_maps(D64, B64, Mass_s64, ncomp, rho, bdt2, dtype):
    """Host f64 shared LSE maps of the enhanced Newmark march: (the
    acceleration map of rho Mass_blk + beta dt^2 D, the value projection
    of Mass_blk), CPU ``SharedOperators`` in the run dtype."""
    Mass_blk = np.kron(np.eye(ncomp), Mass_s64)
    shared = kkt.precompute_shared_lse_host(rho * Mass_blk + bdt2 * D64,
                                            B64, dtype)
    proj = kkt.precompute_shared_lse_host(Mass_blk, B64, dtype)
    return shared, proj


def _hybrid_march(problem, cfg, tcfg, beta, gamma_n, device, *, ncomp,
                  colloc, pieces_fn, rows_fn, trace_fn, component, zero_g,
                  forces, u0s, v0s, tag):
    """The enhanced Newmark march of ``ncomp`` displacement components:
    (pieces, uN, vN, wuN, max CG iterations, energy0, energyN).
    ``colloc(p, cfg)`` gives the host block operators (D, B, Mass_s,
    t_int, trace points), ``rows_fn(axes, t_int)`` the collocation-row
    sampler, ``trace_fn(q, axes, u, t_int, pts)`` one component's trace
    rows of the scalar problem ``component(p, c)``; ``zero_g`` is the
    zero Dirichlet data of the velocity and acceleration traces."""
    if beta <= 0.0:
        raise ValueError("hybrid march needs beta > 0 (trace recovery "
                         "divides by beta dt^2); beta=0 runs only the "
                         f"FEM-only {tag[len('hybrid_'):]}")
    p = problem.elastic
    rho = problem.rho
    with _span("march.setup"):
        dt = tcfg.t_final / tcfg.n_steps
        bdt2 = beta * dt * dt
        D64, B64, Mass_s64, t_int, pts = colloc(p, cfg)
        pc = pieces_fn(problem, cfg, dt, device)
        dev = pc.u0g.device
        shared, proj = (m.to(dev) for m in _block_newmark_maps(
            D64, B64, Mass_s64, ncomp, rho, bdt2, pc.dtype))
        D_j = torch.as_tensor(D64, dtype=pc.dtype, device=dev)
        B_j = torch.as_tensor(B64, dtype=pc.dtype, device=dev)
        fem_step, a0g = _newmark(pc, cfg, dt, beta, gamma_n)
        grid_rows = rows_fn(pc.axes, t_int)
        comp_p = [component(p, c) for c in range(ncomp)]
        comp_p0 = [dataclasses.replace(q, g=zero_g) for q in comp_p]
        _, ts = _time_axis(tcfg, pc.dtype, dev)

    def rows_at(fns, *t):
        return torch.cat([grid_rows(fn, *t) for fn in fns], dim=1)

    def traces(u, probs):
        return torch.cat([trace_fn(probs[c], pc.axes, u[c], t_int, pts)
                          for c in range(ncomp)], dim=1)

    def step(carry, t):
        u, v, a, wu, wv, wa = carry
        with _span("march.fem_step"):
            u1, v1, a1, iters = fem_step(u, v, a, t)
        with _span("march.enhance"):
            # element polynomials: one block LSE map for the acceleration
            w_pred = wu + dt * wv + 0.5 * dt * dt * (1.0 - 2.0 * beta) * wa
            f_rows = rows_at(forces, t + dt) - w_pred @ D_j.T
            bc_a = (traces(u1, comp_p) - w_pred @ B_j.T) / bdt2
            wa1 = kkt.apply_shared(shared, f_rows, bc_a)
            wu1 = w_pred + bdt2 * wa1
            wv1 = wv + dt * ((1.0 - gamma_n) * wa + gamma_n * wa1)
        return (u1, v1, a1, wu1, wv1, wa1), iters

    # initial fits: u0/v0 by value projection; a0 from the momentum
    # balance rho a0 = f(0) + div sigma(u0) with the FEM a0's traces
    zero_t = torch.zeros((), dtype=pc.dtype, device=dev)
    wu0 = kkt.apply_shared(proj, rows_at(u0s), traces(pc.u0g, comp_p))
    wv0 = kkt.apply_shared(proj, rows_at(v0s), traces(pc.v0g, comp_p0))
    fa0 = (rows_at(forces, zero_t) - wu0 @ D_j.T) / rho
    wa0 = kkt.apply_shared(proj, fa0, traces(a0g, comp_p0))
    (uN, vN, _, wuN, _, _), iters = _march_scan(
        step, (pc.u0g, pc.v0g, a0g, wu0, wv0, wa0), ts, problem, cfg, tcfg,
        tag)
    return (pc, uN, vN, wuN, _max_iters(iters),
            _energy(pc.apply_K, pc.apply_M, pc.u0g, pc.v0g, pc.u_bc),
            _energy(pc.apply_K, pc.apply_M, uN, vN, pc.u_bc))


def _rows_2d(cfg):
    def rows_fn(axes, t_int):
        xs, ys = axes
        return _colloc_rows_2d(xs, ys, float(xs[1] - xs[0]),
                               float(ys[1] - ys[0]), t_int, cfg.n_colloc)
    return rows_fn


def hybrid_elastic_wave_march_2d(problem: ElasticWaveProblem2D,
                                 cfg: ElasticConfig2D,
                                 tcfg: TransientConfig,
                                 beta: float = 0.25,
                                 gamma_n: float = 0.5,
                                 device=None) -> ElasticWaveSolution2D:
    """LSSVR-enhanced Newmark march: coupled per-element vector (u, v, a)
    coefficient triples riding the FEM march's traces (module docstring).

    Requires beta > 0: the enhanced acceleration traces are recovered as
    (u_trace - pred_trace) / (beta dt^2), so the explicit central-difference
    member (beta = 0) has no enhanced form — use the FEM-only march."""
    M = cfg.M

    def trace_fn(q, axes, u, t_int, bpts):
        return _element_data_2d(q, cfg, *axes, u, t_int, bpts,
                                trace_lift=cfg.trace_lift, skip_f=True)[1]

    pc, uN, vN, wuN, iters, e0, eN = _hybrid_march(
        problem, cfg, tcfg, beta, gamma_n, device, ncomp=2,
        colloc=_block_colloc_host, pieces_fn=_march_pieces,
        rows_fn=_rows_2d(cfg), trace_fn=trace_fn,
        component=_component_problem, zero_g=_zero2,
        forces=(problem.f1, problem.f2), u0s=(problem.u01, problem.u02),
        v0s=(problem.v01, problem.v02),
        tag="hybrid_elastic_wave_march_2d")
    xs, ys = pc.axes
    p = problem.elastic
    return ElasticWaveSolution2D(
        xs=xs, ys=ys, fem_values=uN, velocity=vN,
        coeffs=torch.stack([wuN[:, c * M * M:(c + 1) * M * M].reshape(
            cfg.ny, cfg.nx, M, M) for c in range(2)]),
        t_final=tcfg.t_final, cg_iters=iters, energy0=e0, energyN=eN,
        lam=p.lam, mu=p.mu)


def evaluate_elastic_wave_2d(sol: ElasticWaveSolution2D, x, y):
    """(u1, u2) at t_final from the enhanced coefficients (the tensor
    contraction of ``elastic.evaluate_elastic_2d``, which reads only the
    solution's xs, ys and coeffs)."""
    from .elastic import evaluate_elastic_2d

    assert sol.coeffs is not None, "FEM-only march has no coefficients"
    return evaluate_elastic_2d(sol, x, y)


# ---------------------------------------------------------------------------
# 3D elastodynamics: the tensor lift onto structured hexes (coarse blocks
# from models/elastic3d.py, trace machinery from hybrid3d).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ElasticWaveProblem3D:
    """rho u_tt - div sigma(u) = f(x, y, z, t) on a box; spatial
    operator, Lame coefficients and (time-independent) Dirichlet data from
    ``elastic3d.ElasticProblem3D``."""

    name: str
    elastic: "object"  # ElasticProblem3D
    f: tuple  # 3 components f_c(x, y, z, t)
    u0: tuple  # 3 components (x, y, z)
    v0: tuple
    rho: float = 1.0
    exact: Optional[tuple] = None  # 3 components (x, y, z, t)


def _zero3(x, y, z):
    return torch.zeros_like(x + y + z)


def elastic_wave_3d(lam: float = 1.0, mu: float = 1.0, rho: float = 1.0,
                    omega: float = float(np.pi)) -> ElasticWaveProblem3D:
    """Manufactured forced motion: the ``sin_elastic_3d`` displacement
    field oscillating as cos(omega t) (the construction of the 2D
    ``elastic_wave_2d``)."""
    from .elastic3d import sin_elastic_3d

    st = sin_elastic_3d(lam=lam, mu=mu)

    def make_f(fs, us):
        return lambda x, y, z, t: torch.cos(omega * _tt(t, x)) * (
            fs(x, y, z) - rho * omega ** 2 * us(x, y, z))

    def make_exact(us):
        return lambda x, y, z, t: torch.cos(omega * _tt(t, x)) * us(x, y, z)

    return ElasticWaveProblem3D(
        name="elastic_wave_3d", elastic=st,
        f=tuple(make_f(fs, us) for fs, us in zip(st.f, st.exact)),
        u0=st.exact, v0=(_zero3, _zero3, _zero3), rho=rho,
        exact=tuple(make_exact(us) for us in st.exact),
    )


class ElasticWaveSolution3D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    fem_values: torch.Tensor  # [3, nz+1, ny+1, nx+1] at t_final
    velocity: torch.Tensor
    coeffs: Optional[torch.Tensor]  # [3, nz, ny, nx, M, M, M]
    t_final: float
    cg_iters: int
    energy0: torch.Tensor
    energyN: torch.Tensor
    lam: float = 1.0
    mu: float = 1.0


def _march_pieces_3d(problem: ElasticWaveProblem3D, cfg, dt: float,
                     device=None) -> _Pieces:
    """The 3D coarse march's pieces (nine-block Q1 hex system)."""
    from .elastic3d import _block_locals_3d

    _check_config(cfg)
    p = problem.elastic
    dtype = cfg.torch_dtype()
    device = resolve_device(device)
    x0, x1, y0, y1, z0, z1 = p.domain
    hx, hy, hz = _spacings(p, cfg)
    diag_loc, off_loc = _block_locals_3d(p, hx, hy, hz)
    # exact tensor-product consistent mass (a0 = 0, c = 1 local operator)
    Ms = problem.rho * assembly3d.q1_local_operator_3d(hx, hy, hz, a0=0.0,
                                                       c=1.0)
    xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)
    zs = torch.linspace(z0, z1, cfg.nz + 1, dtype=dtype, device=device)
    shape = (cfg.nz + 1, cfg.ny + 1, cfg.nx + 1)
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1, 1:-1] = True
    X, Y, Z = xs[None, None, :], ys[None, :, None], zs[:, None, None]
    ones = torch.ones(shape, dtype=dtype, device=device)
    A = assembly3d.apply_stiffness_3d
    Axy, Axz, Ayz = off_loc["xy"], off_loc["xz"], off_loc["yz"]

    def on_grid(fns):
        return torch.stack([fn(X, Y, Z) * ones for fn in fns])

    u_bc = torch.where(interior, 0.0, on_grid(p.g))

    def apply_K(u):
        r1 = A(u[0], diag_loc["x"]) + A(u[1], Axy) + A(u[2], Axz)
        r2 = A(u[0], Axy.T) + A(u[1], diag_loc["y"]) + A(u[2], Ayz)
        r3 = A(u[0], Axz.T) + A(u[1], Ayz.T) + A(u[2], diag_loc["z"])
        return torch.stack([r1, r2, r3])

    def apply_M(u):
        return torch.stack([A(u[c], Ms) for c in range(3)])

    m_diag = assembly3d.stiffness_diag_3d(shape, Ms, dtype, device)
    k_diag = [assembly3d.stiffness_diag_3d(shape, diag_loc[d], dtype, device)
              for d in ("x", "y", "z")]

    def lhs_diag(s):
        return torch.stack([m_diag + s * kd for kd in k_diag])

    def load_at(t):
        return torch.stack([
            assembly3d.assemble_load_3d(
                xs, ys, zs, lambda x, y, z, fc=fc: fc(x, y, z, t))
            for fc in problem.f])

    u0g = u_bc + torch.where(interior, on_grid(problem.u0), 0.0)
    v0g = torch.where(interior, on_grid(problem.v0), 0.0)
    return _Pieces(dtype, (xs, ys, zs), interior, u_bc, apply_K, apply_M,
                   lhs_diag, load_at, u0g.to(dtype), v0g.to(dtype),
                   _cg_tol(cfg, dtype))


def elastic_wave_march_3d(problem: ElasticWaveProblem3D, cfg,
                          tcfg: TransientConfig, beta: float = 0.25,
                          gamma_n: float = 0.5,
                          device=None) -> ElasticWaveSolution3D:
    """FEM Newmark-beta march on the nine-block Q1 hex system."""
    pc, uN, vN, iters, e0, eN = _fem_march(
        problem, cfg, tcfg, beta, gamma_n, _march_pieces_3d,
        "elastic_wave_march_3d", device)
    return ElasticWaveSolution3D(
        *pc.axes, fem_values=uN, velocity=vN, coeffs=None,
        t_final=tcfg.t_final, cg_iters=iters, energy0=e0, energyN=eN,
        lam=problem.elastic.lam, mu=problem.elastic.mu)


def hybrid_elastic_wave_march_3d(problem: ElasticWaveProblem3D, cfg,
                                 tcfg: TransientConfig,
                                 beta: float = 0.25,
                                 gamma_n: float = 0.5,
                                 device=None) -> ElasticWaveSolution3D:
    """Enhanced 3D Newmark march: coupled per-hex vector (u, v, a)
    coefficient triples, one block LSE map of rho Mass_blk + beta dt^2
    D_blk per step (3D mirror of the 2D march).  Requires beta > 0."""
    from .elastic3d import _block_colloc_host_3d, _component_problem_3d

    M = cfg.M

    def rows_fn(axes, t_int):
        xs, ys, zs = axes
        return _colloc_rows_3d(xs, ys, zs, float(xs[1] - xs[0]),
                               float(ys[1] - ys[0]), float(zs[1] - zs[0]),
                               t_int, cfg.n_colloc)

    def trace_fn(q, axes, u, t_int, spts):
        return _element_data_3d(q, cfg, *axes, u, t_int, spts,
                                trace_lift=cfg.trace_lift, skip_f=True)[1]

    pc, uN, vN, wuN, iters, e0, eN = _hybrid_march(
        problem, cfg, tcfg, beta, gamma_n, device, ncomp=3,
        colloc=_block_colloc_host_3d, pieces_fn=_march_pieces_3d,
        rows_fn=rows_fn, trace_fn=trace_fn,
        component=_component_problem_3d, zero_g=_zero3, forces=problem.f,
        u0s=problem.u0, v0s=problem.v0,
        tag="hybrid_elastic_wave_march_3d")
    M3 = M * M * M
    shp = (cfg.nz, cfg.ny, cfg.nx, M, M, M)
    p = problem.elastic
    return ElasticWaveSolution3D(
        *pc.axes, fem_values=uN, velocity=vN,
        coeffs=torch.stack([wuN[:, c * M3:(c + 1) * M3].reshape(shp)
                            for c in range(3)]),
        t_final=tcfg.t_final, cg_iters=iters, energy0=e0, energyN=eN,
        lam=p.lam, mu=p.mu)


def evaluate_elastic_wave_3d(sol: ElasticWaveSolution3D, x, y, z):
    """(u1, u2, u3) at t_final from the enhanced coefficients (duck-types
    ``elastic3d.ElasticSolution3D``'s xs, ys, zs and coeffs)."""
    from .elastic3d import evaluate_elastic_3d

    assert sol.coeffs is not None, "FEM-only march has no coefficients"
    return evaluate_elastic_3d(sol, x, y, z)
