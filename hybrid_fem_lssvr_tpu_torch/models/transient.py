"""Transient extension: u_t + L u = f and u_tt + L u = f, in 1D, 2D, 3D.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/transient.py``, with
the same names, signatures (plus a trailing ``device=None``: the GPU
unless the caller asks for ``device='cpu'``) and arithmetic:

* ``fem_march`` / ``fem_march_2d`` / ``fem_march_3d`` — the P1 / Q1
  theta-scheme (Crank-Nicolson by default) with the consistent or the
  (1, 10, 1)/12 Numerov mass; one tridiagonal solve (1D) or one Jacobi-CG
  solve of the mass-dominated M + theta dt A (2D, 3D) a step.
* ``hybrid_march`` / ``hybrid_march_2d`` — the LSSVR-enhanced
  Crank-Nicolson march: per element a Legendre (tensor-Legendre in 2D)
  polynomial advanced by collocating the CN update with its trace pinned
  to the FEM march; the CN collocation operator is shared across
  elements, so the enhancement is the host float64 affine map
  (``kkt.precompute_shared_host`` in 1D, the null-space LSE map
  ``kkt.precompute_shared_lse_host`` in 2D and 3D): two matrix products
  a step.
* ``wave_march`` / ``hybrid_wave_march`` / ``wave_march_2d`` /
  ``hybrid_wave_march_2d`` — Newmark-beta for u_tt + L u = f, the
  enhanced form solving one shared collocation system for the
  acceleration coefficients with the trace pin moved to the
  acceleration.
* ``fem_march_semilinear[_2d]`` / ``hybrid_march_semilinear[_2d]`` — IMEX
  CNAB for u_t + L u + s(u) = f (AB2-extrapolated reaction).
* ``fem_march_adaptive[_2d]`` — error-controlled steps from the embedded
  CN/BE pair; every one of ``max_attempts`` attempts runs, and once t
  reaches t_final an attempt leaves the carry as it is.

No march runs a hand-written kernel: the JAX package's marches go through
XLA matrix products outside its Pallas kernels, and here through torch
matmuls.  Each ``lax.scan`` is a Python loop of fixed length
(``utils.checkpoint.scan``) on the same step function; with
``TransientConfig.checkpoint`` set the loop is cut into chunks and the
carry written after each (``utils.checkpoint.scan_checkpointed``), and a
resumed march is bit for bit the uninterrupted one.  The time axis is
``arange(n_steps) * dt`` in the run dtype, as in JAX, and the step reads
``ts[i]`` as a 0-d tensor.  One dtype runs a march, coarse stage
included (``fem_dtype`` is not consulted, as in JAX).  Per step each 2D
and 3D march reads one scalar a CG iteration (``ops/cg.py``); the
adaptive 2D and 3D marches also read their step size once an attempt, to
build the implicit operator's local matrix on the host.

Each 2D march has a 3D lift on hexes under the same name with ``_3d``
(the 3D section below); ``models/elastic_wave.py`` builds its
elastodynamics marches on ``_march_scan`` and ``_masked_cg``.  The
enhanced marches apply the shared affine map through
``kkt.apply_shared``, without the diagnostics that no march reads.
``_tri_apply``, ``_numerov_setup`` and ``_numerov_locals_2d`` also serve
``models/eigen.py``.

The marches run inside the ``torch.profiler.record_function`` spans
``SPANS``: the host set-up, the FEM step and the element enhancement.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import assembly, assembly2d, assembly3d, cg, kkt, legendre, tridiag
from ..utils import checkpoint as _ckpt
from ..utils.device import resolve as resolve_device
from .hybrid import SolverConfig, _dirichlet_consistent, uniform_nodes
from .hybrid2d import _boundary_coords, _element_data_2d
from .hybrid3d import _element_data_3d, _spacings, _surface_coords
from .problem import Problem1D

_span = torch.profiler.record_function
SPANS = ("march.setup", "march.fem_step", "march.enhance")


def _tt(t, x):
    """A time (Python number or 0-d tensor) as a tensor beside x."""
    return torch.as_tensor(t, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class TransientProblem1D:
    """u_t + L u = f(x, t) with L (and its BCs) a ``Problem1D``.

    ``elliptic.f`` is unused; boundary data is time-independent."""

    name: str
    elliptic: Problem1D
    f: Callable  # f(x, t)
    u0: Callable  # initial condition u0(x)
    exact: Optional[Callable] = None  # exact(x, t)


@dataclasses.dataclass(frozen=True)
class TransientConfig:
    t_final: float = 1.0
    n_steps: int = 100
    theta: float = 0.5  # 0.5 = Crank-Nicolson, 1.0 = backward Euler
    # "consistent": standard P1 mass, O(h^2) nodal.  "numerov": (1, 10,
    # 1)/12 mass weights, the compact 4th-order scheme; requires a uniform
    # mesh, constant diffusion, no advection and Dirichlet ends; reaction
    # and load are Numerov-weighted so the whole operator keeps O(h^4).
    mass: str = "consistent"
    checkpoint: Optional[str] = None  # mid-march resume directory: the
    # loop is chunked and (step, carry, new ys slice) written atomically
    # per chunk (utils.checkpoint.scan_checkpointed); a matching on-disk
    # state resumes from the last completed chunk, bit for bit the
    # uninterrupted run.  The adaptive marches take their own
    # ``checkpoint=`` argument.
    checkpoint_chunk: int = 0  # steps per chunk (0 -> ~8 chunks)


def _march_scan(step, carry0, ts, problem, cfg, tcfg, tag: str):
    """``utils.checkpoint.scan`` or, when ``tcfg.checkpoint`` is set, the
    chunk-checkpointed resumable scan."""
    if not tcfg.checkpoint:
        return _ckpt.scan(step, carry0, ts)
    fp = _ckpt.march_fingerprint(problem.name, cfg, tcfg, tag)
    return _ckpt.scan_checkpointed(
        step, carry0, ts, path=tcfg.checkpoint,
        chunk=tcfg.checkpoint_chunk, fingerprint=fp)


def _tri_apply(sub, main, sup, u):
    """A @ u for tridiagonal diagonals in the ops.tridiag convention."""
    zero = u[:1] * 0
    return (main * u
            + sub * torch.cat([zero, u[:-1]])
            + sup * torch.cat([u[1:], zero]))


def _operator_and_mass(problem: Problem1D, nodes, cfg: SolverConfig):
    """Raw stiffness A (with Robin boundary mass) + mass M diagonals and
    the constant natural-BC load vector."""
    def zero_f(x):
        return torch.zeros_like(x)

    sub_a, main_a, sup_a, _ = assembly.assemble_p1(
        nodes, problem.a, problem.b, problem.c, zero_f,
        quad_order=cfg.fem_quad_order)
    sub_m, main_m, sup_m, _ = assembly.assemble_p1(
        nodes, None, None, lambda x: torch.ones_like(x), zero_f,
        quad_order=cfg.fem_quad_order)
    ell = torch.zeros_like(main_a)  # natural-BC load (time-independent)
    if problem.bc_left != "dirichlet":
        main_a[0] += problem.robin_alpha_left
        ell[0] += problem.g_left
    if problem.bc_right != "dirichlet":
        main_a[-1] += problem.robin_alpha_right
        ell[-1] += problem.g_right
    return (sub_a, main_a, sup_a), (sub_m, main_m, sup_m), ell


def _dirichlet_rows(problem, trip, rhs_val_left, rhs_val_right):
    """Identity rows at Dirichlet ends (no column elimination: the
    tridiagonal solve does not need symmetry).  Returns new diagonals."""
    sub, main, sup = (v.clone() for v in trip)
    if problem.bc_left == "dirichlet":
        main[0] = 1.0
        sup[0] = 0.0
    if problem.bc_right == "dirichlet":
        main[-1] = 1.0
        sub[-1] = 0.0
    return sub, main, sup


def _load(nodes, f_t, t, quad_order):
    """Load vector of f(x, t) at a time t (0-d tensor)."""
    _, _, _, rhs = assembly.assemble_p1(
        nodes, None, None, None, lambda x: f_t(x, t),
        quad_order=quad_order)
    return rhs


def _numerov_setup(problem: Problem1D, nodes, f_t):
    """Compact fourth-order discretisation pieces: exact P1 stiffness plus
    the (1, 10, 1)/12-weighted mass applied to the time term, the reaction
    term and the load, so the whole semidiscrete operator is O(h^4) at the
    nodes.  Returns (A, M, natural-BC load, load(t)), A and M as (sub,
    main, sup) triples."""
    if problem.b is not None:
        if bool(torch.any(problem.b(nodes) != 0.0)):
            raise NotImplementedError("numerov mass requires b == 0")
    if not problem.constant_coeffs:
        raise NotImplementedError(
            "numerov mass requires constant coefficients")
    if problem.bc_left != "dirichlet" or problem.bc_right != "dirichlet":
        raise NotImplementedError(
            "numerov mass requires Dirichlet ends (the one-sided "
            "boundary correction is not implemented)")
    dtype, device = nodes.dtype, nodes.device
    N = nodes.shape[0]
    h = nodes[1] - nodes[0]
    a0 = (problem.a(nodes[:1]) * torch.ones_like(nodes[:1]))[0]
    c0 = (problem.c(nodes[:1]) * torch.ones_like(nodes[:1]))[0]
    ones = torch.ones(N, dtype=dtype, device=device)

    def full(v, zero_at=None):
        out = ones * v
        if zero_at is not None:
            out[zero_at] = 0.0
        return out

    # Numerov mass (h-scaled): sub = sup = h/12, main = 10h/12
    sub_m = full(h / 12.0, 0)
    sup_m = full(h / 12.0, -1)
    main_m = full(10.0 * h / 12.0)
    Mm = (sub_m, main_m, sup_m)
    # exact P1 stiffness of -a u'' + Numerov-weighted reaction
    sub_a = full(-a0 / h, 0) + c0 * sub_m
    sup_a = full(-a0 / h, -1) + c0 * sup_m
    main_a = full(2.0 * a0 / h) + c0 * main_m
    A = (sub_a, main_a, sup_a)

    def load(t):
        return _tri_apply(*Mm, f_t(nodes, t))

    return A, Mm, torch.zeros(N, dtype=dtype, device=device), load


def _march_operators(p, nodes, f_t, cfg, tcfg):
    """(A, M, natural-BC load, load(t)) of the 1D march for ``tcfg.mass``."""
    if tcfg.mass == "numerov":
        return _numerov_setup(p, nodes, f_t)
    A, Mm, ell = _operator_and_mass(p, nodes, cfg)
    return A, Mm, ell, lambda t: _load(nodes, f_t, t, cfg.fem_quad_order)


def _time_axis(tcfg, dtype, device):
    """(dt, ts): ts = arange(n_steps) * dt in the run dtype, as in JAX."""
    dt = tcfg.t_final / tcfg.n_steps
    ts = torch.arange(tcfg.n_steps, dtype=dtype, device=device) * dt
    return dt, ts


class TransientSolution(NamedTuple):
    nodes: torch.Tensor  # [N]
    fem_values: torch.Tensor  # [N] at t_final
    coeffs: Optional[torch.Tensor]  # [E, M] enhanced (hybrid marches only)
    t_final: float


def fem_march(problem: TransientProblem1D, cfg: SolverConfig,
              tcfg: TransientConfig, device=None):
    """P1 theta-scheme march; returns nodal values at t_final."""
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        dt, ts = _time_axis(tcfg, dtype, nodes.device)
        th = tcfg.theta
        A, Mm, ell, load = _march_operators(p, nodes, problem.f, cfg, tcfg)
        lhs = tuple(m + th * dt * a for m, a in zip(Mm, A))
        lhs = _dirichlet_rows(p, lhs, None, None)

    def step(u, t):
        with _span("march.fem_step"):
            r = (_tri_apply(*Mm, u) - (1.0 - th) * dt * _tri_apply(*A, u)
                 + dt * (th * load(t + dt) + (1.0 - th) * load(t) + ell))
            r = _dirichlet_consistent(p, r)
            return tridiag.solve(*lhs, r, method=cfg.tridiag_method), None

    u0 = _dirichlet_consistent(p, problem.u0(nodes).to(dtype))
    uN, _ = _march_scan(step, u0, ts, problem, cfg, tcfg, "fem_march")
    return TransientSolution(nodes, uN, None, tcfg.t_final)


def _shared_cn_operators(problem: TransientProblem1D, cfg: SolverConfig,
                         dt: float):
    """Host float64 shared CN collocation operator and companions:
    (SharedOperators on the CPU in the run dtype, D_L, V0, pinv(V0)), the
    last three numpy float64."""
    p = problem.elliptic
    if not p.constant_coeffs:
        raise NotImplementedError(
            "hybrid_march shares its CN operator across elements "
            "(uniform mesh, constant coefficients only)")
    x0, x1 = p.domain
    h = (x1 - x0) / (cfg.num_nodes - 1)
    V0, V1, V2 = legendre.collocation_vandermonde_host(cfg.M, cfg.n_colloc)
    t = np.linspace(-1.0, 1.0, cfg.n_colloc)
    xc = torch.as_tensor(x0 + (t + 1.0) * 0.5 * h)
    a2, a1, a0 = (v.numpy() for v in p.colloc_coeffs(xc))
    scale = 2.0 / h
    D_L = (a2[:, None] * scale**2 * V2 + a1[:, None] * scale * V1
           + a0[:, None] * V0)
    D_CN = (2.0 / dt) * V0 + D_L
    B = np.stack([V0[0], V0[-1]])
    shared = kkt.precompute_shared_host(D_CN, B, cfg.gamma,
                                        cfg.torch_dtype())
    W0pinv = np.linalg.pinv(V0)  # least-squares u0 projection
    return shared, D_L, V0, W0pinv


def _element_points(nodes, cfg):
    """[E, C] collocation coordinates of the uniform 1D mesh."""
    h = nodes[1] - nodes[0]
    tc = legendre.collocation_points(cfg.n_colloc, dtype=nodes.dtype,
                                     device=nodes.device)
    return nodes[:-1, None] + 0.5 * h * (tc[None, :] + 1.0)


def _end_traces(p, u1):
    """[E, 2] element end values of the nodal vector u1, Dirichlet ends
    taking exact data."""
    v = _dirichlet_consistent(p, u1)
    return torch.stack([v[:-1], v[1:]], dim=-1)


def hybrid_march(problem: TransientProblem1D, cfg: SolverConfig,
                 tcfg: TransientConfig, device=None):
    """LSSVR-enhanced Crank-Nicolson march (see module docstring).

    Each step: one tridiagonal P1 step (traces) + the collocated CN rhs
    from the previous coefficients (one product) + the shared affine-map
    solve (two products).  Returns coefficients at t_final; evaluate with
    ``ops.eval.evaluate``.
    """
    if tcfg.theta != 0.5:
        raise ValueError("hybrid_march collocates the Crank-Nicolson "
                         "update; theta must be 0.5")
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        dev = nodes.device
        dt, ts = _time_axis(tcfg, dtype, dev)
        shared, D_L64, V064, W0pinv64 = _shared_cn_operators(problem, cfg,
                                                             dt)
        shared = shared.to(dev)
        R_op = torch.as_tensor((2.0 / dt) * V064 - D_L64, dtype=dtype,
                               device=dev)
        # FEM march pieces (trace provider)
        A, Mm, ell, load = _march_operators(p, nodes, problem.f, cfg, tcfg)
        lhs = tuple(m + 0.5 * dt * a for m, a in zip(Mm, A))
        lhs = _dirichlet_rows(p, lhs, None, None)
        xc = _element_points(nodes, cfg)

    def fem_step(u, t):
        with _span("march.fem_step"):
            r = (_tri_apply(*Mm, u) - 0.5 * dt * _tri_apply(*A, u)
                 + dt * (0.5 * load(t + dt) + 0.5 * load(t) + ell))
            r = _dirichlet_consistent(p, r)
            return tridiag.solve(*lhs, r, method=cfg.tridiag_method)

    def step(carry, t):
        u, w = carry
        u1 = fem_step(u, t)
        with _span("march.enhance"):
            bc = _end_traces(p, u1)
            # collocated CN rhs: (2/dt) u^n - L u^n + f^n + f^{n+1}
            f_rows = w @ R_op.T + problem.f(xc, t) + problem.f(xc, t + dt)
            w1 = kkt.apply_shared(shared, f_rows, bc)
        return (u1, w1), None

    # initial state: P1 nodal restriction + per-element least-squares fit
    u0 = problem.u0(nodes).to(dtype)
    w0 = problem.u0(xc).to(dtype) @ torch.as_tensor(
        W0pinv64, dtype=dtype, device=dev).T
    (uN, wN), _ = _march_scan(step, (u0, w0), ts, problem, cfg, tcfg,
                              "hybrid_march")
    return TransientSolution(nodes, uN, wN, tcfg.t_final)


def heat_1d() -> TransientProblem1D:
    """u_t - u_xx = (pi^2 - 1) e^{-t} sin(pi x), u(+-1) = 0,
    u0 = sin(pi x); exact u = e^{-t} sin(pi x)."""
    pi = torch.pi
    from .problems import poisson_1d

    return TransientProblem1D(
        name="heat_1d",
        elliptic=dataclasses.replace(poisson_1d(),
                                     name="heat_1d_operator"),
        f=lambda x, t: (pi**2 - 1.0) * torch.exp(-_tt(t, x))
        * torch.sin(pi * x),
        u0=lambda x: torch.sin(pi * x),
        exact=lambda x, t: torch.exp(-_tt(t, x)) * torch.sin(pi * x),
    )


def heat_robin_1d(alpha: float = 1.0) -> TransientProblem1D:
    """u_t - u_xx + u = f with Robin ends whose data is time-independent:
    exact u = cos(pi x) + e^{-t} sin^2(pi x) (the decaying part has zero
    value and zero slope at x = +-1, so the Robin data stays that of the
    steady cos(pi x) part)."""
    pi = torch.pi
    from .problems import robin_1d

    def exact(x, t):
        return (torch.cos(pi * x)
                + torch.exp(-_tt(t, x)) * torch.sin(pi * x) ** 2)

    def f(x, t):
        et = torch.exp(-_tt(t, x))
        s2 = torch.sin(pi * x) ** 2
        # u_t = -e^{-t} s2 ; u_xx = -pi^2 cos + e^{-t} * 2 pi^2 cos(2 pi x)
        uxx = (-pi**2 * torch.cos(pi * x)
               + et * 2.0 * pi**2 * torch.cos(2.0 * pi * x))
        return -et * s2 - uxx + exact(x, t)

    return TransientProblem1D(
        name="heat_robin_1d",
        elliptic=dataclasses.replace(robin_1d(alpha),
                                     name="heat_robin_1d_operator"),
        f=f,
        u0=lambda x: torch.cos(pi * x) + torch.sin(pi * x) ** 2,
        exact=exact,
    )


TRANSIENT_REGISTRY = {
    "heat_1d": heat_1d,
    "heat_robin_1d": heat_robin_1d,
}


# --------------------------------------------------------------- 2D


@dataclasses.dataclass(frozen=True)
class TransientProblem2D:
    """u_t + L u = f(x, y, t) on a rectangle; L (and BCs) a Problem2D."""

    name: str
    elliptic: "object"  # models.hybrid2d.Problem2D
    f: Callable  # f(x, y, t)
    u0: Callable  # u0(x, y)
    exact: Optional[Callable] = None  # exact(x, y, t)


def _check_2d_dirichlet(p):
    if any(t != "dirichlet" for t in p.bc_edges):
        raise NotImplementedError(
            "2D transient marches support all-Dirichlet edges")
    if p.a_var is not None:
        raise NotImplementedError(
            "2D transient marches require constant coefficients")


class TransientSolution2D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    fem_values: torch.Tensor  # [ny+1, nx+1] at t_final
    coeffs: Optional[torch.Tensor]  # [ny, nx, M, M] (enhanced marches)
    t_final: float
    cg_iters: int  # the most Jacobi-CG iterations of any step


def _numerov_locals_2d(hx, hy, a0, c):
    """Tensor Numerov local 4x4s — shared with the steady coarse='compact'
    option; see ``ops.assembly2d.q1_numerov_locals``."""
    return assembly2d.q1_numerov_locals(hx, hy, a0, c)


def _locals_2d(p, hx, hy, mass, dtype):
    """(K_A, K_M) local 4x4s as CPU tensors in the run dtype: the
    consistent Q1 pair or the tensor-Numerov pair.  They stay on the host:
    ``assembly2d.apply_stiffness`` reads them as Python numbers."""
    if mass == "numerov":
        if p.b != (0.0, 0.0):
            raise NotImplementedError("numerov mass requires b == 0")
        K_A, K_M = _numerov_locals_2d(hx, hy, p.a0, p.c)
    else:
        K_A = assembly2d.q1_local_operator(hx, hy, p.a0, p.c, *p.b)
        K_M = assembly2d.q1_local_mass(hx, hy)
    return (torch.as_tensor(K_A, dtype=dtype),
            torch.as_tensor(K_M, dtype=dtype))


def _grid_2d(p, cfg, dtype, device):
    """(xs, ys, X, Y, interior mask, Dirichlet lift u_bc)."""
    x0, x1, y0, y1 = p.domain
    xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)
    interior = torch.zeros((cfg.ny + 1, cfg.nx + 1), dtype=torch.bool,
                           device=device)
    interior[1:-1, 1:-1] = True
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    u_bc = torch.where(interior, 0.0, p.g(X, Y) * torch.ones_like(X))
    return xs, ys, X, Y, interior, u_bc


def _cg_tol(cfg, dtype):
    """cfg.cg_tol, or 100 eps of the run dtype."""
    if cfg.cg_tol is not None:
        return cfg.cg_tol
    return 100.0 * float(torch.finfo(dtype).eps)


def _fem_march_pieces_2d(p, cfg, tcfg, device=None):
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = p.domain
    hx = float((x1 - x0) / cfg.nx)
    hy = float((y1 - y0) / cfg.ny)
    dt = tcfg.t_final / tcfg.n_steps
    th = tcfg.theta
    K_A, K_M = _locals_2d(p, hx, hy, tcfg.mass, dtype)
    K_lhs = K_M + th * dt * K_A
    xs, ys, _, _, interior, u_bc = _grid_2d(p, cfg, dtype,
                                            resolve_device(device))
    return (dtype, hx, hy, dt, th, K_A, K_M, K_lhs, xs, ys, interior,
            u_bc, _jacobi_2d(K_lhs, interior))


def _jacobi_2d(K, interior):
    """The Jacobi preconditioner of the interior-restricted operator of
    the local matrix K on the node grid ``interior``."""
    diag = assembly2d.stiffness_diag(tuple(interior.shape), K, K.dtype,
                                     device=interior.device)
    return torch.where(interior, 1.0 / diag, 1.0)


def _masked_cg(apply_full, rhs, interior, M_inv, cfg, tol):
    """(x, CG iterations): the preconditioned CG solve of the operator
    ``apply_full`` restricted to the ``interior`` nodes, x zero elsewhere
    (``interior`` broadcasts over a leading component axis, as in the
    elastodynamics marches)."""
    def apply_free(v):
        return torch.where(interior, apply_full(v * interior), 0.0)

    res = cg.cg(apply_free, torch.where(interior, rhs, 0.0), M_inv=M_inv,
                tol=tol, maxiter=cfg.cg_maxiter)
    return torch.where(interior, res.x, 0.0), res.iters


def _free_solve_2d(K, rhs, interior, cfg, tol, M_inv=None):
    """(x, CG iterations): the Jacobi-CG solve of the operator of the
    local matrix K restricted to the interior nodes, x zero on the
    boundary.  M_inv is ``_jacobi_2d(K, interior)`` when not given."""
    if M_inv is None:
        M_inv = _jacobi_2d(K, interior)
    return _masked_cg(lambda v: assembly2d.apply_stiffness(v, K), rhs,
                      interior, M_inv, cfg, tol)


def _load_at_2d(problem, xs, ys, K_M, numerov):
    """load(t) on the node grid: the Numerov-weighted nodal load (the
    (1, 10, 1)/12 tensor weights are part of the 4th-order consistency)
    or the Gauss-assembled consistent one."""
    if numerov:
        Y, X = torch.meshgrid(ys, xs, indexing="ij")

        def load_at(t):
            return assembly2d.apply_stiffness(
                problem.f(X, Y, t) * torch.ones_like(X), K_M)
    else:
        def load_at(t):
            return assembly2d.assemble_load(
                xs, ys, lambda x, y: problem.f(x, y, t))
    return load_at


def _fem_step_2d(problem, p, cfg, pieces, numerov=False,
                 semilinear=False):
    """One theta-step closure: u^n (full grid incl. g boundary) ->
    (u^{n+1}, CG iterations).  With ``semilinear`` the IMEX CNAB step:
    carry (u^n grid, s(u^{n-1}) grid), the reaction s extrapolated
    (1.5 s(u^n) - 0.5 s(u^{n-1})) into the rhs."""
    (dtype, hx, hy, dt, th, K_A, K_M, K_lhs, xs, ys, interior, u_bc,
     M_inv) = pieces
    tol = _cg_tol(cfg, dtype)
    load_at = _load_at_2d(problem, xs, ys, K_M, numerov)

    def theta_step(u, t, s_ex=None):
        load = th * load_at(t + dt) + (1.0 - th) * load_at(t)
        r = (assembly2d.apply_stiffness(u, K_M)
             - (1.0 - th) * dt * assembly2d.apply_stiffness(u, K_A)
             + dt * load)
        if s_ex is not None:
            r = r - dt * assembly2d.apply_stiffness(s_ex, K_M)
        # boundary data is time-independent: solve for the interior
        # increment over the Dirichlet lift
        x, iters = _free_solve_2d(
            K_lhs, r - assembly2d.apply_stiffness(u_bc, K_lhs), interior,
            cfg, tol, M_inv)
        return u_bc + x, iters

    def step(u, t):
        with _span("march.fem_step"):
            return theta_step(u, t)

    def imex_step(carry, t):
        u, s_prev = carry
        with _span("march.fem_step"):
            s_n = problem.s(u)
            u1, iters = theta_step(u, t, 1.5 * s_n - 0.5 * s_prev)
            return (u1, s_n), iters

    return imex_step if semilinear else step


def _initial_grid(fn, X, Y, interior, u_bc, dtype):
    """fn(X, Y) on the interior nodes, the Dirichlet lift on the
    boundary."""
    return torch.where(interior, fn(X, Y) * torch.ones_like(X),
                       u_bc).to(dtype)


def _max_iters(iters):
    return int(iters.max()) if iters is not None else 0


def fem_march_2d(problem: TransientProblem2D, cfg, tcfg: TransientConfig,
                 device=None):
    """Q1 theta-scheme march on structured quads: per step one
    Jacobi-preconditioned CG solve of (M + th dt A) (all-Dirichlet edges,
    constant coefficients)."""
    p = problem.elliptic
    _check_2d_dirichlet(p)
    with _span("march.setup"):
        pieces = _fem_march_pieces_2d(p, cfg, tcfg, device)
        dtype = pieces[0]
        xs, ys, interior, u_bc = pieces[8:12]
        step = _fem_step_2d(problem, p, cfg, pieces,
                            numerov=tcfg.mass == "numerov")
        Y, X = torch.meshgrid(ys, xs, indexing="ij")
        u0 = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
        _, ts = _time_axis(tcfg, dtype, xs.device)
    uN, iters = _march_scan(step, u0, ts, problem, cfg, tcfg,
                            "fem_march_2d")
    return TransientSolution2D(xs, ys, uN, None, tcfg.t_final,
                               _max_iters(iters))


def _mass_dl_b_2d(p, cfg):
    """Host f64 (Mass, D_L, B, t_int, bpts) on the shared element — the
    common ingredients of the enhanced CN and Newmark marches."""
    x0, x1, y0, y1 = p.domain
    hx = float((x1 - x0) / cfg.nx)
    hy = float((y1 - y0) / cfg.ny)
    M, C = cfg.M, cfg.n_colloc
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)
    sx, sy = 2.0 / hx, 2.0 / hy
    Mass = np.einsum("yk,xl->yxkl", V0, V0).reshape(C * C, M * M)
    D_L = -p.a0 * (
        sx * sx * np.einsum("yk,xl->yxkl", V0, V2)
        + sy * sy * np.einsum("yk,xl->yxkl", V2, V0)
    ).reshape(C * C, M * M)
    bx, by = p.b
    if bx != 0.0:
        D_L = D_L + bx * sx * np.einsum(
            "yk,xl->yxkl", V0, V1).reshape(C * C, M * M)
    if by != 0.0:
        D_L = D_L + by * sy * np.einsum(
            "yk,xl->yxkl", V1, V0).reshape(C * C, M * M)
    if p.c != 0.0:
        D_L = D_L + p.c * Mass
    bpts = _boundary_coords(M)
    V0y_b = legendre.vandermonde_host(bpts[:, 0], M)[0]
    V0x_b = legendre.vandermonde_host(bpts[:, 1], M)[0]
    B = np.einsum("pk,pl->pkl", V0y_b, V0x_b).reshape(-1, M * M)
    return Mass, D_L, B, t_int, bpts


def _shared_cn_ops_2d(p, cfg, dt):
    """Host f64 shared CN operators for the 2D enhanced march: (shared LSE
    map of D_CN = (2/dt)·Mass + D_L, projection map of Mass for the u0
    fit, rhs operator (2/dt)·Mass - D_L, t_int, bpts), the maps and the
    operator CPU tensors in the run dtype.  The (2/dt) mass shift also
    removes the steady 2D Laplacian's discrete-harmonic pathology, so the
    plain LSE factorisation is well-posed."""
    dtype = cfg.torch_dtype()
    Mass, D_L, B, t_int, bpts = _mass_dl_b_2d(p, cfg)
    D_CN = (2.0 / dt) * Mass + D_L
    shared = kkt.precompute_shared_lse_host(D_CN, B, dtype)
    proj = kkt.precompute_shared_lse_host(Mass, B, dtype)  # u0 fit
    R_op = torch.as_tensor((2.0 / dt) * Mass - D_L, dtype=dtype)
    return shared, proj, R_op, t_int, bpts


def _colloc_rows_2d(xs, ys, hx, hy, t_int, C):
    """f_rows(fn, *t) -> [E, C^2] rows of fn(x, y, *t) at the interior
    collocation points, row-major (iy, ix) x (cy, cx) as in
    ``_element_data_2d``."""
    t_j = torch.as_tensor(t_int, dtype=xs.dtype, device=xs.device)
    xm = 0.5 * (xs[1:] + xs[:-1])
    ym = 0.5 * (ys[1:] + ys[:-1])
    xq = xm[:, None] + 0.5 * hx * t_j[None, :]  # [nx, C]
    yq = ym[:, None] + 0.5 * hy * t_j[None, :]  # [ny, C]
    nx, ny = xq.shape[0], yq.shape[0]
    ones = torch.ones((ny, nx, C, C), dtype=xs.dtype, device=xs.device)

    def f_rows(fn, *t):
        F = fn(xq[None, :, None, :], yq[:, None, :, None], *t)
        return (F * ones).reshape(nx * ny, C * C)

    return f_rows


def _traces_2d(p, cfg, xs, ys, u, t_int, bpts, trace_lift):
    """[E, 4M-4] element traces of the node field u (``_element_data_2d``
    without its collocation rows)."""
    _, bc_rows, _ = _element_data_2d(p, cfg, xs, ys, u, t_int, bpts,
                                     trace_lift=trace_lift, skip_f=True)
    return bc_rows


def hybrid_march_2d(problem: TransientProblem2D, cfg,
                    tcfg: TransientConfig, trace_lift: int = 0,
                    device=None):
    """LSSVR-enhanced 2D Crank-Nicolson march: per element a tensor-
    Legendre polynomial advanced by collocating the CN update at interior
    points with the trace pinned to the Q1 march (the 2D lift of
    ``hybrid_march``).  D_CN = (2/dt)·Mass + D_L is shared across
    elements, factorised once on the host in f64 via the null-space LSE,
    so each step is the Q1 CG step plus four batched products.
    ``trace_lift >= 2``: tangential-Lagrange lifted traces of the marching
    grid (with the numerov mass the O(h^4) nodal values carry to an O(h^4)
    enhanced Linf)."""
    if tcfg.theta != 0.5:
        raise ValueError("hybrid_march_2d collocates the Crank-Nicolson "
                         "update; theta must be 0.5")
    p = problem.elliptic
    _check_2d_dirichlet(p)
    M, C = cfg.M, cfg.n_colloc
    with _span("march.setup"):
        pieces = _fem_march_pieces_2d(p, cfg, tcfg, device)
        dtype, hx, hy, dt = pieces[0], pieces[1], pieces[2], pieces[3]
        xs, ys, interior, u_bc = pieces[8:12]
        dev = xs.device
        shared, proj, R_op, t_int, bpts = _shared_cn_ops_2d(p, cfg, dt)
        shared, proj, R_op = shared.to(dev), proj.to(dev), R_op.to(dev)
        f_rows = _colloc_rows_2d(xs, ys, hx, hy, t_int, C)
        fem_step = _fem_step_2d(problem, p, cfg, pieces,
                                numerov=tcfg.mass == "numerov")

    def scan_step(carry, t):
        u, w = carry
        u1, iters = fem_step(u, t)
        with _span("march.enhance"):
            bc_rows = _traces_2d(p, cfg, xs, ys, u1, t_int, bpts,
                                 trace_lift)
            rhs = w @ R_op.T + f_rows(problem.f, t) + f_rows(problem.f,
                                                             t + dt)
            w1 = kkt.apply_shared(shared, rhs, bc_rows)
        return (u1, w1), iters

    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    u0g = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
    # initial per-element fit: values at interior colloc + trace of u0
    f0_rows = f_rows(problem.u0)
    bc0 = _traces_2d(p, cfg, xs, ys, u0g, t_int, bpts, trace_lift)
    w0 = kkt.apply_shared(proj, f0_rows, bc0)
    _, ts = _time_axis(tcfg, dtype, dev)
    (uN, wN), iters = _march_scan(scan_step, (u0g, w0), ts, problem, cfg,
                                  tcfg, "hybrid_march_2d")
    return TransientSolution2D(
        xs, ys, uN, wN.reshape(cfg.ny, cfg.nx, M, M), tcfg.t_final,
        _max_iters(iters))


def heat_2d() -> TransientProblem2D:
    """u_t - Lap u = (2 pi^2 - 1) e^{-t} sin sin, u = 0 on the boundary;
    exact u = e^{-t} sin(pi x) sin(pi y)."""
    pi = torch.pi
    from .hybrid2d import poisson_2d

    return TransientProblem2D(
        name="heat_2d",
        elliptic=dataclasses.replace(poisson_2d(),
                                     name="heat_2d_operator"),
        f=lambda x, y, t: (2.0 * pi**2 - 1.0) * torch.exp(-_tt(t, x))
        * torch.sin(pi * x) * torch.sin(pi * y),
        u0=lambda x, y: torch.sin(pi * x) * torch.sin(pi * y),
        exact=lambda x, y, t: torch.exp(-_tt(t, x)) * torch.sin(pi * x)
        * torch.sin(pi * y),
    )


# ------------------------------------------------------------- wave


@dataclasses.dataclass(frozen=True)
class WaveProblem1D:
    """u_tt + L u = f(x, t); L (and BCs) a Problem1D; initial (u0, v0)."""

    name: str
    elliptic: Problem1D
    f: Callable  # f(x, t)
    u0: Callable
    v0: Callable
    exact: Optional[Callable] = None  # exact(x, t)


def wave_1d() -> WaveProblem1D:
    """Free vibration u_tt = u_xx, u(+-1) = 0, u0 = sin(pi x), v0 = 0;
    exact u = cos(pi t) sin(pi x) (f = 0 — also the energy-conservation
    oracle for Newmark beta = 1/4)."""
    pi = torch.pi
    from .problems import poisson_1d

    return WaveProblem1D(
        name="wave_1d",
        elliptic=dataclasses.replace(poisson_1d(),
                                     name="wave_1d_operator"),
        f=lambda x, t: torch.zeros_like(x),
        u0=lambda x: torch.sin(pi * x),
        v0=lambda x: torch.zeros_like(x),
        exact=lambda x, t: torch.cos(pi * _tt(t, x)) * torch.sin(pi * x),
    )


def _free_1d(p, nodes):
    """Mask of the nodes that are not Dirichlet ends."""
    free = torch.ones_like(nodes, dtype=torch.bool)
    if p.bc_left == "dirichlet":
        free[0] = False
    if p.bc_right == "dirichlet":
        free[-1] = False
    return free


def wave_march(problem: WaveProblem1D, cfg: SolverConfig,
               tcfg: TransientConfig, beta: float = 0.25,
               gamma_n: float = 0.5, device=None):
    """Newmark-beta march for u_tt + L u = f (unconditionally stable at
    beta = 1/4, gamma = 1/2; O(dt^2)): per step one tridiagonal solve of
    (M + beta dt^2 A) for the new acceleration.  ``tcfg.mass`` selects
    the consistent or Numerov mass exactly as in ``fem_march``.  Returns
    (solution, nodal velocity at t_final)."""
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        dt, ts = _time_axis(tcfg, dtype, nodes.device)
        A, Mm, ell, load = _march_operators(p, nodes, problem.f, cfg, tcfg)
        lhs = tuple(m + beta * dt * dt * a for m, a in zip(Mm, A))
        lhs = _dirichlet_rows(p, lhs, None, None)
        free = _free_1d(p, nodes)

    def accel(u, t):
        # M a = F - A u  (free rows; boundary rows a = 0 since the
        # Dirichlet data is time-independent)
        rhs = torch.where(free, load(t) + ell - _tri_apply(*A, u), 0.0)
        Ml = _dirichlet_rows(p, Mm, None, None)
        return tridiag.solve(*Ml, rhs, method=cfg.tridiag_method)

    def step(carry, t):
        u, v, a = carry
        with _span("march.fem_step"):
            pred_u = u + dt * v + 0.5 * dt * dt * (1.0 - 2.0 * beta) * a
            rhs = torch.where(free, load(t + dt) + ell
                              - _tri_apply(*A, pred_u), 0.0)
            a1 = tridiag.solve(*lhs, rhs, method=cfg.tridiag_method)
            u1 = _dirichlet_consistent(p, pred_u + beta * dt * dt * a1)
            v1 = v + dt * ((1.0 - gamma_n) * a + gamma_n * a1)
        return (u1, v1, a1), None

    u0 = _dirichlet_consistent(p, problem.u0(nodes).to(dtype))
    v0 = torch.where(free, problem.v0(nodes), 0.0).to(dtype)
    a0 = accel(u0, torch.zeros((), dtype=dtype, device=nodes.device))
    (uN, vN, _), _ = _march_scan(step, (u0, v0, a0), ts, problem, cfg,
                                 tcfg, "wave_march")
    return TransientSolution(nodes, uN, None, tcfg.t_final), vN


def hybrid_wave_march(problem: WaveProblem1D, cfg: SolverConfig,
                      tcfg: TransientConfig, beta: float = 0.25,
                      gamma_n: float = 0.5, device=None):
    """LSSVR-enhanced Newmark march: the element polynomials carry
    (u, v, a) coefficient triples; each step collocates
    a^{n+1} + L u^{n+1} = f^{n+1} with the Newmark closure
    u^{n+1} = pred + beta dt^2 a^{n+1}, i.e. ONE shared-operator solve
    for the acceleration coefficients with D = V0 + beta dt^2 D_L and
    the trace pinning transferred to the acceleration:
    a_trace = (u_fem_trace - pred_trace)/(beta dt^2)."""
    p = problem.elliptic
    if p.bc_left != "dirichlet" or p.bc_right != "dirichlet":
        raise NotImplementedError("hybrid_wave_march supports Dirichlet "
                                  "ends")
    if not p.constant_coeffs:
        raise NotImplementedError("hybrid_wave_march shares its operator "
                                  "(constant coefficients only)")
    dtype = cfg.torch_dtype()
    M, C = cfg.M, cfg.n_colloc
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        dev = nodes.device
        dt, ts = _time_axis(tcfg, dtype, dev)
        bdt2 = beta * dt * dt
        x0d, x1d = p.domain
        h = (x1d - x0d) / (cfg.num_nodes - 1)
        V0h, V1h, V2h = legendre.collocation_vandermonde_host(M, C)
        t_np = np.linspace(-1.0, 1.0, C)
        xc_np = torch.as_tensor(x0d + (t_np + 1.0) * 0.5 * h)
        a2, a1c, a0c = (v.numpy() for v in p.colloc_coeffs(xc_np))
        scale = 2.0 / h
        D_L64 = (a2[:, None] * scale**2 * V2h + a1c[:, None] * scale * V1h
                 + a0c[:, None] * V0h)
        D_NM = V0h + bdt2 * D_L64
        B = np.stack([V0h[0], V0h[-1]])
        shared = kkt.precompute_shared_host(D_NM, B, cfg.gamma,
                                            dtype).to(dev)
        W0pinv = torch.as_tensor(np.linalg.pinv(V0h), dtype=dtype,
                                 device=dev)
        D_L = torch.as_tensor(D_L64, dtype=dtype, device=dev)
        Bj = torch.as_tensor(B, dtype=dtype, device=dev)
        # FEM Newmark march (trace provider) reusing wave_march pieces
        A, Mm, ell, load = _march_operators(p, nodes, problem.f, cfg, tcfg)
        lhs = tuple(m + bdt2 * a for m, a in zip(Mm, A))
        lhs = _dirichlet_rows(p, lhs, None, None)
        free = _free_1d(p, nodes)
        xc = _element_points(nodes, cfg)

    def step(carry, t):
        u, v, a, wu, wv, wa = carry
        with _span("march.fem_step"):
            pred_u = u + dt * v + 0.5 * dt * dt * (1.0 - 2.0 * beta) * a
            rhs = torch.where(free, load(t + dt) + ell
                              - _tri_apply(*A, pred_u), 0.0)
            a1 = tridiag.solve(*lhs, rhs, method=cfg.tridiag_method)
            u1 = _dirichlet_consistent(p, pred_u + bdt2 * a1)
            v1 = v + dt * ((1.0 - gamma_n) * a + gamma_n * a1)
        with _span("march.enhance"):
            # element polynomials: collocated Newmark acceleration solve
            w_pred = wu + dt * wv + 0.5 * dt * dt * (1.0 - 2.0 * beta) * wa
            f_rows = problem.f(xc, t + dt) - w_pred @ D_L.T
            pred_tr = w_pred @ Bj.T  # [E, 2]
            bc = (_end_traces(p, u1) - pred_tr) / bdt2
            wa1 = kkt.apply_shared(shared, f_rows, bc)
            wu1 = w_pred + bdt2 * wa1
            wv1 = wv + dt * ((1.0 - gamma_n) * wa + gamma_n * wa1)
        return (u1, v1, a1, wu1, wv1, wa1), None

    zero_t = torch.zeros((), dtype=dtype, device=dev)
    u0 = _dirichlet_consistent(p, problem.u0(nodes).to(dtype))
    v0 = torch.where(free, problem.v0(nodes), 0.0).to(dtype)
    rhs0 = torch.where(free, load(zero_t) + ell - _tri_apply(*A, u0), 0.0)
    Ml = _dirichlet_rows(p, Mm, None, None)
    a0 = tridiag.solve(*Ml, rhs0, method=cfg.tridiag_method)
    wu0 = problem.u0(xc).to(dtype) @ W0pinv.T
    wv0 = (problem.v0(xc).to(dtype) * torch.ones_like(xc)) @ W0pinv.T
    # initial acceleration polynomials from the PDE: a0 = f - L u0
    fa0 = problem.f(xc, zero_t) - wu0 @ D_L.T
    wa0 = fa0 @ W0pinv.T
    (uN, vN, _, wuN, _, _), _ = _march_scan(
        step, (u0, v0, a0, wu0, wv0, wa0), ts, problem, cfg, tcfg,
        "hybrid_wave_march")
    return TransientSolution(nodes, uN, wuN, tcfg.t_final), vN


@dataclasses.dataclass(frozen=True)
class WaveProblem2D:
    """u_tt + L u = f(x, y, t); L (and BCs) a Problem2D."""

    name: str
    elliptic: "object"
    f: Callable
    u0: Callable
    v0: Callable
    exact: Optional[Callable] = None  # exact(x, y, t)


def wave_2d() -> WaveProblem2D:
    """Free vibration u_tt = Lap u, u0 = sin sin, v0 = 0; exact
    u = cos(sqrt(2) pi t) sin(pi x) sin(pi y)."""
    pi = torch.pi
    from .hybrid2d import poisson_2d

    om = float(np.sqrt(2.0)) * pi
    return WaveProblem2D(
        name="wave_2d",
        elliptic=dataclasses.replace(poisson_2d(),
                                     name="wave_2d_operator"),
        f=lambda x, y, t: torch.zeros_like(x + y),
        u0=lambda x, y: torch.sin(pi * x) * torch.sin(pi * y),
        v0=lambda x, y: torch.zeros_like(x + y),
        exact=lambda x, y, t: torch.cos(om * _tt(t, x)) * torch.sin(pi * x)
        * torch.sin(pi * y),
    )


def _newmark_pieces_2d(problem, cfg, tcfg, beta, device):
    """The Q1 Newmark march's pieces (2D): local matrices, grid, the
    interior-restricted Jacobi-CG solve and the load."""
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = p.domain
    hx = float((x1 - x0) / cfg.nx)
    hy = float((y1 - y0) / cfg.ny)
    dt = tcfg.t_final / tcfg.n_steps
    K_A, K_M = _locals_2d(p, hx, hy, tcfg.mass, dtype)
    K_lhs = K_M + beta * dt * dt * K_A
    xs, ys, X, Y, interior, u_bc = _grid_2d(p, cfg, dtype,
                                            resolve_device(device))
    tol = _cg_tol(cfg, dtype)

    def free_solve(K, rhs):
        return _free_solve_2d(K, rhs, interior, cfg, tol)

    load_at = _load_at_2d(problem, xs, ys, K_M, tcfg.mass == "numerov")
    return (dtype, hx, hy, dt, K_A, K_M, K_lhs, xs, ys, X, Y, interior,
            u_bc, free_solve, load_at)


def wave_march_2d(problem: WaveProblem2D, cfg, tcfg: TransientConfig,
                  beta: float = 0.25, gamma_n: float = 0.5, device=None):
    """Newmark-beta march on Q1 quads (2D lift of ``wave_march``): per
    step one Jacobi-CG solve of (M + beta dt^2 A) for the acceleration;
    consistent or tensor-Numerov mass via ``tcfg.mass``.  Returns
    (solution, nodal velocity grid at t_final)."""
    _check_2d_dirichlet(problem.elliptic)
    with _span("march.setup"):
        (dtype, _, _, dt, K_A, K_M, K_lhs, xs, ys, X, Y, interior, u_bc,
         free_solve, load_at) = _newmark_pieces_2d(problem, cfg, tcfg, beta,
                                                   device)

    def step(carry, t):
        u, v, a = carry
        with _span("march.fem_step"):
            pred = u + dt * v + 0.5 * dt * dt * (1.0 - 2.0 * beta) * a
            rhs = load_at(t + dt) - assembly2d.apply_stiffness(pred, K_A)
            a1, iters = free_solve(K_lhs, rhs)
            u1 = u_bc + torch.where(interior, pred + beta * dt * dt * a1,
                                    0.0)
            v1 = v + dt * ((1.0 - gamma_n) * a + gamma_n * a1)
        return (u1, v1, a1), iters

    zero_t = torch.zeros((), dtype=dtype, device=xs.device)
    u0g = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
    v0g = torch.where(interior, problem.v0(X, Y) * torch.ones_like(X),
                      0.0).to(dtype)
    rhs0 = load_at(zero_t) - assembly2d.apply_stiffness(u0g, K_A)
    a0g, _ = free_solve(K_M, rhs0)
    _, ts = _time_axis(tcfg, dtype, xs.device)
    (uN, vN, _), iters = _march_scan(step, (u0g, v0g, a0g), ts, problem,
                                     cfg, tcfg, "wave_march_nd")
    return TransientSolution2D(xs, ys, uN, None, tcfg.t_final,
                               _max_iters(iters)), vN


def hybrid_wave_march_2d(problem: WaveProblem2D, cfg,
                         tcfg: TransientConfig, beta: float = 0.25,
                         gamma_n: float = 0.5, trace_lift: int = 0,
                         device=None):
    """LSSVR-enhanced 2D Newmark march (lift of ``hybrid_wave_march``):
    per-element tensor-Legendre (u, v, a) coefficient triples; each step
    collocates a^{n+1} + L u^{n+1} = f^{n+1} under the Newmark closure
    u^{n+1} = pred + beta dt^2 a^{n+1} — ONE shared-LSE solve of
    D_NM = Mass + beta dt^2 D_L for the acceleration coefficients, with
    the trace pinning transferred to the acceleration:
    a_trace = (u_trace(Q1 march) - pred_trace)/(beta dt^2).
    ``trace_lift=6`` + numerov mass carries the O(h^4) nodal dispersion
    to the enhanced Linf (as in ``hybrid_march_2d``)."""
    p = problem.elliptic
    _check_2d_dirichlet(p)
    M, C = cfg.M, cfg.n_colloc
    with _span("march.setup"):
        (dtype, hx, hy, dt, K_A, K_M, K_lhs, xs, ys, X, Y, interior, u_bc,
         free_solve, load_at) = _newmark_pieces_2d(problem, cfg, tcfg, beta,
                                                   device)
        dev = xs.device
        bdt2 = beta * dt * dt
        Mass64, D_L64, B64, t_int, bpts = _mass_dl_b_2d(p, cfg)
        D_NM = Mass64 + bdt2 * D_L64
        shared = kkt.precompute_shared_lse_host(D_NM, B64, dtype).to(dev)
        proj = kkt.precompute_shared_lse_host(Mass64, B64, dtype).to(dev)
        D_L = torch.as_tensor(D_L64, dtype=dtype, device=dev)
        Bj = torch.as_tensor(B64, dtype=dtype, device=dev)
        f_rows = _colloc_rows_2d(xs, ys, hx, hy, t_int, C)

    def step(carry, t):
        u, v, a, wu, wv, wa = carry
        with _span("march.fem_step"):
            pred = u + dt * v + 0.5 * dt * dt * (1.0 - 2.0 * beta) * a
            rhs = load_at(t + dt) - assembly2d.apply_stiffness(pred, K_A)
            a1, iters = free_solve(K_lhs, rhs)
            u1 = u_bc + torch.where(interior, pred + bdt2 * a1, 0.0)
            v1 = v + dt * ((1.0 - gamma_n) * a + gamma_n * a1)
        with _span("march.enhance"):
            w_pred = wu + dt * wv + 0.5 * dt * dt * (1.0 - 2.0 * beta) * wa
            fr = f_rows(problem.f, t + dt) - w_pred @ D_L.T
            bc_u1 = _traces_2d(p, cfg, xs, ys, u1, t_int, bpts, trace_lift)
            pred_tr = w_pred @ Bj.T
            bc_a = (bc_u1 - pred_tr) / bdt2
            wa1 = kkt.apply_shared(shared, fr, bc_a)
            wu1 = w_pred + bdt2 * wa1
            wv1 = wv + dt * ((1.0 - gamma_n) * wa + gamma_n * wa1)
        return (u1, v1, a1, wu1, wv1, wa1), iters

    zero_t = torch.zeros((), dtype=dtype, device=dev)
    u0g = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
    v0g = torch.where(interior, problem.v0(X, Y) * torch.ones_like(X),
                      0.0).to(dtype)
    rhs0 = load_at(zero_t) - assembly2d.apply_stiffness(u0g, K_A)
    a0g, _ = free_solve(K_M, rhs0)
    # initial polynomial fits: u0/v0 from values + traces; the
    # acceleration from the PDE a0 = f(0) - L u0 with zero boundary
    # traces (time-independent Dirichlet data)
    F0u = f_rows(problem.u0)
    F0v = f_rows(problem.v0)
    bc_u0 = _traces_2d(p, cfg, xs, ys, u0g, t_int, bpts, trace_lift)
    p0 = dataclasses.replace(p, g=lambda x, y: torch.zeros_like(x + y))
    bc_v0 = _traces_2d(p0, cfg, xs, ys, v0g, t_int, bpts, trace_lift)
    bc_a0 = _traces_2d(p0, cfg, xs, ys, a0g, t_int, bpts, trace_lift)
    wu0 = kkt.apply_shared(proj, F0u, bc_u0)
    wv0 = kkt.apply_shared(proj, F0v, bc_v0)
    fa0 = f_rows(problem.f, zero_t) - wu0 @ D_L.T
    wa0 = kkt.apply_shared(proj, fa0, bc_a0)
    _, ts = _time_axis(tcfg, dtype, dev)
    (uN, vN, _, wuN, _, _), iters = _march_scan(
        step, (u0g, v0g, a0g, wu0, wv0, wa0), ts, problem, cfg, tcfg,
        "hybrid_wave_march_2d")
    return TransientSolution2D(
        xs, ys, uN, wuN.reshape(cfg.ny, cfg.nx, M, M), tcfg.t_final,
        _max_iters(iters)), vN


# --------------------------------------------- semilinear (IMEX CNAB)


@dataclasses.dataclass(frozen=True)
class SemilinearTransientProblem1D:
    """u_t + L u + s(u) = f(x, t); L (and BCs) a ``Problem1D``."""

    name: str
    elliptic: Problem1D
    s: Callable  # s(u), applied pointwise
    f: Callable  # f(x, t)
    u0: Callable
    exact: Optional[Callable] = None


def fem_march_semilinear(problem: SemilinearTransientProblem1D,
                         cfg: SolverConfig, tcfg: TransientConfig,
                         device=None):
    """P1/Numerov IMEX CNAB march; returns nodal values at t_final."""
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        dt, ts = _time_axis(tcfg, dtype, nodes.device)
        th = tcfg.theta
        A, Mm, ell, load = _march_operators(p, nodes, problem.f, cfg, tcfg)
        lhs = tuple(m + th * dt * a for m, a in zip(Mm, A))
        lhs = _dirichlet_rows(p, lhs, None, None)

    def step(carry, t):
        u, s_prev = carry
        with _span("march.fem_step"):
            s_n = problem.s(u)
            s_ex = 1.5 * s_n - 0.5 * s_prev  # AB2 at t + dt/2
            r = (_tri_apply(*Mm, u) - (1.0 - th) * dt * _tri_apply(*A, u)
                 + dt * (th * load(t + dt) + (1.0 - th) * load(t) + ell)
                 - dt * _tri_apply(*Mm, s_ex))
            r = _dirichlet_consistent(p, r)
            u1 = tridiag.solve(*lhs, r, method=cfg.tridiag_method)
        return (u1, s_n), None

    u0 = _dirichlet_consistent(p, problem.u0(nodes).to(dtype))
    (uN, _), _ = _march_scan(step, (u0, problem.s(u0)), ts, problem, cfg,
                             tcfg, "fem_march_semilinear")
    return TransientSolution(nodes, uN, None, tcfg.t_final)


def hybrid_march_semilinear(problem: SemilinearTransientProblem1D,
                            cfg: SolverConfig, tcfg: TransientConfig,
                            device=None):
    """LSSVR-enhanced semilinear CN march: the linear shared CN affine map
    (``_shared_cn_operators`` — the implicit side is unchanged by IMEX) +
    the extrapolated reaction collocated from the previous element
    polynomial: rhs -= 3 s(u^n) - s(u^{n-1}) at the collocation points
    ((s^{n+1} ~ 2 s^n - s^{n-1}) + s^n of the CN average, both times the
    2/dt-scaled update)."""
    if tcfg.theta != 0.5:
        raise ValueError("hybrid_march_semilinear collocates the "
                         "Crank-Nicolson update; theta must be 0.5")
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        dev = nodes.device
        dt, ts = _time_axis(tcfg, dtype, dev)
        lin = TransientProblem1D(problem.name, p, problem.f, problem.u0)
        shared, D_L64, V064, W0pinv64 = _shared_cn_operators(lin, cfg, dt)
        shared = shared.to(dev)
        V0 = torch.as_tensor(V064, dtype=dtype, device=dev)
        R_op = torch.as_tensor((2.0 / dt) * V064 - D_L64, dtype=dtype,
                               device=dev)
        A, Mm, ell, load = _march_operators(p, nodes, problem.f, cfg, tcfg)
        lhs = tuple(m + 0.5 * dt * a for m, a in zip(Mm, A))
        lhs = _dirichlet_rows(p, lhs, None, None)
        xc = _element_points(nodes, cfg)

    def fem_step(u, s_prev, t):
        with _span("march.fem_step"):
            s_n = problem.s(u)
            s_ex = 1.5 * s_n - 0.5 * s_prev
            r = (_tri_apply(*Mm, u) - 0.5 * dt * _tri_apply(*A, u)
                 + dt * (0.5 * load(t + dt) + 0.5 * load(t) + ell)
                 - dt * _tri_apply(*Mm, s_ex))
            r = _dirichlet_consistent(p, r)
            return tridiag.solve(*lhs, r, method=cfg.tridiag_method), s_n

    def step(carry, t):
        u, s_prev, w, sc_prev = carry
        u1, s_n = fem_step(u, s_prev, t)
        with _span("march.enhance"):
            bc = _end_traces(p, u1)
            uc = w @ V0.T  # u^n at the collocation points
            sc_n = problem.s(uc)
            f_rows = (w @ R_op.T + problem.f(xc, t) + problem.f(xc, t + dt)
                      - (3.0 * sc_n - sc_prev))
            w1 = kkt.apply_shared(shared, f_rows, bc)
        return (u1, s_n, w1, sc_n), None

    u0 = problem.u0(nodes).to(dtype)
    w0 = problem.u0(xc).to(dtype) @ torch.as_tensor(
        W0pinv64, dtype=dtype, device=dev).T
    sc0 = problem.s(w0 @ V0.T)
    (uN, _, wN, _), _ = _march_scan(
        step, (u0, problem.s(u0), w0, sc0), ts, problem, cfg, tcfg,
        "hybrid_march_semilinear")
    return TransientSolution(nodes, uN, wN, tcfg.t_final)


def semilinear_heat_1d() -> SemilinearTransientProblem1D:
    """u_t - u_xx + u^3 = f, exact u = e^{-t} sin(pi x)."""
    pi = torch.pi
    from . import problems as P

    def u(x, t):
        return torch.exp(-_tt(t, x)) * torch.sin(pi * x)

    return SemilinearTransientProblem1D(
        name="semilinear_heat_1d",
        elliptic=dataclasses.replace(P.poisson_1d(),
                                     name="semilinear_heat_operator"),
        s=lambda v: v ** 3,
        f=lambda x, t: (pi ** 2 - 1.0) * u(x, t) + u(x, t) ** 3,
        u0=lambda x: torch.sin(pi * x),
        exact=u,
    )


@dataclasses.dataclass(frozen=True)
class SemilinearTransientProblem2D:
    """u_t + L u + s(u) = f(x, y, t); L (and BCs) a ``Problem2D``."""

    name: str
    elliptic: "object"
    s: Callable
    f: Callable
    u0: Callable
    exact: Optional[Callable] = None


def _semilinear_fem_step_2d(problem, p, cfg, pieces, numerov):
    """IMEX CNAB step closure: carry (u^n grid, s(u^{n-1}) grid) ->
    (carry, CG iterations)."""
    return _fem_step_2d(problem, p, cfg, pieces, numerov, semilinear=True)


def fem_march_semilinear_2d(problem: SemilinearTransientProblem2D, cfg,
                            tcfg: TransientConfig, device=None):
    """Q1/tensor-Numerov IMEX CNAB march on structured quads."""
    p = problem.elliptic
    _check_2d_dirichlet(p)
    with _span("march.setup"):
        pieces = _fem_march_pieces_2d(p, cfg, tcfg, device)
        dtype = pieces[0]
        xs, ys, interior, u_bc = pieces[8:12]
        step = _semilinear_fem_step_2d(problem, p, cfg, pieces,
                                       numerov=tcfg.mass == "numerov")
        Y, X = torch.meshgrid(ys, xs, indexing="ij")
        u0 = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
        _, ts = _time_axis(tcfg, dtype, xs.device)
    (uN, _), iters = _march_scan(step, (u0, problem.s(u0)), ts, problem,
                                 cfg, tcfg, "fem_march_semilinear_2d")
    return TransientSolution2D(xs, ys, uN, None, tcfg.t_final,
                               _max_iters(iters))


def hybrid_march_semilinear_2d(problem: SemilinearTransientProblem2D,
                               cfg, tcfg: TransientConfig,
                               trace_lift: int = 0, device=None):
    """2D enhanced semilinear CN march: the linear shared CN affine map
    (the implicit side is unchanged by IMEX) + the extrapolated reaction
    collocated from the previous element polynomial (rhs -= 3 s(u^n) -
    s(u^{n-1}) at interior collocation points), traces pinned to the
    IMEX Q1 march."""
    if tcfg.theta != 0.5:
        raise ValueError("hybrid_march_semilinear_2d collocates the "
                         "Crank-Nicolson update; theta must be 0.5")
    p = problem.elliptic
    _check_2d_dirichlet(p)
    M, C = cfg.M, cfg.n_colloc
    with _span("march.setup"):
        pieces = _fem_march_pieces_2d(p, cfg, tcfg, device)
        dtype, hx, hy, dt = pieces[0], pieces[1], pieces[2], pieces[3]
        xs, ys, interior, u_bc = pieces[8:12]
        dev = xs.device
        shared, proj, R_op, t_int, bpts = _shared_cn_ops_2d(p, cfg, dt)
        shared, proj, R_op = shared.to(dev), proj.to(dev), R_op.to(dev)
        V0i = legendre.vandermonde_host(t_int, M)[0]
        Mass_op = torch.as_tensor(
            np.einsum("yk,xl->yxkl", V0i, V0i).reshape(C * C, M * M),
            dtype=dtype, device=dev)
        f_rows = _colloc_rows_2d(xs, ys, hx, hy, t_int, C)
        fem_step = _semilinear_fem_step_2d(problem, p, cfg, pieces,
                                           numerov=tcfg.mass == "numerov")

    def scan_step(carry, t):
        u, s_prev, w, sc_prev = carry
        (u1, s_n), iters = fem_step((u, s_prev), t)
        with _span("march.enhance"):
            bc_rows = _traces_2d(p, cfg, xs, ys, u1, t_int, bpts,
                                 trace_lift)
            sc_n = problem.s(w @ Mass_op.T)
            rhs = (w @ R_op.T + f_rows(problem.f, t)
                   + f_rows(problem.f, t + dt) - (3.0 * sc_n - sc_prev))
            w1 = kkt.apply_shared(shared, rhs, bc_rows)
        return (u1, s_n, w1, sc_n), iters

    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    u0g = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
    f0_rows = f_rows(problem.u0)
    bc0 = _traces_2d(p, cfg, xs, ys, u0g, t_int, bpts, trace_lift)
    w0 = kkt.apply_shared(proj, f0_rows, bc0)
    sc0 = problem.s(w0 @ Mass_op.T)
    _, ts = _time_axis(tcfg, dtype, dev)
    (uN, _, wN, _), iters = _march_scan(
        scan_step, (u0g, problem.s(u0g), w0, sc0), ts, problem, cfg,
        tcfg, "hybrid_march_semilinear_2d")
    return TransientSolution2D(
        xs, ys, uN, wN.reshape(cfg.ny, cfg.nx, M, M), tcfg.t_final,
        _max_iters(iters))


def semilinear_heat_2d() -> SemilinearTransientProblem2D:
    """u_t - Lap u + u^3 = f, exact u = e^{-t} sin(pi x) sin(pi y)."""
    pi = torch.pi
    from .hybrid2d import poisson_2d

    def u(x, y, t):
        return (torch.exp(-_tt(t, x)) * torch.sin(pi * x)
                * torch.sin(pi * y))

    return SemilinearTransientProblem2D(
        name="semilinear_heat_2d",
        elliptic=dataclasses.replace(poisson_2d(),
                                     name="semilinear_heat_2d_operator"),
        s=lambda v: v ** 3,
        f=lambda x, y, t: (2.0 * pi ** 2 - 1.0) * u(x, y, t)
        + u(x, y, t) ** 3,
        u0=lambda x, y: torch.sin(pi * x) * torch.sin(pi * y),
        exact=u,
    )


TRANSIENT_REGISTRY["semilinear_heat_1d"] = semilinear_heat_1d


# ------------------------------------------- adaptive time stepping
#
# Error-controlled marching: each attempt takes one Crank-Nicolson step
# AND one backward-Euler step with the current dt; their difference is the
# embedded local-error estimate of the first-order member (err ~ C dt^2
# |u_tt|/2).  Accept when err <= tol, then rescale dt by dt *= clip(0.9
# (tol/err)^(1/2), 0.2, 5.0), clamped to land exactly on t_final.  The
# loop runs all max_attempts attempts (the attempt index is the loop
# axis, so a checkpoint counts attempts); the decisions are torch.where
# on the device, so the 1D loop reads nothing back to the host.


class AdaptiveMarchResult(NamedTuple):
    solution: "object"  # TransientSolution / TransientSolution2D
    t_reached: torch.Tensor  # scalar; == t_final when the budget sufficed
    accepted: torch.Tensor  # number of accepted steps (int32)
    rejected: torch.Tensor  # number of rejected attempts (int32)
    max_err: torch.Tensor  # max accepted local-error estimate


@dataclasses.dataclass(frozen=True)
class _AdaptiveParams:
    """Fingerprint payload for the adaptive-dt marches: everything that
    determines the attempt trajectory (the carry includes the running t
    and dt, so restoring it resumes the attempt sequence exactly)."""

    t_final: float
    tol: float
    dt0: Optional[float]
    max_attempts: int


def _adaptive_scan(attempt, carry0, max_attempts, problem, cfg, params,
                   tag, checkpoint, checkpoint_chunk):
    """The attempt loop, chunk-checkpointed when ``checkpoint`` is set (the
    attempt index is the loop axis; the body ignores it)."""
    ts = torch.arange(max_attempts)

    def step(c, _t):
        return attempt(c, None)

    if not checkpoint:
        return _ckpt.scan(step, carry0, ts)
    fp = _ckpt.march_fingerprint(problem.name, cfg, params, tag)
    return _ckpt.scan_checkpointed(step, carry0, ts, path=checkpoint,
                                   chunk=checkpoint_chunk, fingerprint=fp)


def _adaptive_attempt(theta_solve, tf, tol_j):
    """One attempt on the carry (u, t, dt, accepted, rejected, emax)."""
    zero = torch.zeros((), dtype=tf.dtype, device=tf.device)

    def attempt(carry, _):
        u, t, dt, acc, rej, emax = carry
        done = t >= tf * (1.0 - 1e-12)
        dt_c = torch.maximum(torch.minimum(dt, tf - t), zero)  # land on tf
        u_cn = theta_solve(u, t, dt_c, 0.5)
        u_be = theta_solve(u, t, dt_c, 1.0)
        err = torch.abs(u_cn - u_be).amax()
        ok = (err <= tol_j) & ~done
        fac = torch.clamp(
            0.9 * torch.sqrt(tol_j / torch.clamp(err, min=1e-30)), 0.2, 5.0)
        return (torch.where(ok, u_cn, u), torch.where(ok, t + dt_c, t),
                torch.where(done, dt, dt * fac),
                acc + ok.to(torch.int32),
                rej + (~(ok | done)).to(torch.int32),
                torch.where(ok, torch.maximum(emax, err), emax)), None

    return attempt


def _adaptive_carry0(u0, t_final, dt0, dtype):
    """(u, t, dt, accepted, rejected, emax) at the start: t = 0 and dt =
    dt0, or t_final / 64."""
    dev = u0.device
    dt_init = torch.tensor(dt0 if dt0 is not None else t_final / 64.0,
                           dtype=dtype, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return (u0, zero, dt_init, zero_i, zero_i, zero)


def fem_march_adaptive(problem: TransientProblem1D, cfg: SolverConfig,
                       t_final: float, tol: float = 1e-6,
                       dt0: Optional[float] = None,
                       max_attempts: int = 512,
                       checkpoint: Optional[str] = None,
                       checkpoint_chunk: int = 0,
                       device=None) -> AdaptiveMarchResult:
    """Adaptive-dt P1 march of u_t + L u = f (CN/BE embedded pair): the
    tridiagonal diagonals depend on the attempt's dt, so both are rebuilt
    per attempt (two tridiagonal solves an attempt)."""
    p = problem.elliptic
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        nodes = uniform_nodes(p, cfg.num_nodes, dtype, device)
        A, Mm, ell = _operator_and_mass(p, nodes, cfg)

    def load(t):
        return _load(nodes, problem.f, t, cfg.fem_quad_order)

    def theta_solve(u, t, dt, th):
        with _span("march.fem_step"):
            lhs = tuple(m + th * dt * a for m, a in zip(Mm, A))
            lhs = _dirichlet_rows(p, lhs, None, None)
            r = (_tri_apply(*Mm, u) - (1.0 - th) * dt * _tri_apply(*A, u)
                 + dt * (th * load(t + dt) + (1.0 - th) * load(t) + ell))
            r = _dirichlet_consistent(p, r)
            return tridiag.solve(*lhs, r, method=cfg.tridiag_method)

    tf = torch.tensor(t_final, dtype=dtype, device=nodes.device)
    tol_j = torch.tensor(tol, dtype=dtype, device=nodes.device)
    u0 = _dirichlet_consistent(p, problem.u0(nodes).to(dtype))
    (uN, tN, _, acc, rej, emax), _ = _adaptive_scan(
        _adaptive_attempt(theta_solve, tf, tol_j),
        _adaptive_carry0(u0, t_final, dt0, dtype), max_attempts, problem,
        cfg, _AdaptiveParams(t_final, tol, dt0, max_attempts),
        "fem_march_adaptive", checkpoint, checkpoint_chunk)
    return AdaptiveMarchResult(
        solution=TransientSolution(nodes, uN, None, float(t_final)),
        t_reached=tN, accepted=acc, rejected=rej, max_err=emax)


def fem_march_adaptive_2d(problem: TransientProblem2D, cfg,
                          t_final: float, tol: float = 1e-5,
                          dt0: Optional[float] = None,
                          max_attempts: int = 512,
                          checkpoint: Optional[str] = None,
                          checkpoint_chunk: int = 0,
                          device=None) -> AdaptiveMarchResult:
    """2D adaptive-dt Q1 march (CN/BE embedded pair, the 2D lift of
    ``fem_march_adaptive``): the implicit operator M + th dt A of an
    attempt is the local matrix K_M + th dt K_A, built on the host from
    the attempt's dt (one scalar read an attempt), so each attempt is two
    Jacobi-CG solves.  Returns fem_values in the ``solution`` (coeffs
    None, cg_iters 0)."""
    p = problem.elliptic
    _check_2d_dirichlet(p)
    dtype = cfg.torch_dtype()
    with _span("march.setup"):
        x0, x1, y0, y1 = p.domain
        hx = float((x1 - x0) / cfg.nx)
        hy = float((y1 - y0) / cfg.ny)
        K_A, K_M = _locals_2d(p, hx, hy, "consistent", dtype)
        xs, ys, X, Y, interior, u_bc = _grid_2d(p, cfg, dtype,
                                                resolve_device(device))
        tolcg = _cg_tol(cfg, dtype)
        load_at = _load_at_2d(problem, xs, ys, K_M, False)

    def theta_solve(u, t, dt, th):
        with _span("march.fem_step"):
            K_lhs = K_M + th * float(dt) * K_A
            load = th * load_at(t + dt) + (1.0 - th) * load_at(t)
            r = (assembly2d.apply_stiffness(u, K_M)
                 - (1.0 - th) * dt * assembly2d.apply_stiffness(u, K_A)
                 + dt * load)
            x, _ = _free_solve_2d(
                K_lhs, r - assembly2d.apply_stiffness(u_bc, K_lhs),
                interior, cfg, tolcg)
            return u_bc + x

    tf = torch.tensor(t_final, dtype=dtype, device=xs.device)
    tol_j = torch.tensor(tol, dtype=dtype, device=xs.device)
    u0 = _initial_grid(problem.u0, X, Y, interior, u_bc, dtype)
    (uN, tN, _, acc, rej, emax), _ = _adaptive_scan(
        _adaptive_attempt(theta_solve, tf, tol_j),
        _adaptive_carry0(u0, t_final, dt0, dtype), max_attempts, problem,
        cfg, _AdaptiveParams(t_final, tol, dt0, max_attempts),
        "fem_march_adaptive_2d", checkpoint, checkpoint_chunk)
    sol = TransientSolution2D(xs, ys, uN, None, float(t_final), 0)
    return AdaptiveMarchResult(solution=sol, t_reached=tN, accepted=acc,
                               rejected=rej, max_err=emax)


# --------------------------------------------------------------- 3D
#
# The tensor lift onto structured hexes: every 3D march is its 2D
# counterpart with ``ops.assembly3d``'s 8x8 local matrices, one
# interior-masked Jacobi-CG solve a step (``_free_solve_3d``) and, when
# enhanced, the shared affine maps on [E, C^3] collocation and [E, S]
# surface-trace rows.  The enhanced marches read only the trace rows of
# ``hybrid3d._element_data_3d`` and skip its collocation rows
# (``skip_f=True``), which JAX's jit drops as unused.


@dataclasses.dataclass(frozen=True)
class TransientProblem3D:
    """u_t + L u = f(x, y, z, t) on a box; L (and BCs) a Problem3D."""

    name: str
    elliptic: "object"  # models.hybrid3d.Problem3D
    f: Callable  # f(x, y, z, t)
    u0: Callable  # u0(x, y, z)
    exact: Optional[Callable] = None  # exact(x, y, z, t)


class TransientSolution3D(NamedTuple):
    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    fem_values: torch.Tensor  # [nz+1, ny+1, nx+1] at t_final
    coeffs: Optional[torch.Tensor]  # [nz, ny, nx, M, M, M]
    t_final: float
    cg_iters: int  # the most Jacobi-CG iterations of any step


def _check_3d_dirichlet(p):
    if any(t != "dirichlet" for t in p.bc_faces):
        raise NotImplementedError(
            "3D transient marches support all-Dirichlet faces")
    if p.a_var is not None:
        raise NotImplementedError(
            "3D transient marches require constant coefficients")


def _locals_3d(hx, hy, hz, p, mass):
    """Host float64 local 8x8 (K_A, K_M): the Q1 hex operators are exact
    tensor products of the 1D P1 matrices (``ops.assembly3d``), so the
    Numerov (1, 10, 1)/12 mass tensorises as in 2D."""
    if mass == "numerov":
        if p.b != (0.0, 0.0, 0.0):
            raise NotImplementedError("numerov mass requires b == 0")
        return assembly3d.q1_numerov_locals_3d(hx, hy, hz, p.a0, p.c)
    K_M = assembly3d._t3(assembly3d._m1(hz), assembly3d._m1(hy),
                         assembly3d._m1(hx))
    K_A = np.asarray(assembly3d.q1_local_operator_3d(hx, hy, hz, p.a0, p.c,
                                                     *p.b))
    return K_A, K_M


class _Grid3D(NamedTuple):
    """The node grid of a 3D march: axes, their broadcast views X [1, 1,
    nx+1], Y [1, ny+1, 1], Z [nz+1, 1, 1], the interior mask, a grid of
    ones and the Dirichlet lift u_bc."""

    xs: torch.Tensor
    ys: torch.Tensor
    zs: torch.Tensor
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    interior: torch.Tensor
    ones: torch.Tensor
    u_bc: torch.Tensor


def _grid_3d(p, cfg, dtype, device):
    x0, x1, y0, y1, z0, z1 = p.domain
    xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
    ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)
    zs = torch.linspace(z0, z1, cfg.nz + 1, dtype=dtype, device=device)
    shape = (cfg.nz + 1, cfg.ny + 1, cfg.nx + 1)
    interior = torch.zeros(shape, dtype=torch.bool, device=device)
    interior[1:-1, 1:-1, 1:-1] = True
    X, Y, Z = xs[None, None, :], ys[None, :, None], zs[:, None, None]
    ones = torch.ones(shape, dtype=dtype, device=device)
    u_bc = torch.where(interior, 0.0, p.g(X, Y, Z) * ones)
    return _Grid3D(xs, ys, zs, X, Y, Z, interior, ones, u_bc)


def _on_grid_3d(fn, g, outside, dtype):
    """fn(X, Y, Z) on the interior nodes, ``outside`` elsewhere."""
    return torch.where(g.interior, fn(g.X, g.Y, g.Z) * g.ones,
                       outside).to(dtype)


def _march_setup_3d(problem, cfg, mass, device):
    """(dtype, (hx, hy, hz), K_A, K_M, grid) of a 3D march; the local
    matrices are CPU tensors in the run dtype (``assembly3d`` reads them
    as Python numbers)."""
    p = problem.elliptic
    _check_3d_dirichlet(p)
    dtype = cfg.torch_dtype()
    hs = _spacings(p, cfg)
    K_A, K_M = (torch.as_tensor(K, dtype=dtype)
                for K in _locals_3d(*hs, p, mass))
    return dtype, hs, K_A, K_M, _grid_3d(p, cfg, dtype,
                                         resolve_device(device))


def _jacobi_3d(K, interior):
    """The Jacobi preconditioner of the interior-restricted operator of
    the local matrix K on the node grid ``interior``."""
    diag = assembly3d.stiffness_diag_3d(tuple(interior.shape), K, K.dtype,
                                        device=interior.device)
    return torch.where(interior, 1.0 / diag, 1.0)


def _free_solve_3d(K, rhs, interior, cfg, tol, M_inv=None):
    """(x, CG iterations): the Jacobi-CG solve of the hex operator of the
    local matrix K restricted to the interior nodes, x zero on the
    boundary (the 3D ``_free_solve_2d``).  M_inv is ``_jacobi_3d(K,
    interior)`` when not given."""
    if M_inv is None:
        M_inv = _jacobi_3d(K, interior)
    return _masked_cg(lambda v: assembly3d.apply_stiffness_3d(v, K), rhs,
                      interior, M_inv, cfg, tol)


def _load_at_3d(problem, g, K_M, numerov):
    """load(t) on the node grid: Numerov-weighted nodal load or the
    Gauss-assembled consistent one (as ``_load_at_2d``)."""
    if numerov:
        def load_at(t):
            return assembly3d.apply_stiffness_3d(
                problem.f(g.X, g.Y, g.Z, t) * g.ones, K_M)
    else:
        def load_at(t):
            return assembly3d.assemble_load_3d(
                g.xs, g.ys, g.zs, lambda x, y, z: problem.f(x, y, z, t))
    return load_at


def _theta_step_3d(problem, cfg, g, K_A, K_M, dt, th, numerov,
                   semilinear=False):
    """One theta-step closure on hexes: u^n -> (u^{n+1}, CG iterations),
    or with ``semilinear`` the IMEX CNAB step on the carry (u^n,
    s(u^{n-1})) (the 3D ``_fem_step_2d``).  The Dirichlet lift's operator
    term is applied once, here."""
    K_lhs = K_M + th * dt * K_A
    K_rhs = K_M - (1.0 - th) * dt * K_A
    M_inv = _jacobi_3d(K_lhs, g.interior)
    bc_term = assembly3d.apply_stiffness_3d(g.u_bc, K_lhs)
    tol = _cg_tol(cfg, K_A.dtype)
    load_at = _load_at_3d(problem, g, K_M, numerov)

    def theta_step(u, t, s_ex=None):
        r = (assembly3d.apply_stiffness_3d(u, K_rhs)
             + dt * (th * load_at(t + dt) + (1.0 - th) * load_at(t)))
        if s_ex is not None:
            r = r - dt * assembly3d.apply_stiffness_3d(s_ex, K_M)
        x, iters = _free_solve_3d(K_lhs, r - bc_term, g.interior, cfg, tol,
                                  M_inv)
        return g.u_bc + x, iters

    def step(u, t):
        with _span("march.fem_step"):
            return theta_step(u, t)

    def imex_step(carry, t):
        u, s_prev = carry
        with _span("march.fem_step"):
            s_n = problem.s(u)
            u1, iters = theta_step(u, t, 1.5 * s_n - 0.5 * s_prev)
            return (u1, s_n), iters

    return imex_step if semilinear else step


def fem_march_3d(problem: TransientProblem3D, cfg, tcfg: TransientConfig,
                 device=None):
    """Q1 hex theta-scheme march (3D lift of ``fem_march_2d``): per step
    one Jacobi-CG solve of the mass-dominated system."""
    with _span("march.setup"):
        dtype, _, K_A, K_M, g = _march_setup_3d(problem, cfg, tcfg.mass,
                                                device)
        dt, ts = _time_axis(tcfg, dtype, g.xs.device)
        step = _theta_step_3d(problem, cfg, g, K_A, K_M, dt, tcfg.theta,
                              tcfg.mass == "numerov")
        u0 = _on_grid_3d(problem.u0, g, g.u_bc, dtype)
    uN, iters = _march_scan(step, u0, ts, problem, cfg, tcfg,
                            "fem_march_3d")
    return TransientSolution3D(g.xs, g.ys, g.zs, uN, None, tcfg.t_final,
                               _max_iters(iters))


def _mass_dl_b_3d(p, cfg):
    """Host f64 (Mass, D_L, B, t_int, spts) on the shared hex — the common
    ingredients of the enhanced 3D CN and Newmark marches."""
    hx, hy, hz = _spacings(p, cfg)
    M, C = cfg.M, cfg.n_colloc
    t_int = np.linspace(-1.0, 1.0, C + 2)[1:-1]
    V0, V1, V2 = legendre.vandermonde_host(t_int, M)
    sx, sy, sz = 2.0 / hx, 2.0 / hy, 2.0 / hz

    def t3(Az, Ay, Ax):
        return np.einsum("zk,yl,xm->zyxklm", Az, Ay, Ax).reshape(
            C * C * C, M * M * M)

    Mass = t3(V0, V0, V0)
    D_L = -p.a0 * (sx * sx * t3(V0, V0, V2) + sy * sy * t3(V0, V2, V0)
                   + sz * sz * t3(V2, V0, V0))
    bx, by, bz = p.b
    if bx != 0.0:
        D_L = D_L + bx * sx * t3(V0, V0, V1)
    if by != 0.0:
        D_L = D_L + by * sy * t3(V0, V1, V0)
    if bz != 0.0:
        D_L = D_L + bz * sz * t3(V1, V0, V0)
    if p.c != 0.0:
        D_L = D_L + p.c * Mass
    spts = _surface_coords(M)
    Vz_b = legendre.vandermonde_host(spts[:, 0], M)[0]
    Vy_b = legendre.vandermonde_host(spts[:, 1], M)[0]
    Vx_b = legendre.vandermonde_host(spts[:, 2], M)[0]
    B = np.einsum("pk,pl,pm->pklm", Vz_b, Vy_b, Vx_b).reshape(
        -1, M * M * M)
    return Mass, D_L, B, t_int, spts


def _shared_cn_ops_3d(p, cfg, dt):
    """Host f64 shared CN operators for the 3D enhanced march (the 3D
    lift of ``_shared_cn_ops_2d``): (shared LSE map of D_CN, projection
    map of Mass, rhs operator (2/dt)·Mass - D_L, t_int, spts), the maps
    and the operator CPU tensors in the run dtype."""
    dtype = cfg.torch_dtype()
    Mass, D_L, B, t_int, spts = _mass_dl_b_3d(p, cfg)
    D_CN = (2.0 / dt) * Mass + D_L
    shared = kkt.precompute_shared_lse_host(D_CN, B, dtype)
    proj = kkt.precompute_shared_lse_host(Mass, B, dtype)
    R_op = torch.as_tensor((2.0 / dt) * Mass - D_L, dtype=dtype)
    return shared, proj, R_op, t_int, spts


def _colloc_rows_3d(xs, ys, zs, hx, hy, hz, t_int, C):
    """f_rows(fn, *t) -> [E, C^3] rows of fn(x, y, z, *t) at the interior
    collocation points, (iz, iy, ix) x (cz, cy, cx) row-major as in
    ``_element_data_3d``.  The rows are the broadcast values copied once
    (JAX multiplies by a [nz, ny, nx, C, C, C] grid of ones, which its
    jit fuses away)."""
    t_j = torch.as_tensor(t_int, dtype=xs.dtype, device=xs.device)
    xq = xs[:-1][:, None] + 0.5 * hx * (t_j[None, :] + 1.0)  # [nx, C]
    yq = ys[:-1][:, None] + 0.5 * hy * (t_j[None, :] + 1.0)
    zq = zs[:-1][:, None] + 0.5 * hz * (t_j[None, :] + 1.0)
    nx, ny, nz = xq.shape[0], yq.shape[0], zq.shape[0]
    shape = (nz, ny, nx, C, C, C)

    def f_rows(fn, *t):
        F = fn(xq[None, None, :, None, None, :],
               yq[None, :, None, None, :, None],
               zq[:, None, None, :, None, None], *t)
        F = torch.as_tensor(F, dtype=xs.dtype, device=xs.device)
        return torch.broadcast_to(F, shape).reshape(nx * ny * nz, C ** 3)

    return f_rows


def _traces_3d(p, cfg, g, u, t_int, spts, trace_lift):
    """[E, S] element surface traces of the node field u
    (``_element_data_3d`` without its collocation rows)."""
    _, bc_rows, _ = _element_data_3d(p, cfg, g.xs, g.ys, g.zs, u, t_int,
                                     spts, trace_lift=trace_lift,
                                     skip_f=True)
    return bc_rows


def hybrid_march_3d(problem: TransientProblem3D, cfg,
                    tcfg: TransientConfig, trace_lift: int = 0,
                    device=None):
    """LSSVR-enhanced 3D CN march: per-hex tensor-Legendre polynomial
    advanced by collocating the CN update at interior points, trace
    pinned to the Q1 hex march at the surface points (3D lift of
    ``hybrid_march_2d``; the enhanced Linf floor is the trilinear trace
    error O(h^2), or with ``trace_lift=6`` and the numerov mass the
    march's O(h^4) nodal error)."""
    if tcfg.theta != 0.5:
        raise ValueError("hybrid_march_3d collocates the Crank-Nicolson "
                         "update; theta must be 0.5")
    p = problem.elliptic
    M = cfg.M
    with _span("march.setup"):
        dtype, hs, K_A, K_M, g = _march_setup_3d(problem, cfg, tcfg.mass,
                                                 device)
        dev = g.xs.device
        dt, ts = _time_axis(tcfg, dtype, dev)
        shared, proj, R_op, t_int, spts = _shared_cn_ops_3d(p, cfg, dt)
        shared, proj, R_op = shared.to(dev), proj.to(dev), R_op.to(dev)
        f_rows = _colloc_rows_3d(g.xs, g.ys, g.zs, *hs, t_int, cfg.n_colloc)
        fem_step = _theta_step_3d(problem, cfg, g, K_A, K_M, dt, 0.5,
                                  tcfg.mass == "numerov")

    def scan_step(carry, t):
        u, w = carry
        u1, iters = fem_step(u, t)
        with _span("march.enhance"):
            bc_rows = _traces_3d(p, cfg, g, u1, t_int, spts, trace_lift)
            rhs = (w @ R_op.T + f_rows(problem.f, t)
                   + f_rows(problem.f, t + dt))
            w1 = kkt.apply_shared(shared, rhs, bc_rows)
        return (u1, w1), iters

    u0g = _on_grid_3d(problem.u0, g, g.u_bc, dtype)
    bc0 = _traces_3d(p, cfg, g, u0g, t_int, spts, trace_lift)
    w0 = kkt.apply_shared(proj, f_rows(problem.u0), bc0)
    (uN, wN), iters = _march_scan(scan_step, (u0g, w0), ts, problem, cfg,
                                  tcfg, "hybrid_march_3d")
    return TransientSolution3D(
        g.xs, g.ys, g.zs, uN, wN.reshape(cfg.nz, cfg.ny, cfg.nx, M, M, M),
        tcfg.t_final, _max_iters(iters))


def heat_3d() -> TransientProblem3D:
    """u_t - Lap u = (3 pi^2 - 1) e^{-t} sin sin sin, u = 0 on the
    boundary; exact u = e^{-t} sin(pi x) sin(pi y) sin(pi z)."""
    pi = torch.pi
    from .hybrid3d import poisson_3d

    def s3(x, y, z):
        return torch.sin(pi * x) * torch.sin(pi * y) * torch.sin(pi * z)

    return TransientProblem3D(
        name="heat_3d",
        elliptic=dataclasses.replace(poisson_3d(),
                                     name="heat_3d_operator"),
        f=lambda x, y, z, t: (3.0 * pi**2 - 1.0) * torch.exp(-_tt(t, x))
        * s3(x, y, z),
        u0=s3,
        exact=lambda x, y, z, t: torch.exp(-_tt(t, x)) * s3(x, y, z),
    )


@dataclasses.dataclass(frozen=True)
class WaveProblem3D:
    """u_tt + L u = f(x, y, z, t); L (and BCs) a Problem3D."""

    name: str
    elliptic: "object"
    f: Callable
    u0: Callable
    v0: Callable
    exact: Optional[Callable] = None


def wave_3d() -> WaveProblem3D:
    """Free vibration u_tt = Lap u on the cube; exact
    u = cos(sqrt(3) pi t) sin sin sin."""
    pi = torch.pi
    from .hybrid3d import poisson_3d

    om = float(np.sqrt(3.0)) * pi

    def s3(x, y, z):
        return torch.sin(pi * x) * torch.sin(pi * y) * torch.sin(pi * z)

    return WaveProblem3D(
        name="wave_3d",
        elliptic=dataclasses.replace(poisson_3d(),
                                     name="wave_3d_operator"),
        f=lambda x, y, z, t: torch.zeros_like(x + y + z),
        u0=s3,
        v0=lambda x, y, z: torch.zeros_like(x + y + z),
        exact=lambda x, y, z, t: torch.cos(om * _tt(t, x)) * s3(x, y, z),
    )


def _newmark_3d(problem, cfg, tcfg, beta, gamma_n, device):
    """The Q1 hex Newmark march's pieces: (dtype, (hx, hy, hz), dt, grid,
    K_A, the FEM step (u, v, a, t) -> (u1, v1, a1, CG iterations), the
    initial (u0, v0, a0) grids)."""
    dtype, hs, K_A, K_M, g = _march_setup_3d(problem, cfg, tcfg.mass,
                                             device)
    dt = tcfg.t_final / tcfg.n_steps
    bdt2 = beta * dt * dt
    K_lhs = K_M + bdt2 * K_A
    M_inv = _jacobi_3d(K_lhs, g.interior)
    tol = _cg_tol(cfg, dtype)
    load_at = _load_at_3d(problem, g, K_M, tcfg.mass == "numerov")

    def fem_step(u, v, a, t):
        pred = u + dt * v + 0.5 * dt * dt * (1.0 - 2.0 * beta) * a
        rhs = load_at(t + dt) - assembly3d.apply_stiffness_3d(pred, K_A)
        a1, iters = _free_solve_3d(K_lhs, rhs, g.interior, cfg, tol, M_inv)
        u1 = g.u_bc + torch.where(g.interior, pred + bdt2 * a1, 0.0)
        v1 = v + dt * ((1.0 - gamma_n) * a + gamma_n * a1)
        return u1, v1, a1, iters

    u0g = _on_grid_3d(problem.u0, g, g.u_bc, dtype)
    v0g = _on_grid_3d(problem.v0, g, 0.0, dtype)
    zero_t = torch.zeros((), dtype=dtype, device=g.xs.device)
    a0g, _ = _free_solve_3d(
        K_M, load_at(zero_t) - assembly3d.apply_stiffness_3d(u0g, K_A),
        g.interior, cfg, tol)
    return dtype, hs, dt, g, K_A, fem_step, (u0g, v0g, a0g)


def wave_march_3d(problem: WaveProblem3D, cfg, tcfg: TransientConfig,
                  beta: float = 0.25, gamma_n: float = 0.5, device=None):
    """Newmark-beta march on Q1 hexes (3D lift of ``wave_march_2d``).
    Returns (solution, nodal velocity grid at t_final)."""
    with _span("march.setup"):
        dtype, _, _, g, _, fem_step, init = _newmark_3d(
            problem, cfg, tcfg, beta, gamma_n, device)
        _, ts = _time_axis(tcfg, dtype, g.xs.device)

    def step(carry, t):
        with _span("march.fem_step"):
            u1, v1, a1, iters = fem_step(*carry, t)
        return (u1, v1, a1), iters

    (uN, vN, _), iters = _march_scan(step, init, ts, problem, cfg, tcfg,
                                     "wave_march_nd")
    return TransientSolution3D(g.xs, g.ys, g.zs, uN, None, tcfg.t_final,
                               _max_iters(iters)), vN


def hybrid_wave_march_3d(problem: WaveProblem3D, cfg,
                         tcfg: TransientConfig, beta: float = 0.25,
                         gamma_n: float = 0.5, trace_lift: int = 0,
                         device=None):
    """LSSVR-enhanced 3D Newmark march (tensor lift of
    ``hybrid_wave_march_2d``): per-hex (u, v, a) coefficient triples,
    one shared-LSE solve of Mass + beta dt^2 D_L per step, trace pinning
    transferred to the acceleration."""
    p = problem.elliptic
    M = cfg.M
    with _span("march.setup"):
        dtype, hs, dt, g, K_A, fem_step, (u0g, v0g, a0g) = _newmark_3d(
            problem, cfg, tcfg, beta, gamma_n, device)
        dev = g.xs.device
        bdt2 = beta * dt * dt
        Mass64, D_L64, B64, t_int, spts = _mass_dl_b_3d(p, cfg)
        shared = kkt.precompute_shared_lse_host(Mass64 + bdt2 * D_L64, B64,
                                                dtype).to(dev)
        proj = kkt.precompute_shared_lse_host(Mass64, B64, dtype).to(dev)
        D_L = torch.as_tensor(D_L64, dtype=dtype, device=dev)
        Bj = torch.as_tensor(B64, dtype=dtype, device=dev)
        f_rows = _colloc_rows_3d(g.xs, g.ys, g.zs, *hs, t_int, cfg.n_colloc)

    def traces(q, u):
        return _traces_3d(q, cfg, g, u, t_int, spts, trace_lift)

    def step(carry, t):
        u, v, a, wu, wv, wa = carry
        with _span("march.fem_step"):
            u1, v1, a1, iters = fem_step(u, v, a, t)
        with _span("march.enhance"):
            w_pred = wu + dt * wv + 0.5 * dt * dt * (1.0 - 2.0 * beta) * wa
            fr = f_rows(problem.f, t + dt) - w_pred @ D_L.T
            bc_a = (traces(p, u1) - w_pred @ Bj.T) / bdt2
            wa1 = kkt.apply_shared(shared, fr, bc_a)
            wu1 = w_pred + bdt2 * wa1
            wv1 = wv + dt * ((1.0 - gamma_n) * wa + gamma_n * wa1)
        return (u1, v1, a1, wu1, wv1, wa1), iters

    # initial fits: u0/v0 from values + traces; the acceleration from the
    # PDE a0 = f(0) - L u0 with the FEM a0's traces (zero Dirichlet data)
    zero_t = torch.zeros((), dtype=dtype, device=dev)
    p0 = dataclasses.replace(p, g=lambda x, y, z: torch.zeros_like(x + y + z))
    wu0 = kkt.apply_shared(proj, f_rows(problem.u0), traces(p, u0g))
    wv0 = kkt.apply_shared(proj, f_rows(problem.v0), traces(p0, v0g))
    fa0 = f_rows(problem.f, zero_t) - wu0 @ D_L.T
    wa0 = kkt.apply_shared(proj, fa0, traces(p0, a0g))
    _, ts = _time_axis(tcfg, dtype, dev)
    (uN, vN, _, wuN, _, _), iters = _march_scan(
        step, (u0g, v0g, a0g, wu0, wv0, wa0), ts, problem, cfg, tcfg,
        "hybrid_wave_march_3d")
    return TransientSolution3D(
        g.xs, g.ys, g.zs, uN, wuN.reshape(cfg.nz, cfg.ny, cfg.nx, M, M, M),
        tcfg.t_final, _max_iters(iters)), vN


@dataclasses.dataclass(frozen=True)
class SemilinearTransientProblem3D:
    """u_t + L u + s(u) = f(x, y, z, t); L (and BCs) a ``Problem3D``."""

    name: str
    elliptic: "object"
    s: Callable
    f: Callable
    u0: Callable
    exact: Optional[Callable] = None


def _semilinear_pieces_3d(problem, p, cfg, tcfg, device=None):
    """(dtype, (hx, hy, hz), dt, grid, IMEX CNAB step closure) of the 3D
    semilinear marches; the step maps the carry (u^n, s(u^{n-1})) to
    (carry, CG iterations)."""
    dtype, hs, K_A, K_M, g = _march_setup_3d(problem, cfg, tcfg.mass,
                                             device)
    dt = tcfg.t_final / tcfg.n_steps
    step = _theta_step_3d(problem, cfg, g, K_A, K_M, dt, tcfg.theta,
                          tcfg.mass == "numerov", semilinear=True)
    return dtype, hs, dt, g, step


def fem_march_semilinear_3d(problem: SemilinearTransientProblem3D, cfg,
                            tcfg: TransientConfig, device=None):
    """Q1-hex/tensor-Numerov IMEX CNAB march (3D lift)."""
    with _span("march.setup"):
        dtype, _, _, g, step = _semilinear_pieces_3d(
            problem, problem.elliptic, cfg, tcfg, device)
        u0 = _on_grid_3d(problem.u0, g, g.u_bc, dtype)
        _, ts = _time_axis(tcfg, dtype, g.xs.device)
    (uN, _), iters = _march_scan(step, (u0, problem.s(u0)), ts, problem,
                                 cfg, tcfg, "fem_march_semilinear_3d")
    return TransientSolution3D(g.xs, g.ys, g.zs, uN, None, tcfg.t_final,
                               _max_iters(iters))


def hybrid_march_semilinear_3d(problem: SemilinearTransientProblem3D,
                               cfg, tcfg: TransientConfig,
                               trace_lift: int = 0, device=None):
    """3D enhanced semilinear CN march (lift of
    ``hybrid_march_semilinear_2d``): linear shared CN affine map + the
    extrapolated reaction collocated from the previous hex polynomial."""
    if tcfg.theta != 0.5:
        raise ValueError("hybrid_march_semilinear_3d collocates the "
                         "Crank-Nicolson update; theta must be 0.5")
    p = problem.elliptic
    M, C = cfg.M, cfg.n_colloc
    with _span("march.setup"):
        dtype, hs, dt, g, fem_step = _semilinear_pieces_3d(problem, p, cfg,
                                                           tcfg, device)
        dev = g.xs.device
        shared, proj, R_op, t_int, spts = _shared_cn_ops_3d(p, cfg, dt)
        shared, proj, R_op = shared.to(dev), proj.to(dev), R_op.to(dev)
        V0i = legendre.vandermonde_host(t_int, M)[0]
        Mass_op = torch.as_tensor(
            np.einsum("zk,yl,xm->zyxklm", V0i, V0i, V0i).reshape(
                C * C * C, M * M * M), dtype=dtype, device=dev)
        f_rows = _colloc_rows_3d(g.xs, g.ys, g.zs, *hs, t_int, C)

    def scan_step(carry, t):
        u, s_prev, w, sc_prev = carry
        (u1, s_n), iters = fem_step((u, s_prev), t)
        with _span("march.enhance"):
            bc_rows = _traces_3d(p, cfg, g, u1, t_int, spts, trace_lift)
            sc_n = problem.s(w @ Mass_op.T)
            rhs = (w @ R_op.T + f_rows(problem.f, t)
                   + f_rows(problem.f, t + dt) - (3.0 * sc_n - sc_prev))
            w1 = kkt.apply_shared(shared, rhs, bc_rows)
        return (u1, s_n, w1, sc_n), iters

    u0g = _on_grid_3d(problem.u0, g, g.u_bc, dtype)
    bc0 = _traces_3d(p, cfg, g, u0g, t_int, spts, trace_lift)
    w0 = kkt.apply_shared(proj, f_rows(problem.u0), bc0)
    sc0 = problem.s(w0 @ Mass_op.T)
    _, ts = _time_axis(tcfg, dtype, dev)
    (uN, _, wN, _), iters = _march_scan(
        scan_step, (u0g, problem.s(u0g), w0, sc0), ts, problem, cfg, tcfg,
        "hybrid_march_semilinear_3d")
    return TransientSolution3D(
        g.xs, g.ys, g.zs, uN, wN.reshape(cfg.nz, cfg.ny, cfg.nx, M, M, M),
        tcfg.t_final, _max_iters(iters))


def semilinear_heat_3d() -> SemilinearTransientProblem3D:
    """u_t - Lap u + u^3 = f, exact u = e^{-t} sin sin sin."""
    pi = torch.pi
    from .hybrid3d import get_problem_3d

    def s3(x, y, z):
        return torch.sin(pi * x) * torch.sin(pi * y) * torch.sin(pi * z)

    def u(x, y, z, t):
        return torch.exp(-_tt(t, x)) * s3(x, y, z)

    return SemilinearTransientProblem3D(
        name="semilinear_heat_3d",
        elliptic=dataclasses.replace(get_problem_3d("poisson_3d"),
                                     name="semilinear_heat_3d_operator"),
        s=lambda v: v ** 3,
        f=lambda x, y, z, t: (3.0 * pi ** 2 - 1.0) * u(x, y, z, t)
        + u(x, y, z, t) ** 3,
        u0=s3,
        exact=u,
    )


def fem_march_adaptive_3d(problem: TransientProblem3D, cfg,
                          t_final: float, tol: float = 1e-5,
                          dt0: Optional[float] = None,
                          max_attempts: int = 512,
                          checkpoint: Optional[str] = None,
                          checkpoint_chunk: int = 0,
                          device=None) -> AdaptiveMarchResult:
    """3D adaptive-dt Q1-hex march (tensor lift of
    ``fem_march_adaptive_2d``): the implicit operator's local matrix
    K_M + th dt K_A is built on the host from the attempt's dt (one
    scalar read an attempt), so each attempt is two Jacobi-CG solves."""
    with _span("march.setup"):
        dtype, _, K_A, K_M, g = _march_setup_3d(problem, cfg, "consistent",
                                                device)
        tolcg = _cg_tol(cfg, dtype)
        load_at = _load_at_3d(problem, g, K_M, False)

    def theta_solve(u, t, dt, th):
        with _span("march.fem_step"):
            K_lhs = K_M + th * float(dt) * K_A
            load = th * load_at(t + dt) + (1.0 - th) * load_at(t)
            r = (assembly3d.apply_stiffness_3d(u, K_M)
                 - (1.0 - th) * dt * assembly3d.apply_stiffness_3d(u, K_A)
                 + dt * load)
            x, _ = _free_solve_3d(
                K_lhs, r - assembly3d.apply_stiffness_3d(g.u_bc, K_lhs),
                g.interior, cfg, tolcg)
            return g.u_bc + x

    tf = torch.tensor(t_final, dtype=dtype, device=g.xs.device)
    tol_j = torch.tensor(tol, dtype=dtype, device=g.xs.device)
    u0 = _on_grid_3d(problem.u0, g, g.u_bc, dtype)
    (uN, tN, _, acc, rej, emax), _ = _adaptive_scan(
        _adaptive_attempt(theta_solve, tf, tol_j),
        _adaptive_carry0(u0, t_final, dt0, dtype), max_attempts, problem,
        cfg, _AdaptiveParams(t_final, tol, dt0, max_attempts),
        "fem_march_adaptive_3d", checkpoint, checkpoint_chunk)
    sol = TransientSolution3D(g.xs, g.ys, g.zs, uN, None, float(t_final), 0)
    return AdaptiveMarchResult(solution=sol, t_reached=tN, accepted=acc,
                               rejected=rej, max_err=emax)
