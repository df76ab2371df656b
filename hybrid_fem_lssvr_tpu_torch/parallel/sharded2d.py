"""Distributed 2D hybrid solve: element rows as y-slabs, or 2-axis blocks.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/parallel/sharded2d.py``.
Every rank of the mesh runs the JAX ``shard_map`` body on its own slab
(rows ``[row0, row0 + ny_loc]`` of the node grid, the interface rows
duplicated on both neighbours) or block:

* the coarse Q1 stage is a distributed Krylov solve: a matrix-free
  stiffness apply on the slab plus one halo exchange (``_halo_add``: the
  duplicated interface rows' partial sums, by two ``ppermute``), inner
  products masked to owned nodes and summed by ``psum``; the
  preconditioner is Jacobi, a distributed V-cycle (fine-level smoothing and
  restriction on the slabs, the coarser levels on the gathered
  half-resolution grid on every rank) or, on slabs, ADI through the
  all-to-all transpose;
* the enhancement solves each slab's element batch through the shared
  affine map (``kkt.solve_primal_shared``) or the per-element null-space
  algebra (``kkt.solve_batched``), with the domain-boundary masks driven by
  global row and column offsets.  As in the JAX package, no kernel runs
  here.

``distributed_fem=False`` solves the coarse stage whole on every rank.
``cfg.fem_dtype`` sets the dtype of the coarse stage, as in the port's
single-device ``hybrid_solve_2d``; the JAX module ignores it (equal when it
is unset).

Each ``make_sharded_*`` returns a callable that every rank calls together;
a rank's ``ShardedSolution2D`` holds its own rows, and
``collectives.gather_solution`` rebuilds the global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.hybrid2d import (
    Problem2D, Solver2DConfig, _bilinear_fallback_coeffs, _element_data_2d,
    _lifted_trace_2d, _varcoeff_element_operators, _varcoeff_mg_levels,
    fem_solve_2d, prepare_shared_2d,
)
from ..ops import assembly2d, cg, kkt, legendre, multigrid
from . import collectives as col
from .mesh import ELEMENT_AXIS, GRID_AXES, axis_size, mesh_device


class ShardedSolution2D(NamedTuple):
    """One rank's rows of the y-slab solve (JAX's ``P(axis)`` outputs)."""

    coeffs: torch.Tensor  # [ny_rank, nx, M, M] this rank's element rows
    fem_local: torch.Tensor  # [1, ny_loc+1, nx+1] this rank's slab
    solve_ok: torch.Tensor  # [ny_rank, nx]
    max_slack: torch.Tensor = None  # [ny_rank, nx]
    bc_violation: torch.Tensor = None  # [ny_rank, nx]
    cg_iters: torch.Tensor = None  # [1]
    cg_residual: torch.Tensor = None  # [1]

    def assemble_fem_grid(self, total_ny=None):
        """Stitch the overlapping slabs of a gathered solution
        (``gather_solution``) back into the [ny+1, nx+1] grid (numpy);
        ``total_ny`` strips padded tail rows."""
        fl = self.fem_local.detach().cpu().numpy()
        n_dev, nloc1, nx1 = fl.shape
        ny_loc = nloc1 - 1
        grid = np.zeros((n_dev * ny_loc + 1, nx1))
        for dd in range(n_dev):
            grid[dd * ny_loc:(dd + 1) * ny_loc + 1] = fl[dd]
        if total_ny is not None:
            grid = grid[: total_ny + 1]
        return grid


class ShardedSolution2DGrid(NamedTuple):
    """One rank's block of the 2-axis solve (JAX's ``P(ay, ax)``
    outputs); a convergence stall of the distributed CG shows in
    ``cg_iters`` / ``cg_residual``."""

    coeffs: torch.Tensor  # [ny_loc, nx_loc, M, M]
    fem_local: torch.Tensor  # [1, 1, ny_loc+1, nx_loc+1]
    solve_ok: torch.Tensor  # [ny_loc, nx_loc]
    max_slack: torch.Tensor = None
    bc_violation: torch.Tensor = None
    cg_iters: torch.Tensor = None  # [1, 1]
    cg_residual: torch.Tensor = None  # [1, 1]

    def assemble_fem_grid(self):
        """Stitch the overlapping blocks of a gathered solution into
        [ny+1, nx+1] (numpy)."""
        fl = self.fem_local.detach().cpu().numpy()
        n_dy, n_dx, nyl1, nxl1 = fl.shape
        nyl, nxl = nyl1 - 1, nxl1 - 1
        grid = np.zeros((n_dy * nyl + 1, n_dx * nxl + 1))
        for by in range(n_dy):
            for bx in range(n_dx):
                grid[by * nyl:(by + 1) * nyl + 1,
                     bx * nxl:(bx + 1) * nxl + 1] = fl[by, bx]
        return grid


# --------------------------------------------------------------------------
# Halos, restrictions and gathers
# --------------------------------------------------------------------------

def _halo_add(y_loc, d, n_dev, mesh, axis):
    """Sum duplicated-interface contributions across neighbouring slabs:
    after a local stiffness or load computation both owners of an
    interface row hold partial sums; two ``ppermute``s exchange them and
    both copies become the full sum."""
    up_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    dn_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    from_next = col.ppermute(y_loc[0], mesh, axis, up_perm)
    from_prev = col.ppermute(y_loc[-1], mesh, axis, dn_perm)
    y_loc = y_loc.clone()
    if d < n_dev - 1:
        y_loc[-1] += from_next
    if d > 0:
        y_loc[0] += from_prev
    return y_loc


def _fw_2d(r_ext):
    """Full weighting of a row-extended residual [2m+3, n+1] ->
    [m+1, n/2+1] (the row halos already on; the columns padded with
    zeros)."""
    rows = multigrid._fw_rows(r_ext)
    return multigrid._fw_rows(torch.nn.functional.pad(rows, (1, 1)).T).T


def _row_halos(res, dlo, n, mesh, axis):
    """(row below the slab, row above it) from the neighbours, zeros at
    the domain's edges."""
    up = [(i, (i + 1) % n) for i in range(n)]
    dn = [(i, (i - 1) % n) for i in range(n)]
    from_prev = col.ppermute(res[-2], mesh, axis, up)
    from_next = col.ppermute(res[1], mesh, axis, dn)
    if dlo == 0:
        from_prev = torch.zeros_like(from_prev)
    if dlo == n - 1:
        from_next = torch.zeros_like(from_next)
    return from_prev, from_next


def _restrict_slab(res, d, n_dev, mesh, axis):
    """Full-weighting restriction of a y-slab residual [nyl+1, nx+1] ->
    [nyl/2+1, nx/2+1]; the two row halos of the interface coarse nodes
    come by ``ppermute`` (R = P^T, as ``ops.multigrid``)."""
    from_prev, from_next = _row_halos(res, d, n_dev, mesh, axis)
    return _fw_2d(torch.cat([from_prev[None], res, from_next[None]]))


def _gather_grid(c_slab, n_dev, mesh, axis):
    """all_gather overlapping slabs [nc_loc+1, ...] (2D rows or 3D planes)
    into the whole grid [n_dev nc_loc + 1, ...] (the same on every
    rank)."""
    slabs = col.all_gather(c_slab, mesh, axis)
    return torch.cat([slabs[:, :-1].reshape((-1,) + tuple(slabs.shape[2:])),
                      slabs[n_dev - 1, -1:]])


def _restrict_block(res, dy, dx, n_dy, n_dx, mesh, ay, ax):
    """Full-weighting restriction of a 2-axis block residual
    [nyl+1, nxl+1] -> [nyl/2+1, nxl/2+1].  Rows are extended with the
    y-neighbours' halo rows first; the column exchange then runs on the
    row-extended array, so the corners it delivers are the diagonal
    neighbours' values."""
    from_prev, from_next = _row_halos(res, dy, n_dy, mesh, ay)
    r_ext = torch.cat([from_prev[None], res, from_next[None]])
    from_left, from_right = _row_halos(r_ext.T, dx, n_dx, mesh, ax)
    c_ext = torch.cat([from_left[:, None], r_ext, from_right[:, None]],
                      dim=1)  # [nyl+3, nxl+3]
    rows = multigrid._fw_rows(c_ext)
    return multigrid._fw_rows(rows.T).T


def _gather_grid_2d(c_block, n_dy, n_dx, mesh, ay, ax):
    """all_gather overlapping blocks [nyc_loc+1, nxc_loc+1] into the whole
    grid (columns within each row slab first, then rows)."""
    cols = col.all_gather(c_block, mesh, ax)  # [n_dx, nyl+1, nxl+1]
    row_slab = torch.cat([cols[i, :, :-1] for i in range(n_dx)]
                         + [cols[n_dx - 1, :, -1:]], dim=1)
    return _gather_grid(row_slab, n_dy, mesh, ay)


def _halo_add_2d(v, dy, dx, n_dy, n_dx, mesh, ay, ax):
    """Duplicated-interface sum for 2-axis blocks: a row exchange, then a
    column exchange on the row-summed block, which so carries the corner
    nodes' diagonal contributions too."""
    v = _halo_add(v, dy, n_dy, mesh, ay)
    return _halo_add(v.T, dx, n_dx, mesh, ax).T


# --------------------------------------------------------------------------
# The distributed coarse stage
# --------------------------------------------------------------------------

def _local_operator(problem, cfg, hx, hy, xs, ys, dtype):
    """The block's matrix-free operator: (apply_local, diag_local,
    (Sq, a_maps) or None, K_M or None), as ``hybrid2d.fem_solve_2d`` builds
    it on the whole grid (the compact scheme's load matrix K_M)."""
    shape1 = (ys.shape[0], xs.shape[0])
    device = xs.device
    if problem.a_var is not None:
        Sq, dxq, dyq = assembly2d.q1_varcoeff_parts(hx, hy)
        a_maps = assembly2d.coeff_maps(xs, ys, problem.a_var, dxq, dyq)
        K_const = None
        if problem.c != 0.0 or problem.b != (0.0, 0.0):
            K_const = assembly2d.q1_local_operator(hx, hy, 0.0, problem.c,
                                                   *problem.b)

        def apply_local(v):
            y = assembly2d.apply_stiffness_var(v, Sq, a_maps)
            if K_const is not None:
                y = y + assembly2d.apply_stiffness(v, K_const)
            return y

        diag = assembly2d.stiffness_var_diag(shape1, Sq, a_maps, dtype)
        if K_const is not None:
            diag = diag + assembly2d.stiffness_diag(shape1, K_const, dtype,
                                                    device)
        return apply_local, diag, (Sq, a_maps), None
    K_M = None
    if cfg.coarse == "compact":
        # Tensor-Numerov compact rows: the same 9-point local-4x4 sparsity
        # as Q1, so the same halo machinery carries the O(h^4) scheme.
        K_loc, K_M = assembly2d.q1_numerov_locals(hx, hy, problem.a0,
                                                  problem.c)
    else:
        K_loc = assembly2d.q1_local_operator(hx, hy, problem.a0, problem.c,
                                             *problem.b)

    def apply_local(v):
        return assembly2d.apply_stiffness(v, K_loc)

    return (apply_local, assembly2d.stiffness_diag(shape1, K_loc, dtype,
                                                   device), None, K_M)


def _fine_pc(problem, precond, var, hx, hy, dtype, shape1, varparts, halo,
             interior, apply_free, diag, device):
    """Fine-level operator of the distributed V-cycle: 'mg' cycles on the
    true operator; 'shifted' on the SPD c -> |c| operator (variable
    diffusion kept exactly).  Returns (apply_pc, diag_pc)."""
    if precond != "shifted":
        return apply_free, diag
    c_pc = abs(problem.c)
    bx, by = problem.b
    if var:
        Sq, a_maps = varparts
        K_shift = None
        if c_pc != 0.0 or bx != 0.0 or by != 0.0:
            K_shift = assembly2d.q1_local_operator(hx, hy, 0.0, c_pc, bx, by)

        def apply_pc_local(v):
            yv = assembly2d.apply_stiffness_var(v, Sq, a_maps)
            if K_shift is not None:
                yv = yv + assembly2d.apply_stiffness(v, K_shift)
            return yv

        diag_pc_l = assembly2d.stiffness_var_diag(shape1, Sq, a_maps, dtype)
        if K_shift is not None:
            diag_pc_l = diag_pc_l + assembly2d.stiffness_diag(
                shape1, K_shift, dtype, device)
    else:
        K_pc = assembly2d.q1_local_operator(hx, hy, problem.a0, c_pc, bx, by)

        def apply_pc_local(v):
            return assembly2d.apply_stiffness(v, K_pc)

        diag_pc_l = assembly2d.stiffness_diag(shape1, K_pc, dtype, device)

    def apply_pc(v):
        return torch.where(interior, halo(apply_pc_local(v * interior)), 0.0)

    return apply_pc, halo(diag_pc_l)


def _coarse_vcycle(problem, precond, var, hx, hy, dtype, nyc1, nxc1, device):
    """Serial V-cycle on the gathered coarse grid, one level below the
    distributed fine level (spacing 2x fine; per-level rediscretisation;
    c -> |c| under 'shifted')."""
    c_pc = problem.c if precond == "mg" else abs(problem.c)
    if var:
        return multigrid.make_vcycle(
            nyc1, nxc1, None, dtype, device=device,
            apply_diag_for_level=_varcoeff_mg_levels(
                problem, hx, hy, dtype, device, lvl_offset=1,
                c_override=c_pc),
        )

    def loc_for_level(lvl):
        s = 2.0 ** (lvl + 1)
        return assembly2d.q1_local_operator(hx * s, hy * s, problem.a0, c_pc,
                                            *problem.b)

    return multigrid.make_vcycle(nyc1, nxc1, loc_for_level(0), dtype,
                                 device=device, loc_for_level=loc_for_level)


def _distributed_vcycle(problem, precond, var, hx, hy, dtype, shape1,
                        varparts, halo, interior, apply_free, diag, restrict,
                        gather, coarse_shape, origin, device):
    """M_inv of the distributed V-cycle: two smoothing sweeps on the
    block, the restricted residual gathered, the serial cycle below it on
    every rank, this block's part of its correction prolonged, two more
    sweeps."""
    apply_pc, diag_pc = _fine_pc(problem, precond, var, hx, hy, dtype,
                                 shape1, varparts, halo, interior,
                                 apply_free, diag, device)
    serial_vcycle = _coarse_vcycle(problem, precond, var, hx, hy, dtype,
                                   coarse_shape[0], coarse_shape[1], device)
    r0c, c0c = origin
    nyc1 = (shape1[0] - 1) // 2 + 1
    nxc1 = (shape1[1] - 1) // 2 + 1
    omega, nu = 0.8, 2

    def smooth(u, r):
        for _ in range(nu):
            u = u + omega * torch.where(interior,
                                        (r - apply_pc(u)) / diag_pc, 0.0)
        return u

    def M_inv(r):
        u = smooth(torch.zeros_like(r), r)
        res_f = torch.where(interior, r - apply_pc(u), 0.0)
        ec_full = serial_vcycle(gather(restrict(res_f)))
        ec_blk = ec_full[r0c:r0c + nyc1, c0c:c0c + nxc1]
        u = u + torch.where(interior, multigrid.prolong_bilinear(ec_blk),
                            0.0)
        return smooth(u, r)

    return M_inv


def _spd(problem):
    """CG needs an SPD operator: no advection and c >= 0; BiCGStab else."""
    return all(v == 0.0 for v in problem.b) and problem.c >= 0.0


def _krylov(problem, cfg, apply_free, rhs, M_inv, dist_dot, dtype):
    tol = cfg.cg_tol
    if tol is None:
        tol = 100.0 * float(torch.finfo(dtype).eps)
    solver = cg.cg if _spd(problem) else cg.bicgstab
    return solver(apply_free, rhs, M_inv=M_inv, tol=tol,
                  maxiter=cfg.cg_maxiter, dot_fn=dist_dot)


def _dist_fem_solve_2d(problem: Problem2D, cfg: Solver2DConfig, d, n_dev,
                       mesh, axis, xs, ys_loc, row0):
    """Distributed Q1 coarse solve on y-slabs: a local matrix-free
    stiffness apply and one halo exchange per apply, ownership-masked
    ``psum`` inner products.  Returns the slab's nodal values
    [ny_loc+1, nx+1] and the Krylov result."""
    dtype, device = xs.dtype, xs.device
    ny_loc = ys_loc.shape[0] - 1
    nx1 = xs.shape[0]
    shape1 = (ny_loc + 1, nx1)
    hx = float((problem.domain[1] - problem.domain[0]) / cfg.nx)
    hy = float((problem.domain[3] - problem.domain[2]) / cfg.ny)
    var = problem.a_var is not None
    apply_local, diag_local, varparts, K_M = _local_operator(
        problem, cfg, hx, hy, xs, ys_loc, dtype)

    # Global interior mask of this slab's node rows; owned rows (the first
    # row belongs to the previous slab, except on rank 0).
    g_row = row0 + torch.arange(ny_loc + 1, device=device)
    row_int = (g_row > 0) & (g_row < cfg.ny)
    col_int = torch.zeros(nx1, dtype=torch.bool, device=device)
    col_int[1:-1] = True
    interior = row_int[:, None] & col_int[None, :]
    own = torch.ones((ny_loc + 1, 1), dtype=dtype, device=device)
    if d > 0:
        own[0] = 0.0

    def halo(v):
        return _halo_add(v, d, n_dev, mesh, axis)

    Y, X = torch.meshgrid(ys_loc, xs, indexing="ij")
    if K_M is not None:
        # Numerov-weighted load M f_nodal; the interface rows' neighbour
        # contributions arrive through the same halo exchange.
        F_nodes = problem.f(X, Y) * torch.ones_like(X)
        b = halo(assembly2d.apply_stiffness(F_nodes, K_M))
    else:
        b = halo(assembly2d.assemble_load(xs, ys_loc, problem.f))
    u_bc = torch.where(interior, 0.0, problem.g(X, Y) * torch.ones_like(X))

    def apply_full(v):
        return halo(apply_local(v))

    def apply_free(v):
        return torch.where(interior, apply_full(v * interior), 0.0)

    def dist_dot(u, v):
        return col.psum(torch.sum(u * v * own), mesh, axis)

    rhs = torch.where(interior, b - apply_full(u_bc), 0.0)
    diag = halo(diag_local)

    precond = cfg.precond
    if precond == "auto":
        if (cfg.ny % (2 * n_dev) == 0 and cfg.nx % 2 == 0
                and min(cfg.nx, cfg.ny) >= 8):
            precond = "mg" if problem.c >= 0.0 else "shifted"
        else:
            precond = "jacobi"
    if precond in ("mg", "shifted"):
        M_inv = _distributed_vcycle(
            problem, precond, var, hx, hy, dtype, shape1, varparts, halo,
            interior, apply_free, diag,
            restrict=lambda r: _restrict_slab(r, d, n_dev, mesh, axis),
            gather=lambda c: _gather_grid(c, n_dev, mesh, axis),
            coarse_shape=(cfg.ny // 2 + 1, cfg.nx // 2 + 1),
            origin=(row0 // 2, 0), device=device)
    elif precond == "adi":
        M_inv = _adi_preconditioner(cfg, hx, hy, d, n_dev, mesh, axis,
                                    row0, ny_loc, nx1, interior, dtype)
    else:
        M_inv = torch.where(interior, 1.0 / diag, 1.0)
    res = _krylov(problem, cfg, apply_free, rhs, M_inv, dist_dot, dtype)
    return u_bc + torch.where(interior, res.x, 0.0), res


def _adi_preconditioner(cfg, hx, hy, d, n_dev, mesh, axis, row0, ny_loc,
                        nx1, interior, dtype):
    """Distributed ADI (the Ulysses pattern): the slab's interior residual
    moves to x-slabs by the all-to-all block transpose, the line solves
    run with lines on the batch axis, and the pad-aware sweeps keep the
    divisibility padding exactly zero."""
    from .transpose import _local_transpose_block, adi_poisson_sweeps

    device = interior.device
    nx_int = cfg.nx - 1
    C_tot = -(-nx_int // n_dev) * n_dev
    tau = float(np.sqrt(np.pi**2 * 4.0 / min(hx, hy)**2))
    scale = 1.0 / (hx * hy)
    dn_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    row_ids = row0 + 1 + torch.arange(ny_loc, device=device)  # owned rows
    row_mask = (row_ids <= cfg.ny - 1).to(dtype)[:, None]

    def tp(a):
        return _local_transpose_block(a, mesh, axis, n_dev)

    def M_inv(r):
        r_int = r[1:, 1:cfg.nx] * scale * row_mask
        r_int = torch.nn.functional.pad(r_int, (0, C_tot - nx_int))
        u_int = adi_poisson_sweeps(r_int, hx, hy, tau, n_sweeps=1,
                                   transpose_fn=tp, transpose_fn_T=tp,
                                   true_shape=(cfg.ny - 1, nx_int))
        out = torch.zeros((ny_loc + 1, nx1), dtype=dtype, device=device)
        out[1:, 1:cfg.nx] = u_int[:, :nx_int]
        # Row 0 (global row row0) is the previous slab's last owned row.
        from_prev = col.ppermute(u_int[-1, :nx_int].contiguous(), mesh,
                                 axis, dn_perm)
        if d > 0:
            out[0, 1:cfg.nx] = from_prev
        return torch.where(interior, out, 0.0)

    return M_inv


# --------------------------------------------------------------------------
# The enhancement
# --------------------------------------------------------------------------

def _enhance_rows(problem, cfg, xs, ys, fem_loc, shared, t_int, bpts,
                  row0, col0=0, trace_rows=None, D=None):
    """Enhance a block's elements -> (coeffs [nyl, nxl, M, M], ok, slack,
    bcv), with the bilinear fallback where a solve failed."""
    nyl, nxl = ys.shape[0] - 1, xs.shape[0] - 1
    f_rows, bc_rows, corners = _element_data_2d(
        problem, cfg, xs, ys, fem_loc, t_int, bpts, row_offset=row0,
        col_offset=col0, trace_rows=trace_rows)
    if D is None and problem.a_var is not None:
        D = _varcoeff_element_operators(problem, cfg, xs, ys, shared, t_int)
    if D is not None:
        w, diags = kkt.solve_batched(
            D, shared.B, f_rows, bc_rows, cfg.gamma,
            formulation=cfg.formulation, ZP=(shared.Z, shared.Pbc))
    else:
        w, diags = kkt.solve_primal_shared(shared, f_rows, bc_rows)
    M = cfg.M
    coeffs = w.reshape(nyl, nxl, M, M)
    fb = _bilinear_fallback_coeffs(*corners, M)
    ok = diags.solve_ok.reshape(nyl, nxl)
    coeffs = torch.where(ok[..., None, None],
                         torch.where(torch.isfinite(coeffs), coeffs, 0.0), fb)
    return (coeffs, ok, diags.max_slack.reshape(nyl, nxl),
            diags.bc_violation.reshape(nyl, nxl))


def _cg_fields(res, lead, device):
    iters = torch.full(lead, int(res.iters), dtype=torch.int32,
                       device=device)
    return iters, res.residual.reshape(lead).to(device)


def _check_dirichlet(problem):
    if any(t != "dirichlet" for t in problem.bc_edges):
        raise NotImplementedError(
            "this path eliminates all boundary edges structurally "
            "(Dirichlet only); mixed-BC problems run on the "
            "single-device uniform path (HybridSolver2D)"
        )


def _check_compact(problem, cfg):
    if cfg.coarse == "compact":
        # The single-device compact scheme's constraints, checked when the
        # solve is built rather than degrading to Q1.
        if problem.a_var is not None:
            raise ValueError("coarse='compact' needs constant diffusion "
                             "(a_var is set); use coarse='q1'")
        if problem.b != (0.0, 0.0):
            raise ValueError("coarse='compact' requires b == (0, 0)")


def _fem_dtype(cfg, dtype):
    return getattr(torch, cfg.fem_dtype) if cfg.fem_dtype else dtype


def make_sharded_solve_2d(problem: Problem2D, cfg: Solver2DConfig, mesh,
                          axis: str = ELEMENT_AXIS,
                          distributed_fem: bool = True, device=None):
    """Distributed 2D solve on y-slabs (tail slabs padded when cfg.ny does
    not divide by the rank count).

    ``distributed_fem=True`` runs the coarse Krylov stage over the same
    slabs; ``False`` solves it whole on every rank.  ``cfg.coarse=
    'compact'`` swaps in the tensor-Numerov operator and load, and
    ``cfg.trace_lift >= 2`` lifts the trace on the gathered nodal grid
    (one ``all_gather``), sliced back to each slab's element rows.
    Returns a zero-argument callable that every rank calls together."""
    _check_dirichlet(problem)
    _check_compact(problem, cfg)
    n_dev = axis_size(mesh, axis)
    ny_loc = -(-cfg.ny // n_dev)  # ceil: tail slabs carry masked padding
    ny_pad = n_dev * ny_loc
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = _fem_dtype(cfg, dtype)
    shared, (t_int, bpts) = prepare_shared_2d(problem, cfg)
    shared = shared.to(device)
    x0, x1, y0, y1 = problem.domain

    def run() -> ShardedSolution2D:
        d = col.axis_index(mesh, axis)
        row0 = d * ny_loc
        hy = (y1 - y0) / cfg.ny
        # Padded node rows so every slab is in bounds; rows past cfg.ny are
        # masked by the global-row interior and boundary masks.
        ys = y0 + hy * torch.arange(ny_pad + 1, dtype=dtype, device=device)
        xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
        ys_loc = ys[row0:row0 + ny_loc + 1]
        if distributed_fem:
            fem_loc, cg_res = _dist_fem_solve_2d(
                problem, cfg, d, n_dev, mesh, axis, xs.to(fd),
                ys_loc.to(fd), row0)
        else:
            fem_values, cg_res = fem_solve_2d(problem, cfg, xs.to(fd),
                                              ys[:cfg.ny + 1].to(fd))
            fem_pad = torch.nn.functional.pad(fem_values,
                                              (0, 0, 0, ny_pad - cfg.ny))
            fem_loc = fem_pad[row0:row0 + ny_loc + 1]
        fem_loc = fem_loc.to(dtype)
        trace_rows = None
        if cfg.trace_lift >= 2:
            # The Lagrange windows need whole grid lines: gather the nodal
            # grid, lift on it, slice this slab's element rows.
            fem_full = _gather_grid(fem_loc, n_dev, mesh, axis)[:cfg.ny + 1]
            tr = _lifted_trace_2d(fem_full, cfg.M, cfg.nx, cfg.ny,
                                  stencil=cfg.trace_lift
                                  ).reshape(cfg.ny, cfg.nx, -1)
            tr = torch.nn.functional.pad(tr, (0, 0, 0, 0, 0, ny_pad - cfg.ny))
            trace_rows = tr[row0:row0 + ny_loc]
        coeffs, ok, slack, bcv = _enhance_rows(
            problem, cfg, xs, ys_loc, fem_loc, shared, t_int, bpts, row0,
            trace_rows=trace_rows)
        keep = max(0, min(ny_loc, cfg.ny - row0))  # strip padded rows
        iters, resid = _cg_fields(cg_res, (1,), device)
        return ShardedSolution2D(
            coeffs[:keep], fem_loc[None], ok[:keep], max_slack=slack[:keep],
            bc_violation=bcv[:keep], cg_iters=iters, cg_residual=resid)

    return run


def make_sharded_solve_2d_graded(problem: Problem2D, cfg: Solver2DConfig,
                                 mesh, xs, ys, axis: str = ELEMENT_AXIS,
                                 device=None):
    """Distributed graded tensor-product 2D solve on y-slabs: each slab
    builds its matrix-free reference-part operators from its own spacings
    (``hybrid2d_graded.graded_fem_parts``), runs the distributed Jacobi
    Krylov stage (graded meshes have no nested coarsening, so no V-cycle)
    and the per-element null-space enhancement.  Requires
    ``(len(ys) - 1) % n_ranks == 0``."""
    _check_dirichlet(problem)
    if cfg.coarse != "q1" or cfg.trace_lift >= 2:
        raise NotImplementedError(
            "graded meshes run the Q1/bilinear route (the compact scheme "
            "and the tangential lift assume uniform spacing)")
    from ..models.hybrid2d_graded import (
        _graded_element_operators, graded_fem_parts,
        prepare_shared_2d_graded,
    )

    n_dev = axis_size(mesh, axis)
    nx = len(xs) - 1
    ny = len(ys) - 1
    if ny % n_dev:
        raise ValueError(f"graded ny={ny} must divide by devices={n_dev}")
    ny_loc = ny // n_dev
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = _fem_dtype(cfg, dtype)
    cfg = dataclasses.replace(cfg, nx=nx, ny=ny)
    gops, (t_int, bpts) = prepare_shared_2d_graded(problem, cfg)
    gops = gops.to(device)
    xs_r = torch.as_tensor(np.asarray(xs), dtype=dtype, device=device)
    ys_r = torch.as_tensor(np.asarray(ys), dtype=dtype, device=device)
    # The coarse stage runs on the run dtype's node positions, as the
    # single-device graded solve does.
    xs_f, ys_f = xs_r.to(fd), ys_r.to(fd)

    def run() -> ShardedSolution2D:
        d = col.axis_index(mesh, axis)
        row0 = d * ny_loc
        ysf_loc = ys_f[row0:row0 + ny_loc + 1]
        Sq, a_maps = graded_fem_parts(problem, xs_f, ysf_loc)
        g_row = row0 + torch.arange(ny_loc + 1, device=device)
        row_int = (g_row > 0) & (g_row < ny)
        col_int = torch.zeros(nx + 1, dtype=torch.bool, device=device)
        col_int[1:-1] = True
        interior = row_int[:, None] & col_int[None, :]
        own = torch.ones((ny_loc + 1, 1), dtype=fd, device=device)
        if d > 0:
            own[0] = 0.0

        def halo(v):
            return _halo_add(v, d, n_dev, mesh, axis)

        b = halo(assembly2d.assemble_load(xs_f, ysf_loc, problem.f))
        Y, X = torch.meshgrid(ysf_loc, xs_f, indexing="ij")
        u_bc = torch.where(interior, 0.0,
                           problem.g(X, Y) * torch.ones_like(X))

        def apply_full(v):
            return halo(assembly2d.apply_stiffness_var(v, Sq, a_maps))

        def apply_free(v):
            return torch.where(interior, apply_full(v * interior), 0.0)

        def dist_dot(u, v):
            return col.psum(torch.sum(u * v * own), mesh, axis)

        rhs = torch.where(interior, b - apply_full(u_bc), 0.0)
        diag = halo(assembly2d.stiffness_var_diag((ny_loc + 1, nx + 1), Sq,
                                                  a_maps, fd))
        M_inv = torch.where(interior, 1.0 / diag, 1.0)
        res = _krylov(problem, cfg, apply_free, rhs, M_inv, dist_dot, fd)
        fem_loc = (u_bc + torch.where(interior, res.x, 0.0)).to(dtype)
        ys_loc = ys_r[row0:row0 + ny_loc + 1]
        D = _graded_element_operators(problem, cfg, xs_r, ys_loc, gops,
                                      t_int)
        coeffs, ok, slack, bcv = _enhance_rows(
            problem, cfg, xs_r, ys_loc, fem_loc, gops, t_int, bpts, row0,
            D=D)
        iters, resid = _cg_fields(res, (1,), device)
        return ShardedSolution2D(coeffs, fem_loc[None], ok, max_slack=slack,
                                 bc_violation=bcv, cg_iters=iters,
                                 cg_residual=resid)

    return run


def make_sharded_solve_2d_grid(problem: Problem2D, cfg: Solver2DConfig,
                               mesh, axes=None, device=None):
    """Distributed 2D solve on [ny/Dy, nx/Dx] blocks of a ``grid_mesh``:
    the coarse Krylov stage with a block-halo apply and inner products
    summed over both axes, preconditioned by the distributed V-cycle
    (block-halo restriction, gathered serial coarse levels) when the grid
    divides down; the enhancement with masks from global row and column
    offsets.  Requires cfg.ny % Dy == 0 and cfg.nx % Dx == 0."""
    _check_dirichlet(problem)
    _check_compact(problem, cfg)
    ay, ax = GRID_AXES if axes is None else axes
    n_dy, n_dx = axis_size(mesh, ay), axis_size(mesh, ax)
    if cfg.ny % n_dy or cfg.nx % n_dx:
        raise ValueError(
            f"ny={cfg.ny} / nx={cfg.nx} must divide by the mesh "
            f"({n_dy}, {n_dx})"
        )
    ny_loc, nx_loc = cfg.ny // n_dy, cfg.nx // n_dx
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = _fem_dtype(cfg, dtype)
    shared, (t_int, bpts) = prepare_shared_2d(problem, cfg)
    shared = shared.to(device)
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny
    var = problem.a_var is not None

    def axis_nodes(o, h, start, n, dt):
        return o + h * (start + torch.arange(n + 1, device=device)).to(dt)

    def run() -> ShardedSolution2DGrid:
        dy = col.axis_index(mesh, ay)
        dx = col.axis_index(mesh, ax)
        row0, col0 = dy * ny_loc, dx * nx_loc
        xs_f = axis_nodes(x0, hx, col0, nx_loc, fd)
        ys_f = axis_nodes(y0, hy, row0, ny_loc, fd)
        shape1 = (ny_loc + 1, nx_loc + 1)
        apply_local, diag_local, varparts, K_M = _local_operator(
            problem, cfg, hx, hy, xs_f, ys_f, fd)
        g_row = row0 + torch.arange(ny_loc + 1, device=device)
        g_col = col0 + torch.arange(nx_loc + 1, device=device)
        interior = (((g_row > 0) & (g_row < cfg.ny))[:, None]
                    & ((g_col > 0) & (g_col < cfg.nx))[None, :])
        own = torch.ones(shape1, dtype=fd, device=device)
        if dy > 0:
            own[0] = 0.0
        if dx > 0:
            own[:, 0] = 0.0

        def halo(v):
            return _halo_add_2d(v, dy, dx, n_dy, n_dx, mesh, ay, ax)

        Y, X = torch.meshgrid(ys_f, xs_f, indexing="ij")
        if K_M is not None:
            F_nodes = problem.f(X, Y) * torch.ones_like(X)
            b = halo(assembly2d.apply_stiffness(F_nodes, K_M))
        else:
            b = halo(assembly2d.assemble_load(xs_f, ys_f, problem.f))
        u_bc = torch.where(interior, 0.0,
                           problem.g(X, Y) * torch.ones_like(X))

        def apply_full(v):
            return halo(apply_local(v))

        def apply_free(v):
            return torch.where(interior, apply_full(v * interior), 0.0)

        def dist_dot(u, v):
            return col.psum(torch.sum(u * v * own), mesh, (ay, ax))

        rhs = torch.where(interior, b - apply_full(u_bc), 0.0)
        diag = halo(diag_local)
        precond = cfg.precond
        if precond == "auto":
            if (cfg.ny % (2 * n_dy) == 0 and cfg.nx % (2 * n_dx) == 0
                    and min(cfg.nx, cfg.ny) >= 8):
                precond = "mg" if problem.c >= 0.0 else "shifted"
            else:
                precond = "jacobi"
        if precond in ("mg", "shifted"):
            M_inv = _distributed_vcycle(
                problem, precond, var, hx, hy, fd, shape1, varparts, halo,
                interior, apply_free, diag,
                restrict=lambda r: _restrict_block(r, dy, dx, n_dy, n_dx,
                                                   mesh, ay, ax),
                gather=lambda c: _gather_grid_2d(c, n_dy, n_dx, mesh, ay,
                                                 ax),
                coarse_shape=(cfg.ny // 2 + 1, cfg.nx // 2 + 1),
                origin=(row0 // 2, col0 // 2), device=device)
        else:
            M_inv = torch.where(interior, 1.0 / diag, 1.0)
        res = _krylov(problem, cfg, apply_free, rhs, M_inv, dist_dot, fd)
        fem_loc = (u_bc + torch.where(interior, res.x, 0.0)).to(dtype)

        trace_rows = None
        if cfg.trace_lift >= 2:
            fem_full = _gather_grid_2d(fem_loc, n_dy, n_dx, mesh, ay, ax)
            tr = _lifted_trace_2d(fem_full, cfg.M, cfg.nx, cfg.ny,
                                  stencil=cfg.trace_lift
                                  ).reshape(cfg.ny, cfg.nx, -1)
            trace_rows = tr[row0:row0 + ny_loc, col0:col0 + nx_loc]
        xs_loc = axis_nodes(x0, hx, col0, nx_loc, dtype)
        ys_loc = axis_nodes(y0, hy, row0, ny_loc, dtype)
        coeffs, ok, slack, bcv = _enhance_rows(
            problem, cfg, xs_loc, ys_loc, fem_loc, shared, t_int, bpts,
            row0, col0, trace_rows=trace_rows)
        iters, resid = _cg_fields(res, (1, 1), device)
        return ShardedSolution2DGrid(
            coeffs, fem_loc[None, None], ok, max_slack=slack,
            bc_violation=bcv, cg_iters=iters, cg_residual=resid)

    return run


# --------------------------------------------------------------------------
# The distributed read paths
# --------------------------------------------------------------------------

def _eval_tensor(coeffs_loc, iy_l, ix_l, tx, ty, M):
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    W = coeffs_loc[iy_l, ix_l]  # [P, M, M]
    return torch.einsum("pk,pkl,pl->p", Vy, W, Vx)


def _uniform_index(v, o, h, n, dtype):
    i = torch.clamp(((v - o) / h).to(torch.int64), 0, n - 1)
    t = 2.0 * (v - (o + i.to(dtype) * h)) / h - 1.0
    return i, t


def make_sharded_evaluate_2d(problem: Problem2D, cfg: Solver2DConfig, mesh,
                             axis: str = ELEMENT_AXIS, device=None):
    """Distributed 2D read path: the query points are the same on every
    rank; each rank evaluates the points whose element row lies in its
    slab against its own coefficients, and one ``psum`` assembles the
    result (``hybrid2d.evaluate_2d``'s clamp).  Returns fn(coeffs_rank,
    x [P], y [P]) -> u [P], called by every rank together."""
    n_dev = axis_size(mesh, axis)
    ny_loc = -(-cfg.ny // n_dev)
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny

    def evaluate(coeffs, x, y):
        d = col.axis_index(mesh, axis)
        coeffs = coeffs.to(device)
        pad = ny_loc - coeffs.shape[0]
        if pad:
            coeffs = torch.nn.functional.pad(coeffs, (0, 0, 0, 0, 0, 0, 0,
                                                      pad))
        x = torch.as_tensor(x, dtype=dtype, device=device)
        y = torch.as_tensor(y, dtype=dtype, device=device)
        ix, tx = _uniform_index(x, x0, hx, cfg.nx, dtype)
        iy, ty = _uniform_index(y, y0, hy, cfg.ny, dtype)
        lo = d * ny_loc
        mine = (iy >= lo) & (iy < lo + ny_loc)
        iy_l = torch.clamp(iy - lo, 0, ny_loc - 1)
        val = _eval_tensor(coeffs, iy_l, ix, tx, ty, cfg.M)
        return col.psum(torch.where(mine, val, 0.0), mesh, axis)

    return evaluate


def make_sharded_evaluate_2d_grid(problem: Problem2D, cfg: Solver2DConfig,
                                  mesh, axes=None, device=None):
    """Distributed read path of the 2-axis solve: each rank evaluates the
    points whose element lies in its block; one ``psum`` over both axes."""
    ay, ax = GRID_AXES if axes is None else axes
    n_dy, n_dx = axis_size(mesh, ay), axis_size(mesh, ax)
    ny_loc, nx_loc = cfg.ny // n_dy, cfg.nx // n_dx
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1 = problem.domain
    hx = (x1 - x0) / cfg.nx
    hy = (y1 - y0) / cfg.ny

    def evaluate(coeffs, x, y):
        dy = col.axis_index(mesh, ay)
        dx = col.axis_index(mesh, ax)
        coeffs = coeffs.to(device)
        x = torch.as_tensor(x, dtype=dtype, device=device)
        y = torch.as_tensor(y, dtype=dtype, device=device)
        ix, tx = _uniform_index(x, x0, hx, cfg.nx, dtype)
        iy, ty = _uniform_index(y, y0, hy, cfg.ny, dtype)
        mine = ((iy >= dy * ny_loc) & (iy < (dy + 1) * ny_loc)
                & (ix >= dx * nx_loc) & (ix < (dx + 1) * nx_loc))
        iy_l = torch.clamp(iy - dy * ny_loc, 0, ny_loc - 1)
        ix_l = torch.clamp(ix - dx * nx_loc, 0, nx_loc - 1)
        val = _eval_tensor(coeffs, iy_l, ix_l, tx, ty, cfg.M)
        return col.psum(torch.where(mine, val, 0.0), mesh, (ay, ax))

    return evaluate


def _graded_index(nodes, v, n):
    i = torch.clamp(torch.searchsorted(nodes, v, right=True) - 1, 0, n - 1)
    t = (2.0 * v - nodes[i] - nodes[i + 1]) / (nodes[i + 1] - nodes[i])
    return i, t


def make_sharded_evaluate_2d_graded(cfg: Solver2DConfig, mesh, xs, ys,
                                    axis: str = ELEMENT_AXIS, device=None):
    """Distributed read path of the graded y-slab solve: each rank locates
    the points on the (replicated) node arrays, keeps those in its own
    element rows, and one ``psum`` assembles the result
    (``hybrid2d_graded.evaluate_2d_graded``'s clamp)."""
    n_dev = axis_size(mesh, axis)
    nx, ny = len(xs) - 1, len(ys) - 1
    if ny % n_dev:
        raise ValueError(f"graded ny={ny} must divide by devices={n_dev}")
    ny_loc = ny // n_dev
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    xs_t = torch.as_tensor(np.asarray(xs), dtype=dtype, device=device)
    ys_t = torch.as_tensor(np.asarray(ys), dtype=dtype, device=device)

    def evaluate(coeffs, x, y):
        d = col.axis_index(mesh, axis)
        coeffs = coeffs.to(device)
        x = torch.as_tensor(x, dtype=dtype, device=device)
        y = torch.as_tensor(y, dtype=dtype, device=device)
        ix, tx = _graded_index(xs_t, x, nx)
        iy, ty = _graded_index(ys_t, y, ny)
        lo = d * ny_loc
        mine = (iy >= lo) & (iy < lo + ny_loc)
        iy_l = torch.clamp(iy - lo, 0, ny_loc - 1)
        val = _eval_tensor(coeffs, iy_l, ix, tx, ty, cfg.M)
        return col.psum(torch.where(mine, val, 0.0), mesh, axis)

    return evaluate
