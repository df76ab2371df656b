"""Distributed 3D hybrid solve: element layers as z-slabs, (z, y) blocks,
or graded z-slabs.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/parallel/sharded3d.py``:
the 2D design of ``parallel/sharded2d.py`` one dimension up.  The coarse
Q1 hex stage is a distributed Krylov solve (one plane-halo exchange per
stiffness apply, ownership-masked ``psum`` inner products, the distributed
V-cycle with the coarser levels on the gathered half-resolution grid), and
the enhancement solves each slab's elements through the shared affine map
or the per-element null-space algebra, with the domain-boundary face masks
driven by global layer and row offsets.  As in the JAX package, no kernel
runs here.  ``cfg.fem_dtype`` sets the coarse stage's dtype, as in the
port's single-device ``hybrid_solve_3d`` (the JAX module ignores it).

Each ``make_sharded_*`` returns a callable that every rank calls together;
``collectives.gather_solution`` rebuilds the global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.hybrid3d import (
    Problem3D, Solver3DConfig, _element_data_3d, _lifted_trace_3d,
    _trilinear_fallback_coeffs, _varcoeff_element_operators_3d,
    _varcoeff_mg_levels_3d, fem_solve_3d, prepare_shared_3d,
)
from ..ops import assembly3d, kkt, legendre, multigrid
from . import collectives as col
from .mesh import ELEMENT_AXIS, GRID_AXES_3D, axis_size, mesh_device
from .sharded2d import (_cg_fields, _fem_dtype, _gather_grid, _graded_index,
                        _halo_add, _krylov, _row_halos, _uniform_index)


class ShardedSolution3D(NamedTuple):
    """One rank's layers of the z-slab solve (JAX's ``P(axis)``
    outputs)."""

    coeffs: torch.Tensor  # [nz_loc, ny, nx, M, M, M]
    fem_local: torch.Tensor  # [1, nz_loc+1, ny+1, nx+1]
    solve_ok: torch.Tensor  # [nz_loc, ny, nx]
    max_slack: torch.Tensor = None
    bc_violation: torch.Tensor = None
    cg_iters: torch.Tensor = None  # [1]
    cg_residual: torch.Tensor = None  # [1]

    def assemble_fem_grid(self):
        """Stitch the overlapping slabs of a gathered solution into
        [nz+1, ny+1, nx+1] (numpy)."""
        fl = self.fem_local.detach().cpu().numpy()
        n_dev, nloc1, ny1, nx1 = fl.shape
        nz_loc = nloc1 - 1
        grid = np.zeros((n_dev * nz_loc + 1, ny1, nx1))
        for dd in range(n_dev):
            grid[dd * nz_loc:(dd + 1) * nz_loc + 1] = fl[dd]
        return grid


class ShardedSolution3DGrid(NamedTuple):
    """One rank's (z, y) block (JAX's ``P(az, ay)`` outputs)."""

    coeffs: torch.Tensor  # [nz_loc, ny_loc, nx, M, M, M]
    fem_local: torch.Tensor  # [1, 1, nz_loc+1, ny_loc+1, nx+1]
    solve_ok: torch.Tensor  # [nz_loc, ny_loc, nx]
    max_slack: torch.Tensor = None
    bc_violation: torch.Tensor = None
    cg_iters: torch.Tensor = None  # [1, 1]
    cg_residual: torch.Tensor = None  # [1, 1]

    def assemble_fem_grid(self):
        """Stitch the overlapping blocks of a gathered solution into
        [nz+1, ny+1, nx+1] (numpy)."""
        fl = self.fem_local.detach().cpu().numpy()
        n_dz, n_dy, nzl1, nyl1, nx1 = fl.shape
        nz_loc, ny_loc = nzl1 - 1, nyl1 - 1
        grid = np.zeros((n_dz * nz_loc + 1, n_dy * ny_loc + 1, nx1))
        for dz in range(n_dz):
            for dy in range(n_dy):
                grid[dz * nz_loc:(dz + 1) * nz_loc + 1,
                     dy * ny_loc:(dy + 1) * ny_loc + 1] = fl[dz, dy]
        return grid


# --------------------------------------------------------------------------
# Halos, restrictions and gathers
# --------------------------------------------------------------------------

# The duplicated-interface z-plane sum across neighbouring slabs, and the
# gather of overlapping z-slabs: the 2D row versions on the leading axis.
_halo_add_3d = _halo_add
_gather_grid_3d = _gather_grid


def _halo_add_3d_grid(v, dz, dy, n_dz, n_dy, mesh, az, ay):
    """Duplicated-interface sum for (z, y) blocks: the z exchange first,
    then the y exchange on the z-summed planes, which so carries the edge
    nodes' diagonal contributions too."""
    v = _halo_add(v, dz, n_dz, mesh, az)
    return _halo_add(v.transpose(0, 1), dy, n_dy, mesh, ay).transpose(0, 1)


def _fw_axis(a, axis, pad):
    """Full weighting along ``axis`` (zero-padded first when ``pad``)."""
    t = a.movedim(axis, 0)
    if pad:
        t = F.pad(t, (0, 0, 0, 0, 1, 1))
    return multigrid._fw_rows(t).movedim(0, axis)


def _restrict_slab_3d(res, d, n_dev, mesh, axis):
    """Full-weighting restriction of a z-slab residual [nzl+1, ny+1, nx+1]
    -> [nzl/2+1, ny/2+1, nx/2+1]; the two plane halos of the interface
    coarse nodes come by ``ppermute``."""
    from_prev, from_next = _row_halos(res, d, n_dev, mesh, axis)
    r_ext = torch.cat([from_prev[None], res, from_next[None]])
    return _fw_axis(_fw_axis(multigrid._fw_rows(r_ext), 1, True), 2, True)


def _restrict_block_3d(res, dz, dy, n_dz, n_dy, mesh, az, ay):
    """Full-weighting restriction of a (z, y) block residual: the z halos
    first, then the y exchange on the z-extended array, so the edges it
    delivers are the diagonal neighbours' values; x and the domain's
    boundary sides extend with zeros."""
    from_prev, from_next = _row_halos(res, dz, n_dz, mesh, az)
    r_ext = torch.cat([from_prev[None], res, from_next[None]])
    below, above = _row_halos(r_ext.transpose(0, 1), dy, n_dy, mesh, ay)
    c_ext = torch.cat([below[:, None], r_ext, above[:, None]], dim=1)
    return _fw_axis(_fw_axis(multigrid._fw_rows(c_ext), 1, False), 2, True)


def _gather_grid_3d_blocks(c_block, n_dz, n_dy, mesh, az, ay):
    """all_gather overlapping (z, y) blocks into the whole grid (the y
    blocks of each z-slab first, then the z-slabs)."""
    cols = col.all_gather(c_block, mesh, ay)
    z_slab = torch.cat([cols[i, :, :-1] for i in range(n_dy)]
                       + [cols[n_dy - 1, :, -1:]], dim=1)
    return _gather_grid(z_slab, n_dz, mesh, az)


def _serial_coarse_vcycle_3d(problem, precond, var, hx, hy, hz, dtype, cfg,
                             device):
    """Serial 3D V-cycle on the gathered half-resolution grid: per-level
    rediscretisation, c -> |c| when 'shifted'."""
    c_eff = abs(problem.c) if precond == "shifted" else problem.c
    bx, by, bz = problem.b
    shape = (cfg.nz // 2 + 1, cfg.ny // 2 + 1, cfg.nx // 2 + 1)
    if var:
        return multigrid.make_vcycle_3d(
            *shape, None, dtype, device=device,
            apply_diag_for_level=_varcoeff_mg_levels_3d(
                problem, hx, hy, hz, dtype, device,
                c_override=(c_eff if precond == "shifted" else None),
                lvl_offset=1),
        )

    def loc_for_level(lvl):
        s = float(2 ** (lvl + 1))
        return assembly3d.q1_local_operator_3d(hx * s, hy * s, hz * s,
                                               problem.a0, c_eff, bx, by, bz)

    return multigrid.make_vcycle_3d(*shape, loc_for_level(0), dtype,
                                    device=device,
                                    loc_for_level=loc_for_level)


# --------------------------------------------------------------------------
# The distributed coarse stage
# --------------------------------------------------------------------------

def _local_operator_3d(problem, cfg, hx, hy, hz, xs, ys, zs, dtype,
                       c=None):
    """The block's matrix-free hex operator: (apply_local, diag_local,
    K_M or None); ``c`` replaces the reaction coefficient (the shifted
    preconditioner's c -> |c|)."""
    shape1 = (zs.shape[0], ys.shape[0], xs.shape[0])
    device = xs.device
    bx, by, bz = problem.b
    c = problem.c if c is None else c
    if problem.a_var is not None:
        Sq, dxq, dyq, dzq = assembly3d.q1_varcoeff_parts_3d(hx, hy, hz)
        a_maps = assembly3d.coeff_maps_3d(xs, ys, zs, problem.a_var, dxq,
                                          dyq, dzq)
        K_const = None
        if c != 0.0 or bx != 0.0 or by != 0.0 or bz != 0.0:
            K_const = assembly3d.q1_local_operator_3d(hx, hy, hz, 0.0, c,
                                                      bx, by, bz)

        def apply_local(v):
            y = assembly3d.apply_stiffness_var_3d(v, Sq, a_maps)
            if K_const is not None:
                y = y + assembly3d.apply_stiffness_3d(v, K_const)
            return y

        diag = assembly3d.stiffness_var_diag_3d(shape1, Sq, a_maps, dtype)
        if K_const is not None:
            diag = diag + assembly3d.stiffness_diag_3d(shape1, K_const,
                                                       dtype, device)
        return apply_local, diag, None
    K_M = None
    if cfg.coarse == "compact":
        # Tensor-Numerov compact rows: the same 27-point local-8x8
        # sparsity as Q1 hexes, so the same halo machinery applies.
        K_loc, K_M = assembly3d.q1_numerov_locals_3d(hx, hy, hz, problem.a0,
                                                     c)
    else:
        K_loc = assembly3d.q1_local_operator_3d(hx, hy, hz, problem.a0, c,
                                                bx, by, bz)

    def apply_local(v):
        return assembly3d.apply_stiffness_3d(v, K_loc)

    return (apply_local,
            assembly3d.stiffness_diag_3d(shape1, K_loc, dtype, device), K_M)


def _coarse_solve_3d(problem, cfg, xs, ys, zs, offsets, halo, psum_axes,
                     mesh, precond_ok, restrict=None, gather=None):
    """The distributed hex Krylov solve of one block: ``offsets`` = (lay0,
    row0) its global first layer and row, ``halo`` its duplicated-
    interface sum, ``precond_ok`` whether 'auto' may take the V-cycle
    (``restrict`` / ``gather`` its distributed half).  Returns the block's
    nodal values and the Krylov result."""
    dtype, device = xs.dtype, xs.device
    lay0, row0 = offsets
    shape1 = (zs.shape[0], ys.shape[0], xs.shape[0])
    hx = float((problem.domain[1] - problem.domain[0]) / cfg.nx)
    hy = float((problem.domain[3] - problem.domain[2]) / cfg.ny)
    hz = float((problem.domain[5] - problem.domain[4]) / cfg.nz)
    var = problem.a_var is not None
    apply_local, diag_local, K_M = _local_operator_3d(
        problem, cfg, hx, hy, hz, xs, ys, zs, dtype)
    g_lay = lay0 + torch.arange(shape1[0], device=device)
    g_row = row0 + torch.arange(shape1[1], device=device)
    x_int = torch.zeros(shape1[2], dtype=torch.bool, device=device)
    x_int[1:-1] = True
    interior = (((g_lay > 0) & (g_lay < cfg.nz))[:, None, None]
                & ((g_row > 0) & (g_row < cfg.ny))[None, :, None]
                & x_int[None, None, :])
    own = torch.ones(shape1[:2] + (1,), dtype=dtype, device=device)
    if lay0 > 0:  # the first plane / row belongs to the previous block
        own[0] = 0.0
    if row0 > 0:
        own[:, 0] = 0.0

    X, Y, Z = xs[None, None, :], ys[None, :, None], zs[:, None, None]
    ones = torch.ones(shape1, dtype=dtype, device=device)
    if K_M is not None:
        # Numerov-weighted load M f_nodal; interface planes receive the
        # neighbours' element contributions through the same halo.
        b = halo(assembly3d.apply_stiffness_3d(problem.f(X, Y, Z) * ones,
                                               K_M))
    else:
        b = halo(assembly3d.assemble_load_3d(xs, ys, zs, problem.f))
    u_bc = torch.where(interior, 0.0, problem.g(X, Y, Z) * ones)

    def apply_full(v):
        return halo(apply_local(v))

    def apply_free(v):
        return torch.where(interior, apply_full(v * interior), 0.0)

    def dist_dot(u, v):
        return col.psum(torch.sum(u * v * own), mesh, psum_axes)

    rhs = torch.where(interior, b - apply_full(u_bc), 0.0)
    diag = halo(diag_local)
    precond = cfg.precond
    if precond == "auto":
        precond = ("mg" if problem.c >= 0.0 else "shifted") if precond_ok \
            else "jacobi"
    if precond in ("mg", "shifted") and restrict is not None:
        if precond == "shifted":
            # The SPD-shifted Q1 operator (c -> |c|; variable diffusion
            # kept exactly).
            pc_local, pc_diag_l, _ = _local_operator_3d(
                problem, dataclasses.replace(cfg, coarse="q1"), hx, hy, hz,
                xs, ys, zs, dtype, c=abs(problem.c))

            def apply_pc(v):
                return torch.where(interior, halo(pc_local(v * interior)),
                                   0.0)

            diag_pc = halo(pc_diag_l)
        else:
            apply_pc, diag_pc = apply_free, diag
        serial_vcycle = _serial_coarse_vcycle_3d(problem, precond, var, hx,
                                                 hy, hz, dtype, cfg, device)
        nzc1 = (shape1[0] - 1) // 2 + 1
        nyc1 = (shape1[1] - 1) // 2 + 1
        lay0c, row0c = lay0 // 2, row0 // 2
        omega, nu = 0.8, 2

        def smooth(u, r):
            for _ in range(nu):
                u = u + omega * torch.where(
                    interior, (r - apply_pc(u)) / diag_pc, 0.0)
            return u

        def M_inv(r):
            u = smooth(torch.zeros_like(r), r)
            res_f = torch.where(interior, r - apply_pc(u), 0.0)
            ec_full = serial_vcycle(gather(restrict(res_f)))
            ec_blk = ec_full[lay0c:lay0c + nzc1, row0c:row0c + nyc1]
            u = u + torch.where(interior,
                                multigrid.prolong_trilinear(ec_blk), 0.0)
            return smooth(u, r)
    else:
        M_inv = torch.where(interior, 1.0 / diag, 1.0)
    res = _krylov(problem, cfg, apply_free, rhs, M_inv, dist_dot, dtype)
    return u_bc + torch.where(interior, res.x, 0.0), res


def _dist_fem_solve_3d(problem, cfg, d, n_dev, mesh, axis, xs, ys, zs_loc,
                       lay0):
    """Distributed Q1 hex coarse solve on z-slabs."""
    ok = (cfg.nz % (2 * n_dev) == 0 and cfg.nx % 2 == 0
          and cfg.ny % 2 == 0 and min(cfg.nx, cfg.ny, cfg.nz) >= 8)
    return _coarse_solve_3d(
        problem, cfg, xs, ys, zs_loc, (lay0, 0),
        lambda v: _halo_add_3d(v, d, n_dev, mesh, axis), axis, mesh, ok,
        restrict=lambda r: _restrict_slab_3d(r, d, n_dev, mesh, axis),
        gather=lambda c: _gather_grid_3d(c, n_dev, mesh, axis))


def _dist_fem_solve_3d_graded(problem, cfg, d, n_dev, mesh, axis, xs, ys,
                              zs_loc, lay0):
    """Distributed graded hex coarse solve on z-slabs: the reference-part
    assembly is slab-local (the geometric maps depend on the slab's own
    nodes); Jacobi preconditioning, as the single-device graded solve."""
    from ..models.hybrid3d_graded import graded_fem_parts_3d

    dtype, device = xs.dtype, xs.device
    nz_loc = zs_loc.shape[0] - 1
    shape1 = (nz_loc + 1, ys.shape[0], xs.shape[0])
    Sq, a_maps = graded_fem_parts_3d(problem, xs, ys, zs_loc)
    g_lay = lay0 + torch.arange(nz_loc + 1, device=device)
    lay_int = (g_lay > 0) & (g_lay < cfg.nz)
    yx_int = torch.zeros(shape1[1:], dtype=torch.bool, device=device)
    yx_int[1:-1, 1:-1] = True
    interior = lay_int[:, None, None] & yx_int[None]
    own = torch.ones((nz_loc + 1, 1, 1), dtype=dtype, device=device)
    if d > 0:
        own[0] = 0.0

    def halo(v):
        return _halo_add_3d(v, d, n_dev, mesh, axis)

    b = halo(assembly3d.assemble_load_3d(xs, ys, zs_loc, problem.f))
    X, Y, Z = xs[None, None, :], ys[None, :, None], zs_loc[:, None, None]
    g_grid = problem.g(X, Y, Z) * torch.ones(shape1, dtype=dtype,
                                             device=device)
    u_bc = torch.where(interior, 0.0, g_grid)

    def apply_full(v):
        return halo(assembly3d.apply_stiffness_var_3d(v, Sq, a_maps))

    def apply_free(v):
        return torch.where(interior, apply_full(v * interior), 0.0)

    def dist_dot(u, v):
        return col.psum(torch.sum(u * v * own), mesh, axis)

    rhs = torch.where(interior, b - apply_full(u_bc), 0.0)
    diag = halo(assembly3d.stiffness_var_diag_3d(shape1, Sq, a_maps, dtype))
    M_inv = torch.where(interior, 1.0 / diag, 1.0)
    res = _krylov(problem, cfg, apply_free, rhs, M_inv, dist_dot, dtype)
    return u_bc + torch.where(interior, res.x, 0.0), res


# --------------------------------------------------------------------------
# The enhancement and the entry points
# --------------------------------------------------------------------------

def _enhance_3d(problem, cfg, xs, ys, zs, fem_loc, shared, t_int, spts,
                lay0, row0=0, trace_rows=None, D=None, formulation=None):
    """Enhance a block's elements -> (coeffs [nzl, nyl, nx, M, M, M], ok,
    slack, bcv), with the trilinear fallback where a solve failed."""
    shp = (zs.shape[0] - 1, ys.shape[0] - 1, xs.shape[0] - 1)
    f_rows, bc_rows, cs = _element_data_3d(
        problem, cfg, xs, ys, zs, fem_loc, t_int, spts, layer_offset=lay0,
        row_offset=row0, trace_rows=trace_rows)
    if D is None and problem.a_var is not None:
        D = _varcoeff_element_operators_3d(problem, cfg, xs, ys, zs, shared,
                                           t_int)
    if D is not None:
        kw = {} if formulation is None else {"formulation": formulation}
        w, diags = kkt.solve_batched(D, shared.B, f_rows, bc_rows, cfg.gamma,
                                     ZP=(shared.Z, shared.Pbc), **kw)
    else:
        w, diags = kkt.solve_primal_shared(shared, f_rows, bc_rows)
    M = cfg.M
    coeffs = w.reshape(*shp, M, M, M)
    fb = _trilinear_fallback_coeffs(cs, M)
    ok = diags.solve_ok.reshape(shp)
    coeffs = torch.where(ok[..., None, None, None],
                         torch.where(torch.isfinite(coeffs), coeffs, 0.0), fb)
    return (coeffs, ok, diags.max_slack.reshape(shp),
            diags.bc_violation.reshape(shp))


def _check_dirichlet_3d(problem):
    if any(t != "dirichlet" for t in problem.bc_faces):
        raise NotImplementedError(
            "this path eliminates all boundary faces structurally "
            "(Dirichlet only); mixed-BC problems run on the "
            "single-device uniform path (HybridSolver3D)"
        )


def _check_3d(problem, cfg):
    _check_dirichlet_3d(problem)
    if cfg.coarse == "compact":
        if problem.a_var is not None:
            raise ValueError("coarse='compact' needs constant diffusion "
                             "(a_var is set); use coarse='q1'")
        if problem.b != (0.0, 0.0, 0.0):
            raise ValueError("coarse='compact' requires b == (0, 0, 0)")


def _lift_rows(fem_full, cfg, lay0, nz_loc, row0, ny_loc):
    tr = _lifted_trace_3d(fem_full, cfg.M, cfg.nx, cfg.ny, cfg.nz,
                          stencil=cfg.trace_lift
                          ).reshape(cfg.nz, cfg.ny, cfg.nx, -1)
    return tr[lay0:lay0 + nz_loc, row0:row0 + ny_loc]


def make_sharded_solve_3d(problem: Problem3D, cfg: Solver3DConfig, mesh,
                          axis: str = ELEMENT_AXIS,
                          distributed_fem: bool = True, device=None):
    """Distributed 3D solve on z-slabs; ``cfg.nz`` must divide by the rank
    count.  ``distributed_fem=False`` solves the coarse stage whole on
    every rank.  ``cfg.coarse='compact'`` and ``cfg.trace_lift >= 2`` (the
    plane lift on the gathered nodal grid) ride this path as in 2D.
    Returns a zero-argument callable that every rank calls together."""
    _check_3d(problem, cfg)
    n_dev = axis_size(mesh, axis)
    if cfg.nz % n_dev != 0:
        raise ValueError(f"nz={cfg.nz} must divide by the {n_dev}-device "
                         f"mesh")
    nz_loc = cfg.nz // n_dev
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = _fem_dtype(cfg, dtype)
    shared, (t_int, spts) = prepare_shared_3d(problem, cfg)
    shared = shared.to(device)
    x0, x1, y0, y1, z0, z1 = problem.domain

    def run() -> ShardedSolution3D:
        d = col.axis_index(mesh, axis)
        lay0 = d * nz_loc
        xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
        ys = torch.linspace(y0, y1, cfg.ny + 1, dtype=dtype, device=device)
        hz = (z1 - z0) / cfg.nz
        zs = z0 + hz * torch.arange(cfg.nz + 1, dtype=dtype, device=device)
        zs_loc = zs[lay0:lay0 + nz_loc + 1]
        if distributed_fem:
            fem_loc, cg_res = _dist_fem_solve_3d(
                problem, cfg, d, n_dev, mesh, axis, xs.to(fd), ys.to(fd),
                zs_loc.to(fd), lay0)
        else:
            fem_values, cg_res = fem_solve_3d(problem, cfg, xs.to(fd),
                                              ys.to(fd), zs.to(fd))
            fem_loc = fem_values[lay0:lay0 + nz_loc + 1]
        fem_loc = fem_loc.to(dtype)
        trace_rows = None
        if cfg.trace_lift >= 2:
            fem_full = _gather_grid_3d(fem_loc, n_dev, mesh, axis)
            trace_rows = _lift_rows(fem_full, cfg, lay0, nz_loc, 0, cfg.ny)
        coeffs, ok, slack, bcv = _enhance_3d(
            problem, cfg, xs, ys, zs_loc, fem_loc, shared, t_int, spts,
            lay0, trace_rows=trace_rows)
        iters, resid = _cg_fields(cg_res, (1,), device)
        return ShardedSolution3D(coeffs, fem_loc[None], ok, max_slack=slack,
                                 bc_violation=bcv, cg_iters=iters,
                                 cg_residual=resid)

    return run


def make_sharded_solve_3d_grid(problem: Problem3D, cfg: Solver3DConfig,
                               mesh, axes=None, device=None):
    """Distributed 3D solve on [nz/Dz, ny/Dy, nx] blocks of a
    ``grid_mesh_3d``: the coarse hex Krylov stage with a block-halo apply,
    inner products over both axes and the distributed V-cycle; the
    enhancement with face masks from global layer and row offsets.
    Requires cfg.nz % Dz == 0 and cfg.ny % Dy == 0."""
    _check_3d(problem, cfg)
    az, ay = GRID_AXES_3D if axes is None else axes
    n_dz, n_dy = axis_size(mesh, az), axis_size(mesh, ay)
    if cfg.nz % n_dz or cfg.ny % n_dy:
        raise ValueError(
            f"nz={cfg.nz} / ny={cfg.ny} must divide by the mesh "
            f"({n_dz}, {n_dy})"
        )
    nz_loc, ny_loc = cfg.nz // n_dz, cfg.ny // n_dy
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = _fem_dtype(cfg, dtype)
    shared, (t_int, spts) = prepare_shared_3d(problem, cfg)
    shared = shared.to(device)
    x0, x1, y0, y1, z0, z1 = problem.domain
    hy = (y1 - y0) / cfg.ny
    hz = (z1 - z0) / cfg.nz
    ok_mg = (cfg.nz % (2 * n_dz) == 0 and cfg.ny % (2 * n_dy) == 0
             and cfg.nx % 2 == 0 and min(cfg.nx, cfg.ny, cfg.nz) >= 8)

    def axis_nodes(o, h, start, n, dt):
        return o + h * (start + torch.arange(n + 1, device=device)).to(dt)

    def run() -> ShardedSolution3DGrid:
        dz = col.axis_index(mesh, az)
        dy = col.axis_index(mesh, ay)
        lay0, row0 = dz * nz_loc, dy * ny_loc
        xs = torch.linspace(x0, x1, cfg.nx + 1, dtype=dtype, device=device)
        ys_loc = axis_nodes(y0, hy, row0, ny_loc, dtype)
        zs_loc = axis_nodes(z0, hz, lay0, nz_loc, dtype)
        fem_loc, res = _coarse_solve_3d(
            problem, cfg, xs.to(fd), ys_loc.to(fd), zs_loc.to(fd),
            (lay0, row0),
            lambda v: _halo_add_3d_grid(v, dz, dy, n_dz, n_dy, mesh, az,
                                        ay),
            (az, ay), mesh, ok_mg,
            restrict=lambda r: _restrict_block_3d(r, dz, dy, n_dz, n_dy,
                                                  mesh, az, ay),
            gather=lambda c: _gather_grid_3d_blocks(c, n_dz, n_dy, mesh, az,
                                                    ay))
        fem_loc = fem_loc.to(dtype)
        trace_rows = None
        if cfg.trace_lift >= 2:
            fem_full = _gather_grid_3d_blocks(fem_loc, n_dz, n_dy, mesh, az,
                                              ay)
            trace_rows = _lift_rows(fem_full, cfg, lay0, nz_loc, row0,
                                    ny_loc)
        coeffs, ok, slack, bcv = _enhance_3d(
            problem, cfg, xs, ys_loc, zs_loc, fem_loc, shared, t_int, spts,
            lay0, row0, trace_rows=trace_rows)
        iters, resid = _cg_fields(res, (1, 1), device)
        return ShardedSolution3DGrid(
            coeffs, fem_loc[None, None], ok, max_slack=slack,
            bc_violation=bcv, cg_iters=iters, cg_residual=resid)

    return run


def make_sharded_solve_3d_graded(problem: Problem3D, cfg: Solver3DConfig,
                                 mesh, xs, ys, zs, axis: str = ELEMENT_AXIS,
                                 device=None):
    """Distributed graded 3D solve: z-slabs of a non-uniform tensor-product
    hex mesh.  ``len(zs) - 1`` must divide by the rank count; spacings are
    arbitrary."""
    _check_dirichlet_3d(problem)
    if cfg.coarse != "q1" or cfg.trace_lift >= 2:
        raise NotImplementedError(
            "graded meshes run the Q1/trilinear route (the compact scheme "
            "and the plane lift assume uniform spacing)")
    from ..models.hybrid3d_graded import (
        _graded_element_operators_3d, prepare_shared_3d_graded,
    )

    n_dev = axis_size(mesh, axis)
    nz = len(zs) - 1
    if nz % n_dev != 0:
        raise ValueError(f"nz={nz} element layers must divide by the "
                         f"{n_dev}-device mesh")
    nz_loc = nz // n_dev
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = _fem_dtype(cfg, dtype)
    cfg = dataclasses.replace(cfg, nx=len(xs) - 1, ny=len(ys) - 1, nz=nz)
    gops, (t_int, spts) = prepare_shared_3d_graded(problem, cfg)
    gops = gops.to(device)
    xs_r, ys_r, zs_r = (torch.as_tensor(np.asarray(v), dtype=dtype,
                                        device=device) for v in (xs, ys, zs))

    def run() -> ShardedSolution3D:
        d = col.axis_index(mesh, axis)
        lay0 = d * nz_loc
        zs_loc = zs_r[lay0:lay0 + nz_loc + 1]
        fem_loc, cg_res = _dist_fem_solve_3d_graded(
            problem, cfg, d, n_dev, mesh, axis, xs_r.to(fd), ys_r.to(fd),
            zs_loc.to(fd), lay0)
        fem_loc = fem_loc.to(dtype)
        D = _graded_element_operators_3d(problem, cfg, xs_r, ys_r, zs_loc,
                                         gops, t_int)
        coeffs, ok, slack, bcv = _enhance_3d(
            problem, cfg, xs_r, ys_r, zs_loc, fem_loc, gops, t_int, spts,
            lay0, D=D, formulation=cfg.formulation)
        iters, resid = _cg_fields(cg_res, (1,), device)
        return ShardedSolution3D(coeffs, fem_loc[None], ok, max_slack=slack,
                                 bc_violation=bcv, cg_iters=iters,
                                 cg_residual=resid)

    return run


# --------------------------------------------------------------------------
# The distributed read paths
# --------------------------------------------------------------------------

def _eval_tensor_3d(coeffs, iz, iy, ix, tz, ty, tx, M):
    (Vx,) = legendre.legendre_vandermonde(tx, M, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, M, num_derivs=0)
    (Vz,) = legendre.legendre_vandermonde(tz, M, num_derivs=0)
    W = coeffs[iz, iy, ix]  # [P, M, M, M]
    return torch.einsum("pk,pklm,pl,pm->p", Vz, W, Vy, Vx)


def _points(device, dtype, *vs):
    return [torch.as_tensor(v, dtype=dtype, device=device) for v in vs]


def make_sharded_evaluate_3d(problem: Problem3D, cfg: Solver3DConfig, mesh,
                             axis: str = ELEMENT_AXIS, device=None):
    """Distributed 3D read path: each rank evaluates the points whose
    element layer lies in its slab against its own coefficients; one
    ``psum`` assembles the result (``hybrid3d.evaluate_3d``'s clamp).
    Returns fn(coeffs_rank, x, y, z) -> u, called by every rank."""
    n_dev = axis_size(mesh, axis)
    nz_loc = cfg.nz // n_dev
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1, z0, z1 = problem.domain
    hx, hy, hz = (x1 - x0) / cfg.nx, (y1 - y0) / cfg.ny, (z1 - z0) / cfg.nz

    def evaluate(coeffs, x, y, z):
        d = col.axis_index(mesh, axis)
        x, y, z = _points(device, dtype, x, y, z)
        ix, tx = _uniform_index(x, x0, hx, cfg.nx, dtype)
        iy, ty = _uniform_index(y, y0, hy, cfg.ny, dtype)
        iz, tz = _uniform_index(z, z0, hz, cfg.nz, dtype)
        lo = d * nz_loc
        mine = (iz >= lo) & (iz < lo + nz_loc)
        iz_l = torch.clamp(iz - lo, 0, nz_loc - 1)
        val = _eval_tensor_3d(coeffs.to(device), iz_l, iy, ix, tz, ty, tx,
                              cfg.M)
        return col.psum(torch.where(mine, val, 0.0), mesh, axis)

    return evaluate


def make_sharded_evaluate_3d_grid(problem: Problem3D, cfg: Solver3DConfig,
                                  mesh, axes=None, device=None):
    """Distributed read path of the (z, y) block solve; one ``psum`` over
    both axes."""
    az, ay = GRID_AXES_3D if axes is None else axes
    n_dz, n_dy = axis_size(mesh, az), axis_size(mesh, ay)
    nz_loc, ny_loc = cfg.nz // n_dz, cfg.ny // n_dy
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    x0, x1, y0, y1, z0, z1 = problem.domain
    hx, hy, hz = (x1 - x0) / cfg.nx, (y1 - y0) / cfg.ny, (z1 - z0) / cfg.nz

    def evaluate(coeffs, x, y, z):
        dz = col.axis_index(mesh, az)
        dy = col.axis_index(mesh, ay)
        x, y, z = _points(device, dtype, x, y, z)
        ix, tx = _uniform_index(x, x0, hx, cfg.nx, dtype)
        iy, ty = _uniform_index(y, y0, hy, cfg.ny, dtype)
        iz, tz = _uniform_index(z, z0, hz, cfg.nz, dtype)
        mine = ((iz >= dz * nz_loc) & (iz < (dz + 1) * nz_loc)
                & (iy >= dy * ny_loc) & (iy < (dy + 1) * ny_loc))
        iz_l = torch.clamp(iz - dz * nz_loc, 0, nz_loc - 1)
        iy_l = torch.clamp(iy - dy * ny_loc, 0, ny_loc - 1)
        val = _eval_tensor_3d(coeffs.to(device), iz_l, iy_l, ix, tz, ty, tx,
                              cfg.M)
        return col.psum(torch.where(mine, val, 0.0), mesh, (az, ay))

    return evaluate


def make_sharded_evaluate_3d_graded(cfg: Solver3DConfig, mesh, xs, ys, zs,
                                    axis: str = ELEMENT_AXIS, device=None):
    """Distributed read path of the graded z-slab solve: each rank locates
    the points on the (replicated) node arrays, keeps those in its own
    layers, and one ``psum`` assembles the result."""
    n_dev = axis_size(mesh, axis)
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    if nz % n_dev:
        raise ValueError(f"graded nz={nz} must divide by devices={n_dev}")
    nz_loc = nz // n_dev
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    xs_t, ys_t, zs_t = (torch.as_tensor(np.asarray(v), dtype=dtype,
                                        device=device) for v in (xs, ys, zs))

    def evaluate(coeffs, x, y, z):
        d = col.axis_index(mesh, axis)
        x, y, z = _points(device, dtype, x, y, z)
        ix, tx = _graded_index(xs_t, x, nx)
        iy, ty = _graded_index(ys_t, y, ny)
        iz, tz = _graded_index(zs_t, z, nz)
        lo = d * nz_loc
        mine = (iz >= lo) & (iz < lo + nz_loc)
        iz_l = torch.clamp(iz - lo, 0, nz_loc - 1)
        val = _eval_tensor_3d(coeffs.to(device), iz_l, iy, ix, tz, ty, tx,
                              cfg.M)
        return col.psum(torch.where(mine, val, 0.0), mesh, axis)

    return evaluate
