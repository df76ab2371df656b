"""Distributed 1D hybrid solve: distributed assembly, SPIKE tridiagonal
solve and sharded enhancement, one shard of elements per rank.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/parallel/sharded.py``.  The
JAX ``shard_map`` body becomes the function every rank of the mesh runs on
its own contiguous element range; its collectives are those of
``parallel.collectives``:

* **Distributed assembly**: each rank computes its elements' 2x2 stiffness
  blocks (``ops.assembly.element_contributions``); the interface row's
  contribution arrives from the right neighbour in one ``ppermute``.
* **Distributed tridiagonal solve (SPIKE)**: local elimination with three
  right-hand sides (rhs and the two coupling spikes), one ``all_gather`` of
  six scalars a rank, the reduced system of size 2 n_dev solved on every
  rank, local back substitution.  The reduced system is solved by
  ``torch.linalg.solve`` on the host: JAX's unrolled pivoted Gauss
  (``tridiag.gauss_small``) exists only because LU did not compile in the
  TPU's emulated float64.
* **Sharded enhancement**: every rank enhances its own elements; the one
  remote value it needs, the left interface node, is in the reduced
  solution already.  On the card the per-shard enhancement is one launch of
  ``fused_enhance_separable`` (constant coefficients, separable rhs; the
  shard's left edge ``x0 + d E_loc h`` is an input) or of
  ``fused_enhance_varcoeff`` in graded mode (per-element operators; the
  shard's nodes are an input).

``enhance_backend``: 'auto' runs those kernel wrappers when the run is
float32 on the card (on the CPU, any dtype: the wrappers' plain versions),
and the torch route where neither kernel applies, as JAX does; 'cuda'
insists on the kernels (CUDA tensors) and raises, naming the unmet
condition, where neither applies; 'torch' takes the batched torch route
(JAX's 'xla').  JAX's 'pallas-interpret' is what the plain versions stand
for on the CPU.

Dropped from the JAX module: the ``pick_tile(E_loc) >= 128`` gate in front
of each kernel (the CUDA kernels mask the ragged edge, so any shard size
runs) and ``require_x64`` on ``fem_dtype`` (float64 is native here).

Dirichlet rows are eliminated before distribution: the interior system
has E - 1 unknowns, padded with identity rows to n_dev E_loc, so that every
rank owns E_loc = ceil(E / n_dev) rows; the padding is sliced off again.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.hybrid import (SolverConfig, _kernel_finalize, lssvr_enhance,
                             prepare_shared_host)
from ..models.problem import Problem1D
from ..ops import assembly, kernels, legendre, tridiag
from . import collectives as col
from .mesh import ELEMENT_AXIS, axis_size, mesh_device


class ShardedSolution(NamedTuple):
    """One rank's part of the distributed solve;
    ``collectives.gather_solution`` joins
    the parts into the global arrays (coeffs [E, M], fem_local
    [n_dev, E_loc + 1], the diagnostics [E])."""

    coeffs: torch.Tensor  # [E_rank, M] this rank's elements
    fem_local: torch.Tensor  # [1, E_loc + 1] this rank's nodal values
    max_slack: torch.Tensor  # [E_rank]
    bc_violation: torch.Tensor  # [E_rank]
    solve_ok: torch.Tensor  # [E_rank]


def _local_nodes(problem, E_total, E_loc, d, dtype, device):
    x0, x1 = problem.domain
    h = (x1 - x0) / E_total
    base = x0 + torch.tensor(float(d * E_loc), dtype=dtype,
                             device=device) * h
    idx = torch.arange(E_loc + 1, dtype=dtype, device=device)
    return base + idx * h


def _local_assembly(problem, cfg, nodes_loc, d, n_dev, mesh, axis, E_total):
    """Local rows of the Dirichlet-eliminated interior tridiagonal system.

    Rank d owns interior rows [d E_loc, (d+1) E_loc) of the padded system
    (interior node j = row + 1); returns the local diagonals (a, b, c), the
    rhs and the SPIKE couplings (l to the left neighbour's last unknown, u
    to the right neighbour's first unknown).
    """
    dtype, device = nodes_loc.dtype, nodes_loc.device
    E_loc = nodes_loc.shape[0] - 1
    K, bvec = assembly.element_contributions(
        nodes_loc, problem.a, problem.b, problem.c, problem.f,
        quad_order=cfg.fem_quad_order,
    )  # [E_loc, 2, 2], [E_loc, 2]

    # Halo: row r needs element r+1's (K00, K01, b0); the last row needs the
    # right neighbour's first element -> one ppermute shifting left.
    first_elem = torch.stack([K[0, 0, 0], K[0, 0, 1], bvec[0, 0]])
    halo = col.ppermute(first_elem, mesh, axis,
                        [(i, (i - 1) % n_dev) for i in range(n_dev)])
    K00_next = torch.cat([K[1:, 0, 0], halo[0:1]])
    K01_next = torch.cat([K[1:, 0, 1], halo[1:2]])
    b0_next = torch.cat([bvec[1:, 0], halo[2:3]])

    diag = K[:, 1, 1] + K00_next
    sub = K[:, 1, 0].clone()  # couples row r to interior unknown r-1
    sup = K01_next  # couples row r to interior unknown r+1
    rhs = bvec[:, 1] + b0_next

    g_l = float(problem.g_left)
    g_r = float(problem.g_right)
    is_first = d == 0
    # Global padded interior index of each local row: interior unknowns are
    # nodes 1..E_total-1 (indices 0..E_total-2); rows at or past E_total-1
    # are dummy padding (tail slabs when E_total does not divide evenly).
    i_glob = d * E_loc + torch.arange(E_loc, device=device)
    dummy = i_glob >= E_total - 1
    last_true = i_glob == E_total - 2  # couples to the right boundary node

    # Dirichlet column elimination.
    if is_first:
        rhs = rhs.clone()
        rhs[0] = rhs[0] - sub[0] * g_l
    rhs = rhs + torch.where(last_true, -sup * g_r, 0.0)
    diag = torch.where(dummy, 1.0, diag)
    rhs = torch.where(dummy, 0.0, rhs)
    sub = torch.where(dummy, 0.0, sub)
    sup = torch.where(dummy | last_true, 0.0, sup)

    # SPIKE couplings: strip the inter-rank entries out of the local block.
    zero = torch.zeros((), dtype=dtype, device=device)
    i_last = d * E_loc + E_loc - 1  # the last row's global index
    l_coup = zero if (is_first or d * E_loc >= E_total - 1) else sub[0]
    u_coup = zero if i_last >= E_total - 2 else sup[-1]
    sub = sub.clone()
    sup = sup.clone()
    sub[0] = 0.0
    sup[-1] = 0.0
    return sub, diag, sup, rhs, l_coup, u_coup


def _spike_solve(sub, diag, sup, rhs, l_coup, u_coup, d, n_dev, mesh, axis):
    """Distributed tridiagonal solve; returns the local interior unknowns
    and the left-interface value (the left neighbour's last unknown)."""
    E_loc = diag.shape[0]
    dtype, device = diag.dtype, diag.device
    e0 = torch.zeros(E_loc, dtype=dtype, device=device)
    e0[0] = 1.0
    eR = torch.zeros(E_loc, dtype=dtype, device=device)
    eR[-1] = 1.0
    rhs3 = torch.stack([rhs, l_coup * e0, u_coup * eR], dim=1)  # [E_loc, 3]
    # 'auto': Thomas for small slabs, blocked SPIKE beyond 8192 rows.
    sol3 = tridiag.solve(sub, diag, sup, rhs3, method="auto")
    g, v, w = sol3[:, 0], sol3[:, 1], sol3[:, 2]

    # Reduced system over the boundary unknowns (x_first, x_last) of each
    # rank:
    #   x_first + v[0] x_last(d-1)  + w[0] x_first(d+1)  = g[0]
    #   x_last  + v[-1] x_last(d-1) + w[-1] x_first(d+1) = g[-1]
    locals6 = torch.stack([v[0], v[-1], w[0], w[-1], g[0], g[-1]])
    allv = col.all_gather(locals6, mesh, axis).cpu()  # [n_dev, 6]
    n2 = 2 * n_dev
    R = torch.eye(n2, dtype=dtype)
    rr = torch.zeros(n2, dtype=dtype)
    for dd in range(n_dev):
        v1, vR, w1, wR, g1, gR = allv[dd]
        if dd > 0:
            R[2 * dd, 2 * (dd - 1) + 1] = v1
            R[2 * dd + 1, 2 * (dd - 1) + 1] = vR
        if dd < n_dev - 1:
            R[2 * dd, 2 * (dd + 1)] = w1
            R[2 * dd + 1, 2 * (dd + 1)] = wR
        rr[2 * dd] = g1
        rr[2 * dd + 1] = gR
    y = torch.linalg.solve(R, rr)  # 2 n_dev unknowns, on every rank
    xl = float(y[2 * (d - 1) + 1]) if d > 0 else 0.0
    xr = float(y[2 * (d + 1)]) if d < n_dev - 1 else 0.0
    x_loc = g - v * xl - w * xr
    return x_loc, xl


def shard_x0(x0, d, E_loc, h, dtype):
    """Left edge of shard ``d``, x0 + d E_loc h, rounded in the run dtype
    as JAX traces it: the separable kernel's ``x0`` on that shard."""
    return float(torch.tensor(x0, dtype=dtype)
                 + torch.tensor(float(d * E_loc), dtype=dtype)
                 * torch.tensor(h, dtype=dtype))


def _kernel_route(enhance_backend, cfg, device, problem, shared):
    """Which per-shard kernel the enhancement launches: 'separable',
    'varcoeff' or None (the batched torch route).  'cuda' raises where
    neither kernel applies; 'auto' falls through to torch, as JAX does."""
    if enhance_backend not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown enhance_backend: {enhance_backend!r}")
    if enhance_backend == "torch" or (
            enhance_backend == "auto"
            and (cfg.backend not in ("auto", "cuda")
                 or (device.type != "cpu"
                     and cfg.torch_dtype() != torch.float32))):
        return None
    if shared is not None:
        unmet = [name for name, ok in (
            ("shared operators with the separable-rhs block (WfF)",
             shared.WfF is not None),
            ("problem.f_elem_factors", problem.f_elem_factors is not None),
            ("cfg.diagnostics", cfg.diagnostics)) if not ok]
        route = "separable"
    else:
        unmet = [name for name, ok in (
            ("M >= 3", cfg.M >= 3),
            ("kkt_method 'auto' or 'qr'", cfg.kkt_method in ("auto", "qr")),
        ) if not ok]
        route = "varcoeff"
    if enhance_backend == "auto":
        return None if unmet else route
    if unmet:
        raise ValueError(
            f"enhance_backend='cuda': the {route} kernel needs "
            + ", ".join(unmet))
    if device.type != "cuda":
        raise ValueError(
            f"enhance_backend='cuda' needs CUDA tensors, got {device}")
    return route


def make_sharded_solve(problem: Problem1D, cfg: SolverConfig, mesh,
                       axis: str = ELEMENT_AXIS,
                       enhance_backend: str = "auto", device=None):
    """Build the distributed 1D hybrid solve over ``mesh``.

    Uniform mesh; any element count (tail shards carry identity padding
    when E does not divide by the rank count; the padding is sliced off).
    Dirichlet only.  ``cfg.fem_dtype`` sets the dtype of the assembly and
    the SPIKE solve.  Returns a zero-argument callable that every rank of
    the mesh calls together; it returns this rank's ``ShardedSolution``.
    ``device``: None is the rank's card (``mesh_device``); the CPU runs
    only when asked for.
    """
    n_dev = axis_size(mesh, axis)
    E_total = cfg.num_nodes - 1
    E_loc = -(-E_total // n_dev)  # ceil: tail shards carry dummy padding
    if E_loc < 2:
        raise ValueError("need at least 2 elements per device")
    if problem.bc_left != "dirichlet" or problem.bc_right != "dirichlet":
        raise NotImplementedError(
            "the distributed 1D solve eliminates boundary unknowns "
            "structurally (Dirichlet only); Neumann/Robin problems run "
            "on the single-device path (models.hybrid.HybridSolver)"
        )
    device = mesh_device(device)
    dtype = cfg.torch_dtype()
    fd = getattr(torch, cfg.fem_dtype) if cfg.fem_dtype is not None \
        else dtype
    shared = prepare_shared_host(problem, cfg)
    if shared is not None:
        shared = shared.to(device)
    route = _kernel_route(enhance_backend, cfg, device, problem, shared)
    torch_cfg = dataclasses.replace(cfg, backend="torch")
    x0g, x1g = problem.domain
    h = (x1g - x0g) / E_total

    def run() -> ShardedSolution:
        d = col.axis_index(mesh, axis)
        nodes_f = _local_nodes(problem, E_total, E_loc, d, fd, device)
        sub, diag, sup, rhs, l_coup, u_coup = _local_assembly(
            problem, cfg, nodes_f, d, n_dev, mesh, axis, E_total)
        x_loc, xl = _spike_solve(sub, diag, sup, rhs, l_coup, u_coup, d,
                                 n_dev, mesh, axis)
        nodes_loc = nodes_f.to(dtype)
        # Local nodal values (E_loc + 1): left interface then the local
        # interior; the edge ranks' outermost values are the Dirichlet data.
        left_val = float(problem.g_left) if d == 0 else xl
        fem_loc = torch.cat([
            torch.full((1,), left_val, dtype=fd, device=device), x_loc,
        ]).to(dtype)
        # The right boundary node may sit mid-shard when E does not divide
        # evenly: mask by global node id.
        node_ids = d * E_loc + torch.arange(E_loc + 1, device=device)
        fem_loc = torch.where(
            node_ids == E_total,
            torch.tensor(float(problem.g_right), dtype=fd).to(dtype),
            fem_loc)
        if route == "separable":
            w, slack, bcv, okf = kernels.fused_enhance_separable(
                fem_loc, shared, problem.f_elem_factors,
                shard_x0(x0g, d, E_loc, h, dtype), h,
                with_fallback=True)
            out = (w, slack, bcv, okf > 0.5)
        elif route == "varcoeff":
            # Graded mode: the shard's nodes are the kernel's input, so every
            # shard runs the same kernel; h is the true width (rho == 1).
            host = kernels.VarCoeffOperators.host(
                cfg.M, cfg.n_colloc, h, dtype).to(device)
            w, slack, bcv, cond = kernels.fused_enhance_varcoeff(
                fem_loc, problem, host, x0g, h, cfg.n_colloc,
                with_diagnostics=cfg.diagnostics, nodes=nodes_loc)
            w, diags = _kernel_finalize(w, slack, bcv, fem_loc[:-1],
                                        fem_loc[1:], cfg, cond=cond)
            out = (w, diags.max_slack, diags.bc_violation, diags.solve_ok)
        else:
            w, diags = lssvr_enhance(
                problem, nodes_loc, fem_loc, torch_cfg, shared_ops=shared,
                touches_left=(d == 0), touches_right=False)
            out = (w, diags.max_slack, diags.bc_violation, diags.solve_ok)
        # Strip padded tail elements (present when E % n_dev != 0).
        keep = max(0, min(E_loc, E_total - d * E_loc))
        w, slack, bcv, ok = (v[:keep] for v in out)
        return ShardedSolution(w, fem_loc[None], slack, bcv, ok)

    return run


def make_sharded_evaluate(problem: Problem1D, cfg: SolverConfig, mesh,
                          axis: str = ELEMENT_AXIS, device=None):
    """Distributed read path: the query points are the same on every rank;
    each rank evaluates only the points inside its element range against
    its own coefficients, and one ``psum`` assembles the result (the
    reference's clamp through the global element clip).

    Returns fn(coeffs_rank [E_rank, M], x [P]) -> u [P], the same on every
    rank; every rank calls it together with its ``ShardedSolution.coeffs``.
    """
    n_dev = axis_size(mesh, axis)
    E_total = cfg.num_nodes - 1
    E_loc = -(-E_total // n_dev)
    dtype = cfg.torch_dtype()
    device = mesh_device(device)
    x0, x1 = problem.domain
    h = (x1 - x0) / E_total

    def evaluate(coeffs, x):
        d = col.axis_index(mesh, axis)
        coeffs = coeffs.to(device)
        pad = E_loc - coeffs.shape[0]
        if pad:
            coeffs = torch.cat([coeffs, coeffs.new_zeros(pad,
                                                         coeffs.shape[1])])
        x = torch.as_tensor(x, dtype=dtype, device=device)
        e = torch.clamp(((x - x0) / h).to(torch.int64), 0, E_total - 1)
        lo = d * E_loc
        mine = (e >= lo) & (e < lo + E_loc)
        e_loc = torch.clamp(e - lo, 0, E_loc - 1)
        xl = torch.tensor(x0, dtype=dtype, device=device) \
            + e.to(dtype) * torch.tensor(h, dtype=dtype, device=device)
        t = (2.0 * (x - xl)) / h - 1.0
        val = legendre.evaluate_series(coeffs[e_loc], t)
        return col.psum(torch.where(mine, val, 0.0), mesh, axis)

    return evaluate
