"""Geometric multigrid V-cycle preconditioners for the 2D and 3D Q1 coarse
solves.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/multigrid.py``.  A
standard V-cycle — weighted-Jacobi smoothing, full-weighting
restriction R = P^T, bilinear prolongation, rediscretised coarse operators —
bounds the preconditioned CG iteration count independently of the mesh
size, where Jacobi-CG grows like O(N).

Everything is slicing and stencil arithmetic on the node grid.  Restriction
and prolongation use strided slices (the JAX module's pair-deinterleaving
reshapes work around a TPU lowering and compute the same values).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import assembly2d, assembly3d


def _fw_rows(x: torch.Tensor) -> torch.Tensor:
    """1D full weighting along axis 0 of an odd-length (padded) array:
    y[i] = (x[2i] + 2 x[2i+1] + x[2i+2]) / 2."""
    return 0.5 * (x[0:-2:2] + 2.0 * x[1:-1:2] + x[2::2])


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """[nf+1, nf+1] fine-grid residual -> [nf/2+1, nf/2+1] via R = P^T
    (stencil [1 2 1; 2 4 2; 1 2 1]/4, applied separably per axis).  With
    bilinear P the coarse Q1 space is nested in the fine one and P^T A P is
    the coarse Q1 stiffness, so R must be P^T exactly."""
    rp = F.pad(r, (1, 1, 1, 1))
    return _fw_rows(_fw_rows(rp).T).T


def _interleave_rows(xe: torch.Tensor, xo: torch.Tensor) -> torch.Tensor:
    """[m+1, ...] even rows + [m, ...] odd rows -> [2m+1, ...]."""
    out = xe.new_empty((xe.shape[0] + xo.shape[0],) + tuple(xe.shape[1:]))
    out[0::2] = xe
    out[1::2] = xo
    return out


def prolong_bilinear(c: torch.Tensor) -> torch.Tensor:
    """[nc+1, nc+1] coarse field -> [2nc+1, 2nc+1] bilinear interpolation
    (separable interleave per axis)."""
    top = _interleave_rows(c.T, 0.5 * (c[:, :-1] + c[:, 1:]).T).T
    return _interleave_rows(top, 0.5 * (top[:-1] + top[1:]))


def _interior(shape, device):
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def make_vcycle(ny1: int, nx1: int, K_loc, dtype, nu: int = 2,
                omega: float = 0.8, coarsest: int = 5,
                coarse_sweeps: int = 60, loc_for_level=None,
                apply_diag_for_level=None, device=None):
    """Build M_inv(r): one V(nu, nu) cycle on the Dirichlet-interior system.

    Requires (ny1-1, nx1-1) divisible by 2 down to the coarsest level; the
    2D Laplacian's Q1 stiffness is scale-invariant for fixed aspect ratio,
    so by default ``K_loc`` (a host [4, 4] array) is reused on every level.
    For operators with mass or convection terms (which scale with h), pass
    ``loc_for_level(lvl)`` returning the rediscretised local 4x4 at level
    ``lvl`` (spacing ``2**lvl`` times the fine spacing).  For operators
    without a shared local 4x4 (variable coefficients), pass
    ``apply_diag_for_level(lvl, shape)`` returning ``(apply_fn,
    diag_tensor)`` — the exact rediscretisation per level.  ``device`` is
    where the masks and diagonals are built (the residuals' device)."""
    shapes = [(ny1, nx1)]
    while (
        (shapes[-1][0] - 1) % 2 == 0
        and (shapes[-1][1] - 1) % 2 == 0
        and min(shapes[-1]) - 1 > coarsest
    ):
        shapes.append(((shapes[-1][0] - 1) // 2 + 1,
                       (shapes[-1][1] - 1) // 2 + 1))
    masks = [_interior(s, device) for s in shapes]
    if apply_diag_for_level is not None:
        applies, raw_diags = zip(*[
            apply_diag_for_level(i, shapes[i]) for i in range(len(shapes))
        ])
        diags = [torch.where(masks[i], raw_diags[i], 1.0)
                 for i in range(len(shapes))]

        def apply_A(u, lvl):
            return torch.where(masks[lvl], applies[lvl](u * masks[lvl]), 0.0)
    else:
        if loc_for_level is None:
            locs = [K_loc] * len(shapes)
        else:
            locs = [loc_for_level(i) for i in range(len(shapes))]
        diags = [
            torch.where(
                masks[i],
                assembly2d.stiffness_diag(shapes[i], locs[i], dtype, device),
                1.0,
            )
            for i in range(len(shapes))
        ]

        def apply_A(u, lvl):
            return torch.where(
                masks[lvl],
                assembly2d.apply_stiffness(u * masks[lvl], locs[lvl]),
                0.0,
            )

    def smooth(u, r, lvl, sweeps):
        for _ in range(sweeps):
            u = u + omega * torch.where(
                masks[lvl], (r - apply_A(u, lvl)) / diags[lvl], 0.0
            )
        return u

    def vcycle(r, lvl=0):
        u = smooth(torch.zeros_like(r), r, lvl, nu)
        if lvl == len(shapes) - 1:
            return smooth(u, r, lvl, coarse_sweeps - nu)
        res = torch.where(masks[lvl], r - apply_A(u, lvl), 0.0)
        rc = torch.where(masks[lvl + 1], restrict_full_weighting(res), 0.0)
        ec = vcycle(rc, lvl + 1)
        u = u + torch.where(masks[lvl], prolong_bilinear(ec), 0.0)
        return smooth(u, r, lvl, nu)

    return vcycle


def restrict_full_weighting_3d(r: torch.Tensor) -> torch.Tensor:
    """[nf+1]^3 fine residual -> [nf/2+1]^3 via R = P^T (separable
    [1 2 1]/2 per axis)."""
    rp = F.pad(r, (1, 1, 1, 1, 1, 1))
    a = _fw_rows(rp)
    b = _fw_rows(a.movedim(1, 0)).movedim(0, 1)
    return _fw_rows(b.movedim(2, 0)).movedim(0, 2)


def prolong_trilinear(c: torch.Tensor) -> torch.Tensor:
    """[nc+1]^3 coarse field -> [2nc+1]^3 trilinear interpolation
    (separable interleave per axis)."""

    def up(x):
        return _interleave_rows(x, 0.5 * (x[:-1] + x[1:]))

    a = up(c)
    b = up(a.movedim(1, 0)).movedim(0, 1)
    return up(b.movedim(2, 0)).movedim(0, 2)


def _interior_3d(shape, device):
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = True
    return m


def make_vcycle_3d(nz1: int, ny1: int, nx1: int, K_loc, dtype, nu: int = 2,
                   omega: float = 0.8, coarsest: int = 5,
                   coarse_sweeps: int = 60, loc_for_level=None,
                   apply_diag_for_level=None, device=None):
    """3D analog of ``make_vcycle``: V(nu, nu) on the Dirichlet-interior Q1
    hex system.  ``loc_for_level(lvl)`` returns the rediscretised local 8x8
    at level ``lvl`` (spacing 2**lvl x fine), needed whenever the operator
    has terms that scale differently with h (mass ~ h^3, convection ~ h^2,
    stiffness ~ h).  Without it the pure a0-Laplacian scaling is applied:
    every term of the 3D Q1 stiffness scales like h, so
    K_loc(2^l h) = 2^l K_loc(h) exactly (reusing the fine K_loc unscaled
    makes each coarse correction wrong by 2x per level).  For operators
    without a shared local 8x8 (variable coefficients), pass
    ``apply_diag_for_level(lvl, shape)`` returning ``(apply_fn,
    diag_tensor)``."""
    shapes = [(nz1, ny1, nx1)]
    while (all((s - 1) % 2 == 0 for s in shapes[-1])
           and min(shapes[-1]) - 1 > coarsest):
        shapes.append(tuple((s - 1) // 2 + 1 for s in shapes[-1]))
    masks = [_interior_3d(s, device) for s in shapes]
    if apply_diag_for_level is not None:
        applies, raw_diags = zip(*[
            apply_diag_for_level(i, shapes[i]) for i in range(len(shapes))
        ])
        diags = [torch.where(masks[i], raw_diags[i], 1.0)
                 for i in range(len(shapes))]

        def apply_A(u, lvl):
            return torch.where(masks[lvl], applies[lvl](u * masks[lvl]), 0.0)
    else:
        if loc_for_level is None:
            locs = [np.asarray(K_loc) * 2.0 ** lvl
                    for lvl in range(len(shapes))]
        else:
            locs = [loc_for_level(lvl) for lvl in range(len(shapes))]
        diags = [
            torch.where(
                masks[lvl],
                assembly3d.stiffness_diag_3d(shapes[lvl], locs[lvl], dtype,
                                             device),
                1.0,
            )
            for lvl in range(len(shapes))
        ]

        def apply_A(u, lvl):
            return torch.where(
                masks[lvl],
                assembly3d.apply_stiffness_3d(u * masks[lvl], locs[lvl]),
                0.0,
            )

    def smooth(u, r, lvl, sweeps):
        for _ in range(sweeps):
            u = u + omega * torch.where(
                masks[lvl], (r - apply_A(u, lvl)) / diags[lvl], 0.0
            )
        return u

    def vcycle(r, lvl=0):
        u = smooth(torch.zeros_like(r), r, lvl, nu)
        if lvl == len(shapes) - 1:
            return smooth(u, r, lvl, coarse_sweeps - nu)
        res = torch.where(masks[lvl], r - apply_A(u, lvl), 0.0)
        rc = torch.where(masks[lvl + 1], restrict_full_weighting_3d(res),
                         0.0)
        ec = vcycle(rc, lvl + 1)
        u = u + torch.where(masks[lvl], prolong_trilinear(ec), 0.0)
        return smooth(u, r, lvl, nu)

    return vcycle
