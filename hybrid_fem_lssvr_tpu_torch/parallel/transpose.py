"""Peaceman-Rachford ADI line sweeps for the 2D Dirichlet Poisson problem.

PyTorch counterpart of the single-device part of
``hybrid_fem_lssvr_tpu/parallel/transpose.py``.  Each half-step solves
independent tridiagonal line systems along one axis (batched Thomas, lines
on the batch axis), and a transpose switches the line direction between
half-steps.  ``transpose_fn`` / ``transpose_fn_T`` are the hooks a
distributed all-to-all transpose plugs into; that sharded transpose is not
ported yet, and with None the local ``.T`` is used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import tridiag


def _line_solve(rhs_rows, h, tau, n_true=None):
    """Solve (tau I + A) u = rhs along axis 1 for a batch of interior
    Dirichlet lines [L, n]: A = (1/h^2) tridiag(-1, 2, -1).

    ``n_true`` < n marks the line's true Dirichlet length when the batch is
    zero-padded: couplings are cut at the n_true boundary and the pad
    region solves as identity, so the true-region solution is exact."""
    n = rhs_rows.shape[1]
    if n_true is None:
        n_true = n
    inv2 = 1.0 / (h * h)
    dt, dev = rhs_rows.dtype, rhs_rows.device
    j = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    off = torch.full((), -inv2, dtype=dt, device=dev)
    a = torch.where((j == 0) | (j >= n_true), zero, off)
    b = torch.where(j < n_true,
                    torch.full((), tau, dtype=dt, device=dev) + 2.0 * inv2,
                    torch.ones((), dtype=dt, device=dev))
    c = torch.where(j >= n_true - 1, zero, off)
    return tridiag.thomas(a, b, c, rhs_rows.T).T


def _apply_line_laplacian(u_rows, h):
    """A u along axis 1 (zero-Dirichlet line Laplacian)."""
    pad = F.pad(u_rows, (1, 1))
    return (2.0 * u_rows - pad[:, :-2] - pad[:, 2:]) / (h * h)


def adi_poisson_sweeps(f_int, hx, hy, tau, n_sweeps: int,
                       transpose_fn=None, transpose_fn_T=None,
                       true_shape=None):
    """Peaceman-Rachford ADI for -Lap u = f, u = 0 on the boundary of a
    uniform grid; ``f_int``: interior rhs [ny-1, nx-1] (y-major).

    Each sweep:  (tau I + A_x) u*  = (tau I - A_y) u  + f
                 (tau I + A_y) u'  = (tau I - A_x) u* + f

    ``true_shape`` = (ny_true, nx_true) marks the true interior extents
    when ``f_int`` is zero-padded; the pad region stays exactly zero.
    Returns the interior solution, same shape as ``f_int``.
    """
    tp = (lambda a: a.T) if transpose_fn is None else transpose_fn
    tpT = (lambda a: a.T) if transpose_fn_T is None else transpose_fn_T

    u = torch.zeros_like(f_int)
    fT = tp(f_int)
    nx_t = f_int.shape[1] if true_shape is None else true_shape[1]
    ny_t = fT.shape[1] if true_shape is None else true_shape[0]
    dev = f_int.device
    mx = (torch.arange(f_int.shape[1], device=dev) < nx_t)[None, :]
    my = (torch.arange(fT.shape[1], device=dev) < ny_t)[None, :]
    for _ in range(n_sweeps):
        uT = tp(u)  # x-major: y-lines along axis 1
        rhs1 = tpT(my * (tau * uT - _apply_line_laplacian(uT, hy))) + f_int
        u_star = _line_solve(mx * rhs1, hx, tau, n_true=nx_t)
        rhs2 = tp(mx * (tau * u_star - _apply_line_laplacian(u_star, hx))) \
            + fT
        uT = _line_solve(my * rhs2, hy, tau, n_true=ny_t)
        u = tpT(uT)
    return u


def make_adi_preconditioner(ny1: int, nx1: int, hx, hy, dtype,
                            n_sweeps: int = 1, tau=None,
                            transpose_fn=None, transpose_fn_T=None):
    """ADI sweeps as a CG preconditioner for the 2D coarse solve.

    Approximately inverts the 5-point FD Laplacian (spectrally equivalent
    to the Q1 stiffness) with ``n_sweeps`` Peaceman-Rachford iterations
    from a zero start: on a rectangle A_x and A_y commute, so the sweep
    operator is a symmetric rational function of them, a valid SPD
    preconditioner whose line solves are exact per direction whatever the
    hx/hy aspect ratio.  Returns M_inv(r_grid) -> u_grid over the padded
    [ny1, nx1] nodal grid (boundary rows/cols zero).
    """
    if tau is None:
        # Geometric mean of the line operators' spectral extremes:
        # lam in [pi^2, 4/h^2] per direction, h = min(hx, hy).
        hmin = min(float(hx), float(hy))
        tau = float(np.sqrt(np.pi**2 * 4.0 / hmin**2))
    # The Q1 load/stiffness scale: r ~ (hx hy) * continuous residual.
    scale = 1.0 / (float(hx) * float(hy))

    def M_inv(r_grid):
        r_int = r_grid[1:-1, 1:-1] * scale
        u_int = adi_poisson_sweeps(r_int, hx, hy, tau, n_sweeps,
                                   transpose_fn=transpose_fn,
                                   transpose_fn_T=transpose_fn_T)
        return F.pad(u_int, (1, 1, 1, 1))

    return M_inv
