"""Transient (parabolic) extension: u_t + L u = f(x, t) — the 1D Numerov
pieces, so far.

PyTorch counterpart of part of ``hybrid_fem_lssvr_tpu/models/transient.py``:
the helpers the eigenvalue family (``models/eigen.py``) calls, with the
same names and arithmetic:

* ``_tri_apply``         — tridiagonal product (JAX :104);
* ``_numerov_setup``     — exact P1 stiffness plus the (1, 10, 1)/12 mass
                           of the compact fourth-order scheme (:155-190);
* ``_numerov_locals_2d`` — the tensor Numerov local 4x4s (:423).

The marches themselves (``fem_march``, ``hybrid_march``, their 2D
counterparts, the wave, adaptive-step and IMEX marches) are not ported
yet (ROADMAP.md §1 item 5); they belong in this file.
"""

from __future__ import annotations

import torch

from ..ops import assembly2d
from .problem import Problem1D


def _tri_apply(sub, main, sup, u):
    """A @ u for tridiagonal diagonals in the ops.tridiag convention."""
    zero = u[:1] * 0
    return (main * u
            + sub * torch.cat([zero, u[:-1]])
            + sup * torch.cat([u[1:], zero]))


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


def _numerov_locals_2d(hx, hy, a0, c):
    """Tensor Numerov local 4x4s — shared with the steady coarse='compact'
    option; see ``ops.assembly2d.q1_numerov_locals``."""
    return assembly2d.q1_numerov_locals(hx, hy, a0, c)
