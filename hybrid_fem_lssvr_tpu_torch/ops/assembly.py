"""1D P1 FEM assembly into tridiagonal storage.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/assembly.py``.  All
element contributions are computed in one vectorised sweep (shapes [E, Q])
and added into three diagonals with slice adds.

Weak form assembled (trial u, test v):

    int a(x) u' v' + b(x) u' v + c(x) u v dx = int f(x) v dx
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def gauss_rule(order: int):
    """Gauss–Legendre nodes/weights on [-1, 1] (host-side static tables)."""
    t, w = np.polynomial.legendre.leggauss(order)
    return tuple(t.tolist()), tuple(w.tolist())


def assemble_p1(nodes, a_fn, b_fn, c_fn, f_fn, quad_order: int = 3):
    """P1 stiffness + load on an arbitrary 1D mesh.

    nodes: [N] strictly increasing, or [..., N] for a batch of meshes (the
    callables then see points [..., E, Q]); a_fn/b_fn/c_fn/f_fn: callables
    of x (``None`` for an identically-zero b or c).  Returns (sub, main,
    sup, rhs), all of nodes' shape, in the ``ops.tridiag`` convention
    (sub[..., 0] == sup[..., -1] == 0).
    """
    dtype, device = nodes.dtype, nodes.device
    tq, wq = gauss_rule(quad_order)
    tq = torch.tensor(tq, dtype=dtype, device=device)  # [Q]
    wq = torch.tensor(wq, dtype=dtype, device=device)

    xl = nodes[..., :-1]  # [E]
    xr = nodes[..., 1:]
    h = xr - xl
    xq = 0.5 * (xl + xr)[..., None] + 0.5 * h[..., None] * tq  # [E, Q]
    Wq = 0.5 * h[..., None] * wq

    ones = torch.ones_like(xq)
    aq = a_fn(xq) * ones if a_fn is not None else torch.zeros_like(xq)
    bq = b_fn(xq) * ones if b_fn is not None else None
    cq = c_fn(xq) * ones if c_fn is not None else None
    fq = f_fn(xq) * ones

    # P1 shape functions on the reference element.
    phi0 = 0.5 * (1.0 - tq)[None, :]  # [1, Q]
    phi1 = 0.5 * (1.0 + tq)[None, :]
    dphi0 = -1.0 / h[..., None]  # [E, 1]
    dphi1 = 1.0 / h[..., None]

    def K(phi_i, dphi_i, phi_j, dphi_j):
        term = aq * dphi_j * dphi_i
        if bq is not None:
            term = term + bq * dphi_j * phi_i
        if cq is not None:
            term = term + cq * phi_j * phi_i
        return torch.sum(Wq * term, dim=-1)  # [E]

    K00 = K(phi0, dphi0, phi0, dphi0)
    K01 = K(phi0, dphi0, phi1, dphi1)
    K10 = K(phi1, dphi1, phi0, dphi0)
    K11 = K(phi1, dphi1, phi1, dphi1)
    b0 = torch.sum(Wq * fq * phi0, dim=-1)
    b1 = torch.sum(Wq * fq * phi1, dim=-1)

    main = torch.zeros(nodes.shape, dtype=dtype, device=device)
    main[..., :-1] += K00
    main[..., 1:] += K11
    sup = torch.zeros(nodes.shape, dtype=dtype, device=device)
    sup[..., :-1] += K01  # A[i, i+1]
    sub = torch.zeros(nodes.shape, dtype=dtype, device=device)
    sub[..., 1:] += K10  # A[i, i-1]
    rhs = torch.zeros(nodes.shape, dtype=dtype, device=device)
    rhs[..., :-1] += b0
    rhs[..., 1:] += b1
    return sub, main, sup, rhs


def element_contributions(nodes, a_fn, b_fn, c_fn, f_fn, quad_order: int = 3):
    """Per-element 2x2 stiffness blocks and 2-vector loads, unscattered.

    Returns (K [E, 2, 2] (test i, trial j), b [E, 2]); the distributed
    assembly (``parallel/sharded.py``) sums the interface contributions
    across shards before it forms its rows.
    """
    dtype, device = nodes.dtype, nodes.device
    tq, wq = gauss_rule(quad_order)
    tq = torch.tensor(tq, dtype=dtype, device=device)
    wq = torch.tensor(wq, dtype=dtype, device=device)
    xl, xr = nodes[:-1], nodes[1:]
    h = xr - xl
    xq = 0.5 * (xl + xr)[:, None] + 0.5 * h[:, None] * tq[None, :]
    Wq = 0.5 * h[:, None] * wq[None, :]
    aq = a_fn(xq) * torch.ones_like(xq) if a_fn is not None \
        else torch.zeros_like(xq)
    bq = b_fn(xq) * torch.ones_like(xq) if b_fn is not None else None
    cq = c_fn(xq) * torch.ones_like(xq) if c_fn is not None else None
    fq = f_fn(xq) * torch.ones_like(xq)
    phi = torch.stack([0.5 * (1.0 - tq), 0.5 * (1.0 + tq)])  # [2, Q]
    dphi = torch.stack([-1.0 / h, 1.0 / h], dim=1)[:, :, None]  # [E, 2, 1]
    phiE = phi[None].expand(h.shape[0], 2, tq.shape[0])
    term = aq[:, None, None, :] * dphi[:, None, :, :] * dphi[:, :, None, :]
    if bq is not None:
        term = term + (bq[:, None, None, :] * dphi[:, None, :, :]
                       * phiE[:, :, None, :])
    if cq is not None:
        term = term + (cq[:, None, None, :] * phiE[:, None, :, :]
                       * phiE[:, :, None, :])
    K = torch.sum(Wq[:, None, None, :] * term, dim=-1)
    bvec = torch.sum(Wq[:, None, :] * fq[:, None, :] * phiE, dim=-1)
    return K, bvec


def apply_dirichlet(sub, main, sup, rhs, g_left, g_right):
    """Impose u[0] = g_left, u[-1] = g_right by row/column elimination
    (boundary rows become identity, boundary columns move to the rhs)."""
    sub, main, sup, rhs = (v.clone() for v in (sub, main, sup, rhs))
    rhs[1] += -sub[1] * g_left
    rhs[-2] += -sup[-2] * g_right
    sub[1] = 0.0
    sup[-2] = 0.0
    main[0] = 1.0
    main[-1] = 1.0
    sup[0] = 0.0
    sub[-1] = 0.0
    rhs[0] = g_left
    rhs[-1] = g_right
    return sub, main, sup, rhs


def apply_bcs(sub, main, sup, rhs, problem):
    """Per-end boundary conditions.

    Dirichlet ends use the row/column elimination of ``apply_dirichlet``.
    Neumann/Robin ends are natural: the assembled boundary row stays, the
    data a u'·n = g - alpha·u adds g to rhs[end] and alpha to the boundary
    diagonal.  Systems [..., N] take boundary data of the batch's shape
    (or scalars).
    """
    sub, main, sup, rhs = (v.clone() for v in (sub, main, sup, rhs))
    if problem.bc_left == "dirichlet":
        g = problem.g_left
        rhs[..., 1] += -sub[..., 1] * g
        sub[..., 1] = 0.0
        main[..., 0] = 1.0
        sup[..., 0] = 0.0
        rhs[..., 0] = g
    else:
        main[..., 0] += problem.robin_alpha_left
        rhs[..., 0] += problem.g_left
    if problem.bc_right == "dirichlet":
        g = problem.g_right
        rhs[..., -2] += -sup[..., -2] * g
        sup[..., -2] = 0.0
        main[..., -1] = 1.0
        sub[..., -1] = 0.0
        rhs[..., -1] = g
    else:
        main[..., -1] += problem.robin_alpha_right
        rhs[..., -1] += problem.g_right
    return sub, main, sup, rhs
