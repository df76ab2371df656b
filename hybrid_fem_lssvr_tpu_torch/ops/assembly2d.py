"""Matrix-free Q1 FEM on structured quad meshes.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/assembly2d.py``.  No
sparse matrix is formed: the stiffness operator is applied as
gather -> per-element 4x4 -> scatter-add over the node grid, written as
shifted slices of the grid (a 9-point stencil in effect).

Element/node layout: nodes u[ny+1, nx+1] on a uniform grid; element (j, i)
spans x in [x_i, x_{i+1}], y in [y_j, y_{j+1}].  Corner order within an
element: 00=(y_j,x_i), 10=(y_j,x_{i+1}), 01=(y_{j+1},x_i), 11=(y_{j+1},x_{i+1}).

The local 4x4 matrices are host numpy float64 (setup-time); ``local_tensor``
carries one to the run device.  ``q1_reference_parts`` and
``q1_reference_quad_parts`` of the JAX module serve the graded solver and
are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .assembly import gauss_rule


def _rule(quad_order):
    t, w = gauss_rule(quad_order)
    return np.array(t), np.array(w)


def _q1_shape(xi, eta):
    """Q1 shape functions and reference-space gradients at one point."""
    N = 0.25 * np.array([(1 - xi) * (1 - eta), (1 + xi) * (1 - eta),
                         (1 - xi) * (1 + eta), (1 + xi) * (1 + eta)])
    dN_dxi = 0.25 * np.array([-(1 - eta), (1 - eta), -(1 + eta), (1 + eta)])
    dN_deta = 0.25 * np.array([-(1 - xi), -(1 + xi), (1 - xi), (1 + xi)])
    return N, dN_dxi, dN_deta


@functools.lru_cache(maxsize=None)
def q1_local_stiffness(hx: float, hy: float, quad_order: int = 2):
    """4x4 local Poisson stiffness for a rectangular Q1 element."""
    t, w = _rule(quad_order)
    K = np.zeros((4, 4))
    jac = (hx / 2) * (hy / 2)
    for xi, wx in zip(t, w):
        for eta, wy in zip(t, w):
            _, dN_dxi, dN_deta = _q1_shape(xi, eta)
            dN_dx = dN_dxi * (2.0 / hx)
            dN_dy = dN_deta * (2.0 / hy)
            K += wx * wy * jac * (np.outer(dN_dx, dN_dx)
                                  + np.outer(dN_dy, dN_dy))
    return K


@functools.lru_cache(maxsize=None)
def q1_local_mass(hx: float, hy: float, quad_order: int = 2):
    """4x4 local mass matrix int N_a N_b (2x2 Gauss is exact)."""
    t, w = _rule(quad_order)
    Mm = np.zeros((4, 4))
    jac = (hx / 2) * (hy / 2)
    for xi, wx in zip(t, w):
        for eta, wy in zip(t, w):
            N, _, _ = _q1_shape(xi, eta)
            Mm += wx * wy * jac * np.outer(N, N)
    return Mm


@functools.lru_cache(maxsize=None)
def q1_local_convection(hx: float, hy: float, bx: float, by: float,
                        quad_order: int = 2):
    """4x4 local convection matrix int N_a (b . grad N_b), constant b."""
    t, w = _rule(quad_order)
    Cm = np.zeros((4, 4))
    jac = (hx / 2) * (hy / 2)
    for xi, wx in zip(t, w):
        for eta, wy in zip(t, w):
            N, dN_dxi, dN_deta = _q1_shape(xi, eta)
            conv = bx * dN_dxi * (2.0 / hx) + by * dN_deta * (2.0 / hy)
            Cm += wx * wy * jac * np.outer(N, conv)
    return Cm


def q1_local_operator(hx: float, hy: float, a0: float = 1.0, c: float = 0.0,
                      bx: float = 0.0, by: float = 0.0,
                      quad_order: int = 2):
    """Combined 4x4 local matrix for L u = -a0 Lap u + b . grad u + c u;
    the defaults give the pure Poisson stiffness."""
    A = a0 * q1_local_stiffness(hx, hy, quad_order)
    if c != 0.0:
        A = A + c * q1_local_mass(hx, hy, quad_order)
    if bx != 0.0 or by != 0.0:
        A = A + q1_local_convection(hx, hy, bx, by, quad_order)
    return A


def q1_numerov_locals(hx: float, hy: float, a0: float = 1.0, c: float = 0.0):
    """Tensor-Numerov local 4x4s (K_A, K_M) for -a0 Lap u + c u on a uniform
    grid: the Q1 local operator is kron(y-part, x-part), so the 1D Numerov
    mass (h/12) [[5,1],[1,5]] tensorises directly.  The assembled pair gives
    the compact O(h^4) scheme A u = M f_nodal."""
    def K1(h):
        return (1.0 / h) * np.array([[1.0, -1.0], [-1.0, 1.0]])

    def M1n(h):
        return (h / 12.0) * np.array([[5.0, 1.0], [1.0, 5.0]])

    K_M = np.kron(M1n(hy), M1n(hx))
    K_A = (a0 * (np.kron(M1n(hy), K1(hx)) + np.kron(K1(hy), M1n(hx)))
           + c * K_M)
    return K_A, K_M


@functools.lru_cache(maxsize=None)
def q1_varcoeff_parts(hx: float, hy: float, quad_order: int = 2):
    """Per-quadrature-point gradient-product matrices for variable-
    coefficient stiffness: S[q, a, b] = w_q jac (grad N_a . grad N_b)(xi_q),
    so K_e = sum_q a(x_q^e) S[q] for -div(a grad u).  Also the offsets
    (dxq, dyq) [Q] of the quadrature points from the element's lower-left
    corner."""
    t, w = _rule(quad_order)
    jac = (hx / 2) * (hy / 2)
    S, dxq, dyq = [], [], []
    for xi, wx in zip(t, w):
        for eta, wy in zip(t, w):
            _, dN_dxi, dN_deta = _q1_shape(xi, eta)
            dN_dx = dN_dxi * (2.0 / hx)
            dN_dy = dN_deta * (2.0 / hy)
            S.append(wx * wy * jac * (np.outer(dN_dx, dN_dx)
                                      + np.outer(dN_dy, dN_dy)))
            dxq.append((xi + 1.0) * 0.5 * hx)
            dyq.append((eta + 1.0) * 0.5 * hy)
    return np.stack(S), np.array(dxq), np.array(dyq)


def local_tensor(K_np, like: torch.Tensor) -> torch.Tensor:
    """A host local matrix as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(K_np), dtype=like.dtype,
                           device=like.device)


def coeff_maps(xs: torch.Tensor, ys: torch.Tensor, a_fn, dxq, dyq):
    """a(x, y) at each element's quadrature points: [Q, ny, nx]."""
    dxq_t = local_tensor(dxq, xs)
    dyq_t = local_tensor(dyq, xs)
    xq = xs[:-1][None, None, :] + dxq_t[:, None, None]
    yq = ys[:-1][None, :, None] + dyq_t[:, None, None]
    ny, nx = ys.shape[0] - 1, xs.shape[0] - 1
    return (a_fn(xq, yq) * torch.ones((), dtype=xs.dtype, device=xs.device)
            ).expand(len(dxq), ny, nx)


def _corners(u):
    """Element corner values from the node grid: 4 x [ny, nx] views."""
    return (u[:-1, :-1], u[:-1, 1:], u[1:, :-1], u[1:, 1:])


def _scatter_corners(shape, like, r):
    y = torch.zeros(shape, dtype=like.dtype, device=like.device)
    y[:-1, :-1] += r[0]
    y[:-1, 1:] += r[1]
    y[1:, :-1] += r[2]
    y[1:, 1:] += r[3]
    return y


def _scalars(K):
    """A small matrix as nested Python floats, read once: indexing a device
    tensor per entry would synchronise with the GPU on every product."""
    return K.tolist() if isinstance(K, torch.Tensor) else np.asarray(
        K).tolist()


def apply_stiffness(u: torch.Tensor, K_loc) -> torch.Tensor:
    """y = A u with the shared 4x4 local matrix (uniform mesh, constant
    coefficients).  u: [ny+1, nx+1] node grid; K_loc a [4, 4] tensor or
    numpy array."""
    c = _corners(u)
    Kl = _scalars(K_loc)
    r = []
    for a in range(4):
        acc = Kl[a][0] * c[0]
        for b in range(1, 4):
            acc = acc + Kl[a][b] * c[b]
        r.append(acc)
    return _scatter_corners(u.shape, u, r)


def apply_stiffness_var(u: torch.Tensor, Sq, a_maps: torch.Tensor):
    """y = A u for -div(a grad u): per-element K_e = sum_q a_q S_q with
    a_maps [Q, ny, nx] the coefficient per element and quadrature point."""
    c = _corners(u)
    Sl = _scalars(Sq)
    r = []
    for a in range(4):
        acc = None
        for q in range(len(Sl)):
            sq = Sl[q][a][0] * c[0]
            for b in range(1, 4):
                sq = sq + Sl[q][a][b] * c[b]
            term = a_maps[q] * sq
            acc = term if acc is None else acc + term
        r.append(acc)
    return _scatter_corners(u.shape, u, r)


def stiffness_diag(shape, K_loc, dtype, device=None) -> torch.Tensor:
    """diag(A) on the node grid (Jacobi preconditioner)."""
    ny1, nx1 = shape
    Kl = _scalars(K_loc)
    ones = torch.ones((ny1 - 1, nx1 - 1), dtype=dtype, device=device)
    return _scatter_corners((ny1, nx1), ones,
                            [Kl[a][a] * ones for a in range(4)])


def stiffness_var_diag(shape, Sq, a_maps: torch.Tensor, dtype):
    """diag(A) for the variable-coefficient stiffness (Jacobi)."""
    Sl = _scalars(Sq)
    Ke_diag = []
    for a in range(4):
        acc = a_maps[0] * Sl[0][a][a]
        for q in range(1, len(Sl)):
            acc = acc + a_maps[q] * Sl[q][a][a]
        Ke_diag.append(acc.to(dtype))
    return _scatter_corners(tuple(shape), Ke_diag[0], Ke_diag)


def assemble_load(xs: torch.Tensor, ys: torch.Tensor, f_fn,
                  quad_order: int = 2) -> torch.Tensor:
    """Load vector on the node grid: b_i = int f N_i, Gauss quadrature per
    element.  xs: [nx+1], ys: [ny+1] node coordinates."""
    dtype, device = xs.dtype, xs.device
    tq, wq = gauss_rule(quad_order)
    t = torch.tensor(tq, dtype=dtype, device=device)
    w = torch.tensor(wq, dtype=dtype, device=device)
    hx = xs[1:] - xs[:-1]  # [nx]
    hy = ys[1:] - ys[:-1]  # [ny]
    xm = 0.5 * (xs[1:] + xs[:-1])
    ym = 0.5 * (ys[1:] + ys[:-1])
    xq = xm[:, None] + 0.5 * hx[:, None] * t[None, :]  # [nx, Qx]
    yq = ym[:, None] + 0.5 * hy[:, None] * t[None, :]  # [ny, Qy]
    # f on the tensor grid: [ny, Qy, nx, Qx]
    F = f_fn(xq[None, None, :, :], yq[:, :, None, None])
    F = F * torch.ones((yq.shape[0], yq.shape[1], xq.shape[0], xq.shape[1]),
                       dtype=dtype, device=device)
    jac = (hy[:, None, None, None] / 2) * (hx[None, None, :, None] / 2)
    W = w[None, :, None, None] * w[None, None, None, :] * jac
    lo = 0.5 * (1.0 - t)  # weight toward the lower corner
    hi = 0.5 * (1.0 + t)
    b = torch.zeros((ys.shape[0], xs.shape[0]), dtype=dtype, device=device)
    FW = F * W
    ny, nx = hy.shape[0], hx.shape[0]
    for (cy, gy) in ((0, lo), (1, hi)):
        for (cx, gx) in ((0, lo), (1, hi)):
            contrib = torch.einsum("yqxp,q,p->yx", FW, gy, gx)
            b[cy:cy + ny, cx:cx + nx] += contrib
    return b
