"""Matrix-free Q1 FEM on structured hex meshes.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/assembly3d.py``, the 3D
analog of ``ops.assembly2d``: the stiffness operator is applied as
gather -> 8x8 local matrix -> scatter-add over the node grid, written as
shifted slices of the grid (a 27-point stencil in effect).

Element/node layout: nodes u[nz+1, ny+1, nx+1]; element (k, j, i) spans
x in [x_i, x_{i+1}], y in [y_j, y_{j+1}], z in [z_k, z_{k+1}].  Corner
order within an element: a = 4 cz + 2 cy + cx (x fastest), matching the
tensor (kron) construction of the local operators.  The local matrices are
host numpy float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .assembly import gauss_rule
from .assembly2d import _scalars

_LO_HI = (slice(None, -1), slice(1, None))


def _k1(h):
    """1D P1 stiffness int N' N' on [0, h]."""
    return (1.0 / h) * np.array([[1.0, -1.0], [-1.0, 1.0]])


def _m1(h):
    """1D P1 mass int N N on [0, h]."""
    return (h / 6.0) * np.array([[2.0, 1.0], [1.0, 2.0]])


def _c1():
    """1D P1 convection int N N' on [0, h] (h-independent)."""
    return 0.5 * np.array([[-1.0, 1.0], [-1.0, 1.0]])


def _t3(Az, Ay, Ax):
    return np.kron(Az, np.kron(Ay, Ax))


@functools.lru_cache(maxsize=None)
def q1_local_operator_3d(hx: float, hy: float, hz: float, a0: float = 1.0,
                         c: float = 0.0, bx: float = 0.0, by: float = 0.0,
                         bz: float = 0.0):
    """Shared 8x8 local matrix for L u = -a0 Lap u + b . grad u + c u on a
    hex: exact tensor products of the 1D P1 matrices (trilinear shape
    functions separate, so no quadrature loop is needed)."""
    kx, mx = _k1(hx), _m1(hx)
    ky, my = _k1(hy), _m1(hy)
    kz, mz = _k1(hz), _m1(hz)
    K = a0 * (_t3(mz, my, kx) + _t3(mz, ky, mx) + _t3(kz, my, mx))
    if c != 0.0:
        K = K + c * _t3(mz, my, mx)
    cv = _c1()
    if bx != 0.0:
        K = K + bx * _t3(mz, my, cv)
    if by != 0.0:
        K = K + by * _t3(mz, cv, mx)
    if bz != 0.0:
        K = K + bz * _t3(cv, my, mx)
    return K


def q1_numerov_locals_3d(hx: float, hy: float, hz: float, a0: float = 1.0,
                         c: float = 0.0):
    """Tensor-Numerov local 8x8s (K_A, K_M) for -a0 Lap u + c u on a hex:
    the 1D Numerov mass (h/12) [[5,1],[1,5]] tensorises as in 2D; the
    assembled scheme A u = M f_nodal is O(h^4) at the nodes."""
    def m1n(h):
        return (h / 12.0) * np.array([[5.0, 1.0], [1.0, 5.0]])

    mz, my, mx = m1n(hz), m1n(hy), m1n(hx)
    K_M = _t3(mz, my, mx)
    K_A = (a0 * (_t3(mz, my, _k1(hx)) + _t3(mz, _k1(hy), mx)
                 + _t3(_k1(hz), my, mx)) + c * K_M)
    return K_A, K_M


def _q1_shape_3d(xi, eta, zeta):
    """Q1 hex shape functions and reference-space gradients at one point,
    corner order a = 4cz + 2cy + cx (x fastest)."""
    N, dxi, deta, dzeta = [], [], [], []
    for cz in (-1.0, 1.0):
        for cy in (-1.0, 1.0):
            for cx in (-1.0, 1.0):
                N.append(0.125 * (1 + cx * xi) * (1 + cy * eta)
                         * (1 + cz * zeta))
                dxi.append(0.125 * cx * (1 + cy * eta) * (1 + cz * zeta))
                deta.append(0.125 * (1 + cx * xi) * cy * (1 + cz * zeta))
                dzeta.append(0.125 * (1 + cx * xi) * (1 + cy * eta) * cz)
    return (np.array(N), np.array(dxi), np.array(deta), np.array(dzeta))


def _rule3(quad_order):
    """(xi, eta, zeta, weight) of the tensor Gauss rule, x fastest."""
    t, w = gauss_rule(quad_order)
    return [(xi, eta, zeta, wx * wy * wz)
            for zeta, wz in zip(t, w) for eta, wy in zip(t, w)
            for xi, wx in zip(t, w)]


@functools.lru_cache(maxsize=None)
def q1_varcoeff_parts_3d(hx: float, hy: float, hz: float,
                         quad_order: int = 2):
    """Per-quadrature-point gradient-product matrices for variable-
    coefficient hex stiffness: S[q, a, b] = w_q jac (grad N_a . grad
    N_b)(xi_q), so K_e = sum_q a(x_q^e) S[q] for -div(a grad u); also the
    offsets (dxq, dyq, dzq) [Q] of the points from the element's lower
    corner."""
    jac = (hx / 2) * (hy / 2) * (hz / 2)
    S, dxq, dyq, dzq = [], [], [], []
    for xi, eta, zeta, w3 in _rule3(quad_order):
        _, dN_dxi, dN_deta, dN_dzeta = _q1_shape_3d(xi, eta, zeta)
        dN_dx = dN_dxi * (2.0 / hx)
        dN_dy = dN_deta * (2.0 / hy)
        dN_dz = dN_dzeta * (2.0 / hz)
        S.append(w3 * jac * (np.outer(dN_dx, dN_dx) + np.outer(dN_dy, dN_dy)
                             + np.outer(dN_dz, dN_dz)))
        dxq.append((xi + 1.0) * 0.5 * hx)
        dyq.append((eta + 1.0) * 0.5 * hy)
        dzq.append((zeta + 1.0) * 0.5 * hz)
    return np.stack(S), np.array(dxq), np.array(dyq), np.array(dzq)


@functools.lru_cache(maxsize=None)
def q1_reference_parts_3d(quad_order: int = 2):
    """Reference-element 8x8 operator parts over [-1, 1]^3: ``Cxx`` =
    int dN/dxi dN/dxi (``Cyy``, ``Czz`` per axis), ``Mh`` = int N N,
    ``Chx``/``Chy``/``Chz`` = int N dN/daxis.  On an hx x hy x hz hex

        K_e = a0 [(hy hz / 2hx) Cxx + (hx hz / 2hy) Cyy + (hx hy / 2hz) Czz]
              + c (hx hy hz / 8) Mh + bx (hy hz / 4) Chx
              + by (hx hz / 4) Chy + bz (hx hy / 4) Chz

    (per-element scalars: graded hex meshes assemble through
    ``apply_stiffness_var_3d``)."""
    Cxx, Cyy, Czz, Mh, Chx, Chy, Chz = (np.zeros((8, 8)) for _ in range(7))
    for xi, eta, zeta, w3 in _rule3(quad_order):
        N, dxi, deta, dzeta = _q1_shape_3d(xi, eta, zeta)
        Cxx += w3 * np.outer(dxi, dxi)
        Cyy += w3 * np.outer(deta, deta)
        Czz += w3 * np.outer(dzeta, dzeta)
        Mh += w3 * np.outer(N, N)
        Chx += w3 * np.outer(N, dxi)
        Chy += w3 * np.outer(N, deta)
        Chz += w3 * np.outer(N, dzeta)
    return Cxx, Cyy, Czz, Mh, Chx, Chy, Chz


@functools.lru_cache(maxsize=None)
def q1_reference_quad_parts_3d(quad_order: int = 2):
    """Per-quadrature-point reference gradient products ``Sxx[q] = w_q
    dN/dxi dN/dxi`` (``Syy``, ``Szz`` per axis) and the reference
    coordinates ``tq [Q, 3]`` ((xi, eta, zeta)): on an hx x hy x hz hex,
    -div(a grad u) has ``K_e = sum_q a(x_q^e) [(hy hz / 2hx) Sxx[q]
    + (hx hz / 2hy) Syy[q] + (hx hy / 2hz) Szz[q]]``."""
    Sxx, Syy, Szz, tq = [], [], [], []
    for xi, eta, zeta, w3 in _rule3(quad_order):
        _, dxi, deta, dzeta = _q1_shape_3d(xi, eta, zeta)
        Sxx.append(w3 * np.outer(dxi, dxi))
        Syy.append(w3 * np.outer(deta, deta))
        Szz.append(w3 * np.outer(dzeta, dzeta))
        tq.append((xi, eta, zeta))
    return np.stack(Sxx), np.stack(Syy), np.stack(Szz), np.array(tq)


def coeff_maps_3d(xs, ys, zs, a_fn, dxq, dyq, dzq):
    """a(x, y, z) at each element's quadrature points: [Q, nz, ny, nx]."""
    dtype, device = xs.dtype, xs.device

    def off(d):
        return torch.as_tensor(np.asarray(d), dtype=dtype,
                               device=device)[:, None, None, None]

    xq = xs[:-1][None, None, None, :] + off(dxq)
    yq = ys[:-1][None, None, :, None] + off(dyq)
    zq = zs[:-1][None, :, None, None] + off(dzq)
    nz, ny, nx = zs.shape[0] - 1, ys.shape[0] - 1, xs.shape[0] - 1
    return a_fn(xq, yq, zq) * torch.ones((len(dxq), nz, ny, nx), dtype=dtype,
                                         device=device)


def _corners_3d(u):
    """Element corner values: 8 x [nz, ny, nx] views, a = 4cz + 2cy + cx."""
    return tuple(u[_LO_HI[cz], _LO_HI[cy], _LO_HI[cx]]
                 for cz in range(2) for cy in range(2) for cx in range(2))


def _scatter_corners_3d(shape, like, r):
    y = torch.zeros(shape, dtype=like.dtype, device=like.device)
    a = 0
    for cz in range(2):
        for cy in range(2):
            for cx in range(2):
                y[_LO_HI[cz], _LO_HI[cy], _LO_HI[cx]] += r[a]
                a += 1
    return y


def apply_stiffness_3d(u: torch.Tensor, K_loc) -> torch.Tensor:
    """y = A u with the shared 8x8 local operator (uniform mesh, constant
    coefficients).  u: [nz+1, ny+1, nx+1] node grid; K_loc a [8, 8] tensor
    or numpy array."""
    cs = _corners_3d(u)
    Kl = _scalars(K_loc)
    r = []
    for a in range(8):
        acc = Kl[a][0] * cs[0]
        for b in range(1, 8):
            acc = acc + Kl[a][b] * cs[b]
        r.append(acc)
    return _scatter_corners_3d(u.shape, u, r)


def apply_stiffness_var_3d(u: torch.Tensor, Sq, a_maps: torch.Tensor):
    """y = A u for -div(a grad u): per-element K_e = sum_q a_q S_q with
    a_maps [Q, nz, ny, nx] from ``coeff_maps_3d``."""
    cs = _corners_3d(u)
    Sl = _scalars(Sq)
    r = []
    for a in range(8):
        acc = None
        for q in range(len(Sl)):
            sq = Sl[q][a][0] * cs[0]
            for b in range(1, 8):
                sq = sq + Sl[q][a][b] * cs[b]
            term = a_maps[q] * sq
            acc = term if acc is None else acc + term
        r.append(acc)
    return _scatter_corners_3d(u.shape, u, r)


def stiffness_diag_3d(shape, K_loc, dtype, device=None) -> torch.Tensor:
    """diag(A) on the node grid (Jacobi preconditioner)."""
    nz1, ny1, nx1 = shape
    Kl = _scalars(K_loc)
    ones = torch.ones((nz1 - 1, ny1 - 1, nx1 - 1), dtype=dtype, device=device)
    return _scatter_corners_3d(tuple(shape), ones,
                               [Kl[a][a] * ones for a in range(8)])


def stiffness_var_diag_3d(shape, Sq, a_maps: torch.Tensor, dtype):
    """diag(A) for the variable-coefficient hex stiffness (Jacobi)."""
    Sl = _scalars(Sq)
    Ke_diag = []
    for a in range(8):
        acc = a_maps[0] * Sl[0][a][a]
        for q in range(1, len(Sl)):
            acc = acc + a_maps[q] * Sl[q][a][a]
        Ke_diag.append(acc.to(dtype))
    return _scatter_corners_3d(tuple(shape), Ke_diag[0], Ke_diag)


def assemble_load_3d(xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor,
                     f_fn, quad_order: int = 2) -> torch.Tensor:
    """Load vector on the node grid: b_i = int f N_i, tensor Gauss per hex."""
    dtype, device = xs.dtype, xs.device
    tq, wq = gauss_rule(quad_order)
    t = torch.tensor(tq, dtype=dtype, device=device)
    w = torch.tensor(wq, dtype=dtype, device=device)
    hx, hy, hz = xs[1:] - xs[:-1], ys[1:] - ys[:-1], zs[1:] - zs[:-1]
    xq = 0.5 * (xs[1:] + xs[:-1])[:, None] + 0.5 * hx[:, None] * t[None, :]
    yq = 0.5 * (ys[1:] + ys[:-1])[:, None] + 0.5 * hy[:, None] * t[None, :]
    zq = 0.5 * (zs[1:] + zs[:-1])[:, None] + 0.5 * hz[:, None] * t[None, :]
    nz, ny, nx = hz.shape[0], hy.shape[0], hx.shape[0]
    Q = t.shape[0]
    # f on [nz, Qz, ny, Qy, nx, Qx]
    F = f_fn(xq[None, None, None, None, :, :], yq[None, None, :, :, None, None],
             zq[:, :, None, None, None, None])
    F = F * torch.ones((nz, Q, ny, Q, nx, Q), dtype=dtype, device=device)
    jac = (hz[:, None, None, None, None, None] / 2
           * hy[None, None, :, None, None, None] / 2
           * hx[None, None, None, None, :, None] / 2)
    W = (w[None, :, None, None, None, None] * w[None, None, None, :, None, None]
         * w[None, None, None, None, None, :]) * jac
    lo, hi = 0.5 * (1.0 - t), 0.5 * (1.0 + t)
    FW = F * W
    b = torch.zeros((zs.shape[0], ys.shape[0], xs.shape[0]), dtype=dtype,
                    device=device)
    for cz, gz in ((0, lo), (1, hi)):
        for cy, gy in ((0, lo), (1, hi)):
            for cx, gx in ((0, lo), (1, hi)):
                contrib = torch.einsum("zryqxp,r,q,p->zyx", FW, gz, gy, gx)
                b[cz:cz + nz, cy:cy + ny, cx:cx + nx] += contrib
    return b
