"""Fused graded-mesh 2D LSSVR enhancement: the CUDA kernel and its plain
version.

PyTorch counterpart of ``pallas_kernels.fused_enhance_graded_2d`` of the
JAX package.  Per quad of a graded tensor-product mesh, with geometry
(xl, yl, hx_e, hy_e) from the node arrays, sx = 2/hx_e, sy = 2/hy_e and
the per-element row scale inv_s2 = 1/(sx^2 + sy^2):

    c = [-a sx^2, -a sy^2, (bx - a_x) sx, (by - a_y) sy, c] * inv_s2
    G_k = sum_s c_s (AZ_s)_k          (five unit-scale reference blocks)
    wp = Pbc bc;   g = f inv_s2 - sum_s c_s (AP_s bc)
    y = argmin ||G y - g|| (CGS2 QR);   w = wp + Z y
    slack = (sx^2 + sy^2) max |g - G y|;   bcv = max |bc - B w|

with a, a_x, a_y the coefficient fields (the constants a0, 0, 0 without
``a_var``) at the C^2 collocation points.  As in ``ops.kernels2d``, the
wrapper samples the callables with torch into ``[rows, E]`` tensors at the
graded collocation points, x = xl + (t + 1)/2 hx_e, and g along the four
domain edges at the graded trace points; the corner gather, the bilinear
trace with the Dirichlet override, the QR and the diagnostics are the
kernel's (``csrc/enhance2d_graded.cu``).  Given CPU tensors the wrapper
runs the plain version (``fused_enhance_graded_2d_ref``); given CUDA
tensors it launches the kernel or raises.

The TPU kernel evaluates f, a, a_x, a_y itself and has no structured-rhs
hook; the 128-lane tile rule is dropped (the kernel masks the ragged edge).
"""

from __future__ import annotations

import torch

from . import kernels2d as K2
from . import kkt
from .kernels import _ptr, _stream

PLAIN_CHUNK = K2.PLAIN_CHUNK
_SOURCE = "enhance2d_graded"


def reset_launch_counts():
    fused_enhance_graded_2d.launches = 0


def launch_counts() -> dict:
    return {"fused_enhance_graded_2d": fused_enhance_graded_2d.launches}


def _sample(fem_values, problem, xs, ys, nx, ny, t_int, bpts):
    """(coef [3, C^2, E] or None, f [C^2, E], gedge [4, Kb, max(nx, ny)],
    pts [8, Kb]) at the graded collocation and trace points, row-major
    quads, in the nodal values' dtype."""
    if tuple(fem_values.shape) != (ny + 1, nx + 1):
        raise ValueError(f"fem_values {tuple(fem_values.shape)} is not the "
                         f"[{ny + 1}, {nx + 1}] nodal grid")
    if tuple(xs.shape) != (nx + 1,) or tuple(ys.shape) != (ny + 1,):
        raise ValueError("xs / ys must hold nx + 1 / ny + 1 node positions")
    dtype, device = fem_values.dtype, fem_values.device
    xs = xs.to(dtype)
    ys = ys.to(dtype)
    hx = xs[1:] - xs[:-1]  # [nx]
    hy = ys[1:] - ys[:-1]  # [ny]
    t = K2._const(t_int, dtype, device)
    C = t.shape[0]
    dX0 = ((t.repeat(C) + 1.0) * 0.5)[:, None, None]  # [C^2, 1, 1]
    dY0 = ((t.repeat_interleave(C) + 1.0) * 0.5)[:, None, None]
    X = xs[:-1][None, None, :] + dX0 * hx[None, None, :]  # [C^2, 1, nx]
    Y = ys[:-1][None, :, None] + dY0 * hy[None, :, None]  # [C^2, ny, 1]
    ones = torch.ones((C * C, ny, nx), dtype=dtype, device=device)

    def rows(fn):
        return (fn(X, Y) * ones).reshape(C * C, nx * ny)

    coef = None
    if problem.a_var is not None:
        if problem.grad_a is None:
            raise ValueError(
                "fused_enhance_graded_2d needs analytic grad_a "
                "(problem.grad_a); autograd-derived gradients run on "
                "backend='torch'")
        coef = torch.stack([rows(problem.a_var), rows(problem.grad_a[0]),
                            rows(problem.grad_a[1])])
    f = rows(problem.f)
    b = K2._const(bpts, dtype, device)
    bX = ((b[:, 1] + 1.0) * 0.5)[:, None]  # [Kb, 1]
    bY = ((b[:, 0] + 1.0) * 0.5)[:, None]
    nmax = max(nx, ny)
    gedge = torch.zeros(4, b.shape[0], nmax, dtype=dtype, device=device)
    xl, yl = xs[:-1][None], ys[:-1][None]
    edges = ((xl[:, :1], hx[None, :1], yl, hy[None], ny),
             (xl[:, -1:], hx[None, -1:], yl, hy[None], ny),
             (xl, hx[None], yl[:, :1], hy[None, :1], nx),
             (xl, hx[None], yl[:, -1:], hy[None, -1:], nx))
    for i, (xe, he, ye, ke, n) in enumerate(edges):
        xb, yb = xe + bX * he, ye + bY * ke
        gedge[i, :, :n] = problem.g(xb, yb) * torch.ones_like(xb + yb)
    return coef, f, gedge, K2._trace_points(bpts, dtype, device)


def _geometry(xs, ys, nx, ny, dtype):
    """(sx, sy, inv_s2) [1, E] per row-major quad, in ``dtype``."""
    hx = (xs[1:] - xs[:-1]).to(dtype)
    hy = (ys[1:] - ys[:-1]).to(dtype)
    sx = (2.0 / hx)[None, :].expand(ny, nx).reshape(1, -1)
    sy = (2.0 / hy)[:, None].expand(ny, nx).reshape(1, -1)
    return sx, sy, 1.0 / (sx * sx + sy * sy)


def _system(cs, f, bc, gops, inv_s2):
    """One chunk of quads' (wp = Pbc bc [M2, E], g [E, C2], G [E, C2, K])."""
    C2 = f.shape[0]
    AZ = gops.AZ.reshape(5, C2, -1)
    wp = gops.Pbc @ bc  # [M2, E]
    apbc = (gops.AP @ bc).reshape(5, C2, -1)
    Dwp = sum(cs[s] * apbc[s] for s in range(5))
    g = (f * inv_s2 - Dwp).T  # [E, C2]
    G = sum(cs[s].T[:, :, None] * AZ[s] for s in range(5))  # [E, C2, K]
    return wp, g, G


def _plain_chunk(cs, f, bc, gops, inv_s2, s2, with_diagnostics):
    """The per-quad algebra on one chunk of quads (last axis)."""
    wp, g, G = _system(cs, f, bc, gops, inv_s2)
    lstsq, _ = kkt._batched_mgs_qr_factor(G)
    y = lstsq(g)
    w = wp + gops.Z @ y.T  # [M2, E]
    if not with_diagnostics:
        return w.T, None, None
    e_res = g - torch.einsum("eqk,ek->eq", G, y)
    slack = s2[0] * torch.abs(e_res).amax(1)
    bcv = torch.abs(bc - gops.B @ w).amax(0)
    return w.T, slack, bcv


def _chunks(fem_values, coef, f, gedge, pts, problem, xs, ys, nx, ny):
    """(cs, f, bc, inv_s2, sx^2 + sy^2) of each chunk of PLAIN_CHUNK quads:
    the five block weights c_s [C2, E] and the rest on the quads' axis."""
    dtype = fem_values.dtype
    bc = K2._trace_bc(fem_values, gedge, pts, nx, ny)
    sx, sy, inv_s2 = _geometry(xs, ys, nx, ny, dtype)
    bx, by = problem.b
    if coef is None:
        a = torch.full_like(f, problem.a0)
        cx = torch.full_like(f, bx)
        cy = torch.full_like(f, by)
    else:
        a, cx, cy = coef[0], bx - coef[1], by - coef[2]
    sx2, sy2 = sx * sx, sy * sy
    for lo in range(0, nx * ny, PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        i2 = inv_s2[:, sl]
        cs = (-a[:, sl] * sx2[:, sl] * i2, -a[:, sl] * sy2[:, sl] * i2,
              cx[:, sl] * sx[:, sl] * i2, cy[:, sl] * sy[:, sl] * i2,
              problem.c * i2 * torch.ones_like(f[:, sl]))
        yield cs, f[:, sl], bc[:, sl], i2, (sx2 + sy2)[:, sl]


def _plain(fem_values, coef, f, gedge, pts, gops, problem, xs, ys, nx, ny,
           with_diagnostics):
    parts = [_plain_chunk(cs, fc, bc, gops, i2, s2, with_diagnostics)
             for cs, fc, bc, i2, s2 in _chunks(fem_values, coef, f, gedge,
                                               pts, problem, xs, ys, nx, ny)]
    w = torch.cat([p[0] for p in parts]).contiguous()
    if not with_diagnostics:
        return w, None, None
    return (w, torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))


def _cuda(fem_values, coef, f, gedge, pts, gops, problem, xs, ys, nx, ny,
          with_diagnostics):
    name = "fused_enhance_graded_2d"
    M2 = gops.Z.shape[0]
    M, C = K2._shape_of(M2, f.shape[0])
    xs = xs.to(torch.float32).contiguous()
    ys = ys.to(torch.float32).contiguous()
    extra = (coef,) if coef is not None else ()
    K2.check_kernel_inputs(name, fem_values, M, C, f, gedge, xs, ys, *extra)
    lib = K2._checked_lib(name, _SOURCE, M, C)
    dev = fem_values.device
    statics = K2._statics(name, dev, (gops.AZ, gops.AP, gops.Z, gops.Pbc,
                                      gops.B, pts))
    w, slack, bcv = K2._outputs(nx * ny, M2, dev, with_diagnostics)
    bx, by = problem.b
    err = lib.enhance2d_graded_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(xs),
        _ptr(ys), _ptr(coef), _ptr(f), _ptr(gedge), _ptr(statics), _ptr(w),
        _ptr(slack), _ptr(bcv), nx, ny, gedge.shape[2], M, C,
        float(problem.a0), float(bx), float(by), float(problem.c),
        int(coef is not None), int(with_diagnostics))
    K2._raise_on(lib, _SOURCE, name, err)
    fused_enhance_graded_2d.launches += 1
    return w, slack, bcv


def _check(gops):
    if gops.AZ is None or gops.AP is None:
        raise ValueError("gops must carry the AZ/AP fused precompute")


def fused_enhance_graded_2d(fem_values, gops, problem, xs, ys, nx: int,
                            ny: int, t_int, bpts,
                            with_diagnostics: bool = True):
    """Graded-mesh 2D enhancement (replaces
    ``pallas_kernels.fused_enhance_graded_2d``).

    fem_values [ny+1, nx+1]; ``gops`` a ``models.hybrid2d_graded.
    Graded2DOperators`` with the AZ/AP precompute; ``problem`` a
    ``Problem2D`` (a0, b, c, f, g, a_var with analytic grad_a); xs [nx+1],
    ys [ny+1] the node positions; t_int [C] and bpts [4M-4, 2] as in
    ``kernels2d``.  Returns (w [E, M^2], slack [E], bcv [E]) over row-major
    quads; slack and bcv are None without diagnostics."""
    _check(gops)
    coef, f, gedge, pts = _sample(fem_values, problem, xs, ys, nx, ny,
                                  t_int, bpts)
    run = _plain if fem_values.device.type == "cpu" else _cuda
    return run(fem_values, coef, f, gedge, pts, gops, problem, xs, ys, nx, ny,
               with_diagnostics)


def fused_enhance_graded_2d_ref(fem_values, gops, problem, xs, ys, nx, ny,
                                t_int, bpts, with_diagnostics: bool = True):
    """Plain-torch version of ``fused_enhance_graded_2d`` (any device)."""
    _check(gops)
    coef, f, gedge, pts = _sample(fem_values, problem, xs, ys, nx, ny,
                                  t_int, bpts)
    return _plain(fem_values, coef, f, gedge, pts, gops, problem, xs, ys, nx,
                  ny, with_diagnostics)


def least_squares_system(fem_values, gops, problem, xs, ys, nx, ny, t_int,
                         bpts):
    """The quads' systems as the plain version builds them: (G [E, C^2, K],
    g [E, C^2]), y = argmin ||G y - g||."""
    _check(gops)
    coef, f, gedge, pts = _sample(fem_values, problem, xs, ys, nx, ny,
                                  t_int, bpts)
    gs, Gs = zip(*(_system(cs, fc, bc, gops, i2)[1:]
                   for cs, fc, bc, i2, _ in _chunks(
                       fem_values, coef, f, gedge, pts, problem, xs, ys, nx,
                       ny)))
    return torch.cat(Gs), torch.cat(gs)


reset_launch_counts()
