"""Fused 3D LSSVR enhancement on structured hexes: the CUDA kernel and its
plain version.

PyTorch counterpart of ``pallas_kernels.fused_enhance_stacked_3d`` of the
JAX package: per hex, z = [f; bc] with f the rhs at the C^3 interior
collocation points and bc the trilinear trace of the eight corner values at
the S surface points (overridden by g on the domain faces), then

    [w; e] = [[Wf, Wbc], [Pres, Qres]] z,   slack = max |e|,
    bcv = max |bc - B w|.

As in ``ops.kernels2d``, the wrapper samples f with torch into ``[C^3, E]``
(through ``f_shifted`` where the problem has it) and g only on the six
domain faces (``[6, S, max face size]``); hex corner coordinates come from
``x0 + e h`` in the run dtype, as the TPU kernel computes them.  The corner
gather, the trace with its face override, the stacked product and the
diagnostics are the kernel's (``csrc/enhance3d.cu``).  Given CPU tensors the
wrapper runs the plain version (``fused_enhance_stacked_3d_ref``); given
CUDA tensors it launches the kernel or raises.

As the TPU kernel does, the override applies on all six faces; the torch
route of ``models.hybrid3d.enhance_3d`` restricts it to the faces whose
``bc_faces`` entry is "dirichlet".  The 128-lane tile rule is dropped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels2d as K2
from . import kkt
from .kernels import _ptr, _stream

# (M, C) compiled: ENH3D_SHAPES in csrc/enhance3d.cu
SHAPES = ((4, 4),)
_SOURCE = "enhance3d"


def reset_launch_counts():
    fused_enhance_stacked_3d.launches = 0


def launch_counts() -> dict:
    return {"fused_enhance_stacked_3d": fused_enhance_stacked_3d.launches}


def _corner_coords(geom, nx, ny, nz, dtype, device):
    """(xl, yl, zl) [1, E]: lower corner of every hex, x fastest, from index
    arithmetic in the run dtype."""
    x0, hx, y0, hy, z0, hz = geom
    e = torch.arange(nx * ny * nz, device=device)
    ex = (e % nx).to(dtype)[None]
    ey = (torch.div(e, nx, rounding_mode="floor") % ny).to(dtype)[None]
    ez = torch.div(e, nx * ny, rounding_mode="floor").to(dtype)[None]
    return x0 + ex * hx, y0 + ey * hy, z0 + ez * hz


def _colloc_offsets(geom, t_int, dtype, device):
    """(dX, dY, dZ) [C^3, 1]: in-element offsets of the collocation grid,
    rows (cz, cy, cx) row-major as the operators' rows."""
    _, hx, _, hy, _, hz = geom
    t = K2._const(t_int, dtype, device)
    C = t.shape[0]
    dX = (t.repeat(C * C)[:, None] + 1.0) * (0.5 * hx)
    dY = (t.repeat_interleave(C).repeat(C)[:, None] + 1.0) * (0.5 * hy)
    dZ = (t.repeat_interleave(C * C)[:, None] + 1.0) * (0.5 * hz)
    return dX, dY, dZ


def _sample_gface(g_fn, geom, nx, ny, nz, spts, dtype, device):
    """[6, S, F]: g at the surface points of the boundary hexes of the
    x-lo, x-hi (indexed ez ny + ey), y-lo, y-hi (ez nx + ex), z-lo and z-hi
    (ey nx + ex) face; F is the largest face."""
    x0, hx, y0, hy, z0, hz = geom
    sp = K2._const(spts, dtype, device)
    bX = ((sp[:, 2] + 1.0) * (0.5 * hx))[:, None, None]  # [S, 1, 1]
    bY = ((sp[:, 1] + 1.0) * (0.5 * hy))[:, None, None]
    bZ = ((sp[:, 0] + 1.0) * (0.5 * hz))[:, None, None]

    def axis(v0, h, n):
        return v0 + torch.arange(n, device=device).to(dtype) * h

    xl, yl, zl = axis(x0, hx, nx), axis(y0, hy, ny), axis(z0, hz, nz)
    F = max(ny * nz, nx * nz, nx * ny)
    out = torch.zeros(6, sp.shape[0], F, dtype=dtype, device=device)
    # (x, y, z) lower corners of each face's hexes as [n0, n1] grids
    faces = ((xl[:1, None], yl[None, :], zl[:, None]),
             (xl[-1:, None], yl[None, :], zl[:, None]),
             (xl[None, :], yl[:1, None], zl[:, None]),
             (xl[None, :], yl[-1:, None], zl[:, None]),
             (xl[None, :], yl[:, None], zl[:1, None]),
             (xl[None, :], yl[:, None], zl[-1:, None]))
    for i, (xf, yf, zf) in enumerate(faces):
        X, Y, Z = xf[None] + bX, yf[None] + bY, zf[None] + bZ
        v = g_fn(X, Y, Z) * torch.ones_like(X + Y + Z)
        out[i, :, :v.shape[1] * v.shape[2]] = v.reshape(v.shape[0], -1)
    return out


def _trace_points(spts, dtype, device):
    """[14, S]: trilinear shape factors N_a (a = 4cz + 2cy + cx) at the
    surface points, then 0/1 flags for a point on the hex's x-lo, x-hi,
    y-lo, y-hi, z-lo, z-hi face."""
    p = np.asarray(spts, np.float64)
    tz, ty, tx = p[:, 0], p[:, 1], p[:, 2]
    rows = [0.125 * (1 + sxn * tx) * (1 + syn * ty) * (1 + szn * tz)
            for szn in (-1.0, 1.0) for syn in (-1.0, 1.0)
            for sxn in (-1.0, 1.0)]
    rows += [tx == -1.0, tx == 1.0, ty == -1.0, ty == 1.0, tz == -1.0,
             tz == 1.0]
    return K2._const(np.stack([np.asarray(r, np.float64) for r in rows]),
                     dtype, device)


def _trace_bc(fem_values, gface, pts, nx, ny, nz):
    """bc [S, E]: the trilinear trace of the corner values, with g on the
    domain faces of the boundary hexes."""
    S = pts.shape[1]
    lo_hi = (slice(None, -1), slice(1, None))
    bc = 0.0
    a = 0
    for cz in range(2):
        for cy in range(2):
            for cx in range(2):
                u = fem_values[lo_hi[cz], lo_hi[cy], lo_hi[cx]].reshape(1, -1)
                bc = bc + pts[a][:, None] * u
                a += 1
    bc = bc.reshape(S, nz, ny, nx)
    on = pts[8:] > 0.5  # [6, S]
    # Where faces meet, each face's row holds g at the same point.
    views = ((bc[:, -1, :, :], 5, ny * nx, (ny, nx)),
             (bc[:, 0, :, :], 4, ny * nx, (ny, nx)),
             (bc[:, :, -1, :], 3, nz * nx, (nz, nx)),
             (bc[:, :, 0, :], 2, nz * nx, (nz, nx)),
             (bc[:, :, :, -1], 1, nz * ny, (nz, ny)),
             (bc[:, :, :, 0], 0, nz * ny, (nz, ny)))
    for view, fc, n, shape in views:
        g = gface[fc][:, :n].reshape(S, *shape)
        view.copy_(torch.where(on[fc][:, None, None], g, view))
    return bc.reshape(S, nx * ny * nz)


def _inputs(fem_values, ops, f_fn, g_fn, geom, nx, ny, nz, t_int, spts,
            f_shifted_fn):
    if ops.Pres is None or ops.Qres is None:
        raise ValueError("ops has no residual operators; use a host "
                         "precompute (precompute_shared_*_host)")
    if tuple(fem_values.shape) != (nz + 1, ny + 1, nx + 1):
        raise ValueError(f"fem_values {tuple(fem_values.shape)} is not the "
                         f"[{nz + 1}, {ny + 1}, {nx + 1}] nodal grid")
    dtype, device = fem_values.dtype, fem_values.device
    xl, yl, zl = _corner_coords(geom, nx, ny, nz, dtype, device)
    dX, dY, dZ = _colloc_offsets(geom, t_int, dtype, device)
    if f_shifted_fn is not None:
        f = f_shifted_fn(xl, dX, yl, dY, zl, dZ)
    else:
        f = f_fn(xl + dX, yl + dY, zl + dZ)
    # [C^3, E]; a constant or lower-rank f is broadcast (no pass over the
    # 2^21 x 64 values when f already has them).
    f = torch.broadcast_to(f, (dX.shape[0], xl.shape[1])).contiguous()
    gface = _sample_gface(g_fn, geom, nx, ny, nz, spts, dtype, device)
    return f, gface, _trace_points(spts, dtype, device)


def _plain(fem_values, f, gface, pts, ops, nx, ny, nz, with_diagnostics):
    M3 = ops.Wf.shape[0]
    bc = _trace_bc(fem_values, gface, pts, nx, ny, nz)
    O = K2._stacked_operator(ops.Wf, ops.Wbc, ops.Pres, ops.Qres,
                             with_diagnostics)
    out = O @ torch.cat([f, bc])
    w = out[:M3]
    if not with_diagnostics:
        return w.T.contiguous(), None, None
    slack = torch.abs(out[M3:]).amax(0)
    bcv = torch.abs(bc - ops.B @ w).amax(0)
    return w.T.contiguous(), slack, bcv


def _pack(Wf, Wbc, Pres, Qres, B, pts, with_diagnostics=True):
    """The kernel's statics (csrc/enhance3d.cu, ``Layout3``): O^T, its
    output columns interleaved (w feeds B w from the accumulators), and B^T,
    both split and fragment-ordered (``kernels2d._frag``), then the trace
    points."""
    O = K2._stacked_operator(Wf, Wbc, Pres, Qres, with_diagnostics)
    return K2._frag(O.T, interleave=True), K2._frag(B.T), pts


def check_shape(name, M, C):
    """Raises ValueError for an (M, C) the CUDA source does not compile."""
    if (M, C) not in SHAPES:
        raise ValueError(f"{name}: no CUDA kernel compiled for M={M}, C={C} "
                         f"(ENH3D_SHAPES in csrc/enhance3d.cu has {SHAPES}); "
                         f"use backend='torch'")


def _cuda(fem_values, f, gface, pts, ops, nx, ny, nz, with_diagnostics):
    name = "fused_enhance_stacked_3d"
    M3, C3 = ops.Wf.shape
    M, C = round(M3 ** (1 / 3)), round(C3 ** (1 / 3))
    K2.check_tensors(name, fem_values, f, gface)
    check_shape(name, M, C)
    lib = K2._checked_lib(name, _SOURCE, M, C)
    dev = fem_values.device

    statics = K2._statics((name, with_diagnostics), dev,
                          (ops.Wf, ops.Wbc, ops.Pres, ops.Qres, ops.B, pts),
                          functools.partial(_pack,
                                            with_diagnostics=with_diagnostics))
    w, slack, bcv = K2._outputs(nx * ny * nz, M3, dev, with_diagnostics)
    err = lib.enhance3d_stacked_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(f),
        _ptr(gface), _ptr(statics), _ptr(w), _ptr(slack), _ptr(bcv), nx, ny,
        nz, gface.shape[2], M, C, int(with_diagnostics))
    K2._raise_on(lib, _SOURCE, name, err)
    fused_enhance_stacked_3d.launches += 1
    return w, slack, bcv


def fused_enhance_stacked_3d(fem_values, ops: kkt.SharedOperators, f_fn,
                             g_fn, geom, nx: int, ny: int, nz: int, t_int,
                             spts, with_diagnostics: bool = True,
                             f_shifted_fn=None):
    """Shared-operator 3D enhancement with one stacked contraction
    (replaces ``pallas_kernels.fused_enhance_stacked_3d``).

    fem_values [nz+1, ny+1, nx+1] on the uniform mesh ``geom`` = (x0, hx,
    y0, hy, z0, hz); ``t_int`` [C] interior collocation points and ``spts``
    [S, 3] (tz, ty, tx) surface points in reference coordinates.  Returns
    (w [E, M^3], slack [E], bcv [E]) over hexes (x fastest); slack and bcv
    are None without diagnostics."""
    f, gface, pts = _inputs(fem_values, ops, f_fn, g_fn, geom, nx, ny, nz,
                            t_int, spts, f_shifted_fn)
    run = _plain if fem_values.device.type == "cpu" else _cuda
    return run(fem_values, f, gface, pts, ops, nx, ny, nz, with_diagnostics)


def fused_enhance_stacked_3d_ref(fem_values, ops, f_fn, g_fn, geom, nx, ny,
                                 nz, t_int, spts,
                                 with_diagnostics: bool = True,
                                 f_shifted_fn=None):
    """Plain-torch version of ``fused_enhance_stacked_3d`` (any device)."""
    f, gface, pts = _inputs(fem_values, ops, f_fn, g_fn, geom, nx, ny, nz,
                            t_int, spts, f_shifted_fn)
    return _plain(fem_values, f, gface, pts, ops, nx, ny, nz,
                  with_diagnostics)


reset_launch_counts()
