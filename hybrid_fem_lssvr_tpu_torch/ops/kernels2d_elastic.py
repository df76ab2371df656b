"""Fused 2D vector (elasticity) LSSVR enhancement: the CUDA kernel and its
plain version.

PyTorch counterpart of ``pallas_kernels.fused_enhance_elastic_2d`` of the
JAX package.  Per quad, both displacement components' data are stacked:
f = [f1; f2] at the C^2 interior collocation points and bc = [bc1; bc2], the
bilinear traces of the two nodal grids at the 4M-4 trace points with g1, g2
on the domain edges; then

    w = [Wf | Wbc] [f; bc],   slack = max |f - D w|,   bcv = max |bc - B w|

with the block operators of ``models.elastic.prepare_shared_elastic``
(B = diag(Bs, Bs)).

As in ``ops.kernels2d``, the wrapper samples f1 and f2 with torch into
``[2 C^2, E]`` and g1, g2 only along the domain edges (``[2, 4, Kb, nmax]``);
quad corner coordinates come from ``x0 + e h`` in the run dtype, as the TPU
kernel computes them.  The corner gather, both traces with their edge
override, the contraction and the diagnostics are the kernel's
(``csrc/enhance2d_elastic.cu``).  Given CPU tensors the wrapper runs the
plain version (``fused_enhance_elastic_2d_ref``); given CUDA tensors it
launches the kernel or raises.  The override applies on all four domain
edges, as in the TPU kernel.  Dropped from the TPU version: the 128-lane
tile rule (the kernel masks the ragged edge, so any nx, ny runs; the
reference's ``pick_tile`` returns 0 below 128 quads) and
``_mosaic_x64_safe``.
"""

from __future__ import annotations

import torch

from . import kernels2d as K2
from .kernels import _ptr, _stream

SHAPES = K2.SHAPES  # (M, C) compiled: ENH2D_SHAPES in csrc/enhance_common.cuh
_SOURCE = "enhance2d_elastic"


def reset_launch_counts():
    fused_enhance_elastic_2d.launches = 0


def launch_counts() -> dict:
    return {"fused_enhance_elastic_2d": fused_enhance_elastic_2d.launches}


def _inputs(fem_values, f_fns, g_fns, geom, nx, ny, t_int, bpts):
    """(f [2 C^2, E], gedge [2, 4, Kb, nmax], pts [8, Kb])."""
    if tuple(fem_values.shape) != (2, ny + 1, nx + 1):
        raise ValueError(f"fem_values {tuple(fem_values.shape)} is not the "
                         f"[2, {ny + 1}, {nx + 1}] pair of nodal grids")
    dtype, device = fem_values.dtype, fem_values.device
    xl, yl = K2._corner_coords(geom, nx, ny, dtype, device)
    dX, dY = K2._colloc_offsets(geom, t_int, dtype, device)
    f = torch.cat([K2._sample_rows(fn, xl, yl, dX, dY) for fn in f_fns])
    gedge = torch.stack([K2._sample_gedge(g, geom, nx, ny, bpts, dtype,
                                          device) for g in g_fns])
    return f, gedge, K2._trace_points(bpts, dtype, device)


def _elastic_plain(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics):
    bc = torch.cat([K2._trace_bc(fem_values[c], gedge[c], pts, nx, ny)
                    for c in range(2)])  # [2 Kb, E]
    w = torch.cat([ops.Wf, ops.Wbc], dim=1) @ torch.cat([f, bc])
    if not with_diagnostics:
        return w.T.contiguous(), None, None
    slack = torch.abs(f - ops.D @ w).amax(0)
    bcv = torch.abs(bc - ops.B @ w).amax(0)
    return w.T.contiguous(), slack, bcv


def _pack(Wf, Wbc, D, B, pts):
    """The kernel's statics (csrc/enhance2d_elastic.cu, ``Shape``), all but
    the trace points split and fragment-ordered (``kernels2d._frag``):
    [Wf | Wbc]^T with Wf's rows padded to a multiple of 8 and its output
    columns interleaved (the kernel stages w through shared memory in that
    order), the trace points, D^T, and for each component the rows of B^T
    that its block reads, from the first k-step that holds one of its
    columns of w."""
    R, FR = Wf.shape
    Kb = B.shape[0] // 2
    M2 = R // 2
    Bs = B[:Kb, :M2]
    if not (torch.equal(B[Kb:, M2:], Bs) and not B[:Kb, M2:].any()
            and not B[Kb:, :M2].any()):
        raise ValueError("fused_enhance_elastic_2d: B is not diag(Bs, Bs)")
    FRP = K2._pad8(FR)
    OT = Wf.new_zeros(FRP + Wbc.shape[1], R)
    OT[:FR] = Wf.T
    OT[FRP:] = Wbc.T
    b1 = M2 // 8 * 8
    return (K2._frag(OT, interleave=True), pts, K2._frag(D.T),
            K2._frag(B[:Kb, :K2._pad8(M2)].T), K2._frag(B[Kb:, b1:].T))


def _elastic_cuda(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics):
    name = "fused_enhance_elastic_2d"
    R, C2x2 = ops.Wf.shape
    M, C = K2._shape_of(R // 2, C2x2 // 2)
    K2.check_kernel_inputs(name, fem_values, M, C, f, gedge)
    lib = K2._checked_lib(name, _SOURCE, M, C)
    dev = fem_values.device
    statics = K2._statics(name, dev, (ops.Wf, ops.Wbc, ops.D, ops.B, pts),
                          _pack)
    w, slack, bcv = K2._outputs(nx * ny, R, dev, with_diagnostics)
    err = lib.enhance2d_elastic_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(f),
        _ptr(gedge), _ptr(statics), _ptr(w), _ptr(slack), _ptr(bcv),
        nx, ny, gedge.shape[3], M, C, int(with_diagnostics))
    K2._raise_on(lib, _SOURCE, name, err)
    fused_enhance_elastic_2d.launches += 1
    return w, slack, bcv


def fused_enhance_elastic_2d(fem_values, ops, f_fns, g_fns, geom, nx: int,
                             ny: int, t_int, bpts,
                             with_diagnostics: bool = True):
    """Shared-operator vector enhancement for 2D elasticity (replaces
    ``pallas_kernels.fused_enhance_elastic_2d``).

    fem_values [2, ny+1, nx+1]: the two displacement components' nodal
    grids on the uniform mesh ``geom`` = (x0, hx, y0, hy); ``ops`` the block
    ``SharedOperators`` of ``prepare_shared_elastic`` (Wf [2M^2, 2C^2], Wbc
    [2M^2, 2Kb], D, B = diag(Bs, Bs)); ``f_fns`` = (f1, f2) and ``g_fns`` =
    (g1, g2); ``t_int`` [C] and ``bpts`` [Kb, 2] (ty, tx) as in
    ``ops.kernels2d``.  Returns (w [E, 2M^2], slack [E], bcv [E]) over
    row-major quads, w holding u1's M^2 coefficients then u2's; slack and
    bcv are None without diagnostics."""
    f, gedge, pts = _inputs(fem_values, f_fns, g_fns, geom, nx, ny, t_int,
                            bpts)
    run = _elastic_plain if fem_values.device.type == "cpu" \
        else _elastic_cuda
    return run(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics)


def fused_enhance_elastic_2d_ref(fem_values, ops, f_fns, g_fns, geom, nx, ny,
                                 t_int, bpts, with_diagnostics: bool = True):
    """Plain-torch version of ``fused_enhance_elastic_2d`` (any device)."""
    f, gedge, pts = _inputs(fem_values, f_fns, g_fns, geom, nx, ny, t_int,
                            bpts)
    return _elastic_plain(fem_values, f, gedge, pts, ops, nx, ny,
                          with_diagnostics)


reset_launch_counts()
