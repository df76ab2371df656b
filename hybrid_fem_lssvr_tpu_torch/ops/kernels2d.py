"""Fused 2D LSSVR enhancement: CUDA kernels and their plain versions.

PyTorch counterpart of the three structured-quad kernels of
``hybrid_fem_lssvr_tpu/ops/pallas_kernels.py``:

* ``fused_enhance_stacked_2d``  — constant coefficients, one stacked
  operator [[Wf, Wbc], [Pres, Qres]] applied to [f; bc].
* ``fused_enhance_shared_2d``   — the same inputs for a bundle without the
  residual projector ``Pres`` (four separate products).
* ``fused_enhance_varcoeff_2d`` — per-element operators for
  -div(a grad u): null-space least squares per quad, by semi-normal
  equations (``method='sne'``) or CGS2 QR (``method='qr'``).

Python callables cannot enter a CUDA kernel, so each wrapper samples the
rhs ``f`` (and the coefficient fields a, a_x, a_y) at the C^2 interior
collocation points of every quad into dense ``[rows, E]`` tensors, element
index fastest, and the Dirichlet data ``g`` along the four domain edges
only (it matters for the 2 (nx + ny) - 4 boundary quads).  Quad corner
coordinates come from index arithmetic in the run dtype, ``x0 + ex hx``, as
the TPU kernels compute them.  Everything after the sampling — the corner
gather from the nodal grid, the bilinear trace with the Dirichlet override,
the contractions, the factorisation and the diagnostics — is the kernel's
work (``csrc/enhance2d.cu``, ``csrc/enhance2d_varcoeff.cu``).  A wrapper
given CPU tensors runs its plain version (``*_ref``, same signature and
outputs); given CUDA tensors it launches the kernel or raises.

As the TPU kernels do, the Dirichlet override applies on all four domain
edges; the torch route of ``models.hybrid2d.enhance_2d`` restricts it to
the edges whose ``bc_edges`` entry is "dirichlet".

Dropped from the TPU versions: the 128-lane tile rule (the CUDA kernels
mask the ragged edge, so any nx, ny runs), the bf16-split ``NZ``
contraction of 'sne' (N = G^T G is accumulated in float32 instead) and
``_mosaic_x64_safe``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import cuda_lib
from . import kkt
from .kernels import _ptr, _stream

# (M, C) compiled: ENH2D_SHAPES in csrc/enhance_common.cuh
SHAPES = ((4, 4), (5, 5), (6, 6))
METHODS = ("sne", "qr")
PLAIN_CHUNK = 1 << 17  # quads per batch of the plain per-element version


def reset_launch_counts():
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


# --------------------------------------------------------------------------
# Sampling (shared by each wrapper and its plain version)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _upload(data: bytes, shape, dtype, device):
    return torch.tensor(np.frombuffer(data, np.float64).reshape(shape),
                        dtype=dtype, device=device)


def _const(array, dtype, device):
    """A small host array as a tensor on ``device``, uploaded once per
    content (every solve of a sweep passes the same points).  Read-only:
    the tensor is shared between calls."""
    a = np.ascontiguousarray(array, np.float64)
    return _upload(a.tobytes(), a.shape, dtype, torch.device(device))


def _corner_coords(geom, nx, ny, dtype, device):
    """(xl, yl) [1, E]: lower-left corner of every quad, row-major, from
    index arithmetic in the run dtype."""
    x0, hx, y0, hy = geom
    e = torch.arange(nx * ny, device=device)
    ex = (e % nx).to(dtype)[None]
    ey = torch.div(e, nx, rounding_mode="floor").to(dtype)[None]
    return x0 + ex * hx, y0 + ey * hy


def _colloc_offsets(geom, t_int, dtype, device):
    """(dX, dY) [C^2, 1]: in-element offsets of the C x C collocation grid,
    rows (iy, ix) row-major as the operators' rows."""
    _, hx, _, hy = geom
    t = _const(t_int, dtype, device)
    C = t.shape[0]
    dX = (t.repeat(C)[:, None] + 1.0) * (0.5 * hx)
    dY = (t.repeat_interleave(C)[:, None] + 1.0) * (0.5 * hy)
    return dX, dY


def _sample_rows(fn, xl, yl, dX, dY):
    v = fn(xl + dX, yl + dY)
    return (v * torch.ones_like(xl + dX)).contiguous()  # [C^2, E]


def _sample_f(f_fn, f_shifted_fn, xl, yl, dX, dY):
    if f_shifted_fn is not None:
        v = f_shifted_fn(xl, dX, yl, dY)
        return (v * torch.ones_like(xl + dX)).contiguous()
    return _sample_rows(f_fn, xl, yl, dX, dY)


def _sample_gedge(g_fn, geom, nx, ny, bpts, dtype, device):
    """[4, Kb, max(nx, ny)]: g at the trace points of the boundary quads
    along the left, right (indexed by ey), bottom and top (by ex) edge."""
    x0, hx, y0, hy = geom
    b = _const(bpts, dtype, device)
    bX = (b[:, 1:2] + 1.0) * (0.5 * hx)  # [Kb, 1]
    bY = (b[:, 0:1] + 1.0) * (0.5 * hy)
    xl = x0 + torch.arange(nx, dtype=dtype, device=device)[None] * hx
    yl = y0 + torch.arange(ny, dtype=dtype, device=device)[None] * hy
    nmax = max(nx, ny)
    out = torch.zeros(4, b.shape[0], nmax, dtype=dtype, device=device)
    edges = ((xl[:, :1], yl, ny), (xl[:, -1:], yl, ny),
             (xl, yl[:, :1], nx), (xl, yl[:, -1:], nx))
    for i, (xe, ye, n) in enumerate(edges):
        xb, yb = xe + bX, ye + bY
        out[i, :, :n] = g_fn(xb, yb) * torch.ones_like(xb + yb)
    return out


def _trace_points(bpts, dtype, device):
    """pts [8, Kb]: bilinear shape factors N00, N10, N01, N11 at the trace
    points, then 0/1 flags for a point on the quad's left, right, bottom,
    top edge."""
    b = np.asarray(bpts, np.float64)
    ty, tx = b[:, 0], b[:, 1]
    rows = [0.25 * (1 - tx) * (1 - ty), 0.25 * (1 + tx) * (1 - ty),
            0.25 * (1 - tx) * (1 + ty), 0.25 * (1 + tx) * (1 + ty),
            tx == -1.0, tx == 1.0, ty == -1.0, ty == 1.0]
    return _const(np.stack([np.asarray(r, np.float64) for r in rows]),
                  dtype, device)


def _trace_bc(fem_values, gedge, pts, nx, ny):
    """bc [Kb, E]: bilinear trace of the corner values, with g on the
    domain-boundary edges of the boundary quads."""
    Kb = pts.shape[1]
    u00 = fem_values[:-1, :-1].reshape(1, -1)
    u10 = fem_values[:-1, 1:].reshape(1, -1)
    u01 = fem_values[1:, :-1].reshape(1, -1)
    u11 = fem_values[1:, 1:].reshape(1, -1)
    N = pts[:4, :, None]
    bc = (N[0] * u00 + N[1] * u10 + N[2] * u01 + N[3] * u11).reshape(
        Kb, ny, nx)
    on = pts[4:] > 0.5  # [4, Kb]
    bc[:, -1, :] = torch.where(on[3][:, None], gedge[3][:, :nx], bc[:, -1, :])
    bc[:, 0, :] = torch.where(on[2][:, None], gedge[2][:, :nx], bc[:, 0, :])
    bc[:, :, -1] = torch.where(on[1][:, None], gedge[1][:, :ny], bc[:, :, -1])
    bc[:, :, 0] = torch.where(on[0][:, None], gedge[0][:, :ny], bc[:, :, 0])
    return bc.reshape(Kb, ny * nx)


def _shared_inputs(fem_values, f_fn, g_fn, geom, nx, ny, t_int, bpts,
                   f_shifted_fn):
    if tuple(fem_values.shape) != (ny + 1, nx + 1):
        raise ValueError(f"fem_values {tuple(fem_values.shape)} is not the "
                         f"[{ny + 1}, {nx + 1}] nodal grid")
    dtype, device = fem_values.dtype, fem_values.device
    xl, yl = _corner_coords(geom, nx, ny, dtype, device)
    dX, dY = _colloc_offsets(geom, t_int, dtype, device)
    f = _sample_f(f_fn, f_shifted_fn, xl, yl, dX, dY)
    gedge = _sample_gedge(g_fn, geom, nx, ny, bpts, dtype, device)
    pts = _trace_points(bpts, dtype, device)
    return f, gedge, pts, (xl, yl, dX, dY)


# --------------------------------------------------------------------------
# Plain versions of the kernels (quads on the last axis, as on the TPU)
# --------------------------------------------------------------------------

def _stacked_operator(Wf, Wbc, Pres, Qres, with_diagnostics):
    """O = [[Wf, Wbc], [Pres, Qres]], or its first block row alone."""
    O = torch.cat([Wf, Wbc], dim=1)
    if with_diagnostics:
        O = torch.cat([O, torch.cat([Pres, Qres], dim=1)], dim=0)
    return O


def _stacked_plain(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics):
    M2 = ops.Wf.shape[0]
    bc = _trace_bc(fem_values, gedge, pts, nx, ny)
    O = _stacked_operator(ops.Wf, ops.Wbc, ops.Pres, ops.Qres,
                          with_diagnostics)
    out = O @ torch.cat([f, bc], dim=0)
    w = out[:M2]
    if not with_diagnostics:
        return w.T.contiguous(), None, None
    slack = torch.abs(out[M2:]).amax(0)
    bcv = torch.abs(bc - ops.B @ w).amax(0)
    return w.T.contiguous(), slack, bcv


def _shared_plain(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics):
    bc = _trace_bc(fem_values, gedge, pts, nx, ny)
    w = ops.Wf @ f + ops.Wbc @ bc
    if not with_diagnostics:
        return w.T.contiguous(), None, None
    slack = torch.abs(f - ops.D @ w).amax(0)
    bcv = torch.abs(bc - ops.B @ w).amax(0)
    return w.T.contiguous(), slack, bcv


def _varcoeff_system(coef, f, bc, vops, s2):
    """One chunk of quads' (wp = Pbc bc [M2, E], g [E, C2], G [E, C2, K])."""
    C2 = f.shape[0]
    a, ax, ay = coef[0], coef[1], coef[2]  # [C2, E]
    AZ = vops.AZ.reshape(4, C2, -1)
    wp = vops.Pbc @ bc  # [M2, E]
    apbc = (vops.AP @ bc).reshape(4, C2, -1)
    Dwp = -a * apbc[0] - ax * apbc[1] - ay * apbc[2] + apbc[3]
    g = (f * (1.0 / s2) - Dwp).T  # scaled residual rhs [E, C2]
    G = (-a.T[:, :, None] * AZ[0] - ax.T[:, :, None] * AZ[1]
         - ay.T[:, :, None] * AZ[2] + AZ[3])  # [E, C2, K]
    return wp, g, G


def _varcoeff_plain_chunk(coef, f, bc, vops, s2, method, with_diagnostics):
    wp, g, G = _varcoeff_system(coef, f, bc, vops, s2)
    if method == "qr":
        lstsq, _ = kkt._batched_mgs_qr_factor(G)
        y = lstsq(g)
    else:
        # Semi-normal equations with one refinement step in the factored
        # system (cholesky_ex: a NaN element must not raise).
        N = torch.einsum("eqj,eqk->ejk", G, G)
        L = torch.linalg.cholesky_ex(N).L

        def nsolve(r):
            rhs = torch.einsum("eqk,eq->ek", G, r)[..., None]
            return torch.cholesky_solve(rhs, L)[..., 0]

        y = nsolve(g)
        y = y + nsolve(g - torch.einsum("eqk,ek->eq", G, y))
    w = wp + vops.Z @ y.T  # [M2, E]
    if not with_diagnostics:
        return w.T, None, None
    e_res = g - torch.einsum("eqk,ek->eq", G, y)
    slack = s2 * torch.abs(e_res).amax(1)
    bcv = torch.abs(bc - vops.B @ w).amax(0)
    return w.T, slack, bcv


def _varcoeff_plain(fem_values, coef, f, gedge, pts, vops, nx, ny, s2,
                    method, with_diagnostics):
    bc = _trace_bc(fem_values, gedge, pts, nx, ny)
    E = nx * ny
    parts = [
        _varcoeff_plain_chunk(coef[:, :, lo:lo + PLAIN_CHUNK],
                              f[:, lo:lo + PLAIN_CHUNK],
                              bc[:, lo:lo + PLAIN_CHUNK], vops, s2, method,
                              with_diagnostics)
        for lo in range(0, E, PLAIN_CHUNK)
    ]
    w = torch.cat([p[0] for p in parts]).contiguous()
    if not with_diagnostics:
        return w, None, None
    return (w, torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

def check_shape(name, M, C):
    """Raises ValueError for an (M, C) the CUDA sources do not compile."""
    if (M, C) not in SHAPES:
        raise ValueError(f"{name}: no CUDA kernel compiled for M={M}, "
                         f"C={C} (ENH2D_SHAPES in csrc/enhance_common.cuh has "
                         f"{SHAPES}); use backend='torch'")


def check_kernel_inputs(name, fem_values, M, C, *tensors):
    """What the CUDA kernels take: contiguous float32 CUDA tensors on one
    device and an (M, C) pair in ``SHAPES``.  Raises ValueError otherwise."""
    check_tensors(name, fem_values, *tensors)
    check_shape(name, M, C)


def check_tensors(name, fem_values, *tensors):
    """Raises ValueError unless ``fem_values`` and ``tensors`` are
    contiguous float32 tensors on one CUDA device."""
    if fem_values.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{fem_values.device}")
    for t in (fem_values,) + tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernel is float32-only, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.device != fem_values.device:
            raise ValueError(f"{name}: inputs must be contiguous and on "
                             f"{fem_values.device}")


def _checked_lib(name, source, M, C):
    lib = cuda_lib.load(source)
    if not getattr(lib, f"{source}_supported")(M, C):
        raise RuntimeError(f"{name}: {source}.cu was not compiled for "
                           f"M={M}, C={C} although SHAPES lists it")
    return lib


def _raise_on(lib, source, name, err):
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}): {msg}")


_STATICS = {}  # kernel variant -> (operator tensors, their packed copy)


def _statics(key, device, mats, pack=None):
    """The operators ``mats`` flattened into one float32 buffer on
    ``device``, in order (``pack`` may rearrange them first).  The buffer of
    the last bundle is kept per kernel variant: a solver, and every solve of
    a sweep, passes the same operator tensors again."""
    key = (key, device)
    hit = _STATICS.get(key)
    if (hit is not None and len(hit[0]) == len(mats)
            and all(a is m and v == m._version
                    for (a, v), m in zip(hit[0], mats))):
        return hit[1]
    parts = mats if pack is None else pack(*mats)
    flat = torch.cat([m.reshape(-1) for m in parts]).to(
        device=device, dtype=torch.float32).contiguous()
    _STATICS[key] = ([(m, m._version) for m in mats], flat)
    return flat


def _pad8(n):
    return -(-n // 8) * 8


def _tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the
    13 low mantissa bits dropped, to nearest, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


# The column order within an n-tile of a product whose outputs feed a second
# product as its A fragments (csrc/enhance_mma.cuh).
_INTERLEAVE = (0, 4, 1, 5, 2, 6, 3, 7)


def _split(op, interleave):
    """(hi, lo, lo2) of ``op`` [K, N] in float32, zero-padded to K and N
    multiples of 8, with the columns of each n-tile in the order
    ``_INTERLEAVE`` where ``interleave``: hi = tf32(x), lo = tf32(x - hi),
    lo2 = tf32(x - hi - lo), so hi + lo + lo2 = x exactly."""
    K, N = op.shape
    Kp, Np = _pad8(K), _pad8(N)
    p = op.new_zeros(Kp, Np, dtype=torch.float32)
    p[:K, :N] = op
    if interleave:
        p = p.reshape(Kp, Np // 8, 8)[:, :, list(_INTERLEAVE)].reshape(Kp, Np)
    hi = _tf32(p)
    lo = _tf32(p - hi)
    return hi, lo, _tf32(p - hi - lo)


def _fragment_order(x):
    """[Kp, Np] as [Kp/8, Np/8, 32, 2]: lane 4 g + t of k-step ks and
    n-tile nt holds (x[8 ks + t, 8 nt + g], x[8 ks + t + 4, 8 nt + g])."""
    Kp, Np = x.shape
    # [ks, h, t, nt, g] -> [ks, nt, g, t, h]
    return x.reshape(Kp // 8, 2, 4, Np // 8, 8).permute(0, 3, 4, 2, 1) \
        .reshape(Kp // 8, Np // 8, 32, 2)


def _frag(op, interleave=False):
    """``op`` [K, N] as the tensor-core kernels read an operator
    (``csrc/enhance_mma.cuh``): split into TF32 hi and lo (``_split``) and
    packed in fragment order [K/8, N/8, 32, 4], lane 4 g + t of k-step ks
    and n-tile nt holding (b0.hi, b1.hi, b0.lo, b1.lo) with
    b0 = op[8 ks + t, 8 nt + g] and b1 = op[8 ks + t + 4, 8 nt + g]."""
    hi, lo, _ = _split(op, interleave)
    return torch.cat([_fragment_order(hi), _fragment_order(lo)], dim=-1)


def _frag_lo2(op, interleave=False):
    """The third piece of ``op``'s split, lo2 (``_split``), where a kernel
    takes five TF32 products: [K/8, N/8, 32, 2] of (b0.lo2, b1.lo2)."""
    return _fragment_order(_split(op, interleave)[2])


def _outputs(E, M2, dev, with_diagnostics):
    w = torch.empty(E, M2, dtype=torch.float32, device=dev)
    if not with_diagnostics:
        return w, None, None
    return (w, torch.empty(E, dtype=torch.float32, device=dev),
            torch.empty(E, dtype=torch.float32, device=dev))


def _shape_of(ops_rows, n_cols):
    M = int(round(np.sqrt(ops_rows)))
    C = int(round(np.sqrt(n_cols)))
    return M, C


def _pack_stacked(Wf, Wbc, Pres, Qres, B, pts, with_diagnostics=True):
    """The statics of stacked2d_kernel (csrc/enhance2d.cu, ``Stacked``):
    O^T [C^2 + Kb, rows], w's output columns interleaved (B w reads w from
    the accumulators), and B^T [M^2, Kb], both split and fragment-ordered
    (``_frag``), then the trace points."""
    O = _stacked_operator(Wf, Wbc, Pres, Qres, with_diagnostics)
    return _frag(O.T, interleave=True), _frag(B.T), pts


def _pack_shared(Wf, Wbc, D, B, pts):
    """The statics of shared2d_kernel (csrc/enhance2d.cu, ``Shared``):
    W^T = [Wf | Wbc]^T [C^2 + Kb, M^2], w's output columns interleaved,
    split, then the lo2 of its rows from c1 = 8 floor(C^2 / 8) on (the
    k-steps that take five products); R^T = [D; B]^T [M^2, C^2 + Kb] split,
    its columns [0, c1) (D's rows alone) and the rest as two blocks; all
    fragment-ordered (``_frag``); then the trace points.  Output column c
    of R w is compared with row c of z = [f; bc]."""
    c1 = Wf.shape[1] // 8 * 8
    WT = torch.cat([Wf, Wbc], dim=1).T
    RT = torch.cat([D, B], dim=0).T
    return (_frag(WT, interleave=True), _frag_lo2(WT[c1:], interleave=True),
            _frag(RT[:, :c1]), _frag(RT[:, c1:]), pts)


def _launch_2d(name, entry, fem_values, f, gedge, pts, ops, mats, pack,
               nx, ny, with_diagnostics):
    M2, C2 = ops.Wf.shape
    M, C = _shape_of(M2, C2)
    check_kernel_inputs(name, fem_values, M, C, f, gedge)
    lib = _checked_lib(name, "enhance2d", M, C)
    dev = fem_values.device
    statics = _statics((name, with_diagnostics), dev, mats, pack)
    w, slack, bcv = _outputs(nx * ny, M2, dev, with_diagnostics)
    err = getattr(lib, entry)(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(f),
        _ptr(gedge), _ptr(statics), _ptr(w), _ptr(slack), _ptr(bcv),
        nx, ny, gedge.shape[2], M, C, int(with_diagnostics))
    _raise_on(lib, "enhance2d", name, err)
    return w, slack, bcv


def _stacked_cuda(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics):
    out = _launch_2d(
        "fused_enhance_stacked_2d", "enhance2d_stacked_f32", fem_values, f,
        gedge, pts, ops, (ops.Wf, ops.Wbc, ops.Pres, ops.Qres, ops.B, pts),
        functools.partial(_pack_stacked, with_diagnostics=with_diagnostics),
        nx, ny, with_diagnostics)
    fused_enhance_stacked_2d.launches += 1
    return out


def _shared_cuda(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics):
    out = _launch_2d(
        "fused_enhance_shared_2d", "enhance2d_shared_f32", fem_values, f,
        gedge, pts, ops, (ops.Wf, ops.Wbc, ops.D, ops.B, pts), _pack_shared,
        nx, ny, with_diagnostics)
    fused_enhance_shared_2d.launches += 1
    return out


def _varcoeff_cuda(fem_values, coef, f, gedge, pts, vops, nx, ny, s2,
                   method, with_diagnostics):
    name = "fused_enhance_varcoeff_2d"
    M2 = vops.Z.shape[0]
    M, C = _shape_of(M2, f.shape[0])
    check_kernel_inputs(name, fem_values, M, C, coef, f, gedge)
    source = "enhance2d_varcoeff"
    lib = _checked_lib(name, source, M, C)
    dev = fem_values.device
    statics = _statics(name, dev, (vops.AZ, vops.AP, vops.Z, vops.Pbc,
                                   vops.B, pts))
    w, slack, bcv = _outputs(nx * ny, M2, dev, with_diagnostics)
    err = lib.enhance2d_varcoeff_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(coef),
        _ptr(f), _ptr(gedge), _ptr(statics), _ptr(w), _ptr(slack),
        _ptr(bcv), nx, ny, gedge.shape[2], M, C, float(1.0 / s2), float(s2),
        int(vops.n_terms), METHODS.index(method), int(with_diagnostics))
    _raise_on(lib, source, name, err)
    fused_enhance_varcoeff_2d.launches += 1
    return w, slack, bcv


# --------------------------------------------------------------------------
# Public wrappers and plain versions
# --------------------------------------------------------------------------

def _check_stacked_args(ops):
    if ops.Pres is None or ops.Qres is None:
        raise ValueError("ops has no residual operators; use a host "
                         "precompute (precompute_shared_*_host)")


def fused_enhance_stacked_2d(fem_values, ops: kkt.SharedOperators, f_fn,
                             g_fn, geom, nx: int, ny: int, t_int, bpts,
                             with_diagnostics: bool = True,
                             f_shifted_fn=None):
    """Shared-operator 2D enhancement with one stacked contraction
    (replaces ``pallas_kernels.fused_enhance_stacked_2d``).

    fem_values [ny+1, nx+1] nodal grid on the uniform mesh ``geom`` =
    (x0, hx, y0, hy); ``t_int`` [C] interior collocation points and
    ``bpts`` [4M-4, 2] (ty, tx) trace points in reference coordinates.
    With f at the C^2 collocation points of each quad and bc its boundary
    trace (bilinear FEM trace, g on domain-boundary edges):

        [w; e] = [[Wf, Wbc], [Pres, Qres]] [f; bc]
        slack  = max |e|,   bcv = max |bc - B w|

    Returns (w [E, M^2], slack [E], bcv [E]) over row-major quads; slack
    and bcv are None without diagnostics."""
    _check_stacked_args(ops)
    f, gedge, pts, _ = _shared_inputs(fem_values, f_fn, g_fn, geom, nx, ny,
                                      t_int, bpts, f_shifted_fn)
    run = _stacked_plain if fem_values.device.type == "cpu" else _stacked_cuda
    return run(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics)


def fused_enhance_stacked_2d_ref(fem_values, ops, f_fn, g_fn, geom, nx, ny,
                                 t_int, bpts, with_diagnostics: bool = True,
                                 f_shifted_fn=None):
    """Plain-torch version of ``fused_enhance_stacked_2d`` (any device)."""
    _check_stacked_args(ops)
    f, gedge, pts, _ = _shared_inputs(fem_values, f_fn, g_fn, geom, nx, ny,
                                      t_int, bpts, f_shifted_fn)
    return _stacked_plain(fem_values, f, gedge, pts, ops, nx, ny,
                          with_diagnostics)


def fused_enhance_shared_2d(fem_values, ops: kkt.SharedOperators, f_fn, g_fn,
                            geom, nx: int, ny: int, t_int, bpts,
                            with_diagnostics: bool = True,
                            f_shifted_fn=None):
    """Shared-operator 2D enhancement from the four separate operators
    (replaces ``pallas_kernels.fused_enhance_shared_2d``): the inputs of
    ``fused_enhance_stacked_2d``, w = Wf f + Wbc bc, and optionally
    slack = max |f - D w|, bcv = max |bc - B w|."""
    f, gedge, pts, _ = _shared_inputs(fem_values, f_fn, g_fn, geom, nx, ny,
                                      t_int, bpts, f_shifted_fn)
    run = _shared_plain if fem_values.device.type == "cpu" else _shared_cuda
    return run(fem_values, f, gedge, pts, ops, nx, ny, with_diagnostics)


def fused_enhance_shared_2d_ref(fem_values, ops, f_fn, g_fn, geom, nx, ny,
                                t_int, bpts, with_diagnostics: bool = True,
                                f_shifted_fn=None):
    """Plain-torch version of ``fused_enhance_shared_2d`` (any device)."""
    f, gedge, pts, _ = _shared_inputs(fem_values, f_fn, g_fn, geom, nx, ny,
                                      t_int, bpts, f_shifted_fn)
    return _shared_plain(fem_values, f, gedge, pts, ops, nx, ny,
                         with_diagnostics)


def _varcoeff_inputs(fem_values, vops, a_fn, grad_a, f_fn, g_fn, geom, nx,
                     ny, t_int, bpts, f_shifted_fn, method):
    if vops.AZ is None or vops.AP is None:
        raise ValueError("vops must carry the AZ/AP fused precompute")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if grad_a is None:
        raise ValueError(
            "fused_enhance_varcoeff_2d requires analytic grad_a "
            "(problem.grad_a); use backend='torch' for autograd-derived "
            "gradients")
    f, gedge, pts, (xl, yl, dX, dY) = _shared_inputs(
        fem_values, f_fn, g_fn, geom, nx, ny, t_int, bpts, f_shifted_fn)
    coef = torch.stack([_sample_rows(fn, xl, yl, dX, dY)
                        for fn in (a_fn, grad_a[0], grad_a[1])])
    return coef, f, gedge, pts


def fused_enhance_varcoeff_2d(fem_values, vops, a_fn, grad_a, f_fn, g_fn,
                              geom, nx: int, ny: int, t_int, bpts, s2: float,
                              with_diagnostics: bool = True,
                              f_shifted_fn=None, method: str = "qr"):
    """Per-element-operator 2D enhancement for -div(a grad u) (replaces
    ``pallas_kernels.fused_enhance_varcoeff_2d``).

    ``vops`` is a ``models.hybrid2d.VarCoeff2DOperators`` with the AZ/AP
    precompute (scaled by 1/``s2``, s2 = sx^2 + sy^2).  Per quad, with the
    coefficient fields sampled at its collocation points:

        wp = Pbc bc;   g = f / s2 - D~ wp
        G_k = -a AZ0_k - a_x AZ1_k - a_y AZ2_k + AZ3_k
        y = argmin ||G y - g||;   w = wp + Z y

    ``method='qr'`` factors G by CGS2; ``'sne'`` solves the normal
    equations N = G^T G by Cholesky and adds one refinement step in the
    factored system.  Returns (w [E, M^2], slack = s2 max |g - G y|,
    bcv = max |bc - B w|), the last two None without diagnostics."""
    coef, f, gedge, pts = _varcoeff_inputs(
        fem_values, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int,
        bpts, f_shifted_fn, method)
    run = _varcoeff_plain if fem_values.device.type == "cpu" \
        else _varcoeff_cuda
    return run(fem_values, coef, f, gedge, pts, vops, nx, ny, s2, method,
               with_diagnostics)


def fused_enhance_varcoeff_2d_ref(fem_values, vops, a_fn, grad_a, f_fn, g_fn,
                                  geom, nx, ny, t_int, bpts, s2,
                                  with_diagnostics: bool = True,
                                  f_shifted_fn=None, method: str = "qr"):
    """Plain-torch version of ``fused_enhance_varcoeff_2d`` (any device)."""
    coef, f, gedge, pts = _varcoeff_inputs(
        fem_values, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int,
        bpts, f_shifted_fn, method)
    return _varcoeff_plain(fem_values, coef, f, gedge, pts, vops, nx, ny, s2,
                           method, with_diagnostics)


def varcoeff_least_squares_system(fem_values, vops, a_fn, grad_a, f_fn,
                                  g_fn, geom, nx, ny, t_int, bpts, s2,
                                  f_shifted_fn=None):
    """The quads' systems as the plain version of
    ``fused_enhance_varcoeff_2d`` builds them (either method): (G [E, C^2,
    K], g [E, C^2]), y = argmin ||G y - g||."""
    coef, f, gedge, pts = _varcoeff_inputs(
        fem_values, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int,
        bpts, f_shifted_fn, "qr")
    bc = _trace_bc(fem_values, gedge, pts, nx, ny)
    _, g, G = _varcoeff_system(coef, f, bc, vops, s2)
    return G, g


_WRAPPERS = (fused_enhance_stacked_2d, fused_enhance_shared_2d,
             fused_enhance_varcoeff_2d)
reset_launch_counts()
