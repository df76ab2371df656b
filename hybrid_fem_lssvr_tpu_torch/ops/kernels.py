"""Fused 1D LSSVR enhancement: CUDA kernels and their plain versions.

PyTorch counterpart of the three 1D kernels of
``hybrid_fem_lssvr_tpu/ops/pallas_kernels.py``:

* ``fused_enhance_separable`` — constant coefficients, separable rhs.
* ``fused_enhance_shared``    — constant coefficients, generic rhs.
* ``fused_enhance_varcoeff``  — per-element operators (uniform or graded).

Each wrapper samples the problem's rhs and coefficient callables with torch
(Python callables cannot enter a CUDA kernel) and hands the kernel dense
inputs; everything after the sampling — the contractions, the CGS2 QR, the
back substitution, the diagnostics, the gate and the fallback — is the
kernel's work (``csrc/enhance1d.cu``).  A wrapper given CPU tensors runs
its plain version (``*_ref``, same signature and outputs); given CUDA
tensors it launches the kernel or raises.

Dropped from the TPU versions: the 128-lane tile rule (``pick_tile``; the
CUDA kernels mask the ragged edge, so any E works), ``_mosaic_x64_safe``
(a Mosaic lowering workaround) and the translation closure of the
separable kernel (factors are sampled per element here).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..utils import cuda_lib
from . import kkt, legendre

MAX_FACTORS = 4  # separable rhs rank R (kMaxR in the CUDA source)
# (M, C) compiled: ENH_SHAPES in csrc/enhance1d.cu
SHAPES = ((4, 12), (6, 12), (8, 12), (10, 12), (12, 12), (6, 10))


def reset_launch_counts():
    for fn in _WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


@dataclasses.dataclass(frozen=True)
class VarCoeffOperators:
    """Static host-precomputed operators for ``fused_enhance_varcoeff``.

    All operator rows are globally scaled by 1/s^2 (s = 2/h): the LSE
    minimiser is scale-invariant and the scaling keeps every f32
    intermediate O(1) at any element count.
    """

    AZ: torch.Tensor  # [3, C, K]  (W2 Z, W1 Z, W0 Z)
    AP: torch.Tensor  # [3, C, 2]  (W2 Pbc, W1 Pbc, W0 Pbc)
    Z: torch.Tensor  # [M, K] orthonormal null basis of B
    Pbc: torch.Tensor  # [M, 2] min-norm particular map
    B: torch.Tensor  # [2, M]
    K: int
    s2: float

    @classmethod
    def host(cls, M, n_colloc, h, dtype=torch.float32) -> "VarCoeffOperators":
        """Build in numpy float64 on the host (JAX ``VarCoeffOperators``
        constructor); tensors land on the CPU — move with ``.to``."""
        V0, V1, V2 = legendre.collocation_vandermonde_host(M, n_colloc)
        B = np.stack([V0[0], V0[-1]])
        Z, Pbc = kkt.nullspace_host(B)
        s = 2.0 / float(h)
        Ws = (V2, V1 / s, V0 / s**2)  # D/s^2 = a2 W2 + a1 W1 + a0 W0
        return cls(
            AZ=torch.as_tensor(np.stack([w @ Z for w in Ws]), dtype=dtype),
            AP=torch.as_tensor(np.stack([w @ Pbc for w in Ws]), dtype=dtype),
            Z=torch.as_tensor(Z, dtype=dtype),
            Pbc=torch.as_tensor(Pbc, dtype=dtype),
            B=torch.as_tensor(B, dtype=dtype),
            K=Z.shape[1],
            s2=s * s,
        )

    def to(self, device=None, dtype=None) -> "VarCoeffOperators":
        return kkt.bundle_to(self, device, dtype)


# --------------------------------------------------------------------------
# Sampling (shared by each wrapper and its plain version)
# --------------------------------------------------------------------------

def _left_edges(E, x0, h, dtype, device):
    """xl = x0 + e h in the run dtype, from index arithmetic (as the TPU
    kernels compute it; reading ``nodes`` would round differently)."""
    return x0 + torch.arange(E, dtype=dtype, device=device) * h


def _sample_separable(fem_values, f_elem_factors_fn, x0, h):
    E = fem_values.shape[0] - 1
    xl = _left_edges(E, x0, h, fem_values.dtype, fem_values.device)[None]
    rows = [torch.as_tensor(v, dtype=fem_values.dtype,
                            device=fem_values.device).expand(1, E)
            for v in f_elem_factors_fn(xl)]
    return torch.cat(rows, dim=0).contiguous()  # [R, E]


def _sample_shared(fem_values, f_fn, x0, h, n_colloc, f_shifted_fn):
    E = fem_values.shape[0] - 1
    dtype, device = fem_values.dtype, fem_values.device
    t = legendre.collocation_points(n_colloc, dtype=dtype, device=device)
    xl = _left_edges(E, x0, h, dtype, device)[None]  # [1, E]
    tloc = ((t + 1.0) * (0.5 * h))[:, None]  # [C, 1]
    if f_shifted_fn is not None:
        f = f_shifted_fn(xl, tloc)
    else:
        f = f_fn(xl + tloc)
    return f.expand(n_colloc, E).contiguous()  # [C, E]


def _sample_varcoeff(fem_values, problem, x0, h, n_colloc, f_shifted_fn,
                     nodes):
    """Returns (coef [4, C, E] = (a2, a1, a0, f), he [E] or None).

    ``fem_values`` (and ``nodes``) [N] is one mesh, [P, Ef+1] a family of P
    meshes: the callables see points [P, C, Ef] (P = 1 for one mesh; the
    family axis leads, so a parameter shaped [P, 1, 1] broadcasts),
    E = P Ef, and element p Ef + k is family p's element k.
    """
    Ef = fem_values.shape[-1] - 1
    P = fem_values.numel() // (Ef + 1)
    dtype, device = fem_values.dtype, fem_values.device
    t = legendre.collocation_points(n_colloc, dtype=dtype, device=device)
    if nodes is not None:
        nodes = nodes.reshape(P, Ef + 1)
        xl = nodes[:, None, :-1]  # [P, 1, Ef]
        he = nodes[:, 1:] - nodes[:, :-1]  # [P, Ef]
        d = ((t + 1.0) * 0.5)[None, :, None] * he[:, None, :]  # [P, C, Ef]
    else:
        xl = _left_edges(Ef, x0, h, dtype, device)[None, None, :]
        he = None
        d = ((t + 1.0) * (0.5 * h))[None, :, None]  # [1, C, 1]
    xq = xl + d
    a2, a1, a0 = problem.colloc_coeffs(xq)
    if f_shifted_fn is not None and nodes is None:
        f = f_shifted_fn(xl, d)
    else:
        f = problem.f(xq) * torch.ones_like(xq)
    coef = torch.stack([v.expand(P, n_colloc, Ef) for v in (a2, a1, a0, f)])
    coef = coef.transpose(1, 2).reshape(4, n_colloc, P * Ef)
    return coef.contiguous(), (None if he is None else
                               he.reshape(-1).contiguous())


def _nodal_pairs(fem_values):
    """bc [2, E]: each element's (left, right) nodal values, within its own
    family of [P, Ef+1] ([N]: one family)."""
    fam = fem_values.reshape(-1, fem_values.shape[-1])
    return torch.stack([fam[:, :-1].reshape(-1), fam[:, 1:].reshape(-1)])


# --------------------------------------------------------------------------
# Plain versions of the kernels (elements on the last axis, as on the TPU)
# --------------------------------------------------------------------------

def _separable_plain(fem_values, a, ops, with_diagnostics, with_fallback):
    M = ops.Wf.shape[0]
    WfFT, PFT = ops.WfF.T, ops.PF.T  # [M, R], [C, R]
    R = a.shape[0]
    bcs = (fem_values[:-1][None], fem_values[1:][None])  # 2 x [1, E]
    w = WfFT[:, 0:1] * a[0:1]  # [M, E]
    for r in range(1, R):
        w = w + WfFT[:, r:r + 1] * a[r:r + 1]
    for j in range(2):
        w = w + ops.Wbc[:, j:j + 1] * bcs[j]
    if not with_diagnostics:
        return w.T.contiguous(), None, None
    e_res = PFT[:, 0:1] * a[0:1]  # [C, E]
    for r in range(1, R):
        e_res = e_res + PFT[:, r:r + 1] * a[r:r + 1]
    for j in range(2):
        e_res = e_res + ops.Qres[:, j:j + 1] * bcs[j]
    slack = torch.abs(e_res).amax(0, keepdim=True)
    BT = ops.B.T  # [M, 2]
    b0 = torch.sum(BT[:, 0:1] * w, dim=0, keepdim=True)
    b1 = torch.sum(BT[:, 1:2] * w, dim=0, keepdim=True)
    bcv = torch.maximum(torch.abs(bcs[0] - b0), torch.abs(bcs[1] - b1))
    if not with_fallback:
        return w.T.contiguous(), slack[0], bcv[0]
    finite = torch.isfinite(slack) & torch.isfinite(bcv)
    scale = 1.0 + torch.maximum(torch.abs(bcs[0]), torch.abs(bcs[1]))
    ok = finite & (bcv <= 0.01 * scale)
    # Linear-interpolant fallback [(ul+ur)/2, (ur-ul)/2, 0, ...] via masks
    # (a NaN boundary value poisons every coefficient, as on the TPU).
    m_idx = torch.arange(M, device=w.device)[:, None]
    wf = (m_idx == 0) * 0.5 * (bcs[0] + bcs[1]) \
        + (m_idx == 1) * 0.5 * (bcs[1] - bcs[0])
    w_safe = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    w = torch.where(ok, w_safe, wf.to(w.dtype))
    return w.T.contiguous(), slack[0], bcv[0], ok[0].to(w.dtype)


def _shared_plain(fem_values, f, ops, with_diagnostics):
    bc = torch.stack([fem_values[:-1], fem_values[1:]])  # [2, E]
    w = ops.Wf @ f + ops.Wbc @ bc  # [M, E]
    if not with_diagnostics:
        return w.T.contiguous(), None, None
    slack = torch.abs(f - ops.D @ w).amax(0)
    bcv = torch.abs(bc - ops.B @ w).amax(0)
    return w.T.contiguous(), slack, bcv


def _varcoeff_system(fem_values, coef, he, host, h):
    """(bc [2, E], wp = Pbc bc [M, E], g [C, E], G: K columns [C, E]) of the
    elements' scaled systems."""
    C = coef.shape[1]
    a2, a1, a0, f = coef[0], coef[1], coef[2], coef[3]  # [C, E]
    if he is not None:
        # Graded mode: fold rho = h_ref / h_e into the coefficients,
        # D_e / s_ref^2 = (a2 rho^2) W2 + (a1 rho) W1 + a0 W0.
        rho = h / he[None]
        a2 = a2 * (rho * rho)
        a1 = a1 * rho
    AZ2, AZ1, AZ0 = host.AZ[0], host.AZ[1], host.AZ[2]
    bc = _nodal_pairs(fem_values)  # [2, E]
    wp = host.Pbc @ bc  # [M, E]
    apbc = host.AP.reshape(3 * C, 2) @ bc  # [3C, E]
    Dwp = a2 * apbc[0:C] + a1 * apbc[C:2 * C] + a0 * apbc[2 * C:3 * C]
    g = f * (1.0 / host.s2) - Dwp  # scaled residual rhs [C, E]
    G = [a2 * AZ2[:, k:k + 1] + a1 * AZ1[:, k:k + 1] + a0 * AZ0[:, k:k + 1]
         for k in range(host.K)]
    return bc, wp, g, G


def _varcoeff_plain(fem_values, coef, he, host, h, with_diagnostics):
    K = host.K
    bc, wp, g, G = _varcoeff_system(fem_values, coef, he, host, h)
    # CGS2 QR over the K columns (kkt._batched_mgs_qr_factor's algebra).
    Qc = []
    R = [[None] * K for _ in range(K)]
    for j in range(K):
        v = G[j]
        for _pass in range(2):
            for i in range(j):
                rij = torch.sum(Qc[i] * v, dim=0, keepdim=True)
                R[i][j] = rij if R[i][j] is None else R[i][j] + rij
                v = v - rij * Qc[i]
        rjj = torch.sqrt(torch.sum(v * v, dim=0, keepdim=True))
        R[j][j] = rjj
        Qc.append(v / (rjj + 1e-30))
    qtg = [torch.sum(Qc[j] * g, dim=0, keepdim=True) for j in range(K)]
    y = [None] * K
    for j in reversed(range(K)):
        acc = qtg[j]
        for i in range(j + 1, K):
            acc = acc - R[j][i] * y[i]
        y[j] = acc / (R[j][j] + 1e-30)
    w = wp + host.Z @ torch.cat(y, dim=0)  # [M, E]
    if not with_diagnostics:
        return w.T.contiguous(), None, None, None
    e_res = g
    for k in range(K):
        e_res = e_res - G[k] * y[k]
    # Back to the original row scale: f - D w = s^2 (g~ - G~ y).
    slack = host.s2 * torch.abs(e_res).amax(0)
    bcv = torch.abs(bc - host.B @ w).amax(0)
    dR = torch.cat([R[j][j] for j in range(K)], dim=0)  # [K, E]
    cond = dR.amax(0) / torch.clamp(dR.amin(0), min=1e-30)
    return w.T.contiguous(), slack, bcv, cond


# --------------------------------------------------------------------------
# CUDA launches
# --------------------------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _load_checked(name, fem_values, M, C, *tensors):
    """Validates the inputs, loads the kernel library and checks that it
    was compiled for (M, C) (``ENH_SHAPES`` in the CUDA source)."""
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
    lib = cuda_lib.load()
    if not lib.enhance1d_supported(M, C):
        raise ValueError(f"{name}: no CUDA kernel compiled for M={M}, "
                         f"C={C} (ENH_SHAPES in csrc/enhance1d.cu); use "
                         f"backend='torch'")
    return lib


def _statics(device, *mats):
    return torch.cat([m.reshape(-1) for m in mats]).to(
        device=device, dtype=torch.float32).contiguous()


def _raise_on(lib, name, err):
    if err != 0:
        msg = lib.enhance1d_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}): {msg}")


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _pad_cols(x, n):
    """x [..., k] with zero columns appended up to n."""
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def pack_varcoeff(host):
    """The statics of varcoeff_kernel (csrc/enhance1d.cu, ``VcLayout``), row
    by row so that the kernel reads them as float4 broadcasts: AZ [C][3][KP]
    (W2 Z, W1 Z, W0 Z of row c), AP [C][8] (W2 Pbc, W1 Pbc, W0 Pbc of row c,
    two zeros), Z [M][KP], B [2][MP], Pbc [M][2]; KP and MP are K and M
    rounded up to a multiple of 4, zeros in the padding."""
    M, K = host.Z.shape
    C = host.AZ.shape[1]
    KP, MP = -(-K // 4) * 4, -(-M // 4) * 4
    return (_pad_cols(host.AZ.permute(1, 0, 2), KP),
            _pad_cols(host.AP.permute(1, 0, 2).reshape(C, 6), 8),
            _pad_cols(host.Z, KP), _pad_cols(host.B, MP), host.Pbc)


def _separable_cuda(fem_values, a, ops, with_diagnostics, with_fallback):
    name = "fused_enhance_separable"
    E = fem_values.shape[0] - 1
    M, C = ops.Wf.shape
    R = a.shape[0]
    if R > MAX_FACTORS:
        raise ValueError(f"{name}: rhs rank R={R} > {MAX_FACTORS}")
    lib = _load_checked(name, fem_values, M, C, a)
    dev = fem_values.device
    statics = _statics(dev, ops.WfF.T, ops.Wbc, ops.PF.T, ops.Qres, ops.B)
    w = torch.empty(E, M, dtype=torch.float32, device=dev)
    slack = bcv = ok = None
    if with_diagnostics:
        slack = torch.empty(E, dtype=torch.float32, device=dev)
        bcv = torch.empty(E, dtype=torch.float32, device=dev)
    if with_fallback:
        ok = torch.empty(E, dtype=torch.float32, device=dev)
    err = lib.enhance1d_separable_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(a),
        _ptr(statics), _ptr(w), _ptr(slack), _ptr(bcv), _ptr(ok),
        E, M, C, R, int(with_diagnostics), int(with_fallback))
    _raise_on(lib, name, err)
    fused_enhance_separable.launches += 1
    if with_fallback:
        return w, slack, bcv, ok
    return w, slack, bcv


def _shared_cuda(fem_values, f, ops, with_diagnostics):
    name = "fused_enhance_shared"
    E = fem_values.shape[0] - 1
    M, C = ops.Wf.shape
    lib = _load_checked(name, fem_values, M, C, f)
    dev = fem_values.device
    statics = _statics(dev, ops.Wf, ops.Wbc, ops.D, ops.B)
    w = torch.empty(E, M, dtype=torch.float32, device=dev)
    slack = bcv = None
    if with_diagnostics:
        slack = torch.empty(E, dtype=torch.float32, device=dev)
        bcv = torch.empty(E, dtype=torch.float32, device=dev)
    err = lib.enhance1d_shared_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(f),
        _ptr(statics), _ptr(w), _ptr(slack), _ptr(bcv),
        E, M, C, int(with_diagnostics))
    _raise_on(lib, name, err)
    fused_enhance_shared.launches += 1
    return w, slack, bcv


def _varcoeff_cuda(fem_values, coef, he, host, h, with_diagnostics):
    name = "fused_enhance_varcoeff"
    E = coef.shape[2]
    Ef = fem_values.shape[-1] - 1  # elements a family (E: one mesh)
    M = host.Z.shape[0]
    C = coef.shape[1]
    extra = (coef,) if he is None else (coef, he)
    lib = _load_checked(name, fem_values, M, C, *extra)
    dev = fem_values.device
    statics = _statics(dev, *pack_varcoeff(host))
    w = torch.empty(E, M, dtype=torch.float32, device=dev)
    slack = bcv = cond = None
    if with_diagnostics:
        slack, bcv, cond = (torch.empty(E, dtype=torch.float32, device=dev)
                            for _ in range(3))
    err = lib.enhance1d_varcoeff_f32(
        dev.index, _stream(fem_values), _ptr(fem_values), _ptr(coef),
        _ptr(he), _ptr(statics), _ptr(w), _ptr(slack), _ptr(bcv),
        _ptr(cond), E, Ef, M, C, float(h), float(1.0 / host.s2),
        float(host.s2), int(with_diagnostics))
    _raise_on(lib, name, err)
    fused_enhance_varcoeff.launches += 1
    return w, slack, bcv, cond


# --------------------------------------------------------------------------
# Public wrappers and plain versions
# --------------------------------------------------------------------------

def _check_separable_args(ops, with_diagnostics, with_fallback):
    if ops.WfF is None:
        raise ValueError("ops has no rank-factored rhs fields; precompute "
                         "with rhs_colloc_factors")
    if with_fallback and not with_diagnostics:
        raise ValueError("with_fallback requires with_diagnostics")


def fused_enhance_separable(fem_values, ops: kkt.SharedOperators,
                            f_elem_factors_fn, x0, h,
                            with_diagnostics: bool = True,
                            with_fallback: bool = False):
    """Shared-operator enhancement for a SEPARABLE rhs (replaces
    ``pallas_kernels.fused_enhance_separable``).

    fem_values [E+1] (Dirichlet-consistent nodal values) on a uniform mesh
    whose element e starts at x0 + e h.  With a = f_elem_factors(xl) [R, E]:

        w     = WfF^T a + Wbc bc
        slack = max_c | PF^T a + Qres bc |
        bcv   = max | B w - bc |          (from the computed w)

    ``with_fallback`` fuses the solve_ok gate and the linear-interpolant
    fallback.  Returns (w [E, M], slack, bcv[, ok]); slack and bcv are None
    without diagnostics, ok is a float 0/1 vector.
    """
    _check_separable_args(ops, with_diagnostics, with_fallback)
    a = _sample_separable(fem_values, f_elem_factors_fn, x0, h)
    if fem_values.device.type == "cpu":
        return _separable_plain(fem_values, a, ops, with_diagnostics,
                                with_fallback)
    return _separable_cuda(fem_values, a, ops, with_diagnostics,
                           with_fallback)


def fused_enhance_separable_ref(fem_values, ops, f_elem_factors_fn, x0, h,
                                with_diagnostics: bool = True,
                                with_fallback: bool = False):
    """Plain-torch version of ``fused_enhance_separable`` (any device)."""
    _check_separable_args(ops, with_diagnostics, with_fallback)
    a = _sample_separable(fem_values, f_elem_factors_fn, x0, h)
    return _separable_plain(fem_values, a, ops, with_diagnostics,
                            with_fallback)


def fused_enhance_shared(fem_values, ops: kkt.SharedOperators, f_fn, x0, h,
                         n_colloc: int, with_diagnostics: bool = True,
                         f_shifted_fn=None):
    """Shared-operator enhancement for a generic rhs (replaces
    ``pallas_kernels.fused_enhance_shared``): f sampled at the C collocation
    points of every element, w = Wf f + Wbc bc, and optionally
    slack = max|f - D w|, bcv = max|B w - bc|.  Returns (w [E, M], slack,
    bcv), the last two None without diagnostics."""
    f = _sample_shared(fem_values, f_fn, x0, h, n_colloc, f_shifted_fn)
    if fem_values.device.type == "cpu":
        return _shared_plain(fem_values, f, ops, with_diagnostics)
    return _shared_cuda(fem_values, f, ops, with_diagnostics)


def fused_enhance_shared_ref(fem_values, ops, f_fn, x0, h, n_colloc: int,
                             with_diagnostics: bool = True,
                             f_shifted_fn=None):
    """Plain-torch version of ``fused_enhance_shared`` (any device)."""
    f = _sample_shared(fem_values, f_fn, x0, h, n_colloc, f_shifted_fn)
    return _shared_plain(fem_values, f, ops, with_diagnostics)


def _check_varcoeff_args(host):
    if host.K < 1:
        raise ValueError("fused varcoeff kernel needs M >= 3 (K = M-2 >= 1)")


def fused_enhance_varcoeff(fem_values, problem, host: VarCoeffOperators,
                           x0, h, n_colloc: int,
                           with_diagnostics: bool = True,
                           f_shifted_fn=None, nodes=None):
    """Per-element-operator enhancement (replaces
    ``pallas_kernels.fused_enhance_varcoeff``): the null-space LSE of every
    element by CGS2 QR over K = M-2 columns, w = Pbc bc + Z y.

    ``nodes`` [E+1] switches to graded-mesh mode: element positions and
    widths come from the node array and rho = h / h_e (h the reference width
    ``host`` was built at) is folded into the coefficients.  Returns
    (w [E, M], slack, bcv, cond), the last three None without diagnostics.

    Families: ``fem_values`` (and ``nodes``) [P, Ef+1] hold P meshes of Ef
    elements, solved in one launch as E = P Ef elements (w [P Ef, M], family
    p's elements at rows p Ef ...).  Each element pairs with its own family's
    nodal values; the problem's callables see points [P, C, Ef] (one mesh:
    [1, C, E]).
    """
    _check_varcoeff_args(host)
    coef, he = _sample_varcoeff(fem_values, problem, x0, h, n_colloc,
                                f_shifted_fn, nodes)
    if fem_values.device.type == "cpu":
        return _varcoeff_plain(fem_values, coef, he, host, h,
                               with_diagnostics)
    return _varcoeff_cuda(fem_values, coef, he, host, h, with_diagnostics)


def fused_enhance_varcoeff_ref(fem_values, problem, host, x0, h,
                               n_colloc: int, with_diagnostics: bool = True,
                               f_shifted_fn=None, nodes=None):
    """Plain-torch version of ``fused_enhance_varcoeff`` (any device)."""
    _check_varcoeff_args(host)
    coef, he = _sample_varcoeff(fem_values, problem, x0, h, n_colloc,
                                f_shifted_fn, nodes)
    return _varcoeff_plain(fem_values, coef, he, host, h, with_diagnostics)


def varcoeff_least_squares_system(fem_values, problem, host, x0, h,
                                  n_colloc: int, f_shifted_fn=None,
                                  nodes=None):
    """The elements' systems as the plain version of
    ``fused_enhance_varcoeff`` builds them: (G [E, C, K], g [E, C]),
    y = argmin ||G y - g||."""
    _check_varcoeff_args(host)
    coef, he = _sample_varcoeff(fem_values, problem, x0, h, n_colloc,
                                f_shifted_fn, nodes)
    _, _, g, G = _varcoeff_system(fem_values, coef, he, host, h)
    return torch.stack(G, dim=-1).transpose(0, 1).contiguous(), g.T


_WRAPPERS = (fused_enhance_separable, fused_enhance_shared,
             fused_enhance_varcoeff)
reset_launch_counts()
