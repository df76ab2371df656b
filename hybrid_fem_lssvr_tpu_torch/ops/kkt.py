"""Batched LSSVR element solves: closed-form bordered KKT systems.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/kkt.py``.  The
per-element problem

    min_w,e  0.5 ||w||^2 + gamma/2 ||e||^2
    s.t.     (D w)_j + e_j = f_j   (C PDE collocation rows)
             B w = bc              (K continuity rows: the 2 endpoint
                                    values in 1D, the 4M-4 boundary-trace
                                    values of a quad in 2D)

is solved by one of three batched paths:

* ``solve_primal_batched`` — per-element D: H = I + gamma D^T D is SPD, so
  a Jacobi-equilibrated Cholesky plus the 2x2 Schur complement on the
  constraint block solves every element.
* ``solve_primal_shared`` — uniform mesh and x-independent coefficients:
  one affine map (f, bc) -> w, precomputed on the host in float64
  (``precompute_shared_host``; ``precompute_shared_lse_host`` for operators
  with a large null space, as the 2D Laplacian), applied as two matmuls.
* ``solve_dual_batched`` — the dual formulation through the
  row-equilibrated augmented quasi-definite system.

float32 routes through the null-space least-squares path
``solve_primal_lse`` (CGS2 QR), the only one that survives f32 at the
reference's gamma.  The JAX module's ``_solve_tiny`` (a closed-form 2x2,
and for K > 2 an equilibrated Cholesky with one refinement step) existed
because LU did not compile in emulated f64 on the TPU; here the K x K Schur
system goes to pivoted LU (``torch.linalg.solve``) for every K.  (In 2D the
float64 per-element route inherits cond(I + gamma D^T D) ~ 1e16 from the
Laplacian's discrete-harmonic null space: its coefficients are good to
~1e-8 whatever solves the Schur block, in either package.)  On a GPU, float32 matmuls must
run in full float32: keep ``torch.backends.cuda.matmul.allow_tf32`` False.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


def bundle_to(bundle, device=None, dtype=None):
    """Copy of a frozen dataclass of tensors with every tensor field moved
    to ``device`` (and cast to ``dtype`` when given)."""
    moved = {}
    for fld in dataclasses.fields(bundle):
        v = getattr(bundle, fld.name)
        if isinstance(v, torch.Tensor):
            moved[fld.name] = v.to(device=device, dtype=dtype)
    return dataclasses.replace(bundle, **moved)


class KKTDiagnostics(NamedTuple):
    """Per-element health signals."""

    max_slack: torch.Tensor  # [E] max |f - D w| per element
    bc_violation: torch.Tensor  # [E] max |B w - bc| per element
    solve_ok: torch.Tensor  # [E] bool: finite solution + sane constraints
    # Cholesky path: (max L_jj / min L_jj)^2 of the equilibrated factor;
    # QR path: max|R_jj| / min|R_jj|; shared paths: the host-exact kappa_2
    # of the factored operator, broadcast; None for the per-element dual.
    cond_estimate: Optional[torch.Tensor] = None


def operator_rows(V0, V1, V2, a2, a1, a0, scale):
    """Collocation matrix D [C, M] for L u = a2 u'' + a1 u' + a0 u on one
    element; a2/a1/a0 [C], scale = 2/h."""
    return (
        a2[:, None] * (scale**2) * V2
        + a1[:, None] * scale * V1
        + a0[:, None] * V0
    )


def boundary_rows(V0):
    """B: [2, M] — endpoint value rows."""
    return torch.stack([V0[0], V0[-1]])


def _equilibrated_cholesky_factor(H):
    """(L, s) with S H S = L L^T, S = diag(s), for SPD H [..., M, M].

    An element whose H is not positive definite in the run dtype gets a
    factor of NaNs, as ``jnp.linalg.cholesky`` returns: its solve is NaN,
    so the diagnostics gate sends it to the fallback (torch's
    ``cholesky`` would raise for the whole batch instead)."""
    s = torch.rsqrt(torch.diagonal(H, dim1=-2, dim2=-1))
    Hs = H * s[..., :, None] * s[..., None, :]
    L, info = torch.linalg.cholesky_ex(Hs)
    return torch.where((info != 0)[..., None, None], torch.nan, L), s


def _chol_solve(L, s, r):
    """Solve H x = r given the equilibrated factor; r [..., M, k]."""
    rs = r * s[..., :, None]
    y = torch.linalg.solve_triangular(L, rs, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x * s[..., :, None]


def _kkt_core(L, s, B, rw, rbc):
    """Solve [[H, B^T], [B, 0]] [w; lam] = [rw; rbc] batched over elements,
    given the equilibrated Cholesky factor (L, s) of H."""
    rhs = torch.cat([B.transpose(-1, -2), rw[..., None]], dim=-1)  # [E,M,K+1]
    X = _chol_solve(L, s, rhs)
    HiBt, Hirw = X[..., :-1], X[..., -1]
    S = B @ HiBt  # [E, K, K] Schur complement (SPD, tiny)
    lam = torch.linalg.solve(S, (B @ Hirw[..., None])[..., 0] - rbc)
    w = Hirw - (HiBt @ lam[..., None])[..., 0]
    return w, lam


def solve_primal_batched(D, B, f, bc, gamma, refine_steps: int = 0):
    """Per-element-operator path. D: [E, C, M]; B: [K, M] or [E, K, M];
    f: [E, C]; bc: [E, K].  Returns (w [E, M], KKTDiagnostics).

    ``refine_steps`` > 0 adds iterative refinement on the full KKT
    residual with the same factorisation.
    """
    E, C, M = D.shape
    if B.ndim == 2:
        B = B.expand(E, *B.shape)
    Dt = D.transpose(-1, -2)
    H = torch.eye(M, dtype=D.dtype, device=D.device) + gamma * (Dt @ D)
    L, s = _equilibrated_cholesky_factor(H)
    rw0 = gamma * (Dt @ f[..., None])[..., 0]
    w, lam = _kkt_core(L, s, B, rw0, bc)
    Bt = B.transpose(-1, -2)
    for _ in range(refine_steps):
        res_w = rw0 - ((H @ w[..., None])[..., 0]
                       + (Bt @ lam[..., None])[..., 0])
        res_bc = bc - (B @ w[..., None])[..., 0]
        dw, dlam = _kkt_core(L, s, B, res_w, res_bc)
        w = w + dw
        lam = lam + dlam
    dL = torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))
    cond = (dL.amax(-1) / torch.clamp(dL.amin(-1), min=1e-30)) ** 2
    return w, _diagnostics(D, B, f, bc, w, cond=cond)


def _diagnostics(D, B, f, bc, w, tol: float = 1e-2, cond=None):
    """D may be [E, C, M] (per-element) or [C, M] (shared)."""
    if D.ndim == 2:
        e = f - torch.einsum("em,cm->ec", w, D)
    else:
        e = f - torch.einsum("ecm,em->ec", D, w)
    max_slack = torch.abs(e).amax(-1)
    if B.ndim == 2:
        bres = torch.abs(torch.einsum("km,em->ek", B, w) - bc)
    else:
        bres = torch.abs(torch.einsum("ekm,em->ek", B, w) - bc)
    bc_violation = bres.amax(-1)
    finite = torch.all(torch.isfinite(w), dim=-1)
    scale = 1.0 + torch.abs(bc).amax(-1)
    solve_ok = finite & (bc_violation <= tol * scale)
    return KKTDiagnostics(max_slack, bc_violation, solve_ok, cond)


def nullspace_host(B):
    """Host float64 (Z, Pbc): orthonormal null-space basis of B [K, M] and
    the min-norm particular map Pbc = B^T (B B^T)^{-1} [M, K]."""
    B = np.asarray(B, np.float64)
    K, M = B.shape
    Q, _ = np.linalg.qr(B.T, mode="complete")
    Z = Q[:, K:]
    Pbc = B.T @ np.linalg.inv(B @ B.T)
    return Z, Pbc


def _batched_mgs_qr_factor(G):
    """CGS2 QR of a batch of small thin systems G [E, C, K].  Returns
    (lstsq, cond): ``lstsq(g)`` solves min ||G y - g|| for g [E, C] with the
    retained factors; cond = max|R_jj| / min|R_jj| per element."""
    E, C, K = G.shape
    Qc = []
    R = [[None] * K for _ in range(K)]
    for j in range(K):
        v = G[:, :, j]
        for _pass in range(2):  # MGS + reorthogonalisation (CGS2)
            for i in range(j):
                rij = torch.sum(Qc[i] * v, dim=-1)
                R[i][j] = rij if R[i][j] is None else R[i][j] + rij
                v = v - rij[:, None] * Qc[i]
        rjj = torch.sqrt(torch.sum(v * v, dim=-1))
        R[j][j] = rjj
        Qc.append(v / (rjj[:, None] + 1e-30))

    def lstsq(g):
        # y = R^{-1} Q^T g by back substitution.
        qtg = [torch.sum(Qc[j] * g, dim=-1) for j in range(K)]
        y = [None] * K
        for j in reversed(range(K)):
            acc = qtg[j]
            for i in range(j + 1, K):
                acc = acc - R[j][i] * y[i]
            y[j] = acc / (R[j][j] + 1e-30)
        return torch.stack(y, dim=-1)

    dR = torch.abs(torch.stack([R[j][j] for j in range(K)], dim=-1))
    cond = dR.amax(-1) / torch.clamp(dR.amin(-1), min=1e-30)
    return lstsq, cond


def solve_primal_lse(D, B, f, bc, ZP=None, refine_steps: int = 0):
    """Null-space least-squares path (the float32 route).

    Solves min_w ||D w - f|| s.t. B w = bc, which equals the
    gamma-regularised optimum to O(1/(gamma ||D||_F^2)): with Z the
    orthonormal null basis of B and w_p = Pbc bc,
    y = argmin ||(D Z) y - (f - D w_p)|| by CGS2 QR, w = w_p + Z y.
    ``ZP=(Z, Pbc)`` passes the host-precomputed pair.
    """
    if ZP is None:
        if B.ndim != 2:
            raise ValueError("per-element B requires precomputed ZP")
        Z_np, Pbc_np = nullspace_host(B.detach().cpu().numpy())
        Z = torch.as_tensor(Z_np, dtype=D.dtype, device=D.device)
        Pbc = torch.as_tensor(Pbc_np, dtype=D.dtype, device=D.device)
    else:
        Z, Pbc = ZP
    wp = torch.einsum("mk,ek->em", Pbc, bc)  # [E, M]
    # Per-element scale removal (all rows share the (2/h)^2 chain factor).
    s0 = torch.sqrt(torch.mean(D * D, dim=(1, 2))) + 1e-30  # [E]
    G = torch.einsum("ecm,mk->eck", D, Z) / s0[:, None, None]
    g = (f - torch.einsum("ecm,em->ec", D, wp)) / s0[:, None]
    lstsq, cond = _batched_mgs_qr_factor(G)
    y = lstsq(g)
    for _ in range(refine_steps):
        r = g - torch.einsum("eck,ek->ec", G, y)
        y = y + lstsq(r)
    w = wp + torch.einsum("mk,ek->em", Z, y)
    return w, _diagnostics(D, B, f, bc, w, cond=cond)


def solve_batched(D, B, f, bc, gamma, formulation="primal", method="auto",
                  refine_steps: int = 0, ZP=None):
    """Dtype-aware routed solve (JAX ``solve_batched`` and
    ``_solve_batched_inner``; the JAX wrapper only set the matmul
    precision, which torch's float32 matmuls already meet).

    float64: primal -> Schur/Cholesky KKT; dual -> augmented LU.
    float32: both formulations -> the orthogonal LSE core.
    """
    if method == "auto":
        method = "qr" if D.dtype == torch.float32 else (
            "dual_aug" if formulation == "dual" else "cholesky"
        )
    if method == "qr":
        return solve_primal_lse(D, B, f, bc, ZP=ZP, refine_steps=refine_steps)
    if method == "cholesky":
        return solve_primal_batched(D, B, f, bc, gamma,
                                    refine_steps=refine_steps)
    if method == "dual_aug":
        return solve_dual_batched(D, B, f, bc, gamma)
    raise ValueError(f"unknown KKT method: {method}")


@dataclasses.dataclass(frozen=True)
class SharedOperators:
    """Precomputed affine map (f, bc) -> w for a shared element operator.

    With a separable rhs f(xl + d) = sum_r a_r(xl) b_r(d) (b_r static) the
    hot path needs no [C, E] rhs:
      w     = sum_r a_r * WfF[r]  + Wbc @ bc        (WfF[r] = Wf b_r)
      slack = max | sum_r a_r * PF[r] + Qres @ bc |  (PF[r] = (I - D Wf) b_r)
    with WfF / PF contracted on the host in float64.
    """

    Wf: torch.Tensor  # [M, C]
    Wbc: torch.Tensor  # [M, K]
    D: torch.Tensor  # [C, M] (kept for diagnostics)
    B: torch.Tensor  # [K, M]
    WfF: Optional[torch.Tensor] = None  # [R, M] host-f64 Wf @ b_r
    PF: Optional[torch.Tensor] = None  # [R, C] host-f64 (I - D Wf) @ b_r
    Qres: Optional[torch.Tensor] = None  # [C, K] host-f64 -(D @ Wbc)
    Pres: Optional[torch.Tensor] = None  # [C, C] residual projector I - D Wf
    cond: Optional[torch.Tensor] = None  # scalar host-exact kappa_2

    def to(self, device=None, dtype=None) -> "SharedOperators":
        return bundle_to(self, device, dtype)


def _rhs_factor_fields(Wf64, Wbc64, D64, rhs_colloc_factors, dtype):
    """Host-f64 residual operators Pres = I - D Wf, Qres = -(D Wbc) and,
    given static rhs collocation factors, their contractions WfF / PF."""
    C = D64.shape[0]
    P = np.eye(C) - D64 @ Wf64  # residual projector [C, C]
    fields = dict(
        Qres=torch.as_tensor(-(D64 @ Wbc64), dtype=dtype),
        Pres=torch.as_tensor(P, dtype=dtype),
    )
    if rhs_colloc_factors is None:
        return fields
    bs = np.stack([np.asarray(b, np.float64) for b in rhs_colloc_factors])
    fields.update(
        WfF=torch.as_tensor(bs @ Wf64.T, dtype=dtype),  # [R, M]
        PF=torch.as_tensor(bs @ P.T, dtype=dtype),  # [R, C]
    )
    return fields


def precompute_shared_host(D0, B, gamma, dtype=torch.float32,
                           rhs_colloc_factors=None) -> SharedOperators:
    """Host float64 precompute of the shared affine map w = Wf f + Wbc bc
    (H = I + gamma D^T D, S = B H^-1 B^T, Wbc = H^-1 B^T S^-1,
    Wf = (I - Wbc B) H^-1 gamma D^T).  D0/B: numpy [C, M]/[2, M].
    Returns CPU tensors in ``dtype``; move them with ``.to(device)``."""
    D0 = np.asarray(D0, np.float64)
    B = np.asarray(B, np.float64)
    M = D0.shape[1]
    H = np.eye(M) + float(gamma) * D0.T @ D0
    s = 1.0 / np.sqrt(np.diag(H))
    Hs = H * s[:, None] * s[None, :]
    cho = np.linalg.cholesky(Hs)

    def hsolve(R):
        Rs = R * s[:, None]
        y = np.linalg.solve(cho, Rs)
        x = np.linalg.solve(cho.T, y)
        return x * s[:, None]

    HiBt = hsolve(B.T)
    HiDt = hsolve(float(gamma) * D0.T)
    S = B @ HiBt
    Wbc = HiBt @ np.linalg.inv(S)
    Wf = HiDt - Wbc @ (B @ HiDt)
    return SharedOperators(
        Wf=torch.as_tensor(Wf, dtype=dtype),
        Wbc=torch.as_tensor(Wbc, dtype=dtype),
        D=torch.as_tensor(D0, dtype=dtype),
        B=torch.as_tensor(B, dtype=dtype),
        cond=torch.as_tensor(np.linalg.cond(Hs), dtype=dtype),
        **_rhs_factor_fields(Wf, Wbc, D0, rhs_colloc_factors, dtype),
    )


def precompute_shared_dual_host(D0, B, gamma, dtype=torch.float32,
                                rhs_colloc_factors=None) -> SharedOperators:
    """Host float64 precompute of the shared affine map through the dual
    algebra: the row-equilibrated augmented quasi-definite system of
    ``solve_dual_batched`` is factorised once and its (f, bc) -> w block
    extracted."""
    D0 = np.asarray(D0, np.float64)
    B = np.asarray(B, np.float64)
    C, M = D0.shape
    K = B.shape[0]
    n = C + K
    A = np.vstack([D0, B])
    r = 1.0 / np.linalg.norm(A, axis=1)
    At = A * r[:, None]
    reg = np.concatenate([r[:C] ** 2 / float(gamma), np.zeros(K)])
    aug = np.zeros((M + n, M + n))
    aug[:M, :M] = -np.eye(M)
    aug[:M, M:] = At.T
    aug[M:, :M] = At
    aug[M:, M:] = np.diag(reg)
    T = np.linalg.solve(aug, np.vstack([np.zeros((M, n)), np.eye(n)]))[:M]
    T = T * r[None, :]
    return SharedOperators(
        Wf=torch.as_tensor(T[:, :C], dtype=dtype),
        Wbc=torch.as_tensor(T[:, C:], dtype=dtype),
        D=torch.as_tensor(D0, dtype=dtype),
        B=torch.as_tensor(B, dtype=dtype),
        cond=torch.as_tensor(np.linalg.cond(aug), dtype=dtype),
        **_rhs_factor_fields(T[:, :C], T[:, C:], D0, rhs_colloc_factors,
                             dtype),
    )


def precompute_shared_lse_host(D0, B, dtype=torch.float32,
                               rhs_colloc_factors=None,
                               rcond=None) -> SharedOperators:
    """Host float64 precompute of the shared affine map via the null-space
    LSE formulation (the gamma -> infinity limit; it deviates from the
    gamma-regularised optimum by O(1/(gamma ||D||_F^2))).

    Required when D has a large null space — the 2D Laplacian on
    tensor-product Legendre bases, whose discrete-harmonic directions make
    cond(I + gamma D^T D) overflow even float64.

    ``rcond``: rank-tolerant SVD route for rank-deficient constraint
    matrices (trace rows with exact dependencies): Z then spans the full
    null space (right singular vectors past the numerical rank) and the
    particular map is the pseudoinverse, where the QR/inv route would give
    a truncated null space and the inverse of a singular B B^T."""
    D0 = np.asarray(D0, np.float64)
    B = np.asarray(B, np.float64)
    M = D0.shape[1]
    K = B.shape[0]
    if rcond is None:
        Q, _ = np.linalg.qr(B.T, mode="complete")  # [M, M]
        Z = Q[:, K:]  # orthonormal null(B)
        Pbc = B.T @ np.linalg.inv(B @ B.T)  # min-norm particular map
    else:
        U, sv, Vt = np.linalg.svd(B)
        r = int(np.sum(sv > rcond * sv[0]))
        Z = Vt[r:].T  # orthonormal full null(B)
        Pbc = Vt[:r].T @ ((1.0 / sv[:r])[:, None] * U[:, :r].T)  # pinv(B)
    G = D0 @ Z
    qg, rg = np.linalg.qr(G)
    Wf = Z @ np.linalg.solve(rg, qg.T)  # [M, C]: lsq correction map
    Wbc = (np.eye(M) - Wf @ D0) @ Pbc
    return SharedOperators(
        Wf=torch.as_tensor(Wf, dtype=dtype),
        Wbc=torch.as_tensor(Wbc, dtype=dtype),
        D=torch.as_tensor(D0, dtype=dtype),
        B=torch.as_tensor(B, dtype=dtype),
        cond=torch.as_tensor(np.linalg.cond(G), dtype=dtype),
        **_rhs_factor_fields(Wf, Wbc, D0, rhs_colloc_factors, dtype),
    )


def solve_primal_shared(ops: SharedOperators, f, bc):
    """All E elements in two matmuls.  f: [E, C]; bc: [E, K] ->
    (w [E, M], KKTDiagnostics)."""
    w = f @ ops.Wf.T + bc @ ops.Wbc.T
    cond = None
    if ops.cond is not None:
        cond = ops.cond.expand(f.shape[0])
    return w, _diagnostics(ops.D, ops.B, f, bc, w, cond=cond)


def solve_dual_batched(D, B, f, bc, gamma, return_multipliers: bool = False):
    """Dual formulation: with A = [D; B] and row equilibration r, solve the
    augmented quasi-definite system

        [ -I   A~^T ] [ w  ]   [   0   ]
        [  A~  Reg  ] [ mu ] = [ r*rhs ]

    per element with pivoted LU (``torch.linalg.solve``).
    ``return_multipliers=True`` also returns (alpha [E, C], beta [E, K]).
    """
    E, C, M = D.shape
    if B.ndim == 2:
        B = B.expand(E, *B.shape)
    K_bc = B.shape[1]
    n = C + K_bc
    A = torch.cat([D, B], dim=1)  # [E, n, M]
    r = torch.rsqrt(torch.sum(A * A, dim=-1) + 1e-30)  # [E, n]
    At = A * r[..., None]
    reg = torch.cat([r[:, :C] ** 2 / gamma,
                     torch.zeros(E, K_bc, dtype=D.dtype, device=D.device)],
                    dim=-1)
    aug = torch.zeros(E, M + n, M + n, dtype=D.dtype, device=D.device)
    aug[:, :M, :M] = -torch.eye(M, dtype=D.dtype, device=D.device)
    aug[:, :M, M:] = At.transpose(-1, -2)
    aug[:, M:, :M] = At
    aug[:, M:, M:] = torch.diag_embed(reg)
    rhs = torch.cat([torch.zeros(E, M, dtype=D.dtype, device=D.device),
                     torch.cat([f, bc], dim=-1) * r], dim=-1)
    sol = torch.linalg.solve(aug, rhs)
    w, mu = sol[:, :M], sol[:, M:] * r
    if return_multipliers:
        return w, _diagnostics(D, B, f, bc, w), (mu[:, :C], mu[:, C:])
    return w, _diagnostics(D, B, f, bc, w)


def linear_fallback_coeffs(u_left, u_right, M: int):
    """Legendre coefficients of the linear interpolant through the element
    endpoint values: u(t) = (u_l+u_r)/2 + (u_r-u_l)/2 t."""
    c0 = 0.5 * (u_left + u_right)
    c1 = 0.5 * (u_right - u_left)
    zeros = torch.zeros(u_left.shape + (max(M - 2, 0),), dtype=u_left.dtype,
                        device=u_left.device)
    cols = [c0[..., None]]
    if M > 1:
        cols.append(c1[..., None])
    cols.append(zeros)
    return torch.cat(cols, dim=-1)[..., :M]


def apply_fallback(w, diags: KKTDiagnostics, u_left, u_right):
    """Mask failed elements to the linear interpolant."""
    M = w.shape[-1]
    wf = linear_fallback_coeffs(u_left, u_right, M)
    w_safe = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    return torch.where(diags.solve_ok[..., None], w_safe, wf)
