"""Preconditioned Krylov solvers for the matrix-free 2D FEM solve.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/cg.py``: the same
iterations and the same stopping rule (``||r||_2 > tol ||b||_2`` and
``k < maxiter``).  JAX runs the loop on the device (``lax.while_loop``);
PyTorch runs it from the host, so the stopping test reads one scalar from
the device per iteration — on a GPU that is one synchronisation per
iteration, which keeps the host from enqueueing the next iteration early.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # final ||r||_2 (0-d tensor)


def _preconditioner(M_inv):
    if M_inv is None:
        return lambda r: r
    if callable(M_inv):
        return M_inv
    return lambda r: M_inv * r


def _dot(u, v):
    return torch.sum(u * v)


def cg(apply_A: Callable, b: torch.Tensor, x0=None, M_inv=None,
       tol: float = 1e-12, maxiter: int = 1000,
       dot_fn: Callable = None) -> CGResult:
    """Solve A x = b; A SPD via ``apply_A``; optional preconditioner
    ``M_inv`` (elementwise inverse-diagonal tensor or callable).
    ``dot_fn`` overrides the inner product."""
    x = torch.zeros_like(b) if x0 is None else x0
    precond = _preconditioner(M_inv)
    dot = dot_fn if dot_fn is not None else _dot

    r = b - apply_A(x)
    z = precond(r)
    p = z
    gamma = dot(r, z)
    bnorm = torch.sqrt(dot(b, b)) + 1e-30
    k = 0
    while k < maxiter:
        rnorm = torch.sqrt(dot(r, r))
        if not bool(rnorm > tol * bnorm):  # the per-iteration host read
            break
        Ap = apply_A(p)
        alpha = gamma / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_new = dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return CGResult(x=x, iters=k, residual=torch.sqrt(dot(r, r)))


def bicgstab(apply_A: Callable, b: torch.Tensor, x0=None, M_inv=None,
             tol: float = 1e-12, maxiter: int = 1000,
             dot_fn: Callable = None) -> CGResult:
    """Preconditioned BiCGStab (van der Vorst) for nonsymmetric / indefinite
    systems: the 2D coarse stage for advection and Helmholtz operators.

    ``M_inv`` acts as a right preconditioner applied to the search
    directions.  Breakdown of either inner product (rho or omega ~ 0) exits
    the loop with the best iterate so far; the caller sees it as a nonzero
    final residual."""
    x = torch.zeros_like(b) if x0 is None else x0
    precond = _preconditioner(M_inv)
    dot = dot_fn if dot_fn is not None else _dot

    dtype = b.dtype
    tiny = torch.finfo(dtype).tiny * 1e3
    zero = torch.zeros((), dtype=dtype, device=b.device)
    r = b - apply_A(x)
    rhat = r  # fixed shadow residual
    bnorm = torch.sqrt(dot(b, b)) + 1e-30
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    broke = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter:
        go = (torch.sqrt(dot(r, r)) > tol * bnorm) & ~broke
        if not bool(go):  # the per-iteration host read
            break
        rho_new = dot(rhat, r)
        broke = (torch.abs(rho_new) < tiny) | (torch.abs(omega) < tiny)
        beta = torch.where(broke, zero, (rho_new / rho) * (alpha / omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = apply_A(phat)
        denom = dot(rhat, v)
        broke = broke | (torch.abs(denom) < tiny)
        alpha = torch.where(broke, zero, rho_new / denom)
        s = r - alpha * v
        shat = precond(s)
        t = apply_A(shat)
        tt = dot(t, t)
        omega = torch.where(tt < tiny, zero, dot(t, s) / (tt + tiny))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return CGResult(x=x, iters=k, residual=torch.sqrt(dot(r, r)))
