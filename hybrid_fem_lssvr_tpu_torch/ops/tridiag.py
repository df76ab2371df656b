"""Tridiagonal solvers: Thomas, parallel cyclic reduction (PCR) and blocked
SPIKE.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/ops/tridiag.py``.  JAX's two
``lax.scan``s in ``thomas`` become a Python loop over rows, and the
``vmap(thomas)`` inside ``spike`` becomes one loop over the block length on
``[B, n, 3]`` tensors.  On a GPU each loop step is a handful of small
kernel launches, so these solvers are launch-bound there.

Conventions: a system is three length-N diagonals ``a`` (sub, a[0] == 0),
``b`` (main), ``c`` (super, c[-1] == 0) and a right-hand side of shape [N]
or [N, R].
"""

from __future__ import annotations

import torch


def _ensure_2d(rhs):
    if rhs.ndim == 1:
        return rhs[:, None], True
    return rhs, False


def _thomas_batched(a, b, c, rhs):
    """Thomas elimination over the second-to-last axis of rhs.

    a, b, c: [..., n]; rhs: [..., n, R] -> x [..., n, R].  Same arithmetic
    as the JAX scans: denom = b - a cp_prev, cp = c / denom,
    dp = (r - a dp_prev) / denom, then x = dp - cp x_next.
    """
    n = b.shape[-1]
    cp_prev = torch.zeros_like(b[..., 0])
    dp_prev = torch.zeros_like(rhs[..., 0, :])
    cps, dps = [], []
    for i in range(n):
        ai = a[..., i]
        denom = b[..., i] - ai * cp_prev
        cp_prev = c[..., i] / denom
        dp_prev = (rhs[..., i, :] - ai[..., None] * dp_prev) / denom[..., None]
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(dps[0])
    xs = [None] * n
    for i in reversed(range(n)):
        x_next = dps[i] - cps[i][..., None] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-2)


def thomas(a, b, c, rhs):
    """Thomas algorithm. rhs: [N] or [N, R] -> same shape."""
    rhs2, squeeze = _ensure_2d(rhs)
    xs = _thomas_batched(a, b, c, rhs2)
    return xs[:, 0] if squeeze else xs


def _shift_down(x, s, fill):  # x[i - s], out-of-range rows filled
    head = torch.full((s,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:-s]])[:x.shape[0]]


def _shift_up(x, s, fill):  # x[i + s]
    tail = torch.full((s,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[s:], tail])[:x.shape[0]]


def pcr(a, b, c, rhs):
    """Parallel cyclic reduction: log2(N) vectorised elimination sweeps.

    Out-of-range neighbours are identity rows (b=1, a=c=rhs=0).  Kept as a
    test oracle for ``spike``.
    """
    rhs2, squeeze = _ensure_2d(rhs)
    N = b.shape[0]
    n_steps = max(1, (N - 1).bit_length())
    for step in range(n_steps):
        s = 1 << step
        a_m, b_m, c_m = (_shift_down(a, s, 0.0), _shift_down(b, s, 1.0),
                         _shift_down(c, s, 0.0))
        a_p, b_p, c_p = (_shift_up(a, s, 0.0), _shift_up(b, s, 1.0),
                         _shift_up(c, s, 0.0))
        r_m = _shift_down(rhs2, s, 0.0)
        r_p = _shift_up(rhs2, s, 0.0)

        alpha = -a / b_m
        beta = -c / b_p
        b = b + alpha * c_m + beta * a_p
        rhs2 = rhs2 + alpha[:, None] * r_m + beta[:, None] * r_p
        a = alpha * a_m
        c = beta * c_p

    x = rhs2 / b[:, None]
    return x[:, 0] if squeeze else x


def _inv2(Mm):
    det = Mm[..., 0, 0] * Mm[..., 1, 1] - Mm[..., 0, 1] * Mm[..., 1, 0]
    inv = torch.stack([
        torch.stack([Mm[..., 1, 1], -Mm[..., 0, 1]], dim=-1),
        torch.stack([-Mm[..., 1, 0], Mm[..., 0, 0]], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def _mv2(A2, v2):  # [B,2,2] @ [B,2]
    return torch.stack([
        A2[..., 0, 0] * v2[..., 0] + A2[..., 0, 1] * v2[..., 1],
        A2[..., 1, 0] * v2[..., 0] + A2[..., 1, 1] * v2[..., 1],
    ], dim=-1)


def spike(a, b, c, rhs, block_size: int = 256):
    """Blocked SPIKE solve of one right-hand side (rhs: [N]), or of a batch
    of systems (diagonals and rhs [..., N], as JAX's ``vmap`` of it).

    The N rows split into B blocks of ``block_size``: a batched Thomas
    eliminates inside every block at once (depth block_size, width B) and
    yields per-block spikes (v, w); the 2x2-block-tridiagonal reduced
    system over the block-boundary unknowns is solved by block PCR in
    log2(B) sweeps; local back substitution finishes.
    """
    batch, N = b.shape[:-1], b.shape[-1]
    a, b, c, rhs = (v.reshape(-1, N) for v in (a, b, c, rhs))  # [P, N]
    P = b.shape[0]
    n = block_size
    B = -(-N // n)
    pad = B * n - N
    dtype, device = b.dtype, b.device
    if pad:
        zeros = torch.zeros(P, pad, dtype=dtype, device=device)
        a = torch.cat([a, zeros], dim=1)
        c = torch.cat([c, zeros], dim=1)
        b = torch.cat([b, torch.ones(P, pad, dtype=dtype, device=device)],
                      dim=1)
        rhs = torch.cat([rhs, zeros], dim=1)
    ab = a.reshape(P, B, n).clone()
    bb = b.reshape(P, B, n)
    cb = c.reshape(P, B, n).clone()
    rb = rhs.reshape(P, B, n)
    # Strip inter-block couplings into the spikes.
    l_coup = ab[..., 0].clone()  # couples to block d-1's last row
    u_coup = cb[..., -1].clone()  # couples to block d+1's first row
    ab[..., 0] = 0.0
    cb[..., -1] = 0.0

    rhs3 = torch.zeros(P, B, n, 3, dtype=dtype, device=device)
    rhs3[..., 0] = rb
    rhs3[:, :, 0, 1] = l_coup
    rhs3[:, :, -1, 2] = u_coup
    sol3 = _thomas_batched(ab, bb, cb, rhs3)  # [P, B, n, 3]
    g, v, w = sol3[..., 0], sol3[..., 1], sol3[..., 2]

    # Reduced system on y_d = (x_first, x_last) of each block:
    #   y_d + L_d y_{d-1} + U_d y_{d+1} = gb_d
    # with L_d = [[0, v[d,0]], [0, v[d,-1]]], U_d = [[w[d,0], 0],
    # [w[d,-1], 0]], solved by 2x2-block parallel cyclic reduction.
    L = torch.zeros(P, B, 2, 2, dtype=dtype, device=device)
    L[..., 0, 1] = v[..., 0]
    L[..., 1, 1] = v[..., -1]
    U = torch.zeros(P, B, 2, 2, dtype=dtype, device=device)
    U[..., 0, 0] = w[..., 0]
    U[..., 1, 0] = w[..., -1]
    eye = torch.eye(2, dtype=dtype, device=device).expand(P, B, 2, 2)
    Dg = eye.clone()
    r2 = torch.stack([g[..., 0], g[..., -1]], dim=-1)  # [P, B, 2]

    idx = torch.arange(B, device=device)

    def shift_blocks(x, s, fill_eye):  # along the block axis
        zeros = torch.zeros((P, abs(s)) + x.shape[2:], dtype=dtype,
                            device=device)
        if s > 0:
            out = torch.cat([zeros, x], dim=1)[:, :B]
            oob = idx < s
        else:
            out = torch.cat([x, zeros], dim=1)[:, -s:]
            oob = idx >= B + s
        if fill_eye:
            out = torch.where(oob[:, None, None], eye, out)
        return out

    n_steps = max(1, (B - 1).bit_length())
    for step in range(n_steps):
        s = 1 << step
        D_m = shift_blocks(Dg, s, True)
        L_m = shift_blocks(L, s, False)
        U_m = shift_blocks(U, s, False)
        r_m = shift_blocks(r2, s, False)
        D_p = shift_blocks(Dg, -s, True)
        L_p = shift_blocks(L, -s, False)
        U_p = shift_blocks(U, -s, False)
        r_p = shift_blocks(r2, -s, False)
        alpha = -(L @ _inv2(D_m))
        beta = -(U @ _inv2(D_p))
        Dg = Dg + alpha @ U_m + beta @ L_p
        r2 = r2 + _mv2(alpha, r_m) + _mv2(beta, r_p)
        L = alpha @ L_m
        U = beta @ U_p
    y = _mv2(_inv2(Dg), r2)  # [P, B, 2]

    zero1 = torch.zeros(P, 1, dtype=dtype, device=device)
    y_last_prev = torch.cat([zero1, y[:, :-1, 1]], dim=1)  # x_last(d-1)
    y_first_next = torch.cat([y[:, 1:, 0], zero1], dim=1)  # x_first(d+1)
    x = g - v * y_last_prev[..., None] - w * y_first_next[..., None]
    return x.reshape(P, -1)[:, :N].reshape(*batch, N)


def solve(a, b, c, rhs, method: str = "thomas"):
    """Dispatch: 'auto' | 'thomas' | 'pcr' | 'spike' | 'dense'.

    'auto' picks Thomas up to 8192 rows and blocked SPIKE above.  'pcr'
    and 'dense' are test oracles, never picked by 'auto'.  Diagonals of
    [..., N] are a batch of systems, one rhs [..., N] each (JAX's ``vmap``
    of this function)."""
    if method == "auto":
        method = "thomas" if b.shape[-1] <= 8192 else "spike"
    if b.ndim > 1:
        if method == "thomas":
            return _thomas_batched(a, b, c, rhs[..., None])[..., 0]
        if method == "spike":
            return spike(a, b, c, rhs)
        if method in ("pcr", "dense"):  # the oracles, system by system
            rows = [solve(*(v.reshape(-1, v.shape[-1])[i]
                            for v in (a, b, c, rhs)), method=method)
                    for i in range(b[..., 0].numel())]
            return torch.stack(rows).reshape(rhs.shape)
        raise ValueError(f"unknown tridiagonal method: {method}")
    if method == "thomas":
        return thomas(a, b, c, rhs)
    if method == "pcr":
        return pcr(a, b, c, rhs)
    if method == "spike":
        if rhs.ndim != 1:
            return torch.stack(
                [spike(a, b, c, rhs[:, i]) for i in range(rhs.shape[1])],
                dim=1,
            )
        return spike(a, b, c, rhs)
    if method == "dense":
        return torch.linalg.solve(to_dense(a, b, c), rhs)
    raise ValueError(f"unknown tridiagonal method: {method}")


def to_dense(a, b, c) -> torch.Tensor:
    """Materialise the tridiagonal system as a dense [N, N] matrix (tests)."""
    return torch.diag(b) + torch.diag(a[1:], -1) + torch.diag(c[:-1], 1)


def matvec(a, b, c, x) -> torch.Tensor:
    """y = A x for tridiagonal A; x: [N] or [N, R]."""
    x2, squeeze = _ensure_2d(x)
    zero_row = torch.zeros_like(x2[:1])
    up = torch.cat([x2[1:], zero_row])
    dn = torch.cat([zero_row, x2[:-1]])
    y = b[:, None] * x2 + c[:, None] * up + a[:, None] * dn
    return y[:, 0] if squeeze else y


def block_thomas_2x2(L, D, U, rhs):
    """Block-tridiagonal solve with 2x2 blocks: block Thomas elimination
    with closed-form 2x2 inverses (JAX ``tridiag.block_thomas_2x2``).

    The 1D Hermite-cubic system of the clamped beam
    (``models/biharmonic.py``) is block-tridiagonal with two dofs (value,
    slope) a node; its blocks are SPD after the Dirichlet elimination, so
    unpivoted block elimination is stable.  JAX's two ``lax.scan``s are a
    Python loop over rows each, as in ``_thomas_batched``; the closed-form
    inverse is what the function computes, and keeps the arithmetic the
    tests compare.

    L, D, U: [N, 2, 2] (L[0] and U[-1] ignored); rhs: [N, 2] -> x [N, 2].
    """
    n = D.shape[0]
    Cp = torch.zeros(2, 2, dtype=D.dtype, device=D.device)
    Dp = torch.zeros(2, dtype=D.dtype, device=D.device)
    Cs, Ds = [], []
    for i in range(n):
        Si = _inv2(D[i] - L[i] @ Cp)
        Cp = Si @ U[i]
        Dp = Si @ (rhs[i] - L[i] @ Dp)
        Cs.append(Cp)
        Ds.append(Dp)
    x = torch.zeros_like(Dp)
    xs = [None] * n
    for i in reversed(range(n)):
        x = Ds[i] - Cs[i] @ x
        xs[i] = x
    return torch.stack(xs)
