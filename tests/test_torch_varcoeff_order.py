"""The arithmetic of ``varcoeff2d_sne_kernel`` (``csrc/enhance2d_varcoeff.cu``)
and of the 1D ``varcoeff_kernel`` (``csrc/enhance1d.cu``), on the CPU.

Both kernels give each element one thread.  The emulation below repeats
their float32 arithmetic in the kernels' order, as ``test_torch_qr_lanes.py``
does for the per-quad QR (an fma is the float64 product and sum rounded to
float32):

* ``sne``: G's row q and g_q one fma a block from the padded statics
  (``qr::row_G``, ``qr::row_g``); N = G^T G and G^T g as rank-1 updates
  over the rows in order, one fma an entry; a right-looking Cholesky whose
  diagonal holds 1 / (L_jj + 1e-30); y = N^-1 G^T g; one refinement step
  from the residual g - G y with G's rows rebuilt; w = Pbc bc + Z y, B w
  and the slack one fma a term (``qr::quad_w``).
* 1D: G's row c from the row-packed statics (``kernels.pack_varcoeff``),
  G_ck = a0 (W0 Z)_ck + (a1 (W1 Z)_ck + a2 (W2 Z)_ck) with rho folded in
  on a graded mesh; g = f / s^2 - (a0 p0 + (a1 p1 + a2 p2)); CGS2, two
  passes a column, every dot product a chain over the rows in order;
  Q_j = v (1 / (R_jj + 1e-30)); Q^T g for all columns in one pass over
  the rows; back substitution; the residual from G rebuilt.

Each is held against the plain version at ``chip_smoke.py``'s tolerances:
w, bcv in absolute terms, the slack in magnitude, the slack and bcv per
element within SLACK_REL and BCV_REL of the plain version's largest value
and in the mean within MEAN_RATIO (and the 1D condition monitor).  Cases:
2D with three and four operator terms at M = C = 4, 5, 6 on 16^2 quads;
1D at M = 4, 8, 12 (C = 12), uniform and graded, on 4096 elements.

Run as a script (``python tests/test_torch_varcoeff_order.py [n]``, n x n
quads, 1024 by default; a few minutes), it prints both kernels'
diagnostics as emulated against the plain versions on chip_smoke's shapes
and inputs: the prediction for the card.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402
import test_torch_qr_lanes as QL  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.models import problems  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2  # noqa: E402

torch.set_num_threads(1)

EPS = 1e-30
fma = QL.fma


# ------------------------------------------------------------------- sne

def cholesky(N):
    """(L, d) of the kernel's right-looking Cholesky of N [E, K, K]: L's
    strict lower triangle, d = 1 / (L_jj + eps)."""
    L = N.clone()
    K_ = N.shape[1]
    d = torch.zeros(N.shape[0], K_)
    for j in range(K_):
        x = L[:, j, j]  # nan_max(0, x): NaN passes, negatives become 0
        Ljj = torch.sqrt(torch.where((x > 0) | torch.isnan(x), x,
                                     torch.zeros_like(x)))
        d[:, j] = 1.0 / (Ljj + EPS)
        L[:, j + 1:, j] = L[:, j + 1:, j] * d[:, j:j + 1]
        col = L[:, j + 1:, j]
        L[:, j + 1:, j + 1:] = fma(-col[:, :, None], col[:, None, :],
                                   L[:, j + 1:, j + 1:])
    return L, d


def chol_solve(L, d, v):
    """v <- N^-1 v through the factor, in the kernel's order."""
    v = v.clone()
    K_ = v.shape[1]
    for j in range(K_):
        v[:, j] = v[:, j] * d[:, j]
        v[:, j + 1:] = fma(-L[:, j + 1:, j], v[:, j:j + 1], v[:, j + 1:])
    for j in reversed(range(K_)):
        v[:, j] = v[:, j] * d[:, j]
        v[:, :j] = fma(-L[:, j, :j], v[:, j:j + 1], v[:, :j])
    return v


def residual(G, g, y):
    """g - G y per row, one fma a term in column order."""
    er = g
    for k in range(G.shape[2]):
        er = fma(-G[:, :, k], y[:, k:k + 1], er)
    return er


def sne_solve(G, g):
    """y [E, K] of the kernel's semi-normal equations with one refinement
    step, G [E, C2, K] and g [E, C2] as the kernel builds them."""
    E, C2, K_ = G.shape
    N = torch.zeros(E, K_, K_)
    b = torch.zeros(E, K_)
    for q in range(C2):
        Gq = G[:, q]
        N = fma(Gq[:, :, None], Gq[:, None, :], N)
        b = fma(Gq, g[:, q:q + 1], b)
    L, d = cholesky(N)
    y = chol_solve(L, d, b)
    er = residual(G, g, y)
    b = torch.zeros(E, K_)
    for q in range(C2):
        b = fma(G[:, q], er[:, q:q + 1], b)
    return y + chol_solve(L, d, b)


def emulate_sne(args, kw, chunk=K2.PLAIN_CHUNK):
    """(w, slack, bcv) of varcoeff2d_sne_kernel on ``args`` (those of
    ``fused_enhance_varcoeff_2d``)."""
    nodal, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int, bpts = args
    coef, f, gedge, pts = K2._varcoeff_inputs(
        nodal, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int, bpts,
        kw["f_shifted_fn"], "sne")
    bc = K2._trace_bc(nodal, gedge, pts, nx, ny)
    inv_s2 = torch.tensor(1.0 / kw["s2"], dtype=torch.float32)
    C2 = f.shape[0]
    AZ = vops.AZ.float().reshape(4, C2, -1)
    AP = vops.AP.float().reshape(4, C2, -1)
    parts = []
    for lo in range(0, nx * ny, chunk):
        sl = slice(lo, lo + chunk)
        c = coef[:, :, sl]
        cs = (-c[0], -c[1], -c[2], torch.ones_like(c[0]))
        G, g = QL.build(cs[:vops.n_terms], f[:, sl] * inv_s2, bc[:, sl], AZ,
                        AP)
        y = sne_solve(G, g)
        parts.append(QL.finish(G, g, y, bc[:, sl], vops.Pbc.float(),
                               vops.Z.float(), vops.B.float(), kw["s2"]))
    return tuple(torch.cat(x) for x in zip(*parts))


@pytest.mark.parametrize("n_terms", [3, 4])
@pytest.mark.parametrize("M", [4, 5, 6])
def test_sne_order_meets_the_card_tolerances(M, n_terms):
    args, kw = QL.varcoeff_case(M, n_terms)
    kw = dict(kw, method="sne")
    got = emulate_sne(args, kw)
    want = K2.fused_enhance_varcoeff_2d_ref(*args, **kw)
    assert got[0].shape == want[0].shape == (QL.N * QL.N, M * M)
    QL.check_against_plain(got, want, "varcoeff2d_sne_kernel")


def test_sne_emulation_solves_the_least_squares_problem():
    """The emulated semi-normal solve against a float64 least-squares
    solve of well-conditioned random systems."""
    g = torch.Generator().manual_seed(0)
    G = torch.randn(64, 36, 16, generator=g)
    rhs = torch.randn(64, 36, generator=g)
    want = torch.linalg.lstsq(G.double(), rhs.double()[..., None])
    got = sne_solve(G, rhs)
    assert float((got - want.solution[..., 0]).abs().max()) < 1e-4


# -------------------------------------------------------------------- 1D

def row_G_1d(AZ, a2, a1, a0, k):
    """Column k of G over the rows: a0 (W0 Z) + (a1 (W1 Z) + a2 (W2 Z))."""
    return fma(a0, AZ[:, 2, k, None], fma(a1, AZ[:, 1, k, None],
                                          a2 * AZ[:, 0, k, None]))


def emulate_1d(fem, coef, he, host, h):
    """(w, slack, bcv, cond) of varcoeff_kernel: fem [E+1], coef [4, C, E]
    (a2, a1, a0, f), he [E] or None."""
    AZ, AP, Z, B, Pbc = (t.float() for t in K.pack_varcoeff(host))
    M, K_ = host.Z.shape
    C = AZ.shape[0]
    inv_s2 = torch.tensor(1.0 / host.s2, dtype=torch.float32)
    s2 = torch.tensor(host.s2, dtype=torch.float32)
    a2, a1, a0, f = coef[0], coef[1], coef[2], coef[3]
    if he is not None:
        rho = torch.tensor(h, dtype=torch.float32) / he
        a2 = a2 * (rho * rho)
        a1 = a1 * rho
    b0, b1 = fem[:-1], fem[1:]
    p = [fma(AP[:, 2 * i + 1, None], b1, AP[:, 2 * i, None] * b0)
         for i in range(3)]  # p2, p1, p0
    g = f * inv_s2 - fma(a0, p[2], fma(a1, p[1], a2 * p[0]))
    G = [row_G_1d(AZ, a2, a1, a0, k) for k in range(K_)]  # K x [C, E]
    q = list(G)
    R = {}
    for j in range(K_):
        for pass_ in range(2):
            for i in range(j):
                rij = torch.zeros_like(g[0])
                for c in range(C):
                    rij = fma(q[i][c], q[j][c], rij)
                R[i, j] = rij if pass_ == 0 else R[i, j] + rij
                q[j] = fma(-rij, q[i], q[j])
        nrm = torch.zeros_like(g[0])
        for c in range(C):
            nrm = fma(q[j][c], q[j][c], nrm)
        R[j, j] = torch.sqrt(nrm)
        q[j] = q[j] * (1.0 / (R[j, j] + EPS))
    y = [torch.zeros_like(g[0]) for _ in range(K_)]
    for c in range(C):
        for j in range(K_):
            y[j] = fma(q[j][c], g[c], y[j])
    for j in reversed(range(K_)):
        acc = y[j]
        for i in range(j + 1, K_):
            acc = fma(-R[j, i], y[i], acc)
        y[j] = acc / (R[j, j] + EPS)
    w = []
    for m in range(M):
        zy = torch.zeros_like(b0)
        for k in range(K_):
            zy = fma(Z[m, k], y[k], zy)
        w.append(fma(Pbc[m, 1], b1, Pbc[m, 0] * b0) + zy)
    er = g
    for k in range(K_):
        er = fma(-G[k], y[k], er)
    slack = s2 * er.abs().amax(0)
    r = []
    for row in range(2):
        acc = torch.zeros_like(b0)
        for m in range(M):
            acc = fma(B[row, m], w[m], acc)
        r.append(acc)
    bcv = torch.maximum((b0 - r[0]).abs(), (b1 - r[1]).abs())
    dR = torch.stack([R[j, j] for j in range(K_)])
    cond = dR.amax(0) / torch.clamp(dR.amin(0), min=EPS)
    return torch.stack(w, dim=1), slack, bcv, cond


def case_1d(M, graded, E=4096, seed=0):
    """chip_smoke's 1D kernel inputs (kernel_inputs) at E elements:
    (args, keywords) of fused_enhance_varcoeff."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, E + 1)
    fem = np.sin(np.pi * x) + 1e-3 * rng.normal(size=E + 1)
    fem[0] = fem[-1] = 0.0
    h = 2.0 / E
    vc = problems.variable_coeff_elliptic()
    host = K.VarCoeffOperators.host(M, 12, h)
    if not graded:
        fem = torch.tensor(fem, dtype=torch.float32)
        return (fem, vc, host, -1.0, h, 12), dict(f_shifted_fn=vc.f_shifted)
    xs = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, E))])
    nodes = torch.tensor(-1.0 + 2.0 * xs / xs[-1], dtype=torch.float32)
    fem = torch.sin(torch.pi * nodes)
    return (fem, vc, host, -1.0, h, 12), dict(nodes=nodes)


def emulate_case_1d(args, kw):
    fem, problem, host, x0, h, C = args
    coef, he = K._sample_varcoeff(fem, problem, x0, h, C,
                                  kw.get("f_shifted_fn"), kw.get("nodes"))
    return emulate_1d(fem, coef, he, host, h)


def check_1d(got, want, graded):
    """chip_smoke's checks of varcoeff_kernel against its plain version
    (phase_kernels)."""
    w_tol = CS.GRADED_TOL if graded else CS.VC_TOL
    assert float((got[0] - want[0]).abs().max()) <= w_tol
    assert float((got[2] - want[2]).abs().max()) <= CS.BCV_TOL
    assert float(((got[3] - want[3]).abs() / want[3]).max()) <= 1e-3
    assert 0.2 < float(got[1].max()) / float(want[1].max()) < 5.0
    for i, rel in ((1, CS.SLACK_REL["varcoeff_kernel"]), (2, CS.BCV_REL)):
        assert float(want[i].mean()) > 0
        assert float((got[i] - want[i]).abs().max()) <= \
            rel * float(want[i].max())
        ratio = float(got[i].mean()) / float(want[i].mean())
        assert CS.MEAN_RATIO[0] < ratio < CS.MEAN_RATIO[1]


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("M", [4, 8, 12])
def test_1d_order_meets_the_card_tolerances(M, graded):
    args, kw = case_1d(M, graded)
    got = emulate_case_1d(args, kw)
    want = K.fused_enhance_varcoeff_ref(*args, **kw)
    assert got[0].shape == want[0].shape == (4096, M)
    check_1d(got, want, graded)


def test_1d_shapes_and_packing_follow_the_source():
    """``kernels.SHAPES`` is the source's ENH_SHAPES, and the packed
    statics have VcLayout's size: AZ [C][3][KP], AP [C][8], Z [M][KP],
    B [2][MP], Pbc [M][2]."""
    src = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                       "enhance1d.cu")
    with open(src) as fh:
        line = re.search(r"#define ENH_SHAPES\(X\)(.*)", fh.read()).group(1)
    assert K.SHAPES == tuple((int(m), int(c)) for m, c in
                             re.findall(r"X\((\d+), (\d+)\)", line))
    for M, C in K.SHAPES:
        host = K.VarCoeffOperators.host(M, C, 0.1)
        KP, MP = -(-(M - 2) // 4) * 4, -(-M // 4) * 4
        parts = K.pack_varcoeff(host)
        assert [tuple(t.shape) for t in parts] == [
            (C, 3, KP), (C, 8), (M, KP), (2, MP), (M, 2)]
        assert sum(t.numel() for t in parts) == \
            C * 3 * KP + 8 * C + M * KP + 2 * MP + 2 * M
        assert torch.equal(parts[0][:, :, :M - 2],
                           host.AZ.permute(1, 0, 2))
        assert torch.equal(parts[1][:, :6].reshape(C, 3, 2),
                           host.AP.permute(1, 0, 2))


def spread_1d(got, want):
    rec = QL.spread(got[:3], want[:3])
    rec["cond_rel"] = float(((got[3] - want[3]).abs() / want[3]).max())
    return rec


if __name__ == "__main__":
    # python tests/test_torch_varcoeff_order.py [n]: the emulated kernels
    # against the plain versions on chip_smoke's inputs (sne at M = C = 6
    # on n x n quads; 1D at its E = 2^20, M = 8, C = 12).
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    torch.set_num_threads(os.cpu_count() or 1)
    args, kw = QL.varcoeff_case(6, 3, n)
    kw = dict(kw, method="sne")
    rec = QL.spread(emulate_sne(args, kw),
                    K2.fused_enhance_varcoeff_2d_ref(*args, **kw))
    print(f"varcoeff2d_sne_kernel, variable_coeff_elliptic_2d, {n}x{n}, "
          f"M=6: " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()),
          flush=True)
    fem, _, host, h, graded = CS.kernel_inputs("cpu")
    vc = problems.variable_coeff_elliptic()
    for name, args, kw in (
            ("uniform", (fem, vc, host, -1.0, h, CS.C),
             dict(f_shifted_fn=vc.f_shifted)),
            ("graded", (torch.sin(torch.pi * graded), vc, host, -1.0, h,
                        CS.C), dict(nodes=graded))):
        rec = spread_1d(emulate_case_1d(args, kw),
                        K.fused_enhance_varcoeff_ref(*args, **kw))
        print(f"varcoeff_kernel, variable_coeff_elliptic, {name}, "
              f"E={fem.shape[0] - 1}, M={CS.M}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()),
              flush=True)
