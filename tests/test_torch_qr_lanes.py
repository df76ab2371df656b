"""The arithmetic of the per-quad least-squares kernels ``graded2d_kernel``
and ``varcoeff2d_qr_kernel`` (``csrc/enhance_qr.cuh``), on the CPU.

The kernels give each quad a group of L = 8 lanes.  Its C^2 collocation
rows are padded with zero rows to L ceil(C^2 / L); lane l holds rows
q = l + L r.  Every dot product of the CGS2 QR (two modified Gram-Schmidt
passes a column, in column order, the reference's algebra) is the lane's
partial sum over its rows in order, one fma a row, then a butterfly over
lane distances 1, 2 and 4.  The axpys are one fma an entry, a column is
normalised as v times 1 / (r_jj + 1e-30), and the back substitution takes
the reference's order, one fma a term.  G's rows and g are built one fma a
block (and g's products AP_b bc one fma a term), w = Pbc bc + Z y and B w
one fma a term in order.  The emulation below repeats that arithmetic in
float32 torch: an fma is the float64 product and sum rounded to float32,
which differs from a true fma only where that double rounding meets a tie.
It holds w, the slack and bcv to ``chip_smoke.py``'s tolerances against
the plain versions: w 3e-5, bcv 1e-5, the slack in magnitude within
(0.2, 5), the slack per quad within SLACK_REL of its largest value and
bcv within BCV_REL, and both means within MEAN_RATIO.  Cases: the graded
kernel on the power-law mesh of ``chip_smoke.graded_mesh`` (power 1.5, the
ill-conditioned case) and the uniform variable-coefficient kernel with
three and four operator terms, at 16^2 quads, M = C = 4, 5, 6.  Also: the
systems chip_smoke hands ``torch.linalg.lstsq`` as the per-element
kernels' yardstick are the plain versions' (``least_squares_system``).

Run as a script (``python tests/test_torch_qr_lanes.py [n]``, a few
minutes at the default n = 1024), it prints both kernels' diagnostics as
emulated against the plain versions at chip_smoke's shapes: the
prediction for the card.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as CS  # noqa: E402
from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig,  # noqa: E402
                                        get_problem_2d, problems)
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.models import (  # noqa: E402
    hybrid2d_graded as HG)
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.ops import (  # noqa: E402
    kernels2d_graded as KG)

torch.set_num_threads(1)

L = 8  # lanes a quad (enh::qr::kLanes)
N = 16  # quads a side
EPS = 1e-30


def power_nodes(n, power=1.5):
    """Power-law stretched nodes on [-1, 1], clustered toward the centre
    (a copy of the JAX package's cli._graded_axis_nodes)."""
    s = np.linspace(-1.0, 1.0, n + 1)
    return np.sign(s) * np.abs(s) ** power


def fma(a, b, c):
    """a b + c rounded once to float32 (through float64)."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(p):
    """The group's sum of the lanes' partial sums p [..., L], as the
    kernel's __shfl_xor_sync butterfly over lane distances 1, 2, 4 adds
    them: every lane ends with the same value."""
    for o in (1, 2, 4):
        p = p + p[..., torch.arange(L) ^ o]
    return p[..., 0]


def group_dot(a, b):
    """sum_q a_q b_q of rows laid out [E, R, L] (row q = l + L r)."""
    p = torch.zeros(a.shape[0], L)
    for r in range(a.shape[1]):
        p = fma(a[:, r], b[:, r], p)
    return butterfly(p)


def build(cs, fq, bc, AZ, AP):
    """G [E, C2, K] and g [E, C2] as the kernels build them: cs [NB][C2, E]
    the row weights (blocks past len(cs) skipped), fq [C2, E], bc [KB, E],
    AZ [NB, C2, K], AP [NB, C2, KB]."""
    E = bc.shape[1]
    C2, K = AZ.shape[1:]
    G = torch.zeros(E, C2, K)
    dwp = torch.zeros(E, C2)
    for b, c in enumerate(cs):
        p = torch.zeros(E, C2)
        for k in range(AP.shape[2]):
            p = fma(AP[b, :, k][None], bc[k][:, None], p)
        dwp = fma(c.T, p, dwp)
        G = fma(c.T[:, :, None], AZ[b][None], G)
    return G, fq.T - dwp


def qr_solve(G, g):
    """y [E, K] of the group's CGS2 QR and back substitution."""
    E, C2, K = G.shape
    R = -(-C2 // L)
    pad = R * L - C2
    Gp = torch.cat([G, G.new_zeros(E, pad, K)], 1).reshape(E, R, L, K)
    gp = torch.cat([g, g.new_zeros(E, pad)], 1).reshape(E, R, L)
    Q = []
    Rm = {}
    for j in range(K):
        v = Gp[..., j]
        for _pass in range(2):
            for i in range(j):
                rij = group_dot(Q[i], v)
                Rm[i, j] = rij if _pass == 0 else Rm[i, j] + rij
                v = fma(-rij[:, None, None], Q[i], v)
        Rm[j, j] = torch.sqrt(group_dot(v, v))
        Q.append(v * (1.0 / (Rm[j, j] + EPS))[:, None, None])
    y = [None] * K
    for j in reversed(range(K)):
        acc = group_dot(Q[j], gp)
        for i in range(j + 1, K):
            acc = fma(-Rm[j, i], y[i], acc)
        y[j] = acc / (Rm[j, j] + EPS)
    return torch.stack(y, dim=1)


def finish(G, g, y, bc, Pbc, Z, B, scale):
    """(w [E, M2], slack [E], bcv [E]) as the kernels compute them."""
    E = bc.shape[1]
    M2 = Z.shape[0]
    wp = torch.zeros(E, M2)
    for k in range(bc.shape[0]):
        wp = fma(Pbc[:, k][None], bc[k][:, None], wp)
    zy = torch.zeros(E, M2)
    for k in range(y.shape[1]):
        zy = fma(Z[:, k][None], y[:, k][:, None], zy)
    w = wp + zy
    bw = torch.zeros(E, bc.shape[0])
    for m in range(M2):
        bw = fma(B[:, m][None], w[:, m][:, None], bw)
    er = g
    for k in range(y.shape[1]):
        er = fma(-G[..., k], y[:, k][:, None], er)
    return w, scale * er.abs().amax(1), (bc.T - bw).abs().amax(1)


def emulate(cs, fq, bc, ops, nb, scale):
    NB = ops.AZ.shape[0] // fq.shape[0]
    AZ = ops.AZ.float().reshape(NB, fq.shape[0], -1)
    AP = ops.AP.float().reshape(NB, fq.shape[0], -1)
    G, g = build(cs[:nb], fq, bc, AZ, AP)
    y = qr_solve(G, g)
    return finish(G, g, y, bc, ops.Pbc.float(), ops.Z.float(),
                  ops.B.float(), scale)


def graded_case(M, n=N):
    p = get_problem_2d("variable_coeff_elliptic_2d")
    cfg = Solver2DConfig(M=M, n_colloc=M, dtype="float32")
    gops, (t_int, bpts) = HG.prepare_shared_2d_graded(p, cfg)
    nodes = power_nodes(n)
    xs = torch.tensor(nodes, dtype=torch.float32)
    nodal = CS.nodal_grid_graded(p, nodes, nodes, "cpu")
    return (nodal, gops, p, xs, xs.clone(), n, n, t_int, bpts)


def emulate_graded(args):
    nodal, gops, p, xs, ys, nx, ny, t_int, bpts = args
    coef, f, gedge, pts = KG._sample(nodal, p, xs, ys, nx, ny, t_int, bpts)
    parts = [emulate(cs, fc * i2, bc, gops, 5, s2[0])
             for cs, fc, bc, i2, s2 in KG._chunks(nodal, coef, f, gedge, pts,
                                                   p, xs, ys, nx, ny)]
    return tuple(torch.cat(x) for x in zip(*parts))


def varcoeff_case(M, n_terms, n=N):
    p = get_problem_2d("variable_coeff_elliptic_2d")
    if n_terms == 4:  # reaction and advection beside the diffusion
        p = dataclasses.replace(p, c=2.0, b=(1.0, -0.5))
    cfg = Solver2DConfig(nx=n, ny=n, M=M, n_colloc=M, dtype="float32")
    vops, (t_int, bpts) = H2.prepare_shared_2d(p, cfg)
    assert vops.n_terms == n_terms
    h = 2.0 / n
    s2 = 2.0 * (2.0 / h) ** 2
    nodal = CS.nodal_grid_2d(p, "cpu", n)
    args = (nodal, vops, p.a_var, p.grad_a, p.f, p.g, (-1.0, h, -1.0, h), n,
            n, t_int, bpts)
    return args, dict(s2=s2, method="qr", f_shifted_fn=p.f_shifted)


def emulate_varcoeff(args, kw, chunk=K2.PLAIN_CHUNK):
    nodal, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int, bpts = args
    coef, f, gedge, pts = K2._varcoeff_inputs(
        nodal, vops, a_fn, grad_a, f_fn, g_fn, geom, nx, ny, t_int, bpts,
        kw["f_shifted_fn"], "qr")
    bc = K2._trace_bc(nodal, gedge, pts, nx, ny)
    inv_s2 = torch.tensor(1.0 / kw["s2"], dtype=torch.float32)
    parts = []
    for lo in range(0, nx * ny, chunk):
        sl = slice(lo, lo + chunk)
        c = coef[:, :, sl]
        cs = (-c[0], -c[1], -c[2], torch.ones_like(c[0]))
        parts.append(emulate(cs, f[:, sl] * inv_s2, bc[:, sl], vops,
                             vops.n_terms, kw["s2"]))
    return tuple(torch.cat(x) for x in zip(*parts))


def check_against_plain(got, want, kname):
    """chip_smoke's checks of a per-element kernel against its plain
    version (check_kernel_against_plain, check_diagnostic)."""
    assert float((got[0] - want[0]).abs().max()) <= 3e-5
    assert float((got[2] - want[2]).abs().max()) <= 1e-5
    assert 0.2 < float(got[1].max()) / float(want[1].max()) < 5.0
    for i, rel in ((1, CS.SLACK_REL[kname]), (2, CS.BCV_REL)):
        assert float(want[i].mean()) > 0
        assert float((got[i] - want[i]).abs().max()) <= \
            rel * float(want[i].max())
        ratio = float(got[i].mean()) / float(want[i].mean())
        assert CS.MEAN_RATIO[0] < ratio < CS.MEAN_RATIO[1]


def test_butterfly_adds_in_the_kernels_order():
    """Lanes (0, 1), (2, 3), ... first, then pairs of pairs: a sum whose
    order shows (a large term cancelled late)."""
    p = torch.tensor([1e8, 1.0, -1e8, 1.0, 0.5, 0.25, 0.125, 3.0])
    want = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]))
    assert float(butterfly(p)) == float(want)
    assert float(butterfly(p)) != float(p.double().sum())


def test_group_qr_solves_the_least_squares_problem():
    """The emulated group QR against a float64 least-squares solve."""
    g = torch.Generator().manual_seed(0)
    G = torch.randn(64, 36, 16, generator=g)
    rhs = torch.randn(64, 36, generator=g)
    want = torch.linalg.lstsq(G.double(), rhs.double()[..., None])
    got = qr_solve(G, rhs)
    assert float((got - want.solution[..., 0]).abs().max()) < 1e-4


@pytest.mark.parametrize("M", [4, 5, 6])
def test_graded_lanes_meet_the_card_tolerances(M):
    args = graded_case(M)
    got = emulate_graded(args)
    want = KG.fused_enhance_graded_2d_ref(*args)
    assert got[0].shape == want[0].shape == (N * N, M * M)
    check_against_plain(got, want, "graded2d_kernel")


@pytest.mark.parametrize("n_terms", [3, 4])
@pytest.mark.parametrize("M", [4, 5, 6])
def test_varcoeff_qr_lanes_meet_the_card_tolerances(M, n_terms):
    args, kw = varcoeff_case(M, n_terms)
    got = emulate_varcoeff(args, kw)
    want = K2.fused_enhance_varcoeff_2d_ref(*args, **kw)
    assert got[0].shape == want[0].shape == (N * N, M * M)
    check_against_plain(got, want, "varcoeff2d_qr_kernel")


def yardstick_case(kind):
    """(G, g, w of the plain version, bc, Pbc, Z) for chip_smoke's
    torch.linalg.lstsq yardstick of each per-element kernel."""
    if kind == "graded":
        args = graded_case(6, 8)
        nodal, gops, p, xs, ys, nx, ny, t_int, bpts = args
        G, g = KG.least_squares_system(*args)
        bc = K2._trace_bc(nodal, *KG._sample(nodal, p, xs, ys, nx, ny, t_int,
                                             bpts)[2:], nx, ny)
        return G, g, KG.fused_enhance_graded_2d_ref(*args)[0], bc, gops
    if kind == "varcoeff_2d":
        args, kw = varcoeff_case(6, 4, 8)
        G, g = K2.varcoeff_least_squares_system(*args, kw["s2"],
                                                kw["f_shifted_fn"])
        nodal, vops = args[:2]
        pts = K2._varcoeff_inputs(*args, kw["f_shifted_fn"], "qr")[2:]
        bc = K2._trace_bc(nodal, *pts, args[7], args[8])
        return G, g, K2.fused_enhance_varcoeff_2d_ref(*args, **kw)[0], bc, \
            vops
    E, h = 64, 2.0 / 64
    vc = problems.variable_coeff_elliptic()
    host = K.VarCoeffOperators.host(8, 12, h)
    nodal = torch.sin(torch.pi * torch.linspace(-1.0, 1.0, E + 1,
                                                dtype=torch.float64)).float()
    args = (nodal, vc, host, -1.0, h, 12)
    G, g = K.varcoeff_least_squares_system(*args, f_shifted_fn=vc.f_shifted)
    return G, g, K.fused_enhance_varcoeff_ref(
        *args, f_shifted_fn=vc.f_shifted)[0], \
        torch.stack([nodal[:-1], nodal[1:]]), host


@pytest.mark.parametrize("kind", ["graded", "varcoeff_2d", "varcoeff_1d"])
def test_lstsq_yardstick_solves_the_plain_versions_systems(kind):
    """chip_smoke times torch.linalg.lstsq on the systems that
    ``least_squares_system`` hands it: solved (in float64), they give the
    plain version's w."""
    G, g, w_plain, bc, ops = yardstick_case(kind)
    assert G.shape[:2] == g.shape and G.shape[0] == w_plain.shape[0]
    y = torch.linalg.lstsq(G.double(), g.double()[..., None]).solution[..., 0]
    w = (ops.Pbc.double() @ bc.double() + ops.Z.double() @ y.T).T
    assert float((w - w_plain).abs().max()) < 1e-6


def spread(got, want):
    """What chip_smoke reads: w's largest difference, the slack's and
    bcv's largest difference relative to the plain version's largest value
    and their means over the plain version's."""
    rec = {"w_err": float((got[0] - want[0]).abs().max())}
    for i, what in ((1, "slack"), (2, "bcv")):
        rec[f"{what}_rel"] = float((got[i] - want[i]).abs().max()) / \
            float(want[i].max())
        rec[f"{what}_mean_ratio"] = float(got[i].mean()) / \
            float(want[i].mean())
    return rec


if __name__ == "__main__":
    # python tests/test_torch_qr_lanes.py [n]: the emulated kernels against
    # the plain versions at chip_smoke's shapes (M = C = 6, n x n quads).
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    torch.set_num_threads(os.cpu_count() or 1)
    args = graded_case(6, n)
    rec = spread(emulate_graded(args), KG.fused_enhance_graded_2d_ref(*args))
    print(f"graded2d_kernel, variable_coeff_elliptic_2d, power-law {n}x{n}, "
          f"M=6: " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()),
          flush=True)
    args, kw = varcoeff_case(6, 3, n)
    rec = spread(emulate_varcoeff(args, kw),
                 K2.fused_enhance_varcoeff_2d_ref(*args, **kw))
    print(f"varcoeff2d_qr_kernel, variable_coeff_elliptic_2d, {n}x{n}, M=6: "
          + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()), flush=True)
