"""The arithmetic and the operator layout of the tensor-core enhancement
kernels, on the CPU.

``csrc/enhance3d.cu``, ``csrc/enhance2d_elastic.cu`` and
``csrc/enhance2d.cu`` compute their products on the tensor cores in split
TF32 (``csrc/enhance_mma.cuh``): each float32 operand x becomes
hi = tf32(x) and lo = tf32(x - hi), and a product a b is summed from
lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32; the elastic w also adds
lo_a lo_b; the 2D shared w also splits the operator a third time,
lo2_b = tf32(b - hi_b - lo_b), and adds lo_a lo_b and hi_a lo2_b; its D w
is hi_a hi_b alone).  The emulation below repeats that arithmetic with
torch on the operators as the wrappers pack them, and holds its w, slack
and bcv to ``chip_smoke.py``'s tolerances against the plain float32
versions: w 2e-5 (3D and 2D stacked), 3e-5 (elasticity) and 1e-5 (2D
shared), bcv 1e-5, the slack per element within SLACK_REL of its largest
value and in the mean within MEAN_RATIO, bcv with B scaled by 1.5 within
BCV_SKEWED_REL relative, and w on zero nodal values within RHS_REL_TOL
relative.  (In 2D, bcv is held in the mean at 256^2 quads, M = 6: on 16^2
quads its mean, rounding of an exact zero over 256 quads, moves between
0.5 and 1.7 of the plain version's with M.)  Plain TF32 (hi * hi alone)
fails the w tolerance, so the checks on the card see a dropped lo term.
The packed statics of every compiled (M, C) unpack to the bundle's
operators with zeros in the padding.

Run as a script at the main paths' sizes (``python
tests/test_torch_tf32_split.py 1024 128``, about two minutes), it prints
the slack's spread that makes the elastic w take a fourth product, and
the 2D constant-coefficient kernels' diagnostics against their plain
versions as the kernels compute them (and the shared one with w in
3xTF32, which its slack's check refuses).
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
                                        Solver3DConfig, get_problem_2d,
                                        get_problem_3d)
from hybrid_fem_lssvr_tpu_torch.models import elastic as EL  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2  # noqa: E402
from hybrid_fem_lssvr_tpu_torch.ops import (  # noqa: E402
    kernels2d_elastic as KE)
from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3  # noqa: E402

torch.set_num_threads(1)

N3D = 8  # hexes a side
NE = 16  # quads a side
NMEAN = 256  # quads a side where the 2D diagnostics are held in the mean


def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: 13 mantissa bits
    dropped, to nearest, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split_mm(a, op, terms):
    """a [E, K] @ op [K, N] in split TF32 with ``terms`` products (1: plain
    TF32, 3: 3xTF32, 4: with lo * lo), each exact in float32 and summed in
    float32, small terms first as the kernels do.  ``op`` is either a
    float32 matrix, split here, or its (hi, lo) pair as packed."""
    oh, ol = op if isinstance(op, tuple) else (tf32(op), tf32(op - tf32(op)))
    ah = tf32(a)
    if terms == 1:
        return ah @ oh
    al = tf32(a - ah)
    out = al @ oh + ah @ ol
    if terms == 4:
        out = al @ ol + out
    return out + ah @ oh


def unfrag(frag, K, N, interleave=False):
    """The (hi, lo) parts of the [K, N] operator held by a split,
    fragment-ordered copy (``kernels2d._frag``), read by the kernels'
    indexing: lane 4 g + t of k-step ks and n-tile nt holds
    (b0.hi, b1.hi, b0.lo, b1.lo), b0 at (8 ks + t, 8 nt + g), b1 at
    (8 ks + t + 4, 8 nt + g), the columns of an n-tile in the order
    ``_INTERLEAVE`` where ``interleave``; and all the padding."""
    Kp, Np = K2._pad8(K), K2._pad8(N)
    flat = frag.reshape(Kp // 8, Np // 8, 32, 4)
    hi = torch.empty(Kp, Np, dtype=frag.dtype)
    lo = torch.empty(Kp, Np, dtype=frag.dtype)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    order = K2._INTERLEAVE if interleave else tuple(range(8))
    for ks in range(Kp // 8):
        for nt in range(Np // 8):
            col = 8 * nt + torch.tensor(order)[g]
            hi[8 * ks + t, col] = flat[ks, nt, :, 0]
            hi[8 * ks + t + 4, col] = flat[ks, nt, :, 1]
            lo[8 * ks + t, col] = flat[ks, nt, :, 2]
            lo[8 * ks + t + 4, col] = flat[ks, nt, :, 3]
    pad = torch.cat([x[K:].reshape(-1) for x in (hi, lo)]
                    + [x[:, N:].reshape(-1) for x in (hi, lo)])
    return (hi[:K, :N], lo[:K, :N]), pad


def assert_split_of(parts, op):
    """``parts`` is the TF32 split of float32 ``op``: hi = tf32(op) and
    lo = tf32(op - hi), so hi + lo is op to 2^-21."""
    hi, lo = parts
    op = op.to(torch.float32)
    assert torch.equal(hi, tf32(op)) and torch.equal(lo, tf32(op - hi))
    assert bool(((hi + lo - op).abs() <= 2.0 ** -21 * op.abs()).all())


# ------------------------------------------------------------------ 3D

def case_3d(zero=False, skew=False):
    p = get_problem_3d("poisson_3d_inhomogeneous")
    n = N3D
    cfg = Solver3DConfig(nx=n, ny=n, nz=n, M=4, n_colloc=4, dtype="float32")
    ops, (t_int, spts) = H3.prepare_shared_3d(p, cfg)
    if skew:
        ops = dataclasses.replace(ops, B=1.5 * ops.B)
    rng = np.random.default_rng(0)
    Z, Y, X = np.meshgrid(*[np.linspace(-1, 1, n + 1)] * 3, indexing="ij")
    u = p.exact(*(torch.tensor(v) for v in (X, Y, Z))).numpy().copy()
    u[1:-1, 1:-1, 1:-1] += 1e-3 * rng.normal(size=(n - 1,) * 3)
    fem = torch.tensor(u, dtype=torch.float32)
    g = p.g
    if zero:
        fem = torch.zeros_like(fem)
        g = CS.zero_g_3d
    return (fem, ops, p.f, g, (-1.0, 2.0 / n) * 3, n, n, n, t_int, spts), \
        dict(f_shifted_fn=p.f_shifted)


def emulate_3d(args, kw, terms=3):
    """What stacked3d_kernel computes, from the statics as packed."""
    fem, ops, f_fn, g_fn, geom, nx, ny, nz, t_int, spts = args
    f, gface, pts = K3._inputs(fem, ops, f_fn, g_fn, geom, nx, ny, nz, t_int,
                               spts, kw["f_shifted_fn"])
    bc = K3._trace_bc(fem, gface, pts, nx, ny, nz)
    OF, BF, _ = K3._pack(ops.Wf, ops.Wbc, ops.Pres, ops.Qres, ops.B, pts)
    M3, C3 = ops.Wf.shape
    S = bc.shape[0]
    OT = unfrag(OF, C3 + S, M3 + C3, interleave=True)[0]
    BT = unfrag(BF, M3, S)[0]
    out = split_mm(torch.cat([f, bc]).T, OT, terms)
    w = out[:, :M3]
    bcv = (bc.T - split_mm(w, BT, min(terms, 3))).abs().amax(1)
    return w, out[:, M3:].abs().amax(1), bcv


def check_diagnostic(got, want, rel):
    """chip_smoke's check_diagnostic: per element within ``rel`` of the
    plain version's largest value, the means within MEAN_RATIO."""
    assert float(want.mean()) > 0
    assert float((got - want).abs().max()) <= rel * float(want.max())
    ratio = float(got.mean()) / float(want.mean())
    assert CS.MEAN_RATIO[0] < ratio < CS.MEAN_RATIO[1]


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp, 3.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    v = torch.tensor(np.random.default_rng(0).normal(size=1000),
                     dtype=torch.float32)
    hi = tf32(v)
    lo = tf32(v - hi)
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21


def test_3d_split_meets_the_card_tolerances():
    args, kw = case_3d()
    got = emulate_3d(args, kw)
    want = K3.fused_enhance_stacked_3d(*args, **kw)
    assert float((got[0] - want[0]).abs().max()) <= 2e-5
    assert float((got[2] - want[2]).abs().max()) <= 1e-5
    check_diagnostic(got[1], want[1], CS.SLACK_REL["stacked3d_kernel"])
    check_diagnostic(got[2], want[2], CS.BCV_REL)
    # bcv with B scaled by 1.5: ~max |bc| / 2, not rounding
    args, kw = case_3d(skew=True)
    got_b, want_b = emulate_3d(args, kw)[2], \
        K3.fused_enhance_stacked_3d(*args, **kw)[2]
    assert float(want_b.median()) > 1e-3
    assert float((got_b - want_b).abs().max()) <= \
        CS.BCV_SKEWED_REL * float(want_b.max())
    # the rhs part alone
    args, kw = case_3d(zero=True)
    w_rhs, w_plain = emulate_3d(args, kw)[0], \
        K3.fused_enhance_stacked_3d(*args, **kw)[0]
    size = float(w_plain.abs().max())
    assert size > 0
    assert float((w_rhs - w_plain).abs().max()) <= CS.RHS_REL_TOL * size


def test_3d_plain_tf32_fails_the_w_tolerance():
    args, kw = case_3d()
    got = emulate_3d(args, kw, terms=1)[0]
    want = K3.fused_enhance_stacked_3d(*args, **kw)[0]
    assert float((got - want).abs().max()) > 2e-5


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("M,C", K3.SHAPES)
def test_3d_statics_unpack_to_the_bundle(M, C, diag):
    p = get_problem_3d("poisson_3d")
    cfg = Solver3DConfig(nx=2, ny=2, nz=2, M=M, n_colloc=C, dtype="float32")
    ops, (_, spts) = H3.prepare_shared_3d(p, cfg)
    pts = K3._trace_points(spts, torch.float32, "cpu")
    OF, BF, P = K3._pack(ops.Wf, ops.Wbc, ops.Pres, ops.Qres, ops.B, pts,
                         with_diagnostics=diag)
    O = K2._stacked_operator(ops.Wf, ops.Wbc, ops.Pres, ops.Qres, diag)
    for frag, op, inter in ((OF, O.T, True), (BF, ops.B.T, False)):
        got, pad = unfrag(frag, *op.shape, interleave=inter)
        assert_split_of(got, op)
        assert not pad.any()
    assert P is pts
    # the layout csrc/enhance3d.cu's Layout3 reads: O^T, B^T, [14][S]
    S = ops.B.shape[0]
    assert OF.numel() == 2 * (C ** 3 + S) * O.shape[0] and \
        BF.numel() == 2 * M ** 3 * S and pts.shape == (14, S)


# --------------------------------------------------------- elasticity

def case_elastic(M, zero=False, skew=False):
    p = EL.get_elastic_problem("poly_elastic_2d")
    n = NE
    cfg = EL.ElasticConfig2D(nx=n, ny=n, M=M, n_colloc=M, dtype="float32")
    ops, (t_int, bpts) = EL.prepare_shared_elastic(p, cfg)
    if skew:
        ops = dataclasses.replace(ops, B=1.5 * ops.B)
    X, Y = np.meshgrid(np.linspace(-1, 1, n + 1), np.linspace(-1, 1, n + 1))
    u = np.stack([e(torch.tensor(X), torch.tensor(Y)).numpy()
                  for e in (p.exact1, p.exact2)])
    u[:, 1:-1, 1:-1] += 1e-3 * np.random.default_rng(0).normal(
        size=(2, n - 1, n - 1))
    fem = torch.tensor(u, dtype=torch.float32)
    gs = (p.g1, p.g2)
    if zero:
        fem = torch.zeros_like(fem)
        gs = (CS.zero_g_2d, CS.zero_g_2d)
    return (fem, ops, (p.f1, p.f2), gs, (-1.0, 2.0 / n) * 2, n, n, t_int,
            bpts)


def elastic_operators(ops, pts):
    """[Wf | Wbc]^T with Wf's rows padded, D^T and each component's rows of
    B^T, as (hi, lo) pairs with their padding, read back from the statics as
    packed; and the first column of w that component 1's rows read."""
    R, FR = ops.Wf.shape
    Kb = ops.B.shape[0] // 2
    OF, P, DF, BF0, BF1 = KE._pack(ops.Wf, ops.Wbc, ops.D, ops.B, pts)
    FRP = K2._pad8(FR)
    b1 = R // 2 // 8 * 8
    return (unfrag(OF, FRP + 2 * Kb, R, interleave=True), P,
            unfrag(DF, R, FR), unfrag(BF0, K2._pad8(R // 2), Kb),
            unfrag(BF1, R - b1, Kb), b1)


def emulate_elastic(args, w_terms=4):
    """What elastic2d_kernel computes, from the statics as packed."""
    fem, ops, f_fns, g_fns, geom, nx, ny, t_int, bpts = args
    f, gedge, pts = KE._inputs(fem, f_fns, g_fns, geom, nx, ny, t_int, bpts)
    bc = torch.cat([K2._trace_bc(fem[c], gedge[c], pts, nx, ny)
                    for c in range(2)])
    (OT, _), _, (DT, _), (B0, _), (B1, _), b1 = elastic_operators(ops, pts)
    FR, Kb = f.shape[0], bc.shape[0] // 2
    z = torch.zeros(f.shape[1], OT[0].shape[0])
    z[:, :FR] = f.T
    z[:, K2._pad8(FR):] = bc.T
    w = split_mm(z, OT, w_terms)
    slack = (f.T - split_mm(w, DT, 3)).abs().amax(1)
    bw = (split_mm(w[:, :B0[0].shape[0]], B0, 3),
          split_mm(w[:, b1:], B1, 3))
    bcv = torch.cat([(bc[c * Kb:(c + 1) * Kb].T - bw[c]).abs()
                     for c in range(2)], dim=1).amax(1)
    return w, slack, bcv


@pytest.mark.parametrize("M", [4, 5, 6])
def test_elastic_split_meets_the_card_tolerances(M):
    args = case_elastic(M)
    got = emulate_elastic(args)
    want = KE.fused_enhance_elastic_2d(*args)
    assert float((got[0] - want[0]).abs().max()) <= 3e-5
    assert float((got[2] - want[2]).abs().max()) <= 1e-5
    check_diagnostic(got[1], want[1], CS.SLACK_REL["elastic2d_kernel"])
    check_diagnostic(got[2], want[2], CS.BCV_REL)
    args = case_elastic(M, skew=True)
    got_b, want_b = emulate_elastic(args)[2], \
        KE.fused_enhance_elastic_2d(*args)[2]
    assert float(want_b.median()) > 1e-3
    assert float((got_b - want_b).abs().max()) <= \
        CS.BCV_SKEWED_REL * float(want_b.max())
    args = case_elastic(M, zero=True)
    w_rhs, w_plain = emulate_elastic(args)[0], \
        KE.fused_enhance_elastic_2d(*args)[0]
    size = float(w_plain.abs().max())
    assert size > 0
    assert float((w_rhs - w_plain).abs().max()) <= CS.RHS_REL_TOL * size


def test_elastic_plain_tf32_fails_the_w_tolerance():
    args = case_elastic(6)
    got = emulate_elastic(args, w_terms=1)[0]
    want = KE.fused_enhance_elastic_2d(*args)[0]
    assert float((got - want).abs().max()) > 3e-5


@pytest.mark.parametrize("M,C", KE.SHAPES)
def test_elastic_statics_unpack_to_the_bundle(M, C):
    p = EL.get_elastic_problem("sin_elastic_2d")
    cfg = EL.ElasticConfig2D(nx=2, ny=2, M=M, n_colloc=C, dtype="float32")
    ops, (_, bpts) = EL.prepare_shared_elastic(p, cfg)
    pts = K2._trace_points(bpts, torch.float32, "cpu")
    (OT, p0), P, (DT, p1), (B0, p2), (B1, p3), b1 = elastic_operators(ops,
                                                                      pts)
    assert not any(q.any() for q in (p0, p1, p2, p3))
    R, FR = ops.Wf.shape
    M2, Kb = R // 2, ops.B.shape[0] // 2
    FRP = K2._pad8(FR)
    zeros = torch.zeros(FRP - FR, R)
    assert_split_of(OT, torch.cat([ops.Wf.T, zeros, ops.Wbc.T]))
    assert_split_of(DT, ops.D.T)
    assert P is pts
    # component 0 reads columns [0, pad8(M2)) of w, component 1 columns
    # [b1, R): its own M2 and zeros elsewhere
    Bs = ops.B[:Kb, :M2]
    assert_split_of(B0, torch.cat([Bs.T, torch.zeros(B0[0].shape[0] - M2,
                                                     Kb)]))
    assert_split_of(B1, torch.cat([torch.zeros(M2 - b1, Kb), Bs.T]))
    assert b1 % 8 == 0 and b1 <= M2


# ------------------------------------------- 2D constant coefficients

# kernel -> (wrapper, CUDA kernel, w tolerance of chip_smoke's check)
KERNELS_2D = {
    "stacked": (K2.fused_enhance_stacked_2d, "stacked2d_kernel", 2e-5),
    "shared": (K2.fused_enhance_shared_2d, "shared2d_kernel", 1e-5),
}
# The TF32 products of a product: (piece of a, piece of the operator),
# pieces hi, lo, lo2; small terms first as the kernels sum them.
PAIRS = {1: ((0, 0),), 3: ((1, 0), (0, 1), (0, 0)),
         5: ((0, 2), (1, 1), (1, 0), (0, 1), (0, 0))}


def shared_split(C2):
    """Where shared2d_kernel changes its number of products: w's k-steps
    before k-step C2 // 8 (f rows alone) take 3, the others 5; [D; B] w's
    columns before c1 = 8 (C2 // 8) (D rows alone) take 1, the others 3."""
    return C2 // 8, 8 * (C2 // 8)


def unfrag_lo2(frag3, K, N, interleave=False):
    """lo2 of the [K, N] operator held by ``kernels2d._frag_lo2``: lane
    4 g + t of k-step ks and n-tile nt holds (b0.lo2, b1.lo2); and its
    padding."""
    Kp, Np = K2._pad8(K), K2._pad8(N)
    flat = frag3.reshape(Kp // 8, Np // 8, 32, 2)
    out = torch.empty(Kp, Np, dtype=frag3.dtype)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    order = K2._INTERLEAVE if interleave else tuple(range(8))
    for ks in range(Kp // 8):
        for nt in range(Np // 8):
            col = 8 * nt + torch.tensor(order)[g]
            out[8 * ks + t, col] = flat[ks, nt, :, 0]
            out[8 * ks + t + 4, col] = flat[ks, nt, :, 1]
    return out[:K, :N], torch.cat([out[K:].reshape(-1),
                                   out[:, N:].reshape(-1)])


def kstep_mm(a, pieces, terms):
    """a [E, K] @ op [K, N] as the kernels compute it: a split in hi and lo,
    the operator given as its pieces (hi, lo[, lo2]), the products of
    PAIRS[terms] (each exact; ``terms`` one number, or one a k-step) summed
    a k-step of 8 at a time, each k-step's sum rounded once to float32 and
    added to the float32 sum to nearest.  (The sums the kernels keep in the
    tensor cores, which round toward zero, are emulated the same way.)"""
    ah = tf32(a)
    parts = (ah, tf32(a - ah))
    out = torch.zeros(a.shape[0], pieces[0].shape[1], dtype=torch.float32)
    for ks, k0 in enumerate(range(0, a.shape[1], 8)):
        n = terms if isinstance(terms, int) else terms[ks]
        step = sum(parts[i][:, k0:k0 + 8].double()
                   @ pieces[j][k0:k0 + 8].double() for i, j in PAIRS[n])
        out = out + step.float()
    return out


def case_2d(kernel, M, zero=False, skew=False, n=NE):
    """chip_smoke's 2D kernel check at n x n quads: poisson_2d_inhomogeneous,
    the exact nodal values plus noise inside; the shared kernel's bundle has
    no residual operators."""
    p = get_problem_2d("poisson_2d_inhomogeneous")
    cfg = Solver2DConfig(nx=n, ny=n, M=M, n_colloc=M, dtype="float32")
    ops, (t_int, bpts) = H2.prepare_shared_2d(p, cfg)
    if kernel == "shared":
        ops = dataclasses.replace(ops, Pres=None, Qres=None)
    if skew:
        ops = dataclasses.replace(ops, B=1.5 * ops.B)
    fem = CS.nodal_grid_2d(p, "cpu", n)
    g = CS.zero_g_2d if zero else p.g
    if zero:
        fem = torch.zeros_like(fem)
    return (fem, ops, p.f, g, (-1.0, 2.0 / n) * 2, n, n, t_int, bpts), \
        dict(f_shifted_fn=p.f_shifted)


def operators_2d(kernel, ops, pts, diag=True):
    """The pieces of the 2D kernel's two products with their padding, read
    back from the statics as packed: stacked, O^T and B^T (hi, lo); shared,
    [Wf | Wbc]^T (hi, lo, lo2) and [D; B]^T (hi, lo).  And the trace
    points."""
    M2, C2 = ops.Wf.shape
    Kb = ops.B.shape[0]
    if kernel == "stacked":
        OF, BF, P = K2._pack_stacked(ops.Wf, ops.Wbc, ops.Pres, ops.Qres,
                                     ops.B, pts, with_diagnostics=diag)
        rows = M2 + C2 if diag else M2
        return unfrag(OF, C2 + Kb, rows, interleave=True), \
            unfrag(BF, M2, Kb), P
    WF, WF3, RF1, RF2, P = K2._pack_shared(ops.Wf, ops.Wbc, ops.D, ops.B,
                                           pts)
    c1 = shared_split(C2)[1]
    (hi, lo), pad = unfrag(WF, C2 + Kb, M2, interleave=True)
    lo2, pad3 = unfrag_lo2(WF3, C2 + Kb - c1, M2, interleave=True)
    lo2 = torch.cat([torch.zeros(c1, M2), lo2])  # k-steps of 3 products
    (r1h, r1l), pad1 = unfrag(RF1, M2, c1)
    (r2h, r2l), pad2 = unfrag(RF2, M2, C2 + Kb - c1)
    return ((hi, lo, lo2), torch.cat([pad, pad3])), \
        ((torch.cat([r1h, r2h], 1), torch.cat([r1l, r2l], 1)),
         torch.cat([pad1, pad2])), P


def emulate_2d_z(kernel, ops, z, w_terms=None, parts=None):
    """What stacked2d_kernel or shared2d_kernel computes from z = [f; bc]
    [C^2 + Kb, E], with the products as packed (``parts``, else packed
    here) and the first in ``w_terms`` products a k-step (the kernel's by
    default): (w, slack, bcv)."""
    M2, C2 = ops.Wf.shape
    if parts is None:
        parts = operators_2d(kernel, ops, None)
    (first, _), (second, _), _ = parts
    if kernel == "stacked":  # 3xTF32 throughout; B w against the trace
        out = kstep_mm(z.T, first, w_terms or 3)
        w = out[:, :M2]
        bcv = (z[C2:].T - kstep_mm(w, second, 3)).abs().amax(1)
        return w, out[:, M2:].abs().amax(1), bcv
    kf, c1 = shared_split(C2)
    w = kstep_mm(z.T, first, w_terms
                 or [3] * kf + [5] * (K2._pad8(z.shape[0]) // 8 - kf))
    r = torch.cat([kstep_mm(w, tuple(x[:, :c1] for x in second), 1),
                   kstep_mm(w, tuple(x[:, c1:] for x in second), 3)], 1)
    r = (z.T - r).abs()  # [D; B] w against z
    return w, r[:, :C2].amax(1), r[:, C2:].amax(1)


def emulate_2d(kernel, args, kw, w_terms=None):
    fem, ops, f_fn, g_fn, geom, nx, ny, t_int, bpts = args
    f, gedge, pts, _ = K2._shared_inputs(fem, f_fn, g_fn, geom, nx, ny,
                                         t_int, bpts, kw["f_shifted_fn"])
    z = torch.cat([f, K2._trace_bc(fem, gedge, pts, nx, ny)])
    return emulate_2d_z(kernel, ops, z, w_terms)


@pytest.mark.parametrize("M", [4, 5, 6])
@pytest.mark.parametrize("kernel", sorted(KERNELS_2D))
def test_2d_split_meets_the_card_tolerances(kernel, M):
    wrapper, kname, w_tol = KERNELS_2D[kernel]
    args, kw = case_2d(kernel, M)
    got, want = emulate_2d(kernel, args, kw), wrapper(*args, **kw)
    assert float((got[0] - want[0]).abs().max()) <= w_tol
    assert float((got[2] - want[2]).abs().max()) <= 1e-5
    assert 0.05 < float(got[1].max()) / float(want[1].max()) < 20.0
    check_diagnostic(got[1], want[1], CS.SLACK_REL[kname])
    assert float((got[2] - want[2]).abs().max()) <= \
        CS.BCV_REL * float(want[2].max())
    args, kw = case_2d(kernel, M, skew=True)
    got_b, want_b = emulate_2d(kernel, args, kw)[2], wrapper(*args, **kw)[2]
    assert float(want_b.median()) > 1e-3
    assert float((got_b - want_b).abs().max()) <= \
        CS.BCV_SKEWED_REL * float(want_b.max())
    args, kw = case_2d(kernel, M, zero=True)
    w_rhs, w_plain = emulate_2d(kernel, args, kw)[0], wrapper(*args, **kw)[0]
    size = float(w_plain.abs().max())
    assert size > 0
    assert float((w_rhs - w_plain).abs().max()) <= CS.RHS_REL_TOL * size


@pytest.mark.parametrize("kernel", sorted(KERNELS_2D))
def test_2d_split_diagnostics_in_the_mean(kernel):
    """The diagnostics' means at M = 6, the main path's shape, on 256^2
    quads, where bcv, rounding of an exact zero, is averaged over enough
    quads (on 16^2 its mean moves between 0.5 and 1.7 of the plain
    version's with M; chip_smoke holds it at 1024^2)."""
    wrapper, kname, _ = KERNELS_2D[kernel]
    args, kw = case_2d(kernel, 6, n=NMEAN)
    got, want = emulate_2d(kernel, args, kw), wrapper(*args, **kw)
    check_diagnostic(got[1], want[1], CS.SLACK_REL[kname])
    check_diagnostic(got[2], want[2], CS.BCV_REL)


@pytest.mark.parametrize("kernel", sorted(KERNELS_2D))
def test_2d_plain_tf32_fails_the_w_tolerance(kernel):
    wrapper, _, w_tol = KERNELS_2D[kernel]
    args, kw = case_2d(kernel, 6)
    got = emulate_2d(kernel, args, kw, w_terms=1)[0]
    assert float((got - wrapper(*args, **kw)[0]).abs().max()) > w_tol


@pytest.mark.parametrize("kernel,diag", [("stacked", True),
                                         ("stacked", False),
                                         ("shared", True)])
@pytest.mark.parametrize("M,C", K2.SHAPES)
def test_2d_statics_unpack_to_the_bundle(kernel, diag, M, C):
    p = get_problem_2d("poisson_2d")
    cfg = Solver2DConfig(nx=2, ny=2, M=M, n_colloc=C, dtype="float32")
    ops, (_, bpts) = H2.prepare_shared_2d(p, cfg)
    pts = K2._trace_points(bpts, torch.float32, "cpu")
    (first, p0), (second, p1), P = operators_2d(kernel, ops, pts, diag)
    assert not p0.any() and not p1.any()
    assert P is pts
    if kernel == "stacked":
        assert_split_of(first, K2._stacked_operator(
            ops.Wf, ops.Wbc, ops.Pres, ops.Qres, diag).T)
    else:
        W = torch.cat([ops.Wf, ops.Wbc], dim=1).T.to(torch.float32)
        assert_split_of(first[:2], W)
        # lo2 where w's k-steps take five products: hi + lo + lo2 = W
        c1 = shared_split(C * C)[1]
        hi, lo, lo2 = (x[c1:] for x in first)
        assert not first[2][:c1].any()
        assert torch.equal(lo2, tf32(W[c1:] - hi - lo))
        assert torch.equal(hi.double() + lo.double() + lo2.double(),
                           W[c1:].double())
    assert_split_of(second, ops.B.T if kernel == "stacked"
                    else torch.cat([ops.D, ops.B]).T)
    # csrc/enhance2d.cu reads z = [f; bc], C^2 + Kb rows, as the k side of
    # the first product and [8][Kb] trace points
    assert first[0].shape[0] == C * C + 4 * M - 4 == pts.shape[1] + C * C
    assert pts.shape[0] == 8


def plain_2d_z(kernel, ops, z):
    """The plain versions' float32 arithmetic (``kernels2d._stacked_plain``,
    ``_shared_plain``) from z = [f; bc]: (w, slack, bcv)."""
    M2, C2 = ops.Wf.shape
    if kernel == "stacked":
        out = K2._stacked_operator(ops.Wf, ops.Wbc, ops.Pres, ops.Qres,
                                   True) @ z
        w = out[:M2]
        return (w.T, out[M2:].abs().amax(0),
                (z[C2:] - ops.B @ w).abs().amax(0))
    w = ops.Wf @ z[:C2] + ops.Wbc @ z[C2:]
    return (w.T, (z[:C2] - ops.D @ w).abs().amax(0),
            (z[C2:] - ops.B @ w).abs().amax(0))


def spread_2d(n, kernel, chunk=1 << 17):
    """The 2D kernel's outputs, emulated at n x n quads, M = C = 6, on
    chip_smoke's poisson_2d_inhomogeneous nodal values, against the plain
    float32 version, as the kernel computes them (and, for the shared
    kernel, with w in 3xTF32): w's largest difference (the w tolerance),
    the slack's and bcv's largest difference relative to the plain
    version's largest value (SLACK_REL, BCV_REL) and their means over the
    plain version's (MEAN_RATIO)."""
    p = get_problem_2d("poisson_2d_inhomogeneous")
    cfg = Solver2DConfig(nx=n, ny=n, M=6, n_colloc=6, dtype="float32")
    ops, (t_int, bpts) = H2.prepare_shared_2d(p, cfg)
    fem = CS.nodal_grid_2d(p, "cpu", n)
    f, gedge, pts, _ = K2._shared_inputs(fem, p.f, p.g, (-1.0, 2.0 / n) * 2,
                                         n, n, t_int, bpts, p.f_shifted)
    z = torch.cat([f, K2._trace_bc(fem, gedge, pts, n, n)])
    del f
    parts = operators_2d(kernel, ops, pts)
    want = [plain_2d_z(kernel, ops, z[:, lo:lo + chunk])
            for lo in range(0, n * n, chunk)]
    res = {}
    for terms in (3, None) if kernel == "shared" else (None,):
        got = [emulate_2d_z(kernel, ops, z[:, lo:lo + chunk], terms, parts)
               for lo in range(0, n * n, chunk)]
        rec = {"w_err": max(float((g[0] - w_[0]).abs().max())
                            for g, w_ in zip(got, want))}
        for i, what in ((1, "slack"), (2, "bcv")):
            a = torch.cat([g[i] for g in got])
            b = torch.cat([w_[i] for w_ in want])
            rec[f"{what}_rel"] = float((a - b).abs().max()) / float(b.max())
            rec[f"{what}_mean_ratio"] = float(a.mean()) / float(b.mean())
        res["w 3xTF32" if terms else "as the kernel"] = rec
    return res


def slack_spread(n, M=6, chunk=1 << 17):
    """The elastic slack of the emulated kernel against the plain float32
    version at n x n quads (chip_smoke's nodal values and problem): the
    largest difference over the quads, relative to the plain version's
    largest slack, for w in 3xTF32, in 4xTF32 and rounded from float64
    (what SLACK_REL bounds)."""
    p = EL.get_elastic_problem("sin_elastic_2d")
    cfg = EL.ElasticConfig2D(nx=n, ny=n, M=M, n_colloc=M, dtype="float32")
    ops, (t_int, bpts) = EL.prepare_shared_elastic(p, cfg)
    fem = CS.nodal_grid_elastic(p, "cpu", n)
    f, gedge, pts = KE._inputs(fem, (p.f1, p.f2), (p.g1, p.g2),
                               (-1.0, 2.0 / n) * 2, n, n, t_int, bpts)
    bc = torch.cat([K2._trace_bc(fem[c], gedge[c], pts, n, n)
                    for c in range(2)])
    (OT, _), _, (DT, _), _, _, _ = elastic_operators(ops, pts)
    O = torch.cat([ops.Wf, ops.Wbc], dim=1)
    FR, FRP = f.shape[0], K2._pad8(f.shape[0])
    size, diff = 0.0, {"3xTF32": 0.0, "4xTF32": 0.0, "float64": 0.0}
    for lo in range(0, n * n, chunk):
        fc, bcc = f[:, lo:lo + chunk], bc[:, lo:lo + chunk]
        zc = torch.cat([fc, bcc])
        plain = (fc - ops.D @ (O @ zc)).abs().amax(0)
        size = max(size, float(plain.max()))
        z = torch.zeros(fc.shape[1], OT[0].shape[0])
        z[:, :FR] = fc.T
        z[:, FRP:] = bcc.T
        for key in diff:
            if key == "float64":
                w = (O.double() @ zc.double()).float().T
            else:
                w = split_mm(z, OT, int(key[0]))
            got = (fc.T - split_mm(w, DT, 3)).abs().amax(1)
            diff[key] = max(diff[key], float((got - plain).abs().max()))
    return {key: d / size for key, d in diff.items()}


def slack_spread_3d(n, chunk=1 << 17):
    """The same for the 3D slack (the residual rows of the 3xTF32 product)
    at n^3 hexes on chip_smoke's poisson_3d_inhomogeneous nodal values;
    and the largest difference of w."""
    p = get_problem_3d("poisson_3d_inhomogeneous")
    cfg = Solver3DConfig(nx=n, ny=n, nz=n, M=4, n_colloc=4, dtype="float32")
    ops, (t_int, spts) = H3.prepare_shared_3d(p, cfg)
    fem = CS.nodal_grid_3d(p, "cpu", n)
    f, gface, pts = K3._inputs(fem, ops, p.f, p.g, (-1.0, 2.0 / n) * 3, n,
                               n, n, t_int, spts, p.f_shifted)
    bc = K3._trace_bc(fem, gface, pts, n, n, n)
    OF = K3._pack(ops.Wf, ops.Wbc, ops.Pres, ops.Qres, ops.B, pts)[0]
    M3, C3 = ops.Wf.shape
    OT = unfrag(OF, C3 + bc.shape[0], M3 + C3, interleave=True)[0]
    O = K2._stacked_operator(ops.Wf, ops.Wbc, ops.Pres, ops.Qres, True)
    size = diff = w_err = 0.0
    for lo in range(0, n ** 3, chunk):
        zc = torch.cat([f[:, lo:lo + chunk], bc[:, lo:lo + chunk]])
        plain, got = O @ zc, split_mm(zc.T, OT, 3).T
        w_err = max(w_err, float((got[:M3] - plain[:M3]).abs().max()))
        plain, got = plain[M3:].abs().amax(0), got[M3:].abs().amax(0)
        size = max(size, float(plain.max()))
        diff = max(diff, float((got - plain).abs().max()))
    return diff / size, w_err


if __name__ == "__main__":
    # python tests/test_torch_tf32_split.py [n [n3]]: why the elastic w
    # takes four TF32 products (SLACK_REL["elastic2d_kernel"] = 0.025) and
    # where the 3D slack sits (SLACK_REL["stacked3d_kernel"] = 0.003), with
    # every sum rounded to nearest (the kernels add their k-steps so).
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    n3 = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    torch.set_num_threads(os.cpu_count() or 1)
    for key, rel in slack_spread(n).items():
        print(f"sin_elastic_2d {n}x{n}, M=6, w {key}: slack differs from "
              f"the plain version's by {rel:.4f} of its largest value")
    rel, w_err = slack_spread_3d(n3)
    print(f"poisson_3d_inhomogeneous {n3}^3, M=4, 3xTF32: slack differs "
          f"from the plain version's by {rel:.2e} of its largest value, w "
          f"by {w_err:.2e}")
    for kernel in sorted(KERNELS_2D):
        for key, rec in spread_2d(n, kernel).items():
            print(f"poisson_2d_inhomogeneous {n}x{n}, M=6, {kernel}, w "
                  f"{key}: " + ", ".join(f"{k} {v:.4g}"
                                         for k, v in rec.items()))
