"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so on a machine with a card it runs without the repo's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances are those of ``tests/test_pallas.py`` (see
``tests/test_torch_kernels.py``).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from hybrid_fem_lssvr_tpu_torch import (ElasticConfig2D, ElasticSolver2D,
                                        HybridSolver, HybridSolver2D,
                                        HybridSolver2DGraded, HybridSolver3D,
                                        Solver2DConfig, Solver3DConfig,
                                        SolverConfig, get_problem_2d,
                                        get_problem_3d, problems)
from hybrid_fem_lssvr_tpu_torch.models import elastic as EL
from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d_graded as HG
from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
from hybrid_fem_lssvr_tpu_torch.ops import assembly3d as A3
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_elastic as KE
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG
from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3

W_TOL, SLACK_TOL, BCV_TOL = 2e-6, 2e-5, 2e-6
VC_TOL, GRADED_TOL = 3e-5, 5e-5

pytestmark = pytest.mark.cuda

# The (M, C) pairs the CUDA source compiles (its ENH_SHAPES line).
_CU = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                   "enhance1d.cu")
with open(_CU) as _fh:
    SHAPES = [(int(m), int(c)) for m, c in re.findall(
        r"X\((\d+), (\d+)\)",
        re.search(r"#define ENH_SHAPES\(X\)(.*)", _fh.read()).group(1))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(E, M, C, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, E + 1)
    fem = np.sin(np.pi * x) + 1e-3 * rng.normal(size=E + 1)
    fem[0] = fem[-1] = 0.0
    fem = torch.tensor(fem, dtype=torch.float32, device=dev)
    cfg = SolverConfig(num_nodes=E + 1, M=M, n_colloc=C, dtype="float32")
    ops = H.prepare_shared_host(problems.poisson_1d(), cfg).to(dev)
    h = 2.0 / E
    host = K.VarCoeffOperators.host(M, C, h).to(dev)
    widths = rng.uniform(0.5, 2.0, E)
    xs = np.concatenate([[0.0], np.cumsum(widths)])
    graded = torch.tensor(-1.0 + 2.0 * xs / xs[-1], dtype=torch.float32,
                          device=dev)
    return fem, ops, host, h, graded


def assert_close(got, want, tols):
    for g, w, tol in zip(got, want, tols):
        if tol is None:
            continue
        torch.testing.assert_close(g, w, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("E", [1, 1000, 4099])
@pytest.mark.parametrize("M,C", SHAPES)
def test_kernels_match_plain(dev, M, C, E):
    fem, ops, host, h, graded = inputs(E, M, C, dev)
    pois = problems.poisson_1d()
    vc = problems.variable_coeff_elliptic()
    K.reset_launch_counts()
    cases = [
        (K.fused_enhance_separable, K.fused_enhance_separable_ref,
         (fem, ops, pois.f_elem_factors, -1.0, h), dict(with_fallback=True),
         (W_TOL, SLACK_TOL, BCV_TOL, 0.0)),
        (K.fused_enhance_separable, K.fused_enhance_separable_ref,
         (fem, ops, pois.f_elem_factors, -1.0, h),
         dict(with_diagnostics=False), (W_TOL,)),
        (K.fused_enhance_shared, K.fused_enhance_shared_ref,
         (fem, ops, pois.f, -1.0, h, C), dict(f_shifted_fn=pois.f_shifted),
         (W_TOL, SLACK_TOL, BCV_TOL)),
        (K.fused_enhance_shared, K.fused_enhance_shared_ref,
         (fem, ops, pois.f, -1.0, h, C), dict(with_diagnostics=False),
         (W_TOL,)),
        (K.fused_enhance_varcoeff, K.fused_enhance_varcoeff_ref,
         (fem, vc, host, -1.0, h, C), dict(f_shifted_fn=vc.f_shifted),
         (VC_TOL, None, BCV_TOL, None)),
        (K.fused_enhance_varcoeff, K.fused_enhance_varcoeff_ref,
         (torch.sin(torch.pi * graded), vc, host, -1.0, h, C),
         dict(nodes=graded), (GRADED_TOL, None, BCV_TOL, None)),
    ]
    for wrapper, ref, args, kw, tols in cases:
        got, want = wrapper(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        assert got[0].shape == (E, M) and got[0].is_cuda
        assert_close(got, want, tols)
        if wrapper is K.fused_enhance_varcoeff and got[3] is not None:
            torch.testing.assert_close(got[3], want[3], rtol=1e-3, atol=0)
    assert K.launch_counts() == {"fused_enhance_separable": 2,
                                 "fused_enhance_shared": 2,
                                 "fused_enhance_varcoeff": 2}


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("M,C", SHAPES)
def test_varcoeff_kernel_over_several_rounds(dev, M, C, diag):
    """The persistent varcoeff_kernel with more elements than the card
    holds threads at once (several rounds, a ragged last one), uniform and
    graded, with and without diagnostics."""
    E = 300001
    fem, _, host, h, graded = inputs(E, M, C, dev)
    vc = problems.variable_coeff_elliptic()
    for args, kw, w_tol in (
            ((fem, vc, host, -1.0, h, C), dict(f_shifted_fn=vc.f_shifted),
             VC_TOL),
            ((torch.sin(torch.pi * graded), vc, host, -1.0, h, C),
             dict(nodes=graded), GRADED_TOL)):
        kw = dict(kw, with_diagnostics=diag)
        got = K.fused_enhance_varcoeff(*args, **kw)
        want = K.fused_enhance_varcoeff_ref(*args, **kw)
        torch.cuda.synchronize()
        assert got[0].shape == (E, M)
        if diag:
            assert_close(got, want, (w_tol, None, BCV_TOL, None))
            torch.testing.assert_close(got[3], want[3], rtol=1e-3, atol=0)
            ratio = float(got[1].max()) / float(want[1].max())
            assert 0.2 < ratio < 5.0, ratio
        else:
            assert got[1:] == (None, None, None)
            assert_close(got, want, (w_tol,))


def family_inputs(P, Ef, M, C, dev, seed=0, seam=False):
    """P families of Ef elements: nodal values [P, Ef+1] (with ``seam``,
    offset by +-1e3 per family), graded nodes [P, Ef+1], the advection-
    diffusion family's batched problem and the statics."""
    from hybrid_fem_lssvr_tpu_torch.models import batched as B

    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, Ef + 1)
    fem = np.sin(np.pi * x)[None] + 1e-3 * rng.normal(size=(P, Ef + 1))
    if seam:
        fem += 1e3 * np.arange(P)[:, None] * (-1.0) ** np.arange(P)[:, None]
    widths = rng.uniform(0.5, 2.0, (P, Ef))
    xs = np.concatenate([np.zeros((P, 1)), np.cumsum(widths, 1)], 1)
    graded = torch.tensor(-1.0 + 2.0 * xs / xs[:, -1:], dtype=torch.float32,
                          device=dev)
    thetas = torch.tensor(np.stack([rng.uniform(0.5, 2.0, P),
                                    rng.uniform(0.0, 3.0, P)], 1),
                          dtype=torch.float32, device=dev)
    prob = B.batched_problem(B.advdiff_family(), thetas)
    h = 2.0 / Ef
    host = K.VarCoeffOperators.host(M, C, h).to(dev)
    return (torch.tensor(fem, dtype=torch.float32, device=dev), graded,
            prob, host, h)


@pytest.mark.parametrize("P,Ef", [(1, 4099), (3, 1000), (3, 777),
                                  (128, 8191), (128, 97)])
@pytest.mark.parametrize("seam", [False, True])
def test_varcoeff_kernel_family_layout(dev, P, Ef, seam):
    """The family launch (fem [P, Ef+1], E = P Ef, one launch) against the
    plain version in the same layout, graded and uniform, at P = 1, 3 and
    128 and ragged Ef; with ``seam`` the families' nodal values jump by
    1e3, so an element that read across a family boundary would be off by
    that much."""
    M, C = 8, 12
    fem, graded, prob, host, h = family_inputs(P, Ef, M, C, dev, seam=seam)
    scale = float(fem.abs().max())
    K.reset_launch_counts()
    for nodes, w_tol in ((graded, GRADED_TOL), (None, VC_TOL)):
        args = (fem, prob, host, -1.0, h, C)
        got = K.fused_enhance_varcoeff(*args, nodes=nodes)
        want = K.fused_enhance_varcoeff_ref(*args, nodes=nodes)
        torch.cuda.synchronize()
        assert got[0].shape == (P * Ef, M)
        assert_close(got, want, (w_tol * max(1.0, scale), None,
                                 BCV_TOL * max(1.0, scale), None))
        torch.testing.assert_close(got[3], want[3], rtol=1e-3, atol=0)
    assert K.launch_counts()["fused_enhance_varcoeff"] == 2


def test_varcoeff_kernel_family_equals_single_launches(dev):
    """Member p of a family launch equals the P = 1 launch on that
    member's nodal values, nodes and coefficients, bit for bit: the same
    element arithmetic, only the nodal index differs."""
    from hybrid_fem_lssvr_tpu_torch.models import batched as B

    P, Ef, M, C = 4, 1000, 8, 12
    fem, graded, prob, host, h = family_inputs(P, Ef, M, C, dev, seam=True)
    got = K.fused_enhance_varcoeff(fem, prob, host, -1.0, h, C,
                                   nodes=graded)
    coef, he = K._sample_varcoeff(fem, prob, -1.0, h, C, None, graded)
    for p in range(P):
        rows = slice(p * Ef, (p + 1) * Ef)
        one = K._varcoeff_cuda(fem[p].contiguous(),
                               coef[:, :, rows].contiguous(),
                               he[rows].contiguous(), host, h, True)
        for g, w in zip(got, one):
            assert torch.equal(g[rows], w)


def test_varcoeff_kernels_nan_coefficient(dev):
    """A NaN coefficient makes the diagnostics of its elements NaN, in the
    1D kernel and both 2D methods as in their plain versions, and leaves
    every other element as the plain version has it."""
    E, M, C = 1000, 8, 12
    fem, _, host, h, _ = inputs(E, M, C, dev)
    base = problems.variable_coeff_elliptic()
    nan = float("nan")
    vc = dataclasses.replace(base, a=lambda x: torch.where(
        (x > 0.1) & (x < 0.12), nan, base.a(x)))
    args = (fem, vc, host, -1.0, h, C)
    got = K.fused_enhance_varcoeff(*args)
    want = K.fused_enhance_varcoeff_ref(*args)
    torch.cuda.synchronize()
    bad = torch.isnan(want[1])
    assert 0 < int(bad.sum()) < E
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    torch.testing.assert_close(got[0][~bad], want[0][~bad], rtol=0,
                               atol=VC_TOL)
    nx = ny = 16
    p, ops, fem2, geom, t_int, bpts = inputs_2d(
        "variable_coeff_elliptic_2d", nx, ny, 6, 6, dev)

    def a_nan(x, y):
        box = (x > 0.1) & (x < 0.2) & (y > 0.1) & (y < 0.2)
        return torch.where(box, nan, p.a_var(x, y))

    args = (fem2, ops, a_nan, p.grad_a, p.f, p.g, geom, nx, ny, t_int, bpts)
    for method in K2.METHODS:
        kw = dict(s2=2.0 * nx * nx, method=method)
        got = K2.fused_enhance_varcoeff_2d(*args, **kw)
        want = K2.fused_enhance_varcoeff_2d_ref(*args, **kw)
        torch.cuda.synchronize()
        bad = torch.isnan(want[1])
        assert 0 < int(bad.sum()) < nx * ny
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
        torch.testing.assert_close(got[0][~bad], want[0][~bad], rtol=0,
                                   atol=3e-5)


def test_varcoeff_launch_shapes(dev):
    """The persistent kernels' launch shapes as their sources report them:
    shared memory a block, resident blocks, threads a block."""
    import ctypes

    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    for source, fn, shapes, threads in (
            ("enhance1d", "enhance1d_varcoeff_launch_shape", SHAPES, 128),
            ("enhance2d_varcoeff", "enhance2d_varcoeff_sne_launch_shape",
             K2.SHAPES, 256),
            ("enhance2d_varcoeff", "enhance2d_varcoeff_launch_shape",
             K2.SHAPES, 128)):
        query = getattr(cuda_lib.load(source), fn)
        for M, C in shapes:
            out = [ctypes.c_int(0) for _ in range(3)]
            assert query(dev.index or 0, M, C,
                         *(ctypes.byref(v) for v in out)) == 0
            smem, blocks, nthreads = (v.value for v in out)
            assert smem > 0 and blocks > 0 and nthreads == threads
        out = [ctypes.c_int(0) for _ in range(3)]
        assert query(dev.index or 0, 7, 3,
                     *(ctypes.byref(v) for v in out)) != 0


def test_nan_gate_and_fallback(dev):
    E = 1000
    fem, ops, _, h, _ = inputs(E, 8, 12, dev)
    fem[300] = float("nan")
    fem[700] = float("inf")
    pois = problems.poisson_1d()
    args = (fem, ops, pois.f_elem_factors, -1.0, h)
    got = K.fused_enhance_separable(*args, with_fallback=True)
    want = K.fused_enhance_separable_ref(*args, with_fallback=True)
    assert_close(got, want, (W_TOL, SLACK_TOL, BCV_TOL, 0.0))
    bad = torch.nonzero(got[3] == 0).flatten().tolist()
    assert bad == [299, 300, 699, 700]


def test_rejects_what_it_cannot_run(dev):
    fem, ops, host, h, _ = inputs(64, 8, 12, dev)
    pois = problems.poisson_1d()
    with pytest.raises(ValueError, match="float32"):
        K.fused_enhance_separable(fem.double(), ops.to(dtype=torch.float64),
                                  pois.f_elem_factors, -1.0, h)
    f5 = H.prepare_shared_host(pois, SolverConfig(num_nodes=65, M=5,
                                                  dtype="float32")).to(dev)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        K.fused_enhance_shared(fem, f5, pois.f, -1.0, h, 12)
    # 'auto' routes a CUDA float32 solve to the kernels whatever (M, C):
    # an uncompiled pair raises rather than running torch on the card.
    with pytest.raises(ValueError, match="no CUDA kernel"):
        HybridSolver(pois, SolverConfig(num_nodes=65, M=5, dtype="float32"),
                     device=dev).solve()


@pytest.mark.parametrize("name,nodes", [
    ("poisson_1d", None), ("variable_coeff_elliptic", None),
    ("poisson_neumann", None), ("robin_1d", None),
    ("variable_coeff_elliptic", "graded"),
])
def test_solver_on_gpu_matches_cpu(dev, name, nodes):
    """The whole solver on the GPU (kernels) against the CPU (torch
    route), float32 enhancement with a float64 coarse solve."""
    cfg = SolverConfig(num_nodes=257, dtype="float32", fem_dtype="float64")
    x = None
    if nodes == "graded":
        w = np.random.default_rng(2).uniform(0.5, 2.0, 256)
        xs = np.concatenate([[0.0], np.cumsum(w)])
        x = torch.tensor(-1.0 + 2.0 * xs / xs[-1], dtype=torch.float32)
    K.reset_launch_counts()
    gpu = HybridSolver(problems.get(name), cfg, nodes=x, device=dev)
    cpu = HybridSolver(problems.get(name), cfg, nodes=x, device="cpu")
    gpu.solve()
    cpu.solve()
    assert sum(K.launch_counts().values()) == 1
    torch.testing.assert_close(gpu.solution.coeffs.cpu(),
                               cpu.solution.coeffs, rtol=0, atol=VC_TOL)
    assert bool(gpu.solution.solve_ok.all())
    pts = np.linspace(-1, 1, 201)
    assert abs(float(gpu.errors(pts)[0]) - float(cpu.errors(pts)[0])) < 1e-5


def test_generic_rhs_and_no_diagnostics_routes(dev):
    cfg = SolverConfig(num_nodes=257, dtype="float32", fem_dtype="float64")
    generic = dataclasses.replace(problems.poisson_1d(), f_elem_factors=None,
                                  f_colloc_factors=None)
    for problem, c in ((generic, cfg),
                       (problems.poisson_1d(),
                        dataclasses.replace(cfg, diagnostics=False))):
        K.reset_launch_counts()
        gpu = HybridSolver(problem, c, device=dev)
        cpu = HybridSolver(problem, c, device="cpu")
        gpu.solve()
        cpu.solve()
        assert sum(K.launch_counts().values()) == 1
        torch.testing.assert_close(gpu.solution.coeffs.cpu(),
                                   cpu.solution.coeffs, rtol=0, atol=W_TOL)


def test_default_device_is_the_gpu(dev):
    """No ``device`` argument: every 1D entry point lands on the card."""
    problem = problems.poisson_1d()
    cfg = SolverConfig(num_nodes=65, dtype="float32", fem_dtype="float64")
    s = HybridSolver(problem, cfg)
    assert s.device.type == "cuda"
    assert s.solve().coeffs.is_cuda
    assert H.uniform_nodes(problem, 65, torch.float32).is_cuda
    cpu_nodes = torch.linspace(-1.0, 1.0, 65)
    assert H.hybrid_solve_general(problem, cfg, cpu_nodes).coeffs.is_cuda
    assert H.sweep_solve(problem, [cfg])[0].coeffs.is_cuda


# ------------------------------------------------------------ 2D kernels
# Tolerances of tests/test_pallas.py for the 2D kernels (see
# tests/test_torch_kernels2d.py): stacked w 2e-5, shared w 1e-5,
# per-element w 3e-5, bcv 1e-5; the slack amplifies float32 rounding by
# ||D|| ~ (2/h)^2, so it is compared in magnitude.

def inputs_2d(name, nx, ny, M, C, dev, seed=0):
    p = get_problem_2d(name)
    cfg = Solver2DConfig(nx=nx, ny=ny, M=M, n_colloc=C, dtype="float32")
    ops, (t_int, bpts) = H2.prepare_shared_2d(p, cfg)
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(-1, 1, nx + 1), np.linspace(-1, 1, ny + 1))
    u = p.exact(torch.tensor(X), torch.tensor(Y)).numpy().copy()
    u[1:-1, 1:-1] += 1e-3 * rng.normal(size=(ny - 1, nx - 1))
    fem = torch.tensor(u, dtype=torch.float32, device=dev)
    geom = (-1.0, 2.0 / nx, -1.0, 2.0 / ny)
    return p, ops.to(dev), fem, geom, t_int, bpts


def assert_close_2d(got, want, w_tol, lo=0.05, hi=20.0):
    assert len(got) == len(want) == 3
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=w_tol,
                               equal_nan=True)
    if want[1] is None:
        assert got[1] is None and got[2] is None
        return
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5,
                               equal_nan=True)
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    ratio = float(got[1][fin].max()) / max(float(want[1][fin].max()), 1e-30)
    assert lo < ratio < hi, ratio


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("nx,ny", [(1, 1), (5, 3), (64, 48), (131, 67)])
@pytest.mark.parametrize("M,C", K2.SHAPES)
def test_shared_2d_kernels_match_plain(dev, M, C, nx, ny, diag):
    p, ops, fem, geom, t_int, bpts = inputs_2d("poisson_2d_inhomogeneous",
                                               nx, ny, M, C, dev)
    bare = dataclasses.replace(ops, Pres=None, Qres=None)
    K2.reset_launch_counts()
    for wrapper, ref, o, tol in (
            (K2.fused_enhance_stacked_2d, K2.fused_enhance_stacked_2d_ref,
             ops, 2e-5),
            (K2.fused_enhance_shared_2d, K2.fused_enhance_shared_2d_ref,
             bare, 1e-5)):
        for fs in (None, p.f_shifted):
            args = (fem, o, p.f, p.g, geom, nx, ny, t_int, bpts)
            kw = dict(with_diagnostics=diag, f_shifted_fn=fs)
            got, want = wrapper(*args, **kw), ref(*args, **kw)
            torch.cuda.synchronize()
            assert got[0].shape == (nx * ny, M * M) and got[0].is_cuda
            assert_close_2d(got, want, tol)
    assert K2.launch_counts() == {"fused_enhance_stacked_2d": 2,
                                  "fused_enhance_shared_2d": 2,
                                  "fused_enhance_varcoeff_2d": 0}


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("method", K2.METHODS)
@pytest.mark.parametrize("nx,ny", [(1, 1), (5, 3), (64, 48), (131, 67),
                                   (257, 131), (300, 257)])
@pytest.mark.parametrize("M,C", K2.SHAPES)
def test_varcoeff_2d_kernel_matches_plain(dev, M, C, nx, ny, method, diag):
    p, ops, fem, geom, t_int, bpts = inputs_2d("variable_coeff_elliptic_2d",
                                               nx, ny, M, C, dev)
    s2 = (2.0 / geom[1]) ** 2 + (2.0 / geom[3]) ** 2
    args = (fem, ops, p.a_var, p.grad_a, p.f, p.g, geom, nx, ny, t_int, bpts)
    kw = dict(s2=s2, with_diagnostics=diag, method=method,
              f_shifted_fn=p.f_shifted)
    K2.reset_launch_counts()
    got = K2.fused_enhance_varcoeff_2d(*args, **kw)
    want = K2.fused_enhance_varcoeff_2d_ref(*args, **kw)
    torch.cuda.synchronize()
    assert K2.launch_counts()["fused_enhance_varcoeff_2d"] == 1
    assert got[0].shape == (nx * ny, M * M) and got[0].is_cuda
    assert_close_2d(got, want, 3e-5, lo=0.2, hi=5.0)


def test_varcoeff_2d_kernel_with_constant_terms(dev):
    """n_terms = 4: reaction and advection beside the variable diffusion."""
    base = get_problem_2d("variable_coeff_elliptic_2d")
    p = dataclasses.replace(base, c=2.0, b=(1.0, -0.5))
    nx = ny = 32
    cfg = Solver2DConfig(nx=nx, ny=ny, M=6, n_colloc=6, dtype="float32")
    ops, (t_int, bpts) = H2.prepare_shared_2d(p, cfg)
    assert ops.n_terms == 4
    _, _, fem, geom, _, _ = inputs_2d("variable_coeff_elliptic_2d", nx, ny,
                                      6, 6, dev)
    args = (fem, ops.to(dev), p.a_var, p.grad_a, p.f, p.g, geom, nx, ny,
            t_int, bpts)
    for method in K2.METHODS:
        kw = dict(s2=2.0 * nx * nx, method=method)
        assert_close_2d(K2.fused_enhance_varcoeff_2d(*args, **kw),
                        K2.fused_enhance_varcoeff_2d_ref(*args, **kw), 3e-5,
                        lo=0.2, hi=5.0)


def test_2d_kernels_nan_nodal_value(dev):
    """A NaN nodal value reaches the diagnostics of its four quads and of
    no other, in every kernel as in its plain version."""
    nx = ny = 16
    bad_quads = [6 * 16 + 8, 6 * 16 + 9, 7 * 16 + 8, 7 * 16 + 9]
    p, ops, fem, geom, t_int, bpts = inputs_2d("poisson_2d", nx, ny, 6, 6,
                                               dev)
    fem[7, 9] = float("nan")
    bare = dataclasses.replace(ops, Pres=None, Qres=None)
    args = (p.f, p.g, geom, nx, ny, t_int, bpts)
    runs = [(K2.fused_enhance_stacked_2d(fem, ops, *args),
             K2.fused_enhance_stacked_2d_ref(fem, ops, *args)),
            (K2.fused_enhance_shared_2d(fem, bare, *args),
             K2.fused_enhance_shared_2d_ref(fem, bare, *args))]
    vp, vops, _, _, _, _ = inputs_2d("variable_coeff_elliptic_2d", nx, ny, 6,
                                     6, dev)
    vargs = (fem, vops, vp.a_var, vp.grad_a, vp.f, vp.g, geom, nx, ny, t_int,
             bpts)
    for method in K2.METHODS:
        kw = dict(s2=2.0 * nx * nx, method=method)
        runs.append((K2.fused_enhance_varcoeff_2d(*vargs, **kw),
                     K2.fused_enhance_varcoeff_2d_ref(*vargs, **kw)))
    corners = (fem[:-1, :-1], fem[:-1, 1:], fem[1:, :-1], fem[1:, 1:])
    for got, want in runs:
        for out in (got, want):
            ok = H2._kernel_solve_ok(out[1], out[2], corners)
            assert torch.nonzero(~ok).flatten().tolist() == bad_quads
        good = torch.ones(nx * ny, dtype=torch.bool, device=dev)
        good[bad_quads] = False
        torch.testing.assert_close(got[0][good], want[0][good], rtol=0,
                                   atol=3e-5)


def test_2d_statics_follow_the_bundle(dev):
    """The packed operators are kept between calls: another bundle, or an
    in-place edit of the same one, must reach the kernel."""
    nx, ny, M = 9, 7, 5
    p, ops, fem, geom, t_int, bpts = inputs_2d("poisson_2d_inhomogeneous",
                                               nx, ny, M, M, dev)
    tail = (p.f, p.g, geom, nx, ny, t_int, bpts)
    first = K2.fused_enhance_stacked_2d(fem, ops, *tail)
    again = K2.fused_enhance_stacked_2d(fem, ops, *tail)
    assert torch.equal(first[0], again[0])
    skewed = dataclasses.replace(ops, B=1.5 * ops.B)
    got = K2.fused_enhance_stacked_2d(fem, skewed, *tail)
    want = K2.fused_enhance_stacked_2d_ref(fem, skewed, *tail)
    assert float(want[2].min()) > 1e-3 > float(first[2].max())
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    assert torch.equal(got[0], first[0])
    K2.fused_enhance_stacked_2d(fem, ops, *tail)  # packs ``ops`` again
    ops.Wbc.mul_(2.0)
    got = K2.fused_enhance_stacked_2d(fem, ops, *tail)
    want = K2.fused_enhance_stacked_2d_ref(fem, ops, *tail)
    assert float((got[0] - first[0]).abs().max()) > 1e-2
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=4e-5)


def test_2d_kernels_reject_what_they_cannot_run(dev):
    p, ops, fem, geom, t_int, bpts = inputs_2d("poisson_2d", 8, 8, 6, 6, dev)
    args = (p.f, p.g, geom, 8, 8, t_int, bpts)
    with pytest.raises(ValueError, match="float32"):
        K2.fused_enhance_stacked_2d(fem.double(),
                                    ops.to(dtype=torch.float64), *args)
    with pytest.raises(ValueError, match="contiguous"):
        K2.fused_enhance_stacked_2d(fem.T.contiguous().T, ops, *args)
    p7, ops7, fem7, geom7, t7, b7 = inputs_2d("poisson_2d", 8, 8, 7, 7, dev)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        K2.fused_enhance_stacked_2d(fem7, ops7, p7.f, p7.g, geom7, 8, 8, t7,
                                    b7)
    # 'auto' on the card goes to the kernels whatever (M, C): an uncompiled
    # pair raises rather than running torch on the card.
    cfg = Solver2DConfig(nx=8, ny=8, M=7, n_colloc=7, dtype="float32",
                         fem_dtype="float64")
    with pytest.raises(ValueError, match="no CUDA kernel"):
        HybridSolver2D(p7, cfg, device=dev).solve()
    ok = HybridSolver2D(p7, dataclasses.replace(cfg, backend="torch"),
                        device=dev).solve()
    assert bool(ok.solve_ok.all()) and K2.launch_counts() is not None


@pytest.mark.parametrize("name,kw,kernel", [
    ("poisson_2d", {}, "fused_enhance_stacked_2d"),
    ("poisson_2d", dict(formulation="dual"), "fused_enhance_stacked_2d"),
    ("poisson_2d", dict(diagnostics=False), "fused_enhance_stacked_2d"),
    ("poisson_2d_inhomogeneous", {}, "fused_enhance_stacked_2d"),
    ("helmholtz_2d", {}, "fused_enhance_stacked_2d"),
    ("advection_diffusion_2d", {}, "fused_enhance_stacked_2d"),
    ("variable_coeff_elliptic_2d", {}, "fused_enhance_varcoeff_2d"),
    ("variable_coeff_elliptic_2d", dict(varcoeff_method="qr"),
     "fused_enhance_varcoeff_2d"),
])
def test_2d_solver_on_gpu_matches_cpu(dev, name, kw, kernel):
    """The whole 2D solver on the GPU (kernels) against the CPU (torch
    route), float32 enhancement over a float64 coarse solve."""
    cfg = Solver2DConfig(nx=32, ny=24, dtype="float32", fem_dtype="float64",
                         **kw)
    K2.reset_launch_counts()
    gpu = HybridSolver2D(get_problem_2d(name), cfg, device=dev)
    cpu = HybridSolver2D(get_problem_2d(name), cfg, device="cpu")
    gpu.solve()
    cpu.solve()
    counts = K2.launch_counts()
    assert counts[kernel] == 1 and sum(counts.values()) == 1
    torch.testing.assert_close(gpu.solution.coeffs.cpu(),
                               cpu.solution.coeffs, rtol=0, atol=3e-5)
    assert bool(gpu.solution.solve_ok.all())
    assert abs(gpu.solution.cg_iters - cpu.solution.cg_iters) <= 1
    pts = np.random.default_rng(0).uniform(-1, 1, (2, 500))
    assert abs(float(gpu.errors(*pts)[0]) - float(cpu.errors(*pts)[0])) < 1e-5


def test_shared_2d_kernel_through_enhance_2d(dev):
    """A bundle without Pres goes to ``fused_enhance_shared_2d``."""
    p = get_problem_2d("poisson_2d")
    cfg = Solver2DConfig(nx=16, ny=16, dtype="float32", fem_dtype="float64")
    s = HybridSolver2D(p, cfg, device=dev)
    sol = s.solve()
    ops, pts = s._shared
    bare = dataclasses.replace(ops, Pres=None, Qres=None)
    K2.reset_launch_counts()
    coeffs, diags, _ = H2.enhance_2d(p, cfg, sol.xs, sol.ys, sol.fem_values,
                                     (bare, pts))
    assert K2.launch_counts()["fused_enhance_shared_2d"] == 1
    torch.testing.assert_close(coeffs, sol.coeffs, rtol=0, atol=2e-5)
    assert bool(diags.solve_ok.all())


def test_default_device_is_the_gpu_2d(dev):
    p = get_problem_2d("poisson_2d")
    cfg = Solver2DConfig(nx=8, ny=8, dtype="float32", fem_dtype="float64")
    s = HybridSolver2D(p, cfg)
    assert s.device.type == "cuda"
    assert s.solve().coeffs.is_cuda
    assert H2.hybrid_solve_2d(p, cfg, H2.prepare_shared_2d(p, cfg)
                              ).coeffs.is_cuda


# ------------------------------------------------------------ 3D kernel
# Tolerances of tests/test_pallas.py:274 (see tests/test_torch_kernels3d.py):
# w 2e-5, bcv 1e-5, slack in magnitude.

def inputs_3d(name, nx, ny, nz, dev, seed=0, M=4, C=4):
    p = get_problem_3d(name)
    cfg = Solver3DConfig(nx=nx, ny=ny, nz=nz, M=M, n_colloc=C,
                         dtype="float32")
    ops, (t_int, spts) = H3.prepare_shared_3d(p, cfg)
    rng = np.random.default_rng(seed)
    Z, Y, X = np.meshgrid(np.linspace(-1, 1, nz + 1),
                          np.linspace(-1, 1, ny + 1),
                          np.linspace(-1, 1, nx + 1), indexing="ij")
    u = p.exact(*(torch.tensor(v) for v in (X, Y, Z))).numpy().copy()
    u[1:-1, 1:-1, 1:-1] += 1e-3 * rng.normal(size=(nz - 1, ny - 1, nx - 1))
    fem = torch.tensor(u, dtype=torch.float32, device=dev)
    geom = (-1.0, 2.0 / nx, -1.0, 2.0 / ny, -1.0, 2.0 / nz)
    return p, ops.to(dev), fem, geom, t_int, spts


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("nx,ny,nz", [(1, 1, 1), (3, 5, 2), (5, 3, 7),
                                      (16, 12, 8), (33, 17, 9), (40, 33, 17),
                                      (41, 33, 17)])
@pytest.mark.parametrize("M,C", K3.SHAPES)
def test_stacked_3d_kernel_matches_plain(dev, M, C, nx, ny, nz, diag):
    p, ops, fem, geom, t_int, spts = inputs_3d("poisson_3d_inhomogeneous",
                                               nx, ny, nz, dev, M=M, C=C)
    K3.reset_launch_counts()
    for fs in (None, p.f_shifted):
        args = (fem, ops, p.f, p.g, geom, nx, ny, nz, t_int, spts)
        kw = dict(with_diagnostics=diag, f_shifted_fn=fs)
        got = K3.fused_enhance_stacked_3d(*args, **kw)
        want = K3.fused_enhance_stacked_3d_ref(*args, **kw)
        torch.cuda.synchronize()
        assert got[0].shape == (nx * ny * nz, M ** 3) and got[0].is_cuda
        assert_close_2d(got, want, 2e-5)
    assert K3.launch_counts() == {"fused_enhance_stacked_3d": 2}


def test_3d_kernel_nan_nodal_value(dev):
    """A NaN nodal value reaches the diagnostics of its eight hexes and of
    no other, in the kernel as in its plain version."""
    n = 6
    p, ops, fem, geom, t_int, spts = inputs_3d("poisson_3d", n, n, n, dev)
    fem[3, 2, 4] = float("nan")
    args = (fem, ops, p.f, p.g, geom, n, n, n, t_int, spts)
    bad = sorted(ez * n * n + ey * n + ex for ez in (2, 3) for ey in (1, 2)
                 for ex in (3, 4))
    got = K3.fused_enhance_stacked_3d(*args)
    want = K3.fused_enhance_stacked_3d_ref(*args)
    corners = A3._corners_3d(fem)
    for out in (got, want):
        ok = H3._kernel_solve_ok_3d(out[1], out[2], corners)
        assert torch.nonzero(~ok).flatten().tolist() == bad
    good = torch.ones(n ** 3, dtype=torch.bool, device=dev)
    good[bad] = False
    torch.testing.assert_close(got[0][good], want[0][good], rtol=0,
                               atol=2e-5)


def test_3d_kernel_rejects_what_it_cannot_run(dev):
    p, ops, fem, geom, t_int, spts = inputs_3d("poisson_3d", 4, 4, 4, dev)
    args = (p.f, p.g, geom, 4, 4, 4, t_int, spts)
    with pytest.raises(ValueError, match="float32"):
        K3.fused_enhance_stacked_3d(fem.double(),
                                    ops.to(dtype=torch.float64), *args)
    p5, ops5, fem5, geom5, t5, s5 = inputs_3d("poisson_3d", 4, 4, 4, dev,
                                              M=5, C=5)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        K3.fused_enhance_stacked_3d(fem5, ops5, p5.f, p5.g, geom5, 4, 4, 4,
                                    t5, s5)
    # 'auto' on the card goes to the kernel whatever (M, C): an uncompiled
    # pair raises rather than running torch on the card.
    cfg = Solver3DConfig(nx=4, ny=4, nz=4, M=5, n_colloc=5, dtype="float32",
                         fem_dtype="float64", precond="jacobi")
    with pytest.raises(ValueError, match="no CUDA kernel"):
        HybridSolver3D(p5, cfg, device=dev).solve()
    ok = HybridSolver3D(p5, dataclasses.replace(cfg, backend="torch"),
                        device=dev).solve()
    assert bool(ok.solve_ok.all())


@pytest.mark.parametrize("name,kw,launches", [
    ("poisson_3d", {}, 1),
    ("poisson_3d", dict(formulation="dual"), 1),
    ("poisson_3d", dict(diagnostics=False), 1),
    ("poisson_3d_inhomogeneous", {}, 1),
    ("helmholtz_3d", {}, 1),
    ("advection_diffusion_3d", {}, 1),
    ("poisson_3d_neumann", {}, 1),
    ("variable_coeff_elliptic_3d", {}, 0),
])
def test_3d_solver_on_gpu_matches_cpu(dev, name, kw, launches):
    """The whole 3D solver on the GPU (the kernel where it applies) against
    the CPU (torch route), float32 enhancement over a float64 coarse
    solve."""
    cfg = Solver3DConfig(nx=16, ny=8, nz=8, dtype="float32",
                         fem_dtype="float64", **kw)
    K3.reset_launch_counts()
    gpu = HybridSolver3D(get_problem_3d(name), cfg, device=dev)
    cpu = HybridSolver3D(get_problem_3d(name), cfg, device="cpu")
    gpu.solve()
    cpu.solve()
    assert K3.launch_counts()["fused_enhance_stacked_3d"] == launches
    got, want = gpu.solution.coeffs.cpu(), cpu.solution.coeffs
    if name == "poisson_3d_neumann":
        # The kernel puts g on every domain face, as the Pallas kernel
        # does; the torch route keeps the FEM trace on the natural x-hi
        # face, as JAX's XLA route does (ROADMAP section 3).
        got, want = got[:, :, :-1], want[:, :, :-1]
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
    assert bool(gpu.solution.solve_ok.all())
    assert abs(gpu.solution.cg_iters - cpu.solution.cg_iters) <= 1
    pts = np.random.default_rng(0).uniform(-1, 1, (3, 500))
    assert abs(float(gpu.errors(*pts)[0]) - float(cpu.errors(*pts)[0])) < (
        1e-2 if name == "poisson_3d_neumann" else 1e-5)


def test_default_device_is_the_gpu_3d(dev):
    p = get_problem_3d("poisson_3d")
    cfg = Solver3DConfig(nx=4, ny=4, nz=4, dtype="float32",
                         fem_dtype="float64")
    s = HybridSolver3D(p, cfg)
    assert s.device.type == "cuda"
    assert s.solve().coeffs.is_cuda
    assert H3.hybrid_solve_3d(p, cfg, H3.prepare_shared_3d(p, cfg)
                              ).coeffs.is_cuda


# ------------------------------------------------------ graded 2D kernel
# Tolerances of tests/test_pallas.py:383 (see tests/test_torch_graded2d.py):
# w 3e-5, bcv 1e-5, slack ratio in (0.2, 5).

def power_nodes(n, power=1.5):
    """Power-law stretched nodes on [-1, 1], clustered at the centre."""
    s = np.linspace(-1.0, 1.0, n + 1)
    return np.sign(s) * np.abs(s) ** power


def inputs_graded(name, nx, ny, M, C, dev, seed=0):
    p = get_problem_2d(name)
    cfg = Solver2DConfig(M=M, n_colloc=C, dtype="float32")
    gops, (t_int, bpts) = HG.prepare_shared_2d_graded(p, cfg)
    xs = torch.tensor(power_nodes(nx), dtype=torch.float32, device=dev)
    ys = torch.tensor(power_nodes(ny), dtype=torch.float32, device=dev)
    Y, X = torch.meshgrid(ys.double().cpu(), xs.double().cpu(),
                          indexing="ij")
    u = p.exact(X, Y).numpy().copy()
    u[1:-1, 1:-1] += 1e-3 * np.random.default_rng(seed).normal(
        size=(ny - 1, nx - 1))
    fem = torch.tensor(u, dtype=torch.float32, device=dev)
    return p, gops.to(dev), fem, xs, ys, t_int, bpts


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("nx,ny", [(1, 1), (5, 3), (64, 48), (131, 67),
                                   (257, 131)])
@pytest.mark.parametrize("M,C", K2.SHAPES)
def test_graded_2d_kernel_matches_plain(dev, M, C, nx, ny, diag):
    KG.reset_launch_counts()
    for name in ("variable_coeff_elliptic_2d", "advection_diffusion_2d"):
        p, gops, fem, xs, ys, t_int, bpts = inputs_graded(name, nx, ny, M, C,
                                                          dev)
        args = (fem, gops, p, xs, ys, nx, ny, t_int, bpts)
        got = KG.fused_enhance_graded_2d(*args, with_diagnostics=diag)
        want = KG.fused_enhance_graded_2d_ref(*args, with_diagnostics=diag)
        torch.cuda.synchronize()
        assert got[0].shape == (nx * ny, M * M) and got[0].is_cuda
        assert_close_2d(got, want, 3e-5, lo=0.2, hi=5.0)
    assert KG.launch_counts() == {"fused_enhance_graded_2d": 2}


def test_graded_2d_kernel_nan_nodal_value(dev):
    nx = ny = 16
    p, gops, fem, xs, ys, t_int, bpts = inputs_graded(
        "variable_coeff_elliptic_2d", nx, ny, 6, 6, dev)
    fem[7, 9] = float("nan")
    bad = [6 * 16 + 8, 6 * 16 + 9, 7 * 16 + 8, 7 * 16 + 9]
    args = (fem, gops, p, xs, ys, nx, ny, t_int, bpts)
    got = KG.fused_enhance_graded_2d(*args)
    want = KG.fused_enhance_graded_2d_ref(*args)
    corners = (fem[:-1, :-1], fem[:-1, 1:], fem[1:, :-1], fem[1:, 1:])
    for out in (got, want):
        ok = H2._kernel_solve_ok(out[1], out[2], corners)
        assert torch.nonzero(~ok).flatten().tolist() == bad
    good = torch.ones(nx * ny, dtype=torch.bool, device=dev)
    good[bad] = False
    torch.testing.assert_close(got[0][good], want[0][good], rtol=0,
                               atol=3e-5)


def test_graded_2d_kernel_rejects_what_it_cannot_run(dev):
    p, gops, fem, xs, ys, t_int, bpts = inputs_graded(
        "variable_coeff_elliptic_2d", 8, 8, 7, 7, dev)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        KG.fused_enhance_graded_2d(fem, gops, p, xs, ys, 8, 8, t_int, bpts)
    cfg = Solver2DConfig(M=7, n_colloc=7, dtype="float32",
                         fem_dtype="float64")
    nodes = power_nodes(8)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        HybridSolver2DGraded(p, cfg, nodes, nodes, device=dev).solve()
    # Without an analytic grad_a the route is torch: no launch.
    KG.reset_launch_counts()
    auto = HybridSolver2DGraded(dataclasses.replace(p, grad_a=None),
                                dataclasses.replace(cfg, M=6, n_colloc=6),
                                nodes, nodes, device=dev).solve()
    assert KG.launch_counts()["fused_enhance_graded_2d"] == 0
    assert bool(auto.solve_ok.all())
    with pytest.raises(ValueError, match="float32"):
        KG.fused_enhance_graded_2d(fem.double(), gops.to(dtype=torch.float64),
                                   p, xs, ys, 8, 8, t_int, bpts)


@pytest.mark.parametrize("name", ["poisson_2d", "poisson_2d_inhomogeneous",
                                  "variable_coeff_elliptic_2d",
                                  "advection_diffusion_2d", "helmholtz_2d"])
def test_graded_solver_on_gpu_matches_cpu(dev, name):
    """The whole graded solver on the GPU (kernel) against the CPU (torch
    route), float32 enhancement over a float64 coarse solve."""
    cfg = Solver2DConfig(M=6, n_colloc=6, dtype="float32",
                         fem_dtype="float64")
    xs, ys = power_nodes(32), power_nodes(24)
    KG.reset_launch_counts()
    gpu = HybridSolver2DGraded(get_problem_2d(name), cfg, xs, ys, device=dev)
    cpu = HybridSolver2DGraded(get_problem_2d(name), cfg, xs, ys,
                               device="cpu")
    gpu.solve()
    cpu.solve()
    assert KG.launch_counts()["fused_enhance_graded_2d"] == 1
    torch.testing.assert_close(gpu.solution.coeffs.cpu(),
                               cpu.solution.coeffs, rtol=0, atol=3e-5)
    assert bool(gpu.solution.solve_ok.all())
    assert abs(gpu.solution.cg_iters - cpu.solution.cg_iters) <= 1
    pts = np.random.default_rng(0).uniform(-1, 1, (2, 500))
    assert abs(float(gpu.errors(*pts)[0]) - float(cpu.errors(*pts)[0])) < 1e-5


def test_default_device_is_the_gpu_graded(dev):
    p = get_problem_2d("poisson_2d")
    nodes = power_nodes(8)
    s = HybridSolver2DGraded(p, Solver2DConfig(dtype="float32"), nodes,
                             nodes)
    assert s.device.type == "cuda"
    assert s.solve().coeffs.is_cuda


# ------------------------------------------------------ elastic 2D kernel
# Tolerances of tests/test_pallas.py:423-469 (see tests/test_torch_elastic.py):
# w 3e-5, bcv 1e-5 here as for the scalar 2D kernels, slack in magnitude.

def inputs_elastic(name, nx, ny, M, C, dev, seed=0):
    p = EL.get_elastic_problem(name)
    cfg = ElasticConfig2D(nx=nx, ny=ny, M=M, n_colloc=C, dtype="float32")
    ops, (t_int, bpts) = EL.prepare_shared_elastic(p, cfg)
    X, Y = np.meshgrid(np.linspace(-1, 1, nx + 1), np.linspace(-1, 1, ny + 1))
    u = np.stack([e(torch.tensor(X), torch.tensor(Y)).numpy()
                  for e in (p.exact1, p.exact2)])
    u[:, 1:-1, 1:-1] += 1e-3 * np.random.default_rng(seed).normal(
        size=(2, ny - 1, nx - 1))
    fem = torch.tensor(u, dtype=torch.float32, device=dev)
    geom = (-1.0, 2.0 / nx, -1.0, 2.0 / ny)
    return p, ops.to(dev), fem, ((p.f1, p.f2), (p.g1, p.g2), geom, nx, ny,
                                 t_int, bpts)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("nx,ny", [(1, 1), (5, 3), (64, 48), (131, 67),
                                   (257, 131)])
@pytest.mark.parametrize("M,C", KE.SHAPES)
def test_elastic_2d_kernel_matches_plain(dev, M, C, nx, ny, diag):
    KE.reset_launch_counts()
    for name in ("sin_elastic_2d", "poly_elastic_2d"):
        p, ops, fem, tail = inputs_elastic(name, nx, ny, M, C, dev)
        got = KE.fused_enhance_elastic_2d(fem, ops, *tail,
                                          with_diagnostics=diag)
        want = KE.fused_enhance_elastic_2d_ref(fem, ops, *tail,
                                               with_diagnostics=diag)
        torch.cuda.synchronize()
        assert got[0].shape == (nx * ny, 2 * M * M) and got[0].is_cuda
        assert_close_2d(got, want, 3e-5)
    assert KE.launch_counts() == {"fused_enhance_elastic_2d": 2}


def test_elastic_2d_kernel_diagnostics_see_b(dev):
    """bcv with B scaled by 1.5 is ~max|bc|/2 on every quad, not rounding:
    the kernel's must follow its plain version's, and a NaN nodal value
    reaches the gate of its four quads and of no other."""
    nx = ny = 16
    p, ops, fem, tail = inputs_elastic("poly_elastic_2d", nx, ny, 6, 6, dev)
    skewed = dataclasses.replace(ops, B=1.5 * ops.B)
    got = KE.fused_enhance_elastic_2d(fem, skewed, *tail)[2]
    want = KE.fused_enhance_elastic_2d_ref(fem, skewed, *tail)[2]
    assert float(want.median()) > 1e-3
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.max()))
    fem[1, 7, 9] = float("nan")
    bad = [6 * 16 + 8, 6 * 16 + 9, 7 * 16 + 8, 7 * 16 + 9]
    corners = [(f[:-1, :-1], f[:-1, 1:], f[1:, :-1], f[1:, 1:]) for f in fem]
    for out in (KE.fused_enhance_elastic_2d(fem, ops, *tail),
                KE.fused_enhance_elastic_2d_ref(fem, ops, *tail)):
        ok = (H2._kernel_solve_ok(out[1], out[2], corners[0])
              & H2._kernel_solve_ok(out[1], out[2], corners[1]))
        assert torch.nonzero(~ok).flatten().tolist() == bad


def test_elastic_2d_kernel_rejects_what_it_cannot_run(dev):
    p, ops, fem, tail = inputs_elastic("sin_elastic_2d", 8, 8, 7, 7, dev)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        KE.fused_enhance_elastic_2d(fem, ops, *tail)
    cfg = ElasticConfig2D(nx=8, ny=8, M=7, n_colloc=7, dtype="float32",
                          backend="cuda")
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ElasticSolver2D(p, cfg, device=dev).solve()
    p, ops, fem, tail = inputs_elastic("sin_elastic_2d", 8, 8, 6, 6, dev)
    with pytest.raises(ValueError, match="float32"):
        KE.fused_enhance_elastic_2d(fem.double(), ops.to(dtype=torch.float64),
                                    *tail)
    with pytest.raises(ValueError, match="nodal grids"):
        KE.fused_enhance_elastic_2d(fem[0], ops, *tail)
    bad_b = dataclasses.replace(ops, B=ops.B.flip(0).contiguous())
    with pytest.raises(ValueError, match="diag"):
        KE.fused_enhance_elastic_2d(fem, bad_b, *tail)


@pytest.mark.parametrize("name,n", [("sin_elastic_2d", 64),
                                    ("poly_elastic_2d", 32)])
def test_elastic_solver_on_gpu_matches_cpu(dev, name, n):
    """ElasticSolver2D on the GPU through the kernel against the CPU (torch
    route), float32 throughout as in the JAX package.  poly_elastic_2d at
    32 x 32: from 64 x 64 on its float32 coarse CG meets its tolerance only
    by the chance of rounding (393 iterations on a CPU, 601 on an H100), so
    the two devices' iteration counts part there."""
    cfg = ElasticConfig2D(nx=n, ny=n, dtype="float32", backend="cuda")
    KE.reset_launch_counts()
    gpu = ElasticSolver2D(EL.get_elastic_problem(name), cfg, device=dev)
    gpu.solve()
    assert KE.launch_counts()["fused_enhance_elastic_2d"] == 1
    cpu = ElasticSolver2D(EL.get_elastic_problem(name),
                          dataclasses.replace(cfg, backend="torch"),
                          device="cpu")
    cpu.solve()
    torch.testing.assert_close(gpu.solution.coeffs.cpu(),
                               cpu.solution.coeffs, rtol=0, atol=3e-5)
    assert bool(gpu.solution.solve_ok.all())
    assert abs(gpu.solution.cg_iters - cpu.solution.cg_iters) <= 1
    pts = np.random.default_rng(0).uniform(-1, 1, (2, 500))
    assert abs(float(gpu.errors(*pts)[0]) - float(cpu.errors(*pts)[0])) < 1e-5


def test_elastic_auto_route_and_default_device(dev):
    p = EL.sin_elastic_2d()
    cfg = ElasticConfig2D(nx=8, ny=8, dtype="float32")
    KE.reset_launch_counts()
    s = ElasticSolver2D(p, cfg)
    assert s.device.type == "cuda"
    assert s.solve().coeffs.is_cuda
    assert KE.launch_counts()["fused_enhance_elastic_2d"] == 1
    KE.reset_launch_counts()
    lifted = dataclasses.replace(cfg, backend="cuda", coarse="richardson",
                                 trace_lift=6)
    assert bool(ElasticSolver2D(p, lifted).solve().solve_ok.all())
    assert KE.launch_counts()["fused_enhance_elastic_2d"] == 0


@pytest.mark.parametrize("kind", ["tensor", "number"])
def test_fully_resumed_scan_outputs_stay_on_the_card(dev, tmp_path, kind):
    """A checkpointed scan's per-step outputs lie on the carry's device
    whether they were computed or every chunk came from disk (tensor
    outputs and Python numbers, as the 2D marches' CG counts)."""
    from hybrid_fem_lssvr_tpu_torch.utils import checkpoint as CK

    def step(c, t):
        c2 = c * (1.0 + 0.01 * t) + torch.sin(t + c[0])
        return c2, torch.sum(c2) if kind == "tensor" else int(c2.numel())

    c0 = torch.arange(5, dtype=torch.float64, device=dev)
    ts = torch.linspace(0.0, 1.0, 24, dtype=torch.float64, device=dev)
    ref_c, ref_y = CK.scan(step, c0, ts)
    path = str(tmp_path / kind)
    for _ in range(2):  # uninterrupted, then every chunk restored
        c, y = CK.scan_checkpointed(step, c0, ts, path=path, chunk=6,
                                    fingerprint="fp")
        assert torch.equal(c, ref_c) and torch.equal(y, ref_y)
        assert y.device == c.device == ref_y.device and y.is_cuda
