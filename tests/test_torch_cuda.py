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

from hybrid_fem_lssvr_tpu_torch import (HybridSolver, HybridSolver2D,
                                        Solver2DConfig, SolverConfig,
                                        get_problem_2d, problems)
from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2

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
@pytest.mark.parametrize("nx,ny", [(1, 1), (5, 3), (64, 48), (131, 67)])
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
