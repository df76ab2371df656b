"""The port's 2D solver against the JAX package's, float64 on the CPU.

``HybridSolver2D`` of both packages solves the same configuration; nodal
values agree to 1e-10, coefficients to 1e-9, Krylov iteration counts to
within 1 and the fallback masks exactly.  Both sides do the same float64
arithmetic in another order, and the coarse solve stops at a relative
residual of 100 eps, which bounds how far two runs can drift apart.

The JAX side is jit-compiled per configuration, and its multigrid V-cycle
takes 8 s to compile, so most JAX comparisons run with ``precond='jacobi'``
or ``'adi'`` (under a second each).  The 'mg' and 'shifted' routes are held
against the JAX package once each in ``CONFIGS`` (``poisson_2d`` at 16 x 16,
``helmholtz_2d`` under BiCGStab).  For the other problems, and for the
composite mixed-BC preconditioner (the same V-cycle on the inner unknowns
plus Jacobi on the natural edges), the port's ``precond='auto'`` solution
is held against its own Jacobi solution, and the V-cycle itself against
JAX's in ``tests/test_torch_ops2d.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from hybrid_fem_lssvr_tpu.models import hybrid2d as JH2

from hybrid_fem_lssvr_tpu_torch import (HybridSolver2D, Solver2DConfig,
                                        get_problem_2d)
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
from hybrid_fem_lssvr_tpu_torch.utils import convert, metrics

torch.set_num_threads(1)

BASE = dict(nx=8, ny=8, M=5, n_colloc=5)


def np_(t):
    return np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=atol)


def cached(solve):
    """One solve per configuration, shared by the tests that read it."""
    memo = functools.lru_cache(maxsize=None)(
        lambda name, items: solve(name, **dict(items)))
    return lambda name, **kw: memo(name, tuple(sorted(kw.items())))


@cached
def port_solve(name, **kw):
    s = HybridSolver2D(get_problem_2d(name),
                       Solver2DConfig(**dict(BASE, **kw)), device="cpu")
    s.solve()
    return s


@cached
def jax_solve(name, **kw):
    s = JH2.HybridSolver2D(JH2.get_problem_2d(name),
                           JH2.Solver2DConfig(**dict(BASE, **kw)))
    s.solve()
    return s


def assert_same_solution(got, want, coeff_tol=1e-9):
    close(got.fem_values, want.fem_values, 1e-10)
    close(got.coeffs, want.coeffs, coeff_tol)
    assert tuple(got.coeffs.shape) == tuple(want.coeffs.shape)
    assert abs(got.cg_iters - int(want.cg_iters)) <= 1
    np.testing.assert_array_equal(np_(got.solve_ok), np_(want.solve_ok))
    assert bool(got.solve_ok.all())
    close(got.bc_violation, want.bc_violation, 10 * coeff_tol)
    close(got.xs, want.xs, 1e-15)  # the two linspace formulas: one ulp
    close(got.ys, want.ys, 1e-15)
    if want.cond_estimate is not None:
        np.testing.assert_allclose(np_(got.cond_estimate),  # a monitor
                                   np_(want.cond_estimate), rtol=1e-4)


CONFIGS = [
    ("poisson_2d", dict(nx=16, ny=16, precond="mg")),
    ("poisson_2d", dict(formulation="dual")),
    ("poisson_2d", dict(nx=6, ny=10)),
    ("poisson_2d_inhomogeneous", {}),
    ("helmholtz_2d", dict(precond="shifted")),
    ("advection_diffusion_2d", {}),
    ("reaction_diffusion_2d", {}),
    ("variable_coeff_elliptic_2d", {}),
    ("poisson_2d_neumann", {}),
    ("robin_2d", {}),
]


@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or '8'}"
                              for n, k in CONFIGS])
def test_solver_matches_jax_float64(name, kw):
    kw = dict(dict(precond="jacobi"), **kw)
    # The float64 per-element route factors H = I + gamma D^T D, whose
    # condition number is ~1e16 in 2D (discrete-harmonic null space of the
    # Laplacian): either package meets its own trace constraints only to
    # ~5e-9 there, and two summation orders differ by as much.
    tol = 2e-8 if name == "variable_coeff_elliptic_2d" else 1e-9
    assert_same_solution(port_solve(name, **kw).solution,
                         jax_solve(name, **kw).solution, coeff_tol=tol)


def test_adi_preconditioned_solve_matches_jax():
    kw = dict(precond="adi", nx=8, ny=16)
    assert_same_solution(port_solve("poisson_2d", **kw).solution,
                         jax_solve("poisson_2d", **kw).solution)


def test_compact_coarse_with_trace_lift_matches_jax():
    kw = dict(coarse="compact", trace_lift=6, precond="jacobi")
    got, want = port_solve("poisson_2d", **kw), jax_solve("poisson_2d", **kw)
    assert_same_solution(got.solution, want.solution)
    pts = np.random.default_rng(0).uniform(-1, 1, (2, 200))
    # O(h^4) nodal values carried through by the lift: under the Q1 nodal
    # floor (8.4e-3 at 8 x 8) already on this coarse mesh.
    q1 = port_solve("poisson_2d", precond="jacobi")
    assert float(got.errors(*pts)[0]) < 0.5 * float(q1.errors(*pts)[0])


@pytest.mark.parametrize("name,n", [
    ("poisson_2d", 8), ("poisson_2d", 16), ("poisson_2d_inhomogeneous", 8),
    ("helmholtz_2d", 8), ("advection_diffusion_2d", 8),
    ("variable_coeff_elliptic_2d", 8), ("poisson_2d_neumann", 8),
    ("robin_2d", 8),
])
def test_multigrid_routes_match_own_jacobi(name, n):
    """precond='auto': mg, shifted (helmholtz) or the composite mixed-BC
    preconditioner (neumann, robin) reaches the Jacobi route's solution."""
    auto = port_solve(name, nx=n, ny=n).solution
    jac = port_solve(name, nx=n, ny=n, precond="jacobi").solution
    close(auto.fem_values, jac.fem_values, 1e-10)
    close(auto.coeffs, jac.coeffs, 1e-8)


def test_evaluation_matches_jax_and_clamps_outside():
    got = port_solve("poisson_2d_inhomogeneous", precond="jacobi")
    want = jax_solve("poisson_2d_inhomogeneous", precond="jacobi")
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-1.2, 1.2, 300), rng.uniform(-1.2, 1.2, 300)
    close(got.evaluate_solution(x, y), want.evaluate_solution(x, y), 1e-9)
    gx, gy = got.evaluate_gradient(x, y)
    wx, wy = want.evaluate_gradient(x, y)
    close(gx, wx, 1e-8)
    close(gy, wy, 1e-8)
    for g, w in zip(got.errors(x, y), want.errors(x, y)):
        assert float(g) == pytest.approx(float(w), abs=1e-9)
    # Outside the domain the nearest element's polynomial is extrapolated.
    out = got.evaluate_solution(np.array([1.3]), np.array([0.1]))
    sol = got.solution
    t = torch.tensor([(2 * 1.3 - sol.xs[-2] - sol.xs[-1])
                      / (sol.xs[1] - sol.xs[0])])
    iy = int(np.floor((0.1 + 1.0) / 0.25))
    ty = torch.tensor([(2 * 0.1 - sol.ys[iy] - sol.ys[iy + 1]) / 0.25])
    from hybrid_fem_lssvr_tpu_torch.ops import legendre
    (Vx,) = legendre.legendre_vandermonde(t, 5, num_derivs=0)
    (Vy,) = legendre.legendre_vandermonde(ty, 5, num_derivs=0)
    ref = torch.einsum("pk,kl,pl->p", Vy, sol.coeffs[iy, -1], Vx)
    close(out, ref, 1e-13)
    with pytest.raises(RuntimeError, match="solve"):
        HybridSolver2D(get_problem_2d("poisson_2d"), Solver2DConfig(**BASE),
                       device="cpu").evaluate_solution(x, y)


def test_jax_bundle_through_converter_gives_same_solution():
    name = "variable_coeff_elliptic_2d"
    cfg = dict(BASE, precond="jacobi")
    jops, (t_int, bpts) = JH2.prepare_shared_2d(JH2.get_problem_2d(name),
                                                JH2.Solver2DConfig(**cfg))
    arrays = {k: (v if isinstance(v, (int, float)) else np.asarray(v))
              for k, v in jops._asdict().items() if v is not None}
    ops = convert.varcoeff2d_operators_from_arrays(arrays,
                                                   dtype=torch.float64)
    via_jax = H2.hybrid_solve_2d(get_problem_2d(name), Solver2DConfig(**cfg),
                                 (ops, (np.array(t_int), np.array(bpts))),
                                 device="cpu")
    own = port_solve(name, precond="jacobi").solution
    close(via_jax.coeffs, own.coeffs, 1e-12)


def test_autograd_gradient_of_a_var_matches_analytic():
    """``grad_a=None``: the chain-rule coefficients come from autograd."""
    p = get_problem_2d("variable_coeff_elliptic_2d")
    cfg = Solver2DConfig(**BASE)
    vb, (t_int, _) = H2.prepare_shared_2d(p, cfg)
    xs = torch.linspace(-1, 1, 9, dtype=torch.float64)
    want = H2._varcoeff_element_operators(p, cfg, xs, xs, vb, t_int)
    got = H2._varcoeff_element_operators(
        dataclasses.replace(p, grad_a=None), cfg, xs, xs, vb, t_int)
    close(got, want, 1e-12)
    jp = JH2.get_problem_2d("variable_coeff_elliptic_2d")
    jvb, _ = JH2.prepare_shared_2d(jp, JH2.Solver2DConfig(**BASE))
    close(want, JH2._varcoeff_element_operators(
        jp, JH2.Solver2DConfig(**BASE), jax.numpy.linspace(-1, 1, 9),
        jax.numpy.linspace(-1, 1, 9), jvb, t_int), 1e-10)


def test_bc_rows_override_and_fallback():
    """``bc_rows_override`` replaces the trace (and forces the torch
    route); a NaN nodal value falls back to the bilinear interpolant on
    its four quads only."""
    p = get_problem_2d("poisson_2d")
    cfg = Solver2DConfig(**BASE)
    s = port_solve("poisson_2d", precond="jacobi")
    sol = s.solution
    bundle = H2.prepare_shared_2d(p, cfg)
    _, bc_rows, _ = H2._element_data_2d(p, cfg, sol.xs, sol.ys,
                                        sol.fem_values, *bundle[1])
    same, _, _ = H2.enhance_2d(p, cfg, sol.xs, sol.ys, sol.fem_values,
                               bundle, bc_rows_override=bc_rows)
    close(same, sol.coeffs, 1e-13)
    zero, _, _ = H2.enhance_2d(p, cfg, sol.xs, sol.ys, sol.fem_values,
                               bundle,
                               bc_rows_override=torch.zeros_like(bc_rows))
    assert float((zero - sol.coeffs).abs().max()) > 1e-3
    bad = sol.fem_values.clone()
    bad[3, 5] = float("nan")
    coeffs, diags, _ = H2.enhance_2d(p, cfg, sol.xs, sol.ys, bad, bundle)
    ok = diags.solve_ok.reshape(8, 8)
    assert int((~ok).sum()) == 4 and not bool(ok[2:4, 4:6].any())
    close(coeffs[ok], sol.coeffs[ok], 1e-13)
    fb = H2._bilinear_fallback_coeffs(bad[:-1, :-1], bad[:-1, 1:],
                                      bad[1:, :-1], bad[1:, 1:], 5)
    assert torch.equal(torch.isnan(coeffs), torch.isnan(fb))


@pytest.mark.parametrize("bad", [dict(formulation="x"), dict(coarse="x"),
                                 dict(trace_lift=1), dict(backend="pallas"),
                                 dict(varcoeff_method="x")])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        Solver2DConfig(**bad)


@pytest.mark.parametrize("name,kw,match", [
    ("variable_coeff_elliptic_2d", dict(coarse="compact"), "constant diff"),
    ("advection_diffusion_2d", dict(coarse="compact"), "b == "),
    ("robin_2d", dict(coarse="compact"), "all-Dirichlet"),
    ("robin_2d", dict(precond="adi"), "all-Dirichlet"),
    ("poisson_2d_neumann", dict(precond="mg", nx=6, ny=6), "mixed-BC"),
    ("poisson_2d", dict(precond="ilu"), "unknown precond"),
])
def test_solver_refuses_what_the_reference_refuses(name, kw, match):
    with pytest.raises(ValueError, match=match):
        port_solve(name, **kw)


# ------------------------------------------------- the reference's claims

def test_q1_nodal_order_two():
    """tests/test_poisson2d.py:62-84 on the port: the coarse Q1 solution
    converges at order 2 in the nodes."""
    errs, hs = [], []
    p = get_problem_2d("poisson_2d")
    for n in (8, 16, 32):
        sol = port_solve("poisson_2d", nx=n, ny=n).solution
        Y, X = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
        errs.append(float((sol.fem_values - p.exact(X, Y)).abs().max()))
        hs.append(2.0 / n)
    order = metrics.convergence_order(hs, errs)
    assert 1.8 < order < 2.2, (order, errs)


def test_hybrid_solution_rides_under_the_nodal_floor():
    """tests/test_poisson2d.py:86-107 on the port: off-node error of the
    enhanced solution stays under the coarse nodal error, with the trace
    constraints met to round-off."""
    s = port_solve("poisson_2d", nx=16, ny=16, M=6, n_colloc=6)
    sol = s.solution
    p = get_problem_2d("poisson_2d")
    Y, X = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
    nodal = float((sol.fem_values - p.exact(X, Y)).abs().max())
    pts = np.random.default_rng(2).uniform(-1, 1, (2, 4000))
    linf, l2 = s.errors(*pts)
    assert float(linf) <= 1.05 * nodal
    assert float(l2) < float(linf)
    assert float(sol.bc_violation.max()) < 1e-10
    assert bool(sol.solve_ok.all())


def test_default_device_is_the_gpu_or_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; see tests/test_torch_cuda.py")
    p, cfg = get_problem_2d("poisson_2d"), Solver2DConfig(**BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridSolver2D(p, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H2.hybrid_solve_2d(p, cfg, H2.prepare_shared_2d(p, cfg))
