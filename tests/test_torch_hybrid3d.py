"""The port's 3D solver against the JAX package's, float64 on the CPU.

``HybridSolver3D`` of both packages solves the same configuration; nodal
values agree to 1e-10, coefficients to 1e-9 (beyond what each side's own
trace constraints allow on the per-element route, see
``tests/test_torch_graded2d.py``), Krylov iteration counts to within 1 and
the fallback masks exactly.

JAX's 3D V-cycle is jit-compiled per configuration, so it is compiled once:
``poisson_3d`` at 8^3 with ``precond='mg'``.  The other JAX comparisons run
with ``precond='jacobi'`` at 4^3.  The shifted V-cycle (Helmholtz), the
V-cycle on variable coefficients and the composite mixed-BC preconditioner
(the V-cycle on the inner unknowns plus Jacobi on the natural faces) are
held against the port's own Jacobi solution, and the V-cycle itself
against JAX's in ``tests/test_torch_ops3d.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import hybrid3d as JH3

from hybrid_fem_lssvr_tpu_torch import (HybridSolver3D, Solver3DConfig,
                                        get_problem_3d)
from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
from hybrid_fem_lssvr_tpu_torch.ops import legendre
from hybrid_fem_lssvr_tpu_torch.utils import convert, metrics

torch.set_num_threads(1)

BASE = dict(nx=4, ny=4, nz=4)


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
    s = HybridSolver3D(get_problem_3d(name),
                       Solver3DConfig(**dict(BASE, **kw)), device="cpu")
    s.solve()
    return s


@cached
def jax_solve(name, **kw):
    s = JH3.HybridSolver3D(JH3.get_problem_3d(name),
                           JH3.Solver3DConfig(**dict(BASE, **kw)))
    s.solve()
    return s


def assert_same_solution(got, want):
    close(got.fem_values, want.fem_values, 1e-10)
    own = max(float(got.bc_violation.max()), float(np.max(want.bc_violation)))
    close(got.coeffs, want.coeffs, 1e-9 + own)
    assert tuple(got.coeffs.shape) == tuple(want.coeffs.shape)
    assert abs(got.cg_iters - int(want.cg_iters)) <= 1
    np.testing.assert_array_equal(np_(got.solve_ok), np_(want.solve_ok))
    assert bool(got.solve_ok.all())
    close(got.bc_violation, want.bc_violation, 10 * (1e-9 + own))
    for a in ("xs", "ys", "zs"):
        close(getattr(got, a), getattr(want, a), 1e-15)
    if want.cond_estimate is not None:
        np.testing.assert_allclose(np_(got.cond_estimate),  # a monitor
                                   np_(want.cond_estimate), rtol=1e-4)


CONFIGS = [
    ("poisson_3d", dict(nx=8, ny=8, nz=8, precond="mg")),
    ("poisson_3d", dict(formulation="dual")),
    ("poisson_3d", dict(nx=2, ny=4, nz=6)),
    ("poisson_3d_inhomogeneous", {}),
    ("helmholtz_3d", {}),
    ("advection_diffusion_3d", {}),
    ("variable_coeff_elliptic_3d", {}),
    ("poisson_3d_neumann", {}),
    ("robin_3d", {}),
    ("poisson_3d_inhomogeneous", dict(coarse="compact", trace_lift=4)),
]


@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or '4'}"
                              for n, k in CONFIGS])
def test_solver_3d_matches_jax_float64(name, kw):
    kw = dict(dict(precond="jacobi"), **kw)
    assert_same_solution(port_solve(name, **kw).solution,
                         jax_solve(name, **kw).solution)


def test_dual_solves_the_primal_problem():
    """tests/test_poisson3d.py:369 on the port: the dual (finite gamma)
    and the primal (the LSE limit) differ by O(1/gamma), far below the
    coarse stage's error."""
    kw = dict(precond="jacobi")
    primal = port_solve("poisson_3d", **kw)
    dual = port_solve("poisson_3d", formulation="dual", **kw)
    assert bool(dual.solution.solve_ok.all())
    pts = np.random.default_rng(7).uniform(-1, 1, (3, 800))
    close(dual.evaluate_solution(*pts), primal.evaluate_solution(*pts), 2e-5)
    close(dual.solution.coeffs, primal.solution.coeffs, 1e-6)


@pytest.mark.parametrize("name,kw", [
    ("poisson_3d", {}), ("helmholtz_3d", {}),
    ("variable_coeff_elliptic_3d", {}), ("advection_diffusion_3d", {}),
    ("poisson_3d_neumann", {}), ("robin_3d", {}),
    ("poisson_3d_inhomogeneous", dict(coarse="compact")),
])
def test_multigrid_routes_match_own_jacobi(name, kw):
    """precond='auto' at 8^3: mg (constant or variable coefficients),
    shifted (helmholtz) or the composite mixed-BC preconditioner (neumann,
    robin) reaches the Jacobi route's solution."""
    grid = dict(nx=8, ny=8, nz=8, **kw)
    auto = port_solve(name, **grid).solution
    jac = port_solve(name, precond="jacobi", **grid).solution
    close(auto.fem_values, jac.fem_values, 1e-10)
    # The per-element route (variable coefficients) meets its constraints
    # only to its own bc violation (see tests/test_torch_graded2d.py).
    own = max(float(auto.bc_violation.max()), float(jac.bc_violation.max()))
    close(auto.coeffs, jac.coeffs, 1e-8 + own)


def test_evaluation_matches_jax_and_clamps_outside():
    got = port_solve("poisson_3d_inhomogeneous", precond="jacobi")
    want = jax_solve("poisson_3d_inhomogeneous", precond="jacobi")
    rng = np.random.default_rng(1)
    x, y, z = (rng.uniform(-1.2, 1.2, 300) for _ in range(3))
    close(got.evaluate_solution(x, y, z), want.evaluate_solution(x, y, z),
          1e-9)
    for g, w in zip(got.evaluate_gradient(x, y, z),
                    want.evaluate_gradient(x, y, z)):
        close(g, w, 1e-8)
    for g, w in zip(got.errors(x, y, z), want.errors(x, y, z)):
        assert float(g) == pytest.approx(float(w), abs=1e-9)
    # Outside the domain the nearest hex's polynomial is extrapolated.
    sol = got.solution
    out = got.evaluate_solution(np.array([1.3]), np.array([0.1]),
                                np.array([-1.1]))
    t = [torch.tensor([(2 * v - n[i] - n[i + 1]) / 0.5])
         for v, n, i in ((1.3, sol.xs, 3), (0.1, sol.ys, 2),
                         (-1.1, sol.zs, 0))]
    Vx, Vy, Vz = (legendre.legendre_vandermonde(v, 4, num_derivs=0)[0]
                  for v in t)
    ref = torch.einsum("pk,klm,pl,pm->p", Vz, sol.coeffs[0, 2, 3], Vy, Vx)
    close(out, ref, 1e-13)
    with pytest.raises(RuntimeError, match="solve"):
        HybridSolver3D(get_problem_3d("poisson_3d"), Solver3DConfig(**BASE),
                       device="cpu").evaluate_solution(x, y, z)


def test_jax_bundle_through_converter_gives_same_solution():
    name = "variable_coeff_elliptic_3d"
    cfg = dict(BASE, precond="jacobi")
    jops, (t_int, spts) = JH3.prepare_shared_3d(JH3.get_problem_3d(name),
                                                JH3.Solver3DConfig(**cfg))
    ops = convert.varcoeff3d_operators_from_arrays(
        {k: np.asarray(v) for k, v in jops._asdict().items()},
        dtype=torch.float64)
    via_jax = H3.hybrid_solve_3d(get_problem_3d(name), Solver3DConfig(**cfg),
                                 (ops, (np.array(t_int), np.array(spts))),
                                 device="cpu")
    own = port_solve(name, precond="jacobi").solution
    close(via_jax.coeffs, own.coeffs, 1e-12)


def test_autograd_gradient_of_a_var_matches_analytic():
    """``grad_a=None``: the chain-rule coefficients come from autograd."""
    p = get_problem_3d("variable_coeff_elliptic_3d")
    cfg = Solver3DConfig(**BASE)
    vb, (t_int, _) = H3.prepare_shared_3d(p, cfg)
    xs = torch.linspace(-1, 1, 5, dtype=torch.float64)
    want = H3._varcoeff_element_operators_3d(p, cfg, xs, xs, xs, vb, t_int)
    got = H3._varcoeff_element_operators_3d(
        dataclasses.replace(p, grad_a=None), cfg, xs, xs, xs, vb, t_int)
    close(got, want, 1e-12)
    jp = JH3.get_problem_3d("variable_coeff_elliptic_3d")
    jvb, _ = JH3.prepare_shared_3d(jp, JH3.Solver3DConfig(**BASE))
    jx = jnp.linspace(-1, 1, 5)
    close(want, JH3._varcoeff_element_operators_3d(
        jp, JH3.Solver3DConfig(**BASE), jx, jx, jx, jvb, t_int), 1e-10)


def test_trilinear_fallback_matches_jax_and_interpolates():
    u = np.random.default_rng(3).normal(size=(3, 4, 5))
    from hybrid_fem_lssvr_tpu.ops import assembly3d as JA3

    from hybrid_fem_lssvr_tpu_torch.ops import assembly3d as A3
    got = H3._trilinear_fallback_coeffs(
        A3._corners_3d(torch.tensor(u)), 4)
    want = JH3._trilinear_fallback_coeffs(JA3._corners_3d(jnp.asarray(u)), 4)
    close(got, want, 1e-15)
    # At the lower corner (t = -1 on each axis) the expansion is u[0, 0, 0].
    V = legendre.legendre_vandermonde(torch.tensor([-1.0], dtype=torch.float64),
                                      4, num_derivs=0)[0][0]
    close(torch.einsum("k,klm,l,m->", V, got[0, 0, 0], V, V), u[0, 0, 0],
          1e-14)


def test_bc_rows_override_and_fallback():
    """``bc_rows_override`` replaces the trace (and forces the torch
    route); a NaN nodal value falls back to the trilinear interpolant on
    its eight hexes only."""
    p = get_problem_3d("poisson_3d")
    cfg = Solver3DConfig(**BASE)
    s = port_solve("poisson_3d", precond="jacobi")
    sol = s.solution
    bundle = H3.prepare_shared_3d(p, cfg)
    _, bc_rows, _ = H3._element_data_3d(p, cfg, sol.xs, sol.ys, sol.zs,
                                        sol.fem_values, *bundle[1])
    same, _, _ = H3.enhance_3d(p, cfg, sol.xs, sol.ys, sol.zs,
                               sol.fem_values, bundle,
                               bc_rows_override=bc_rows)
    close(same, sol.coeffs, 1e-13)
    zero, _, _ = H3.enhance_3d(p, cfg, sol.xs, sol.ys, sol.zs,
                               sol.fem_values, bundle,
                               bc_rows_override=torch.zeros_like(bc_rows))
    assert float((zero - sol.coeffs).abs().max()) > 1e-3
    bad = sol.fem_values.clone()
    bad[2, 1, 2] = float("nan")
    coeffs, diags, _ = H3.enhance_3d(p, cfg, sol.xs, sol.ys, sol.zs, bad,
                                     bundle)
    ok = diags.solve_ok.reshape(4, 4, 4)
    assert int((~ok).sum()) == 8 and not bool(ok[1:3, 0:2, 1:3].any())
    close(coeffs[ok], sol.coeffs[ok], 1e-13)


@pytest.mark.parametrize("bad", [dict(formulation="x"), dict(coarse="x"),
                                 dict(trace_lift=1), dict(backend="xla")])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        Solver3DConfig(**bad)


@pytest.mark.parametrize("name,kw,match", [
    ("variable_coeff_elliptic_3d", dict(coarse="compact"), "constant diff"),
    ("advection_diffusion_3d", dict(coarse="compact"), "b == "),
    ("robin_3d", dict(coarse="compact"), "all-Dirichlet"),
    ("robin_3d", dict(precond="shifted"), "all-Dirichlet"),
    ("poisson_3d_neumann", dict(precond="mg", nx=6, ny=6, nz=6), "mixed-BC"),
    ("poisson_3d", dict(precond="ilu"), "unknown precond"),
])
def test_solver_refuses_what_the_reference_refuses(name, kw, match):
    with pytest.raises(ValueError, match=match):
        port_solve(name, **kw)


def test_q1_nodal_order_two():
    """The coarse Q1 solution converges at order 2 in the nodes."""
    errs, hs = [], []
    p = get_problem_3d("poisson_3d")
    for n in (4, 8, 16):
        sol = port_solve("poisson_3d", nx=n, ny=n, nz=n).solution
        Z, Y, X = torch.meshgrid(sol.zs, sol.ys, sol.xs, indexing="ij")
        errs.append(float((sol.fem_values - p.exact(X, Y, Z)).abs().max()))
        hs.append(2.0 / n)
    order = metrics.convergence_order(hs, errs)
    assert 1.8 < order < 2.3, (order, errs)


def test_default_device_is_the_gpu_or_an_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; see tests/test_torch_cuda.py")
    p, cfg = get_problem_3d("poisson_3d"), Solver3DConfig(**BASE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridSolver3D(p, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H3.hybrid_solve_3d(p, cfg, H3.prepare_shared_3d(p, cfg))
    assert jax.default_backend() == "cpu"
