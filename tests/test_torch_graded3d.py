"""The port's graded 3D hex solver (``models/hybrid3d_graded.py``) against
the JAX package, at ``tests/test_graded3d.py``'s sizes (6^3, M = C = 4,
Jacobi-CG, float64).

The enhancement is the per-element float64 route on both sides, so the
coefficients are held to ROADMAP.md section 3's rule: 1e-9 plus the larger
of the two packages' own bc violations.  The coarse Q1 nodal values (the
same Jacobi-CG iterations) agree to 1e-12 relative.  The JAX solves run
once per module (fixtures).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hybrid_fem_lssvr_tpu.models import hybrid3d as JH3
from hybrid_fem_lssvr_tpu.models import hybrid3d_graded as JHG

from hybrid_fem_lssvr_tpu_torch import HybridSolver3D, HybridSolver3DGraded
from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
from hybrid_fem_lssvr_tpu_torch.models import hybrid3d_graded as HG
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

PROBLEMS = ("poisson_3d_inhomogeneous", "advection_diffusion_3d",
            "variable_coeff_elliptic_3d")
N = 6


def stretched(n, power):
    s = np.linspace(-1, 1, n + 1)
    return np.sign(s) * np.abs(s) ** power, s


@pytest.fixture(scope="module")
def query():
    r = np.random.default_rng(13)
    return (r.uniform(-1, 1, 800), r.uniform(-1, 1, 800),
            r.uniform(-1, 1, 800))


def cfg(port=True, **kw):
    base = dict(nx=N, ny=N, nz=N, M=4, n_colloc=4, precond="jacobi",
                dtype="float64", **kw)
    if port:
        return H3.Solver3DConfig(backend="torch", **base)
    return JH3.Solver3DConfig(backend="xla", **base)


@pytest.fixture(scope="module")
def jax_graded(query):
    """JAX's graded solves on the x^1.5-stretched mesh, with values and
    gradients at the query points."""
    xs, s = stretched(N, 1.5)
    # (evaluation under jax.jit: op by op it compiles ~10x longer)
    value = jax.jit(JHG.evaluate_3d_graded)
    grad = jax.jit(JHG.evaluate_3d_graded_gradient)
    out = {}
    for name in PROBLEMS:
        sol = JHG.HybridSolver3DGraded(JH3.get_problem_3d(name), cfg(False),
                                       xs, s, s).solve()
        out[name] = (sol, np.asarray(value(sol, *query)),
                     [np.asarray(g) for g in grad(sol, *query)])
    return out


def bcv(*sols):
    return max(float(np.max(np.asarray(s.bc_violation))) for s in sols)


@pytest.mark.parametrize("name", PROBLEMS)
def test_graded_solve_matches_jax(jax_graded, query, name):
    jsol, ju, jgrad = jax_graded[name]
    xs, s = stretched(N, 1.5)
    ts = HybridSolver3DGraded(H3.get_problem_3d(name), cfg(), xs, s, s,
                              device="cpu")
    sol = ts.solve()
    assert sol.cg_iters == jsol.cg_iters
    np.testing.assert_allclose(sol.fem_values.numpy(),
                               np.asarray(jsol.fem_values), rtol=0,
                               atol=1e-12 * float(np.abs(jsol.fem_values)
                                                  .max()))
    tol = 1e-9 + bcv(sol, jsol)
    np.testing.assert_allclose(sol.coeffs.numpy(), np.asarray(jsol.coeffs),
                               rtol=0, atol=tol)
    np.testing.assert_array_equal(sol.solve_ok.numpy(),
                                  np.asarray(jsol.solve_ok))
    assert bool(sol.solve_ok.all())
    # values and gradients at the query points (chain factors up to
    # 2/h ~ 20 on the finest elements)
    np.testing.assert_allclose(ts.evaluate_solution(*query).numpy(), ju,
                               rtol=0, atol=4 * tol)
    for g, jg in zip(ts.evaluate_gradient(*query), jgrad):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=100 * tol)


@pytest.mark.parametrize("name", PROBLEMS)
def test_graded_equals_uniform_on_uniform_mesh(query, name):
    """tests/test_graded3d.py's check on the port: with equal spacings the
    graded path reproduces the uniform pipeline."""
    p = H3.get_problem_3d(name)
    c = cfg()
    su = HybridSolver3D(p, c, device="cpu")
    solu = su.solve()
    xs = np.linspace(-1, 1, N + 1)
    sg = HybridSolver3DGraded(p, c, xs, xs, xs, device="cpu")
    solg = sg.solve()
    assert bool(solg.solve_ok.all())
    np.testing.assert_allclose(solg.coeffs.numpy(), solu.coeffs.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(sg.evaluate_solution(*query).numpy(),
                               su.evaluate_solution(*query).numpy(),
                               atol=4e-6)


def test_mesh_larger_than_config_keeps_interior_slabs():
    """The domain-boundary override keys off the true mesh extents, not the
    config's nx/ny/nz."""
    p = H3.get_problem_3d("poisson_3d")
    c = dataclasses.replace(cfg(), nx=4, ny=4, nz=4)
    xs = np.array([-1.0, -2 / 3, -0.4, 0.0, 0.4, 2 / 3, 1.0])
    sol = HybridSolver3DGraded(p, c, xs, xs, xs, device="cpu").solve()
    assert bool(sol.solve_ok.all())
    hx = np.diff(xs)
    scale = (((2 / hx) ** 2)[None, None, :] + ((2 / hx) ** 2)[None, :, None]
             + ((2 / hx) ** 2)[:, None, None])
    assert float((sol.max_slack.numpy() / scale).max()) < 0.2


def test_graded_variable_coeff_coarse_matches_uniform_assembler():
    """The graded coarse apply with a_var against the uniform
    variable-coefficient assembler on an equal-spacing mesh."""
    p = H3.get_problem_3d("variable_coeff_elliptic_3d")
    c = dataclasses.replace(cfg(), cg_tol=1e-6)
    xs = torch.linspace(-1, 1, N + 1, dtype=torch.float64)
    fu, _ = H3.fem_solve_3d(p, c, xs, xs, xs)
    fg, _ = HG.fem_solve_3d_graded(p, c, xs, xs, xs)
    np.testing.assert_allclose(fg.numpy(), fu.numpy(), atol=1e-5)


def test_autograd_gradient_of_a_matches_the_analytic_one():
    """grad_a by torch.autograd (the problem without grad_a) gives the
    same element operators as the analytic grad_a."""
    p = H3.get_problem_3d("variable_coeff_elliptic_3d")
    xs, s = stretched(4, 1.5)
    c = dataclasses.replace(cfg(), nx=4, ny=4, nz=4)
    gops, (t_int, _) = HG.prepare_shared_3d_graded(p, c)
    args = [torch.tensor(v) for v in (xs, s, s)]
    D = HG._graded_element_operators_3d(p, c, *args, gops, t_int)
    D_ad = HG._graded_element_operators_3d(
        dataclasses.replace(p, grad_a=None), c, *args, gops, t_int)
    np.testing.assert_allclose(D_ad.numpy(), D.numpy(), rtol=0,
                               atol=1e-12 * float(D.abs().max()))


@pytest.fixture(scope="module")
def jax_adaptive(query):
    return JHG.adaptive_solve_3d(JH3.get_problem_3d("poisson_3d"),
                                 cfg(False), rounds=1, refine_frac=0.3,
                                 eval_points=query)


def test_adaptive_3d_matches_jax(jax_adaptive, query):
    """adaptive_solve_3d from 6^3, one refinement round: the same refined
    axes, and the history's elements, scale-normalised slack and error."""
    res = HG.adaptive_solve_3d(H3.get_problem_3d("poisson_3d"), cfg(),
                               rounds=1, refine_frac=0.3, eval_points=query,
                               device="cpu")
    for a in ("xs", "ys", "zs"):
        np.testing.assert_array_equal(getattr(res, a),
                                      getattr(jax_adaptive, a))
    tol = 4 * (1e-9 + bcv(res.solution, jax_adaptive.solution))
    for t, j in zip(res.history, jax_adaptive.history):
        assert t["elements"] == j["elements"]
        assert abs(t["max_slack"] - j["max_slack"]) <= 1e-6 * j["max_slack"]
        assert abs(t["linf"] - j["linf"]) <= tol  # as the values above
    assert res.history[-1]["elements"] > res.history[0]["elements"]
    assert res.history[-1]["max_slack"] < res.history[0]["max_slack"]
    assert res.history[-1]["linf"] < res.history[0]["linf"]
    assert bool(res.solution.solve_ok.all())


def test_graded_gradient_matches_exact(query):
    """Graded gradient evaluation against the exact gradient of
    sin(pi x) sin(pi y) sin(pi z) on a 10^3 stretched mesh."""
    xq, yq, zq = query
    n = 10
    xs, s = stretched(n, 1.5)
    c = dataclasses.replace(cfg(), nx=n, ny=n, nz=n)
    sg = HybridSolver3DGraded(H3.get_problem_3d("poisson_3d"), c, xs, s, s,
                              device="cpu")
    sg.solve()
    ux, uy, uz = sg.evaluate_gradient(xq, yq, zq)
    pi = np.pi
    ex = pi * np.cos(pi * xq) * np.sin(pi * yq) * np.sin(pi * zq)
    ey = pi * np.sin(pi * xq) * np.cos(pi * yq) * np.sin(pi * zq)
    ez = pi * np.sin(pi * xq) * np.sin(pi * yq) * np.cos(pi * zq)
    for g, e in ((ux, ex), (uy, ey), (uz, ez)):
        assert np.abs(g.numpy() - e).max() < 1.2


def test_graded_dual_equals_primal_3d(query):
    xs, s = stretched(N, 1.3)
    vals = []
    for form in ("primal", "dual"):
        sg = HybridSolver3DGraded(
            H3.get_problem_3d("poisson_3d"),
            dataclasses.replace(cfg(), formulation=form), xs, s, s,
            device="cpu")
        assert bool(sg.solve().solve_ok.all())
        vals.append(sg.evaluate_solution(*query).numpy())
    np.testing.assert_allclose(vals[1], vals[0], atol=2e-5)


def test_graded3d_operators_convert_from_jax():
    """graded3d_operators_from_arrays on JAX's prepare_shared_3d_graded
    bundle equals the port's own precompute, field by field."""
    p = H3.get_problem_3d("poisson_3d")
    jops, (jt, jpts) = JHG.prepare_shared_3d_graded(
        JH3.get_problem_3d("poisson_3d"), cfg(False))
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()}
    got = convert.graded3d_operators_from_arrays(arrays, device="cpu",
                                                 dtype=torch.float64)
    ops, (t_int, spts) = HG.prepare_shared_3d_graded(p, cfg())
    for f in dataclasses.fields(ops):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   getattr(ops, f.name).numpy(), rtol=0,
                                   atol=1e-13)
    np.testing.assert_allclose(t_int, np.asarray(jt), atol=1e-15)
    np.testing.assert_allclose(spts, np.asarray(jpts), atol=0)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        HG.prepare_shared_3d_graded(H3.get_problem_3d("robin_3d"), cfg())
