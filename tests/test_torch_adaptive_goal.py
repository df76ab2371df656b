"""The port's slack-driven adaptivity (``models/adaptive.py``) and
goal-oriented DWR estimates and loops (``models/goal.py``, 1D, 2D, 3D and
semilinear) against the JAX package, at the sizes of
``tests/test_adaptive.py`` and ``tests/test_goal.py``.

Tolerances: 1D coefficients 1e-12 relative; the adaptive loops' node
sequences identical; the DWR estimators on the same solutions: totals,
cell and face terms and indicators 1e-10 relative to the size of what they
sum (``dwr_size_1d``: a real solution's face terms are differences of
derivatives ~1e8 times smaller than the derivatives; on random
coefficients, in 2D and 3D, the summed size of the terms).  Through each
package's own solves the 1e-12 agreement of the coefficients holds the
terms to 1e-8 of their summed size; 2D and 3D per-element
coefficients 1e-9 plus the larger of the two packages' own bc violations
(ROADMAP.md section 3).

The JAX solves run once per module (fixtures).  The JAX package compiles
each mesh shape of its adaptive loops anew (~15 s a round in 2D and 3D on
a CPU), so its 2D and 3D loops run here for one round from small meshes
(4 x 3 and 3 x 2 x 4, with their estimators under ``jax.jit``): the same
refined axes, and goals and estimates within ten times the relative
agreement of the solutions (1e-9 plus the bc violations, over the
coefficients' size).  The estimators are held against JAX on the same
solutions, and the port's loops to the reference tests' properties at
their sizes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import adaptive as JA
from hybrid_fem_lssvr_tpu.models import goal as JG
from hybrid_fem_lssvr_tpu.models import hybrid as JH
from hybrid_fem_lssvr_tpu.models import hybrid2d as JH2
from hybrid_fem_lssvr_tpu.models import hybrid3d as JH3
from hybrid_fem_lssvr_tpu.models import nonlinear as JN
from hybrid_fem_lssvr_tpu.models import problems as jprob
from hybrid_fem_lssvr_tpu.models.problem import Problem1D as JProblem1D

from hybrid_fem_lssvr_tpu_torch import (Problem1D, Solver2DConfig,
                                        Solver3DConfig, SolverConfig,
                                        adaptive_solve, get_problem_2d,
                                        get_problem_3d, goal_adaptive_solve,
                                        goal_adaptive_solve_2d,
                                        goal_adaptive_solve_3d, problems)
from hybrid_fem_lssvr_tpu_torch.models import adaptive as A
from hybrid_fem_lssvr_tpu_torch.models import goal as G
from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
from hybrid_fem_lssvr_tpu_torch.models import nonlinear as N

torch.set_num_threads(1)

PI = np.pi
X_EVAL = np.linspace(-1, 1, 801)


def rel_close(got, want, rtol=1e-12, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    size = float(np.max(np.abs(want))) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * size)


def close_per_element(got, want, bcv):
    """ROADMAP section 3's rule for the per-element float64 route."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-9 + bcv)


# ------------------------------------------------------------ adaptive 1D

def layer(backend):
    """tests/test_adaptive.py's atan layer (alpha = 40, x0 = 0.2)."""
    alpha, x0 = 40.0, 0.2
    if backend == "jax":
        xp, P = jnp, JProblem1D
    else:
        xp, P = torch, Problem1D

    def u(x):
        return xp.arctan(alpha * (x - x0))

    def f(x):
        s = x - x0
        return 2.0 * alpha**3 * s / (1.0 + alpha**2 * s**2) ** 2

    return P(name="atan_layer", f=f, g_left=float(np.arctan(alpha * -1.2)),
             g_right=float(np.arctan(alpha * 0.8)), exact=u,
             constant_coeffs=True)


@pytest.fixture(scope="module")
def jax_adaptive():
    return JA.adaptive_solve(layer("jax"), JH.SolverConfig(num_nodes=17),
                             rounds=6, refine_frac=0.25, eval_points=X_EVAL)


def test_refine_nodes_matches_jax():
    rng = np.random.default_rng(5)
    nodes = np.sort(rng.uniform(-1, 1, 40))
    ind = rng.integers(0, 5, 39).astype(float)  # many ties
    for frac in (0.1, 0.25, 0.3):
        np.testing.assert_array_equal(A.refine_nodes(nodes, ind, frac),
                                      JA.refine_nodes(nodes, ind, frac))
    out = A.refine_nodes(np.linspace(0, 1, 5), np.array([0.1, 5.0, 0.2, 0.3]),
                         refine_frac=0.25)
    assert out.shape[0] == 6 and 0.375 in out


def test_adaptive_solve_matches_jax(jax_adaptive):
    res = adaptive_solve(layer("torch"), SolverConfig(num_nodes=17),
                         rounds=6, refine_frac=0.25, eval_points=X_EVAL,
                         device="cpu")
    np.testing.assert_array_equal(res.nodes.numpy(),
                                  np.asarray(jax_adaptive.nodes))
    for t, j in zip(res.history, jax_adaptive.history):
        assert t["round"] == j["round"] and t["elements"] == j["elements"]
        # the slack is the residual of a near-exact fit: it carries the
        # coefficients' rounding times the operator rows' size (~(2/h)^2)
        assert abs(t["max_slack"] - j["max_slack"]) <= 1e-6 * j["max_slack"]
        assert abs(t["linf"] - j["linf"]) <= 1e-12 + 1e-9 * j["linf"]
    rel_close(res.solution.coeffs, jax_adaptive.solution.coeffs)
    # tests/test_adaptive.py's properties: nodes cluster at the layer and
    # the error falls.
    nodes = res.nodes.numpy()
    assert np.sum(np.abs(nodes - 0.2) < 0.1) > 2 * np.sum(
        np.abs(nodes + 0.6) < 0.1)
    errs = [h["linf"] for h in res.history]
    assert errs[-1] < 0.2 * errs[0]


# ----------------------------------------------------------------- goal 1D

X0, S = 0.3, 0.15


def j_torch(x):
    return torch.exp(-0.5 * ((x - X0) / S) ** 2)


def j_jax(x):
    return jnp.exp(-0.5 * ((x - X0) / S) ** 2)


def varb(backend):
    """tests/test_goal.py's variable-advection problem (b = x)."""
    xp, P = (jnp, JProblem1D) if backend == "jax" else (torch, Problem1D)
    return P(name="varb",
             f=lambda x: PI**2 * xp.sin(PI * x) + x * PI * xp.cos(PI * x),
             b=lambda x: x, exact=lambda x: xp.sin(PI * x))


def problem_1d(name, backend):
    if name == "varb":
        return varb(backend)
    return (jprob if backend == "jax" else problems).get(name)


def assert_dwr_close(t, j, rtol=1e-10, size=None):
    """Totals, terms and indicators relative to ``size`` (default: the
    summed size of the terms)."""
    if size is None:
        size = float(np.sum(np.abs(np.asarray(j.cell))))
        if hasattr(j, "face"):
            size += float(np.sum(np.abs(np.asarray(j.face))))
    if hasattr(j, "face"):
        rel_close(t.face, j.face, rtol, size)
    rel_close(t.cell, j.cell, rtol, size)
    rel_close(t.indicator, j.indicator, rtol, size)
    assert abs(float(t.total) - float(j.total)) <= rtol * size


def dwr_size_1d(primal, adjoint, f, a, q=8):
    """The size of what a 1D DWR estimate sums before it cancels: the cell
    integrals of |f| |z| and the face products |z| a (|u'_-| + |u'_+|)
    (a real solution's terms are differences ~1e8 times smaller)."""
    nodes, coeffs = primal.nodes, primal.coeffs
    tq, wq = G._gauss(q, coeffs.dtype, coeffs.device)
    x, _, ux, _ = G._series_on_gauss(nodes, coeffs, tq)
    _, z, _, _ = G._series_on_gauss(nodes, adjoint.coeffs, tq)
    h = nodes[1:] - nodes[:-1]
    cell = 0.5 * h * ((f(x).abs() * z.abs()) @ wq)
    zf = z.abs().amax(1)[:-1] * a * (ux.abs().amax(1)[:-1]
                                     + ux.abs().amax(1)[1:])
    return float(cell.sum() + zf.sum())


def port_solution_1d(sol):
    """A JAX 1D Solution as the port's."""
    return H.Solution(*(torch.tensor(np.asarray(v)) for v in sol[:6]))


@pytest.fixture(scope="module")
def jax_dwr_1d():
    cfg = JH.SolverConfig(num_nodes=9, M=8, gamma=1e4, dtype="float64")
    out = {}
    for name in ("poisson_1d", "advection_diffusion_1d", "varb"):
        p = problem_1d(name, "jax")
        nodes = jnp.linspace(-1.0, 1.0, 9, dtype=jnp.float64)
        ps = JH.HybridSolver(p, cfg, nodes=nodes).solve()
        ad = JH.HybridSolver(JG.adjoint_problem(p, j_jax), cfg,
                             nodes=nodes).solve()
        out[name] = (ps, ad, JG.dwr_estimate(p, ps, ad),
                     JG.goal_value(nodes, ps.coeffs, j_jax))
    return out


@pytest.mark.parametrize("name", ["poisson_1d", "advection_diffusion_1d",
                                  "varb"])
def test_dwr_estimate_1d_matches_jax(jax_dwr_1d, name):
    jps, jad, jest, jgoal = jax_dwr_1d[name]
    cfg = SolverConfig(num_nodes=9, M=8, gamma=1e4, dtype="float64")
    p = problem_1d(name, "torch")
    nodes = torch.linspace(-1.0, 1.0, 9, dtype=torch.float64)
    ps = H.HybridSolver(p, cfg, nodes=nodes, device="cpu").solve()
    ad = H.HybridSolver(G.adjoint_problem(p, j_torch), cfg, nodes=nodes,
                        device="cpu").solve()
    rel_close(ps.coeffs, jps.coeffs)
    rel_close(ad.coeffs, jad.coeffs)
    assert_dwr_close(G.dwr_estimate(p, ps, ad), jest, 1e-8)
    goal = float(G.goal_value(nodes, ps.coeffs, j_torch))
    assert abs(goal - float(jgoal)) <= 1e-12 * abs(float(jgoal))
    # the estimator alone, on JAX's own solutions
    assert_dwr_close(G.dwr_estimate(p, port_solution_1d(jps),
                                    port_solution_1d(jad)), jest,
                     size=dwr_size_1d(ps, ad, p.f, 1.0))


def test_adjoint_of_variable_advection_by_autograd():
    """c_adj = c - b' through torch.autograd, against the JAX package's
    jax.grad on the same points."""
    x = np.linspace(-1, 1, 7)
    t = G.adjoint_problem(varb("torch"), j_torch).c(torch.tensor(x))
    j = JG.adjoint_problem(varb("jax"), j_jax).c(jnp.asarray(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-15)
    with pytest.raises(ValueError, match="Dirichlet"):
        G.adjoint_problem(problems.poisson_neumann(), j_torch)


@pytest.fixture(scope="module")
def jax_goal_loop():
    cfg = JH.SolverConfig(num_nodes=9, M=8, gamma=1e4, dtype="float64")
    return JG.goal_adaptive_solve(jprob.poisson_1d(), j_jax, cfg, rounds=2,
                                  refine_frac=0.3, exact_goal=0.25)


def test_goal_adaptive_solve_matches_jax(jax_goal_loop):
    """tests/test_goal.py's loop (9 nodes, M = 8) for two rounds."""
    cfg = SolverConfig(num_nodes=9, M=8, gamma=1e4, dtype="float64")
    res = goal_adaptive_solve(problems.poisson_1d(), j_torch, cfg, rounds=2,
                              refine_frac=0.3, exact_goal=0.25,
                              device="cpu")
    np.testing.assert_array_equal(res.nodes.numpy(),
                                  np.asarray(jax_goal_loop.nodes))
    scale = max(abs(r["est_error"]) for r in jax_goal_loop.history)
    for t, j in zip(res.history, jax_goal_loop.history):
        assert t["elements"] == j["elements"]
        assert abs(t["goal"] - j["goal"]) <= 1e-12 * abs(j["goal"])
        assert abs(t["true_error"] - j["true_error"]) <= 1e-12
        assert abs(t["est_error"] - j["est_error"]) <= 1e-8 * scale
    rel_close(res.solution.coeffs, jax_goal_loop.solution.coeffs)
    rel_close(res.adjoint.coeffs, jax_goal_loop.adjoint.coeffs)


def test_goal_error_semilinear_matches_jax():
    """tests/test_goal.py's semilinear DWR (cubic_1d) at 9 nodes."""
    n = 9
    cfg = SolverConfig(num_nodes=n, M=8, gamma=1e4, dtype="float64")
    jcfg = JH.SolverConfig(num_nodes=n, M=8, gamma=1e4, dtype="float64")
    sol = N.hybrid_solve_semilinear(N.cubic_1d(), cfg, device="cpu")
    Jh, est, asol = G.goal_error_semilinear(N.cubic_1d(), sol, cfg, j_torch)
    jsol = JN.hybrid_solve_semilinear(JN.cubic_1d(), jcfg)
    jJh, jest, jasol = JG.goal_error_semilinear(JN.cubic_1d(), jsol, jcfg,
                                                j_jax)
    rel_close(asol.coeffs, jasol.coeffs)
    assert abs(float(Jh) - float(jJh)) <= 1e-12 * abs(float(jJh))
    assert_dwr_close(est, jest, 1e-8)
    assert_dwr_close(G.dwr_estimate_semilinear(
        N.cubic_1d(), N.SemilinearSolution(*(torch.tensor(np.asarray(v))
                                             for v in jsol)),
        port_solution_1d(jasol)), jest,
        size=dwr_size_1d(sol, asol, N.cubic_1d().f, 1.0))


# ---------------------------------------------------------------- goal 2D

def j2_torch(x, y):
    return torch.exp(-0.5 * (((x - 0.55) / 0.08) ** 2
                             + ((y - 0.55) / 0.08) ** 2))


def j2_jax(x, y):
    return jnp.exp(-0.5 * (((x - 0.55) / 0.08) ** 2
                           + ((y - 0.55) / 0.08) ** 2))


CFG2 = dict(nx=8, ny=8, M=6, n_colloc=6, dtype="float64", precond="jacobi")


def exact_goal_2d():
    tq, wq = np.polynomial.legendre.leggauss(200)
    X, Y = np.meshgrid(tq, tq)
    u = np.sin(PI * X) * np.sin(PI * Y)
    return float(np.sum(np.outer(wq, wq) * u
                        * np.asarray(j2_jax(jnp.asarray(X), jnp.asarray(Y)))))


def graded_nodes(n, power, seed):
    s = np.linspace(-1.0, 1.0, n + 1)
    s = np.sign(s) * np.abs(s) ** power
    rng = np.random.default_rng(seed)
    s[1:-1] += rng.uniform(-0.1, 0.1, n - 1) / n
    return np.sort(s)


def synthetic_2d(n, M, seed):
    """A graded-mesh 2D solution with random coefficients, as both
    packages' Solution2D."""
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import Solution2D

    rng = np.random.default_rng(seed)
    xs, ys = graded_nodes(n, 1.3, seed), graded_nodes(n + 1, 1.2, seed + 1)
    coeffs = rng.normal(size=(n + 1, n, M, M)) / (1.0 + np.arange(M)) ** 2
    fem = rng.normal(size=(n + 2, n + 1))
    t = Solution2D(*(torch.tensor(v) for v in (xs, ys, fem, coeffs)), 0,
                   torch.zeros(()), None, None, None)
    j = JH2.Solution2D(*(jnp.asarray(v) for v in (xs, ys, fem, coeffs)), 0,
                       jnp.zeros(()), None, None, None)
    return t, j


@pytest.mark.parametrize("name", ["poisson_2d", "advection_diffusion_2d",
                                  "variable_coeff_elliptic_2d"])
def test_dwr_estimate_2d_matches_jax(name):
    """dwr_estimate_2d and goal_value_2d on the same solutions (a primal on
    a graded mesh, an adjoint on its bisection, random coefficients)."""
    tp, jp = get_problem_2d(name), JH2.get_problem_2d(name)
    (tprim, jprim), (tadj, jadj) = synthetic_2d(6, 6, 0), synthetic_2d(12, 6,
                                                                       5)
    # (the JAX side under jax.jit: op by op it compiles ~10x longer)
    assert_dwr_close(G.dwr_estimate_2d(tp, tprim, tadj), jax.jit(
        lambda a, b: JG.dwr_estimate_2d(jp, a, b))(jprim, jadj))
    rel_close(G.goal_value_2d(tprim, j2_torch),
              jax.jit(lambda a: JG.goal_value_2d(a, j2_jax))(jprim))
    adj = G.adjoint_problem_2d(tp, j2_torch)
    assert adj.b == tuple(-b for b in tp.b) and adj.a_var is tp.a_var
    with pytest.raises(ValueError, match="Dirichlet"):
        G.adjoint_problem_2d(get_problem_2d("robin_2d"), j2_torch)
    xs = np.linspace(-1.0, 1.0, 9)
    np.testing.assert_array_equal(G._bisect(xs, 2), JG._bisect(xs, 2))


def test_goal_adaptive_solve_2d_converges_and_tracks():
    """tests/test_goal.py's 2D loop and properties, on the port."""
    res = goal_adaptive_solve_2d(get_problem_2d("poisson_2d"), j2_torch,
                                 Solver2DConfig(**CFG2), rounds=3,
                                 refine_frac=0.3, exact_goal=exact_goal_2d(),
                                 device="cpu")
    errs = [abs(r["true_error"]) for r in res.history]
    assert errs[-1] < 0.2 * errs[0], errs
    for r in res.history:
        assert abs(r["est_error"] - r["true_error"]) \
            < 0.35 * abs(r["true_error"]), r
    assert res.xs.shape[0] > 9 and res.ys.shape[0] > 9


def _estimator_jit(fn, problem, primal, adjoint, **kw):
    return jax.jit(lambda a, b: fn(problem, a, b, **kw))(primal, adjoint)


def _goal_jit(fn, sol, j, **kw):
    return jax.jit(lambda a: fn(a, j, **kw))(sol)


def bcv(*sols):
    return max(float(np.max(np.asarray(s.bc_violation))) for s in sols)


@pytest.mark.parametrize("dim", [2, 3])
def test_goal_adaptive_solve_nd_matches_jax(dim):
    """One round of the 2D (from 4 x 3) and 3D (from 3 x 2 x 4: no axis
    like another) goal loops against the JAX package's: the same per-axis
    marking (refined axes equal), the
    same element counts, the final primal and adjoint coefficients by
    ROADMAP section 3's rule, and each round's goal and estimate within ten
    times the solutions' relative agreement."""
    if dim == 2:
        kw = dict(nx=4, ny=3, M=6, n_colloc=6, dtype="float64",
                  precond="jacobi")
        problem, jproblem = get_problem_2d("poisson_2d"), \
            JH2.get_problem_2d("poisson_2d")
        loop, jloop = goal_adaptive_solve_2d, JG.goal_adaptive_solve_2d
        cfg, jcfg = Solver2DConfig(**kw), JH2.Solver2DConfig(**kw,
                                                             backend="xla")
        j, jj, axes = j2_torch, j2_jax, ("xs", "ys")
    else:
        kw = dict(nx=3, ny=2, nz=4, M=4, n_colloc=4, dtype="float64",
                  precond="jacobi")
        problem, jproblem = get_problem_3d("poisson_3d"), \
            JH3.get_problem_3d("poisson_3d")
        loop, jloop = goal_adaptive_solve_3d, JG.goal_adaptive_solve_3d
        cfg, jcfg = Solver3DConfig(**kw), JH3.Solver3DConfig(**kw,
                                                             backend="xla")
        j, jj, axes = j3_torch, j3_jax, ("xs", "ys", "zs")
    with pytest.MonkeyPatch.context() as mp:
        for name, wrap in ((f"dwr_estimate_{dim}d", _estimator_jit),
                           (f"goal_value_{dim}d", _goal_jit)):
            mp.setattr(JG, name, functools.partial(wrap, getattr(JG, name)))
        want = jloop(jproblem, jj, jcfg, rounds=1, refine_frac=0.3)
    got = loop(problem, j, cfg, rounds=1, refine_frac=0.3, device="cpu")
    for a in axes:
        np.testing.assert_array_equal(np.asarray(getattr(got, a)),
                                      np.asarray(getattr(want, a)))
    assert getattr(got, axes[0]).shape[0] > kw["nx"] + 1
    for part in ("solution", "adjoint"):
        t, w = getattr(got, part), getattr(want, part)
        close_per_element(t.coeffs, w.coeffs, bcv(t, w))
    sol = want.solution
    rel = 10 * (1e-9 + bcv(got.solution, sol)) / float(
        np.max(np.abs(np.asarray(sol.coeffs))))
    scale = max(abs(r["est_error"]) for r in want.history)
    for t, w in zip(got.history, want.history):
        assert t["elements"] == w["elements"]
        assert abs(t["goal"] - w["goal"]) <= rel * abs(w["goal"])
        assert abs(t["est_error"] - w["est_error"]) <= rel * scale


# ---------------------------------------------------------------- goal 3D

def j3_torch(x, y, z):
    return torch.exp(-0.5 * (((x - 0.45) ** 2 + (y - 0.45) ** 2
                              + (z - 0.45) ** 2) / 0.15 ** 2))


def j3_jax(x, y, z):
    return jnp.exp(-0.5 * (((x - 0.45) ** 2 + (y - 0.45) ** 2
                            + (z - 0.45) ** 2) / 0.15 ** 2))


def synthetic_3d(n, M, seed):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import Solution3D

    rng = np.random.default_rng(seed)
    xs, ys, zs = (graded_nodes(n + k, 1.1 + 0.1 * k, seed + k)
                  for k in range(3))
    deg = 1.0 + np.arange(M)
    coeffs = rng.normal(size=(n + 2, n + 1, n, M, M, M)) / deg**2
    fem = rng.normal(size=(n + 3, n + 2, n + 1))
    t = Solution3D(*(torch.tensor(v) for v in (xs, ys, zs, fem, coeffs)), 0,
                   torch.zeros(()), None, None, None)
    j = JH3.Solution3D(*(jnp.asarray(v) for v in (xs, ys, zs, fem, coeffs)),
                       0, jnp.zeros(()), None, None, None)
    return t, j


@pytest.mark.parametrize("name", ["poisson_3d", "advection_diffusion_3d",
                                  "variable_coeff_elliptic_3d"])
def test_dwr_estimate_3d_matches_jax(name):
    tp, jp = get_problem_3d(name), JH3.get_problem_3d(name)
    (tprim, jprim), (tadj, jadj) = synthetic_3d(3, 4, 0), synthetic_3d(6, 4,
                                                                       9)
    assert_dwr_close(G.dwr_estimate_3d(tp, tprim, tadj), jax.jit(
        lambda a, b: JG.dwr_estimate_3d(jp, a, b))(jprim, jadj))
    rel_close(G.goal_value_3d(tprim, j3_torch),
              jax.jit(lambda a: JG.goal_value_3d(a, j3_jax))(jprim))
    adj = G.adjoint_problem_3d(tp, j3_torch)
    assert adj.b == tuple(-b for b in tp.b) and adj.a_var is tp.a_var
    with pytest.raises(ValueError, match="Dirichlet"):
        G.adjoint_problem_3d(get_problem_3d("robin_3d"), j3_torch)


def test_goal_adaptive_solve_3d_converges():
    """tests/test_goal.py's 3D loop and properties (6^3, M = C = 4, two
    rounds), on the port."""
    tq, wq = np.polynomial.legendre.leggauss(80)
    X, Y, Z = np.meshgrid(tq, tq, tq, indexing="ij")
    W = wq[:, None, None] * wq[None, :, None] * wq[None, None, :]
    ue = np.sin(PI * X) * np.sin(PI * Y) * np.sin(PI * Z)
    jz = np.exp(-0.5 * ((X - 0.45) ** 2 + (Y - 0.45) ** 2
                        + (Z - 0.45) ** 2) / 0.15 ** 2)
    cfg = Solver3DConfig(nx=6, ny=6, nz=6, M=4, n_colloc=4,
                         precond="jacobi", dtype="float64")
    res = goal_adaptive_solve_3d(get_problem_3d("poisson_3d"), j3_torch, cfg,
                                 rounds=2,
                                 exact_goal=float(np.sum(W * ue * jz)),
                                 device="cpu")
    errs = [abs(r["true_error"]) for r in res.history]
    assert errs[-1] < 0.05 * errs[0], errs
    for r in res.history[:2]:
        assert abs(r["est_error"] - r["true_error"]) \
            < 0.35 * abs(r["true_error"]), r
