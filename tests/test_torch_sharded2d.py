"""The port's distributed 2D solves (y-slabs, the 2 x 2 grid, graded
slabs) on four ``gloo`` ranks on the CPU, against the JAX package on the
conftest's virtual CPU devices and against the port's single-device
solvers.

One set of ranks (``_torch_ranks.py``, no JAX) runs every case in the
``ranks`` fixture.  Each JAX entry point is built once, at D = 4 or 2 x 2,
in float64 with Jacobi preconditioning (its distributed V-cycle compiles
for tens of seconds; the port's V-cycle, ADI, compact-lift and non-SPD
variants are held to the port's single-device solvers, which are held to
JAX by their own tests).

Tolerances, each as the JAX package's own tests of these paths set them
or tighter: the distributed CG paths keep the iteration counts (to one
iteration against the single-device solvers, whose inner products sum in
another order) and the nodal values to 1e-10; the coefficients follow
within 1e-9 of their size, and the evaluations to 1e-12 of theirs.  The
graded paths factor H = I + gamma D^T D per element (condition ~1e16):
their coefficients are held to 1e-9 of their size plus the larger of the
two solves' bc violations (ROADMAP section 3), the nodal values to 1e-12.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as R

torch.set_num_threads(1)

CASES = ("sharded_2d", "sharded_2d_variants", "sharded_2d_rejects")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's ranks, started before its JAX builds so that the two
    overlap."""
    ranks = R.Ranks(4, "_torch_ranks", CASES,
                    tmp_path_factory.mktemp("ranks_2d"))
    yield ranks
    ranks.stop()


@pytest.fixture(scope="module")
def ranks(started, jax_2d):
    return started.results()


def case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def rel_close(got, want, rtol, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    bound = rtol * float(np.max(np.abs(want))) + atol
    assert err <= bound, f"max err {err:.3e} > {bound:.3e}"


def test_ranks_load_no_jax(ranks):
    assert ranks["_modules"] == []


# ---- against the JAX package ----------------------------------------------

def _jax_cfg(**kw):
    from hybrid_fem_lssvr_tpu.models.hybrid2d import Solver2DConfig

    base = dict(nx=8, ny=8, M=4, n_colloc=4, precond="jacobi")
    base.update(kw)
    return Solver2DConfig(**base)


@pytest.fixture(scope="module")
def jax_2d(started):
    """The three JAX solves and their evaluations, built once."""
    from hybrid_fem_lssvr_tpu.models.hybrid2d import poisson_2d
    from hybrid_fem_lssvr_tpu.parallel import mesh as jm
    from hybrid_fem_lssvr_tpu.parallel import sharded2d as J2

    x, y = R.eval_points()
    p = poisson_2d()
    out = {}

    def at_points(ev):
        return lambda coeffs: np.asarray(ev(coeffs, x, y))

    m = jm.element_mesh(4)
    s = J2.make_sharded_solve_2d(p, _jax_cfg(), m)()
    out["slab"] = (s, s.assemble_fem_grid(total_ny=8), at_points(
        J2.make_sharded_evaluate_2d(p, _jax_cfg(), m)))
    g = jm.grid_mesh(2, 2)
    s = J2.make_sharded_solve_2d_grid(p, _jax_cfg(), g)()
    out["grid"] = (s, s.assemble_fem_grid(), at_points(
        J2.make_sharded_evaluate_2d_grid(p, _jax_cfg(), g)))
    xs, ys = R.graded_nodes(10), R.graded_nodes(8, seed=8)
    cfg = _jax_cfg(nx=10)
    s = J2.make_sharded_solve_2d_graded(p, cfg, m, xs, ys)()
    out["graded_poisson_2d"] = (s, s.assemble_fem_grid(), at_points(
        J2.make_sharded_evaluate_2d_graded(cfg, m, xs, ys)))
    return out


@pytest.mark.parametrize("key", ["slab", "grid"])
def test_sharded_solve_2d_matches_jax(ranks, jax_2d, key):
    """make_sharded_solve_2d (four slabs) and make_sharded_solve_2d_grid
    (2 x 2) against JAX: equal CG counts, nodal values 1e-10."""
    out = case(ranks, "sharded_2d")[key]
    sol, grid, _ = jax_2d[key]
    np.testing.assert_array_equal(out["cg_iters"].reshape(-1),
                                  np.asarray(sol.cg_iters).reshape(-1))
    rel_close(out["grid"][:9], grid, 1e-10)
    rel_close(out["coeffs"], sol.coeffs, 1e-9)
    np.testing.assert_allclose(out["bc_violation"], sol.bc_violation,
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(out["solve_ok"], np.asarray(sol.solve_ok))


def test_sharded_solve_2d_graded_matches_jax(ranks, jax_2d):
    out = case(ranks, "sharded_2d")["graded_poisson_2d"]
    sol, grid, _ = jax_2d["graded_poisson_2d"]
    np.testing.assert_array_equal(out["cg_iters"],
                                  np.asarray(sol.cg_iters))
    rel_close(out["grid"], grid, 1e-12)
    bcv = max(float(np.max(out["bc_violation"])),
              float(np.max(sol.bc_violation)))
    rel_close(out["coeffs"], sol.coeffs, 1e-9, atol=bcv)
    assert out["solve_ok"].all()


@pytest.mark.parametrize("key", ["slab", "grid", "graded_poisson_2d"])
def test_sharded_evaluate_2d_matches_jax(ranks, jax_2d, key):
    """make_sharded_evaluate_2d / _grid / _graded against JAX's, both on
    the port's gathered coefficients, points outside the domain included
    (the clamp)."""
    out = case(ranks, "sharded_2d")[key]
    rel_close(out["u"], jax_2d[key][2](out["coeffs"]), 1e-12)


# ---- against the port's single-device solvers -----------------------------

def _single(name, **over):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import (
        HybridSolver2D, get_problem_2d)

    return HybridSolver2D(get_problem_2d(name), R.cfg_2d(**over),
                          device="cpu").solve()


# Coefficient tolerances (of their size): 1e-9 in general; the shifted
# Helmholtz BiCGStab stops at its residual, where two summation orders
# part by ~1e-12 of the nodal values and the enhancement amplifies that.
# Variable coefficients take the per-element route (condition ~1e16): 1e-9
# plus the larger bc violation, as the graded solves.
COEFF_TOL = {"helmholtz_shifted": 1e-8, "grid_shifted": 1e-8}
PER_ELEMENT = {"varcoeff_mg", "grid_varcoeff"}


@pytest.mark.parametrize("key,name,over", [v[:3] for v in R.VARIANTS_2D],
                         ids=[v[0] for v in R.VARIANTS_2D])
def test_variants_match_single_device(ranks, key, name, over):
    out = case(ranks, "sharded_2d_variants")[key]
    ref = _single(name, **over)
    ny = ref.coeffs.shape[0]
    assert abs(int(out["cg_iters"].reshape(-1)[0]) - ref.cg_iters) <= 1
    assert len(set(out["cg_iters"].reshape(-1).tolist())) == 1
    rel_close(out["grid"][:ny + 1], ref.fem_values, 1e-10)
    bcv = 0.0
    if key in PER_ELEMENT:
        bcv = max(float(np.max(out["bc_violation"])),
                  float(np.max(ref.bc_violation.numpy())))
    rel_close(out["coeffs"], ref.coeffs, COEFF_TOL.get(key, 1e-9), atol=bcv)
    assert out["solve_ok"].all()


def test_graded_varcoeff_matches_single_device(ranks):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d_graded import (
        HybridSolver2DGraded)

    out = case(ranks, "sharded_2d")["graded_variable_coeff_elliptic_2d"]
    xs, ys = R.graded_nodes(10), R.graded_nodes(8, seed=8)
    ref = HybridSolver2DGraded(get_problem_2d("variable_coeff_elliptic_2d"),
                               R.cfg_2d(nx=10), xs, ys,
                               device="cpu").solve()
    assert abs(int(out["cg_iters"][0]) - ref.cg_iters) <= 1
    rel_close(out["grid"], ref.fem_values, 1e-12)
    bcv = max(float(np.max(out["bc_violation"])),
              float(np.max(ref.bc_violation.numpy())))
    rel_close(out["coeffs"], ref.coeffs, 1e-9, atol=bcv)


def test_rejects_mixed_bcs_compact_varcoeff_and_indivisible(ranks):
    out = case(ranks, "sharded_2d_rejects")
    assert list(out["raised"]) == ["NotImplementedError", "ValueError",
                                   "ValueError", "ValueError",
                                   "NotImplementedError"]
