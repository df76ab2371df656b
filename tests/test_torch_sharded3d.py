"""The port's distributed 3D solves (z-slabs, the 2 x 2 (z, y) grid,
graded z-slabs) on four ``gloo`` ranks on the CPU, against the JAX
package on the conftest's virtual CPU devices and against the port's
single-device solvers.

One set of ranks (``_torch_ranks.py``, no JAX) runs every case in the
``ranks`` fixture.  Each JAX entry point is built once, in float64 with
Jacobi preconditioning; the V-cycle, compact-lift, non-SPD and
variable-coefficient variants are held to the port's single-device
solvers.  Tolerances as in ``test_torch_sharded2d.py``: equal CG counts
against JAX (within one against the single-device solvers), nodal values
1e-10 (1e-12 graded), coefficients 1e-9 of their size (plus the larger bc
violation on the per-element routes), evaluations 1e-12.
"""

import numpy as np
import pytest
import torch

import _torch_ranks as R

torch.set_num_threads(1)

CASES = ("sharded_3d", "sharded_3d_variants", "sharded_3d_rejects")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's ranks, started before its JAX builds so that the two
    overlap."""
    ranks = R.Ranks(4, "_torch_ranks", CASES,
                    tmp_path_factory.mktemp("ranks_3d"))
    yield ranks
    ranks.stop()


@pytest.fixture(scope="module")
def ranks(started, jax_3d):
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


def bcv_of(*arrays):
    return max(float(np.max(np.asarray(a))) for a in arrays)


def test_ranks_load_no_jax(ranks):
    assert ranks["_modules"] == []


# ---- against the JAX package ----------------------------------------------

def _jax_cfg(**kw):
    from hybrid_fem_lssvr_tpu.models.hybrid3d import Solver3DConfig

    base = dict(nx=4, ny=4, nz=8, M=3, n_colloc=3, precond="jacobi")
    base.update(kw)
    return Solver3DConfig(**base)


@pytest.fixture(scope="module")
def jax_3d(started):
    """The three JAX solves and their read paths, built once."""
    from hybrid_fem_lssvr_tpu.models.hybrid3d import poisson_3d
    from hybrid_fem_lssvr_tpu.parallel import mesh as jm
    from hybrid_fem_lssvr_tpu.parallel import sharded3d as J3

    x, y, z = R.eval_points(dim=3)
    p = poisson_3d()

    def at_points(ev):
        return lambda coeffs: np.asarray(ev(coeffs, x, y, z))

    out = {}
    m = jm.element_mesh(4)
    s = J3.make_sharded_solve_3d(p, _jax_cfg(), m)()
    out["slab"] = (s, at_points(J3.make_sharded_evaluate_3d(p, _jax_cfg(),
                                                            m)))
    g = jm.grid_mesh_3d(2, 2)
    cfg = _jax_cfg(nz=4)
    s = J3.make_sharded_solve_3d_grid(p, cfg, g)()
    out["grid"] = (s, at_points(J3.make_sharded_evaluate_3d_grid(p, cfg, g)))
    xs, ys, zs = R.graded_mesh_3d()
    s = J3.make_sharded_solve_3d_graded(p, _jax_cfg(), m, xs, ys, zs)()
    out["graded_poisson_3d"] = (s, at_points(
        J3.make_sharded_evaluate_3d_graded(_jax_cfg(), m, xs, ys, zs)))
    return out


@pytest.mark.parametrize("key", ["slab", "grid"])
def test_sharded_solve_3d_matches_jax(ranks, jax_3d, key):
    """make_sharded_solve_3d (four z-slabs) and make_sharded_solve_3d_grid
    (2 x 2): equal CG counts, nodal values 1e-10, coefficients 1e-9."""
    out = case(ranks, "sharded_3d")[key]
    sol = jax_3d[key][0]
    np.testing.assert_array_equal(out["cg_iters"].reshape(-1),
                                  np.asarray(sol.cg_iters).reshape(-1))
    rel_close(out["grid"], sol.assemble_fem_grid(), 1e-10)
    rel_close(out["coeffs"], sol.coeffs, 1e-9)
    np.testing.assert_allclose(out["bc_violation"], sol.bc_violation,
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(out["solve_ok"], np.asarray(sol.solve_ok))


def test_sharded_solve_3d_graded_matches_jax(ranks, jax_3d):
    out = case(ranks, "sharded_3d")["graded_poisson_3d"]
    sol = jax_3d["graded_poisson_3d"][0]
    np.testing.assert_array_equal(out["cg_iters"], np.asarray(sol.cg_iters))
    rel_close(out["grid"], sol.assemble_fem_grid(), 1e-12)
    rel_close(out["coeffs"], sol.coeffs, 1e-9,
              atol=bcv_of(out["bc_violation"], sol.bc_violation))
    assert out["solve_ok"].all()


@pytest.mark.parametrize("key", ["slab", "grid", "graded_poisson_3d"])
def test_sharded_evaluate_3d_matches_jax(ranks, jax_3d, key):
    """make_sharded_evaluate_3d / _grid / _graded against JAX's, both on
    the port's gathered coefficients (points outside the domain
    included)."""
    out = case(ranks, "sharded_3d")[key]
    rel_close(out["u"], jax_3d[key][1](out["coeffs"]), 1e-12)


# ---- against the port's single-device solvers -----------------------------

PER_ELEMENT = {"varcoeff", "grid_varcoeff"}
# The shifted-Helmholtz BiCGStab stops at its residual; two summation
# orders part there by ~1e-12 of the nodal values, amplified by the
# enhancement.
COEFF_TOL = {"helmholtz_shifted": 1e-8}


@pytest.mark.parametrize("key,name,over", [v[:3] for v in R.VARIANTS_3D],
                         ids=[v[0] for v in R.VARIANTS_3D])
def test_variants_match_single_device(ranks, key, name, over):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import (
        HybridSolver3D, get_problem_3d)

    out = case(ranks, "sharded_3d_variants")[key]
    ref = HybridSolver3D(get_problem_3d(name), R.cfg_3d(**over),
                         device="cpu").solve()
    assert abs(int(out["cg_iters"].reshape(-1)[0]) - ref.cg_iters) <= 1
    assert len(set(out["cg_iters"].reshape(-1).tolist())) == 1
    rel_close(out["grid"], ref.fem_values, 1e-10)
    bcv = bcv_of(out["bc_violation"], ref.bc_violation.numpy()) \
        if key in PER_ELEMENT else 0.0
    rel_close(out["coeffs"], ref.coeffs, COEFF_TOL.get(key, 1e-9), atol=bcv)
    assert out["solve_ok"].all()


def test_graded_varcoeff_matches_single_device(ranks):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import get_problem_3d
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d_graded import (
        HybridSolver3DGraded)

    out = case(ranks, "sharded_3d")["graded_variable_coeff_elliptic_3d"]
    ref = HybridSolver3DGraded(get_problem_3d("variable_coeff_elliptic_3d"),
                               R.cfg_3d(), *R.graded_mesh_3d(),
                               device="cpu").solve()
    assert abs(int(out["cg_iters"][0]) - ref.cg_iters) <= 1
    rel_close(out["grid"], ref.fem_values, 1e-12)
    rel_close(out["coeffs"], ref.coeffs, 1e-9,
              atol=bcv_of(out["bc_violation"], ref.bc_violation.numpy()))


def test_rejects_mixed_bcs_indivisible_and_graded_compact(ranks):
    out = case(ranks, "sharded_3d_rejects")
    assert list(out["raised"]) == ["NotImplementedError", "ValueError",
                                   "ValueError", "NotImplementedError",
                                   "ValueError"]
