"""The port's semilinear solves (``models/nonlinear.py``) against the JAX
package at ``tests/test_nonlinear.py``'s sizes, float64 on the CPU.

1D: coefficients and nodal values to 1e-12 relative, the Newton residual
history to 1e-12 of its first entry.  2D and 3D: the coarse Newton iterate
to 1e-12 relative; the element-level coefficients (the per-element float64
route, five Newton steps) to 1e-9 plus the larger of the two packages' own
trace violations (ROADMAP.md section 3).  The final collocation residual is
the residual of a near-exact fit, rounding times the operator rows' size,
and is held to 1e-6 of its value.  The JAX solves run once per module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import nonlinear as JN
from hybrid_fem_lssvr_tpu.models.hybrid import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models.hybrid2d import Solver2DConfig as J2Config
from hybrid_fem_lssvr_tpu.models.hybrid3d import Solver3DConfig as J3Config

from hybrid_fem_lssvr_tpu_torch import (HybridSolver, Solver2DConfig,
                                        Solver3DConfig, SolverConfig,
                                        problems)
from hybrid_fem_lssvr_tpu_torch.models import nonlinear as N
from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import _element_data_2d
from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import _element_data_3d

torch.set_num_threads(1)

X = np.linspace(-1, 1, 401)
CASES_1D = [("cubic_1d", "p1"), ("bratu_1d", "p1"), ("cubic_1d", "numerov"),
            ("bratu_1d", "numerov")]


def rel_close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


def solve_1d(name, E, scheme="p1"):
    sol = N.hybrid_solve_semilinear(getattr(N, name)(),
                                    SolverConfig(num_nodes=E + 1, M=8,
                                                 gamma=1e4),
                                    scheme=scheme, device="cpu")
    u = N.evaluate_semilinear(sol, torch.tensor(X))
    return sol, float(np.abs(u.numpy() - np.sin(np.pi * X)).max())


@pytest.fixture(scope="module")
def jax_1d():
    return {(name, scheme): JN.hybrid_solve_semilinear(
        getattr(JN, name)(), JConfig(num_nodes=17, M=8, gamma=1e4),
        scheme=scheme) for name, scheme in CASES_1D}


@pytest.mark.parametrize("name,scheme", CASES_1D)
def test_semilinear_1d_matches_jax(jax_1d, name, scheme):
    j = jax_1d[(name, scheme)]
    t, _ = solve_1d(name, 16, scheme)
    rel_close(t.coeffs, j.coeffs)
    rel_close(t.fem_values, j.fem_values)
    r, jr = t.newton_residuals.numpy(), np.asarray(j.newton_residuals)
    assert r.shape == jr.shape == (8,)
    np.testing.assert_allclose(r, jr, rtol=0, atol=1e-12 * jr[0])
    assert abs(float(t.colloc_residual) - float(j.colloc_residual)) <= \
        1e-6 * float(j.colloc_residual)
    np.testing.assert_array_equal(t.solve_ok.numpy(), np.asarray(j.solve_ok))


@pytest.mark.parametrize("name", ["cubic_1d", "bratu_1d"])
def test_newton_quadratic_and_h2_floor(name):
    """tests/test_nonlinear.py's properties on the port: quadratic
    contraction, the hybrid at the P1 nodal floor, O(h^2)."""
    sol, linf = solve_1d(name, 16)
    r = sol.newton_residuals.numpy()
    assert r[1] < 0.3 * r[0] and r[2] < 0.1 * r[1] and r[3] < 1e-5
    assert r[-1] < 1e-12
    assert bool(sol.solve_ok.all())
    assert float(sol.colloc_residual) < 1e-6
    nodal = float((sol.fem_values - torch.sin(torch.pi * sol.nodes))
                  .abs().max())
    assert linf < 1.5 * nodal + 1e-12
    _, linf32 = solve_1d(name, 32)
    assert 1.6 < np.log2(linf / linf32) < 2.4
    _, e16 = solve_1d(name, 16, "numerov")
    _, e32 = solve_1d(name, 32, "numerov")
    assert 3.4 < np.log2(e16 / e32) < 4.6 and e32 < 1e-5


def test_semilinear_reduces_to_linear():
    """s == 0 reproduces the linear Poisson hybrid solve."""
    pi = torch.pi
    prob = N.SemilinearProblem1D(
        name="poisson_as_semilinear", s=lambda u: 0.0 * u,
        ds=lambda u: 0.0 * u, f=lambda x: pi**2 * torch.sin(pi * x),
        exact=lambda x: torch.sin(pi * x))
    sol = N.hybrid_solve_semilinear(prob, SolverConfig(num_nodes=25, M=8,
                                                       gamma=1e4),
                                    device="cpu")
    u = N.evaluate_semilinear(sol, torch.tensor(X))
    linf = float(np.abs(u.numpy() - np.sin(np.pi * X)).max())
    lin = HybridSolver(problems.poisson_1d(), SolverConfig(num_nodes=25, M=8,
                                                          gamma=1e4),
                       device="cpu")
    lin.solve()
    assert abs(linf - float(lin.errors(X)[0])) < 1e-9


# ------------------------------------------------------------- 2D and 3D

CASES = [("p1", 0), ("numerov", 6)]


def trace_violation(w, parts, bc_rows):
    B = parts[2]
    return float((w.reshape(w.shape[0], -1) @ B.T - bc_rows).abs().max())


@pytest.fixture(scope="module")
def jax_2d():
    return {case: JN.hybrid_solve_semilinear_2d(
        JN.cubic_2d(), J2Config(nx=8, ny=8, M=6, n_colloc=6),
        scheme=case[0], trace_lift=case[1]) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_semilinear_2d_matches_jax(jax_2d, case):
    j = jax_2d[case]
    cfg = Solver2DConfig(nx=8, ny=8, M=6, n_colloc=6)
    t = N.hybrid_solve_semilinear_2d(N.cubic_2d(), cfg, scheme=case[0],
                                     trace_lift=case[1], device="cpu")
    rel_close(t.fem_values, j.fem_values)
    np.testing.assert_allclose(t.newton_residuals.numpy(),
                               np.asarray(j.newton_residuals), rtol=0,
                               atol=1e-12 * float(j.newton_residuals[0]))
    *parts, t_int, bpts = N._semilinear2d_element_parts_host(
        N.cubic_2d(), cfg, torch.float64)
    _, bc_rows, _ = _element_data_2d(N._P2DStub(N.cubic_2d()), cfg, t.xs,
                                     t.ys, t.fem_values, t_int, bpts,
                                     trace_lift=case[1], skip_f=True)
    E = 64
    bcv = max(trace_violation(t.coeffs.reshape(E, -1), parts, bc_rows),
              trace_violation(torch.tensor(np.asarray(j.coeffs)).reshape(
                  E, -1), parts, bc_rows))
    np.testing.assert_allclose(t.coeffs.numpy(), np.asarray(j.coeffs),
                               rtol=0, atol=1e-9 + bcv)
    assert abs(float(t.colloc_residual) - float(j.colloc_residual)) <= \
        1e-6 * float(j.colloc_residual)
    assert bool(t.solve_ok.all())
    rng = np.random.default_rng(2)
    xq, yq = rng.uniform(-1, 1, 2000), rng.uniform(-1, 1, 2000)
    u = N.evaluate_semilinear_2d(t, torch.tensor(xq), torch.tensor(yq))
    ju = JN.evaluate_semilinear_2d(j, jnp.asarray(xq), jnp.asarray(yq))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                               atol=4 * (1e-9 + bcv))


@pytest.fixture(scope="module")
def jax_3d():
    return {case: JN.hybrid_solve_semilinear_3d(
        JN.cubic_3d(), J3Config(nx=8, ny=8, nz=8, M=4, n_colloc=4),
        scheme=case[0], trace_lift=case[1]) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_semilinear_3d_matches_jax(jax_3d, case):
    j = jax_3d[case]
    cfg = Solver3DConfig(nx=8, ny=8, nz=8, M=4, n_colloc=4)
    t = N.hybrid_solve_semilinear_3d(N.cubic_3d(), cfg, scheme=case[0],
                                     trace_lift=case[1], device="cpu")
    rel_close(t.fem_values, j.fem_values)
    np.testing.assert_allclose(t.newton_residuals.numpy(),
                               np.asarray(j.newton_residuals), rtol=0,
                               atol=1e-12 * float(j.newton_residuals[0]))
    *parts, t_int, spts = N._semilinear3d_element_parts_host(
        N.cubic_3d(), cfg, torch.float64)
    _, bc_rows, _ = _element_data_3d(N._P3DStub(N.cubic_3d()), cfg, t.xs,
                                     t.ys, t.zs, t.fem_values, t_int, spts,
                                     trace_lift=case[1])
    E = 512
    bcv = max(trace_violation(t.coeffs.reshape(E, -1), parts, bc_rows),
              trace_violation(torch.tensor(np.asarray(j.coeffs)).reshape(
                  E, -1), parts, bc_rows))
    np.testing.assert_allclose(t.coeffs.numpy(), np.asarray(j.coeffs),
                               rtol=0, atol=1e-9 + bcv)
    assert abs(float(t.colloc_residual) - float(j.colloc_residual)) <= \
        1e-6 * float(j.colloc_residual)
    assert bool(t.solve_ok.all())
    rng = np.random.default_rng(2)
    q = [rng.uniform(-1, 1, 2000) for _ in range(3)]
    u = N.evaluate_semilinear_3d(t, *(torch.tensor(v) for v in q))
    ju = JN.evaluate_semilinear_3d(j, *(jnp.asarray(v) for v in q))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                               atol=4 * (1e-9 + bcv))


@pytest.mark.parametrize("dim", [2])
def test_semilinear_converges_at_second_order(dim):
    """tests/test_nonlinear.py's 2D convergence check on the port:
    quadratic coarse Newton, O(h^2) between 8 and 16 elements an axis (the
    3D one, 12 s at 16^3 on a CPU, is left to the reference: the 3D solve
    is held against it above)."""
    rng = np.random.default_rng(2)
    q = [torch.tensor(rng.uniform(-1, 1, 2000)) for _ in range(dim)]
    errs = {}
    for n in (8, 16):
        if dim == 2:
            p = N.cubic_2d()
            sol = N.hybrid_solve_semilinear_2d(
                p, Solver2DConfig(nx=n, ny=n, M=6, n_colloc=6), device="cpu")
            u = N.evaluate_semilinear_2d(sol, *q)
        else:
            p = N.cubic_3d()
            sol = N.hybrid_solve_semilinear_3d(
                p, Solver3DConfig(nx=n, ny=n, nz=n, M=4, n_colloc=4),
                device="cpu")
            u = N.evaluate_semilinear_3d(sol, *q)
        errs[n] = float((u - p.exact(*q)).abs().max())
        r = sol.newton_residuals.numpy()
        assert r[3] < 1e-6 and r[-1] < 1e-12
        assert bool(sol.solve_ok.all())
    assert 1.6 < np.log2(errs[8] / errs[16]) < 2.6, errs


def test_non_positive_definite_element_is_flagged():
    """An element whose I + gamma D^T D is not positive definite in float64
    gets a NaN factor, as jnp.linalg.cholesky returns, so its solve is NaN
    and solve_ok flags it; the batch's other elements solve as before
    (torch's cholesky would raise for the whole batch).  The float64 2D
    semilinear element Newton meets this from 128^2 on (its rows grow like
    (2/h)^2); like the JAX package's, it keeps no fallback, so exactly the
    flagged elements end NaN."""
    from hybrid_fem_lssvr_tpu_torch.ops import kkt

    rng = np.random.default_rng(0)
    A = rng.normal(size=(2, 6, 6))
    H = torch.tensor(A @ A.transpose(0, 2, 1) + np.eye(6))
    H[1, 2, 2] = -1.0  # indefinite
    L, s = kkt._equilibrated_cholesky_factor(H)
    assert bool(torch.isnan(L[1]).all()) and bool(torch.isfinite(L[0]).all())
    S = torch.diag(s[0])
    np.testing.assert_allclose((L[0] @ L[0].T).numpy(),
                               (S @ H[0] @ S).numpy(), atol=1e-12)
    sol = N.hybrid_solve_semilinear_2d(
        N.cubic_2d(), Solver2DConfig(nx=128, ny=128, M=6, n_colloc=6,
                                     cg_maxiter=40000), device="cpu")
    ok = sol.solve_ok
    assert 0 < int((~ok).sum()) < ok.numel()
    assert torch.equal(ok, torch.isfinite(sol.coeffs).all(-1).all(-1))
