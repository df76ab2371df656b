"""The port's 1D solver end to end, against JAX's ``HybridSolver`` and the
reference numbers (BASELINE.md, tests/test_poisson1d.py).

float64 comparisons hold to about 1e-12 relative (the same algorithms on
both sides).  float32 comparisons run the port's torch route against JAX's
XLA route; both solve the coarse system in float32, whose round-off grows
with the element count, so their tolerance is stated per test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu import HybridSolver as JSolver
from hybrid_fem_lssvr_tpu import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models import hybrid as JH
from hybrid_fem_lssvr_tpu.models import problems as jprob

from hybrid_fem_lssvr_tpu_torch import HybridSolver, SolverConfig, problems
from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
from hybrid_fem_lssvr_tpu_torch.utils import convert, metrics

torch.set_num_threads(1)

TEST_POINTS = np.linspace(-1, 1, 201)  # the reference's evaluation grid


def port_solve(name="poisson_1d", nodes=None, **cfg):
    s = HybridSolver(problems.get(name), SolverConfig(**cfg), nodes=nodes,
                     device="cpu")
    s.solve()
    return s


def jax_solve(name="poisson_1d", nodes=None, **cfg):
    s = JSolver(jprob.get(name), JConfig(**cfg),
                nodes=None if nodes is None else jnp.asarray(nodes))
    s.solve()
    return s


def rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.mark.parametrize("name,N", [
    ("poisson_1d", 25), ("variable_coeff_elliptic", 33),
    ("helmholtz_1d", 41), ("advection_diffusion_1d", 25),
    ("poisson_inhomogeneous", 65), ("poisson_neumann", 33),
    ("robin_1d", 49),
])
def test_registry_matches_jax_float64(name, N):
    t, j = port_solve(name, num_nodes=N), jax_solve(name, num_nodes=N)
    rel_close(t.solution.coeffs, j.solution.coeffs, 1e-12)
    rel_close(t.solution.fem_values, j.solution.fem_values, 1e-12)
    np.testing.assert_array_equal(np.asarray(t.solution.solve_ok),
                                  np.asarray(j.solution.solve_ok))
    lt, lj = (float(v) for v in (t.errors(TEST_POINTS)[0],
                                 j.errors(TEST_POINTS)[0]))
    assert abs(lt - lj) <= 1e-12 + 1e-6 * lj, (lt, lj)


def test_reference_parity_and_default_quadrature():
    """25 nodes, M=8, gamma=1e4: parity mode (2-point load quadrature)
    reproduces the reference's Linf 3.274e-6; the default quadrature
    reaches ~8.0e-10 (BASELINE.md; SKILL.md expected numbers)."""
    linf, l2 = port_solve(num_nodes=25, fem_quad_order=2).errors(TEST_POINTS)
    assert abs(float(linf) - 3.274e-6) < 0.05e-6, float(linf)
    assert float(l2) < 5e-6
    s = port_solve(num_nodes=25)
    linf = float(s.errors(TEST_POINTS)[0])
    assert 7.5e-10 < linf < 8.5e-10, linf
    sol = s.solution
    assert bool(sol.solve_ok.all())
    assert float(sol.bc_violation.max()) < 1e-8
    fem_err = float(metrics.linf_error(s.evaluate_fem(TEST_POINTS),
                                       torch.sin(np.pi * torch.as_tensor(
                                           TEST_POINTS))))
    assert 6e-3 < fem_err < 1.1e-2 and fem_err / linf > 1e3


@pytest.mark.parametrize("formulation", ["primal", "dual"])
def test_h_refinement_order4(formulation):
    """Parity mode, E = 4 -> 32: O(h^4) with the reference's table
    4.84e-3 / 2.73e-4 / 1.67e-5 / 1.03e-6 (test_poisson1d.py:72)."""
    errs, hs = [], []
    for E in (4, 8, 16, 32):
        s = port_solve(num_nodes=E + 1, formulation=formulation,
                       fem_quad_order=2)
        errs.append(float(s.errors(TEST_POINTS)[0]))
        hs.append(2.0 / E)
    order = metrics.convergence_order(hs, errs)
    assert 3.5 < order < 4.8, (order, errs)
    for got, want in zip(errs, [4.84e-3, 2.73e-4, 1.67e-5, 1.03e-6]):
        assert abs(got - want) < 0.05 * want, errs


def test_primal_equals_dual():
    p = port_solve(num_nodes=25)
    d = port_solve(num_nodes=25, formulation="dual")
    rel_close(d.solution.coeffs, p.solution.coeffs, 1e-12)


def test_custom_nodes_match_jax():
    """The graded-mesh path (test_poisson1d.py:178)."""
    x = np.concatenate([np.linspace(-1, 0, 17), np.geomspace(0.02, 1, 15)])
    x = np.unique(np.concatenate([x, [0.0, 1.0]]))
    t = port_solve(nodes=x, M=8)
    j = jax_solve(nodes=x, M=8)
    rel_close(t.solution.coeffs, j.solution.coeffs, 1e-12)
    assert float(t.errors(TEST_POINTS)[0]) < 1e-3
    xs = np.linspace(-1.3, 1.3, 301)
    rel_close(t.evaluate_solution(xs), j.evaluate_solution(xs), 1e-12)
    rel_close(t.evaluate_fem(xs), j.evaluate_fem(xs), 1e-14)


@pytest.mark.parametrize("name,atol", [
    # Both sides solve the coarse system in float32 (round-off ~E eps at
    # E = 128); the enhancement adds ~1e-6.
    ("poisson_1d", 1e-5),
    ("variable_coeff_elliptic", 1e-4),
])
def test_float32_torch_route_matches_jax_xla_route(name, atol):
    t = port_solve(name, num_nodes=129, dtype="float32")
    j = jax_solve(name, num_nodes=129, dtype="float32")
    assert t.solution.coeffs.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(t.solution.coeffs),
                               np.asarray(j.solution.coeffs), rtol=0,
                               atol=atol)
    assert bool(t.solution.solve_ok.all())
    assert float(t.errors(TEST_POINTS)[0]) < 3e-4


def test_jax_operators_through_converter_give_same_solution():
    problem, cfg = problems.poisson_1d(), SolverConfig(num_nodes=33)
    jops = JH.prepare_shared_host(jprob.poisson_1d(), JConfig(num_nodes=33))
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()
              if v is not None}
    ops = convert.shared_operators_from_arrays(arrays, dtype=torch.float64)
    nodes = H.uniform_nodes(problem, 33, torch.float64, device="cpu")
    via_jax = H.hybrid_solve(problem, cfg, nodes, ops, uniform=True,
                             device="cpu")
    own = H.hybrid_solve(problem, cfg, nodes,
                         H.prepare_shared_host(problem, cfg), uniform=True,
                         device="cpu")
    rel_close(via_jax.coeffs, own.coeffs, 1e-13)
    rel_close(via_jax.coeffs, jax_solve(num_nodes=33).solution.coeffs, 1e-12)


@pytest.mark.parametrize("case", ["separable", "separable_no_diag",
                                  "shared", "varcoeff", "graded"])
def test_kernel_route_on_cpu_matches_torch_route(case, monkeypatch):
    """The glue of the CUDA route (Dirichlet pinning, kernel dispatch,
    gate and fallback), driven on the CPU: with the backend forced to
    'cuda', the wrappers receive CPU tensors and run their plain versions.
    The result matches the torch route in float32."""
    name, nodes, cfg = "poisson_1d", None, dict(num_nodes=129,
                                                  dtype="float32",
                                                  fem_dtype="float64")
    problem = problems.poisson_1d()
    if case == "separable_no_diag":
        cfg["diagnostics"] = False
    if case == "shared":  # a constant-coefficient rhs without factors
        problem = dataclasses.replace(problem, f_elem_factors=None,
                                      f_colloc_factors=None)
    if case in ("varcoeff", "graded"):
        name = "variable_coeff_elliptic"
        problem = problems.get(name)
    if case == "graded":
        x = np.cumsum(np.random.default_rng(5).uniform(0.5, 2.0, 129))
        nodes = (-1.0 + 2.0 * (x - x[0]) / (x[-1] - x[0])).astype(np.float32)

    def solve():
        s = HybridSolver(problem, SolverConfig(**cfg),
                         nodes=None if nodes is None else
                         torch.from_numpy(nodes), device="cpu")
        s.solve()
        return s

    ref = solve()
    monkeypatch.setattr(H, "_resolve_backend", lambda cfg, device: "cuda")
    got = solve()
    np.testing.assert_allclose(np.asarray(got.solution.coeffs),
                               np.asarray(ref.solution.coeffs), rtol=0,
                               atol=3e-5)
    assert bool(got.solution.solve_ok.all())
    assert float(got.errors(TEST_POINTS)[0]) < 3e-4
    assert K.launch_counts()["fused_enhance_separable"] == 0


def test_facade_evaluation_and_sweep():
    """Points outside the domain evaluate on the first / last element (the
    reference's clamp); sweep_solve equals one solve per config."""
    from hybrid_fem_lssvr_tpu_torch.ops import legendre

    s = port_solve(num_nodes=9)
    u = s.evaluate_solution(np.array([-1.3, 1.3]))
    n, c = s.solution.nodes, s.solution.coeffs
    t = torch.tensor([(2 * -1.3 - n[0] - n[1]) / (n[1] - n[0]),
                      (2 * 1.3 - n[-2] - n[-1]) / (n[-1] - n[-2])],
                     dtype=torch.float64)
    rel_close(u, legendre.evaluate_series(c[[0, -1]], t), 1e-14)
    sols = H.sweep_solve(problems.poisson_1d(),
                         [SolverConfig(num_nodes=n) for n in (9, 17)],
                         device="cpu")
    rel_close(sols[0].coeffs, s.solution.coeffs, 0.0)
    assert sols[1].coeffs.shape == (16, 8)
    assert s.fem_nodes is s.solution.nodes


@pytest.mark.parametrize("bad", [dict(num_nodes=1), dict(M=0),
                                 dict(n_colloc=4, M=8), dict(gamma=0.0),
                                 dict(formulation="x"), dict(kkt_method="x"),
                                 dict(backend="xla"),
                                 dict(tridiag_method="x")])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        SolverConfig(**bad)


def test_default_device_is_the_gpu_or_an_error():
    """With no ``device`` an entry point runs on the GPU; on a machine
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; see tests/test_torch_cuda.py")
    problem, cfg = problems.poisson_1d(), SolverConfig(num_nodes=9)
    nodes = torch.linspace(-1.0, 1.0, 9, dtype=torch.float64)
    for call in (lambda: HybridSolver(problem),
                 lambda: HybridSolver(problem, cfg, nodes=nodes),
                 lambda: H.uniform_nodes(problem, 9, torch.float64),
                 lambda: H.hybrid_solve(problem, cfg, nodes),
                 lambda: H.hybrid_solve_general(problem, cfg, nodes),
                 lambda: H.sweep_solve(problem, [cfg])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
