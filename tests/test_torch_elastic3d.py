"""The port's 3D elasticity (``models/elastic3d.py``) against the JAX
package on the CPU.

In float64: the host operators to 1e-12; the whole solve at 8^3 hexes,
M = 4, with ``precond='jacobi'`` (nodal values to 1e-10, CG iterations
within one, coefficients to 1e-9), its evaluation and stress readout; the
enhancement of poly_elastic_3d (g on every face) on nodal values made with
numpy from a seed.  JAX's 3D V-cycle costs ~25 s to compile, so the
``'mg'`` route is held against the port's own Jacobi solution.  The JAX
calls run under ``jax.jit`` (one compile instead of op-by-op compiles).
The JAX package has no TPU kernel for this path: the port runs it in torch
alone.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import elastic3d as JE3

from hybrid_fem_lssvr_tpu_torch.models import elastic3d as TE3
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

PROBLEMS = ["sin_elastic_3d", "poly_elastic_3d"]
N = 8


def np_(t):
    return None if t is None else np.asarray(t)


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol)


def nodal_values(name, n, seed=0):
    """[3, n+1, n+1, n+1] float64: the exact displacement on the nodes plus
    noise on the interior ones."""
    p = JE3.get_elastic_problem_3d(name)
    rng = np.random.default_rng(seed)
    Z, Y, X = np.meshgrid(*[np.linspace(-1.0, 1.0, n + 1)] * 3,
                          indexing="ij")
    u = np.stack([np.asarray(e(*(jnp.asarray(v) for v in (X, Y, Z))))
                  for e in p.exact])
    u[:, 1:-1, 1:-1, 1:-1] += 1e-3 * rng.normal(size=(3,) + (n - 1,) * 3)
    return u


# ------------------------------------------------------- host operators

@pytest.mark.parametrize("h", [(0.25, 0.25, 0.25), (0.125, 0.5, 0.25)])
@pytest.mark.parametrize("name", PROBLEMS)
def test_block_locals_match_jax(name, h):
    jp = JE3.get_elastic_problem_3d(name)
    tp = TE3.get_elastic_problem_3d(name)
    for a, b in zip(TE3._hex_grad_mats(*h).values(),
                    JE3._hex_grad_mats(*h).values()):
        close(a, b, 1e-12)
    tdiag, toff = TE3._block_locals_3d(tp, *h)
    jdiag, joff = JE3._block_locals_3d(jp, *h, jnp.float64)
    assert sorted(tdiag) == sorted(jdiag) and sorted(toff) == sorted(joff)
    for k in jdiag:
        close(tdiag[k], jdiag[k], 1e-12)
    for k in joff:
        close(toff[k], joff[k], 1e-12)


@pytest.mark.parametrize("shape,M", [((8, 8, 8), 4), ((4, 6, 2), 3)])
@pytest.mark.parametrize("name", PROBLEMS)
def test_block_colloc_and_precompute_match_jax(name, shape, M):
    nx, ny, nz = shape
    jp = JE3.get_elastic_problem_3d(name)
    tp = TE3.get_elastic_problem_3d(name)
    kw = dict(nx=nx, ny=ny, nz=nz, M=M, n_colloc=M)
    jcfg, tcfg = JE3.ElasticConfig3D(**kw), TE3.ElasticConfig3D(**kw)
    for a, b in zip(TE3._block_colloc_host_3d(tp, tcfg),
                    JE3._block_colloc_host_3d(jp, jcfg)):
        close(a, b, 1e-12, rtol=1e-12)
    tops, (t_int, spts) = TE3.prepare_shared_elastic_3d(tp, tcfg)
    jops, (jt, js) = JE3.prepare_shared_elastic_3d(jp, jcfg)
    close(t_int, jt, 1e-15)
    close(spts, js, 1e-15)
    for field in ("Wf", "Wbc", "D", "B", "Pres", "Qres", "cond"):
        close(getattr(tops, field), getattr(jops, field), 1e-12, rtol=1e-12)


# ------------------------------------------------------- whole solves

@functools.lru_cache(maxsize=None)
def jax_solve(name, kw=(("precond", "jacobi"),)):
    """JAX's ``hybrid_solve_elastic_3d`` at 8^3 in float64, its solution's
    arrays as numpy."""
    p = JE3.get_elastic_problem_3d(name)
    cfg = JE3.ElasticConfig3D(nx=N, ny=N, nz=N, **dict(kw))
    sol = jax.jit(functools.partial(JE3.hybrid_solve_elastic_3d, p, cfg,
                                    JE3.prepare_shared_elastic_3d(p, cfg)))()
    return {k: np_(v) for k, v in sol._asdict().items()}


@functools.lru_cache(maxsize=None)
def torch_solve(name, n=N, kw=(("precond", "jacobi"),)):
    s = TE3.ElasticSolver3D(TE3.get_elastic_problem_3d(name),
                            TE3.ElasticConfig3D(nx=n, ny=n, nz=n,
                                                **dict(kw)),
                            device="cpu")
    s.solve()
    return s


def test_solver_matches_jax():
    sol = torch_solve("sin_elastic_3d").solution
    want = jax_solve("sin_elastic_3d")
    assert sol.fem_values.shape == (3, N + 1, N + 1, N + 1)
    assert sol.coeffs.shape == (3, N, N, N, 4, 4, 4)
    assert bool(sol.solve_ok.all()) and bool(want["solve_ok"].all())
    close(sol.fem_values, want["fem_values"], 1e-10)
    assert abs(sol.cg_iters - int(want["cg_iters"])) <= 1
    close(sol.coeffs, want["coeffs"], 1e-9)
    close(sol.bc_violation, want["bc_violation"], 1e-9)
    close(sol.max_slack, want["max_slack"], 1e-7, rtol=1e-7)
    close(sol.cond_estimate, want["cond_estimate"], 0, rtol=1e-10)


@jax.jit
def jax_readouts(sol, x, y, z):
    return (JE3.evaluate_elastic_3d(sol, x, y, z),
            JE3.evaluate_stress_3d(sol, x, y, z))


def test_evaluation_and_stress_match_jax():
    s = torch_solve("sin_elastic_3d")
    want = jax_solve("sin_elastic_3d")
    jsol = JE3.ElasticSolution3D(**{k: jnp.asarray(v)
                                    for k, v in want.items()})
    x, y, z = np.random.default_rng(5).uniform(-1.0, 1.0, (3, 300))
    u, stress = jax_readouts(jsol, *(jnp.asarray(v) for v in (x, y, z)))
    for got, ref in ((s.evaluate_solution(x, y, z), u),
                     (s.evaluate_stress(x, y, z), stress)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            close(a, b, 1e-9 * max(1.0, float(np.abs(np_(b)).max())))
    linf = max(float(np.abs(np_(u[c]) - s.problem.exact[c](
        *(torch.from_numpy(v) for v in (x, y, z))).numpy()).max())
        for c in range(3))
    close(s.errors(x, y, z)[0], linf, 1e-10)


@functools.lru_cache(maxsize=None)
def enhancement_case(name, n=4):
    """JAX's enhance_elastic_3d and the port's on the same float64 nodal
    values, both from JAX's operator bundle (converted for the port)."""
    jp = JE3.get_elastic_problem_3d(name)
    cfg = JE3.ElasticConfig3D(nx=n, ny=n, nz=n)
    jops, (t_int, spts) = JE3.prepare_shared_elastic_3d(jp, cfg)
    fem = nodal_values(name, n)
    xs = jnp.linspace(-1.0, 1.0, n + 1)
    jc, jd, _ = jax.jit(lambda f: JE3.enhance_elastic_3d(
        jp, cfg, xs, xs, xs, f, (jops, (t_int, spts))))(jnp.asarray(fem))
    bundle = convert.elastic_bundle_from_arrays(
        {k: np.asarray(v) for k, v in jops._asdict().items()
         if v is not None}, np.asarray(t_int), np.asarray(spts),
        dtype=torch.float64)
    return jc, jd, bundle, fem


def test_enhancement_matches_jax():
    """poly_elastic_3d's enhancement on noisy nodal values: g on every face
    (the override of every component); sin_elastic_3d's is in the whole
    solve above."""
    name, n = "poly_elastic_3d", 4
    jc, jd, bundle, fem = enhancement_case(name, n)
    tp = TE3.get_elastic_problem_3d(name)
    cfg = TE3.ElasticConfig3D(nx=n, ny=n, nz=n)
    xs = torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64)
    coeffs, diags, _ = TE3.enhance_elastic_3d(
        tp, cfg, xs, xs, xs, torch.from_numpy(fem), bundle)
    assert bool(diags.solve_ok.all())
    close(coeffs, jc, 1e-9)
    close(diags.bc_violation, jd.bc_violation, 1e-9)
    close(diags.max_slack, jd.max_slack, 1e-7, rtol=1e-7)
    # the port's own precompute gives the same map
    own = TE3.prepare_shared_elastic_3d(tp, cfg)
    again = TE3.enhance_elastic_3d(tp, cfg, xs, xs, xs,
                                   torch.from_numpy(fem), own)[0]
    close(again, coeffs, 1e-12)


def test_mg_matches_own_jacobi():
    """The component V-cycle route converges to the Jacobi route's nodal
    values and coefficients (both to CG's 100 eps), in fewer iterations."""
    name = "sin_elastic_3d"
    jac = torch_solve(name).solution
    mg = torch_solve(name, kw=(("precond", "mg"),)).solution
    close(mg.fem_values, jac.fem_values, 1e-10)
    close(mg.coeffs, jac.coeffs, 1e-9)
    assert mg.cg_iters < jac.cg_iters
    assert bool(mg.solve_ok.all())


def test_poly_elastic_3d_rides_the_trace_floor():
    """The cubic is inside the M = 4 trial space: the nodal values are
    exact (JAX measures 2.2e-14 at 8^3) and Linf is the trilinear trace
    floor (JAX: 0.0464)."""
    s = torch_solve("poly_elastic_3d")
    p = s.problem
    grid = torch.linspace(-1.0, 1.0, N + 1, dtype=torch.float64)
    Z, Y, X = torch.meshgrid(grid, grid, grid, indexing="ij")
    for c in range(3):
        close(s.solution.fem_values[c], p.exact[c](X, Y, Z), 1e-12)
    x, y, z = np.random.default_rng(2).uniform(-1.0, 1.0, (3, 500))
    assert float(s.errors(x, y, z)[0]) < 6e-2


def test_config_validation_and_device_rule():
    for kw, match in ((dict(precond="ilu"), "precond"),
                      (dict(coarse="compact"), "coarse"),
                      (dict(trace_lift=1), "trace_lift")):
        with pytest.raises(ValueError, match=match):
            TE3.ElasticConfig3D(**kw)
    assert TE3.ElasticConfig3D(mg_omega=0.6).torch_dtype() == torch.float64
    with pytest.raises(ValueError, match="unknown 3D elastic problem"):
        TE3.get_elastic_problem_3d("beam")
    cfg = TE3.ElasticConfig3D(nx=7, ny=8, nz=8, precond="mg")
    with pytest.raises(ValueError, match="even"):
        TE3.ElasticSolver3D(TE3.sin_elastic_3d(), cfg, device="cpu").solve()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE3.ElasticSolver3D(TE3.sin_elastic_3d())
    assert dataclasses.replace(cfg, precond="jacobi").precond == "jacobi"
