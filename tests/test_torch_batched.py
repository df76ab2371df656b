"""The port's parametric families (``models/batched.py``) against the JAX
package, and the pieces they batch: P1 assembly and the tridiagonal solve
over a batch of meshes, and the family layout of the 1D per-element
kernel's plain version.

float64 comparisons with JAX hold to 1e-12 relative on coefficients and
nodal values (``tests/test_torch_hybrid.py``).  The JAX solves run once
per module (fixtures).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models import batched as JB

from hybrid_fem_lssvr_tpu_torch import (HybridSolver, SolverConfig,
                                        problems, solve_family,
                                        solve_groups)
from hybrid_fem_lssvr_tpu_torch.models import batched as B
from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
from hybrid_fem_lssvr_tpu_torch.ops import assembly, kernels as K, tridiag

torch.set_num_threads(1)

KS = [1.3, 2.3, 3.1]
THETAS = [[1.0, 3.0], [0.5, 1.0], [2.0, 0.0]]


def rel_close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


@pytest.fixture(scope="module")
def jax_families():
    """JAX's solve_family on the reference tests' configurations."""
    return {
        "helmholtz": JB.solve_family(JB.helmholtz_family(),
                                     JConfig(num_nodes=41), jnp.asarray(KS)),
        "advdiff": JB.solve_family(JB.advdiff_family(),
                                   JConfig(num_nodes=65),
                                   jnp.asarray(THETAS)),
    }


def port_family(name):
    if name == "helmholtz":
        return solve_family(B.helmholtz_family(), SolverConfig(num_nodes=41),
                            KS, device="cpu")
    return solve_family(B.advdiff_family(), SolverConfig(num_nodes=65),
                        THETAS, device="cpu")


@pytest.mark.parametrize("name", ["helmholtz", "advdiff"])
def test_family_matches_jax(jax_families, name):
    j, t = jax_families[name], port_family(name)
    rel_close(t.coeffs, j.coeffs)
    rel_close(t.fem_values, j.fem_values)
    rel_close(t.nodes, j.nodes, 1e-15)  # linspace: one ulp apart at most
    np.testing.assert_array_equal(t.solve_ok.numpy(), np.asarray(j.solve_ok))
    assert bool(t.solve_ok.all())
    # The diagnostics: rounding-sized, so held absolutely at the size of
    # the operator rows times the coefficients' rounding.
    for got, want in ((t.max_slack, j.max_slack),
                      (t.bc_violation, j.bc_violation)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("name", ["helmholtz", "advdiff"])
def test_family_matches_single_solves_of_the_port(name):
    """Member p of the batched solve is the general (per-element) solve of
    the instantiated problem on the same nodes."""
    fam = B.helmholtz_family() if name == "helmholtz" else B.advdiff_family()
    thetas = KS if name == "helmholtz" else THETAS
    sol = port_family(name)
    cfg = SolverConfig(num_nodes=sol.nodes.shape[1])
    for p, th in enumerate(thetas):
        theta = torch.tensor(th, dtype=torch.float64)
        one = HybridSolver(fam.instantiate(theta), cfg, nodes=sol.nodes[p],
                           device="cpu").solve()
        rel_close(sol.coeffs[p], one.coeffs)
        rel_close(sol.fem_values[p], one.fem_values)
        assert torch.equal(sol.solve_ok[p], one.solve_ok)


def test_helmholtz_family_matches_individual_solves():
    """tests/test_batched.py's check: each member against the registry's
    helmholtz_1d through HybridSolver (its shared-operator route)."""
    sol = port_family("helmholtz")
    assert sol.coeffs.shape == (3, 40, 8)
    for i, k in enumerate(KS):
        s = HybridSolver(problems.helmholtz_1d(k=k),
                         SolverConfig(num_nodes=41), device="cpu")
        s.solve()
        np.testing.assert_allclose(sol.coeffs[i].numpy(),
                                   s.solution.coeffs.numpy(), atol=1e-8)


def test_advdiff_family_reaches_the_nodal_floor():
    sol = port_family("advdiff")
    x = torch.linspace(-1, 1, 101, dtype=torch.float64)
    from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval

    for i in range(3):
        u = ops_eval.evaluate(sol.nodes[i], sol.coeffs[i], x)
        err = float((u - torch.sin(torch.pi * x)).abs().max())
        assert err < 5e-3, (i, err)


def test_solve_groups_static_routing():
    groups = [
        (B.helmholtz_family(), SolverConfig(num_nodes=33), [1.0, 2.0]),
        (B.advdiff_family(), SolverConfig(num_nodes=33), [[1.0, 2.0]]),
    ]
    out = solve_groups(groups, device="cpu")
    assert [g.family_name for g in out] == ["helmholtz_family",
                                           "advdiff_family"]
    assert out[0].solution.coeffs.shape == (2, 32, 8)
    assert out[1].solution.coeffs.shape == (1, 32, 8)
    jout = JB.solve_groups([(JB.helmholtz_family(), JConfig(num_nodes=33),
                             jnp.asarray([1.0, 2.0])),
                            (JB.advdiff_family(), JConfig(num_nodes=33),
                             jnp.asarray([[1.0, 2.0]]))])
    for t, j in zip(out, jout):
        rel_close(t.solution.coeffs, j.solution.coeffs)


def test_family_above_the_thomas_limit_uses_batched_spike():
    """A family of 9,000-node meshes takes tridiag 'auto' -> SPIKE over the
    batch, and each member matches its own single solve."""
    cfg = SolverConfig(num_nodes=9000)
    sol = solve_family(B.helmholtz_family(), cfg, [1.0, 2.5], device="cpu")
    for p, k in enumerate([1.0, 2.5]):
        one = HybridSolver(B.helmholtz_family().instantiate(k), cfg,
                           nodes=sol.nodes[p], device="cpu").solve()
        rel_close(sol.fem_values[p], one.fem_values)
        rel_close(sol.coeffs[p], one.coeffs)


def test_tridiag_spike_takes_a_batch():
    """tridiag.solve(method='spike') on P = 2 systems of 9,000 rows equals
    two single solves (and Thomas, and the dense oracle's batch path)."""
    rng = np.random.default_rng(3)
    N = 9000
    a, c = (torch.tensor(rng.uniform(-1, 0, (2, N))) for _ in range(2))
    b = torch.tensor(rng.uniform(2.5, 3.5, (2, N)))
    a[:, 0] = 0.0
    c[:, -1] = 0.0
    rhs = torch.tensor(rng.normal(size=(2, N)))
    got = tridiag.solve(a, b, c, rhs, method="spike")
    assert got.shape == (2, N)
    for p in range(2):
        one = tridiag.solve(a[p], b[p], c[p], rhs[p], method="spike")
        np.testing.assert_allclose(got[p].numpy(), one.numpy(), rtol=0,
                                   atol=1e-13)
        thomas = tridiag.solve(a[p], b[p], c[p], rhs[p], method="thomas")
        np.testing.assert_allclose(got[p].numpy(), thomas.numpy(), rtol=0,
                                   atol=1e-12)
    auto = tridiag.solve(a, b, c, rhs, method="auto")
    assert torch.equal(auto, got)
    small = tridiag.solve(a[:, :300], b[:, :300], c[:, :300], rhs[:, :300],
                          method="thomas")
    dense = tridiag.solve(a[:, :300], b[:, :300], c[:, :300], rhs[:, :300],
                          method="dense")
    np.testing.assert_allclose(small.numpy(), dense.numpy(), atol=1e-12)


def test_assembly_takes_a_batch_of_meshes():
    nodes = torch.stack([torch.linspace(-1, 1, 17, dtype=torch.float64),
                         torch.linspace(-1, 1, 17, dtype=torch.float64) ** 3])
    ks = torch.tensor([1.5, 2.5], dtype=torch.float64)
    fam = B.helmholtz_family()
    out = assembly.assemble_p1(nodes, lambda x: torch.ones_like(x), None,
                               lambda x: fam.c(x, ks[:, None, None]),
                               lambda x: fam.f(x, ks[:, None, None]))
    bp = B.batched_problem(fam, ks)
    bc = assembly.apply_bcs(*out, bp)
    for p in range(2):
        one = assembly.assemble_p1(nodes[p], lambda x: torch.ones_like(x),
                                   None, lambda x: fam.c(x, ks[p]),
                                   lambda x: fam.f(x, ks[p]))
        for g, w in zip(out, one):
            assert torch.equal(g[p], w)
        for g, w in zip(bc, assembly.apply_bcs(*one, fam.instantiate(ks[p]))):
            assert torch.equal(g[p], w)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
@pytest.mark.parametrize("seam", [False, True])
def test_varcoeff_plain_family_layout(dtype, rtol, seam):
    """The plain version of fused_enhance_varcoeff on P families laid out
    [P, Ef+1] equals P single calls, on graded and uniform meshes.  With
    ``seam`` the families' nodal values jump by 1e3 between families: an
    element that read across a seam would be off by that much."""
    P, Ef, M, C = 3, 50, 8, 12
    rng = np.random.default_rng(0)
    fem = rng.normal(size=(P, Ef + 1))
    if seam:
        fem += 1e3 * np.arange(P)[:, None] * (-1) ** np.arange(P)[:, None]
    fem = torch.tensor(fem, dtype=dtype)
    widths = rng.uniform(0.5, 2.0, (P, Ef))
    xs = np.concatenate([np.zeros((P, 1)), np.cumsum(widths, 1)], 1)
    graded = torch.tensor(-1.0 + 2.0 * xs / xs[:, -1:], dtype=dtype)
    thetas = torch.tensor(THETAS, dtype=dtype)
    prob = B.batched_problem(B.advdiff_family(), thetas)
    h = 2.0 / Ef
    host = K.VarCoeffOperators.host(M, C, h, dtype)
    for nodes in (graded, None):
        got = K.fused_enhance_varcoeff(fem, prob, host, -1.0, h, C,
                                       nodes=nodes)
        ref = K.fused_enhance_varcoeff_ref(fem, prob, host, -1.0, h, C,
                                           nodes=nodes)
        assert got[0].shape == (P * Ef, M)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        for p in range(P):
            one = K.fused_enhance_varcoeff_ref(
                fem[p].contiguous(), B.advdiff_family().instantiate(thetas[p]),
                host, -1.0, h, C,
                nodes=None if nodes is None else nodes[p].contiguous())
            rows = slice(p * Ef, (p + 1) * Ef)
            rel_close(got[0][rows], one[0], rtol)
            rel_close(got[3][rows], one[3], 1e3 * rtol)
            # slack and bcv are rounding-sized: held at the rounding of
            # their operands (the rows' scale s^2 |f| and |bc|).
            bc_scale = float(fem[p].abs().max())
            np.testing.assert_allclose(got[2][rows].numpy(), one[2].numpy(),
                                       rtol=0, atol=50 * rtol * bc_scale)
            assert float(got[1][rows].max()) < 100 * float(one[1].max()) + \
                1e3 * rtol * host.s2 * bc_scale


def test_family_rejects_shared_operators():
    nodes = torch.linspace(-1, 1, 9, dtype=torch.float64).expand(2, 9)
    cfg = SolverConfig(num_nodes=9)
    with pytest.raises(ValueError, match="per-element"):
        H.lssvr_enhance(problems.poisson_1d(), nodes, torch.zeros(2, 9),
                        cfg, shared_ops=object())
