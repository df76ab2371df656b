"""The port's distributed 1D solve, collectives and transpose, on four
``gloo`` ranks on the CPU, against the JAX package on the conftest's eight
virtual CPU devices and against the port's single-device solver.

The ranks are spawned processes that load no JAX (``_torch_ranks.py``);
one set runs every case of this module in the ``ranks`` fixture, and the
tests read rank 0's gathered arrays.  A rank that dies or hangs fails the
fixture within ``_torch_ranks.JOIN_TIMEOUT_S``.

Tolerances: the direct paths (SPIKE, the evaluate) hold to 1e-12 of their
size against JAX (the same algorithm; the reduced system is solved by LU
here and by pivoted Gauss there); the transpose is exact.  Against the
port's single-device solver (Thomas, not SPIKE) the nodal values hold to
1e-12 and the coefficients to 1e-10 of their size in float64.
"""

import numpy as np
import pytest
import torch

import _torch_ranks

torch.set_num_threads(1)

CASES = ("collectives_all", "sharded_1d", "sharded_1d_variants",
         "sharded_1d_plain_kernels", "sharded_1d_rejects", "transpose")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The module's ranks, started before its JAX builds so that the two
    overlap."""
    ranks = _torch_ranks.Ranks(4, "_torch_ranks", CASES,
                               tmp_path_factory.mktemp("ranks_1d"))
    yield ranks
    ranks.stop()


@pytest.fixture(scope="module")
def ranks(started, jax_1d):
    return started.results()


def case(ranks, name):
    out = ranks[name]
    assert "error" not in out, out.get("error")
    return out


def rel_close(got, want, rtol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                              np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= rtol * scale, f"max err {err:.3e} > {rtol} x {scale:.3e}"


def test_ranks_load_no_jax(ranks):
    assert ranks["_modules"] == []


def test_a_dead_rank_fails_the_run_quickly(tmp_path):
    """A rank that dies mid-run fails ``run_ranks`` (its peer's collective
    errors out or the join deadline kills it), within the deadline."""
    import time

    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        _torch_ranks.run_ranks(2, "_torch_ranks", ["die"], tmp_path,
                               timeout=30)
    assert time.monotonic() - t0 < 35


# ---- the collectives against numpy ----------------------------------------

def _per_rank(ranks):
    return case(ranks, "collectives_all")["ranks"]


def test_ppermute_gives_zeros_at_open_ends(ranks):
    for r in _per_rank(ranks):
        d = int(r["rank"][0])
        # (i -> i+1): rank 0 has no sender; (i+1 -> i): rank 3 has none.
        np.testing.assert_array_equal(r["up"], np.full(3, float(d) if d
                                                       else 0.0))
        np.testing.assert_array_equal(r["dn"], np.full(3, float(d + 2)
                                                       if d < 3 else 0.0))
        np.testing.assert_array_equal(r["cyc"], np.full(3, float((d - 1) % 4
                                                                 + 1)))


def test_psum_over_one_axis_and_both_grid_axes(ranks):
    for r in _per_rank(ranks):
        _, dy, dx = (int(v) for v in r["rank"])
        # v = 10 dy + dx on the 2 x 2 grid.
        assert r["s_y"][0] == 10.0 + 2 * dx
        assert r["s_x"][0] == 20.0 * dy + 1.0
        assert r["s_xy"][0] == 22.0
        np.testing.assert_array_equal(r["s_line"], np.full(3, 10.0))


def test_all_gather_stacks_in_mesh_order(ranks):
    for r in _per_rank(ranks):
        _, dy, _ = (int(v) for v in r["rank"])
        np.testing.assert_array_equal(
            r["gathered"], np.array([[d, 7.0 * d] for d in range(4)]))
        np.testing.assert_array_equal(r["gx"], np.array([[10.0 * dy],
                                                         [10.0 * dy + 1]]))


def test_all_to_all_gives_transpose_block_order(ranks):
    for r in _per_rank(ranks):
        d = int(r["rank"][0])
        np.testing.assert_array_equal(
            r["a2a"], np.array([[e, d] for e in range(4)], dtype=float))


# ---- against the JAX package ----------------------------------------------

def _jax_solve_1d(num_nodes=33):
    from hybrid_fem_lssvr_tpu import SolverConfig as JConfig
    from hybrid_fem_lssvr_tpu.models import problems as jprob
    from hybrid_fem_lssvr_tpu.parallel import mesh as jmesh
    from hybrid_fem_lssvr_tpu.parallel import sharded as jsh

    problem = jprob.poisson_1d()
    cfg = JConfig(num_nodes=num_nodes, M=8, gamma=1e4)
    m = jmesh.element_mesh(4)
    sol = jsh.make_sharded_solve(problem, cfg, m, enhance_backend="xla")()
    ev = jsh.make_sharded_evaluate(problem, cfg, m)
    return sol, lambda coeffs: np.asarray(
        ev(coeffs, np.linspace(-1.0, 1.0, 101)))


@pytest.fixture(scope="module")
def jax_1d(started):
    return _jax_solve_1d()


def test_sharded_solve_matches_jax(ranks, jax_1d):
    out = case(ranks, "sharded_1d")
    sol, _ = jax_1d
    rel_close(out["fem_local"], sol.fem_local, 1e-12)
    rel_close(out["coeffs"], sol.coeffs, 1e-12)
    # slack and bcv are rounding-sized here; held in absolute terms.
    np.testing.assert_allclose(out["max_slack"], sol.max_slack, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out["bc_violation"], sol.bc_violation,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(out["solve_ok"], np.asarray(sol.solve_ok))


def test_sharded_evaluate_matches_jax(ranks, jax_1d):
    """Both read paths on the port's gathered coefficients."""
    out = case(ranks, "sharded_1d")
    rel_close(out["u"], jax_1d[1](out["coeffs"]), 1e-12)


def test_sharded_transpose_matches_jax(ranks):
    from hybrid_fem_lssvr_tpu.parallel import mesh as jmesh
    from hybrid_fem_lssvr_tpu.parallel.transpose import make_sharded_transpose

    out = case(ranks, "transpose")
    x = np.arange(96, dtype=np.float64).reshape(8, 12)
    jt = np.asarray(make_sharded_transpose(jmesh.element_mesh(4), 8, 12)(x))
    # The gathered shards [4, 3, 8] are the transpose's row blocks.
    np.testing.assert_array_equal(out["xt"].reshape(12, 8), jt)
    np.testing.assert_array_equal(out["xt"].reshape(12, 8), x.T)
    np.testing.assert_array_equal(out["back"].reshape(8, 12), x)
    assert bool(out["rejects"])


def test_adi_distributed_matches_local(ranks):
    out = case(ranks, "transpose")
    np.testing.assert_allclose(out["adi_dist"], out["adi_local"], rtol=0,
                               atol=1e-12)


# ---- against the port's single-device solver ------------------------------

def _single(name, **cfg):
    from hybrid_fem_lssvr_tpu_torch import HybridSolver, problems

    s = HybridSolver(problems.get(name), _torch_ranks.cfg_1d(**cfg),
                     device="cpu")
    return s.solve()


def _fem_grid(fem_local):
    """[n_dev, E_loc + 1] overlapping shards -> the nodal vector."""
    fl = np.asarray(fem_local)
    return np.concatenate([fl[:, :-1].reshape(-1), fl[-1, -1:]])


VARIANTS = [
    ("poisson_1d", "poisson_1d", dict(num_nodes=41)),
    ("helmholtz_1d", "helmholtz_1d", dict(num_nodes=41)),
    ("advection_diffusion_1d", "advection_diffusion_1d",
     dict(num_nodes=41)),
    ("variable_coeff_elliptic", "variable_coeff_elliptic",
     dict(num_nodes=41)),
    ("indivisible_30", "poisson_1d", dict(num_nodes=31)),
    ("d2", "poisson_1d", dict()),
    ("dual", "poisson_1d", dict(formulation="dual")),
]


@pytest.mark.parametrize("key,name,cfg", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_variants_match_single_device(ranks, key, name, cfg):
    out = case(ranks, "sharded_1d_variants")[key]
    ref = _single(name, **cfg)
    E = ref.coeffs.shape[0]
    rel_close(_fem_grid(out["fem_local"])[:E + 1], ref.fem_values, 1e-12)
    rel_close(out["coeffs"], ref.coeffs, 1e-10)
    assert out["solve_ok"].shape == (E,) and out["solve_ok"].all()
    np.testing.assert_allclose(out["bc_violation"], ref.bc_violation,
                               rtol=0, atol=1e-10)


def test_fem_dtype_float64_coarse_stage(ranks):
    """float32 run with a float64 SPIKE stage: the nodal values are the
    float64 single-device ones rounded to float32."""
    out = case(ranks, "sharded_1d_variants")["fem_dtype"]
    ref = _single("poisson_1d", num_nodes=513, dtype="float32",
                  fem_dtype="float64")
    np.testing.assert_allclose(_fem_grid(out["fem_local"]), ref.fem_values,
                               rtol=0, atol=1e-7)
    rel_close(out["coeffs"], ref.coeffs, 2e-5)


PLAIN = [(f"{n}_{dt}", n, dt) for dt in ("float64", "float32")
         for n in ("poisson_1d", "variable_coeff_elliptic")]


@pytest.mark.parametrize("key,name,dt", PLAIN, ids=[p[0] for p in PLAIN])
def test_per_shard_plain_kernels_match_torch_route(ranks, key, name, dt):
    """'auto' on the CPU: each shard through the separable / graded-mode
    varcoeff kernel's plain version, against HybridSolver's torch route.
    float64: the same least-squares solution by two algorithms (shared
    affine map vs rank-factored rhs; CGS2 QR vs the batched solve), 1e-9
    of the coefficients' size; float32: 2e-5."""
    out = case(ranks, "sharded_1d_plain_kernels")[key]
    ref = _single(name, num_nodes=65, dtype=dt, fem_dtype="float64",
                  backend="torch")
    tol = 1e-9 if dt == "float64" else 2e-5
    rel_close(_fem_grid(out["fem_local"]), ref.fem_values,
              1e-12 if dt == "float64" else 2e-7)
    rel_close(out["coeffs"], ref.coeffs, tol)
    assert out["solve_ok"].all()


def test_rejects_non_dirichlet_small_shards_and_cuda_on_cpu(ranks):
    out = case(ranks, "sharded_1d_rejects")
    assert list(out["raised"]) == ["NotImplementedError", "ValueError",
                                   "ValueError", "ValueError", ""]
    assert "needs CUDA tensors" in out["said"][2]
    assert "cfg.diagnostics" in out["said"][3]
