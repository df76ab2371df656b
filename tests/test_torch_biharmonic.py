"""The port's biharmonic family (``models/biharmonic.py``) and
``tridiag.block_thomas_2x2`` against the JAX package, float64 on the CPU.

Inputs are the JAX package's own test problems (or, for the block solve,
numpy draws from a seed); each JAX solve runs once per module.
Tolerances:
- ``block_thomas_2x2``: 1e-11 against the dense solve (the JAX test's), 1e-13
  against JAX;
- the 1D chain and the clamped beam: coefficients, nodal values and slopes
  within 1e-10 of the largest value compared;
- the 2D and 3D chains and the BFS plate: coefficients within 1e-9 plus the
  larger of the two packages' own trace violations (ROADMAP.md §3), nodal
  values within 1e-12 relative, CG iteration counts equal.
The u-stage of the 2D and 3D chains runs the port's torch route against
JAX's forced XLA route (the port keeps ``cfg.backend`` there; on the CPU
both stages take the torch route).  The 2D chains use ``precond='jacobi'``:
JAX's V-cycle compile would take ~20 s of the file's time a chain.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import biharmonic as JB
from hybrid_fem_lssvr_tpu.models.hybrid import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models.hybrid2d import Solver2DConfig as J2Config
from hybrid_fem_lssvr_tpu.models.hybrid3d import Solver3DConfig as J3Config
from hybrid_fem_lssvr_tpu.ops import tridiag as JT

from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                        SolverConfig)
from hybrid_fem_lssvr_tpu_torch.models import biharmonic as B
from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import evaluate_2d
from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval
from hybrid_fem_lssvr_tpu_torch.ops import tridiag as T
from hybrid_fem_lssvr_tpu_torch.utils.convert import \
    clamped_bundle_from_arrays

torch.set_num_threads(1)


def close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def rel_close(got, want, rtol):
    want = np.asarray(want)
    close(got, want, rtol * max(1.0, float(np.max(np.abs(want)))))


def arrays(bundle):
    return {k: np.asarray(v) for k, v in bundle._asdict().items()
            if v is not None}


# ------------------------------------------------------- block_thomas_2x2


def block_system(n, seed=3):
    """The JAX test's SPD-ish random block-tridiagonal system, n rows."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, 2, 2)) * 0.1
    U = rng.standard_normal((n, 2, 2)) * 0.1
    D = np.broadcast_to(np.eye(2) * 4.0, (n, 2, 2)).copy()
    D += rng.standard_normal((n, 2, 2)) * 0.2
    r = rng.standard_normal((n, 2))
    A = np.zeros((2 * n, 2 * n))
    for i in range(n):
        A[2 * i:2 * i + 2, 2 * i:2 * i + 2] = D[i]
        if i > 0:
            A[2 * i:2 * i + 2, 2 * i - 2:2 * i] = L[i]
        if i < n - 1:
            A[2 * i:2 * i + 2, 2 * i + 2:2 * i + 4] = U[i]
    return L, D, U, r, A


@pytest.mark.parametrize("n", [1, 2, 17, 64])
def test_block_thomas_2x2_matches_dense_and_jax(n):
    L, D, U, r, A = block_system(n)
    got = T.block_thomas_2x2(*(torch.tensor(v) for v in (L, D, U, r)))
    want = np.linalg.solve(A, r.ravel()).reshape(n, 2)
    close(got, want, 1e-11)
    j = JT.block_thomas_2x2(*(jnp.asarray(v) for v in (L, D, U, r)))
    close(got, np.asarray(j), 1e-13)


# ------------------------------------------------------------- 1D chain

CHAIN_1D = (17, 33)


@pytest.fixture(scope="module")
def jax_chain_1d():
    return {n: JB.solve_biharmonic_1d(JB.sin_biharmonic_1d(), JConfig(
        num_nodes=n, M=8, gamma=1e4, dtype="float64")) for n in CHAIN_1D}


@pytest.mark.parametrize("n", CHAIN_1D)
def test_chain_1d_matches_jax(jax_chain_1d, n):
    j = jax_chain_1d[n]
    t = B.solve_biharmonic_1d(B.sin_biharmonic_1d(), SolverConfig(
        num_nodes=n, M=8, gamma=1e4, dtype="float64"), device="cpu")
    for stage in ("v", "u"):
        ts, js = getattr(t, stage), getattr(j, stage)
        rel_close(ts.coeffs, js.coeffs, 1e-10)
        rel_close(ts.fem_values, js.fem_values, 1e-10)
        np.testing.assert_array_equal(ts.solve_ok.numpy(),
                                      np.asarray(js.solve_ok))


def test_chain_1d_rides_hybrid_floor():
    """tests/test_biharmonic.py's property on the port: Linf 1.2e-6 /
    1.8e-8 / 1.6e-9 at 9 / 17 / 25 nodes, the moment first-class too."""
    p = B.sin_biharmonic_1d()
    x = torch.linspace(-1.0, 1.0, 801, dtype=torch.float64)
    errs = {}
    for n in (9, 17, 25):
        sol = B.solve_biharmonic_1d(p, SolverConfig(
            num_nodes=n, M=8, gamma=1e4, dtype="float64"), device="cpu")
        assert bool(sol.u.solve_ok.all()) and bool(sol.v.solve_ok.all())
        u = ops_eval.evaluate(sol.u.nodes, sol.u.coeffs, x)
        errs[n] = float((u - p.exact(x)).abs().max())
    assert errs[9] / errs[17] > 30.0, errs
    assert errs[25] < 1e-8, errs
    v = ops_eval.evaluate(sol.v.nodes, sol.v.coeffs, x)
    assert float((v - p.exact_d2(x)).abs().max()) < 1e-7


# --------------------------------------------------------- 2D / 3D chains

CHAIN_CFGS = {"default": {}, "compact": dict(coarse="compact",
                                             trace_lift=6)}


def chain_2d_cfg(cls, case):
    return cls(nx=8, ny=8, M=6, n_colloc=6, dtype="float64",
               precond="jacobi", **CHAIN_CFGS[case])


def chain_3d_cfg(cls, case):
    return cls(nx=4, ny=4, nz=4, M=4, n_colloc=4, dtype="float64",
               **CHAIN_CFGS[case])


@pytest.fixture(scope="module")
def jax_chain_2d():
    return {case: JB.solve_biharmonic_2d(JB.sin_biharmonic_2d(),
                                         chain_2d_cfg(J2Config, case))
            for case in CHAIN_CFGS}


@pytest.fixture(scope="module")
def jax_chain_3d():
    return {case: JB.solve_biharmonic_3d(JB.sin_biharmonic_3d(),
                                         chain_3d_cfg(J3Config, case))
            for case in CHAIN_CFGS}


def compare_stages(t, j):
    for stage in ("v", "u"):
        ts, js = getattr(t, stage), getattr(j, stage)
        rel_close(ts.fem_values, js.fem_values, 1e-12)
        assert ts.cg_iters == int(js.cg_iters)
        bcv = max(float(ts.bc_violation.max()),
                  float(np.max(np.asarray(js.bc_violation))))
        close(ts.coeffs, js.coeffs, 1e-9 + bcv)
        np.testing.assert_array_equal(ts.solve_ok.numpy(),
                                      np.asarray(js.solve_ok))


@pytest.mark.parametrize("case", list(CHAIN_CFGS))
def test_chain_2d_matches_jax(jax_chain_2d, case):
    """The u-stage on the port's torch route (explicitly, and by 'auto' on
    the CPU) against JAX's XLA route."""
    for backend in ("auto", "torch"):
        cfg = dataclasses.replace(chain_2d_cfg(Solver2DConfig, case),
                                  backend=backend)
        t = B.solve_biharmonic_2d(B.sin_biharmonic_2d(), cfg, device="cpu")
        compare_stages(t, jax_chain_2d[case])


@pytest.mark.parametrize("case", list(CHAIN_CFGS))
def test_chain_3d_matches_jax(jax_chain_3d, case):
    t = B.solve_biharmonic_3d(B.sin_biharmonic_3d(),
                              chain_3d_cfg(Solver3DConfig, case),
                              device="cpu")
    compare_stages(t, jax_chain_3d[case])


def test_chain_2d_fourth_order():
    """tests/test_biharmonic.py's property on the port: O(h^4) with
    coarse='compact' + trace_lift=6 (1.97e-4 -> 1.23e-5 at 16^2 -> 32^2)."""
    p = B.sin_biharmonic_2d()
    rng = np.random.default_rng(4)
    xq = torch.tensor(rng.uniform(-1, 1, 2000))
    yq = torch.tensor(rng.uniform(-1, 1, 2000))
    errs = {}
    for n in (16, 32):
        sol = B.solve_biharmonic_2d(p, Solver2DConfig(
            nx=n, ny=n, M=6, n_colloc=6, dtype="float64", precond="jacobi",
            coarse="compact", trace_lift=6), device="cpu")
        assert bool(sol.u.solve_ok.all())
        errs[n] = float((evaluate_2d(sol.u, xq, yq)
                         - p.exact(xq, yq)).abs().max())
    assert errs[16] / errs[32] > 11.0, errs
    assert errs[32] < 5e-5, errs


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_u_stage_read_is_chunked_pointwise(monkeypatch, dim):
    """The u-stage rhs evaluates READ_CHUNK points at a time: a chunk of 7
    points gives the same chain, bit for bit."""
    runs = {
        1: lambda: B.solve_biharmonic_1d(B.sin_biharmonic_1d(), SolverConfig(
            num_nodes=9, M=8, dtype="float64"), device="cpu"),
        2: lambda: B.solve_biharmonic_2d(B.sin_biharmonic_2d(), chain_2d_cfg(
            Solver2DConfig, "default"), device="cpu"),
        3: lambda: B.solve_biharmonic_3d(B.sin_biharmonic_3d(), chain_3d_cfg(
            Solver3DConfig, "default"), device="cpu"),
    }
    whole = runs[dim]()
    monkeypatch.setattr(B, "READ_CHUNK", 7)
    chunked = runs[dim]()
    assert torch.equal(whole.u.coeffs, chunked.u.coeffs)
    assert torch.equal(whole.u.fem_values, chunked.u.fem_values)


def test_u_stage_reads_float32_moment_at_float64_points():
    """A float32 moment read at float64 points (fem_dtype='float64') is the
    float64 evaluation of the float32 solution, as JAX promotes it."""
    sol = B.solve_biharmonic_2d(B.sin_biharmonic_2d(), Solver2DConfig(
        nx=8, ny=8, M=6, n_colloc=6, dtype="float32", precond="jacobi"),
        device="cpu").v
    rhs = B._negated_reader(
        lambda fs, x, y: evaluate_2d(sol._replace(xs=fs[0], ys=fs[1],
                                                  coeffs=fs[2]), x, y),
        (sol.xs, sol.ys, sol.coeffs))
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.uniform(-1, 1, (3, 5)))
    y = torch.tensor(rng.uniform(-1, 1, (5,)))
    got = rhs(x, y)
    assert got.dtype == torch.float64 and got.shape == (3, 5)
    s64 = sol._replace(xs=sol.xs.double(), ys=sol.ys.double(),
                       coeffs=sol.coeffs.double())
    want = -evaluate_2d(s64, x.reshape(-1),
                        y.expand(3, 5).reshape(-1)).reshape(3, 5)
    assert torch.equal(got, want)


# ---------------------------------------------------------- clamped beam

BEAM = [("clamped_sin2_1d", 8), ("clamped_sin2_1d", 16),
        ("clamped_sin_slope_1d", 16)]


def beam_cfg(cls, E):
    return cls(num_nodes=E + 1, M=10, n_colloc=12, dtype="float64")


@pytest.fixture(scope="module")
def jax_beam():
    out = {}
    for name, E in BEAM:
        p, cfg = getattr(JB, name)(), beam_cfg(JConfig, E)
        bundle = JB.prepare_shared_clamped(p, cfg)
        out[(name, E)] = (JB.solve_clamped_biharmonic_1d(p, cfg, bundle),
                          bundle)
    return out


@pytest.mark.parametrize("name,E", BEAM)
def test_clamped_beam_matches_jax(jax_beam, name, E):
    j, (jshared, jt) = jax_beam[(name, E)]
    p, cfg = getattr(B, name)(), beam_cfg(SolverConfig, E)
    t = B.solve_clamped_biharmonic_1d(p, cfg, device="cpu")
    rel_close(t.u_nodal, j.u_nodal, 1e-10)
    rel_close(t.up_nodal, j.up_nodal, 1e-10)
    rel_close(t.coeffs, j.coeffs, 1e-10)
    assert bool(t.solve_ok.all()) and bool(np.all(np.asarray(j.solve_ok)))
    # Hermite nodal superconvergence, and the spectral fit
    assert float((t.u_nodal - p.exact(t.nodes)).abs().max()) < 1e-10
    assert float((t.up_nodal - p.exact_d1(t.nodes)).abs().max()) < 1e-10
    # The JAX bundle, converted, gives the port's solve the JAX coefficients.
    bundle = clamped_bundle_from_arrays(arrays(jshared), np.asarray(jt),
                                        device="cpu")
    tb = B.solve_clamped_biharmonic_1d(p, cfg, shared_bundle=bundle,
                                       device="cpu")
    rel_close(tb.coeffs, j.coeffs, 1e-10)


def test_clamped_beam_hits_hybrid_floor():
    """Linf 2.2e-10 / 2.9e-13 at E = 8 / 16 with M = 10 (JAX test's)."""
    p = B.clamped_sin2_1d()
    x = torch.linspace(-1.0, 1.0, 2001, dtype=torch.float64)
    errs = []
    for E in (8, 16):
        sol = B.solve_clamped_biharmonic_1d(p, beam_cfg(SolverConfig, E),
                                            device="cpu")
        u = ops_eval.evaluate(sol.nodes, sol.coeffs, x)
        errs.append(float((u - p.exact(x)).abs().max()))
    assert errs[0] < 1e-9 and errs[1] < 1e-11, errs


# ----------------------------------------------------------- BFS plate


def plate_cfg(cls):
    return cls(nx=8, ny=8, M=8, n_colloc=8, dtype="float64")


@pytest.fixture(scope="module")
def jax_plate():
    p, cfg = JB.clamped_sin2_2d(), plate_cfg(J2Config)
    bundle = JB.prepare_shared_clamped_2d(p, cfg)
    return JB.solve_clamped_biharmonic_2d(p, cfg, bundle), bundle


def plate_tol(t, j, bundle):
    """1e-9 plus the larger trace violation |B w - T u| of the two."""
    shared, _, T_all = bundle
    Bm = torch.tensor(np.asarray(shared.B))
    bc = torch.einsum("yxl,pl->yxp", B._bfs_gather(t.u_nodal),
                      torch.tensor(np.asarray(T_all))).reshape(64, -1)
    viol = [float((torch.tensor(np.asarray(c)).reshape(64, -1) @ Bm.T
                   - bc).abs().max()) for c in (t.coeffs, j.coeffs)]
    return 1e-9 + max(viol)


def test_bfs_plate_matches_jax(jax_plate):
    j, jbundle = jax_plate
    p, cfg = B.clamped_sin2_2d(), plate_cfg(Solver2DConfig)
    t = B.solve_clamped_biharmonic_2d(p, cfg, device="cpu")
    rel_close(t.u_nodal, j.u_nodal, 1e-12)
    assert t.cg_iters == int(j.cg_iters)
    close(t.coeffs, j.coeffs, plate_tol(t, j, jbundle))
    np.testing.assert_array_equal(t.solve_ok.numpy(), np.asarray(j.solve_ok))
    rng = np.random.default_rng(0)
    xq, yq = rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500)
    u = B.evaluate_clamped_2d(t, torch.tensor(xq), torch.tensor(yq))
    ju = JB.evaluate_clamped_2d(j, jnp.asarray(xq), jnp.asarray(yq))
    close(u, ju, 4 * plate_tol(t, j, jbundle))


def test_bfs_plate_rank_deficient_bundle_through_convert(jax_plate):
    """The JAX plate bundle (SVD route: B of rank 8M-16 of 8M-4 rows),
    converted by clamped_bundle_from_arrays, gives the port's solve the JAX
    coefficients; the port's own precompute has the same null space
    dimension and particular map."""
    j, (jshared, jt, jT) = jax_plate
    p, cfg = B.clamped_sin2_2d(), plate_cfg(Solver2DConfig)
    bundle = clamped_bundle_from_arrays(arrays(jshared), np.asarray(jt),
                                        np.asarray(jT), device="cpu")
    t = B.solve_clamped_biharmonic_2d(p, cfg, shared_bundle=bundle,
                                      device="cpu")
    close(t.coeffs, j.coeffs, plate_tol(t, j, (jshared, jt, jT)))
    shared, t_int, T_all = B.prepare_shared_clamped_2d(p, cfg)
    close(t_int, np.asarray(jt), 0)
    close(T_all, np.asarray(jT), 1e-12)
    for name in ("Wf", "Wbc", "D", "B", "Pres", "Qres"):
        rel_close(getattr(shared, name), np.asarray(getattr(jshared, name)),
                  1e-9)


def test_bfs_coarse_and_plate_fourth_order():
    """tests/test_biharmonic.py's properties on the port: nodal values
    O(h^4) (3.8e-3 / 2.7e-4 at 8 / 16) and the plate at its trace-limited
    O(h^4) rate (5.7e-3 / 4.5e-4 with M = 10)."""
    p = B.clamped_sin2_2d()
    rng = np.random.default_rng(0)
    xq = torch.tensor(rng.uniform(-1, 1, 2000))
    yq = torch.tensor(rng.uniform(-1, 1, 2000))
    nodal, errs = [], []
    for n in (8, 16):
        cfg = Solver2DConfig(nx=n, ny=n, M=10, n_colloc=10, dtype="float64")
        sol = B.solve_clamped_biharmonic_2d(p, cfg, device="cpu")
        assert bool(sol.solve_ok.all())
        X, Y = torch.meshgrid(sol.xs, sol.ys, indexing="xy")
        nodal.append(float((sol.u_nodal[..., 0] - p.exact(X, Y))
                           .abs().max()))
        errs.append(float((B.evaluate_clamped_2d(sol, xq, yq)
                           - p.exact(xq, yq)).abs().max()))
    assert nodal[0] / nodal[1] > 10.0, nodal
    assert errs[0] < 1e-2 and errs[1] < 7e-4 and errs[0] / errs[1] > 8.0


# ------------------------------------------------------------------ gates


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_clamped_gates_raise_as_in_jax(pkg):
    mod, c1, c2 = ((JB, JConfig, J2Config) if pkg == "jax"
                   else (B, SolverConfig, Solver2DConfig))
    with pytest.raises(ValueError, match="float64"):
        mod.prepare_shared_clamped(mod.clamped_sin2_1d(), c1(
            num_nodes=17, M=8, dtype="float32"))
    with pytest.raises(ValueError, match="M >= 6"):
        mod.prepare_shared_clamped(mod.clamped_sin2_1d(), c1(
            num_nodes=17, M=5, dtype="float64"))
    with pytest.raises(ValueError, match="float64"):
        mod.prepare_shared_clamped_2d(mod.clamped_sin2_2d(), c2(
            nx=8, ny=8, M=8, n_colloc=8, dtype="float32"))
    with pytest.raises(ValueError, match="M >= 6"):
        mod.prepare_shared_clamped_2d(mod.clamped_sin2_2d(), c2(
            nx=8, ny=8, M=5, n_colloc=5, dtype="float64"))
