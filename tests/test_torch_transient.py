"""The port's time marches (``models/transient.py``) against the JAX
package, float64 on the CPU, and the reference's own properties of
``tests/test_transient.py`` on the port alone.

Against JAX (each JAX march runs once per module): 1D at 17 nodes, 2D at
8^2 (M = C = 6), 16 steps.  Nodal values (and the wave marches' nodal
velocities) within 1e-12 of their size, coefficients within 1e-9 of
theirs, ``cg_iters`` within 1; the adaptive marches' accepted and
rejected counts equal and ``t_reached`` within 1e-14.  The host maps
(``_shared_cn_operators``, ``_shared_cn_ops_2d``) within 1e-12, also once
through ``convert.shared_operators_from_arrays`` from JAX's bundle.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import transient as JT
from hybrid_fem_lssvr_tpu.models.hybrid import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models.hybrid2d import Solver2DConfig as J2Config

from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, SolverConfig
from hybrid_fem_lssvr_tpu_torch.models import problems as P
from hybrid_fem_lssvr_tpu_torch.models import transient as TR
from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import (Solution2D,
                                                        evaluate_2d)
from hybrid_fem_lssvr_tpu_torch.ops import eval as ev
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

T = 0.5
X = torch.linspace(-1, 1, 401, dtype=torch.float64)
CPU = dict(device="cpu")


def rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


# ------------------------------------------------------- against JAX

TC = dict(t_final=0.25, n_steps=16)
CFG1 = dict(num_nodes=17, M=8, gamma=1e4)
CFG2 = dict(nx=8, ny=8, M=6, n_colloc=6)

# (name, march, problem, mass, extra keyword arguments, dimension)
MARCHES = [
    ("fem_march", "fem_march", "heat_1d", "consistent", {}, 1),
    ("fem_march/numerov", "fem_march", "heat_1d", "numerov", {}, 1),
    ("fem_march/robin", "fem_march", "heat_robin_1d", "consistent", {}, 1),
    ("fem_march/be", "fem_march", "heat_1d", "consistent", {}, 1),
    ("hybrid_march", "hybrid_march", "heat_1d", "numerov", {}, 1),
    ("hybrid_march/robin", "hybrid_march", "heat_robin_1d", "consistent",
     {}, 1),
    ("wave_march", "wave_march", "wave_1d", "numerov", {}, 1),
    ("wave_march/beta", "wave_march", "wave_1d", "consistent",
     {"beta": 0.3, "gamma_n": 0.6}, 1),
    ("hybrid_wave_march", "hybrid_wave_march", "wave_1d", "numerov", {}, 1),
    ("fem_march_semilinear", "fem_march_semilinear", "semilinear_heat_1d",
     "numerov", {}, 1),
    ("hybrid_march_semilinear", "hybrid_march_semilinear",
     "semilinear_heat_1d", "consistent", {}, 1),
    ("fem_march_2d", "fem_march_2d", "heat_2d", "consistent", {}, 2),
    ("fem_march_2d/numerov", "fem_march_2d", "heat_2d", "numerov", {}, 2),
    ("hybrid_march_2d", "hybrid_march_2d", "heat_2d", "numerov", {}, 2),
    ("hybrid_march_2d/lift6", "hybrid_march_2d", "heat_2d", "numerov",
     {"trace_lift": 6}, 2),
    ("wave_march_2d", "wave_march_2d", "wave_2d", "consistent", {}, 2),
    ("hybrid_wave_march_2d", "hybrid_wave_march_2d", "wave_2d", "numerov",
     {"trace_lift": 6}, 2),
    ("fem_march_semilinear_2d", "fem_march_semilinear_2d",
     "semilinear_heat_2d", "numerov", {}, 2),
    ("hybrid_march_semilinear_2d", "hybrid_march_semilinear_2d",
     "semilinear_heat_2d", "numerov", {}, 2),
]


def _tcfg(mod, name, mass):
    theta = 1.0 if name.endswith("/be") else 0.5
    return mod.TransientConfig(mass=mass, theta=theta, **TC)


def _run(mod, name, march, prob, mass, extra, dim, **kw):
    cfg = (JConfig(**CFG1) if mod is JT else SolverConfig(**CFG1)) \
        if dim == 1 else \
        (J2Config(**CFG2) if mod is JT else Solver2DConfig(**CFG2))
    out = getattr(mod, march)(getattr(mod, prob)(), cfg,
                              _tcfg(mod, name, mass), **extra, **kw)
    return out if isinstance(out, tuple) and len(out) == 2 else (out, None)


@pytest.fixture(scope="module")
def jax_marches():
    return {m[0]: _run(JT, *m) for m in MARCHES}


@pytest.mark.parametrize("case", MARCHES, ids=[m[0] for m in MARCHES])
def test_march_matches_jax(jax_marches, case):
    (j, jv), (t, tv) = jax_marches[case[0]], _run(TR, *case, **CPU)
    rel_close(t.fem_values, j.fem_values, 1e-12)
    if jv is not None:  # the Newmark marches' nodal velocity
        rel_close(tv, jv, 1e-12)
    assert (t.coeffs is None) == (j.coeffs is None)
    if t.coeffs is not None:
        rel_close(t.coeffs, j.coeffs, 1e-9)
    if case[5] == 2:
        assert abs(t.cg_iters - int(j.cg_iters)) <= 1
        rel_close(t.xs, j.xs, 1e-15)
    else:
        rel_close(t.nodes, j.nodes, 1e-15)
    assert t.t_final == j.t_final


ADAPTIVE = [
    ("1d", dict(t_final=0.5, tol=1e-4, max_attempts=48)),
    ("1d/dt0", dict(t_final=0.5, tol=3e-5, dt0=0.05, max_attempts=80)),
    ("2d", dict(t_final=0.5, tol=1e-4, max_attempts=64)),
]


def _adaptive(mod, dim, kw, **extra):
    if dim.startswith("1d"):
        cfg = (JConfig if mod is JT else SolverConfig)(num_nodes=17)
        return mod.fem_march_adaptive(mod.heat_1d(), cfg, **kw, **extra)
    cfg = (J2Config if mod is JT else Solver2DConfig)(**CFG2)
    return mod.fem_march_adaptive_2d(mod.heat_2d(), cfg, **kw, **extra)


@pytest.fixture(scope="module")
def jax_adaptive():
    return {dim: _adaptive(JT, dim, kw) for dim, kw in ADAPTIVE}


@pytest.mark.parametrize("dim,kw", ADAPTIVE, ids=[a[0] for a in ADAPTIVE])
def test_adaptive_matches_jax(jax_adaptive, dim, kw):
    j, t = jax_adaptive[dim], _adaptive(TR, dim, kw, **CPU)
    # the budget reaches t_final, where t lands exactly
    assert abs(float(j.t_reached) - kw["t_final"]) < 1e-14
    assert abs(float(t.t_reached) - float(j.t_reached)) <= 1e-14
    assert int(t.accepted) == int(j.accepted)
    assert int(t.rejected) == int(j.rejected)
    assert t.accepted.dtype == t.rejected.dtype == torch.int32
    rel_close(t.solution.fem_values, j.solution.fem_values, 1e-12)
    rel_close(t.max_err, j.max_err, 1e-9)


def _fields(shared):
    """A bundle's non-None fields (the port's dataclass or JAX's
    NamedTuple) as numpy arrays."""
    d = shared._asdict() if hasattr(shared, "_asdict") else {
        f.name: getattr(shared, f.name) for f in dataclasses.fields(shared)}
    return {k: np.asarray(v) for k, v in d.items() if v is not None}


def _same_maps(port, jax_, rtol=1e-12):
    pf, jf = _fields(port), _fields(jax_)
    assert sorted(pf) == sorted(jf)
    for k in pf:
        rel_close(pf[k], jf[k], rtol)


@pytest.mark.parametrize("name", ["heat_1d", "heat_robin_1d"])
def test_shared_cn_operators_match_jax(name):
    dt = 0.25 / 16
    cfg_t, cfg_j = SolverConfig(**CFG1), JConfig(**CFG1)
    tp, jp = getattr(TR, name)(), getattr(JT, name)()
    t_sh, *t_rest = TR._shared_cn_operators(tp, cfg_t, dt)
    j_sh, *j_rest = JT._shared_cn_operators(jp, cfg_j, dt)
    _same_maps(t_sh, j_sh)
    for a, b in zip(t_rest, j_rest):
        rel_close(a, b, 1e-12)
    # JAX's bundle carried across, as the marches would use it
    conv = convert.shared_operators_from_arrays(_fields(j_sh),
                                                device="cpu",
                                                dtype=torch.float64)
    _same_maps(conv, j_sh, 0.0)
    _same_maps(t_sh, conv)


def test_shared_cn_ops_2d_match_jax():
    dt = 0.25 / 16
    pt, pj = TR.heat_2d().elliptic, JT.heat_2d().elliptic
    t_sh, t_proj, t_R, t_int, bpts = TR._shared_cn_ops_2d(
        pt, Solver2DConfig(**CFG2), dt)
    j_sh, j_proj, j_R, j_int, j_bpts = JT._shared_cn_ops_2d(
        pj, J2Config(**CFG2), dt)
    _same_maps(t_sh, j_sh)
    _same_maps(t_proj, j_proj)
    rel_close(t_R, j_R, 1e-12)
    np.testing.assert_array_equal(t_int, j_int)
    np.testing.assert_array_equal(bpts, j_bpts)
    conv = convert.shared_operators_from_arrays(_fields(j_sh),
                                                device="cpu",
                                                dtype=torch.float64)
    _same_maps(t_sh, conv)
    for a, b in zip(TR._mass_dl_b_2d(pt, Solver2DConfig(**CFG2)),
                    JT._mass_dl_b_2d(pj, J2Config(**CFG2))):
        rel_close(a, b, 1e-12)


def test_numerov_pieces_match_jax():
    nodes_t = torch.linspace(-1, 1, 17, dtype=torch.float64)
    nodes_j = jnp.linspace(-1, 1, 17)
    t_p, j_p = TR.heat_1d(), JT.heat_1d()
    A, Mm, ell, load = TR._numerov_setup(t_p.elliptic, nodes_t, t_p.f)
    Aj, Mj, ellj, loadj = JT._numerov_setup(j_p.elliptic, nodes_j, j_p.f)
    for a, b in zip(A + Mm + (ell, load(torch.tensor(0.1, dtype=torch
                                                         .float64))),
                    Aj + Mj + (ellj, loadj(jnp.asarray(0.1)))):
        rel_close(a, b, 1e-14)
    cfg_t, cfg_j = SolverConfig(**CFG1), JConfig(**CFG1)
    rp_t, rp_j = TR.heat_robin_1d().elliptic, JT.heat_robin_1d().elliptic
    for a, b in zip(TR._operator_and_mass(rp_t, nodes_t, cfg_t),
                    JT._operator_and_mass(rp_j, nodes_j, cfg_j)):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            rel_close(x, y, 1e-14)


# ------------------------------------- the reference's properties, 1D


def _nodal_err(problem, sol, t=T):
    return float((sol.fem_values - problem.exact(sol.nodes, t)).abs().max())


def test_cn_is_second_order_in_time():
    """dt-halving at fine h (Numerov keeps the h-floor out of the way)."""
    p = TR.heat_1d()
    cfg = SolverConfig(num_nodes=129)
    errs = {n: _nodal_err(p, TR.fem_march(p, cfg, TR.TransientConfig(
        t_final=T, n_steps=n, mass="numerov"), **CPU)) for n in (4, 8)}
    order = np.log2(errs[4] / errs[8])
    assert 1.7 < order < 2.3, (errs, order)


def test_backward_euler_is_first_order():
    p = TR.heat_1d()
    cfg = SolverConfig(num_nodes=129)
    errs = {n: _nodal_err(p, TR.fem_march(p, cfg, TR.TransientConfig(
        t_final=T, n_steps=n, theta=1.0, mass="numerov"), **CPU))
        for n in (8, 16)}
    order = np.log2(errs[8] / errs[16])
    assert 0.7 < order < 1.3, (errs, order)


def test_mass_orders_h2_consistent_h4_numerov():
    """h-halving at tiny dt: consistent mass O(h^2), Numerov O(h^4).
    512 steps: the reference's 2,048 give the same orders to 1e-4."""
    p = TR.heat_1d()
    e_c, e_n = {}, {}
    for E in (8, 16):
        for mass, errs in (("consistent", e_c), ("numerov", e_n)):
            errs[E] = _nodal_err(p, TR.fem_march(
                p, SolverConfig(num_nodes=E + 1),
                TR.TransientConfig(t_final=T, n_steps=512, mass=mass),
                **CPU))
    assert 1.7 < np.log2(e_c[8] / e_c[16]) < 2.3, e_c
    assert 3.5 < np.log2(e_n[8] / e_n[16]) < 4.5, e_n
    assert e_n[16] < 0.15 * e_c[16]


def test_hybrid_march_rides_the_nodal_floor():
    """Enhanced CN march: Linf over the whole interval within 3x the
    march's nodal error, >50x better than the P1 interpolant."""
    p = TR.heat_1d()
    cfg = SolverConfig(num_nodes=17, M=8, gamma=1e4)
    sol = TR.hybrid_march(p, cfg, TR.TransientConfig(
        t_final=T, n_steps=512, mass="numerov"), **CPU)
    uex = p.exact(X, T)
    linf = float((ev.evaluate(sol.nodes, sol.coeffs, X) - uex).abs().max())
    nodal = _nodal_err(p, sol)
    assert linf < 3.0 * nodal + 1e-12, (linf, nodal)
    up1 = np.interp(X.numpy(), sol.nodes.numpy(), sol.fem_values.numpy())
    p1_linf = float(np.abs(up1 - uex.numpy()).max())
    assert linf < p1_linf / 50.0, (linf, p1_linf)


def test_transient_robin_march():
    """Robin ends with time-independent data: consistent-mass CN
    converges at O(h^2) with the natural-BC load in every step (256
    steps; the reference's 1,024 give the same order to 1e-4)."""
    p = TR.heat_robin_1d()
    errs = {E: _nodal_err(p, TR.fem_march(
        p, SolverConfig(num_nodes=E + 1),
        TR.TransientConfig(t_final=T, n_steps=256), **CPU))
        for E in (16, 32)}
    order = np.log2(errs[16] / errs[32])
    assert 1.6 < order < 2.4, (errs, order)


def test_transient_guards():
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        TR.fem_march(TR.heat_robin_1d(), SolverConfig(num_nodes=17),
                     TR.TransientConfig(mass="numerov"), **CPU)
    with pytest.raises(ValueError, match="0.5"):
        TR.hybrid_march(TR.heat_1d(), SolverConfig(num_nodes=17),
                        TR.TransientConfig(theta=1.0), **CPU)
    varcoeff = dataclasses.replace(
        TR.heat_1d(), elliptic=P.variable_coeff_elliptic())
    with pytest.raises(NotImplementedError, match="constant"):
        TR.hybrid_march(varcoeff, SolverConfig(num_nodes=17),
                        TR.TransientConfig(), **CPU)
    p2 = TR.heat_2d()
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        TR.fem_march_2d(dataclasses.replace(p2, elliptic=dataclasses.replace(
            p2.elliptic, bc_edges=("dirichlet", "neumann", "dirichlet",
                                   "dirichlet"))),
            Solver2DConfig(nx=4, ny=4), TR.TransientConfig(), **CPU)


# ------------------------------------- the reference's properties, 2D


def _grid_err(problem, sol, t):
    Y, Xg = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
    return float((sol.fem_values - problem.exact(Xg, Y, t)).abs().max())


def _enhanced_err_2d(problem, sol, t, n=2000):
    rng = np.random.default_rng(3)
    xq = torch.tensor(rng.uniform(-1, 1, n))
    yq = torch.tensor(rng.uniform(-1, 1, n))
    z = torch.zeros(())
    s2 = Solution2D(sol.xs, sol.ys, sol.fem_values, sol.coeffs, 0, z, z, z,
                    z)
    return float((evaluate_2d(s2, xq, yq)
                  - problem.exact(xq, yq, t)).abs().max())


def test_fem_march_2d_orders():
    """2D CN march: consistent mass O(h^2) nodal, tensor Numerov mass
    O(h^4) nodal; the mass-dominated system takes few CG iterations."""
    p = TR.heat_2d()
    e_c, e_n = {}, {}
    for n in (8, 16):
        cfg = Solver2DConfig(nx=n, ny=n, M=4, n_colloc=4)
        for mass, errs in (("consistent", e_c), ("numerov", e_n)):
            sol = TR.fem_march_2d(p, cfg, TR.TransientConfig(
                t_final=T, n_steps=256, mass=mass), **CPU)
            errs[n] = _grid_err(p, sol, T)
            assert sol.cg_iters <= 8
    assert 1.7 < np.log2(e_c[8] / e_c[16]) < 2.4, e_c
    assert 3.4 < np.log2(e_n[8] / e_n[16]) < 4.6, e_n


def test_hybrid_march_2d_matches_steady_floor():
    """2D enhanced CN march: the Linf floor is the Q1 bilinear trace
    error, O(h^2)."""
    p = TR.heat_2d()
    errs = {}
    for n in (8, 16):
        cfg = Solver2DConfig(nx=n, ny=n, M=6, n_colloc=6)
        hs = TR.hybrid_march_2d(p, cfg, TR.TransientConfig(
            t_final=T, n_steps=128, mass="numerov"), **CPU)
        errs[n] = _enhanced_err_2d(p, hs, T)
    order = np.log2(errs[8] / errs[16])
    assert 1.5 < order < 2.5, (errs, order)
    assert errs[16] < 2e-2


def test_hybrid_march_2d_trace_lift_fourth_order():
    """trace_lift=6 + numerov mass: the O(h^4) nodal accuracy carries
    through the lifted traces to the enhanced Linf."""
    p = TR.heat_2d()
    errs = {}
    for n, n_steps in ((8, 64), (16, 256)):
        cfg = Solver2DConfig(nx=n, ny=n, M=6, n_colloc=6)
        hs = TR.hybrid_march_2d(p, cfg, TR.TransientConfig(
            t_final=T, n_steps=n_steps, mass="numerov"), trace_lift=6,
            **CPU)
        errs[n] = _enhanced_err_2d(p, hs, T)
    assert errs[8] / errs[16] > 10.0, errs
    assert errs[16] < 2e-4, errs


# ----------------------------------------------------------- wave


def test_wave_march_orders():
    """Newmark beta=1/4 free vibration: the Numerov mass keeps the nodal
    dispersion at O(h^4); consistent mass is O(h^2) (512 steps; the
    reference's 1,024 give the same ratios to 2%)."""
    p = TR.wave_1d()
    Tw = 0.7
    errs = {}
    for mass in ("consistent", "numerov"):
        for E in (8, 16):
            sol, _ = TR.wave_march(p, SolverConfig(num_nodes=E + 1),
                                   TR.TransientConfig(t_final=Tw,
                                                      n_steps=512,
                                                      mass=mass), **CPU)
            errs[mass, E] = _nodal_err(p, sol, Tw)
    assert errs["numerov", 8] < 0.05 * errs["consistent", 8], errs
    assert errs["numerov", 16] < 0.1 * errs["numerov", 8], errs


def test_wave_energy_conservation():
    """f = 0, gamma = 1/2, beta = 1/4 conserves the discrete energy: at
    t = 2 (one period) the solution returns to u0."""
    p = TR.wave_1d()
    sol, _ = TR.wave_march(p, SolverConfig(num_nodes=33),
                           TR.TransientConfig(t_final=2.0, n_steps=512,
                                              mass="numerov"), **CPU)
    assert float((sol.fem_values - p.u0(sol.nodes)).abs().max()) < 1e-3


def test_hybrid_wave_march_floor():
    """Enhanced Newmark march: >20x better than the P1 interpolant at
    E = 8."""
    p = TR.wave_1d()
    Tw = 0.7
    sol, _ = TR.hybrid_wave_march(p, SolverConfig(num_nodes=9, M=8,
                                                  gamma=1e4),
                                  TR.TransientConfig(t_final=Tw,
                                                     n_steps=256,
                                                     mass="numerov"), **CPU)
    uex = p.exact(X, Tw)
    linf = float((ev.evaluate(sol.nodes, sol.coeffs, X) - uex).abs().max())
    up1 = np.interp(X.numpy(), sol.nodes.numpy(), sol.fem_values.numpy())
    p1_linf = float(np.abs(up1 - uex.numpy()).max())
    assert linf < p1_linf / 20.0, (linf, p1_linf)
    assert linf < 5e-3


def test_wave_march_2d_orders():
    """2D Newmark free vibration: tensor-Numerov mass keeps O(h^4) nodal
    dispersion; consistent mass is O(h^2)."""
    p = TR.wave_2d()
    Tw = 0.6
    errs = {}
    for mass in ("consistent", "numerov"):
        for n in (8, 16):
            sol, _ = TR.wave_march_2d(
                p, Solver2DConfig(nx=n, ny=n, M=4, n_colloc=4),
                TR.TransientConfig(t_final=Tw, n_steps=256, mass=mass),
                **CPU)
            errs[mass, n] = _grid_err(p, sol, Tw)
    assert errs["numerov", 8] < 0.1 * errs["consistent", 8], errs
    order = np.log2(errs["numerov", 8] / errs["numerov", 16])
    assert 3.3 < order < 4.7, (errs, order)


def test_hybrid_wave_march_2d_trace_lift_rides_nodal_floor():
    """trace_lift=6 + numerov mass puts the enhanced Linf at the O(h^4)
    nodal dispersion floor; bilinear traces are >20x worse."""
    p = TR.wave_2d()
    cfg = Solver2DConfig(nx=16, ny=16, M=6, n_colloc=6, precond="jacobi")
    tcfg = TR.TransientConfig(t_final=0.5, n_steps=512, mass="numerov")
    sol, _ = TR.hybrid_wave_march_2d(p, cfg, tcfg, trace_lift=6, **CPU)
    err = _enhanced_err_2d(p, sol, 0.5)
    nodal = _grid_err(p, sol, 0.5)
    assert err < 3.0 * nodal, (err, nodal)
    assert err < 3e-4, err
    sol0, _ = TR.hybrid_wave_march_2d(p, cfg, tcfg, **CPU)
    err0 = _enhanced_err_2d(p, sol0, 0.5)
    assert err0 > 20.0 * err, (err0, err)


# ---------------------------------------------- semilinear (IMEX CNAB)


def test_semilinear_march_numerov_fourth_order():
    """IMEX CNAB on u_t - u_xx + u^3 = f: nodal O(h^4) with the numerov
    mass once dt is resolved."""
    p = TR.semilinear_heat_1d()
    errs = {}
    for N, n_steps in ((17, 400), (33, 1600)):
        sol = TR.fem_march_semilinear(
            p, SolverConfig(num_nodes=N, M=8, gamma=1e4, dtype="float64"),
            TR.TransientConfig(t_final=1.0, n_steps=n_steps,
                               mass="numerov"), **CPU)
        errs[N] = _nodal_err(p, sol, 1.0)
    assert errs[17] / errs[33] > 11.0, errs
    assert errs[33] < 1e-5


def test_semilinear_march_second_order_in_dt():
    """Halving dt quarters the time error (AB2 keeps the CN order)."""
    p = TR.semilinear_heat_1d()
    cfg = SolverConfig(num_nodes=17, M=8, gamma=1e4, dtype="float64")
    errs = {n: _nodal_err(p, TR.fem_march_semilinear(
        p, cfg, TR.TransientConfig(t_final=1.0, n_steps=n, mass="numerov"),
        **CPU), 1.0) for n in (25, 50)}
    floor = 3.92e-5  # spatial floor at 17 nodes
    assert (errs[25] - floor) / max(errs[50] - floor, 1e-12) > 3.0, errs


def test_semilinear_hybrid_march_hits_nodal_floor():
    """The enhanced semilinear march's Linf everywhere is at the numerov
    nodal floor, and the nonlinearity is load-bearing."""
    p = TR.semilinear_heat_1d()
    cfg = SolverConfig(num_nodes=17, M=8, gamma=1e4, dtype="float64")
    tcfg = TR.TransientConfig(t_final=1.0, n_steps=200, mass="numerov")
    sol = TR.hybrid_march_semilinear(p, cfg, tcfg, **CPU)
    x = torch.linspace(-1.0, 1.0, 801, dtype=torch.float64)
    err = float((ev.evaluate(sol.nodes, sol.coeffs, x)
                 - p.exact(x, 1.0)).abs().max())
    assert err < 1e-4, err
    p0 = dataclasses.replace(p, s=lambda v: 0.0 * v)
    err0 = _nodal_err(p, TR.fem_march_semilinear(p0, cfg, tcfg, **CPU), 1.0)
    assert err0 > 50.0 * err, (err0, err)


def test_semilinear_march_2d_numerov_fourth_order():
    p = TR.semilinear_heat_2d()
    errs = {}
    for n, n_steps in ((8, 50), (16, 200)):
        cfg = Solver2DConfig(nx=n, ny=n, M=6, n_colloc=6, dtype="float64",
                             precond="jacobi")
        sol = TR.fem_march_semilinear_2d(p, cfg, TR.TransientConfig(
            t_final=1.0, n_steps=n_steps, mass="numerov"), **CPU)
        errs[n] = _grid_err(p, sol, 1.0)
    assert errs[8] / errs[16] > 11.0, errs
    assert errs[16] < 1e-4


def test_semilinear_hybrid_march_2d_tracks_exact():
    """2D enhanced semilinear march: Linf at the bilinear trace floor,
    nodal values at the numerov O(h^4) floor; trace_lift=6 lifts the
    enhanced Linf to O(h^4) class."""
    p = TR.semilinear_heat_2d()
    cfg = Solver2DConfig(nx=16, ny=16, M=6, n_colloc=6, dtype="float64",
                         precond="jacobi")
    tcfg = TR.TransientConfig(t_final=1.0, n_steps=200, mass="numerov")
    sol = TR.hybrid_march_semilinear_2d(p, cfg, tcfg, **CPU)
    assert _enhanced_err_2d(p, sol, 1.0, 1500) < 2e-2
    assert _grid_err(p, sol, 1.0) < 1e-4
    lifted = TR.hybrid_march_semilinear_2d(p, cfg, tcfg, trace_lift=6, **CPU)
    assert _enhanced_err_2d(p, lifted, 1.0, 1500) < 3e-4


# ------------------------------------------------- adaptive time steps


def _burst_problem():
    """Exact u = e^{-t}(1 + e^{-((t-.5)/.05)^2}) sin(pi x): a temporal
    burst at t = 0.5 that an error-controlled march must resolve."""
    pi, tau = torch.pi, 0.05

    def amp(t):
        t = torch.as_tensor(t, dtype=torch.float64)
        return torch.exp(-t) * (1.0 + torch.exp(-((t - 0.5) / tau) ** 2))

    def damp(t):
        t = torch.as_tensor(t, dtype=torch.float64)
        g = torch.exp(-((t - 0.5) / tau) ** 2)
        return -amp(t) + torch.exp(-t) * g * (-2.0 * (t - 0.5) / tau ** 2)

    return TR.TransientProblem1D(
        name="burst",
        elliptic=dataclasses.replace(P.poisson_1d(), name="burst_op"),
        f=lambda x, t: (damp(t) + pi ** 2 * amp(t)) * torch.sin(pi * x),
        u0=lambda x: amp(0.0) * torch.sin(pi * x),
        exact=lambda x, t: amp(t) * torch.sin(pi * x),
    )


def test_adaptive_march_error_control():
    """The embedded CN/BE controller reaches t_final within the budget,
    every accepted step meets the local tolerance, and the final error
    respects it (512 attempts; the reference's 1,024 are more than twice
    the ~300 it takes, and the attempts after t_final change nothing)."""
    p = _burst_problem()
    cfg = SolverConfig(num_nodes=65, M=8, gamma=1e4, dtype="float64")
    res = TR.fem_march_adaptive(p, cfg, t_final=1.0, tol=1e-4,
                                max_attempts=512, **CPU)
    assert float(res.t_reached) == pytest.approx(1.0, abs=1e-10)
    assert float(res.max_err) <= 1e-4
    assert int(res.rejected) > 0  # the burst forces rejections
    assert int(res.accepted) + int(res.rejected) < 512
    assert _nodal_err(p, res.solution, 1.0) < 1e-4


def test_adaptive_march_step_count_scales_with_tol():
    """dt ~ sqrt(tol): 10x tighter tolerance costs ~sqrt(10)x the steps
    (budgets 160 and 400 where the reference gives 2,048 to both; each
    run must still reach t_final)."""
    p = _burst_problem()
    cfg = SolverConfig(num_nodes=33, M=8, gamma=1e4, dtype="float64")
    acc = {}
    for tol, budget in ((1e-3, 160), (1e-4, 400)):
        res = TR.fem_march_adaptive(p, cfg, t_final=1.0, tol=tol,
                                    max_attempts=budget, **CPU)
        assert float(res.t_reached) == pytest.approx(1.0, abs=1e-10)
        acc[tol] = int(res.accepted)
    assert 2.0 < acc[1e-4] / acc[1e-3] < 5.0, acc


def test_adaptive_march_2d_error_control():
    """2D lift: two Jacobi-CG solves an attempt, error control holds; the
    Linf is the consistent-mass O(h^2) floor at 16^2 (128 attempts, the
    reference's 256; it takes ~106)."""
    p = TR.heat_2d()
    cfg = Solver2DConfig(nx=16, ny=16, M=4, n_colloc=4, dtype="float64",
                         precond="jacobi")
    res = TR.fem_march_adaptive_2d(p, cfg, t_final=0.5, tol=1e-5,
                                   max_attempts=128, **CPU)
    assert float(res.t_reached) == pytest.approx(0.5, abs=1e-10)
    assert float(res.max_err) <= 1e-5
    assert int(res.accepted) + int(res.rejected) < 128
    assert _grid_err(p, res.solution, 0.5) < 2e-2
