"""The port's 3D time marches (``models/transient.py``) against the JAX
package, float64 on the CPU, and the reference's own 3D properties of
``tests/test_transient.py`` on the port alone.

Against JAX (each JAX march runs once per module): 4^3 hexes for the
unlifted marches and 6^3 for ``trace_lift=6`` (the lift needs six nodes a
grid line), M = C = 4, 8 steps.  Nodal values (and the wave marches'
nodal velocities) within 1e-12 of their size, coefficients within 1e-9 of
theirs, ``cg_iters`` within 1; the adaptive march's accepted and rejected
counts equal and ``t_reached`` within 1e-14.  The host pieces
(``_locals_3d``, ``_mass_dl_b_3d``, ``_shared_cn_ops_3d``) within 1e-13,
the shared maps also once through ``convert.shared_operators_from_arrays``
from JAX's bundle.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hybrid_fem_lssvr_tpu.models import transient as JT
from hybrid_fem_lssvr_tpu.models.hybrid3d import Solver3DConfig as J3Config

from hybrid_fem_lssvr_tpu_torch import Solver3DConfig
from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
from hybrid_fem_lssvr_tpu_torch.models import transient as TR
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

CPU = dict(device="cpu")


def rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


# ------------------------------------------------------- against JAX

TC = dict(t_final=0.25, n_steps=8)

# (name, march, problem, mass, extra keyword arguments, n)
MARCHES = [
    ("fem_march_3d", "fem_march_3d", "heat_3d", "consistent", {}, 4),
    ("fem_march_3d/numerov", "fem_march_3d", "heat_3d", "numerov", {}, 4),
    ("hybrid_march_3d", "hybrid_march_3d", "heat_3d", "numerov", {}, 4),
    ("hybrid_march_3d/lift6", "hybrid_march_3d", "heat_3d", "numerov",
     {"trace_lift": 6}, 6),
    ("wave_march_3d", "wave_march_3d", "wave_3d", "numerov", {}, 4),
    ("wave_march_3d/beta", "wave_march_3d", "wave_3d", "consistent",
     {"beta": 0.3, "gamma_n": 0.6}, 4),
    ("hybrid_wave_march_3d/lift6", "hybrid_wave_march_3d", "wave_3d",
     "numerov", {"trace_lift": 6}, 6),
    ("fem_march_semilinear_3d", "fem_march_semilinear_3d",
     "semilinear_heat_3d", "numerov", {}, 4),
    ("hybrid_march_semilinear_3d", "hybrid_march_semilinear_3d",
     "semilinear_heat_3d", "consistent", {}, 4),
]


def _cfg(mod, n, **kw):
    cls = J3Config if mod is JT else Solver3DConfig
    return cls(nx=n, ny=n, nz=n, M=4, n_colloc=4, dtype="float64", **kw)


def _run(mod, name, march, prob, mass, extra, n, **kw):
    tcfg = mod.TransientConfig(mass=mass, **TC)
    out = getattr(mod, march)(getattr(mod, prob)(), _cfg(mod, n), tcfg,
                              **extra, **kw)
    return out if "wave" in march else (out, None)


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
    assert abs(t.cg_iters - int(j.cg_iters)) <= 1
    for a, b in zip((t.xs, t.ys, t.zs), (j.xs, j.ys, j.zs)):
        rel_close(a, b, 1e-15)
    assert t.t_final == j.t_final


ADAPTIVE = dict(t_final=0.25, tol=3e-3, max_attempts=40)


def _adaptive(mod, **kw):
    return mod.fem_march_adaptive_3d(mod.heat_3d(), _cfg(mod, 4),
                                     **ADAPTIVE, **kw)


def test_adaptive_matches_jax():
    j, t = _adaptive(JT), _adaptive(TR, **CPU)
    # the budget reaches t_final, where t lands exactly
    assert abs(float(j.t_reached) - ADAPTIVE["t_final"]) < 1e-14
    assert abs(float(t.t_reached) - float(j.t_reached)) <= 1e-14
    assert int(t.accepted) == int(j.accepted)
    assert int(t.rejected) == int(j.rejected)
    assert t.accepted.dtype == t.rejected.dtype == torch.int32
    rel_close(t.solution.fem_values, j.solution.fem_values, 1e-12)
    rel_close(t.max_err, j.max_err, 1e-9)


def _fields(shared):
    d = shared._asdict() if hasattr(shared, "_asdict") else {
        f.name: getattr(shared, f.name) for f in dataclasses.fields(shared)}
    return {k: np.asarray(v) for k, v in d.items() if v is not None}


def _same_maps(port, jax_, rtol=1e-13):
    pf, jf = _fields(port), _fields(jax_)
    assert sorted(pf) == sorted(jf)
    for k in pf:
        rel_close(pf[k], jf[k], rtol)


@pytest.mark.parametrize("mass", ["consistent", "numerov"])
def test_locals_3d_match_jax(mass):
    pt, pj = TR.heat_3d().elliptic, JT.heat_3d().elliptic
    hs = (0.5, 0.25, 0.4)
    for a, b in zip(TR._locals_3d(*hs, pt, mass),
                    JT._locals_3d(*hs, pj, mass)):
        rel_close(a, b, 1e-13)
    adv = dataclasses.replace(pt, b=(1.0, 0.5, -2.0), c=0.7)
    advj = dataclasses.replace(pj, b=(1.0, 0.5, -2.0), c=0.7)
    if mass == "consistent":
        for a, b in zip(TR._locals_3d(*hs, adv, mass),
                        JT._locals_3d(*hs, advj, mass)):
            rel_close(a, b, 1e-13)
    else:
        with pytest.raises(NotImplementedError, match="b == 0"):
            TR._locals_3d(*hs, adv, mass)


def test_shared_cn_ops_3d_match_jax():
    dt = 0.25 / 8
    pt, pj = TR.heat_3d().elliptic, JT.heat_3d().elliptic
    ct, cj = _cfg(TR, 4), _cfg(JT, 4)
    t_sh, t_proj, t_R, t_int, spts = TR._shared_cn_ops_3d(pt, ct, dt)
    j_sh, j_proj, j_R, j_int, j_spts = JT._shared_cn_ops_3d(pj, cj, dt)
    _same_maps(t_sh, j_sh)
    _same_maps(t_proj, j_proj)
    rel_close(t_R, j_R, 1e-13)
    np.testing.assert_array_equal(t_int, j_int)
    np.testing.assert_array_equal(spts, j_spts)
    # JAX's bundles carried across, as the marches would use them
    for port, jax_ in ((t_sh, j_sh), (t_proj, j_proj)):
        conv = convert.shared_operators_from_arrays(
            _fields(jax_), device="cpu", dtype=torch.float64)
        _same_maps(conv, jax_, 0.0)
        _same_maps(port, conv)
    adv = dataclasses.replace(pt, b=(1.0, 0.5, -2.0), c=0.7)
    advj = dataclasses.replace(pj, b=(1.0, 0.5, -2.0), c=0.7)
    for a, b in zip(TR._mass_dl_b_3d(adv, ct), JT._mass_dl_b_3d(advj, cj)):
        rel_close(a, b, 1e-13)


def test_element_data_skip_f_keeps_the_traces():
    """``skip_f=True`` returns the same trace rows without the
    collocation rows, with and without the plane lift."""
    p = TR.heat_3d().elliptic
    cfg = _cfg(TR, 6)
    xs = ys = zs = torch.linspace(-1, 1, 7, dtype=torch.float64)
    u = torch.rand(7, 7, 7, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    t_int = np.linspace(-1.0, 1.0, 6)[1:-1]
    spts = H3._surface_coords(4)
    for lift in (0, 6):
        f_rows, bc, _ = H3._element_data_3d(p, cfg, xs, ys, zs, u, t_int,
                                            spts, trace_lift=lift)
        none, bc_skip, _ = H3._element_data_3d(
            p, cfg, xs, ys, zs, u, t_int, spts, trace_lift=lift,
            skip_f=True)
        assert f_rows.shape == (216, 64) and none is None
        assert torch.equal(bc, bc_skip)


def test_enhanced_marches_skip_f_and_build_lift_tables_once(monkeypatch):
    """Every enhanced 3D march asks ``_element_data_3d`` for its traces
    alone, and a lifted march builds its lift tables once a shape."""
    calls = []
    orig = TR._element_data_3d

    def spy(*a, **k):
        calls.append(k.get("skip_f", False))
        return orig(*a, **k)

    monkeypatch.setattr(TR, "_element_data_3d", spy)
    built = []
    orig_w = H3._lift_weights

    def count(*a, **k):
        built.append(a[0])
        return orig_w(*a, **k)

    monkeypatch.setattr(H3, "_lift_weights", count)
    H3._lift_tables_3d.cache_clear()
    tcfg = TR.TransientConfig(mass="numerov", **TC)
    cfg = Solver3DConfig(nx=6, ny=7, nz=8, M=4, n_colloc=4)
    TR.hybrid_march_3d(TR.heat_3d(), cfg, tcfg, trace_lift=6, **CPU)
    TR.hybrid_wave_march_3d(TR.wave_3d(), cfg, tcfg, trace_lift=6, **CPU)
    TR.hybrid_march_semilinear_3d(TR.semilinear_heat_3d(), cfg, tcfg,
                                  trace_lift=6, **CPU)
    # 1 + 8 trace calls, 3 + 8, 1 + 8; all trace-only
    assert len(calls) == 29 and all(calls), calls
    assert sorted(built) == [7, 8, 9]  # one build of each axis, once
    assert H3._lift_tables_3d.cache_info().misses == 1


# ------------------------------------- the reference's properties, 3D

QUERY = [torch.tensor(np.random.default_rng(5).uniform(-1, 1, 1200))
         for _ in range(3)]


def _grid_err(problem, sol, t):
    X, Y, Z = sol.xs[None, None, :], sol.ys[None, :, None], sol.zs[:, None,
                                                                   None]
    return float((sol.fem_values - problem.exact(X, Y, Z, t)).abs().max())


def _enhanced_err(problem, sol, t, q=QUERY):
    z = torch.zeros(())
    s3 = H3.Solution3D(sol.xs, sol.ys, sol.zs, sol.fem_values, sol.coeffs,
                       0, z, z, z, z)
    return float((H3.evaluate_3d(s3, *q) - problem.exact(*q, t))
                 .abs().max())


def test_fem_march_3d_numerov_beats_consistent():
    """3D hex CN march: the tensor Numerov mass cuts the nodal error ~2
    orders at 8^3; CG stays at a few iterations (mass-dominated)."""
    p = TR.heat_3d()
    cfg = Solver3DConfig(nx=8, ny=8, nz=8, M=4, n_colloc=4)
    errs = {}
    for mass in ("consistent", "numerov"):
        sol = TR.fem_march_3d(p, cfg, TR.TransientConfig(
            t_final=0.25, n_steps=64, mass=mass), **CPU)
        errs[mass] = _grid_err(p, sol, 0.25)
        assert sol.cg_iters <= 8
    assert errs["numerov"] < 0.05 * errs["consistent"], errs


def test_hybrid_march_3d_trace_floor():
    """3D enhanced CN march: the Linf floor is the trilinear trace error
    O(h^2) (6^3 -> 12^3; 16 steps, where the reference takes 32: the
    orders, 1.80 and 1.75, agree to 0.05)."""
    p = TR.heat_3d()
    errs = {}
    for n in (6, 12):
        cfg = Solver3DConfig(nx=n, ny=n, nz=n, M=4, n_colloc=4)
        hs = TR.hybrid_march_3d(p, cfg, TR.TransientConfig(
            t_final=0.25, n_steps=16, mass="numerov"), **CPU)
        errs[n] = _enhanced_err(p, hs, 0.25)
    order = np.log2(errs[6] / errs[12])
    assert 1.4 < order < 2.6, (errs, order)


def test_hybrid_march_3d_trace_lift():
    """trace_lift=6 cuts the enhanced Linf more than tenfold at 8^3."""
    p = TR.heat_3d()
    cfg = Solver3DConfig(nx=8, ny=8, nz=8, M=4, n_colloc=4)
    tcfg = TR.TransientConfig(t_final=0.25, n_steps=64, mass="numerov")
    e_lift = _enhanced_err(p, TR.hybrid_march_3d(p, cfg, tcfg, trace_lift=6,
                                                 **CPU), 0.25)
    e_base = _enhanced_err(p, TR.hybrid_march_3d(p, cfg, tcfg, **CPU), 0.25)
    assert e_lift < 0.1 * e_base, (e_lift, e_base)


def test_wave_march_3d_numerov():
    """3D Newmark free vibration: the tensor Numerov mass keeps O(h^4)
    nodal dispersion (6^3 -> 12^3)."""
    p = TR.wave_3d()
    Tw = 0.4
    errs = {}
    for n in (6, 12):
        sol, _ = TR.wave_march_3d(
            p, Solver3DConfig(nx=n, ny=n, nz=n, M=3, n_colloc=3),
            TR.TransientConfig(t_final=Tw, n_steps=128, mass="numerov"),
            **CPU)
        errs[n] = _grid_err(p, sol, Tw)
    order = np.log2(errs[6] / errs[12])
    assert 2.8 < order < 4.8, (errs, order)


def test_hybrid_wave_march_3d_trace_lift():
    """3D enhanced Newmark march: the plane lift cuts the enhanced Linf
    toward the nodal floor at 8^3, >10x below the trilinear traces (64
    steps, where the reference takes 256: both Linf within 2% of
    theirs)."""
    p = TR.wave_3d()
    cfg = Solver3DConfig(nx=8, ny=8, nz=8, M=4, n_colloc=4,
                         precond="jacobi")
    tcfg = TR.TransientConfig(t_final=0.25, n_steps=64, mass="numerov")
    sol, _ = TR.hybrid_wave_march_3d(p, cfg, tcfg, trace_lift=6, **CPU)
    e_lift = _enhanced_err(p, sol, 0.25)
    assert e_lift < 5e-3, e_lift
    sol0, _ = TR.hybrid_wave_march_3d(p, cfg, tcfg, **CPU)
    assert _enhanced_err(p, sol0, 0.25) > 10.0 * e_lift


def test_semilinear_march_3d_numerov():
    """3D IMEX CNAB on hexes: tensor-Numerov nodal accuracy (6^3 ->
    12^3)."""
    p = TR.semilinear_heat_3d()
    errs = {}
    for n, n_steps in ((6, 30), (12, 120)):
        cfg = Solver3DConfig(nx=n, ny=n, nz=n, M=4, n_colloc=4,
                             precond="jacobi", dtype="float64",
                             backend="torch")
        sol = TR.fem_march_semilinear_3d(p, cfg, TR.TransientConfig(
            t_final=0.5, n_steps=n_steps, mass="numerov"), **CPU)
        errs[n] = _grid_err(p, sol, 0.5)
    assert errs[6] / errs[12] > 8.0, errs
    assert errs[12] < 5e-4


def test_semilinear_hybrid_march_3d_smoke():
    """The enhanced 3D semilinear march sits at the trilinear trace floor
    at 8^3, and its nodal values are the FEM march's."""
    p = TR.semilinear_heat_3d()
    cfg = Solver3DConfig(nx=8, ny=8, nz=8, M=4, n_colloc=4,
                         precond="jacobi", dtype="float64", backend="torch")
    tcfg = TR.TransientConfig(t_final=0.5, n_steps=60, mass="numerov")
    sol = TR.hybrid_march_semilinear_3d(p, cfg, tcfg, **CPU)
    err = _enhanced_err(p, sol, 0.5)
    assert err < 0.15, err
    fem = TR.fem_march_semilinear_3d(p, cfg, tcfg, **CPU)
    assert torch.equal(sol.fem_values, fem.fem_values)
    assert _grid_err(p, sol, 0.5) < 1e-3


def test_adaptive_march_3d_error_control():
    """3D lift: reaches t_final within budget with every accepted local
    estimate <= tol."""
    p = TR.heat_3d()
    cfg = Solver3DConfig(nx=8, ny=8, nz=8, M=4, n_colloc=4,
                         dtype="float64", precond="jacobi")
    res = TR.fem_march_adaptive_3d(p, cfg, t_final=0.25, tol=1e-4,
                                   max_attempts=256, **CPU)
    assert float(res.t_reached) == pytest.approx(0.25, abs=1e-10)
    assert float(res.max_err) <= 1e-4
    assert int(res.accepted) + int(res.rejected) < 256


def test_transient_3d_guards():
    p = TR.heat_3d()
    cfg = Solver3DConfig(nx=4, ny=4, nz=4)
    with pytest.raises(ValueError, match="0.5"):
        TR.hybrid_march_3d(p, cfg, TR.TransientConfig(theta=1.0), **CPU)
    neumann = dataclasses.replace(p, elliptic=dataclasses.replace(
        p.elliptic, bc_faces=("neumann",) + ("dirichlet",) * 5))
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        TR.fem_march_3d(neumann, cfg, TR.TransientConfig(), **CPU)
    varc = dataclasses.replace(p, elliptic=dataclasses.replace(
        p.elliptic, a_var=lambda x, y, z: 1.0 + x * 0))
    with pytest.raises(NotImplementedError, match="constant"):
        TR.fem_march_adaptive_3d(varc, cfg, t_final=0.1, **CPU)


def test_default_device_without_a_card_raises():
    """``device=None`` means the card; without one the marches raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    cfg = Solver3DConfig(nx=4, ny=4, nz=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.fem_march_3d(TR.heat_3d(), cfg, TR.TransientConfig(n_steps=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.hybrid_wave_march_3d(TR.wave_3d(), cfg,
                                TR.TransientConfig(n_steps=2))


def test_checkpointed_3d_march_resumes_bit_for_bit(tmp_path):
    """A 3D march with ``TransientConfig.checkpoint`` set is bit for bit
    the plain run, and a finished state reloads to the same values."""
    p = TR.heat_3d()
    cfg = Solver3DConfig(nx=6, ny=6, nz=6, M=4, n_colloc=4)
    tcfg = TR.TransientConfig(mass="numerov", **TC)
    plain = TR.hybrid_march_3d(p, cfg, tcfg, trace_lift=6, **CPU)
    ck = dataclasses.replace(tcfg, checkpoint=str(tmp_path / "m"),
                             checkpoint_chunk=3)
    for _ in range(2):  # the run, then a reload of the finished state
        sol = TR.hybrid_march_3d(p, cfg, ck, trace_lift=6, **CPU)
        assert torch.equal(sol.coeffs, plain.coeffs)
        assert torch.equal(sol.fem_values, plain.fem_values)
        assert sol.cg_iters == plain.cg_iters
