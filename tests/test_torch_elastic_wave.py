"""The port's elastodynamics marches (``models/elastic_wave.py``) against
the JAX package, float64 on the CPU, and the reference's own properties
of ``tests/test_elastic_wave.py`` on the port alone (its CLI test aside:
the port has no CLI yet).

Against JAX: 2D at 8^2, M = C = 5, 3D at 4^3, M = C = 4, 10 steps to
t = 0.2, lam = 2, mu = 0.5.  Nodal displacements and velocities within
1e-12 of their size, coefficients within 1e-9, the energies within
1e-12, ``cg_iters`` within 1; the enhanced march's host block maps within
1e-13, also once through ``convert.shared_operators_from_arrays`` from
JAX's bundles.  Each march runs once per module in each package.  The
JAX package runs its two enhanced marches only (its 3D march compiles
for ~16 s): their nodal outputs are its FEM march's, the same solves in
the same order (its ``tests/test_elastic_wave.py`` holds them within
1e-12), and both of the port's marches are held against them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import elastic_wave as JEW
from hybrid_fem_lssvr_tpu.models import elastic as JEL
from hybrid_fem_lssvr_tpu.models import elastic3d as JEL3
from hybrid_fem_lssvr_tpu.models.transient import TransientConfig as JTC
from hybrid_fem_lssvr_tpu.ops import kkt as jkkt

from hybrid_fem_lssvr_tpu_torch import ElasticConfig2D, ElasticConfig3D
from hybrid_fem_lssvr_tpu_torch.models import elastic as EL
from hybrid_fem_lssvr_tpu_torch.models import elastic3d as EL3
from hybrid_fem_lssvr_tpu_torch.models import elastic_wave as EW
from hybrid_fem_lssvr_tpu_torch.models.transient import TransientConfig
from hybrid_fem_lssvr_tpu_torch.utils import checkpoint as CK
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

CPU = dict(device="cpu")


def rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


# ------------------------------------------------------- against JAX

TC = dict(t_final=0.2, n_steps=10)
LAME = dict(lam=2.0, mu=0.5)
CFG2 = dict(nx=8, ny=8, M=5, n_colloc=5, precond="jacobi")
CFG3 = dict(nx=4, ny=4, nz=4, M=4, n_colloc=4, precond="jacobi")

MARCHES = ["elastic_wave_march_2d", "hybrid_elastic_wave_march_2d",
           "elastic_wave_march_3d", "hybrid_elastic_wave_march_3d"]


def _dim(march):
    return 2 if march.endswith("2d") else 3


def _cfg(jax_, dim, **kw):
    if dim == 2:
        return (JEL.ElasticConfig2D if jax_ else ElasticConfig2D)(**CFG2,
                                                                  **kw)
    return (JEL3.ElasticConfig3D if jax_ else ElasticConfig3D)(**CFG3, **kw)


def _run(mod, march, **kw):
    jax_ = mod is JEW
    tcfg = (JTC if jax_ else TransientConfig)(**TC)
    problem = getattr(mod, f"elastic_wave_{_dim(march)}d")(**LAME)
    return getattr(mod, march)(problem, _cfg(jax_, _dim(march)), tcfg, **kw)


@pytest.fixture(scope="module")
def jax_marches():
    """JAX's enhanced march of each dimension."""
    return {d: _run(JEW, f"hybrid_elastic_wave_march_{d}d") for d in (2, 3)}


@pytest.fixture(scope="module")
def port_marches():
    return {m: _run(EW, m, **CPU) for m in MARCHES}


@pytest.mark.parametrize("march", MARCHES)
def test_march_matches_jax(jax_marches, port_marches, march):
    j, t = jax_marches[_dim(march)], port_marches[march]
    rel_close(t.fem_values, j.fem_values, 1e-12)
    rel_close(t.velocity, j.velocity, 1e-12)
    if march.startswith("hybrid"):
        rel_close(t.coeffs, j.coeffs, 1e-9)
    else:
        assert t.coeffs is None
    for e in ("energy0", "energyN"):
        rel_close(getattr(t, e), getattr(j, e), 1e-12)
    assert abs(t.cg_iters - int(j.cg_iters)) <= 1
    rel_close(t.xs, j.xs, 1e-15)
    assert (t.t_final, t.lam, t.mu) == (j.t_final, j.lam, j.mu)


@pytest.mark.parametrize("dim", [2, 3])
def test_evaluate_matches_jax(jax_marches, port_marches, dim):
    j = jax_marches[dim]
    t = port_marches[f"hybrid_elastic_wave_march_{dim}d"]
    q = np.random.default_rng(1).uniform(-1, 1, (dim, 300))
    if dim == 2:
        got = EW.evaluate_elastic_wave_2d(t, *map(torch.tensor, q))
        want = JEW.evaluate_elastic_wave_2d(j, *map(jnp.asarray, q))
    else:
        got = EW.evaluate_elastic_wave_3d(t, *map(torch.tensor, q))
        want = JEW.evaluate_elastic_wave_3d(j, *map(jnp.asarray, q))
    for a, b in zip(got, want):
        rel_close(a, b, 1e-9)


def _fields(shared):
    d = shared._asdict() if hasattr(shared, "_asdict") else {
        f.name: getattr(shared, f.name) for f in dataclasses.fields(shared)}
    return {k: np.asarray(v) for k, v in d.items() if v is not None}


@pytest.mark.parametrize("dim", [2, 3])
def test_block_maps_match_jax(dim):
    """rho Mass_blk + beta dt^2 D and Mass_blk through the host LSE, as
    JAX's enhanced marches build them (``elastic_wave.py:284-289`` and
    ``:592-597`` of the JAX package)."""
    rho, bdt2 = 1.3, 0.25 * (0.2 / 10) ** 2
    if dim == 2:
        p, pj = EL.sin_elastic_2d(**LAME), JEL.sin_elastic_2d(**LAME)
        host = EL._block_colloc_host(p, _cfg(False, 2))
        hostj = JEL._block_colloc_host(pj, _cfg(True, 2))
    else:
        p, pj = EL3.sin_elastic_3d(**LAME), JEL3.sin_elastic_3d(**LAME)
        host = EL3._block_colloc_host_3d(p, _cfg(False, 3))
        hostj = JEL3._block_colloc_host_3d(pj, _cfg(True, 3))
    D, B, Ms = host[:3]
    Dj, Bj, Msj = hostj[:3]
    maps = EW._block_newmark_maps(D, B, Ms, dim, rho, bdt2, torch.float64)
    Mass_blk = np.kron(np.eye(dim), np.asarray(Msj))
    maps_j = (jkkt.precompute_shared_lse_host(rho * Mass_blk + bdt2 * Dj,
                                              Bj, jnp.float64),
              jkkt.precompute_shared_lse_host(Mass_blk, Bj, jnp.float64))
    for port, jax_ in zip(maps, maps_j):
        pf, jf = _fields(port), _fields(jax_)
        assert sorted(pf) == sorted(jf)
        conv = convert.shared_operators_from_arrays(jf, device="cpu",
                                                    dtype=torch.float64)
        cf = _fields(conv)
        for k in pf:
            rel_close(pf[k], jf[k], 1e-13)
            np.testing.assert_array_equal(cf[k], jf[k])


# ---------------------------------------- the reference's properties


def _nodal_err(sol, p, t):
    Y, X = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
    return max(float((sol.fem_values[0] - p.exact1(X, Y, t)).abs().max()),
               float((sol.fem_values[1] - p.exact2(X, Y, t)).abs().max()))


def test_fem_march_second_order_in_h():
    """Manufactured forced oscillation: the nodal error at t_final falls
    like h^2 with dt fixed small (the vector Q1 floor)."""
    p = EW.elastic_wave_2d()
    tcfg = TransientConfig(t_final=0.25, n_steps=40)
    errs = []
    for n in (8, 16):
        cfg = ElasticConfig2D(nx=n, ny=n, M=6, n_colloc=6, precond="jacobi")
        errs.append(_nodal_err(EW.elastic_wave_march_2d(p, cfg, tcfg,
                                                        **CPU), p, 0.25))
    assert errs[0] / errs[1] > 3.0, errs
    assert errs[1] < 0.06, errs


def test_newmark_conserves_energy_free_vibration():
    """f = 0, beta = 1/4, gamma = 1/2: the discrete energy is an exact
    invariant of the trapezoidal Newmark member (drift at machine eps
    over 50 steps, float64), and the release moves."""
    p = EW.elastic_free_vibration_2d(lam=2.0, mu=0.7)
    cfg = ElasticConfig2D(nx=16, ny=16, M=6, n_colloc=6, precond="jacobi")
    sol = EW.elastic_wave_march_2d(p, cfg, TransientConfig(t_final=1.0,
                                                           n_steps=50),
                                   **CPU)
    drift = abs(float(sol.energyN - sol.energy0)) / float(sol.energy0)
    assert drift < 1e-10, drift
    Y, X = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
    moved = float((sol.fem_values[0] - p.elastic.exact1(X, Y)).abs().max())
    assert moved > 0.1, moved


def test_hybrid_march_rides_nodal_floor():
    """The enhanced march's coefficients evaluate off the nodes at the
    O(h^2) trace floor (8^2 -> 16^2)."""
    p = EW.elastic_wave_2d()
    tcfg = TransientConfig(t_final=0.25, n_steps=40)
    rng = np.random.default_rng(0)
    xr = torch.tensor(rng.uniform(-1, 1, 500))
    yr = torch.tensor(rng.uniform(-1, 1, 500))
    errs = []
    for n in (8, 16):
        cfg = ElasticConfig2D(nx=n, ny=n, M=6, n_colloc=6, precond="jacobi")
        sol = EW.hybrid_elastic_wave_march_2d(p, cfg, tcfg, **CPU)
        u1, u2 = EW.evaluate_elastic_wave_2d(sol, xr, yr)
        errs.append(max(float((u1 - p.exact1(xr, yr, 0.25)).abs().max()),
                        float((u2 - p.exact2(xr, yr, 0.25)).abs().max())))
    assert errs[0] / errs[1] > 3.0, errs
    assert errs[1] < 0.06, errs


@pytest.mark.parametrize("dim", [2, 3])
def test_hybrid_march_fem_values_match_fem_march(port_marches, dim):
    """The enhanced march's trace provider is the FEM march: the same
    nodal displacement and velocity histories (the reference's 2D
    configuration, 8^2, M = C = 5, 10 steps, lam = 2, mu = 0.5; 3D at
    4^3)."""
    a = port_marches[f"elastic_wave_march_{dim}d"]
    b = port_marches[f"hybrid_elastic_wave_march_{dim}d"]
    assert float((a.fem_values - b.fem_values).abs().max()) < 1e-12
    assert float((a.velocity - b.velocity).abs().max()) < 1e-12


def test_elastic_wave_3d_converges():
    """3D mirror: the enhanced off-node error drops >= O(h^2) from 4^3 to
    8^3, riding elastic3d's vector floor (10 steps, where the reference
    takes 20: the error ratios, 7.435 and 7.434, agree to 1e-3)."""
    p = EW.elastic_wave_3d()
    tcfg = TransientConfig(t_final=0.2, n_steps=10)
    rng = np.random.default_rng(0)
    q = [torch.tensor(rng.uniform(-1, 1, 300)) for _ in range(3)]
    errs = []
    for n in (4, 8):
        cfg = ElasticConfig3D(nx=n, ny=n, nz=n, M=4, n_colloc=4,
                              precond="jacobi")
        sol = EW.hybrid_elastic_wave_march_3d(p, cfg, tcfg, **CPU)
        u = EW.evaluate_elastic_wave_3d(sol, *q)
        errs.append(max(float((u[c] - p.exact[c](*q, 0.2)).abs().max())
                        for c in range(3)))
    assert errs[0] / errs[1] > 3.0, errs
    assert errs[1] < 0.2, errs


def test_elastic_wave_3d_fem_energy_invariant():
    """3D free vibration (zero forcing): Newmark (1/4, 1/2) conserves the
    block-system discrete energy (10 steps to t = 0.5, where the
    reference takes 25: the drift is rounding-sized at any count)."""
    st = EL3.sin_elastic_3d(lam=1.5, mu=0.8)

    def zero4(x, y, z, t):
        return torch.zeros_like(x + y + z)

    p = EW.ElasticWaveProblem3D(
        name="free3d", elastic=st, f=(zero4,) * 3, u0=st.exact,
        v0=(EW._zero3,) * 3)
    cfg = ElasticConfig3D(nx=6, ny=6, nz=6, M=4, n_colloc=4,
                          precond="jacobi")
    sol = EW.elastic_wave_march_3d(p, cfg, TransientConfig(t_final=0.5,
                                                           n_steps=10),
                                   **CPU)
    drift = abs(float(sol.energyN - sol.energy0)) / float(sol.energy0)
    assert drift < 1e-10, drift


def test_guards():
    p2 = EW.elastic_wave_2d()
    tcfg = TransientConfig(**TC)
    with pytest.raises(ValueError, match="mg"):
        EW.elastic_wave_march_2d(p2, ElasticConfig2D(nx=8, ny=8,
                                                     precond="mg"), tcfg,
                                 **CPU)
    with pytest.raises(ValueError, match="q1"):
        EW.hybrid_elastic_wave_march_3d(
            EW.elastic_wave_3d(), ElasticConfig3D(nx=4, ny=4, nz=4,
                                                  coarse="richardson"),
            tcfg, **CPU)
    with pytest.raises(ValueError, match="beta > 0"):
        EW.hybrid_elastic_wave_march_2d(p2, ElasticConfig2D(nx=4, ny=4),
                                        tcfg, beta=0.0, **CPU)


def test_default_device_without_a_card_raises():
    """``device=None`` means the card; without one the marches raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EW.hybrid_elastic_wave_march_2d(EW.elastic_wave_2d(),
                                        ElasticConfig2D(nx=4, ny=4),
                                        TransientConfig(**TC))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EW.elastic_wave_march_3d(EW.elastic_wave_3d(),
                                 ElasticConfig3D(nx=2, ny=2, nz=2),
                                 TransientConfig(**TC))


class Killed(Exception):
    """The simulated kill."""


def test_hybrid_march_2d_kill_and_resume(tmp_path, monkeypatch):
    """A checkpointed ``hybrid_elastic_wave_march_2d`` (a six-leaf carry
    and per-step CG counts) killed after its second chunk write resumes
    bit for bit to the uninterrupted run, which is the plain run."""
    p = EW.elastic_wave_2d(**LAME)
    cfg = ElasticConfig2D(**CFG2)
    tcfg = TransientConfig(**TC)
    plain = EW.hybrid_elastic_wave_march_2d(p, cfg, tcfg, **CPU)
    whole = EW.hybrid_elastic_wave_march_2d(p, cfg, dataclasses.replace(
        tcfg, checkpoint=str(tmp_path / "whole"), checkpoint_chunk=3),
        **CPU)
    kill = dataclasses.replace(tcfg, checkpoint=str(tmp_path / "kill"),
                               checkpoint_chunk=3)
    orig, writes = CK._write_march, []

    def bomb(*a, **k):
        orig(*a, **k)
        writes.append(a[2])
        if len(writes) == 2:
            raise Killed

    monkeypatch.setattr(CK, "_write_march", bomb)
    with pytest.raises(Killed):
        EW.hybrid_elastic_wave_march_2d(p, cfg, kill, **CPU)
    monkeypatch.setattr(CK, "_write_march", orig)
    fp = CK.march_fingerprint(p.name, cfg, kill,
                              "hybrid_elastic_wave_march_2d")
    state = CK.load_march_state(kill.checkpoint, fp)
    assert state[0] == 6 and len(state[1]) == 6
    resumed = EW.hybrid_elastic_wave_march_2d(p, cfg, kill, **CPU)
    for sol in (whole, resumed):
        for f in ("fem_values", "velocity", "coeffs", "energy0",
                  "energyN"):
            assert torch.equal(getattr(sol, f), getattr(plain, f)), f
        assert sol.cg_iters == plain.cg_iters
