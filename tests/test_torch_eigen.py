"""The port's eigenvalue family (``models/eigen.py``, with the Numerov
helpers of ``models/transient.py``) against the JAX package on the CPU.

Inputs are the JAX package's own problems; each JAX eigensolve runs once
per module (each compiles its iteration anew, ~5-15 s), and the mixed
routes reuse the float64 routes' pencils (``shared_pencils``: the same
call with the same arguments).  Float64 unless named, at the stated
tolerances, relative to the largest value compared:
- 1D at 33 nodes: eigenvalues, nodal eigenvectors (one sign convention in
  both packages) and enhanced coefficients within 1e-10; float32: the
  eigenvalues within the JAX test's own floor, 5e-5, of JAX's and of the
  exact ones.
- 2D at 8^2 quads (the multigrid branch) on the rectangle
  (-1, 1) x (-0.75, 0.75), whose first modes are simple: the pencil, the
  lifted enhancement (whole solve) and the unlifted one (on JAX's pencil
  pair), eigenvalues 1e-10, vectors 1e-10, coefficients 1e-9.  The mixed
  route: the float64 pencil as above; the float32 coefficients, rounded in
  another order, within 1e-5 of the largest; the corrected quotients'
  eigenvalues within 1e-9.
- 3D at 4^3 hexes (the Jacobi branch) on the cube, k = 4: the ground
  state as in 2D; the degenerate (1,1,2) triple through its projector
  sum_j v_j v_j^T (np.linalg.eigh picks the vectors inside the group by
  rounding, differently in each package), so only the simple ground state
  is compared after enhancement.
- Both corrected quotients (2D and 3D) on the same coefficient arrays:
  1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import eigen as JE
from hybrid_fem_lssvr_tpu.models import problems as JP
from hybrid_fem_lssvr_tpu.models import transient as JTr
from hybrid_fem_lssvr_tpu.models.hybrid import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models.hybrid2d import Solver2DConfig as J2Config
from hybrid_fem_lssvr_tpu.models.hybrid2d import enhance_2d as jenhance_2d
from hybrid_fem_lssvr_tpu.models.hybrid2d import poisson_2d as jpoisson_2d
from hybrid_fem_lssvr_tpu.models.hybrid2d import \
    prepare_shared_2d as jprepare_shared_2d
from hybrid_fem_lssvr_tpu.models.hybrid3d import Solver3DConfig as J3Config
from hybrid_fem_lssvr_tpu.models.hybrid3d import enhance_3d as jenhance_3d
from hybrid_fem_lssvr_tpu.models.hybrid3d import poisson_3d as jpoisson_3d
from hybrid_fem_lssvr_tpu.models.hybrid3d import \
    prepare_shared_3d as jprepare_shared_3d

from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                        SolverConfig, problems)
from hybrid_fem_lssvr_tpu_torch.models import eigen as E
from hybrid_fem_lssvr_tpu_torch.models import transient as Tr
from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import (enhance_2d,
                                                        poisson_2d,
                                                        prepare_shared_2d)
from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import (enhance_3d,
                                                        poisson_3d,
                                                        prepare_shared_3d)

torch.set_num_threads(1)

RECT = (-1.0, 1.0, -0.75, 0.75)
EC_2D = E.EigenConfig(k=2, iters=12)
EC_3D = E.EigenConfig(k=4, iters=12, rq_iters=1)


def jec(ec):
    return JE.EigenConfig(**dataclasses.asdict(ec))


def shared_pencils(mod, *names):
    """Patch ``mod``'s pencil functions to run once per (problem, config,
    EigenConfig): the mixed route then reuses the float64 route's pencil,
    the same deterministic computation, instead of compiling it again."""
    mp = pytest.MonkeyPatch()
    for name in names:
        fn, cache = getattr(mod, name), {}

        def memo(problem, cfg, ecfg, _fn=fn, _cache=cache, **kw):
            key = (problem, cfg, ecfg, tuple(sorted(kw.items())))
            if key not in _cache:
                _cache[key] = _fn(problem, cfg, ecfg, **kw)
            return _cache[key]

        mp.setattr(mod, name, memo)
    return mp


def rel_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=rtol * max(1.0, float(np.max(np.abs(want)))))


# -------------------------------------------------------------------- 1D

CFG_1D = dict(num_nodes=33, M=8)


@pytest.fixture(scope="module")
def jax_1d():
    p = JP.get("poisson_1d")
    c64 = JConfig(dtype="float64", **CFG_1D)
    hybrid = JE.hybrid_eigensolve(p, c64, JE.EigenConfig(k=3))
    return {
        "consistent": hybrid.fem,
        "numerov": JE.fem_eigensolve(p, c64, JE.EigenConfig(
            k=3, mass="numerov")),
        "float64": hybrid,
        "float32": JE.hybrid_eigensolve(p, JConfig(dtype="float32",
                                                   **CFG_1D),
                                        JE.EigenConfig(k=2)),
    }


def compare_fem_1d(t, j):
    rel_close(t.lams, j.lams, 1e-10)
    rel_close(t.vectors, j.vectors, 1e-10)
    rel_close(t.nodes, j.nodes, 0)
    assert float(t.residuals.max()) < 1e-10


@pytest.mark.parametrize("mass", ["consistent", "numerov"])
def test_fem_eigensolve_1d_matches_jax(jax_1d, mass):
    p = problems.get("poisson_1d")
    t = E.fem_eigensolve(p, SolverConfig(dtype="float64", **CFG_1D),
                         E.EigenConfig(k=3, mass=mass), device="cpu")
    compare_fem_1d(t, jax_1d[mass])


def test_hybrid_eigensolve_1d_matches_jax(jax_1d):
    j = jax_1d["float64"]
    p = problems.get("poisson_1d")
    t = E.hybrid_eigensolve(p, SolverConfig(dtype="float64", **CFG_1D),
                            E.EigenConfig(k=3), device="cpu")
    compare_fem_1d(t.fem, j.fem)
    rel_close(t.lams, j.lams, 1e-10)
    rel_close(t.coeffs, j.coeffs, 1e-10)
    assert bool(t.solve_ok.all()) and bool(np.all(np.asarray(j.solve_ok)))
    ex = E.exact_eigenvalues(p, 3)
    assert np.all(np.abs(t.lams.numpy() - ex) < 1e-10)
    assert np.all(np.abs(t.fem.lams.numpy() - ex) > 1e-3)


def test_hybrid_eigensolve_1d_float32(jax_1d):
    j = jax_1d["float32"]
    p = problems.get("poisson_1d")
    t = E.hybrid_eigensolve(p, SolverConfig(dtype="float32", **CFG_1D),
                            E.EigenConfig(k=2), device="cpu")
    assert t.lams.dtype == torch.float32
    ex = E.exact_eigenvalues(p, 2)
    assert np.all(np.abs(t.lams.numpy() - np.asarray(j.lams)) < 5e-5)
    assert np.all(np.abs(t.lams.numpy() - ex) < 5e-5)
    assert bool(t.solve_ok.all())


def test_eigenfunctions_1d_unit_l2_and_beat_p1():
    """tests/test_eigen.py's properties on the port: unit continuous L2
    norm, and the enhanced eigenfunction 1e4 below the P1 interpolant."""
    p = problems.get("poisson_1d")
    cfg = SolverConfig(num_nodes=17, M=8, dtype="float64")
    sol = E.hybrid_eigensolve(p, cfg, E.EigenConfig(k=2), device="cpu")
    x = torch.linspace(-1.0, 1.0, 1001, dtype=torch.float64)
    xn = x.numpy()
    for j in range(2):
        _, den = E._quadrature_forms(p, sol.fem.nodes, sol.coeffs[j], cfg)
        assert abs(float(den) - 1.0) < 1e-12
        u = E.evaluate_eigenfunction(sol, j, x).numpy()
        ue = np.sin((j + 1) * np.pi * (xn + 1) / 2.0)
        ufem = np.interp(xn, sol.fem.nodes.numpy(),
                         sol.fem.vectors[:, j].numpy())
        ufem /= np.sqrt(np.trapezoid(ufem**2, xn))
        assert np.max(np.abs(u - ue)) < 1e-4 * np.max(np.abs(ufem - ue))


def test_helmholtz_and_variable_coefficient_1d():
    """The indefinite helmholtz pencil to 1e-10, and the per-element route
    (variable coefficients) converging under refinement, as
    tests/test_eigen.py holds the JAX package."""
    p = problems.get("helmholtz_1d")
    c0 = float(p.c(torch.zeros(1, dtype=torch.float64))[0])
    sol = E.hybrid_eigensolve(p, SolverConfig(dtype="float64", **CFG_1D),
                              E.EigenConfig(k=3), device="cpu")
    ex = E.exact_eigenvalues(p, 3, c0=c0)
    assert ex[0] < 0 and np.all(np.abs(sol.lams.numpy() - ex) < 1e-10)
    pv = problems.get("variable_coeff_elliptic")
    lams = [float(E.hybrid_eigensolve(pv, SolverConfig(
        num_nodes=N, M=8, dtype="float64"), E.EigenConfig(k=1),
        device="cpu").lams[0]) for N in (33, 65, 129)]
    assert abs(lams[2] - lams[1]) < 0.2 * abs(lams[1] - lams[0]) + 1e-12
    assert abs(lams[1] - lams[0]) < 1e-4


def test_numerov_helpers_match_jax():
    """transient._tri_apply, _numerov_setup and _numerov_locals_2d."""
    p, jp = problems.get("helmholtz_1d"), JP.get("helmholtz_1d")
    nodes = np.linspace(-1.0, 1.0, 17)
    f_t = (lambda x, t: x ** 2 + t)
    A, Mm, ell, load = Tr._numerov_setup(p, torch.tensor(nodes), f_t)
    jA, jM, jell, jload = JTr._numerov_setup(jp, jnp.asarray(nodes), f_t)
    for got, want in zip(A + Mm + (ell, load(0.5)),
                         tuple(jA) + tuple(jM) + (jell, jload(0.5))):
        rel_close(got, want, 1e-14)
    u = np.random.default_rng(5).standard_normal(17)
    rel_close(Tr._tri_apply(*A, torch.tensor(u)),
              JTr._tri_apply(*jA, jnp.asarray(u)), 1e-14)
    for got, want in zip(Tr._numerov_locals_2d(0.25, 0.125, 1.5, -2.0),
                         JTr._numerov_locals_2d(0.25, 0.125, 1.5, -2.0)):
        rel_close(got, want, 0)


@pytest.mark.parametrize("name", ["advection_diffusion_1d",
                                  "variable_coeff_elliptic",
                                  "poisson_neumann"])
def test_numerov_and_eigen_gates_raise_as_in_jax(name):
    """The three NotImplementedError gates of _numerov_setup, and the
    eigensolver's own (b != 0, natural ends), in both packages."""
    cfg, jcfg = (SolverConfig(num_nodes=17, M=8, dtype="float64"),
                 JConfig(num_nodes=17, M=8, dtype="float64"))
    nodes = np.linspace(-1.0, 1.0, 17)
    with pytest.raises(NotImplementedError):
        JTr._numerov_setup(JP.get(name), jnp.asarray(nodes), None)
    with pytest.raises(NotImplementedError):
        Tr._numerov_setup(problems.get(name), torch.tensor(nodes), None)
    if name != "variable_coeff_elliptic":
        with pytest.raises(NotImplementedError):
            JE.fem_eigensolve(JP.get(name), jcfg, JE.EigenConfig(k=1))
        with pytest.raises(NotImplementedError):
            E.fem_eigensolve(problems.get(name), cfg, E.EigenConfig(k=1),
                             device="cpu")


def test_eigenconfig_validation_and_float32_gates():
    for bad in (dict(k=0), dict(mass="lumped"), dict(iters=0),
                dict(rq_iters=-1), dict(oversample=-1)):
        with pytest.raises(ValueError):
            E.EigenConfig(**bad)
    for mod, p2, c2, p3, c3 in (
            (JE, jpoisson_2d(), J2Config, jpoisson_3d(), J3Config),
            (E, poisson_2d(), Solver2DConfig, poisson_3d(), Solver3DConfig)):
        kw = {} if mod is JE else dict(device="cpu")
        with pytest.raises(ValueError, match="float64"):
            mod.fem_eigensolve_2d(p2, c2(nx=8, ny=8, dtype="float32"), **kw)
        with pytest.raises(ValueError, match="float64"):
            mod.fem_eigensolve_3d(p3, c3(dtype="float32"), **kw)


# -------------------------------------------------------------------- 2D


def cfg_2d(cls, dtype="float64"):
    return cls(nx=8, ny=8, M=6, n_colloc=6, dtype=dtype)


@pytest.fixture(scope="module")
def jax_2d():
    p = dataclasses.replace(jpoisson_2d(), domain=RECT)
    mp = shared_pencils(JE, "fem_eigensolve_2d")
    try:
        return {
            "hybrid": JE.hybrid_eigensolve_2d(p, cfg_2d(J2Config),
                                              jec(EC_2D)),
            "mixed": JE.hybrid_eigensolve_2d_mixed(
                p, cfg_2d(J2Config, "float32"), jec(EC_2D)),
        }
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_2d():
    p = dataclasses.replace(poisson_2d(), domain=RECT)
    mp = shared_pencils(E, "fem_eigensolve_2d")
    try:
        return {
            "hybrid": E.hybrid_eigensolve_2d(p, cfg_2d(Solver2DConfig),
                                             EC_2D, device="cpu"),
            "mixed": E.hybrid_eigensolve_2d_mixed(
                p, cfg_2d(Solver2DConfig, "float32"), EC_2D, device="cpu"),
        }
    finally:
        mp.undo()


def compare_pencil(t, j, simple):
    """Eigenvalues, residuals, and the vectors of the simple modes."""
    rel_close(t.lams, j.lams, 1e-10)
    assert float(t.residuals.max()) < 1e-9
    assert float(np.max(np.asarray(j.residuals))) < 1e-9
    for m in simple:
        rel_close(t.vectors[m], j.vectors[m], 1e-10)


@pytest.mark.parametrize("route", ["hybrid", "mixed"])
def test_pencil_2d_matches_jax(jax_2d, port_2d, route):
    t, j = port_2d[route].fem, jax_2d[route].fem
    compare_pencil(t, j, range(t.lams.shape[0]))
    rel_close(t.xs, j.xs, 0)


def test_lifted_enhancement_2d_matches_jax(jax_2d, port_2d):
    t, j = port_2d["hybrid"], jax_2d["hybrid"]
    rel_close(t.lams, j.lams, 1e-10)
    rel_close(t.coeffs, j.coeffs, 1e-9)
    assert bool(t.solve_ok.all()) and bool(np.all(np.asarray(j.solve_ok)))
    p = dataclasses.replace(poisson_2d(), domain=RECT)
    ex = E.exact_eigenvalues_2d(p, 2)
    fem_err = np.abs(t.fem.lams.numpy() - ex)
    enh_err = np.abs(t.lams.numpy() - ex)
    assert np.all(enh_err < 1e-2 * fem_err), (enh_err, fem_err)


@pytest.mark.parametrize("mode", [0, 1])
def test_unlifted_enhancement_2d_matches_jax(jax_2d, mode):
    """enhance_2d with the bilinear trace (trace_lift 0: on the card the
    stacked kernel's route) on JAX's pencil pair, and the plain quotient of
    its coefficients."""
    jf = jax_2d["hybrid"].fem
    lam, u = float(jf.lams[mode]), np.asarray(jf.vectors[mode])
    jp = dataclasses.replace(jpoisson_2d(), domain=RECT)
    p = dataclasses.replace(poisson_2d(), domain=RECT)
    js = JE._shifted_problem_2d(jp, lam)
    jc, _, _ = jenhance_2d(js, cfg_2d(J2Config), jf.xs, jf.ys,
                           jnp.asarray(u), jprepare_shared_2d(
                               js, cfg_2d(J2Config)))
    s = E._shifted_problem_2d(p, lam)
    xs, ys = torch.tensor(np.asarray(jf.xs)), torch.tensor(np.asarray(jf.ys))
    c, diags, _ = enhance_2d(s, cfg_2d(Solver2DConfig), xs, ys,
                             torch.tensor(u),
                             prepare_shared_2d(s, cfg_2d(Solver2DConfig)))
    rel_close(c, jc, 1e-9)
    assert bool(diags.solve_ok.all())
    rel_close(E.rayleigh_quotient_2d(p, xs, ys, c, cfg_2d(Solver2DConfig)),
              JE.rayleigh_quotient_2d(jp, jf.xs, jf.ys, jc,
                                      cfg_2d(J2Config)), 1e-10)


def test_mixed_2d_matches_jax(jax_2d, port_2d):
    t, j = port_2d["mixed"], jax_2d["mixed"]
    assert t.coeffs.dtype == torch.float64
    rel_close(t.coeffs, j.coeffs, 1e-5)
    rel_close(t.lams, j.lams, 1e-9)
    assert bool(t.solve_ok.all())
    p = dataclasses.replace(poisson_2d(), domain=RECT)
    ex = E.exact_eigenvalues_2d(p, 2)
    # the corrected quotient of float32 coefficients: at the float64
    # route's floor on this mesh
    rel_close(t.lams, port_2d["hybrid"].lams[:2], 1e-8)
    assert np.all(np.abs(t.lams.numpy() - ex)
                  < 1e-2 * np.abs(t.fem.lams.numpy() - ex))


def test_corrected_quotients_2d_match_jax(jax_2d):
    """Both quotients and the face term on the same (JAX mixed route's)
    coefficients."""
    j = jax_2d["mixed"]
    jp = dataclasses.replace(jpoisson_2d(), domain=RECT)
    p = dataclasses.replace(poisson_2d(), domain=RECT)
    xs, ys = torch.tensor(np.asarray(j.fem.xs)), \
        torch.tensor(np.asarray(j.fem.ys))
    for m in range(2):
        c = torch.tensor(np.asarray(j.coeffs[m]))
        rel_close(E._face_correction_2d(c, 0.25, 0.1875, 8),
                  JE._face_correction_2d(j.coeffs[m], 0.25, 0.1875, 8),
                  1e-12)
        for name in ("rayleigh_quotient_2d", "rayleigh_quotient_2d_corrected"):
            rel_close(getattr(E, name)(p, xs, ys, c, cfg_2d(Solver2DConfig)),
                      getattr(JE, name)(jp, j.fem.xs, j.fem.ys, j.coeffs[m],
                                        cfg_2d(J2Config)), 1e-12)


# -------------------------------------------------------------------- 3D


def cfg_3d(cls, dtype="float64"):
    return cls(nx=4, ny=4, nz=4, M=4, n_colloc=4, dtype=dtype)


@pytest.fixture(scope="module")
def jax_3d():
    p = jpoisson_3d()
    mp = shared_pencils(JE, "fem_eigensolve_3d")
    try:
        return {
            "hybrid": JE.hybrid_eigensolve_3d(p, cfg_3d(J3Config),
                                              jec(EC_3D)),
            "mixed": JE.hybrid_eigensolve_3d_mixed(
                p, cfg_3d(J3Config, "float32"), jec(EC_3D)),
        }
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_3d():
    p = poisson_3d()
    return {
        "hybrid": E.hybrid_eigensolve_3d(p, cfg_3d(Solver3DConfig), EC_3D,
                                         device="cpu"),
        "mixed": E.hybrid_eigensolve_3d_mixed(
            p, cfg_3d(Solver3DConfig, "float32"), EC_3D, device="cpu"),
    }


def test_pencil_3d_matches_jax(jax_3d, port_3d):
    t, j = port_3d["hybrid"].fem, jax_3d["hybrid"].fem
    compare_pencil(t, j, [0])
    ex = E.exact_eigenvalues_3d(poisson_3d(), 4)
    assert np.allclose(ex[1:], ex[1], rtol=1e-14)  # the (1,1,2) triple
    assert abs(float(t.lams[1] - t.lams[3])) < 1e-10 * float(t.lams[1])

    def projector(V):
        V = np.asarray(V).reshape(V.shape[0], -1)
        return V.T @ V

    rel_close(projector(t.vectors[1:]), projector(j.vectors[1:]), 1e-10)


def test_lifted_enhancement_3d_matches_jax(jax_3d, port_3d):
    t, j = port_3d["hybrid"], jax_3d["hybrid"]
    rel_close(t.lams[0], j.lams[0], 1e-10)
    rel_close(t.coeffs[0], j.coeffs[0], 1e-9)
    assert bool(t.solve_ok.all()) and bool(np.all(np.asarray(j.solve_ok)))


def test_unlifted_enhancement_3d_matches_jax(jax_3d):
    jf = jax_3d["hybrid"].fem
    lam, u = float(jf.lams[0]), np.asarray(jf.vectors[0])
    js = JE._shifted_problem_3d(jpoisson_3d(), lam)
    jc, _, _ = jenhance_3d(js, cfg_3d(J3Config), jf.xs, jf.ys, jf.zs,
                           jnp.asarray(u), jprepare_shared_3d(
                               js, cfg_3d(J3Config)))
    s = E._shifted_problem_3d(poisson_3d(), lam)
    g = [torch.tensor(np.asarray(v)) for v in (jf.xs, jf.ys, jf.zs)]
    c, diags, _ = enhance_3d(s, cfg_3d(Solver3DConfig), *g, torch.tensor(u),
                             prepare_shared_3d(s, cfg_3d(Solver3DConfig)))
    rel_close(c, jc, 1e-9)
    assert bool(diags.solve_ok.all())


def test_mixed_3d_matches_jax(jax_3d, port_3d):
    t, j = port_3d["mixed"], jax_3d["mixed"]
    compare_pencil(t.fem, j.fem, [0])
    rel_close(t.coeffs[0], j.coeffs[0], 1e-5)
    rel_close(t.lams[0], j.lams[0], 1e-9)
    # tests/test_eigen.py: the mixed route reproduces the float64 route
    rel_close(t.lams[0], port_3d["hybrid"].lams[0], 1e-7)


def test_corrected_quotient_3d_matches_jax(jax_3d):
    j = jax_3d["mixed"]
    g = [torch.tensor(np.asarray(v)) for v in (j.fem.xs, j.fem.ys, j.fem.zs)]
    c = torch.tensor(np.asarray(j.coeffs[0]))
    rel_close(E._face_correction_3d(c, 0.5, 0.5, 0.5, 6),
              JE._face_correction_3d(j.coeffs[0], 0.5, 0.5, 0.5, 6), 1e-12)
    for name in ("rayleigh_quotient_3d", "rayleigh_quotient_3d_corrected"):
        rel_close(getattr(E, name)(poisson_3d(), *g, c,
                                   cfg_3d(Solver3DConfig)),
                  getattr(JE, name)(jpoisson_3d(), j.fem.xs, j.fem.ys,
                                    j.fem.zs, j.coeffs[0], cfg_3d(J3Config)),
                  1e-12)
