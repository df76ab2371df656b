"""The port's 2D building blocks against the JAX package, float64 on the CPU.

Inputs come from numpy with a seed and go through the JAX function and its
PyTorch counterpart: the Q1 assembly (``ops/assembly2d.py``), the Krylov
solvers (``ops/cg.py``), the V-cycle (``ops/multigrid.py``), the ADI
preconditioner (``parallel/transpose.py``), the LSE host precompute
(``ops/kkt.py``), ``prepare_shared_2d`` through the converter, and every
callable of every 2D problem.  Tolerance 1e-12 absolute unless stated:
both sides do the same float64 arithmetic, in another order at most.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import hybrid2d as JH2
from hybrid_fem_lssvr_tpu.ops import assembly2d as JA
from hybrid_fem_lssvr_tpu.ops import cg as JCG
from hybrid_fem_lssvr_tpu.ops import kkt as JK
from hybrid_fem_lssvr_tpu.ops import multigrid as JM
from hybrid_fem_lssvr_tpu.parallel import transpose as JT

from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
from hybrid_fem_lssvr_tpu_torch.ops import assembly2d as A
from hybrid_fem_lssvr_tpu_torch.ops import cg as CG
from hybrid_fem_lssvr_tpu_torch.ops import kkt as K
from hybrid_fem_lssvr_tpu_torch.ops import multigrid as MG
from hybrid_fem_lssvr_tpu_torch.parallel import transpose as T
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

ATOL = 1e-12
SIZES = [(0.125, 0.125), (0.25, 0.0625)]


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ assembly2d

LOCALS = {
    "stiffness": lambda m, hx, hy: m.q1_local_stiffness(hx, hy),
    "mass": lambda m, hx, hy: m.q1_local_mass(hx, hy),
    "convection": lambda m, hx, hy: m.q1_local_convection(hx, hy, 3.0, 1.5),
    "operator": lambda m, hx, hy: m.q1_local_operator(hx, hy, 1.3, -4.0,
                                                      3.0, 1.5),
    "numerov_A": lambda m, hx, hy: m.q1_numerov_locals(hx, hy, 1.3, 2.0)[0],
    "numerov_M": lambda m, hx, hy: m.q1_numerov_locals(hx, hy, 1.3, 2.0)[1],
    "varcoeff_S": lambda m, hx, hy: m.q1_varcoeff_parts(hx, hy)[0],
    "varcoeff_dxq": lambda m, hx, hy: m.q1_varcoeff_parts(hx, hy)[1],
    "varcoeff_dyq": lambda m, hx, hy: m.q1_varcoeff_parts(hx, hy)[2],
}


@pytest.mark.parametrize("hx,hy", SIZES)
@pytest.mark.parametrize("which", sorted(LOCALS))
def test_q1_locals_match_jax(which, hx, hy):
    close(LOCALS[which](A, hx, hy), LOCALS[which](JA, hx, hy), 1e-14)


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(0)
    ny, nx = 6, 9
    xs = np.linspace(-1.0, 1.0, nx + 1)
    ys = np.linspace(-1.0, 1.0, ny + 1)
    return dict(u=rng.normal(size=(ny + 1, nx + 1)), xs=xs, ys=ys,
                hx=2.0 / nx, hy=2.0 / ny)


def _a_fn(x, y):
    return 1.0 + 0.5 * x * y


def _f_fn(m):
    return lambda x, y: m.sin(2.0 * x) * m.cos(y) + x * y


GRID_OPS = ["coeff_maps", "apply_stiffness", "apply_stiffness_var",
            "stiffness_diag", "stiffness_var_diag", "assemble_load"]


@pytest.mark.parametrize("op", GRID_OPS)
def test_grid_ops_match_jax(grid, op):
    g = grid
    Kl = JA.q1_local_operator(g["hx"], g["hy"], 1.3, -4.0, 3.0, 1.5)
    Sq, dxq, dyq = JA.q1_varcoeff_parts(g["hx"], g["hy"])
    shape = g["u"].shape
    jam = JA.coeff_maps(jnp.asarray(g["xs"]), jnp.asarray(g["ys"]), _a_fn,
                        dxq, dyq)
    tam = A.coeff_maps(t64(g["xs"]), t64(g["ys"]), _a_fn, dxq, dyq)
    if op == "coeff_maps":
        got, want = tam, jam
    elif op == "apply_stiffness":
        got = A.apply_stiffness(t64(g["u"]), Kl)
        want = JA.apply_stiffness(jnp.asarray(g["u"]), jnp.asarray(Kl))
        close(A.apply_stiffness(t64(g["u"]), t64(Kl)), want)
    elif op == "apply_stiffness_var":
        got = A.apply_stiffness_var(t64(g["u"]), Sq, tam)
        want = JA.apply_stiffness_var(jnp.asarray(g["u"]), jnp.asarray(Sq),
                                      jam)
    elif op == "stiffness_diag":
        got = A.stiffness_diag(shape, Kl, torch.float64)
        want = JA.stiffness_diag(shape, jnp.asarray(Kl), jnp.float64)
    elif op == "stiffness_var_diag":
        got = A.stiffness_var_diag(shape, Sq, tam, torch.float64)
        want = JA.stiffness_var_diag(shape, jnp.asarray(Sq), jam,
                                     jnp.float64)
    else:
        got = A.assemble_load(t64(g["xs"]), t64(g["ys"]), _f_fn(torch))
        want = JA.assemble_load(jnp.asarray(g["xs"]), jnp.asarray(g["ys"]),
                                _f_fn(jnp))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


# ------------------------------------------------------------------- cg

@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
@pytest.mark.parametrize("precond", ["none", "diag", "callable"])
def test_krylov_matches_jax(solver, precond):
    """Same iterates: solution to 1e-9, iteration count within 1 of
    JAX's, the residual field under the stopping rule."""
    rng = np.random.default_rng(1)
    n = 24
    Q = rng.normal(size=(n, n))
    Amat = Q @ Q.T + n * np.eye(n)
    if solver == "bicgstab":
        Amat = Amat + 3.0 * rng.normal(size=(n, n))  # nonsymmetric
    b = rng.normal(size=n)
    d = 1.0 / np.diag(Amat)
    jm = {"none": None, "diag": jnp.asarray(d),
          "callable": lambda r: jnp.asarray(d) * r}[precond]
    tm = {"none": None, "diag": t64(d),
          "callable": lambda r: t64(d) * r}[precond]
    want = getattr(JCG, solver)(lambda v: jnp.asarray(Amat) @ v,
                                jnp.asarray(b), M_inv=jm, tol=1e-12,
                                maxiter=200)
    got = getattr(CG, solver)(lambda v: t64(Amat) @ v, t64(b), M_inv=tm,
                              tol=1e-12, maxiter=200)
    close(got.x, want.x, 1e-9)
    close(got.x, np.linalg.solve(Amat, b), 1e-9)
    assert abs(got.iters - int(want.iters)) <= 1
    assert isinstance(got.iters, int) and 0 < got.iters < 200
    assert float(got.residual) <= 1e-12 * (np.linalg.norm(b) + 1e-30)


def test_krylov_stops_at_maxiter():
    Amat = np.diag(np.arange(1.0, 31.0))
    b = np.ones(30)
    for solver in (CG.cg, CG.bicgstab):
        res = solver(lambda v: t64(Amat) @ v, t64(b), tol=1e-14, maxiter=3)
        assert res.iters == 3 and float(res.residual) > 0


# ------------------------------------------------------------ multigrid

@pytest.fixture(scope="module")
def grid17():
    return np.random.default_rng(2).normal(size=(17, 17))


def test_restrict_matches_jax(grid17):
    got = MG.restrict_full_weighting(t64(grid17))
    assert tuple(got.shape) == (9, 9)
    close(got, JM.restrict_full_weighting(jnp.asarray(grid17)))


def test_prolong_matches_jax(grid17):
    c = grid17[:9, :9]
    got = MG.prolong_bilinear(t64(c))
    assert tuple(got.shape) == (17, 17)
    close(got, JM.prolong_bilinear(jnp.asarray(c)))


@pytest.mark.parametrize("hook", ["shared", "loc_for_level",
                                  "apply_diag_for_level"])
def test_vcycle_matches_jax(grid17, hook):
    """One V-cycle application (fewer sweeps than the default, for the
    JAX side's time: the cycle's structure is the same)."""
    h = 2.0 / 16
    kw = dict(nu=1, coarse_sweeps=3)

    def loc(lvl):
        s = float(2 ** lvl)
        return JA.q1_local_operator(h * s, h * s, 1.0, 2.0)

    if hook == "shared":
        Kl = JA.q1_local_operator(h, h)
        jv = JM.make_vcycle(17, 17, jnp.asarray(Kl), jnp.float64, **kw)
        tv = MG.make_vcycle(17, 17, Kl, torch.float64, **kw)
    elif hook == "loc_for_level":
        jv = JM.make_vcycle(17, 17, None, jnp.float64,
                            loc_for_level=lambda i: jnp.asarray(loc(i)),
                            **kw)
        tv = MG.make_vcycle(17, 17, None, torch.float64, loc_for_level=loc,
                            **kw)
    else:
        jp = JH2.variable_coeff_elliptic_2d()
        tp = H2.variable_coeff_elliptic_2d()
        jv = JM.make_vcycle(
            17, 17, None, jnp.float64, apply_diag_for_level=JH2.
            _varcoeff_mg_levels(jp, h, h, jnp.float64, c_override=2.0), **kw)
        tv = MG.make_vcycle(
            17, 17, None, torch.float64, apply_diag_for_level=H2.
            _varcoeff_mg_levels(tp, h, h, torch.float64, c_override=2.0),
            **kw)
    got = tv(t64(grid17))
    close(got, jv(jnp.asarray(grid17)))
    assert float(got[0].abs().max()) == 0.0  # Dirichlet rim stays zero


# ------------------------------------------------------------------ adi

def test_adi_preconditioner_matches_jax():
    r = np.random.default_rng(3).normal(size=(9, 17))
    hx, hy = 2.0 / 16, 2.0 / 8
    want = JT.make_adi_preconditioner(9, 17, hx, hy, jnp.float64)(
        jnp.asarray(r))
    got = T.make_adi_preconditioner(9, 17, hx, hy, torch.float64)(t64(r))
    assert tuple(got.shape) == (9, 17)
    close(got, want)


def test_adi_sweeps_with_padding_match_jax():
    f = np.zeros((7, 15))  # the shapes of the test above: no new compile
    f[:6, :14] = np.random.default_rng(4).normal(size=(6, 14))
    args = (0.125, 0.25, 20.0, 2)
    want = JT.adi_poisson_sweeps(jnp.asarray(f), *args, true_shape=(6, 14))
    got = T.adi_poisson_sweeps(t64(f), *args, true_shape=(6, 14))
    close(got, want)
    assert float(got[6:].abs().max()) == 0.0


# ------------------------------------------------------------------ kkt

def _fields(bundle):
    if hasattr(bundle, "_asdict"):
        return bundle._asdict()
    return {f.name: getattr(bundle, f.name)
            for f in dataclasses.fields(bundle)}


def assert_bundles_close(got, want, atol):
    """Every field of a JAX bundle against the port's, relative to the
    field's own size."""
    gf, wf = _fields(got), _fields(want)
    assert set(gf) == set(wf)
    for k, w in wf.items():
        g = gf[k]
        if w is None:
            assert g is None, k
        elif isinstance(w, (int, float)):
            assert g == pytest.approx(w, rel=1e-14), k
        else:
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape, k
            np.testing.assert_allclose(np.asarray(g), w, rtol=0, err_msg=k,
                                       atol=atol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("rcond", [None, 1e-10])
def test_precompute_shared_lse_host_matches_jax(rcond):
    rng = np.random.default_rng(5)
    D0 = rng.normal(size=(16, 12))
    B = rng.normal(size=(5, 12))
    if rcond is not None:
        B[4] = B[0] + 2.0 * B[1]  # rank-deficient trace rows
    factors = [rng.normal(size=16), rng.normal(size=16)]
    want = JK.precompute_shared_lse_host(D0, B, jnp.float64,
                                         rhs_colloc_factors=factors,
                                         rcond=rcond)
    got = K.precompute_shared_lse_host(D0, B, torch.float64,
                                       rhs_colloc_factors=factors,
                                       rcond=rcond)
    assert_bundles_close(got, want, 1e-10)
    bc = B @ rng.normal(size=12)  # consistent with the dependency
    w = got.Wf.numpy() @ rng.normal(size=16) + got.Wbc.numpy() @ bc
    close(B @ w, bc, 1e-9)


@pytest.mark.parametrize("name,formulation", [
    ("poisson_2d", "primal"), ("poisson_2d", "dual"),
    ("advection_diffusion_2d", "primal"),
    ("variable_coeff_elliptic_2d", "primal")])
def test_prepare_shared_2d_matches_jax_through_converter(name, formulation):
    kw = dict(nx=8, ny=4, M=5, n_colloc=5, formulation=formulation)
    jops, (jt, jb) = JH2.prepare_shared_2d(JH2.get_problem_2d(name),
                                           JH2.Solver2DConfig(**kw))
    tops, (tt, tb) = H2.prepare_shared_2d(H2.get_problem_2d(name),
                                          H2.Solver2DConfig(**kw))
    close(tt, jt, 1e-15)
    close(tb, jb, 1e-15)
    assert_bundles_close(tops, jops, 1e-10)
    arrays = {k: (v if isinstance(v, (int, float)) else np.asarray(v))
              for k, v in jops._asdict().items() if v is not None}
    if name.startswith("variable"):
        conv = convert.varcoeff2d_operators_from_arrays(arrays,
                                                        dtype=torch.float64)
        assert conv.n_terms == jops.n_terms == 3
        assert tuple(conv.NZ.shape) == (81, 6 * 25)
    else:
        conv = convert.shared_operators_from_arrays(arrays,
                                                       dtype=torch.float64)
    assert_bundles_close(conv, jops, 0.0)


def test_boundary_coords_and_lift_weights_match_jax():
    close(H2._boundary_coords(6), JH2._boundary_coords(6), 0.0)
    tb = np.linspace(-1.0, 1.0, 5)
    for n_nodes, stencil in ((9, 6), (4, 6)):
        ji, jw = JH2._lift_weights(n_nodes, tb, stencil)
        ti, tw = H2._lift_weights(n_nodes, tb, stencil)
        np.testing.assert_array_equal(ti, ji)
        close(tw, jw, 0.0)
    fem = np.random.default_rng(6).normal(size=(5, 9))
    close(H2._lifted_trace_2d(t64(fem), 5, 8, 4),
          JH2._lifted_trace_2d(jnp.asarray(fem), 5, 8, 4))


# ------------------------------------------------------------- problems

PROBLEMS = sorted(JH2._PROBLEMS_2D)
FIELDS = ["f", "g", "exact", "a_var", "grad_a", "g_natural", "f_shifted",
          "f_factors", "statics"]


def _has(name, field):
    attr = {"f_factors": "f_elem_factors", "statics": "name"}.get(field,
                                                                  field)
    return getattr(JH2.get_problem_2d(name), attr) is not None


# One case per problem and field that the problem defines (the JAX
# registry is static, so every worker collects the same cases).
CASES = [(n, f) for n in PROBLEMS for f in FIELDS if _has(n, f)]


@pytest.mark.parametrize("name,field", CASES)
def test_problem_callables_match_jax(name, field):
    jp, tp = JH2.get_problem_2d(name), H2.get_problem_2d(name)
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40)
    xl, yl = rng.uniform(-1, 1, (1, 7)), rng.uniform(-1, 1, (1, 7))
    dx, dy = rng.uniform(0, 0.2, (5, 1)), rng.uniform(0, 0.2, (5, 1))
    if field == "statics":
        for k in ("name", "domain", "bc_edges", "robin_alpha", "a0", "c",
                  "b"):
            assert getattr(tp, k) == getattr(jp, k), k
        for k in FIELDS[:7] + ["f_elem_factors", "f_colloc_factors"]:
            assert (getattr(tp, k) is None) == (getattr(jp, k) is None), k
        return
    if field == "f_factors":
        ja = jp.f_elem_factors(jnp.asarray(xl), jnp.asarray(yl))
        ta = tp.f_elem_factors(t64(xl), t64(yl))
        jb = jp.f_colloc_factors(dx[:, 0], dy[:, 0])
        tb = tp.f_colloc_factors(dx[:, 0], dy[:, 0])
        assert len(ta) == len(ja) == len(tb) == len(jb)
        for a, b, c, d in zip(ta, ja, tb, jb):
            close(a, b)
            close(c, d, 0.0)
        total = sum(a * t64(b)[:, None] for a, b in zip(ta, tb))
        close(total, tp.f(t64(xl + dx[:, :1]), t64(yl + dy[:, :1])), 1e-11)
        return
    jfn, tfn = getattr(jp, field), getattr(tp, field)
    if field == "f_shifted":
        got = tfn(t64(xl), t64(dx), t64(yl), t64(dy))
        close(got, jfn(jnp.asarray(xl), jnp.asarray(dx), jnp.asarray(yl),
                       jnp.asarray(dy)))
        close(got, tp.f(t64(xl + dx), t64(yl + dy)), 1e-11)
    elif field == "grad_a":
        for t, j in zip(tfn, jfn):
            close(t(t64(x), t64(y)), j(jnp.asarray(x), jnp.asarray(y)))
    else:
        got = tfn(t64(x), t64(y))
        assert tuple(got.shape) == (40,)
        close(got, jfn(jnp.asarray(x), jnp.asarray(y)))


def test_get_problem_2d_registry():
    assert sorted(H2._PROBLEMS_2D) == PROBLEMS
    assert H2.get_problem_2d("helmholtz_2d", k=3.0).c == -9.0
    with pytest.raises(ValueError, match="unknown 2D problem"):
        H2.get_problem_2d("nope")
