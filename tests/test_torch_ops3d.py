"""The port's 3D building blocks against the JAX package, float64 on the CPU.

Inputs come from numpy with a seed and go through the JAX function and its
PyTorch counterpart: the Q1 hex assembly (``ops/assembly3d.py``), the 3D
half of the V-cycle (``ops/multigrid.py``), the surface points, the lifted
trace and the face-mass helpers of ``models/hybrid3d.py``,
``prepare_shared_3d`` through the converter, and every callable of every 3D
problem.  Tolerance 1e-12 absolute unless stated: both sides do the same
float64 arithmetic, in another order at most.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import hybrid3d as JH3
from hybrid_fem_lssvr_tpu.ops import assembly3d as JA3
from hybrid_fem_lssvr_tpu.ops import multigrid as JM

from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
from hybrid_fem_lssvr_tpu_torch.ops import assembly3d as A3
from hybrid_fem_lssvr_tpu_torch.ops import multigrid as MG
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

ATOL = 1e-12
SIZES = [(0.25, 0.25, 0.25), (0.5, 0.25, 0.125)]


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ------------------------------------------------------------ assembly3d

def _parts(i):
    return lambda m, hx, hy, hz: m.q1_reference_parts_3d()[i]


def _quad_parts(i):
    return lambda m, hx, hy, hz: m.q1_reference_quad_parts_3d()[i]


def _varcoeff(i):
    return lambda m, hx, hy, hz: m.q1_varcoeff_parts_3d(hx, hy, hz)[i]


LOCALS = {
    "laplacian": lambda m, hx, hy, hz: m.q1_local_operator_3d(hx, hy, hz),
    "operator": lambda m, hx, hy, hz: m.q1_local_operator_3d(
        hx, hy, hz, 1.3, -4.0, 3.0, 1.5, -0.5),
    "numerov_A": lambda m, hx, hy, hz: m.q1_numerov_locals_3d(
        hx, hy, hz, 1.3, 2.0)[0],
    "numerov_M": lambda m, hx, hy, hz: m.q1_numerov_locals_3d(
        hx, hy, hz, 1.3, 2.0)[1],
    **{f"varcoeff_{k}": _varcoeff(i)
       for i, k in enumerate(("S", "dxq", "dyq", "dzq"))},
    **{f"reference_{k}": _parts(i)
       for i, k in enumerate(("Cxx", "Cyy", "Czz", "Mh", "Chx", "Chy",
                              "Chz"))},
    **{f"reference_quad_{k}": _quad_parts(i)
       for i, k in enumerate(("Sxx", "Syy", "Szz", "tq"))},
}


@pytest.mark.parametrize("hx,hy,hz", SIZES)
@pytest.mark.parametrize("which", sorted(LOCALS))
def test_q1_hex_locals_match_jax(which, hx, hy, hz):
    close(LOCALS[which](A3, hx, hy, hz), LOCALS[which](JA3, hx, hy, hz),
          1e-14)


def test_reference_parts_rebuild_the_local_operator():
    """K_e of an hx x hy x hz hex is the per-element-scalar combination of
    the reference parts (what a graded hex mesh assembles from)."""
    hx, hy, hz, a0, c, b = 0.5, 0.25, 0.125, 1.3, 2.0, (3.0, 1.5, -0.5)
    Cxx, Cyy, Czz, Mh, Chx, Chy, Chz = A3.q1_reference_parts_3d()
    K = (a0 * (hy * hz / (2 * hx) * Cxx + hx * hz / (2 * hy) * Cyy
               + hx * hy / (2 * hz) * Czz) + c * hx * hy * hz / 8 * Mh
         + b[0] * hy * hz / 4 * Chx + b[1] * hx * hz / 4 * Chy
         + b[2] * hx * hy / 4 * Chz)
    close(K, A3.q1_local_operator_3d(hx, hy, hz, a0, c, *b), 1e-14)


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(0)
    nz, ny, nx = 3, 4, 5
    xs = np.linspace(-1.0, 1.0, nx + 1)
    ys = np.linspace(-0.5, 1.0, ny + 1)
    zs = np.linspace(-1.0, 0.5, nz + 1)
    return dict(u=rng.normal(size=(nz + 1, ny + 1, nx + 1)), xs=xs, ys=ys,
                zs=zs, h=(xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0]))


def _a_fn(x, y, z):
    return 1.0 + 0.5 * x * y * z


def _f_fn(m):
    return lambda x, y, z: m.sin(2.0 * x) * m.cos(y) * (1.0 + z) + x * y


GRID_OPS = ["coeff_maps_3d", "corners_3d", "apply_stiffness_3d",
            "apply_stiffness_var_3d", "stiffness_diag_3d",
            "stiffness_var_diag_3d", "assemble_load_3d"]


@pytest.mark.parametrize("op", GRID_OPS)
def test_hex_grid_ops_match_jax(grid, op):
    g = grid
    hx, hy, hz = g["h"]
    Kl = JA3.q1_local_operator_3d(hx, hy, hz, 1.3, -4.0, 3.0, 1.5, -0.5)
    Sq, dxq, dyq, dzq = JA3.q1_varcoeff_parts_3d(hx, hy, hz)
    shape = g["u"].shape
    jx, jy, jz = (jnp.asarray(g[k]) for k in ("xs", "ys", "zs"))
    tx, ty, tz = (t64(g[k]) for k in ("xs", "ys", "zs"))
    jam = JA3.coeff_maps_3d(jx, jy, jz, _a_fn, dxq, dyq, dzq)
    tam = A3.coeff_maps_3d(tx, ty, tz, _a_fn, dxq, dyq, dzq)
    ju, tu = jnp.asarray(g["u"]), t64(g["u"])
    if op == "coeff_maps_3d":
        got, want = tam, jam
    elif op == "corners_3d":
        for a, b in zip(A3._corners_3d(tu), JA3._corners_3d(ju)):
            close(a, b, 0.0)
        return
    elif op == "apply_stiffness_3d":
        got = A3.apply_stiffness_3d(tu, Kl)
        want = JA3.apply_stiffness_3d(ju, jnp.asarray(Kl))
        close(A3.apply_stiffness_3d(tu, t64(Kl)), want)
    elif op == "apply_stiffness_var_3d":
        got = A3.apply_stiffness_var_3d(tu, Sq, tam)
        want = JA3.apply_stiffness_var_3d(ju, jnp.asarray(Sq), jam)
    elif op == "stiffness_diag_3d":
        got = A3.stiffness_diag_3d(shape, Kl, torch.float64)
        want = JA3.stiffness_diag_3d(shape, jnp.asarray(Kl), jnp.float64)
    elif op == "stiffness_var_diag_3d":
        got = A3.stiffness_var_diag_3d(shape, Sq, tam, torch.float64)
        want = JA3.stiffness_var_diag_3d(shape, jnp.asarray(Sq), jam,
                                         jnp.float64)
    else:
        got = A3.assemble_load_3d(tx, ty, tz, _f_fn(torch))
        want = JA3.assemble_load_3d(jx, jy, jz, _f_fn(jnp))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


# ------------------------------------------------------------ multigrid

@pytest.fixture(scope="module")
def grid9():
    return np.random.default_rng(2).normal(size=(9, 9, 9))


def test_restrict_3d_matches_jax(grid9):
    got = MG.restrict_full_weighting_3d(t64(grid9))
    assert tuple(got.shape) == (5, 5, 5)
    close(got, JM.restrict_full_weighting_3d(jnp.asarray(grid9)))


def test_prolong_trilinear_matches_jax(grid9):
    c = grid9[:5, :5, :5]
    got = MG.prolong_trilinear(t64(c))
    assert tuple(got.shape) == (9, 9, 9)
    close(got, JM.prolong_trilinear(jnp.asarray(c)))
    # Trilinear interpolation reproduces a trilinear field exactly.
    i = torch.arange(5, dtype=torch.float64)
    lin = (1 + i[:, None, None]) * (2 - i[None, :, None]) * i[None, None, :]
    fine = MG.prolong_trilinear(lin)
    close(fine[::2, ::2, ::2], lin, 0.0)
    close(fine[1, 0, 0], 0.5 * (lin[0, 0, 0] + lin[1, 0, 0]), 1e-15)


@pytest.mark.parametrize("hook", ["shared", "loc_for_level",
                                  "apply_diag_for_level"])
def test_vcycle_3d_matches_jax(grid9, hook):
    """One V-cycle application on a 9^3 grid (two levels, fewer sweeps
    than the default for the JAX side's time: the cycle's structure is the
    same)."""
    h = 2.0 / 8
    kw = dict(nu=1, coarse_sweeps=2)

    def loc(lvl):
        s = float(2 ** lvl)
        return JA3.q1_local_operator_3d(h * s, h * s, h * s, 1.0, 2.0)

    if hook == "shared":
        Kl = JA3.q1_local_operator_3d(h, h, h)
        jv = JM.make_vcycle_3d(9, 9, 9, jnp.asarray(Kl), jnp.float64, **kw)
        tv = MG.make_vcycle_3d(9, 9, 9, Kl, torch.float64, **kw)
    elif hook == "loc_for_level":
        jv = JM.make_vcycle_3d(9, 9, 9, None, jnp.float64,
                               loc_for_level=lambda i: jnp.asarray(loc(i)),
                               **kw)
        tv = MG.make_vcycle_3d(9, 9, 9, None, torch.float64,
                               loc_for_level=loc, **kw)
    else:
        jp = JH3.variable_coeff_elliptic_3d()
        tp = H3.variable_coeff_elliptic_3d()
        jv = JM.make_vcycle_3d(
            9, 9, 9, None, jnp.float64, apply_diag_for_level=JH3.
            _varcoeff_mg_levels_3d(jp, h, h, h, jnp.float64, c_override=2.0),
            **kw)
        tv = MG.make_vcycle_3d(
            9, 9, 9, None, torch.float64, apply_diag_for_level=H3.
            _varcoeff_mg_levels_3d(tp, h, h, h, torch.float64,
                                   c_override=2.0), **kw)
    got = tv(t64(grid9))
    close(got, jv(jnp.asarray(grid9)))
    assert float(got[0].abs().max()) == 0.0  # Dirichlet rim stays zero
    assert float(got[:, :, -1].abs().max()) == 0.0


# ------------------------------------------------- hybrid3d helpers

@pytest.mark.parametrize("M", [3, 4, 5])
def test_surface_points_match_jax(M):
    got = H3._surface_coords(M)
    close(got, JH3._surface_coords(M), 0.0)
    assert got.shape == (M ** 3 - (M - 2) ** 3, 3)
    assert H3._surface_indices(M) == JH3._surface_indices(M)


def test_lifted_trace_3d_matches_jax():
    fem = np.random.default_rng(6).normal(size=(7, 8, 9))
    got = H3._lifted_trace_3d(t64(fem), 4, 8, 7, 6)
    assert tuple(got.shape) == (8 * 7 * 6, 56)
    close(got, JH3._lifted_trace_3d(jnp.asarray(fem), 4, 8, 7, 6))


def test_face_mass_helpers_match_jax():
    G = np.random.default_rng(8).normal(size=(5, 7))
    close(H3._mass1d_apply(t64(G), 0.25), JH3._mass1d_apply(
        jnp.asarray(G), 0.25))
    close(H3._face_mass_apply(t64(G), 0.25, 0.5),
          JH3._face_mass_apply(jnp.asarray(G), 0.25, 0.5))
    close(H3._mass1d_diag(6, 0.25, torch.float64, "cpu"),
          JH3._mass1d_diag(6, 0.25, jnp.float64))
    u = np.random.default_rng(9).normal(size=(3, 4, 5))
    for fc in range(6):
        vals = np.full(np.asarray(JH3._face_get(jnp.asarray(u), fc)).shape,
                       float(fc + 1))
        close(H3._face_add(t64(u), fc, t64(vals)),
              JH3._face_add(jnp.asarray(u), fc, jnp.asarray(vals)), 0.0)


def _arrays(bundle):
    return {k: np.asarray(v) for k, v in bundle._asdict().items()
            if v is not None}


@pytest.mark.parametrize("name,formulation", [
    ("poisson_3d", "primal"), ("poisson_3d", "dual"),
    ("advection_diffusion_3d", "primal"), ("helmholtz_3d", "primal"),
    ("variable_coeff_elliptic_3d", "primal")])
def test_prepare_shared_3d_matches_jax_through_converter(name, formulation):
    kw = dict(nx=4, ny=8, nz=2, formulation=formulation)
    jops, (jt, js) = JH3.prepare_shared_3d(JH3.get_problem_3d(name),
                                           JH3.Solver3DConfig(**kw))
    tops, (tt, ts) = H3.prepare_shared_3d(H3.get_problem_3d(name),
                                          H3.Solver3DConfig(**kw))
    close(tt, jt, 0.0)
    close(ts, js, 0.0)
    arrays = _arrays(jops)
    conv = (convert.varcoeff3d_operators_from_arrays
            if name.startswith("variable")
            else convert.shared_operators_from_arrays)(arrays,
                                                       dtype=torch.float64)
    for k, v in arrays.items():
        mine = getattr(tops, k)
        assert mine is not None, k
        # The host float64 algebra (SVD, QR, solves) in another order.
        close(mine, v, 1e-9 if k == "cond" else 1e-10)
        close(getattr(conv, k), v, 0.0)


# ------------------------------------------------------------- problems

PROBLEMS = sorted(JH3._PROBLEMS_3D)
FIELDS = ["f", "g", "exact", "a_var", "grad_a", "g_natural", "f_shifted",
          "statics"]


def _has(name, field):
    attr = "name" if field == "statics" else field
    return getattr(JH3.get_problem_3d(name), attr) is not None


CASES = [(n, f) for n in PROBLEMS for f in FIELDS if _has(n, f)]


@pytest.mark.parametrize("name,field", CASES)
def test_problem_3d_callables_match_jax(name, field):
    jp, tp = JH3.get_problem_3d(name), H3.get_problem_3d(name)
    rng = np.random.default_rng(7)
    x, y, z = (rng.uniform(-1, 1, 40) for _ in range(3))
    if field == "statics":
        for k in ("name", "domain", "bc_faces", "robin_alpha", "a0", "c",
                  "b"):
            assert getattr(tp, k) == getattr(jp, k), k
        for k in FIELDS[:7]:
            assert (getattr(tp, k) is None) == (getattr(jp, k) is None), k
        return
    jfn, tfn = getattr(jp, field), getattr(tp, field)
    if field == "f_shifted":
        low = [rng.uniform(-1, 1, (1, 7)) for _ in range(3)]
        off = [rng.uniform(0, 0.2, (5, 1)) for _ in range(3)]
        targs = [t64(v) for pair in zip(low, off) for v in pair]
        jargs = [jnp.asarray(v) for pair in zip(low, off) for v in pair]
        got = tfn(*targs)
        close(got, jfn(*jargs))
        close(got, tp.f(*(t64(a + b) for a, b in zip(low, off))), 1e-11)
    elif field == "grad_a":
        for t, j in zip(tfn, jfn):
            close(t(t64(x), t64(y), t64(z)),
                  j(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))
    else:
        got = tfn(t64(x), t64(y), t64(z))
        assert tuple(got.shape) == (40,)
        close(got, jfn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)))


def test_get_problem_3d_registry():
    assert sorted(H3._PROBLEMS_3D) == PROBLEMS
    assert H3.get_problem_3d("helmholtz_3d", k=3.0).c == -9.0
    assert H3.get_problem_3d("robin_3d", alpha=2.0).name == "robin_3d_alpha2"
    with pytest.raises(ValueError, match="unknown 3D problem"):
        H3.get_problem_3d("nope")
