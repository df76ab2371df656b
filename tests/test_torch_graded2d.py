"""The port's graded-mesh 2D solver against the JAX package's.

Inputs (node arrays, nodal values) come from numpy with a seed and go
through the JAX function and its PyTorch counterpart:

* ``assembly2d.q1_reference_parts`` / ``q1_reference_quad_parts``,
  ``prepare_shared_2d_graded`` (through the converter), ``graded_fem_parts``,
  ``fem_solve_2d_graded`` and ``_graded_element_operators``, float64, 1e-12
  unless stated;
* the plain version of ``fused_enhance_graded_2d`` against JAX's Pallas
  kernel in interpret mode, once (16 x 16 quads on a random mesh, M = C =
  5, as ``tests/test_pallas.py:383`` runs it), and against JAX's XLA route
  in every other case, at ``test_pallas.py``'s tolerances: w 3e-5, bcv
  1e-5, slack ratio in (0.2, 5);
* the whole solver, ``HybridSolver2DGraded``, float64, on uniform and
  random meshes: nodal values to 1e-10, coefficients to 1e-9 beyond what
  each side's own trace constraints allow.  Every float64 graded solve goes
  through the per-element Schur/Cholesky route, which factors
  H = I + gamma D^T D: at the default gamma = 1e4 either package meets its
  constraints B w = bc only to ~5e-8 there, so two summation orders differ
  by as much; at gamma = 1e2 both meet them to ~6e-10 and agree to 3e-10.
* one round of ``adaptive_solve_2d``, which must bisect the same intervals.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import hybrid2d as JH2
from hybrid_fem_lssvr_tpu.models import hybrid2d_graded as JG
from hybrid_fem_lssvr_tpu.ops import assembly2d as JA
from hybrid_fem_lssvr_tpu.ops import kkt as JK
from hybrid_fem_lssvr_tpu.ops import pallas_kernels as pk

from hybrid_fem_lssvr_tpu_torch import HybridSolver2DGraded, Solver2DConfig
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
from hybrid_fem_lssvr_tpu_torch.models import hybrid2d_graded as HG
from hybrid_fem_lssvr_tpu_torch.ops import assembly2d as A
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

M = C = 5


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def np_(t):
    return np.asarray(t)


def close(got, want, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def random_nodes(n, seed):
    """n intervals on [-1, 1]: uniform nodes, the interior ones moved by up
    to 0.35 of a spacing (widths vary by up to a factor 6.5)."""
    x = np.linspace(-1.0, 1.0, n + 1)
    x[1:-1] += np.random.default_rng(seed).uniform(-0.35, 0.35, n - 1) * (
        2.0 / n)
    return x


MESHES = {
    "uniform": lambda nx, ny: (np.linspace(-1, 1, nx + 1),
                               np.linspace(-1, 1, ny + 1)),
    "random": lambda nx, ny: (random_nodes(nx, 0), random_nodes(ny, 1)),
}


# ------------------------------------------------------ reference parts

PARTS = [("parts", i) for i in range(5)] + [("quad_parts", i)
                                            for i in range(3)]


@pytest.mark.parametrize("which,i", PARTS)
def test_q1_reference_parts_match_jax(which, i):
    fn = f"q1_reference_{which}"
    close(getattr(A, fn)()[i], getattr(JA, fn)()[i], 0.0)


def test_reference_parts_rebuild_the_local_operator():
    hx, hy, a0, c, bx, by = 0.25, 0.125, 1.3, 2.0, 3.0, -1.5
    Cxx, Cyy, Mh, Chx, Chy = A.q1_reference_parts()
    K = (a0 * (hy / hx) * Cxx + a0 * (hx / hy) * Cyy + c * hx * hy / 4 * Mh
         + bx * hy / 2 * Chx + by * hx / 2 * Chy)
    close(K, A.q1_local_operator(hx, hy, a0, c, bx, by), 1e-14)


# ------------------------------------------------ precompute and coarse

@pytest.mark.parametrize("name", ["poisson_2d", "variable_coeff_elliptic_2d"])
def test_prepare_shared_2d_graded_matches_jax_through_converter(name):
    cfg = dict(M=M, n_colloc=C)
    jops, (jt, jb) = JG.prepare_shared_2d_graded(JH2.get_problem_2d(name),
                                                 JH2.Solver2DConfig(**cfg))
    tops, (tt, tb) = HG.prepare_shared_2d_graded(H2.get_problem_2d(name),
                                                 H2.Solver2DConfig(**cfg))
    close(tt, jt, 0.0)
    close(tb, jb, 0.0)
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()}
    conv = convert.graded2d_operators_from_arrays(arrays,
                                                  dtype=torch.float64)
    for k, v in arrays.items():
        close(getattr(tops, k), v, 1e-12)
        close(getattr(conv, k), v, 0.0)
    assert tuple(tops.AZ.shape) == (5 * C * C, M * M - (4 * M - 4))


def test_prepare_refuses_natural_edges():
    for name in ("poisson_2d_neumann", "robin_2d"):
        with pytest.raises(NotImplementedError, match="Dirichlet only"):
            HG.prepare_shared_2d_graded(H2.get_problem_2d(name),
                                        Solver2DConfig())


COARSE = ["poisson_2d", "variable_coeff_elliptic_2d",
          "advection_diffusion_2d", "reaction_diffusion_2d"]


@pytest.mark.parametrize("name", COARSE)
def test_graded_fem_parts_match_jax(name):
    """The coarse operator's reference parts and per-element maps (the
    coarse solve itself is held by the whole-solver tests below)."""
    xs, ys = MESHES["random"](7, 5)
    jp, tp = JH2.get_problem_2d(name), H2.get_problem_2d(name)
    jS, jmaps = JG.graded_fem_parts(jp, jnp.asarray(xs), jnp.asarray(ys))
    tS, tmaps = HG.graded_fem_parts(tp, t64(xs), t64(ys))
    close(tS, jS, 0.0)
    close(tmaps, jmaps)


@pytest.mark.parametrize("name,grad", [
    ("variable_coeff_elliptic_2d", "analytic"),
    ("variable_coeff_elliptic_2d", "autograd"),
    ("advection_diffusion_2d", "analytic"),
    ("helmholtz_2d", "analytic")])
def test_graded_element_operators_match_jax(name, grad):
    xs, ys = MESHES["random"](4, 3)
    cfg = dict(M=M, n_colloc=C)
    jp, tp = JH2.get_problem_2d(name), H2.get_problem_2d(name)
    if grad == "autograd":
        tp = dataclasses.replace(tp, grad_a=None)
    jops, (t_int, _) = JG.prepare_shared_2d_graded(jp,
                                                   JH2.Solver2DConfig(**cfg))
    tops, _ = HG.prepare_shared_2d_graded(tp, Solver2DConfig(**cfg))
    want = JG._graded_element_operators(jp, JH2.Solver2DConfig(**cfg),
                                        jnp.asarray(xs), jnp.asarray(ys),
                                        jops, t_int)
    got = HG._graded_element_operators(tp, Solver2DConfig(**cfg), t64(xs),
                                       t64(ys), tops, np.asarray(t_int))
    assert tuple(got.shape) == (4 * 3, C * C, M * M)
    close(got, want, 1e-10)


# ------------------------------------------------------------ the kernel

N = 16


def kernel_case(name, mesh, nx=N, ny=N, seed=0, jax_route=True):
    """float32 bundles, nodal values (the exact solution plus noise), the
    mesh, and JAX's XLA route on them (``jax_route``: each new shape costs
    a JAX compile)."""
    cfg = JH2.Solver2DConfig(nx=nx, ny=ny, M=M, n_colloc=C, dtype="float32")
    jp, tp = JH2.get_problem_2d(name), H2.get_problem_2d(name)
    jops, (t_int, bpts) = JG.prepare_shared_2d_graded(jp, cfg)
    tops = convert.graded2d_operators_from_arrays(
        {k: np.asarray(v) for k, v in jops._asdict().items()})
    xs, ys = MESHES[mesh](nx, ny)
    xs32, ys32 = xs.astype(np.float32), ys.astype(np.float32)
    X, Y = np.meshgrid(xs32.astype(np.float64), ys32.astype(np.float64))
    u = np.array(jp.exact(jnp.asarray(X), jnp.asarray(Y)))
    u[1:-1, 1:-1] += 1e-3 * np.random.default_rng(seed).normal(
        size=(ny - 1, nx - 1))
    fem = u.astype(np.float32)
    xla = None
    if jax_route:
        jx, jy = jnp.asarray(xs32), jnp.asarray(ys32)
        f_rows, bc_rows, _ = JH2._element_data_2d(
            jp, cfg, jx, jy, jnp.asarray(fem), t_int, bpts)
        D = JG._graded_element_operators(jp, cfg, jx, jy, jops, t_int)
        xla = JK.solve_batched(D, jops.B, f_rows, bc_rows, cfg.gamma,
                               ZP=(jops.Z, jops.Pbc))
    return dict(jp=jp, tp=tp, jops=jops, tops=tops, fem=fem, xs=xs32,
                ys=ys32, t_int=np.asarray(t_int), bpts=np.asarray(bpts),
                xla=xla, nx=nx, ny=ny)


def run_kernel(c, problem=None, **kw):
    return KG.fused_enhance_graded_2d(
        torch.from_numpy(c["fem"]), c["tops"], problem or c["tp"],
        torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"]), c["nx"],
        c["ny"], c["t_int"], c["bpts"], **kw)


def assert_matches(got, w, bcv, slack):
    close(got[0], w, 3e-5)
    close(got[2], bcv, 1e-5)
    r = float(got[1].max()) / max(float(np.max(np_(slack))), 1e-30)
    assert 0.2 < r < 5.0, r


@pytest.fixture(scope="module")
def pallas_run():
    """The one interpret-mode run of JAX's kernel: variable coefficients on
    a random mesh."""
    c = kernel_case("variable_coeff_elliptic_2d", "random")
    out = pk.fused_enhance_graded_2d(
        jnp.asarray(c["fem"]), c["jops"], c["jp"], jnp.asarray(c["xs"]),
        jnp.asarray(c["ys"]), N, N, c["t_int"], c["bpts"], tile=256,
        interpret=True)
    return c, out


def test_graded_kernel_matches_pallas(pallas_run):
    c, (w, slack, bcv) = pallas_run
    got = run_kernel(c)
    assert tuple(got[0].shape) == (N * N, M * M)
    assert_matches(got, w, bcv, slack)
    assert_matches(got, c["xla"][0], c["xla"][1].bc_violation,
                   c["xla"][1].max_slack)


@pytest.fixture(scope="module", params=[
    ("advection_diffusion_2d", "uniform"), ("advection_diffusion_2d", "random"),
    ("variable_coeff_elliptic_2d", "uniform"), ("helmholtz_2d", "random")])
def xla_case(request):
    return kernel_case(*request.param)


@pytest.mark.parametrize("diag", [True, False])
def test_graded_kernel_matches_jax_xla_route(xla_case, diag):
    c = xla_case
    got = run_kernel(c, with_diagnostics=diag)
    w_xla, d_xla = c["xla"]
    if not diag:
        close(got[0], w_xla, 3e-5)
        assert got[1] is None and got[2] is None
        return
    assert_matches(got, w_xla, d_xla.bc_violation, d_xla.max_slack)
    ref = KG.fused_enhance_graded_2d_ref(
        torch.from_numpy(c["fem"]), c["tops"], c["tp"],
        torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"]), N, N,
        c["t_int"], c["bpts"])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_ragged_graded_mesh_matches_the_torch_route():
    """nx = 5, ny = 3, no multiple of a TPU tile: held against the port's
    own torch route (``enhance_2d_graded`` on the CPU), which the
    whole-solver tests hold against JAX."""
    c = kernel_case("variable_coeff_elliptic_2d", "random", nx=5, ny=3,
                    seed=2, jax_route=False)
    got = run_kernel(c)
    assert tuple(got[0].shape) == (15, M * M)
    cfg = Solver2DConfig(M=M, n_colloc=C, dtype="float32")
    coeffs, diags = HG.enhance_2d_graded(
        c["tp"], cfg, torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"]),
        torch.from_numpy(c["fem"]),
        (c["tops"], (c["t_int"], c["bpts"])))
    assert bool(diags.solve_ok.all())
    assert_matches(got, coeffs.reshape(15, M * M), diags.bc_violation,
                   diags.max_slack)


def test_graded_kernel_argument_checks():
    c = kernel_case("variable_coeff_elliptic_2d", "uniform", nx=4, ny=4,
                    jax_route=False)
    with pytest.raises(ValueError, match="analytic grad_a"):
        run_kernel(c, problem=dataclasses.replace(c["tp"], grad_a=None))
    with pytest.raises(ValueError, match="AZ/AP"):
        KG.fused_enhance_graded_2d(
            torch.from_numpy(c["fem"]), dataclasses.replace(c["tops"],
                                                            AZ=None),
            c["tp"], torch.from_numpy(c["xs"]), torch.from_numpy(c["ys"]),
            4, 4, c["t_int"], c["bpts"])
    with pytest.raises(ValueError, match="node positions"):
        KG.fused_enhance_graded_2d(
            torch.from_numpy(c["fem"]), c["tops"], c["tp"],
            torch.from_numpy(c["xs"][:-1]), torch.from_numpy(c["ys"]), 4, 4,
            c["t_int"], c["bpts"])
    x = torch.from_numpy(c["fem"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        KG._cuda(x, None, x, x, x, c["tops"], c["tp"], x, x, 4, 4, True)
    assert KG.launch_counts() == {"fused_enhance_graded_2d": 0}


def test_graded_source_compiles_the_2d_shape_list():
    import os

    path = os.path.join(os.path.dirname(KG.__file__), os.pardir, "csrc",
                        "enhance2d_graded.cu")
    with open(path) as fh:
        text = fh.read()
    assert '#include "enhance_common.cuh"' in text
    assert "ENH2D_SHAPES(X)" in text and "#define ENH2D_SHAPES" not in text


# ----------------------------------------------------- the whole solver

def solve_both(name, mesh, nx=8, ny=6, **kw):
    xs, ys = MESHES[mesh](nx, ny)
    cfg = dict(M=M, n_colloc=C, **kw)
    js = JG.HybridSolver2DGraded(JH2.get_problem_2d(name),
                                 JH2.Solver2DConfig(**cfg), xs, ys)
    js.solve()
    ts = HybridSolver2DGraded(H2.get_problem_2d(name), Solver2DConfig(**cfg),
                              xs, ys, device="cpu")
    ts.solve()
    return ts, js


def assert_same_solution(got, want):
    close(got.fem_values, want.fem_values, 1e-10)
    own = max(float(got.bc_violation.max()), float(np.max(want.bc_violation)))
    tol = 1e-9 + own
    close(got.coeffs, want.coeffs, tol)
    assert tuple(got.coeffs.shape) == tuple(want.coeffs.shape)
    assert abs(got.cg_iters - int(want.cg_iters)) <= 1
    np.testing.assert_array_equal(np.asarray(got.solve_ok),
                                  np.asarray(want.solve_ok))
    assert bool(got.solve_ok.all())
    close(got.xs, want.xs, 0.0)
    close(got.ys, want.ys, 0.0)
    return tol


SOLVES = [("poisson_2d", "uniform", {}), ("poisson_2d", "random", {}),
          ("poisson_2d_inhomogeneous", "random", {}),
          ("variable_coeff_elliptic_2d", "random", {}),
          ("advection_diffusion_2d", "random", {}),
          ("helmholtz_2d", "random", {}),
          ("poisson_2d", "random", dict(formulation="dual")),
          ("variable_coeff_elliptic_2d", "random", dict(gamma=1e2))]


@pytest.mark.parametrize("name,mesh,kw", SOLVES,
                         ids=[f"{n}-{m}-{'-'.join(map(str, k.values()))}"
                              for n, m, k in SOLVES])
def test_graded_solver_matches_jax_float64(name, mesh, kw):
    ts, js = solve_both(name, mesh, **kw)
    tol = assert_same_solution(ts.solution, js.solution)
    if kw.get("gamma") == 1e2:
        close(ts.solution.coeffs, js.solution.coeffs, 1e-9)
    # A value sums M^2 coefficients times Legendre values of at most 1 (in
    # the domain; up to ~2 in the extrapolated margin); a derivative adds
    # the chain factor 2/h_e < 20 and |P_k'| <= k (k + 1) / 2 = 10.
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-1.1, 1.1, 300), rng.uniform(-1.1, 1.1, 300)
    close(ts.evaluate_solution(x, y), js.evaluate_solution(x, y),
          2 * M * M * tol)
    for g, w in zip(ts.evaluate_gradient(x, y), js.evaluate_gradient(x, y)):
        close(g, w, 400 * M * M * tol)
    for g, w in zip(ts.errors(x, y), js.errors(x, y)):
        assert float(g) == pytest.approx(float(w), abs=2 * M * M * tol)


def test_uniform_graded_mesh_equals_the_uniform_solver():
    """On a uniform mesh the graded path solves the uniform path's
    problem: the same nodal values (one Jacobi-CG each)."""
    ts, _ = solve_both("poisson_2d", "uniform")
    uni = H2.HybridSolver2D(H2.get_problem_2d("poisson_2d"),
                            Solver2DConfig(nx=8, ny=6, M=M, n_colloc=C,
                                           precond="jacobi"), device="cpu")
    uni.solve()
    close(ts.solution.fem_values, uni.solution.fem_values, 1e-10)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 200))
    close(ts.evaluate_solution(*x), uni.evaluate_solution(*x), 1e-6)


def test_adaptive_round_refines_the_same_intervals():
    jp, tp = (m.get_problem_2d("variable_coeff_elliptic_2d")
              for m in (JH2, H2))
    cfg = dict(nx=6, ny=4, M=M, n_colloc=C)
    pts = np.random.default_rng(6).uniform(-1, 1, (2, 200))
    want = JG.adaptive_solve_2d(jp, JH2.Solver2DConfig(**cfg), rounds=1,
                                eval_points=pts)
    got = HG.adaptive_solve_2d(tp, Solver2DConfig(**cfg), rounds=1,
                               eval_points=pts, device="cpu")
    close(got.xs, want.xs, 0.0)
    close(got.ys, want.ys, 0.0)
    assert len(got.xs) > 7 and len(got.ys) > 5
    for g, w in zip(got.history, want.history):
        assert g["elements"] == w["elements"]
        assert g["max_slack"] == pytest.approx(w["max_slack"], rel=1e-6)
        assert g["linf"] == pytest.approx(w["linf"], abs=1e-7)
    close(HG.refine_axis(np.linspace(0, 1, 5), np.array([0, 3, 1, 2.0]),
                         0.5), np.array([0, 0.25, 0.375, 0.5, 0.75, 0.875,
                                         1.0]), 0.0)


def test_solver_runs_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; see tests/test_torch_cuda.py")
    xs = np.linspace(-1, 1, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridSolver2DGraded(H2.get_problem_2d("poisson_2d"),
                             Solver2DConfig(), xs, xs)
    with pytest.raises(RuntimeError, match="call solve"):
        HybridSolver2DGraded(H2.get_problem_2d("poisson_2d"),
                             Solver2DConfig(), xs, xs,
                             device="cpu").evaluate_solution([0.0], [0.0])
