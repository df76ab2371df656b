"""The port's 2D elasticity (``models/elastic.py``, ``ops/kernels2d_elastic``)
against the JAX package on the CPU.

Operators and nodal values are made with numpy from a seed and handed to
both packages.  In float64: the host operators to 1e-12, the block coarse
solve's nodal values to 1e-10 with CG iterations within one, whole solves'
coefficients to 1e-9.  The kernel's plain version is held against JAX's
Pallas kernel in interpret mode at 16 x 16 quads, M = C = 4, float32, at
``tests/test_pallas.py:423-469``'s tolerances (coefficients 3e-5, slack
and bcv rtol 5e-4), and on a ragged 5 x 3 mesh, which the Pallas tile rule
cannot run, against JAX's XLA route.  JAX's V-cycle takes ~20 s to compile
on the CPU, so ``precond='mg'`` is held against JAX once; every other
solve uses Jacobi.  The JAX calls run under ``jax.jit``: one compile of a
whole solve costs less than JAX's op-by-op compiles.  The CUDA kernel
itself is compared with this plain version on the GPU by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import elastic as JE
from hybrid_fem_lssvr_tpu.models import hybrid2d as JH2
from hybrid_fem_lssvr_tpu.ops import kkt as JK
from hybrid_fem_lssvr_tpu.ops import pallas_kernels as pk

from hybrid_fem_lssvr_tpu_torch.models import elastic as TE
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_elastic as KE
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

PROBLEMS = ["sin_elastic_2d", "poly_elastic_2d"]


def np_(t):
    return None if t is None else np.asarray(t)


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol)


def jax_arrays(nt):
    """The fields of a JAX NamedTuple as numpy arrays, for the converter."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()
            if v is not None}


def nodal_values(name, nx, ny, seed=0, dtype=np.float32):
    """[2, ny+1, nx+1]: the exact displacement on the nodes plus noise on
    the interior ones: what a coarse solve hands the enhancement."""
    p = JE.get_elastic_problem(name)
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(-1.0, 1.0, nx + 1),
                       np.linspace(-1.0, 1.0, ny + 1))
    u = np.stack([np.asarray(e(jnp.asarray(X), jnp.asarray(Y)))
                  for e in (p.exact1, p.exact2)])
    u[:, 1:-1, 1:-1] += 1e-3 * rng.normal(size=(2, ny - 1, nx - 1))
    return u.astype(dtype)


# ------------------------------------------------------- host operators

@pytest.mark.parametrize("hx,hy", [(0.25, 0.25), (0.125, 0.5), (2 / 3, 0.1)])
def test_q1_grad_mats_match_jax(hx, hy):
    for a, b in zip(TE._q1_grad_mats(hx, hy), JE._q1_grad_mats(hx, hy)):
        close(a, b, 1e-12)


@pytest.mark.parametrize("name", PROBLEMS)
def test_block_locals_match_jax(name):
    jp, tp = JE.get_elastic_problem(name), TE.get_elastic_problem(name)
    for a, b in zip(TE._block_locals(tp, 0.25, 0.125),
                    JE._block_locals(jp, 0.25, 0.125, jnp.float64)):
        close(a, b, 1e-12)


@pytest.mark.parametrize("nx,ny,M,C", [(16, 16, 6, 6), (8, 12, 4, 4),
                                       (5, 3, 5, 4)])
@pytest.mark.parametrize("name", PROBLEMS)
def test_block_colloc_and_precompute_match_jax(name, nx, ny, M, C):
    jp, tp = JE.get_elastic_problem(name), TE.get_elastic_problem(name)
    jcfg = JE.ElasticConfig2D(nx=nx, ny=ny, M=M, n_colloc=C)
    tcfg = TE.ElasticConfig2D(nx=nx, ny=ny, M=M, n_colloc=C)
    for a, b in zip(TE._block_colloc_host(tp, tcfg),
                    JE._block_colloc_host(jp, jcfg)):
        close(a, b, 1e-12, rtol=1e-12)
    tops, (t_int, bpts) = TE.prepare_shared_elastic(tp, tcfg)
    jops, (jt, jb) = JE.prepare_shared_elastic(jp, jcfg)
    close(t_int, jt, 1e-15)
    close(bpts, jb, 1e-15)
    assert tops.Wf.dtype == torch.float64
    for field in ("Wf", "Wbc", "D", "B", "Pres", "Qres", "cond"):
        close(getattr(tops, field), getattr(jops, field), 1e-12, rtol=1e-12)


# ------------------------------------------------------ coarse solve

@functools.lru_cache(maxsize=None)
def jax_fem(name, n, precond):
    """JAX's nodal values and CG iterations.  The V-cycle case is read from
    the whole solve of ``jax_solve`` (same config), so that JAX compiles its
    V-cycle once in this file."""
    if precond == "mg":
        sol = jax_solve(name, n, (("precond", "mg"),))
        return sol["fem_values"], int(sol["cg_iters"])
    cfg = JE.ElasticConfig2D(nx=n, ny=n, precond=precond)
    xs = jnp.linspace(-1.0, 1.0, n + 1)
    u, res = jax.jit(functools.partial(
        JE.fem_solve_elastic, JE.get_elastic_problem(name), cfg))(xs, xs)
    return np.asarray(u), int(res.iters)


@pytest.mark.parametrize("name,precond", [
    ("sin_elastic_2d", "jacobi"), ("poly_elastic_2d", "jacobi"),
    ("sin_elastic_2d", "mg")])
def test_fem_solve_elastic_matches_jax(name, precond):
    n = 16
    cfg = TE.ElasticConfig2D(nx=n, ny=n, precond=precond)
    xs = torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64)
    u, res = TE.fem_solve_elastic(TE.get_elastic_problem(name), cfg, xs, xs)
    want, iters = jax_fem(name, n, precond)
    assert u.shape == (2, n + 1, n + 1)
    close(u, want, 1e-10)
    assert abs(res.iters - iters) <= 1


def test_fem_solve_elastic_mg_needs_an_even_grid():
    cfg = TE.ElasticConfig2D(nx=7, ny=8, precond="mg")
    xs = torch.linspace(-1.0, 1.0, 8, dtype=torch.float64)
    ys = torch.linspace(-1.0, 1.0, 9, dtype=torch.float64)
    with pytest.raises(ValueError, match="even"):
        TE.fem_solve_elastic(TE.sin_elastic_2d(), cfg, xs, ys)


# --------------------------------------- the kernel's plain version

N, MK = 16, 4
GEOM = (-1.0, 2.0 / N, -1.0, 2.0 / N)


@pytest.fixture(scope="module")
def pallas_case():
    """JAX's Pallas kernel in interpret mode, once, on float32 nodal values
    of poly_elastic_2d (g on every edge)."""
    name = "poly_elastic_2d"
    jp = JE.get_elastic_problem(name)
    cfg = JE.ElasticConfig2D(nx=N, ny=N, M=MK, n_colloc=MK, dtype="float32")
    jops, (t_int, bpts) = JE.prepare_shared_elastic(jp, cfg)
    fem = nodal_values(name, N, N)
    out = pk.fused_enhance_elastic_2d(
        jnp.asarray(fem), jops, (jp.f1, jp.f2), (jp.g1, jp.g2), GEOM, N, N,
        t_int, bpts, tile=256, interpret=True)
    tops = convert.shared_operators_from_arrays(jax_arrays(jops))
    return dict(tp=TE.get_elastic_problem(name), tops=tops, fem=fem,
                t_int=np.asarray(t_int), bpts=np.asarray(bpts),
                pallas=[np_(v) for v in out])


def plain(c, diag=True, fem=None):
    tp = c["tp"]
    f = torch.from_numpy(c["fem"] if fem is None else fem)
    return KE.fused_enhance_elastic_2d_ref(
        f, c["tops"], (tp.f1, tp.f2), (tp.g1, tp.g2), GEOM, N, N, c["t_int"],
        c["bpts"], with_diagnostics=diag)


@pytest.mark.parametrize("entry", ["wrapper", "ref"])
def test_plain_kernel_matches_pallas(pallas_case, entry):
    """w, slack and bcv at test_pallas.py's tolerances; on CPU tensors the
    wrapper is the plain version."""
    c = pallas_case
    tp = c["tp"]
    fn = (KE.fused_enhance_elastic_2d if entry == "wrapper"
          else KE.fused_enhance_elastic_2d_ref)
    before = KE.launch_counts()["fused_enhance_elastic_2d"]
    w, slack, bcv = fn(torch.from_numpy(c["fem"]), c["tops"],
                       (tp.f1, tp.f2), (tp.g1, tp.g2), GEOM, N, N,
                       c["t_int"], c["bpts"])
    assert KE.launch_counts()["fused_enhance_elastic_2d"] == before
    assert w.shape == (N * N, 2 * MK * MK) and w.dtype == torch.float32
    pw, pslack, pbcv = c["pallas"]
    close(w, pw, 3e-5)
    close(slack, pslack, 2e-4, rtol=5e-4)
    close(bcv, pbcv, 2e-5, rtol=5e-4)


def test_plain_kernel_without_diagnostics(pallas_case):
    w, slack, bcv = plain(pallas_case, diag=False)
    assert slack is None and bcv is None
    close(w, pallas_case["pallas"][0], 3e-5)


def test_plain_kernel_rhs_part(pallas_case):
    """On zero nodal values and zero g, w is the rhs part alone: the same
    map as JAX's Wf applied to the sampled body force."""
    c = pallas_case
    tp = dataclasses.replace(c["tp"], g1=TE._zero, g2=TE._zero)
    zero = torch.zeros(2, N + 1, N + 1, dtype=torch.float32)
    w = KE.fused_enhance_elastic_2d_ref(
        zero, c["tops"], (tp.f1, tp.f2), (tp.g1, tp.g2), GEOM, N, N,
        c["t_int"], c["bpts"])[0]
    f, _, _ = KE._inputs(zero, (tp.f1, tp.f2), (tp.g1, tp.g2), GEOM, N, N,
                         c["t_int"], c["bpts"])
    want = (c["tops"].Wf.double() @ f.double()).T
    assert float(want.abs().max()) > 1e-3
    close(w, want, 1e-6)


def test_plain_kernel_ragged_mesh_matches_xla():
    """5 x 3 quads (E = 15 < 128, which the reference's tile rule rejects)
    against JAX's XLA route: its element data and solve_primal_shared."""
    name, nx, ny, M = "poly_elastic_2d", 5, 3, 5
    jp, tp = JE.get_elastic_problem(name), TE.get_elastic_problem(name)
    jcfg = JE.ElasticConfig2D(nx=nx, ny=ny, M=M, n_colloc=M,
                              dtype="float32")
    jops, (t_int, bpts) = JE.prepare_shared_elastic(jp, jcfg)
    fem = nodal_values(name, nx, ny, seed=3)

    @jax.jit
    def xla_route(fem):
        xs = jnp.linspace(-1, 1, nx + 1, dtype=jnp.float32)
        ys = jnp.linspace(-1, 1, ny + 1, dtype=jnp.float32)
        rows, traces = [], []
        for comp in range(2):
            f_rows, bc_rows, _ = JH2._element_data_2d(
                JE._component_problem(jp, comp), jcfg, xs, ys, fem[comp],
                t_int, bpts)
            rows.append(f_rows)
            traces.append(bc_rows)
        return JK.solve_primal_shared(jops, jnp.concatenate(rows, axis=1),
                                      jnp.concatenate(traces, axis=1))

    w_x, d_x = xla_route(jnp.asarray(fem))
    tops = convert.shared_operators_from_arrays(jax_arrays(jops))
    w, slack, bcv = KE.fused_enhance_elastic_2d(
        torch.from_numpy(fem), tops, (tp.f1, tp.f2), (tp.g1, tp.g2),
        (-1.0, 2.0 / nx, -1.0, 2.0 / ny), nx, ny, t_int, bpts)
    close(w, w_x, 3e-5)
    close(bcv, d_x.bc_violation, 2e-5, rtol=5e-4)
    close(slack, d_x.max_slack, 2e-4, rtol=5e-4)


def test_wrapper_rejects_a_wrong_grid(pallas_case):
    c = pallas_case
    with pytest.raises(ValueError, match="nodal grids"):
        plain(c, fem=c["fem"][0])


# ------------------------------------------------------- whole solves

@functools.lru_cache(maxsize=None)
def jax_solve(name, n, kw):
    """JAX's ``hybrid_solve_elastic`` in float64, its solution's arrays as
    numpy (lam and mu too)."""
    p = JE.get_elastic_problem(name)
    cfg = JE.ElasticConfig2D(nx=n, ny=n, **dict(kw))
    sol = jax.jit(functools.partial(JE.hybrid_solve_elastic, p, cfg,
                                    JE.prepare_shared_elastic(p, cfg)))()
    return {k: np_(v) for k, v in sol._asdict().items()}


@jax.jit
def jax_readouts(sol, x, y):
    """JAX's displacement, raw stress and recovered stress at (x, y)."""
    return (JE.evaluate_elastic_2d(sol, x, y),
            JE.evaluate_stress_2d(sol, x, y),
            JE.recover_stress_2d(sol, x, y))


# One V-cycle solve; the others reuse the Jacobi solves JAX has compiled
# above (the richardson fine grid is 16 x 16).
SOLVES = [
    ("sin_elastic_2d", 16, (("precond", "mg"),)),
    ("poly_elastic_2d", 16, (("precond", "jacobi"),)),
    ("sin_elastic_2d", 8, (("precond", "jacobi"), ("coarse", "richardson"),
                           ("trace_lift", 6))),
]


@functools.lru_cache(maxsize=None)
def torch_solve(name, n, kw):
    s = TE.ElasticSolver2D(TE.get_elastic_problem(name),
                           TE.ElasticConfig2D(nx=n, ny=n, **dict(kw)),
                           device="cpu")
    s.solve()
    return s


@pytest.mark.parametrize("name,n,kw", SOLVES)
def test_solver_matches_jax(name, n, kw):
    s = torch_solve(name, n, kw)
    sol = s.solution
    want = jax_solve(name, n, kw)
    assert sol.coeffs.shape == (2, n, n, 6, 6)
    assert bool(sol.solve_ok.all()) and bool(want["solve_ok"].all())
    close(sol.fem_values, want["fem_values"], 1e-10)
    close(sol.coeffs, want["coeffs"], 1e-9)
    close(sol.bc_violation, want["bc_violation"], 1e-9)
    close(sol.max_slack, want["max_slack"], 1e-7, rtol=1e-7)
    assert abs(sol.cg_iters - int(want["cg_iters"])) <= 1
    close(sol.cond_estimate, want["cond_estimate"], 0, rtol=1e-10)


@pytest.mark.parametrize("name,n,kw", SOLVES[:1])
def test_evaluation_and_stress_match_jax(name, n, kw):
    s = torch_solve(name, n, kw)
    want = jax_solve(name, n, kw)
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-1.0, 1.0, (2, 300))
    jsol = JE.ElasticSolution2D(**{k: jnp.asarray(v)
                                   for k, v in want.items()})
    u, raw, rec = jax_readouts(jsol, jnp.asarray(x), jnp.asarray(y))
    for got, want_ in ((s.evaluate_solution(x, y), u),
                       (s.evaluate_stress(x, y), raw),
                       (s.evaluate_stress(x, y, recover=True), rec)):
        assert len(got) == len(want_)
        for a, b in zip(got, want_):
            scale = max(1.0, float(np.abs(np_(b)).max()))
            close(a, b, 1e-9 * scale)
    exact = s.problem.exact1(*(torch.from_numpy(v) for v in (x, y)))
    linf = float(np.abs(np_(u[0]) - exact.numpy()).max())
    assert abs(float(s.errors(x, y)[0]) - max(
        linf, float(np.abs(np_(u[1]) - s.problem.exact2(
            torch.from_numpy(x), torch.from_numpy(y)).numpy()).max()))) < 1e-10


def test_richardson_raises_the_order():
    """(4 u_{h/2} - u_h)/3 with the lifted trace: the error of sin_elastic_2d
    at 16x16 falls far below the plain Q1 solve's (JAX: 3.1e-4 against
    3.2e-2)."""
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-1.0, 1.0, (2, 400))
    plain_q1 = torch_solve("sin_elastic_2d", 16, (("precond", "jacobi"),))
    rich = torch_solve("sin_elastic_2d", 16, SOLVES[2][2])
    assert float(rich.errors(x, y)[0]) < 0.1 * float(plain_q1.errors(x, y)[0])


def test_converted_jax_bundle_gives_the_same_enhancement():
    name, n = "poly_elastic_2d", 8
    jcfg = JE.ElasticConfig2D(nx=n, ny=n, M=5, n_colloc=5)
    jops, (t_int, bpts) = JE.prepare_shared_elastic(
        JE.get_elastic_problem(name), jcfg)
    conv = convert.elastic_bundle_from_arrays(
        jax_arrays(jops), np.asarray(t_int), np.asarray(bpts),
        dtype=torch.float64)
    tp = TE.get_elastic_problem(name)
    cfg = TE.ElasticConfig2D(nx=n, ny=n, M=5, n_colloc=5)
    own = TE.prepare_shared_elastic(tp, cfg)
    xs = torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64)
    fem = torch.from_numpy(nodal_values(name, n, n, dtype=np.float64))
    a = TE.enhance_elastic(tp, cfg, xs, xs, fem, conv)
    b = TE.enhance_elastic(tp, cfg, xs, xs, fem, own)
    close(a[0], b[0], 1e-12)
    close(a[1].bc_violation, b[1].bc_violation, 1e-12)
    assert a[0].shape == (2, n, n, 5, 5)


def test_backend_cuda_on_cpu_tensors_raises():
    cfg = TE.ElasticConfig2D(nx=8, ny=8, precond="jacobi", backend="cuda")
    s = TE.ElasticSolver2D(TE.sin_elastic_2d(), cfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        s.solve()
    # a lifted trace forces the torch route whatever the backend says
    lifted = dataclasses.replace(cfg, coarse="richardson", trace_lift=6)
    assert TE._resolve_backend(lifted, "cpu") == "torch"
    assert TE._resolve_backend(dataclasses.replace(cfg, backend="auto"),
                               "cpu") == "torch"


@pytest.mark.parametrize("kw,match", [
    (dict(precond="ilu"), "precond"), (dict(coarse="compact"), "coarse"),
    (dict(trace_lift=1), "trace_lift"), (dict(backend="pallas"), "backend")])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        TE.ElasticConfig2D(**kw)


def test_default_dtype_and_device_rule():
    assert TE.ElasticConfig2D().torch_dtype() == torch.float64
    assert TE.ElasticConfig2D(dtype="float32").torch_dtype() == torch.float32
    with pytest.raises(KeyError, match="unknown elastic problem"):
        TE.get_elastic_problem("beam")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.ElasticSolver2D(TE.sin_elastic_2d())
