"""The port's fused 2D kernels' plain versions against JAX's Pallas kernels.

The JAX kernels run in interpret mode on the CPU (16 x 16 quads, M = C = 5,
tile = 256), as ``tests/test_pallas.py`` runs them, and the port's wrappers,
given CPU tensors, run their plain versions on the same float32 nodal
values (made with numpy from a seed).  Tolerances are ``test_pallas.py``'s:
stacked w 2e-5, bcv 1e-5, slack ratio in (0.05, 20) (``:239-271``); shared
w and bcv 1e-5 (``:75-98``); per-element w 3e-5, bcv 1e-5, slack ratio in
(0.2, 5) (``:308-346``).  A ragged mesh (nx = 5, ny = 3), which the Pallas
tile rule cannot run, is held against JAX's XLA route.  The CUDA kernels
themselves are compared with these plain versions on the GPU by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import hybrid2d as JH2
from hybrid_fem_lssvr_tpu.ops import kkt as JK
from hybrid_fem_lssvr_tpu.ops import pallas_kernels as pk

from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

N, M, C = 16, 5, 5
GEOM = (-1.0, 2.0 / N, -1.0, 2.0 / N)
S2 = 2.0 * float(N) ** 2  # sx^2 + sy^2 at hx = hy = 2/16


def np_(t):
    return None if t is None else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=atol)


def nodal_values(problem, nx, ny, seed=0):
    """The exact solution on the nodes plus noise on the interior ones,
    float32: what a coarse solve hands the enhancement."""
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(-1.0, 1.0, nx + 1),
                       np.linspace(-1.0, 1.0, ny + 1))
    u = np.asarray(problem.exact(jnp.asarray(X), jnp.asarray(Y)))
    u = u.copy()
    u[1:-1, 1:-1] += 1e-3 * rng.normal(size=(ny - 1, nx - 1))
    return u.astype(np.float32)


def bundles(name, nx=N, ny=N, **kw):
    """(JAX problem, port problem, JAX bundle, the port's copy of it through
    the converter, t_int, bpts), float32."""
    cfg = dict(nx=nx, ny=ny, M=M, n_colloc=C, dtype="float32", **kw)
    jp, tp = JH2.get_problem_2d(name), H2.get_problem_2d(name)
    jops, (t_int, bpts) = JH2.prepare_shared_2d(jp, JH2.Solver2DConfig(**cfg))
    arrays = {k: (v if isinstance(v, (int, float)) else np.asarray(v))
              for k, v in jops._asdict().items() if v is not None}
    conv = (convert.varcoeff2d_operators_from_arrays
            if jp.a_var is not None
            else convert.shared_operators_from_arrays)
    return jp, tp, jops, conv(arrays), np.asarray(t_int), np.asarray(bpts)


@pytest.fixture(scope="module", params=["poisson_2d",
                                        "poisson_2d_inhomogeneous"])
def shared_case(request):
    jp, tp, jops, tops, t_int, bpts = bundles(request.param)
    fem = nodal_values(jp, N, N)
    xs = jnp.linspace(-1, 1, N + 1, dtype=jnp.float32)
    f_rows, bc_rows, _ = JH2._element_data_2d(
        jp, JH2.Solver2DConfig(nx=N, ny=N, M=M, n_colloc=C, dtype="float32"),
        xs, xs, jnp.asarray(fem), t_int, bpts)
    w_xla, d_xla = JK.solve_primal_shared(jops, f_rows, bc_rows)
    pallas = {
        kern: getattr(pk, kern)(jnp.asarray(fem), jops, jp.f, jp.g, GEOM, N,
                                N, t_int, bpts, tile=256, interpret=True,
                                f_shifted_fn=jp.f_shifted)
        for kern in ("fused_enhance_stacked_2d", "fused_enhance_shared_2d")
    }
    return dict(jp=jp, tp=tp, tops=tops, fem=fem, t_int=t_int, bpts=bpts,
                pallas=pallas, xla=(w_xla, d_xla))


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("kern", ["fused_enhance_stacked_2d",
                                  "fused_enhance_shared_2d"])
def test_shared_kernels_match_pallas(shared_case, kern, shifted, diag):
    c = shared_case
    tp = c["tp"]
    got = getattr(K2, kern)(
        torch.from_numpy(c["fem"]), c["tops"], tp.f, tp.g, GEOM, N, N,
        c["t_int"], c["bpts"], with_diagnostics=diag,
        f_shifted_fn=tp.f_shifted if shifted else None)
    want = c["pallas"][kern]
    w_tol = 2e-5 if "stacked" in kern else 1e-5
    assert tuple(got[0].shape) == (N * N, M * M)
    close(got[0], want[0], w_tol)
    close(got[0], c["xla"][0], w_tol)
    if not diag:
        assert got[1] is None and got[2] is None
        return
    close(got[2], want[2], 1e-5)
    close(got[2], c["xla"][1].bc_violation, 1e-5)
    r = float(got[1].max()) / max(float(jnp.max(want[1])), 1e-30)
    assert 0.05 < r < 20.0, r
    r = float(got[1].max()) / max(float(jnp.max(c["xla"][1].max_slack)),
                                  1e-30)
    assert 0.05 < r < 20.0, r


def test_stacked_needs_residual_operators(shared_case):
    c = shared_case
    tp = c["tp"]
    bare = dataclasses.replace(c["tops"], Pres=None)
    with pytest.raises(ValueError, match="residual operators"):
        K2.fused_enhance_stacked_2d(torch.from_numpy(c["fem"]), bare, tp.f,
                                    tp.g, GEOM, N, N, c["t_int"], c["bpts"])
    with pytest.raises(ValueError, match="nodal grid"):
        K2.fused_enhance_shared_2d(torch.from_numpy(c["fem"][:-1]),
                                   c["tops"], tp.f, tp.g, GEOM, N, N,
                                   c["t_int"], c["bpts"])


@pytest.fixture(scope="module")
def varcoeff_case():
    jp, tp, jops, tops, t_int, bpts = bundles("variable_coeff_elliptic_2d")
    fem = nodal_values(jp, N, N, seed=1)
    cfg = JH2.Solver2DConfig(nx=N, ny=N, M=M, n_colloc=C, dtype="float32")
    xs = jnp.linspace(-1, 1, N + 1, dtype=jnp.float32)
    f_rows, bc_rows, _ = JH2._element_data_2d(jp, cfg, xs, xs,
                                              jnp.asarray(fem), t_int, bpts)
    D = JH2._varcoeff_element_operators(jp, cfg, xs, xs, jops, t_int)
    xla = JK.solve_batched(D, jops.B, f_rows, bc_rows, cfg.gamma,
                           ZP=(jops.Z, jops.Pbc))
    pallas = {
        method: pk.fused_enhance_varcoeff_2d(
            jnp.asarray(fem), jops, jp.a_var, jp.grad_a, jp.f, jp.g, GEOM, N,
            N, t_int, bpts, s2=S2, tile=256, interpret=True,
            f_shifted_fn=jp.f_shifted, method=method)
        for method in ("qr", "sne")
    }
    return dict(jp=jp, tp=tp, tops=tops, fem=fem, t_int=t_int, bpts=bpts,
                pallas=pallas, xla=xla)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("method", ["qr", "sne"])
def test_varcoeff_kernel_matches_pallas(varcoeff_case, method, shifted, diag):
    c = varcoeff_case
    tp = c["tp"]
    got = K2.fused_enhance_varcoeff_2d(
        torch.from_numpy(c["fem"]), c["tops"], tp.a_var, tp.grad_a, tp.f,
        tp.g, GEOM, N, N, c["t_int"], c["bpts"], s2=S2,
        with_diagnostics=diag, method=method,
        f_shifted_fn=tp.f_shifted if shifted else None)
    want = c["pallas"][method]
    w_xla, d_xla = c["xla"]
    assert tuple(got[0].shape) == (N * N, M * M)
    close(got[0], want[0], 3e-5)
    close(got[0], w_xla, 3e-5)
    if not diag:
        assert got[1] is None and got[2] is None
        return
    close(got[2], want[2], 1e-5)
    close(got[2], d_xla.bc_violation, 1e-5)
    for ref in (jnp.max(want[1]), jnp.max(d_xla.max_slack)):
        r = float(got[1].max()) / max(float(ref), 1e-30)
        assert 0.2 < r < 5.0, (method, r)


def test_varcoeff_kernel_argument_checks(varcoeff_case):
    c = varcoeff_case
    tp = c["tp"]
    args = (torch.from_numpy(c["fem"]), c["tops"], tp.a_var)
    rest = (tp.f, tp.g, GEOM, N, N, c["t_int"], c["bpts"])
    with pytest.raises(ValueError, match="analytic grad_a"):
        K2.fused_enhance_varcoeff_2d(*args, None, *rest, s2=S2)
    with pytest.raises(ValueError, match="unknown method"):
        K2.fused_enhance_varcoeff_2d(*args, tp.grad_a, *rest, s2=S2,
                                     method="lu")
    bare = dataclasses.replace(c["tops"], AZ=None)
    with pytest.raises(ValueError, match="AZ/AP"):
        K2.fused_enhance_varcoeff_2d(args[0], bare, tp.a_var, tp.grad_a,
                                     *rest, s2=S2)


@pytest.mark.parametrize("name", ["poisson_2d_inhomogeneous",
                                  "variable_coeff_elliptic_2d"])
def test_ragged_mesh_matches_jax_xla_route(name):
    """nx = 5, ny = 3: no multiple of a TPU tile, so the reference is JAX's
    batched XLA route on ``_element_data_2d``."""
    nx, ny = 5, 3
    jp, tp, jops, tops, t_int, bpts = bundles(name, nx=nx, ny=ny)
    fem = nodal_values(jp, nx, ny, seed=2)
    cfg = JH2.Solver2DConfig(nx=nx, ny=ny, M=M, n_colloc=C, dtype="float32")
    xs = jnp.linspace(-1, 1, nx + 1, dtype=jnp.float32)
    ys = jnp.linspace(-1, 1, ny + 1, dtype=jnp.float32)
    f_rows, bc_rows, _ = JH2._element_data_2d(jp, cfg, xs, ys,
                                              jnp.asarray(fem), t_int, bpts)
    geom = (-1.0, 2.0 / nx, -1.0, 2.0 / ny)
    tfem = torch.from_numpy(fem)
    if jp.a_var is None:
        w_ref, d_ref = JK.solve_primal_shared(jops, f_rows, bc_rows)
        outs = [fn(tfem, tops, tp.f, tp.g, geom, nx, ny, t_int, bpts)
                for fn in (K2.fused_enhance_stacked_2d,
                           K2.fused_enhance_shared_2d,
                           K2.fused_enhance_shared_2d_ref)]
    else:
        D = JH2._varcoeff_element_operators(jp, cfg, xs, ys, jops, t_int)
        w_ref, d_ref = JK.solve_batched(D, jops.B, f_rows, bc_rows,
                                        cfg.gamma, ZP=(jops.Z, jops.Pbc))
        s2 = (2.0 / geom[1]) ** 2 + (2.0 / geom[3]) ** 2
        outs = [K2.fused_enhance_varcoeff_2d(
            tfem, tops, tp.a_var, tp.grad_a, tp.f, tp.g, geom, nx, ny, t_int,
            bpts, s2=s2, method=m) for m in K2.METHODS]
    for w, slack, bcv in outs:
        assert tuple(w.shape) == (nx * ny, M * M)
        close(w, w_ref, 3e-5)
        close(bcv, d_ref.bc_violation, 1e-5)
        assert bool(torch.isfinite(slack).all())


def test_trace_rows_match_jax_element_data(shared_case):
    """The wrappers' boundary trace (corner gather, bilinear trace, g from
    the four edge samples) equals JAX's ``_element_data_2d`` rows; so does
    the sampled rhs."""
    c = shared_case
    jp, tp = c["jp"], c["tp"]
    xs = jnp.linspace(-1, 1, N + 1, dtype=jnp.float32)
    f_rows, bc_rows, _ = JH2._element_data_2d(
        jp, JH2.Solver2DConfig(nx=N, ny=N, M=M, n_colloc=C, dtype="float32"),
        xs, xs, jnp.asarray(c["fem"]), c["t_int"], c["bpts"])
    tfem = torch.from_numpy(c["fem"])
    f, gedge, pts, _ = K2._shared_inputs(tfem, tp.f, tp.g, GEOM, N, N,
                                         c["t_int"], c["bpts"], None)
    assert tuple(gedge.shape) == (4, 4 * M - 4, N)
    close(K2._trace_bc(tfem, gedge, pts, N, N).T, bc_rows, 2e-6)
    close(f.T, f_rows, 2e-5)


def test_nan_nodal_value_fails_only_its_quads():
    """A NaN nodal value poisons the four quads around it (NaN diagnostics,
    gate false, bilinear fallback) and no other."""
    tp = H2.get_problem_2d("poisson_2d")
    cfg = H2.Solver2DConfig(nx=8, ny=8, M=M, n_colloc=C, dtype="float32")
    bundle = H2.prepare_shared_2d(tp, cfg)
    fem = nodal_values(JH2.get_problem_2d("poisson_2d"), 8, 8)
    fem[3, 5] = np.nan
    geom = (-1.0, 0.25, -1.0, 0.25)
    for fn in (K2.fused_enhance_stacked_2d, K2.fused_enhance_shared_2d):
        w, slack, bcv = fn(torch.from_numpy(fem), bundle[0], tp.f, tp.g,
                           geom, 8, 8, *bundle[1])
        bad = torch.nonzero(~torch.isfinite(bcv)).flatten().tolist()
        assert bad == [2 * 8 + 4, 2 * 8 + 5, 3 * 8 + 4, 3 * 8 + 5]
        assert torch.isfinite(slack).sum() == 60
    t = torch.from_numpy(fem)
    ok = H2._kernel_solve_ok(slack, bcv, (t[:-1, :-1], t[:-1, 1:],
                                          t[1:, :-1], t[1:, 1:]))
    assert int((~ok).sum()) == 4


def test_routing_and_shape_checks():
    """On the CPU 'auto' resolves to torch and 'cuda' is refused; the check
    that guards the CUDA launches refuses CPU tensors, float64 and an
    (M, C) that was not compiled."""
    p = H2.get_problem_2d("poisson_2d")
    vc = H2.get_problem_2d("variable_coeff_elliptic_2d")
    f32 = H2.Solver2DConfig(dtype="float32")
    assert H2._resolve_backend(p, f32, "cpu") == "torch"
    assert H2._resolve_backend(p, f32, "cuda") == "cuda"
    assert H2._resolve_backend(p, H2.Solver2DConfig(), "cuda") == "torch"
    assert H2._resolve_backend(vc, f32, "cuda") == "cuda"
    no_grad = dataclasses.replace(vc, grad_a=None)
    assert H2._resolve_backend(no_grad, f32, "cuda") == "torch"
    assert H2._resolve_backend(p, f32, "cuda", forced_torch=True) == "torch"
    cuda_cfg = H2.Solver2DConfig(dtype="float32", backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda'"):
        H2._resolve_backend(p, cuda_cfg, "cpu")
    with pytest.raises(ValueError, match="backend='cuda'"):
        H2.HybridSolver2D(p, dataclasses.replace(cuda_cfg, nx=4, ny=4),
                          device="cpu").solve()
    with pytest.raises(ValueError, match="unknown backend"):
        H2.Solver2DConfig(backend="xla")
    with pytest.raises(ValueError, match="varcoeff_method"):
        H2.Solver2DConfig(varcoeff_method="lu")
    x = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K2.check_kernel_inputs("k", x, 6, 6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K2._stacked_cuda(x, None, None, None,
                         H2.prepare_shared_2d(p, f32)[0], 4, 4, True)
    K2.check_shape("k", 6, 6)
    with pytest.raises(ValueError, match="no CUDA kernel compiled for M=7"):
        K2.check_shape("k", 7, 7)
    assert K2.launch_counts() == {"fused_enhance_stacked_2d": 0,
                                  "fused_enhance_shared_2d": 0,
                                  "fused_enhance_varcoeff_2d": 0}


def test_compiled_shapes_agree_with_the_cuda_sources():
    """``kernels2d.SHAPES`` is the list both 2D sources compile: the one
    ``ENH2D_SHAPES`` of the header they share."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(K2.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "enhance_common.cuh")) as fh:
        line = re.search(r"#define ENH2D_SHAPES\(X\)(.*)", fh.read())
    shapes = tuple((int(m), int(c)) for m, c in
                   re.findall(r"X\((\d+), (\d+)\)", line.group(1)))
    assert shapes == K2.SHAPES
    for name in ("enhance2d.cu", "enhance2d_varcoeff.cu"):
        with open(os.path.join(csrc, name)) as fh:
            text = fh.read()
        assert '#include "enhance_common.cuh"' in text, name
        assert "#define ENH2D_SHAPES" not in text, name
        assert "ENH2D_SHAPES(X)" in text, name


def test_statics_are_packed_once_per_bundle():
    """The flat operator buffer of a kernel is reused while the same
    operator tensors come again, and rebuilt after an in-place edit or for
    another bundle; small host arrays are uploaded once per content."""
    cpu = torch.device("cpu")
    A, B = torch.arange(6.0).reshape(2, 3), torch.ones(2, dtype=torch.float64)
    first = K2._statics("k", cpu, (A, B))
    assert first.dtype == torch.float32
    assert first.tolist() == [0, 1, 2, 3, 4, 5, 1, 1]
    assert K2._statics("k", cpu, (A, B)) is first
    A[0, 0] = 7.0
    second = K2._statics("k", cpu, (A, B))
    assert second is not first and second[0] == 7.0
    assert K2._statics("k", cpu, (A.clone(), B)) is not second
    swapped = K2._statics("k2", cpu, (A, B), pack=lambda a, b: (b, a.T))
    assert swapped.tolist() == [1, 1, 7, 3, 1, 4, 2, 5]
    pts = np.array([[0.5, -1.0], [1.0, 0.25]])
    t = K2._const(pts, torch.float32, "cpu")
    assert K2._const(pts.copy(), torch.float32, cpu) is t
    assert K2._const(2 * pts, torch.float32, "cpu") is not t
    assert torch.equal(K2._trace_points(pts, torch.float64, "cpu")[4:],
                       torch.tensor([[1., 0.], [0., 0.], [0., 0.], [0., 1.]],
                                    dtype=torch.float64))


def test_ptxas_summary_reads_template_arguments(monkeypatch):
    """Registers, stack frame and spills per kernel instantiation from nvcc's
    ``-Xptxas -v`` output, named through the toolkit's demangler; without
    one the rows keep the mangled names."""
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    log = (
        "ptxas info    : Compiling entry function '_ZN3abc16stacked2d_kernel"
        "ILi6ELi6ELb1EEEvPKf' for 'sm_90a'\n"
        "ptxas info    : Used 160 registers, 0 bytes spill stores, 0 bytes "
        "spill loads\n"
        "ptxas info    : Compiling entry function '_ZN3abc21varcoeff2d_sne_"
        "kernelILi5ELi5EEEvPKf' for 'sm_90a'\n"
        "    24 bytes stack frame, 24 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers\n")
    names = ["void abc::stacked2d_kernel<(int)6, (int)6, (bool)1>(const "
             "float *)", "void abc::varcoeff2d_sne_kernel<5, 5>(float *)"]
    monkeypatch.setattr(cuda_lib, "_demangle", lambda mangled: names)
    a, b = cuda_lib.ptxas_summary(log)
    assert a == dict(kernel="stacked2d_kernel", M=6, C=6, params=[6, 6, 1],
                     registers=160, spill_stores=0, spill_loads=0)
    assert b == dict(kernel="varcoeff2d_sne_kernel", M=5, C=5, params=[5, 5],
                     registers=255, stack_frame=24, spill_stores=24,
                     spill_loads=12)
    monkeypatch.setattr(cuda_lib, "_demangle", list)
    raw = cuda_lib.ptxas_summary(log)[0]
    assert raw["kernel"].startswith("_ZN3abc") and raw["M"] is None
    assert raw["registers"] == 160
