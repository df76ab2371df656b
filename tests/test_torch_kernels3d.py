"""The port's fused 3D kernel's plain version against JAX's Pallas kernel.

``fused_enhance_stacked_3d`` of the JAX package runs once in interpret mode
on the CPU (4 x 4 x 8 hexes, M = C = 4, tile = 128, as
``tests/test_pallas.py:274`` runs it), held in a module-scoped fixture; the
port's wrapper, given CPU tensors, runs its plain version on the same
float32 nodal values (made with numpy from a seed).  The other cases are
held against JAX's XLA route (``_element_data_3d`` then
``kkt.solve_primal_shared``).  Tolerances are ``test_pallas.py``'s: w 2e-5,
bcv 1e-5, slack ratio in (0.05, 20).  The CUDA kernel itself is compared
with this plain version on the GPU by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybrid_fem_lssvr_tpu.models import hybrid3d as JH3
from hybrid_fem_lssvr_tpu.ops import kkt as JK
from hybrid_fem_lssvr_tpu.ops import pallas_kernels as pk

from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

NX, NY, NZ = 4, 4, 8
GEOM = (-1.0, 2.0 / NX, -1.0, 2.0 / NY, -1.0, 2.0 / NZ)
PROBLEMS = ["poisson_3d", "poisson_3d_inhomogeneous"]


def np_(t):
    return None if t is None else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=atol)


def nodal_values(problem, nx, ny, nz, seed=0):
    """The exact solution on the nodes plus noise on the interior ones,
    float32: what a coarse solve hands the enhancement."""
    rng = np.random.default_rng(seed)
    Z, Y, X = np.meshgrid(np.linspace(-1.0, 1.0, nz + 1),
                          np.linspace(-1.0, 1.0, ny + 1),
                          np.linspace(-1.0, 1.0, nx + 1), indexing="ij")
    u = np.array(problem.exact(jnp.asarray(X), jnp.asarray(Y),
                               jnp.asarray(Z)))
    u[1:-1, 1:-1, 1:-1] += 1e-3 * rng.normal(size=(nz - 1, ny - 1, nx - 1))
    return u.astype(np.float32)


def case(name, nx=NX, ny=NY, nz=NZ, seed=0):
    """JAX problem and float32 bundle, the port's problem and its copy of
    the bundle through the converter, nodal values, points, and JAX's XLA
    route on them."""
    cfg = JH3.Solver3DConfig(nx=nx, ny=ny, nz=nz, M=4, n_colloc=4,
                             dtype="float32")
    jp, tp = JH3.get_problem_3d(name), H3.get_problem_3d(name)
    jops, (t_int, spts) = JH3.prepare_shared_3d(jp, cfg)
    tops = convert.shared_operators_from_arrays(
        {k: np.asarray(v) for k, v in jops._asdict().items()
         if v is not None})
    fem = nodal_values(jp, nx, ny, nz, seed)
    axes = [jnp.linspace(-1, 1, n + 1, dtype=jnp.float32)
            for n in (nx, ny, nz)]
    f_rows, bc_rows, _ = JH3._element_data_3d(jp, cfg, *axes,
                                              jnp.asarray(fem), t_int, spts)
    xla = JK.solve_primal_shared(jops, f_rows, bc_rows)
    return dict(jp=jp, tp=tp, jops=jops, tops=tops, fem=fem,
                t_int=np.asarray(t_int), spts=np.asarray(spts), xla=xla,
                rows=(f_rows, bc_rows), cfg=cfg)


@pytest.fixture(scope="module", params=PROBLEMS)
def shared_case(request):
    return case(request.param)


@pytest.fixture(scope="module")
def pallas_run():
    """The one interpret-mode run of JAX's kernel: the inhomogeneous
    problem (g nonzero on every face) through its structured rhs."""
    c = case("poisson_3d_inhomogeneous")
    jp = c["jp"]
    out = pk.fused_enhance_stacked_3d(
        jnp.asarray(c["fem"]), c["jops"], jp.f, jp.g, GEOM, NX, NY, NZ,
        c["t_int"], c["spts"], tile=128, interpret=True,
        f_shifted_fn=jp.f_shifted)
    return c, out


def run(c, fem=None, nx=NX, ny=NY, nz=NZ, geom=GEOM, **kw):
    tp = c["tp"]
    fem = c["fem"] if fem is None else fem
    return K3.fused_enhance_stacked_3d(
        torch.from_numpy(fem), c["tops"], tp.f, tp.g, geom, nx, ny, nz,
        c["t_int"], c["spts"], **kw)


def assert_matches(got, w, bcv, slack, w_tol=2e-5):
    close(got[0], w, w_tol)
    close(got[2], bcv, 1e-5)
    r = float(got[1].max()) / max(float(np.max(np_(slack))), 1e-30)
    assert 0.05 < r < 20.0, r


@pytest.mark.parametrize("shifted", [True, False])
def test_stacked_3d_matches_pallas(pallas_run, shifted):
    c, (w, slack, bcv) = pallas_run
    got = run(c, f_shifted_fn=c["tp"].f_shifted if shifted else None)
    assert tuple(got[0].shape) == (NX * NY * NZ, 64)
    assert_matches(got, w, bcv, slack)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("shifted", [True, False])
def test_stacked_3d_matches_xla_route(shared_case, shifted, diag):
    c = shared_case
    got = run(c, with_diagnostics=diag,
              f_shifted_fn=c["tp"].f_shifted if shifted else None)
    w_xla, d_xla = c["xla"]
    if not diag:
        close(got[0], w_xla, 2e-5)
        assert got[1] is None and got[2] is None
        return
    assert_matches(got, w_xla, d_xla.bc_violation, d_xla.max_slack)
    # The wrapper against its own plain version: the same function.
    ref = K3.fused_enhance_stacked_3d_ref(
        torch.from_numpy(c["fem"]), c["tops"], c["tp"].f, c["tp"].g, GEOM,
        NX, NY, NZ, c["t_int"], c["spts"],
        f_shifted_fn=c["tp"].f_shifted if shifted else None)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_ragged_mesh_matches_the_torch_route():
    """nx, ny, nz = 3, 5, 2: no multiple of a TPU tile, so the reference is
    the port's own torch route (``enhance_3d`` on the CPU), which
    ``tests/test_torch_hybrid3d.py`` holds against JAX."""
    nx, ny, nz = 3, 5, 2
    tp = H3.get_problem_3d("poisson_3d_inhomogeneous")
    cfg = H3.Solver3DConfig(nx=nx, ny=ny, nz=nz, dtype="float32",
                            backend="torch")
    ops, (t_int, spts) = H3.prepare_shared_3d(tp, cfg)
    fem = nodal_values(JH3.get_problem_3d("poisson_3d_inhomogeneous"), nx,
                       ny, nz, seed=2)
    geom = (-1.0, 2.0 / nx, -1.0, 2.0 / ny, -1.0, 2.0 / nz)
    tfem = torch.from_numpy(fem)
    got = K3.fused_enhance_stacked_3d(tfem, ops, tp.f, tp.g, geom, nx, ny,
                                      nz, t_int, spts,
                                      f_shifted_fn=tp.f_shifted)
    axes = [torch.linspace(-1, 1, n + 1) for n in (nx, ny, nz)]
    coeffs, diags, _ = H3.enhance_3d(tp, cfg, *axes, tfem,
                                     (ops, (t_int, spts)))
    assert tuple(got[0].shape) == (nx * ny * nz, 64)
    assert_matches(got, coeffs.reshape(-1, 64), diags.bc_violation,
                   diags.max_slack)


def test_trace_rows_match_jax_element_data(shared_case):
    """The wrapper's surface trace (corner gather, trilinear trace, g from
    the six face samples) equals JAX's ``_element_data_3d`` rows; so does
    the sampled rhs, plain and through ``f_shifted``."""
    c = shared_case
    tp = c["tp"]
    tfem = torch.from_numpy(c["fem"])
    f_rows, bc_rows = c["rows"]
    for fs in (None, tp.f_shifted):
        f, gface, pts = K3._inputs(tfem, c["tops"], tp.f, tp.g, GEOM, NX, NY,
                                   NZ, c["t_int"], c["spts"], fs)
        close(f.T, f_rows, 5e-5)
    assert tuple(gface.shape) == (6, 56, max(NY * NZ, NX * NZ, NX * NY))
    assert tuple(pts.shape) == (14, 56)
    close(K3._trace_bc(tfem, gface, pts, NX, NY, NZ).T, bc_rows, 2e-6)


def test_override_on_every_face_mirrors_the_tpu_kernel():
    """The kernel route puts g on all six domain faces, as the Pallas
    kernel does; the torch route keeps the FEM trace on natural faces, as
    JAX's XLA route does.  With a g that is wrong on robin_3d's natural
    faces the two differ exactly there."""
    c = case("robin_3d")
    tp = dataclasses.replace(c["tp"], g=lambda x, y, z: 0.0 * x + 5.0)
    tfem = torch.from_numpy(c["fem"])
    f, gface, pts = K3._inputs(tfem, c["tops"], tp.f, tp.g, GEOM, NX, NY, NZ,
                               c["t_int"], c["spts"], None)
    bc_kernel = K3._trace_bc(tfem, gface, pts, NX, NY, NZ).T
    cfg = H3.Solver3DConfig(nx=NX, ny=NY, nz=NZ, dtype="float32")
    axes = [torch.linspace(-1, 1, n + 1) for n in (NX, NY, NZ)]
    _, bc_torch, _ = H3._element_data_3d(tp, cfg, *axes, tfem, c["t_int"],
                                         c["spts"])
    # robin_3d: natural x-hi and z-hi faces.
    on_x_hi = torch.tensor(c["spts"][:, 2] == 1.0)
    hexes = torch.arange(NX * NY * NZ)
    ey, ez = hexes // NX % NY, hexes // (NX * NY)
    # x-hi hexes away from the other faces: only the natural face there.
    x_hi = ((hexes % NX == NX - 1) & (ey > 0) & (ey < NY - 1) & (ez > 0)
            & (ez < NZ - 1))
    assert torch.all(bc_kernel[x_hi][:, on_x_hi] == 5.0)
    assert not torch.any(bc_torch[x_hi][:, on_x_hi] == 5.0)
    dirichlet_only = (hexes % NX == 0) & (ey == 0) & (ez == 0)
    close(bc_kernel[dirichlet_only], bc_torch[dirichlet_only], 1e-6)
    # The torch route is JAX's XLA route.
    close(bc_torch, JH3._element_data_3d(
        dataclasses.replace(c["jp"], g=lambda x, y, z: 0.0 * x + 5.0),
        c["cfg"], *[jnp.linspace(-1, 1, n + 1, dtype=jnp.float32)
                    for n in (NX, NY, NZ)], jnp.asarray(c["fem"]),
        c["t_int"], c["spts"])[1], 2e-6)


def test_nan_nodal_value_fails_only_its_hexes():
    """A NaN nodal value poisons the eight hexes around it (NaN
    diagnostics, gate false) and no other."""
    c = case("poisson_3d")
    fem = c["fem"].copy()
    fem[3, 2, 1] = np.nan  # node (z=3, y=2, x=1)
    w, slack, bcv = run(c, fem=fem)
    bad = torch.nonzero(~torch.isfinite(bcv)).flatten().tolist()
    want = sorted(ez * NX * NY + ey * NX + ex for ez in (2, 3)
                  for ey in (1, 2) for ex in (0, 1))
    assert bad == want
    assert int(torch.isfinite(slack).sum()) == NX * NY * NZ - 8
    t = torch.from_numpy(fem)
    from hybrid_fem_lssvr_tpu_torch.ops import assembly3d as A3
    ok = H3._kernel_solve_ok_3d(slack, bcv, A3._corners_3d(t))
    assert torch.nonzero(~ok).flatten().tolist() == want


def test_argument_checks():
    c = case("poisson_3d")
    bare = dataclasses.replace(c["tops"], Pres=None)
    tp = c["tp"]
    with pytest.raises(ValueError, match="residual operators"):
        K3.fused_enhance_stacked_3d(torch.from_numpy(c["fem"]), bare, tp.f,
                                    tp.g, GEOM, NX, NY, NZ, c["t_int"],
                                    c["spts"])
    with pytest.raises(ValueError, match="nodal grid"):
        K3.fused_enhance_stacked_3d(torch.from_numpy(c["fem"][:-1]),
                                    c["tops"], tp.f, tp.g, GEOM, NX, NY, NZ,
                                    c["t_int"], c["spts"])


def test_routing_and_shape_checks():
    """On the CPU 'auto' resolves to torch and 'cuda' is refused; CUDA
    float32 with constant coefficients takes the kernel; variable
    coefficients, a lifted trace or a trace override take torch; the
    launch guard refuses CPU tensors and an (M, C) that was not
    compiled."""
    p = H3.get_problem_3d("poisson_3d")
    vc = H3.get_problem_3d("variable_coeff_elliptic_3d")
    f32 = H3.Solver3DConfig(dtype="float32")
    assert H3._resolve_backend(p, f32, "cpu") == "torch"
    assert H3._resolve_backend(p, f32, "cuda") == "cuda"
    assert H3._resolve_backend(p, H3.Solver3DConfig(), "cuda") == "torch"
    assert H3._resolve_backend(vc, f32, "cuda") == "torch"
    assert H3._resolve_backend(p, f32, "cuda", forced_torch=True) == "torch"
    cuda_cfg = H3.Solver3DConfig(dtype="float32", backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda'"):
        H3._resolve_backend(p, cuda_cfg, "cpu")
    with pytest.raises(ValueError, match="backend='cuda'"):
        H3.HybridSolver3D(p, dataclasses.replace(cuda_cfg, nx=2, ny=2, nz=2),
                          device="cpu").solve()
    with pytest.raises(ValueError, match="unknown backend"):
        H3.Solver3DConfig(backend="pallas")
    c = case("poisson_3d")
    x = torch.from_numpy(c["fem"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        K3._cuda(x, x, x, x, c["tops"], NX, NY, NZ, True)
    K3.check_shape("k", 4, 4)
    with pytest.raises(ValueError, match="no CUDA kernel compiled for M=5"):
        K3.check_shape("k", 5, 5)
    assert K3.launch_counts() == {"fused_enhance_stacked_3d": 0}


def test_compiled_shapes_agree_with_the_cuda_source():
    """``kernels3d.SHAPES`` is the list ``ENH3D_SHAPES`` of
    ``csrc/enhance3d.cu`` compiles."""
    path = os.path.join(os.path.dirname(K3.__file__), os.pardir, "csrc",
                        "enhance3d.cu")
    with open(path) as fh:
        line = re.search(r"#define ENH3D_SHAPES\(X\)(.*)", fh.read())
    shapes = tuple((int(m), int(c)) for m, c in
                   re.findall(r"X\((\d+), (\d+)\)", line.group(1)))
    assert shapes == K3.SHAPES
