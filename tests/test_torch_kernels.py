"""The port's fused-kernel plain versions against JAX's Pallas kernels.

The JAX kernels run in interpret mode on the CPU (E=256, tile=128), as
``tests/test_pallas.py`` runs them, and the port's wrappers, given CPU
tensors, run their plain versions on the same float32 inputs.  Tolerances
are ``test_pallas.py``'s: w 2e-6, slack 2e-5 and bcv 2e-6 for the shared
kernels (``:34-39``, ``:116-129``), 3e-5 for the per-element kernel on a
uniform mesh (``:175``, ``:205``) and 5e-5 on a graded one (``:370``).
The kernels themselves are compared with these plain versions on the GPU
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hybrid_fem_lssvr_tpu import SolverConfig as JConfig
from hybrid_fem_lssvr_tpu.models import hybrid as JH
from hybrid_fem_lssvr_tpu.models import problems as jprob
from hybrid_fem_lssvr_tpu.ops import pallas_kernels as pk

from hybrid_fem_lssvr_tpu_torch import SolverConfig, HybridSolver
from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
from hybrid_fem_lssvr_tpu_torch.models import problems as tprob
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
from hybrid_fem_lssvr_tpu_torch.utils import convert

torch.set_num_threads(1)

W_TOL, SLACK_TOL, BCV_TOL = 2e-6, 2e-5, 2e-6
VC_TOL, GRADED_TOL = 3e-5, 5e-5


def fem_values(E, seed=0):
    """Nodal values of sin(pi x) with a little noise, float32."""
    x = np.linspace(-1.0, 1.0, E + 1)
    rng = np.random.default_rng(seed)
    return (np.sin(np.pi * x) + 1e-3 * rng.normal(size=E + 1)).astype(
        np.float32)


def np_(t):
    return None if t is None else np.asarray(t)


def close(got, want, atol):
    np.testing.assert_allclose(np_(got), np_(want), rtol=0, atol=atol)


def shared_ops(name, E, M=8, C=12):
    """JAX's float32 shared operators and the port's copy of them."""
    cfg = JConfig(num_nodes=E + 1, dtype="float32", M=M, n_colloc=C)
    jops = JH.prepare_shared_host(jprob.get(name), cfg)
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()
              if v is not None}
    return jops, convert.shared_operators_from_arrays(arrays)


@pytest.fixture(scope="module")
def poisson():
    E = 256
    jops, tops = shared_ops("poisson_1d", E)
    return E, fem_values(E), jops, tops


@pytest.mark.parametrize("mode", ["diagnostics", "fallback", "plain"])
def test_separable_matches_pallas(poisson, mode):
    E, fem, jops, tops = poisson
    kw = dict(with_diagnostics=mode != "plain",
              with_fallback=mode == "fallback")
    want = pk.fused_enhance_separable(
        jnp.asarray(fem), jops, jprob.poisson_1d().f_elem_factors, -1.0,
        2.0 / E, tile=128, interpret=True, **kw)
    got = K.fused_enhance_separable(
        torch.from_numpy(fem), tops, tprob.poisson_1d().f_elem_factors, -1.0,
        2.0 / E, **kw)
    assert len(got) == len(want)
    close(got[0], want[0], W_TOL)
    if mode == "plain":
        assert got[1] is None and got[2] is None
        return
    close(got[1], want[1], SLACK_TOL)
    close(got[2], want[2], BCV_TOL)
    if mode == "fallback":
        np.testing.assert_array_equal(np_(got[3]), np_(want[3]))
        assert np_(got[3]).all()


def test_separable_matches_pallas_translation_mode(poisson):
    """JAX's translation closure (one base point per tile) against the
    port's per-element factor sampling (test_pallas.py:122-129)."""
    E, fem, jops, tops = poisson
    p = jprob.poisson_1d()
    want = pk.fused_enhance_separable(
        jnp.asarray(fem), jops, p.f_elem_factors, -1.0, 2.0 / E, tile=128,
        interpret=True, f_translation=p.f_translation)
    got = K.fused_enhance_separable(
        torch.from_numpy(fem), tops, tprob.poisson_1d().f_elem_factors,
        -1.0, 2.0 / E)
    close(got[0], want[0], W_TOL)
    np.testing.assert_allclose(np_(got[1]), np_(want[1]), rtol=1e-3,
                               atol=1e-11)


def test_separable_nan_gate_and_fallback(poisson):
    """A NaN nodal value fails the gate of its two elements; every other
    element keeps its solve, as in JAX's with_fallback=True kernel."""
    E, fem, jops, tops = poisson
    bad = fem.copy()
    bad[100] = np.nan
    want = pk.fused_enhance_separable(
        jnp.asarray(bad), jops, jprob.poisson_1d().f_elem_factors, -1.0,
        2.0 / E, tile=128, interpret=True, with_fallback=True)
    got = K.fused_enhance_separable(
        torch.from_numpy(bad), tops, tprob.poisson_1d().f_elem_factors,
        -1.0, 2.0 / E, with_fallback=True)
    ok = np_(got[3])
    np.testing.assert_array_equal(ok, np_(want[3]))
    assert list(np.flatnonzero(ok == 0)) == [99, 100]
    for g, w, tol in zip(got[:3], want[:3], (W_TOL, SLACK_TOL, BCV_TOL)):
        np.testing.assert_allclose(np_(g), np_(w), rtol=0, atol=tol,
                                   equal_nan=True)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("diagnostics", [True, False])
def test_shared_matches_pallas(poisson, shifted, diagnostics):
    E, fem, jops, tops = poisson
    jp, tp = jprob.poisson_1d(), tprob.poisson_1d()
    want = pk.fused_enhance_shared(
        jnp.asarray(fem), jops, jp.f, -1.0, 2.0 / E, 12, tile=128,
        interpret=True, with_diagnostics=diagnostics,
        f_shifted_fn=jp.f_shifted if shifted else None)
    got = K.fused_enhance_shared(
        torch.from_numpy(fem), tops, tp.f, -1.0, 2.0 / E, 12,
        with_diagnostics=diagnostics,
        f_shifted_fn=tp.f_shifted if shifted else None)
    close(got[0], want[0], W_TOL)
    if diagnostics:
        close(got[1], want[1], SLACK_TOL)
        close(got[2], want[2], BCV_TOL)
    else:
        assert got[1] is None and got[2] is None


def varcoeff_ops(M, C, h):
    """JAX's VarCoeffOperators and the port's copy through the converter."""
    jhost = pk.VarCoeffOperators(M, C, h, jnp.float32)
    arrays = {k: np.asarray(getattr(jhost, k))
              for k in ("AZ", "AP", "Z", "Pbc", "B", "K", "s2")}
    return jhost, convert.varcoeff_operators_from_arrays(arrays)


@pytest.mark.parametrize("name,M,C,E,shifted", [
    ("variable_coeff_elliptic", 8, 12, 256, False),
    ("variable_coeff_elliptic", 8, 12, 256, True),
    ("advection_diffusion_1d", 6, 10, 128, False),
])
def test_varcoeff_matches_pallas(name, M, C, E, shifted):
    fem = fem_values(E, seed=1)
    h = 2.0 / E
    jhost, thost = varcoeff_ops(M, C, h)
    jp, tp = jprob.get(name), tprob.get(name)
    want = pk.fused_enhance_varcoeff(
        jnp.asarray(fem), jp, jhost, -1.0, h, C, tile=128, interpret=True,
        f_shifted_fn=jp.f_shifted if shifted else None)
    got = K.fused_enhance_varcoeff(
        torch.from_numpy(fem), tp, thost, -1.0, h, C,
        f_shifted_fn=tp.f_shifted if shifted else None)
    close(got[0], want[0], VC_TOL)
    # Same CGS2 factorisation: the condition monitor agrees closely; the
    # slack amplifies f32 noise in w by ||D|| ~ (2/h)^2, so compare its
    # magnitude (test_pallas.py:182-187).
    np.testing.assert_allclose(np_(got[3]), np_(want[3]), rtol=1e-3)
    ratio = float(got[1].max()) / float(np.max(np_(want[1])))
    assert 0.2 < ratio < 5.0, ratio
    close(got[2], want[2], BCV_TOL)


@pytest.mark.parametrize("name", ["variable_coeff_elliptic", "poisson_1d"])
def test_varcoeff_graded_matches_pallas(name):
    E = 128
    rng = np.random.default_rng(4)
    x = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, E))])
    nodes = (-1.0 + 2.0 * x / x[-1]).astype(np.float32)
    fem = np.sin(np.pi * nodes).astype(np.float32)
    h = 2.0 / E
    jhost, thost = varcoeff_ops(8, 12, h)
    want = pk.fused_enhance_varcoeff(
        jnp.asarray(fem), jprob.get(name), jhost, -1.0, h, 12, tile=128,
        interpret=True, nodes=jnp.asarray(nodes))
    got = K.fused_enhance_varcoeff(
        torch.from_numpy(fem), tprob.get(name), thost, -1.0, h, 12,
        nodes=torch.from_numpy(nodes))
    close(got[0], want[0], GRADED_TOL)
    close(got[2], want[2], BCV_TOL)
    np.testing.assert_allclose(np_(got[3]), np_(want[3]), rtol=1e-3)


def test_ragged_element_count_matches_xla_route():
    """E = 200 is no multiple of 128 (JAX's Pallas kernels refuse it): the
    plain versions match JAX's XLA route there."""
    E = 200
    fem = fem_values(E, seed=2)
    fem[0] = fem[-1] = 0.0  # Dirichlet-consistent, as the solver passes it
    jops, tops = shared_ops("poisson_1d", E)
    jp, tp = jprob.poisson_1d(), tprob.poisson_1d()
    jcfg = JConfig(num_nodes=E + 1, dtype="float32")
    jnodes = JH.uniform_nodes(jp, E + 1, jnp.float32)
    wj, dj = jax.jit(lambda n, f: JH.lssvr_enhance(jp, n, f, jcfg, jops))(
        jnodes, jnp.asarray(fem))
    t = torch.from_numpy(fem)
    for got in (K.fused_enhance_separable(t, tops, tp.f_elem_factors, -1.0,
                                          2.0 / E),
                K.fused_enhance_shared(t, tops, tp.f, -1.0, 2.0 / E, 12)):
        close(got[0], wj, W_TOL)
        close(got[2], dj.bc_violation, BCV_TOL)

    vp, vt = jprob.variable_coeff_elliptic(), tprob.variable_coeff_elliptic()
    wj, _ = jax.jit(lambda n, f: JH.lssvr_enhance(vp, n, f, jcfg))(
        jnodes, jnp.asarray(fem))
    _, thost = varcoeff_ops(8, 12, 2.0 / E)
    got = K.fused_enhance_varcoeff(t, vt, thost, -1.0, 2.0 / E, 12)
    close(got[0], wj, VC_TOL)


def test_wrappers_use_plain_versions_on_cpu(poisson):
    """On CPU tensors each wrapper returns exactly its plain version's
    output, and no kernel is launched."""
    E, fem, _, tops = poisson
    K.reset_launch_counts()
    t = torch.from_numpy(fem)
    p = tprob.poisson_1d()
    pairs = [
        (K.fused_enhance_separable, K.fused_enhance_separable_ref,
         (t, tops, p.f_elem_factors, -1.0, 2.0 / E), dict(with_fallback=True)),
        (K.fused_enhance_shared, K.fused_enhance_shared_ref,
         (t, tops, p.f, -1.0, 2.0 / E, 12), {}),
        (K.fused_enhance_varcoeff, K.fused_enhance_varcoeff_ref,
         (t, tprob.variable_coeff_elliptic(),
          K.VarCoeffOperators.host(8, 12, 2.0 / E), -1.0, 2.0 / E, 12), {}),
    ]
    for wrapper, ref, args, kw in pairs:
        for g, w in zip(wrapper(*args, **kw), ref(*args, **kw)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert K.launch_counts() == {"fused_enhance_separable": 0,
                                 "fused_enhance_shared": 0,
                                 "fused_enhance_varcoeff": 0}


def test_cuda_route_rejects_cpu_tensors(poisson):
    E, fem, _, tops = poisson
    t = torch.from_numpy(fem)
    a = torch.zeros(2, E)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K._separable_cuda(t, a, tops, True, True)
    cfg = SolverConfig(num_nodes=33, dtype="float32", backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda'"):
        HybridSolver(tprob.poisson_1d(), cfg, device="cpu").solve()
    assert H._resolve_backend(SolverConfig(dtype="float32"), "cpu") == "torch"
    assert H._resolve_backend(SolverConfig(dtype="float32"), "cuda") == "cuda"
    assert H._resolve_backend(SolverConfig(), "cuda") == "torch"  # float64
    # No kernel is compiled for M=5: 'auto' still picks the kernels, which
    # raise for it (no silent torch route on the card).
    assert H._resolve_backend(SolverConfig(dtype="float32", M=5),
                              "cuda") == "cuda"
    assert K.launch_counts()["fused_enhance_separable"] == 0


def test_host_operators_match_jax():
    """The port's own host precompute of the kernel statics equals JAX's."""
    jhost, _ = varcoeff_ops(8, 12, 2.0 / 64)
    own = K.VarCoeffOperators.host(8, 12, 2.0 / 64)
    for k in ("AZ", "AP", "Z", "Pbc", "B"):
        np.testing.assert_array_equal(np_(getattr(own, k)),
                                      np_(getattr(jhost, k)))
    assert own.K == jhost.K and own.s2 == jhost.s2
    cfg = SolverConfig(num_nodes=65, dtype="float32")
    own_shared = H.prepare_shared_host(tprob.poisson_1d(), cfg)
    jops, _ = shared_ops("poisson_1d", 64)
    for k, v in jops._asdict().items():
        if v is not None:
            np.testing.assert_allclose(np_(getattr(own_shared, k)), np_(v),
                                       rtol=0, atol=1e-6 * float(
                                           np.max(np.abs(np_(v)))))
