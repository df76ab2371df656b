"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--gate-basis]

``--gate-basis`` also solves each 2D configuration through the plain torch
route on the card and prints its Linf: the numbers the 2D gates are set
from.

Builds the hand-written kernels of ``hybrid_fem_lssvr_tpu_torch/csrc`` with
nvcc (one process per source, in parallel), holds each kernel against its
plain PyTorch version at the main paths' shapes (1D: E = 2^20 elements,
M = 8, 12 collocation points; 2D: 1024 x 1024 quads, M = 6, 6 x 6
collocation points), then drives the 1D solver through ``HybridSolver`` at
2^20 elements and at the reference's 25-node configuration and the 2D
solver through ``HybridSolver2D`` at 1024 x 1024 quads, checks the errors
against gates and shows through the kernels' launch counters that the
solves ran on them.

Each phase prints one JSON line.  The last lines are the kernel summary,
the card's name and power limit as nvidia-smi reports them, and
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero.  Without a CUDA device, or without the package beside
it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "hybrid_fem_lssvr_tpu_torch"
CSRC = f"{PKG}/csrc"
PALLAS = "hybrid_fem_lssvr_tpu/ops/pallas_kernels.py"
# name -> (source in the repo, file:line of the TPU kernel it replaces)
KERNELS = {
    "fused_enhance_separable": (f"{CSRC}/enhance1d.cu", f"{PALLAS}:165"),
    "fused_enhance_shared": (f"{CSRC}/enhance1d.cu", f"{PALLAS}:54"),
    "fused_enhance_varcoeff": (f"{CSRC}/enhance1d.cu", f"{PALLAS}:866"),
    "fused_enhance_stacked_2d": (f"{CSRC}/enhance2d.cu", f"{PALLAS}:490"),
    "fused_enhance_shared_2d": (f"{CSRC}/enhance2d.cu", f"{PALLAS}:341"),
    "fused_enhance_varcoeff_2d": (f"{CSRC}/enhance2d_varcoeff.cu",
                                  f"{PALLAS}:1064"),
}

# The card's published peaks (H100 SXM data sheet): device memory rate and
# float32 rate outside the tensor cores.  bound_ms of a kernel is the larger
# of its bytes (each input read once, each output written once) over the
# first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

E_MAIN = 1 << 20
M, C = 8, 12
REPS = 20  # timed launches per median
DENSE_POINTS = (1 << 22) + 1  # evaluation grid of the error gates

# The 2D main path: bench.py's size for the structured-quad solver.
N2D = 1024
M2D = C2D = 6
REPS_2D = 5
POINTS_2D = 1 << 20  # random evaluation points (seed 0) of the 2D gates
TEST_POINTS = 201  # the reference's evaluation grid (25-node config)

# Linf gates on the dense grid: about 10x what the port's plain (torch)
# route gives at the same size and dtypes on a CPU (2.98e-7, 2.98e-7,
# 2.74e-6, 1.61e-6), never looser than bench.py's 1e-5 for poisson.
GATES = {
    "poisson_1d": 3e-6,
    "poisson_1d_generic_rhs": 3e-6,
    "variable_coeff_elliptic": 3e-5,
    "variable_coeff_elliptic_graded": 2e-5,
}
# The reference's Linf at 25 nodes, M=8, gamma=1e4, 2-point load quadrature;
# float32 adds ~1.2e-7 (the plain route on a CPU gives 3.397e-6).
PARITY_LINF, PARITY_TOL = 3.274e-6, 0.5e-6

# Kernel-vs-plain tolerances on the whole output (tests/test_pallas.py's,
# as in the CPU tests).
W_TOL, SLACK_TOL, BCV_TOL = 2e-6, 2e-5, 2e-6
VC_TOL, GRADED_TOL = 3e-5, 5e-5
# At 2^20 elements the rhs's share of w is ~(h/2)^2 f ~ 1e-11: far below
# the absolute tolerances above and below float32 rounding of the boundary
# part, so a kernel that dropped its rhs term would pass them.  Each kernel
# is therefore also run on zero nodal values, where w is the rhs part
# alone, and held to its plain version relative to that part's size.
# Float32 rounding gives up to ~1e-5 there (plain float32 against plain
# float64 on a CPU at this h); a dropped or sign-flipped rhs gives 1 or 2.
RHS_REL_TOL = 1e-3
# The diagnostics.  Where the solve is sound, bcv is float32 rounding of an
# exact zero (~1e-7 to 1e-6 a quad) and the kernel and its plain version
# differ on a single element by as much as the value itself, so the absolute
# tolerances above would pass a kernel that returns zeros.  check_diagnostic
# therefore holds each output (a) element by element within a multiple of
# the plain version's largest value and (b) in the mean over all elements
# within MEAN_RATIO: zeros give a ratio of 0.  The multiples are about twice
# what an H100 run gives: per element the 1D separable and shared slack
# agree to 1e-7 and 5e-5 of the largest value, the 2D stacked and shared
# slack to 0.30 and 0.52; the per-element factorisations amplify rounding
# by ||D|| (0.78 sne, 1.14 qr, 1.24 in 1D); bcv to 0.6-1.25; the means
# agree within 0.97-1.24.  In 2D, bcv is also computed with B scaled by
# 1.5, where it is ~max |bc| / 2 on every quad and not rounding, and held
# quad by quad to BCV_SKEWED_REL of its size (an H100 run gives ~3e-7).
SLACK_REL = {"separable_kernel": 1e-3, "shared_kernel": 1e-3,
             "varcoeff_kernel": 2.5, "stacked2d_kernel": 0.6,
             "shared2d_kernel": 1.0, "varcoeff2d_sne_kernel": 1.6,
             "varcoeff2d_qr_kernel": 2.3}
BCV_REL = 2.0
MEAN_RATIO = (0.66, 1.5)
BCV_SKEWED_REL = 1e-5

def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS):
    """Median wall milliseconds of fn() between CUDA events, after one
    warm-up.  It includes the host's launch overhead whenever the host
    takes longer to enqueue fn's work than the device takes to run it."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def busy_ms(events, skip=()):
    """Milliseconds in which the card ran anything: the union of the
    intervals of the profiler's device events, leaving out the device-side
    copies of user spans (names in ``skip``)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in skip)
    check(spans, "torch.profiler recorded no device activity")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def device_ms(fn, kernel=None, reps=REPS):
    """(busy, kernel) device milliseconds per fn() call, averaged over
    ``reps`` calls under torch.profiler: busy is the union of the intervals
    in which fn's kernels and copies ran on the card (host launch overhead
    excluded); kernel is the time of the CUDA kernel named ``kernel`` alone
    (None without a name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        if kernel is None:
            return busy_ms(events) / reps, None
        own = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and f"{kernel}<" in e.name]
        if len(own) == reps:  # the tracer now and then drops a record
            break
    check(len(own) == reps, f"profiler saw {len(own)} launches of {kernel} "
          f"in {reps} calls, three times over")
    own_ms = sum(e.time_range.elapsed_us() for e in own) / 1e3
    return busy_ms(events) / reps, own_ms / reps


def max_err(a, b):
    return float((a - b).abs().max())


def check_diagnostic(tag, what, got, want, rel):
    """A per-element diagnostics output (slack or bcv) of a kernel against
    the plain version's: every element within ``rel`` of the plain version's
    largest value, and the two means within MEAN_RATIO (see SLACK_REL)."""
    size, mean = float(want.max()), float(want.mean())
    check(mean > 0, f"{tag}: the plain version's {what} is zero")
    err, ratio = max_err(got, want), float(got.mean()) / mean
    check(err <= rel * size, f"{tag}: {what} differs from the plain version "
          f"by {err}, more than {rel} of its largest value {size}")
    check(MEAN_RATIO[0] < ratio < MEAN_RATIO[1], f"{tag}: mean {what} is "
          f"{ratio} of the plain version's {mean}")
    return {f"{what}_size": size, f"{what}_max_abs_err": err,
            f"{what}_mean_ratio": ratio}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops \
        else (by_ops, "operations")


def work_1d(name, E, R=2):
    """(bytes, flops) of a 1D kernel at (E, M, C) with diagnostics: the
    dense inputs read once, w and the diagnostics written once; two flops
    per multiply-add of the function's contractions."""
    K = M - 2
    if name == "fused_enhance_separable":
        nbytes = 4 * (E + 1 + R * E + E * M + 3 * E)
        flops = 2 * E * ((R + 2) * (M + C) + 2 * M)
    elif name == "fused_enhance_shared":
        nbytes = 4 * (E + 1 + C * E + E * M + 2 * E)
        flops = 2 * E * (M * (C + 2) + C * M + 2 * M)
    else:  # per-element CGS2 QR: G, g, two Gram-Schmidt passes, y, w, e
        nbytes = 4 * (E + 1 + 4 * C * E + E * M + 3 * E)
        flops = 2 * E * (3 * C * K + 6 * C + 2 * K * K * C + C * K
                         + K * K // 2 + M * (K + 2) + C * K + 2 * M)
    return nbytes, flops


def work_2d(name, method="sne", n_terms=3):
    """(bytes, flops) of a 2D kernel at N2D x N2D quads, (M2D, C2D), with
    diagnostics.  For the per-element kernel the operations are those of
    the algorithm with G formed once (the kernel rebuilds it per pass)."""
    E = N2D * N2D
    M2, C2, Kb = M2D * M2D, C2D * C2D, 4 * M2D - 4
    K = M2 - Kb
    nodes = (N2D + 1) * (N2D + 1)
    edges = 4 * Kb * N2D
    out = E * M2 + 2 * E
    if name == "fused_enhance_stacked_2d":
        nbytes = 4 * (nodes + edges + C2 * E + out)
        flops = 2 * E * ((M2 + C2) * (C2 + Kb) + Kb * M2)
    elif name == "fused_enhance_shared_2d":
        nbytes = 4 * (nodes + edges + C2 * E + out)
        flops = 2 * E * (M2 * (C2 + Kb) + C2 * M2 + Kb * M2)
    else:
        nbytes = 4 * (nodes + edges + 4 * C2 * E + out)
        common = (n_terms * C2 * (K + Kb)  # G and g
                  + M2 * (Kb + K) + Kb * M2  # w = Pbc bc + Z y, B w
                  + C2 * K)  # the final residual
        if method == "sne":  # N, G^T g, Cholesky, refinement (G y, G^T e)
            solve = (C2 * (K * (K + 1) // 2 + K) + K * K * K // 6
                     + 2 * K * K + 2 * C2 * K)
        else:  # CGS2: two passes of dot + axpy per column pair, Q^T g, R
            solve = 2 * K * K * C2 + C2 * K + K * K // 2
        flops = 2 * E * (common + solve)
    return nbytes, flops


# ---------------------------------------------------------------- phases

def phase_build():
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    t0 = time.perf_counter()
    libs = cuda_lib.build()  # every source, one nvcc each, in parallel
    for source in cuda_lib.SOURCES:
        cuda_lib.load(source)
    seconds = time.perf_counter() - t0
    log = cuda_lib.build_log()
    emit("build", seconds=seconds, nvcc_flags=" ".join(cuda_lib.NVCC_FLAGS),
         libraries=sorted(os.path.basename(v) for v in libs.values()),
         ptxas=[r for r in cuda_lib.ptxas_summary(log)
                if (r.get("M"), r.get("C")) in ((M, C), (M2D, C2D))])


def kernel_inputs(device):
    """Main-path-shaped inputs from seed 0: Dirichlet-consistent nodal values
    of sin(pi x) plus noise, the shared operators of poisson_1d, the
    per-element statics and a graded mesh."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import hybrid as H
    from hybrid_fem_lssvr_tpu_torch.models import problems
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(0)
    x = torch.linspace(-1.0, 1.0, E_MAIN + 1, dtype=torch.float64)
    fem = torch.sin(torch.pi * x) + 1e-3 * torch.randn(
        E_MAIN + 1, generator=g, dtype=torch.float64)
    fem[0] = fem[-1] = 0.0
    fem = fem.to(device=device, dtype=torch.float32)
    cfg = H.SolverConfig(num_nodes=E_MAIN + 1, M=M, n_colloc=C,
                         dtype="float32")
    h = 2.0 / E_MAIN
    ops = H.prepare_shared_host(problems.poisson_1d(), cfg).to(device)
    host = K.VarCoeffOperators.host(M, C, h).to(device)
    widths = 0.5 + 1.5 * torch.rand(E_MAIN, generator=g,
                                    dtype=torch.float64)
    xs = torch.cat([torch.zeros(1, dtype=torch.float64),
                    torch.cumsum(widths, 0)])
    graded = (-1.0 + 2.0 * xs / xs[-1]).to(device=device,
                                           dtype=torch.float32)
    return fem, ops, host, h, graded


def phase_kernels(device="cuda"):
    """Each kernel's public wrapper against its plain version (``*_ref``)
    on the same inputs: on the main path's nodal values, and on zero nodal
    values, where w is the rhs part alone (RHS_REL_TOL)."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import problems
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    fem, ops, host, h, graded = kernel_inputs(device)
    gfem = torch.sin(torch.pi * graded)
    pois, vc = problems.poisson_1d(), problems.variable_coeff_elliptic()
    sep = (K.fused_enhance_separable, K.fused_enhance_separable_ref,
           "separable_kernel", (ops, pois.f_elem_factors, -1.0, h))
    sh = (K.fused_enhance_shared, K.fused_enhance_shared_ref,
          "shared_kernel", (ops, pois.f, -1.0, h, C))
    var = (K.fused_enhance_varcoeff, K.fused_enhance_varcoeff_ref,
           "varcoeff_kernel", (vc, host, -1.0, h, C))
    cases = [
        # variant, (wrapper, plain, CUDA kernel, arguments after the nodal
        # values), nodal values, keywords, tolerance per output
        ("gate+fallback", sep, fem, dict(with_fallback=True),
         (W_TOL, SLACK_TOL, BCV_TOL, 0.0)),
        ("no diagnostics", sep, fem, dict(with_diagnostics=False), (W_TOL,)),
        ("diagnostics", sh, fem, dict(f_shifted_fn=pois.f_shifted),
         (W_TOL, SLACK_TOL, BCV_TOL)),
        ("no diagnostics", sh, fem,
         dict(with_diagnostics=False, f_shifted_fn=pois.f_shifted), (W_TOL,)),
        ("uniform", var, fem, dict(f_shifted_fn=vc.f_shifted),
         (VC_TOL, None, BCV_TOL, None)),
        ("graded", var, gfem, dict(nodes=graded),
         (GRADED_TOL, None, BCV_TOL, None)),
    ]
    summary = {}
    for variant, (wrapper, ref, kname, args), nodal, kw, tols in cases:
        name = wrapper.__name__
        tag = f"{name}/{variant}"
        kern = functools.partial(wrapper, nodal, *args, **kw)
        plain = functools.partial(ref, nodal, *args, **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(len(got) == len(want), f"{tag}: {len(got)} outputs, plain "
              f"version {len(want)}")
        errs = []
        for g, w, tol in zip(got, want, tols):
            if tol is None:
                continue
            check(g.shape == w.shape, f"{tag}: shape {g.shape} != {w.shape}")
            err = max_err(g, w)
            errs.append(err)
            check(err <= tol, f"{tag}: max abs err {err} > {tol}")
        check(got[0].shape == (E_MAIN, M), f"{tag}: w shape {got[0].shape}")
        check(bool(torch.isfinite(got[0]).all()), f"{tag}: non-finite w")
        if kname == "varcoeff_kernel":
            # Same CGS2 factorisation: the condition monitor agrees to
            # rounding; the slack amplifies f32 noise by ||D||, so compare
            # its magnitude (test_pallas.py:182-187).
            rel = float(((got[3] - want[3]).abs() / want[3]).max())
            check(rel <= 1e-3, f"{tag}: cond rel err {rel}")
            ratio = float(got[1].max()) / float(want[1].max())
            check(0.2 < ratio < 5.0, f"{tag}: slack ratio {ratio}")
        diag = {}
        if len(got) > 1 and got[1] is not None:
            for what, i, rel in (("slack", 1, SLACK_REL[kname]),
                                 ("bcv", 2, BCV_REL)):
                diag.update(check_diagnostic(tag, what, got[i], want[i], rel))
        zero = torch.zeros_like(nodal)
        w_rhs = wrapper(zero, *args, **kw)[0]
        w_rhs_plain = ref(zero, *args, **kw)[0]
        size = float(w_rhs_plain.abs().max())
        check(size > 0, f"{tag}: the plain version's rhs part is zero")
        rhs_rel = max_err(w_rhs, w_rhs_plain) / size
        check(rhs_rel <= RHS_REL_TOL, f"{tag}: rhs part of w differs from "
              f"the plain version by {rhs_rel} of its size {size} "
              f"(> {RHS_REL_TOL})")
        ms, kernel_ms = device_ms(kern, kname)
        plain_ms, _ = device_ms(plain)
        bound_ms, bound_by = bound(*work_1d(name, E_MAIN))
        emit("kernel", name=name, variant=variant, E=E_MAIN, M=M, C=C,
             max_abs_err=max(errs), rhs_size=size, rhs_rel_err=rhs_rel,
             ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             wall_ms=cuda_ms(kern), plain_wall_ms=cuda_ms(plain), **diag)
        summary.setdefault(name, dict(
            max_abs_err=max(errs), rhs_rel_err=rhs_rel, ms=ms,
            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None))
    # One PyTorch call that does a kernel's contraction on inputs already
    # sampled (a yardstick; the port never calls it): w = [WfF^T, Wbc] [a; bc]
    # for the separable kernel, w = [Wf, Wbc] [f; bc] for the shared one.
    # No single call does the per-element QR.
    bc = torch.stack([fem[:-1], fem[1:]])
    a = K._sample_separable(fem, pois.f_elem_factors, -1.0, h)
    f = K._sample_shared(fem, pois.f, -1.0, h, C, pois.f_shifted)
    for name, O, z in (
            ("fused_enhance_separable",
             torch.cat([ops.WfF.T, ops.Wbc], dim=1), torch.cat([a, bc])),
            ("fused_enhance_shared",
             torch.cat([ops.Wf, ops.Wbc], dim=1), torch.cat([f, bc]))):
        O, z = O.contiguous(), z.contiguous()
        summary[name]["library_ms"] = device_ms(
            functools.partial(torch.mm, O, z))[0]
        emit("library", name=name, call=f"torch.mm({list(O.shape)}, "
             f"{list(z.shape)})", library_ms=summary[name]["library_ms"])
    return summary


def main_path_runs(n_elements):
    """(label, problem, config, nodes or None) of the main-path run."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import SolverConfig, problems

    cfg = SolverConfig(num_nodes=n_elements + 1, M=M, gamma=1e4, n_colloc=C,
                       dtype="float32", fem_dtype="float64")
    generic = dataclasses.replace(problems.poisson_1d(), f_elem_factors=None,
                                  f_colloc_factors=None)
    g = torch.Generator().manual_seed(1)
    widths = 0.5 + 1.5 * torch.rand(n_elements, generator=g,
                                    dtype=torch.float64)
    xs = torch.cat([torch.zeros(1, dtype=torch.float64),
                    torch.cumsum(widths, 0)])
    graded = (-1.0 + 2.0 * xs / xs[-1]).to(torch.float32)
    return [
        ("poisson_1d", problems.poisson_1d(), cfg, None),
        ("poisson_1d_generic_rhs", generic, cfg, None),
        ("variable_coeff_elliptic", problems.variable_coeff_elliptic(), cfg,
         None),
        ("variable_coeff_elliptic_graded",
         problems.variable_coeff_elliptic(), cfg, graded),
    ]


def solve_and_gate(label, problem, cfg, nodes, device, points, gate):
    import torch

    from hybrid_fem_lssvr_tpu_torch import HybridSolver

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    s = HybridSolver(problem, cfg, nodes=nodes, device=device)
    sol = s.solve()
    sync()
    t1 = time.perf_counter()
    linf, l2 = (float(v) for v in s.errors(points))
    sync()
    t2 = time.perf_counter()
    E = cfg.num_nodes - 1
    check(sol.coeffs.shape == (E, cfg.M), f"{label}: coeffs shape "
          f"{tuple(sol.coeffs.shape)}")
    check(bool(torch.isfinite(sol.coeffs).all()), f"{label}: non-finite")
    check(bool(sol.solve_ok.all()), f"{label}: {int((~sol.solve_ok).sum())} "
          f"elements fell back")
    check(linf < gate, f"{label}: Linf {linf} >= gate {gate}")
    return s, dict(E=E, linf=linf, l2=l2, gate=gate, solve_s=t1 - t0,
                   errors_s=t2 - t1)


def phase_main_path(device="cuda"):
    """The solver's main path through HybridSolver; returns the launch
    counts of that run."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import SolverConfig, problems
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float32)
    runs = main_path_runs(E_MAIN)
    parity_cfg = SolverConfig(num_nodes=25, M=M, gamma=1e4, n_colloc=C,
                              dtype="float32", fem_quad_order=2)
    grid = torch.linspace(-1.0, 1.0, TEST_POINTS, dtype=torch.float32)

    K.reset_launch_counts()
    for label, problem, cfg, nodes in runs:
        _, rec = solve_and_gate(label, problem, cfg, nodes, device, dense,
                                GATES[label])
        emit("main_path", run=label, **rec)
    s, rec = solve_and_gate("parity_25_nodes", problems.poisson_1d(),
                            parity_cfg, None, device, grid,
                            PARITY_LINF + PARITY_TOL)
    counts = K.launch_counts()
    check(abs(rec["linf"] - PARITY_LINF) < PARITY_TOL,
          f"parity config: Linf {rec['linf']} vs reference {PARITY_LINF}")
    # The same configuration through the plain torch route on the CPU.
    cpu = solve_and_gate("parity_25_nodes_cpu", problems.poisson_1d(),
                         dataclasses.replace(parity_cfg, backend="torch"),
                         None, "cpu", grid, PARITY_LINF + PARITY_TOL)[0]
    agree = max_err(s.solution.coeffs.cpu(), cpu.solution.coeffs)
    check(agree < 3e-5, f"parity config: GPU vs CPU coeffs differ {agree}")
    emit("main_path", run="parity_25_nodes", gpu_vs_cpu_max_abs=agree, **rec)
    for name, n in counts.items():
        check(n > 0, f"{name} was not launched on the main path")
    emit("launch_counts", **counts)
    return counts


def phase_stages(device="cuda"):
    """Where the poisson_1d solve at 2^20 elements spends its time.  One
    HybridSolver solve plus errors() is timed on the host clock, then run
    once more under torch.profiler and read through the solver's own named
    spans (``models/hybrid.py`` SPANS): each span's host time, which the
    profiler's per-operation cost inflates, and the device time of the
    kernels launched inside it.  The device's idle share is taken against
    the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hybrid_fem_lssvr_tpu_torch import HybridSolver
    from hybrid_fem_lssvr_tpu_torch.models import hybrid as H

    label, problem, cfg, _ = main_path_runs(E_MAIN)[0]
    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float32)

    def run():
        s = HybridSolver(problem, cfg, device=device)
        s.solve()
        return [float(v) for v in s.errors(dense)]  # synchronises

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = {name: dict(host_ms=0.0, device_ms=0.0) for name in H.SPANS}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in spans:
            spans[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
            spans[e.name]["device_ms"] += e.device_time_total / 1e3
    for name, rec in spans.items():
        check(rec["host_ms"] > 0, f"span {name} not seen by the profiler")
    check(spans["lssvr_enhance"]["device_ms"] > 0,
          "the profiler attributed no device time to lssvr_enhance")
    busy = busy_ms(events, skip=H.SPANS)
    host_total = sum(r["host_ms"] for r in spans.values())
    tri = spans["fem_solve.tridiag"]
    emit("stages", run=label, E=E_MAIN, wall_ms=wall_ms,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, spans=spans,
         tridiag_host_share=tri["host_ms"] / host_total,
         tridiag_device_share=tri["device_ms"] / busy)


# ------------------------------------------------------------ 2D phases

def nodal_grid_2d(problem, device):
    """Nodal values for the kernel checks: the exact solution on the
    1025 x 1025 nodes plus noise on the interior ones, float32 (seed 0)."""
    import torch

    g = torch.Generator().manual_seed(0)
    xs = torch.linspace(-1.0, 1.0, N2D + 1, dtype=torch.float64)
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    u = problem.exact(X, Y).clone()
    u[1:-1, 1:-1] += 1e-3 * torch.randn(N2D - 1, N2D - 1, generator=g,
                                        dtype=torch.float64)
    return u.to(device=device, dtype=torch.float32).contiguous()


def phase_kernels_2d(device="cuda"):
    """Each 2D kernel's public wrapper against its plain version on the
    same inputs at 1024 x 1024 quads: on main-path-shaped nodal values
    (tolerances of tests/test_pallas.py: w 2e-5 stacked, 1e-5 shared, 3e-5
    per-element; bcv 1e-5; the slack in magnitude; the diagnostics also
    relative to their own size, see SLACK_REL), and on zero nodal values
    with zero boundary data, where w is the rhs part alone (RHS_REL_TOL)."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2

    cfg = Solver2DConfig(nx=N2D, ny=N2D, M=M2D, n_colloc=C2D,
                         dtype="float32")
    h = 2.0 / N2D
    geom = (-1.0, h, -1.0, h)
    s2 = 2.0 * (2.0 / h) ** 2
    inh = get_problem_2d("poisson_2d_inhomogeneous")
    vc = get_problem_2d("variable_coeff_elliptic_2d")
    ops, (t_int, bpts) = H2.prepare_shared_2d(inh, cfg)
    ops = ops.to(device)
    bare = dataclasses.replace(ops, Pres=None, Qres=None)
    vops = H2.prepare_shared_2d(vc, cfg)[0].to(device)
    fem_inh, fem_vc = nodal_grid_2d(inh, device), nodal_grid_2d(vc, device)
    tail = (geom, N2D, N2D, t_int, bpts)

    def zero_g(x, y):
        return torch.zeros_like(x + y)

    def shared_args(o, p, g_fn):
        return (o, p.f, g_fn) + tail

    def var_args(o, p, g_fn):
        return (o, p.a_var, p.grad_a, p.f, g_fn) + tail

    stacked = (K2.fused_enhance_stacked_2d, K2.fused_enhance_stacked_2d_ref,
               "stacked2d_kernel", shared_args, ops, inh, fem_inh)
    shared = (K2.fused_enhance_shared_2d, K2.fused_enhance_shared_2d_ref,
              "shared2d_kernel", shared_args, bare, inh, fem_inh)
    var = (K2.fused_enhance_varcoeff_2d, K2.fused_enhance_varcoeff_2d_ref,
           None, var_args, vops, vc, fem_vc)
    cases = [
        # variant, (wrapper, plain, CUDA kernel, arguments after the nodal
        # values, operators, problem, nodal values), keywords, w tolerance,
        # slack ratio range
        ("diagnostics", stacked, dict(f_shifted_fn=inh.f_shifted), 2e-5,
         (0.05, 20.0)),
        ("no diagnostics", stacked,
         dict(f_shifted_fn=inh.f_shifted, with_diagnostics=False), 2e-5,
         None),
        ("diagnostics", shared, dict(f_shifted_fn=inh.f_shifted), 1e-5,
         (0.05, 20.0)),
        ("sne", var, dict(s2=s2, method="sne", f_shifted_fn=vc.f_shifted),
         3e-5, (0.2, 5.0)),
        ("qr", var, dict(s2=s2, method="qr", f_shifted_fn=vc.f_shifted),
         3e-5, (0.2, 5.0)),
    ]
    E = N2D * N2D
    summary = {}
    for variant, case, kw, w_tol, rng in cases:
        wrapper, ref, kname, args_for, bundle, problem, nodal = case
        kname = kname or f"varcoeff2d_{variant}_kernel"
        name = wrapper.__name__
        tag = f"{name}/{variant}"
        args = args_for(bundle, problem, problem.g)
        kern = functools.partial(wrapper, nodal, *args, **kw)
        plain = functools.partial(ref, nodal, *args, **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(got[0].shape == want[0].shape == (E, M2D * M2D),
              f"{tag}: w shape {tuple(got[0].shape)}")
        check(bool(torch.isfinite(got[0]).all()), f"{tag}: non-finite w")
        err = max_err(got[0], want[0])
        check(err <= w_tol, f"{tag}: w max abs err {err} > {w_tol}")
        slack_ratio, diag = None, {}
        if rng is not None:
            bcv_err = max_err(got[2], want[2])
            check(bcv_err <= 1e-5, f"{tag}: bcv max abs err {bcv_err}")
            slack_ratio = float(got[1].max()) / float(want[1].max())
            check(rng[0] < slack_ratio < rng[1],
                  f"{tag}: slack ratio {slack_ratio}")
            for what, i, rel in (("slack", 1, SLACK_REL[kname]),
                                 ("bcv", 2, BCV_REL)):
                diag.update(check_diagnostic(tag, what, got[i], want[i], rel))
            # A sound solve meets its trace constraints, so bcv above is
            # rounding alone.  With B scaled by 1.5 (it enters nothing but
            # bcv) the same function gives bcv ~ max |bc| / 2 on every
            # quad, and the kernel has to agree quad by quad.
            skewed = args_for(dataclasses.replace(bundle, B=1.5 * bundle.B),
                              problem, problem.g)
            got_b, want_b = (fn(nodal, *skewed, **kw)[2]
                             for fn in (wrapper, ref))
            size = float(want_b.max())
            check(float(want_b.median()) > 1e-3,
                  f"{tag}: scaling B left bcv at {size}")
            diag["bcv_skewed_rel_err"] = max_err(got_b, want_b) / size
            check(diag["bcv_skewed_rel_err"] <= BCV_SKEWED_REL,
                  f"{tag}: bcv with B scaled by 1.5 differs from the plain "
                  f"version by {diag['bcv_skewed_rel_err']} of its size "
                  f"{size} (> {BCV_SKEWED_REL})")
            del got_b, want_b
        else:
            check(got[1] is None and got[2] is None,
                  f"{tag}: diagnostics returned without being asked for")
        del got, want
        zero = torch.zeros_like(nodal)
        rhs_only = args_for(bundle, problem, zero_g)
        w_rhs = wrapper(zero, *rhs_only, **kw)[0]
        w_rhs_plain = ref(zero, *rhs_only, **kw)[0]
        size = float(w_rhs_plain.abs().max())
        check(size > 0, f"{tag}: the plain version's rhs part is zero")
        rhs_rel = max_err(w_rhs, w_rhs_plain) / size
        check(rhs_rel <= RHS_REL_TOL, f"{tag}: rhs part of w differs from "
              f"the plain version by {rhs_rel} of its size {size} "
              f"(> {RHS_REL_TOL})")
        del w_rhs, w_rhs_plain
        ms, kernel_ms = device_ms(kern, kname, reps=REPS_2D)
        plain_ms, _ = device_ms(plain, reps=REPS_2D)
        method = kw.get("method", "sne")
        bound_ms, bound_by = bound(*work_2d(name, method, vops.n_terms))
        rec = dict(max_abs_err=err, slack_ratio=slack_ratio, **diag,
                   rhs_rel_err=rhs_rel, ms=ms,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        emit("kernel", name=name, variant=variant, nx=N2D, ny=N2D, M=M2D,
             C=C2D, rhs_size=size, wall_ms=cuda_ms(kern, reps=REPS_2D),
             plain_wall_ms=cuda_ms(plain, reps=REPS_2D), **rec)
        if name not in summary:
            summary[name] = dict(rec, library_ms=None)
        elif variant == "qr":
            summary[name]["qr"] = rec
    # The yardstick: one torch.mm of the stacked operator on a prebuilt
    # z = [f; bc] (no single PyTorch call does the per-quad factorisation).
    f, gedge, pts, _ = K2._shared_inputs(fem_inh, inh.f, inh.g, *tail,
                                         inh.f_shifted)
    z = torch.cat([f, K2._trace_bc(fem_inh, gedge, pts, N2D, N2D)])
    del f
    top = torch.cat([ops.Wf, ops.Wbc], dim=1)
    full = torch.cat([top, torch.cat([ops.Pres, ops.Qres], dim=1)])
    for name, O in (("fused_enhance_stacked_2d", full.contiguous()),
                    ("fused_enhance_shared_2d", top.contiguous())):
        summary[name]["library_ms"] = device_ms(
            functools.partial(torch.mm, O, z), reps=REPS_2D)[0]
        emit("library", name=name, call=f"torch.mm({list(O.shape)}, "
             f"{list(z.shape)})", library_ms=summary[name]["library_ms"])
    return summary


def runs_2d():
    """(label, problem name, config overrides) of the 2D main path."""
    return [
        ("poisson_2d", "poisson_2d", {}),
        ("poisson_2d_inhomogeneous", "poisson_2d_inhomogeneous", {}),
        ("variable_coeff_elliptic_2d/sne", "variable_coeff_elliptic_2d",
         dict(varcoeff_method="sne")),
        ("variable_coeff_elliptic_2d/qr", "variable_coeff_elliptic_2d",
         dict(varcoeff_method="qr")),
    ]


# Linf gates of the 2D main path on POINTS_2D random points: 10x what the
# port's plain torch route gives for the same configuration (float32
# enhancement over a float64 coarse solve at 1024 x 1024 quads, on an H100:
# 3.10e-6, 4.77e-6 and 2.98e-6, from ``--gate-basis``); for the variable
# coefficient problem far inside the 2e-3 of the reference's bench.py.
GATES_2D = {
    "poisson_2d": 3e-5,
    "poisson_2d/shared_2d": 3e-5,
    "poisson_2d_inhomogeneous": 5e-5,
    "variable_coeff_elliptic_2d/sne": 3e-5,
    "variable_coeff_elliptic_2d/qr": 3e-5,
}


def points_2d():
    import torch

    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, POINTS_2D, generator=g, dtype=torch.float64) * 2 - 1
    return pts[0].to(torch.float32), pts[1].to(torch.float32)


def solve_2d(name, device, n=N2D, **kw):
    import torch

    from hybrid_fem_lssvr_tpu_torch import (HybridSolver2D, Solver2DConfig,
                                            get_problem_2d)

    cfg = Solver2DConfig(**dict(dict(nx=n, ny=n, M=M2D, n_colloc=C2D,
                                     dtype="float32", fem_dtype="float64"),
                                **kw))
    t0 = time.perf_counter()
    s = HybridSolver2D(get_problem_2d(name), cfg, device=device)
    sol = s.solve()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, sol, time.perf_counter() - t0


def gate_2d(label, s, x, y, n=N2D):
    """Shape, finiteness and the Linf gate of the solver's 2D solution."""
    import torch

    coeffs = s.solution.coeffs
    check(tuple(coeffs.shape) == (n, n, M2D, M2D),
          f"{label}: coeffs shape {tuple(coeffs.shape)}")
    check(bool(torch.isfinite(coeffs).all()), f"{label}: non-finite")
    t0 = time.perf_counter()
    linf, l2 = (float(v) for v in s.errors(x, y))
    errors_s = time.perf_counter() - t0
    gate = GATES_2D[label]
    check(linf < gate, f"{label}: Linf {linf} >= gate {gate}")
    return dict(linf=linf, l2=l2, gate=gate, errors_s=errors_s)


def phase_main_path_2d(device="cuda", gate_basis=False):
    """The 2D main path through HybridSolver2D at 1024 x 1024 quads with
    backend='cuda'; returns the launch counts of that run.  With
    ``gate_basis`` each configuration is solved once more through the torch
    route (after the counts are read), for its Linf."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2

    x, y = points_2d()
    K2.reset_launch_counts()
    for label, name, kw in runs_2d():
        before = dict(K2.launch_counts())
        s, sol, solve_s = solve_2d(name, device, backend="cuda", **kw)
        check(bool(sol.solve_ok.all()), f"{label}: "
              f"{int((~sol.solve_ok).sum())} quads fell back")
        rec = gate_2d(label, s, x, y)
        launched = {k: v - before[k] for k, v in K2.launch_counts().items()
                    if v != before[k]}
        check(sum(launched.values()) == 1, f"{label}: launches {launched}")
        emit("main_path_2d", run=label, nx=N2D, ny=N2D, solve_s=solve_s,
             cg_iters=sol.cg_iters, cg_residual=float(sol.cg_residual),
             max_bc_violation=float(sol.bc_violation.max()),
             launched=launched, **rec)
        if label == "poisson_2d":
            # The same nodal values through enhance_2d with a bundle that
            # has no Pres: the route to fused_enhance_shared_2d.
            ops, pts = s._shared
            bare = dataclasses.replace(ops, Pres=None, Qres=None)
            coeffs, diags, _ = H2.enhance_2d(s.problem, s.config, sol.xs,
                                             sol.ys, sol.fem_values,
                                             (bare, pts))
            check(bool(diags.solve_ok.all()), "shared_2d: quads fell back")
            agree = max_err(coeffs, sol.coeffs)
            check(agree < 2e-5, f"shared_2d vs stacked_2d coeffs: {agree}")
            s.solution = sol._replace(coeffs=coeffs)
            emit("main_path_2d", run="poisson_2d/shared_2d",
                 vs_stacked_max_abs=agree,
                 **gate_2d("poisson_2d/shared_2d", s, x, y))
        del s, sol
    counts = K2.launch_counts()
    if gate_basis:
        for label, name, kw in runs_2d()[:3]:
            s, sol, solve_s = solve_2d(name, device, backend="torch", **kw)
            linf, l2 = (float(v) for v in s.errors(x, y))
            emit("gate_basis_2d", run=label.split("/")[0], route="torch",
                 linf=linf, l2=l2, solve_s=solve_s)
            del s, sol
            torch.cuda.empty_cache()
    # GPU (kernels) against CPU (torch route) coefficients at 64 x 64.
    for label, name, kw in runs_2d():
        gpu = solve_2d(name, device, n=64, backend="cuda", **kw)[1]
        cpu = solve_2d(name, "cpu", n=64, backend="torch", **kw)[1]
        agree = max_err(gpu.coeffs.cpu(), cpu.coeffs)
        check(agree < 3e-5, f"{label}: GPU vs CPU coeffs differ {agree}")
        check(abs(gpu.cg_iters - cpu.cg_iters) <= 1, f"{label}: cg iters "
              f"{gpu.cg_iters} on the GPU, {cpu.cg_iters} on the CPU")
        emit("main_path_2d", run=f"{label}@64", gpu_vs_cpu_max_abs=agree,
             cg_iters=gpu.cg_iters)
    for kname, n in counts.items():
        check(n > 0, f"{kname} was not launched on the 2D main path")
    emit("launch_counts_2d", **counts)
    return counts


def phase_routes_2d(device="cuda"):
    """The enhancement stage alone at 1024 x 1024 quads through its two
    routes on the same nodal values, in turns (kernel, torch, torch,
    kernel): what ``backend='auto'`` chooses between.  ``ms`` is the
    device-busy time of one ``enhance_2d`` call, ``wall_ms`` its CUDA-event
    time with the host's share."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2

    for label, name, kw in runs_2d()[:3]:
        s, sol, _ = solve_2d(name, device, backend="cuda", **kw)
        recs = {"cuda": [], "torch": []}
        for backend in ("cuda", "torch", "torch", "cuda"):
            cfg = dataclasses.replace(s.config, backend=backend)
            fn = functools.partial(H2.enhance_2d, s.problem, cfg, sol.xs,
                                   sol.ys, sol.fem_values, s._shared)
            reps = 2 if (backend, name) == (
                "torch", "variable_coeff_elliptic_2d") else REPS_2D
            recs[backend].append((device_ms(fn, reps=reps)[0],
                                  cuda_ms(fn, reps=reps)))
            torch.cuda.empty_cache()
        emit("routes_2d", run=label, nx=N2D, ny=N2D,
             **{f"{b}_{k}": [r[i] for r in recs[b]]
                for b in recs for i, k in enumerate(("ms", "wall_ms"))})
        del s, sol


def phase_stages_2d(device="cuda"):
    """Where the poisson_2d solve at 1024 x 1024 quads spends its time: one
    HybridSolver2D construction, solve and errors() on the host clock, then
    once more under torch.profiler, read through the solver's spans
    (``models/hybrid2d.py`` SPANS).  The Krylov loop reads one scalar per
    iteration from the card; the profiler's ``aten::item`` /
    ``aten::_local_scalar_dense`` events inside the run say how long the
    host waited there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2

    x, y = points_2d()
    iters = []

    def run():
        s, sol, _ = solve_2d("poisson_2d", device, backend="cuda")
        iters.append(sol.cg_iters)
        return [float(v) for v in s.errors(x, y)]  # synchronises

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    spans = {name: dict(host_ms=0.0, device_ms=0.0) for name in H2.SPANS}
    reads, read_ms = 0, 0.0
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name in spans:
            spans[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
            spans[e.name]["device_ms"] += e.device_time_total / 1e3
        elif e.name == "aten::item":
            reads += 1
            read_ms += e.time_range.elapsed_us() / 1e3
    for name, rec in spans.items():
        check(rec["host_ms"] > 0, f"span {name} not seen by the profiler")
    check(spans["enhance_2d"]["device_ms"] > 0,
          "the profiler attributed no device time to enhance_2d")
    busy = busy_ms(events, skip=H2.SPANS)
    emit("stages_2d", run="poisson_2d", nx=N2D, ny=N2D, wall_ms=wall_ms,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, cg_iters=iters[-1],
         host_reads=reads, host_read_wait_ms=read_ms, spans=spans)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script needs an NVIDIA "
                 "GPU and has no CPU route")
    if not os.path.isdir(os.path.join(ROOT, PKG, "csrc")):
        sys.exit(f"chip_smoke: package {PKG} not found beside {__file__}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())

    phase_build()
    summary = phase_kernels()
    torch.cuda.synchronize()
    summary.update(phase_kernels_2d())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = phase_main_path()
    torch.cuda.synchronize()
    counts.update(phase_main_path_2d(gate_basis="--gate-basis" in sys.argv))
    torch.cuda.synchronize()
    phase_routes_2d()
    phase_stages()
    phase_stages_2d()
    torch.cuda.synchronize()

    check(sorted(summary) == sorted(KERNELS), f"kernels checked: "
          f"{sorted(summary)}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": counts[name],
         **summary[name]}
        for name in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
