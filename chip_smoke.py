"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--gate-basis]
    python3 chip_smoke.py --identity OLD_TREE
    python3 chip_smoke.py --sharded

``--gate-basis`` also solves each 2D, graded 2D, 3D, 2D elasticity,
family and goal-oriented 2D configuration and the 1D eigensolve through
the plain torch route on the card and prints its Linf (eigenvalue error):
the numbers their gates are set from (the biharmonic chains and the mixed
eigensolves print theirs on every run).

``--sharded`` builds the kernels and runs only ``main_path_sharded``
(below), with no summary and no last line.

``--identity OLD_TREE`` runs only the 1D varcoeff kernel of two checkouts
(OLD_TREE's and this one's, each built from its own sources in a process
of its own) on each tree's own main-path inputs (``kernel_inputs``: 2^20
elements, M = 8, C = 12, seed 0): uniform mode with ``f_shifted`` and
graded mode, each with and without diagnostics.  It compares the outputs
bit for bit (``torch.equal``, through ~300 MB in a temporary directory),
takes the kernel's device time in the order old, new, new, old, prints
one JSON line and exits non-zero if any output differs.

Builds the hand-written kernels of ``hybrid_fem_lssvr_tpu_torch/csrc`` with
nvcc (one process per source, in parallel), holds each kernel against its
plain PyTorch version at the main paths' shapes (1D: E = 2^20 elements,
M = 8, 12 collocation points; 2D: 1024 x 1024 quads, M = 6, 6 x 6
collocation points, on a uniform and on a power-law graded mesh; 3D: 128^3
hexes, M = 4, 4^3 collocation points; the 1D kernel also in its family
layout, 128 families of 8,191 elements in one launch, with a seam check
and the 128 single launches it replaces), then drives the 1D solver through
``HybridSolver`` at 2^20 elements and at the reference's 25-node
configuration, the 2D solvers through ``HybridSolver2D`` and
``HybridSolver2DGraded`` at 1024 x 1024 quads and the 3D solver through
``HybridSolver3D`` at 128^3 hexes, 2D elasticity through
``ElasticSolver2D`` at 1024 x 1024 quads (M = 6) and 3D elasticity through
``ElasticSolver3D`` at 64^3 hexes, checks the errors against gates and
shows through the kernels' launch counters that the solves ran on them.
Then ``solve_family`` and ``solve_groups`` (one launch a family),
``adaptive_solve`` and ``goal_adaptive_solve`` from 2^16 + 1 nodes (one
graded-mode launch a solve), ``HybridSolver3DGraded`` at 64^3, the 3D
adaptive and goal loops and the 2D goal loop (through graded2d_kernel),
where the family solve spends its time, the semilinear solves (1D at
2^20 elements, 2D at 256^2, 3D at 32^3), the simply-supported biharmonic
chains (1D at 2^20 elements, the plate at 1024^2 quads, the box at 128^3
hexes; two launches a chain, each chain also on the torch route, the plate
and the box once more under torch.profiler), the eigensolves (1D at 1,025
nodes through fused_enhance_shared, the mixed 2D route at 256^2 and 3D at
32^3 through the stacked kernels, each also on the torch route and with a
lifted trace on the same pencil), the clamped beam (E = 1,024) and plate
(64^2) in float64, the 1D, 2D and 3D time marches (heat, wave,
semilinear and adaptive-step; 2^20 elements, 1024^2 quads and 128^3 hexes,
float64, no kernel), with a kill-and-resume of a checkpointed march at
2^20, and the elastodynamics marches (2D at 1024^2 quads, 3D at 64^3
hexes, float64, no kernel).  Last, ``main_path_sharded`` runs the
distributed solves of ``parallel/`` on four ranks that share the card
(gloo): the 1D SPIKE solve at 2^20 elements through separable_kernel and
varcoeff_kernel once a rank, poisson_2d at 1024^2 on y-slabs and on a
2 x 2 grid, the graded 2D solve at 1024^2, poisson_3d at 128^3 on
z-slabs and on a 2 x 2 grid and the graded 3D solve at 64^3; then the 1D
solves on one rank under NCCL.  Each is held against the single-device
solve of the same configuration on the card, and every rank's 1D shard
outputs against its kernel's plain version on that shard's inputs.

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
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "hybrid_fem_lssvr_tpu_torch"
CSRC = f"{PKG}/csrc"
PALLAS = "hybrid_fem_lssvr_tpu/ops/pallas_kernels.py"
# name -> (source in the repo, file:line of the TPU kernel it replaces)
QR_2D = "fused_enhance_varcoeff_2d/qr"
KERNELS = {
    "fused_enhance_separable": (f"{CSRC}/enhance1d.cu", f"{PALLAS}:165"),
    "fused_enhance_shared": (f"{CSRC}/enhance1d.cu", f"{PALLAS}:54"),
    "fused_enhance_varcoeff": (f"{CSRC}/enhance1d.cu", f"{PALLAS}:866"),
    "fused_enhance_stacked_2d": (f"{CSRC}/enhance2d.cu", f"{PALLAS}:490"),
    "fused_enhance_shared_2d": (f"{CSRC}/enhance2d.cu", f"{PALLAS}:341"),
    "fused_enhance_varcoeff_2d": (f"{CSRC}/enhance2d_varcoeff.cu",
                                  f"{PALLAS}:1064"),
    # the same wrapper and TPU kernel, method='qr': varcoeff2d_qr_kernel
    QR_2D: (f"{CSRC}/enhance2d_varcoeff.cu", f"{PALLAS}:1064"),
    "fused_enhance_graded_2d": (f"{CSRC}/enhance2d_graded.cu",
                                f"{PALLAS}:1431"),
    "fused_enhance_stacked_3d": (f"{CSRC}/enhance3d.cu", f"{PALLAS}:652"),
    "fused_enhance_elastic_2d": (f"{CSRC}/enhance2d_elastic.cu",
                                 f"{PALLAS}:1671"),
}

# The card's published peaks (H100 SXM data sheet): device memory rate,
# float32 rate outside the tensor cores and dense TF32 rate of the tensor
# cores.  bound_ms of a kernel is the larger of its bytes (each input read
# once, each output written once) over the first and its operations over
# the second; bound_tc_ms the larger of its bytes over the first and three
# times its operations (3xTF32) over the third.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

# A torch.linalg.lstsq yardstick call that takes longer than this many
# seconds is timed on the largest power-of-two batch that does not and
# scaled linearly (lstsq_ms).
LSTSQ_MAX_S = 2.0

E_MAIN = 1 << 20
M, C = 8, 12
REPS = 20  # timed launches per median
PROFILE_TRIES = 5  # profiles of a call before a dropped record fails it
PROFILE_PAUSE_S = 0.01  # host pause around the timed calls of a profile
TIMED_SPAN = "chip_smoke.timed_calls"
# Host calls of the CUDA runtime and driver that each put one kernel, copy
# or set on the card (device_ms wants a device record for each).
LAUNCH_CALL = re.compile(r"(cu|cuda)(Launch|Memcpy|Memset)")
DENSE_POINTS = (1 << 22) + 1  # evaluation grid of the error gates

# The 2D main path: bench.py's size for the structured-quad solver.
N2D = 1024
M2D = C2D = 6
REPS_2D = 5
POINTS_2D = 1 << 20  # random evaluation points (seed 0) of the 2D gates
TEST_POINTS = 201  # the reference's evaluation grid (25-node config)

# The graded 2D path: 1024 x 1024 quads on the JAX package's power-law mesh
# (cli.py ``_graded_axis_nodes``, power 1.5: the centre quads are 23x
# narrower than the uniform ones), M = C = 6.  Jacobi-CG needs more than
# the default 2000 iterations there.
NG = 1024
GRADED_POWER = 1.5
GRADED_CG_MAXITER = 40000
# The 3D path: 128^3 hexes (E = 2^21), M = C = 4 (the JAX default and
# bench.py's stacked3d shape).
N3D = 128
M3D = C3D = 4
REPS_3D = 5
POINTS_3D = 1 << 20  # random evaluation points (seed 0) of the 3D gates
N3D_VARCOEFF = 32  # variable coefficients: the torch route (no TPU kernel)

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
# agree within 0.97-1.24; the graded 2D slack to 0.77 of its largest value
# (means 1.22-1.23).  The tensor-core kernels (split TF32): the 3D slack to
# 2.0e-3, the elastic slack to 0.017 (M = 6) and 1.8e-3 (M = 4); their bcv
# means are 0.70-0.94 of the plain version's, whose float32 product rounds
# w more coarsely than their k-step sums.  In 2D and 3D, bcv is also
# computed with B scaled by
# 1.5, where it is ~max |bc| / 2 on every quad and not rounding, and held
# quad by quad to BCV_SKEWED_REL of its size (an H100 run gives ~3e-7;
# 2e-6 to 4e-6 for the tensor-core kernels).
SLACK_REL = {"separable_kernel": 1e-3, "shared_kernel": 1e-3,
             "varcoeff_kernel": 2.5, "stacked2d_kernel": 0.6,
             "shared2d_kernel": 1.0, "varcoeff2d_sne_kernel": 1.6,
             "varcoeff2d_qr_kernel": 2.3, "graded2d_kernel": 2.5,
             "stacked3d_kernel": 0.003, "elastic2d_kernel": 0.025}
BCV_REL = 2.0
MEAN_RATIO = (0.66, 1.5)
BCV_SKEWED_REL = 1e-5

T0 = time.monotonic()


def emit(phase, **fields):
    """One JSON line; ``t_s`` is the seconds since the script started, so
    the lines show where its time goes."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.monotonic() - T0}), flush=True)


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


def union_ms(spans, per_ms):
    """Milliseconds covered by the sorted (start, end) intervals, given in
    units of 1/per_ms ms."""
    check(spans, "torch.profiler recorded no device activity")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / per_ms


def read_profile(prof, span_names, count=None):
    """What the stage profiles read from one torch.profiler run, straight
    from its kineto results (``prof.events()`` takes ~20 s to build for a
    trace of 50,000 device operations on the card's host): ({span:
    {host_ms, device_ms}}, device-busy ms, device operations, calls and
    host ms of the CPU op named ``count``).  A span's device ms is what
    ``FunctionEvent.device_time_total`` gives: the device records linked
    to the span's own CPU record or to a record nested in it on its
    thread.  The device-side copies of the spans count neither as
    operations nor as busy time."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    spans = {name: dict(host_ms=0.0, device_ms=0.0) for name in span_names}
    front, found, device = {}, [], []
    calls, call_ms = 0, 0.0
    for e in prof.profiler.kineto_results.events():
        kind, name = e.device_type(), e.name()
        if kind == cuda:
            device.append((e.linked_correlation_id(), e.start_ns(),
                           e.end_ns(), name))
        elif kind == cpu:
            where = (e.start_thread_id(), e.start_ns(), e.end_ns())
            if e.linked_correlation_id() == 0:
                front[e.correlation_id()] = where
            if name in spans:
                spans[name]["host_ms"] += (where[2] - where[1]) / 1e6
                found.append((name, *where))
            elif name == count:
                calls += 1
                call_ms += (where[2] - where[1]) / 1e6
    for link, start, end, _ in device:
        if link not in front:
            continue
        thread, lo, hi = front[link]
        for name, t, a, b in found:
            if t == thread and a <= lo and hi <= b:
                spans[name]["device_ms"] += (end - start) / 1e6
    ops = sorted((a, b) for _, a, b, name in device if name not in spans)
    for name, rec in spans.items():
        check(rec["host_ms"] > 0, f"span {name} not seen by the profiler")
    return spans, union_ms(ops, 1e6), len(ops), calls, call_ms


def read_timed(prof, kernel=None):
    """The records of device_ms's timed calls, read straight from the
    profile's kineto results (see read_profile): {correlation id: (name,
    thread)} of the host calls that put work on the card (LAUNCH_CALL)
    inside the TIMED_SPAN host span, the (correlation id, start ns, end ns)
    of their device records, and the (start ns, end ns) of those of the
    CUDA kernel named ``kernel`` (its demangled name)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    lo, hi = next((e.start_ns(), e.end_ns()) for e in events
                  if e.name() == TIMED_SPAN and e.device_type() != cuda)
    calls = {e.correlation_id(): (e.name(), e.start_thread_id())
             for e in events
             if e.device_type() != cuda and LAUNCH_CALL.match(e.name())
             and lo <= e.start_ns() <= hi}
    timed, own = [], []
    for e in events:
        if (e.device_type() == cuda and e.correlation_id() in calls
                and not e.is_user_annotation()):
            timed.append((e.correlation_id(), e.start_ns(), e.end_ns()))
            if (kernel is not None
                    and f"{kernel}<" in torch._C._demangle(e.name())):
                own.append(timed[-1][1:])
    return calls, timed, own


class IncompleteProfile(RuntimeError):
    """Every profile of a call lost a device record (device_ms)."""


def device_ms(fn, kernel=None, reps=REPS, launches=1):
    """(busy, kernel) device milliseconds per fn() call, averaged over
    ``reps`` calls under torch.profiler: busy is the union of the intervals
    in which fn's kernels and copies ran on the card (host launch overhead
    excluded); kernel is the time of the CUDA kernel named ``kernel`` alone,
    summed over its ``launches`` launches a call (None without a name).
    Each profile runs fn once before the timed calls and once after them, a
    host pause of PROFILE_PAUSE_S apart; the
    timed calls are the host calls that put work on the card (LAUNCH_CALL)
    inside their host span, and their device records are those with the
    same correlation ids (a window in time held too few records in every
    profile of one long call).  The tracer now and then drops a device
    record, so a profile is complete when every timed host call has its
    record and the named kernel was seen ``launches`` times a call (a
    library may pick another kernel from one call to the next, as cuBLAS
    does); an incomplete one is reported on stderr and taken again, and after
    PROFILE_TRIES incomplete profiles the run fails."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
            with record_function(TIMED_SPAN):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAUSE_S)
            fn()
            torch.cuda.synchronize()
        calls, timed, own = read_timed(prof, kernel)
        missing = collections.Counter(
            name for name, _ in calls.values()) - collections.Counter(
                calls[c][0] for c, _, _ in timed)
        if (calls and not missing
                and (kernel is None or len(own) == reps * launches)):
            kernel_ms = (None if kernel is None else
                         sum(b - a for a, b in own) / 1e6 / reps)
            return union_ms(sorted((a, b) for _, a, b in timed),
                            1e6) / reps, kernel_ms
        recorded = {c for c, _, _ in timed}
        lost = [call for c, call in calls.items() if c not in recorded][:8]
        print(f"device_ms: profile {attempt} of {kernel or 'a call'} "
              f"incomplete: {len(timed)} device records for {len(calls)} "
              f"launch calls, {len(own)} of {kernel}; calls without a "
              f"record: {dict(missing)}; (call, thread): {lost}",
              file=sys.stderr, flush=True)
    raise IncompleteProfile(f"device_ms: {PROFILE_TRIES} incomplete "
                            f"profiles of {kernel or 'a call'} in {reps} "
                            f"calls")


def library_ms(fn, reps=REPS):
    """(ms, timing) of a library yardstick call: device_ms's busy time
    (timing "profiler"), or, where every profile of the call lost a device
    record, its CUDA-event wall time (cuda_ms, timing "cuda_events": it
    adds the host's launch overhead, microseconds against the milliseconds
    timed here).  On an H100 with PyTorch 2.11 and CUDA 12.8 every profile
    of the 3D torch.mm lost two of its twenty kernel records.  The port's
    own kernels are always timed by device_ms."""
    try:
        return device_ms(fn, reps=reps)[0], "profiler"
    except IncompleteProfile as err:
        print(f"library_ms: {err}; timed with CUDA events instead",
              file=sys.stderr, flush=True)
        return cuda_ms(fn, reps=reps), "cuda_events"


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


def emit_ptxas(name, kname):
    """The registers, spills and template arguments ptxas reports for every
    compiled variant of the kernel ``kname``."""
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    emit("ptxas", name=name, rows=[
        r for r in cuda_lib.ptxas_summary(cuda_lib.build_log())
        if r["kernel"] == kname])


def emit_launch_shape(name, kname, query, shapes=None):
    """The ptxas rows of the persistent kernel ``kname`` and its launch
    shape at every compiled (M, C) of ``shapes`` (the 2D ones by default):
    dynamic shared memory a block, blocks resident on the card, and blocks
    and warps resident an SM.  ``query(device, M, C, &smem, &blocks,
    &threads)`` is its source's C entry point.  Fails where ptxas reports a
    spill or a stack frame for the kernel at any shape."""
    import ctypes

    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    shapes = K2.SHAPES if shapes is None else shapes
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for M_, C_ in shapes:
        smem, blocks, threads = (ctypes.c_int(0) for _ in range(3))
        err = query(dev, M_, C_, ctypes.byref(smem), ctypes.byref(blocks),
                    ctypes.byref(threads))
        check(err == 0, f"{kname}: launch shape of M={M_}, C={C_}: CUDA "
              f"error {err}")
        per_sm = blocks.value // sms
        out.append(dict(M=M_, C=C_, smem_bytes=smem.value,
                        resident_blocks=blocks.value, blocks_per_sm=per_sm,
                        warps_per_sm=per_sm * threads.value // 32))
    rows = [r for r in cuda_lib.ptxas_summary(cuda_lib.build_log())
            if r["kernel"] == kname]
    emit("ptxas", name=name, rows=rows)
    check(sorted((r["M"], r["C"]) for r in rows) == sorted(shapes),
          f"{kname}: ptxas rows for {[(r['M'], r['C']) for r in rows]}, "
          f"compiled shapes {list(shapes)}")
    for r in rows:
        check(r.get("stack_frame", 0) == 0 and r.get("spill_stores") == 0
              and r.get("spill_loads") == 0, f"{kname} at M={r['M']}, "
              f"C={r['C']}: {r.get('stack_frame')} bytes of stack, "
              f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes of "
              f"spill stores / loads")
    emit("launch_shape", name=name, kernel=kname, shapes=out)


def lstsq_ms(name, G, g):
    """Device ms of one torch.linalg.lstsq(G, g[..., None]) over the batch
    of systems G [E, rows, K], g [E, rows]: the yardstick of a per-element
    least-squares kernel (the port never calls it).  Where the batch does
    not fit in memory, or one call takes longer than LSTSQ_MAX_S, the
    largest power-of-two batch that does is timed and the time scaled
    linearly to E.  Prints the call on a ``library`` line."""
    import torch

    E = G.shape[0]
    b = E
    while True:
        try:
            call = functools.partial(torch.linalg.lstsq, G[:b],
                                     g[:b, :, None])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            if time.perf_counter() - t0 <= LSTSQ_MAX_S or b == 1:
                ms, timing = library_ms(call, reps=REPS_2D)
                ms *= E / b
                break
        except torch.cuda.OutOfMemoryError:
            pass
        del call
        torch.cuda.empty_cache()
        b = 1 << ((b - 1).bit_length() - 1)  # the power of two below b
    emit("library", name=name, call=f"torch.linalg.lstsq({list(G.shape)}, "
         f"{list(g.shape) + [1]})", timed_batch=b, scaled=b < E,
         library_ms=ms, timing=timing)
    return ms


def bound(nbytes, flops):
    """The least time the card could take: bound_ms (and bound_by) at the
    float32 rate of the CUDA cores, bound_tc_ms with the contractions on the
    tensor cores in 3xTF32 (three TF32 products per product)."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_tc_ms=max(by_bytes, 3 * flops / PEAK_TF32_FLOPS * 1e3))


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
                if (r.get("M"), r.get("C")) in ((M, C), (M2D, C2D),
                                                 (M3D, C3D))])


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
    values, where w is the rhs part alone (RHS_REL_TOL).  Also the ptxas
    rows and launch shapes of the persistent varcoeff_kernel."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import problems
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    emit_launch_shape(
        "fused_enhance_varcoeff", "varcoeff_kernel",
        cuda_lib.load("enhance1d").enhance1d_varcoeff_launch_shape,
        K.SHAPES)
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
        bounds = bound(*work_1d(name, E_MAIN))
        emit("kernel", name=name, variant=variant, E=E_MAIN, M=M, C=C,
             max_abs_err=max(errs), rhs_size=size, rhs_rel_err=rhs_rel,
             ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, **bounds,
             wall_ms=cuda_ms(kern), plain_wall_ms=cuda_ms(plain), **diag)
        summary.setdefault(name, dict(
            max_abs_err=max(errs), rhs_rel_err=rhs_rel, ms=ms,
            kernel_ms=kernel_ms, plain_ms=plain_ms, **bounds,
            library_ms=None))
    # One PyTorch call that does a kernel's contraction on inputs already
    # sampled (a yardstick; the port never calls it): w = [WfF^T, Wbc] [a; bc]
    # for the separable kernel, w = [Wf, Wbc] [f; bc] for the shared one;
    # for the per-element QR, torch.linalg.lstsq of the elements' systems.
    bc = torch.stack([fem[:-1], fem[1:]])
    a = K._sample_separable(fem, pois.f_elem_factors, -1.0, h)
    f = K._sample_shared(fem, pois.f, -1.0, h, C, pois.f_shifted)
    for name, O, z in (
            ("fused_enhance_separable",
             torch.cat([ops.WfF.T, ops.Wbc], dim=1), torch.cat([a, bc])),
            ("fused_enhance_shared",
             torch.cat([ops.Wf, ops.Wbc], dim=1), torch.cat([f, bc]))):
        O, z = O.contiguous(), z.contiguous()
        summary[name]["library_ms"], timing = library_ms(
            functools.partial(torch.mm, O, z))
        emit("library", name=name, call=f"torch.mm({list(O.shape)}, "
             f"{list(z.shape)})", library_ms=summary[name]["library_ms"],
             timing=timing)
    del O, z, a, f
    G, g = K.varcoeff_least_squares_system(fem, vc, host, -1.0, h, C,
                                           f_shifted_fn=vc.f_shifted)
    summary["fused_enhance_varcoeff"]["library_ms"] = lstsq_ms(
        "fused_enhance_varcoeff", G, g)
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
    spans, busy, _, _, _ = read_profile(prof, H.SPANS)
    check(spans["lssvr_enhance"]["device_ms"] > 0,
          "the profiler attributed no device time to lssvr_enhance")
    host_total = sum(r["host_ms"] for r in spans.values())
    tri = spans["fem_solve.tridiag"]
    emit("stages", run=label, E=E_MAIN, wall_ms=wall_ms,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, spans=spans,
         tridiag_host_share=tri["host_ms"] / host_total,
         tridiag_device_share=tri["device_ms"] / busy)


# ------------------------------------------------------------ 2D phases

def nodal_grid_2d(problem, device, n=None):
    """Nodal values for the kernel checks: the exact solution on the
    (n + 1)^2 nodes (n = N2D by default) plus noise on the interior ones,
    float32 (seed 0)."""
    import torch

    n = n or N2D
    g = torch.Generator().manual_seed(0)
    xs = torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64)
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    u = problem.exact(X, Y).clone()
    u[1:-1, 1:-1] += 1e-3 * torch.randn(n - 1, n - 1, generator=g,
                                        dtype=torch.float64)
    return u.to(device=device, dtype=torch.float32).contiguous()


def check_kernel_against_plain(tag, wrapper, ref, kname, nodal, args, kw,
                               w_shape, w_tol, ratio_range, skewed_args,
                               rhs_args):
    """A 2D or 3D kernel's wrapper against its plain version, whose
    arguments after the nodal values are ``args``: w (of shape
    ``w_shape``), bcv and the slack in magnitude (``ratio_range``; None
    without diagnostics); the diagnostics relative to their own size; bcv
    again on ``skewed_args`` (B scaled by 1.5); and w on zero nodal values
    with ``rhs_args`` (zero boundary data), where it is the rhs part alone.
    Returns the record of the comparisons."""
    import torch

    got, want = wrapper(nodal, *args, **kw), ref(nodal, *args, **kw)
    torch.cuda.synchronize()
    check(tuple(got[0].shape) == tuple(want[0].shape) == w_shape,
          f"{tag}: w shape {tuple(got[0].shape)}, plain version "
          f"{tuple(want[0].shape)}, expected {w_shape}")
    check(bool(torch.isfinite(got[0]).all()), f"{tag}: non-finite w")
    err = max_err(got[0], want[0])
    check(err <= w_tol, f"{tag}: w max abs err {err} > {w_tol}")
    rec = dict(max_abs_err=err, slack_ratio=None)
    if ratio_range is not None:
        bcv_err = max_err(got[2], want[2])
        check(bcv_err <= 1e-5, f"{tag}: bcv max abs err {bcv_err}")
        rec["slack_ratio"] = float(got[1].max()) / float(want[1].max())
        check(ratio_range[0] < rec["slack_ratio"] < ratio_range[1],
              f"{tag}: slack ratio {rec['slack_ratio']}")
        for what, i, rel in (("slack", 1, SLACK_REL[kname]),
                             ("bcv", 2, BCV_REL)):
            rec.update(check_diagnostic(tag, what, got[i], want[i], rel))
        del got, want
        got_b, want_b = (fn(nodal, *skewed_args, **kw)[2]
                         for fn in (wrapper, ref))
        size = float(want_b.max())
        check(float(want_b.median()) > 1e-3,
              f"{tag}: scaling B left bcv at {size}")
        rec["bcv_skewed_rel_err"] = max_err(got_b, want_b) / size
        check(rec["bcv_skewed_rel_err"] <= BCV_SKEWED_REL,
              f"{tag}: bcv with B scaled by 1.5 differs from the plain "
              f"version by {rec['bcv_skewed_rel_err']} of its size {size} "
              f"(> {BCV_SKEWED_REL})")
        del got_b, want_b
    else:
        check(got[1] is None and got[2] is None,
              f"{tag}: diagnostics returned without being asked for")
        del got, want
    zero = torch.zeros_like(nodal)
    w_rhs = wrapper(zero, *rhs_args, **kw)[0]
    w_rhs_plain = ref(zero, *rhs_args, **kw)[0]
    rec["rhs_size"] = float(w_rhs_plain.abs().max())
    check(rec["rhs_size"] > 0, f"{tag}: the plain version's rhs part is zero")
    rec["rhs_rel_err"] = max_err(w_rhs, w_rhs_plain) / rec["rhs_size"]
    check(rec["rhs_rel_err"] <= RHS_REL_TOL, f"{tag}: rhs part of w differs "
          f"from the plain version by {rec['rhs_rel_err']} of its size "
          f"{rec['rhs_size']} (> {RHS_REL_TOL})")
    return rec


def emit_launch_shapes_2d():
    """The ptxas rows of the two tensor-core 2D kernels, each with its
    dynamic shared memory a block and its blocks resident on the card at
    every compiled shape, with and without diagnostics."""
    import ctypes

    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    lib = cuda_lib.load("enhance2d")
    for kind, (name, kname) in enumerate((
            ("fused_enhance_stacked_2d", "stacked2d_kernel"),
            ("fused_enhance_shared_2d", "shared2d_kernel"))):
        shapes = []
        for M_, C_ in K2.SHAPES:
            for diag in (1, 0):
                smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
                err = lib.enhance2d_launch_shape(
                    kind, torch.cuda.current_device(), M_, C_, diag,
                    ctypes.byref(smem), ctypes.byref(blocks))
                check(err == 0, f"{kname}: launch shape of M={M_}, C={C_}, "
                      f"diag={diag}: CUDA error {err}")
                shapes.append(dict(M=M_, C=C_, diag=diag,
                                   smem_bytes=smem.value,
                                   resident_blocks=blocks.value))
        emit_ptxas(name, kname)
        emit("launch_shape", name=name, kernel=kname, shapes=shapes)


def phase_kernels_2d(device="cuda"):
    """Each 2D kernel's public wrapper against its plain version on the
    same inputs at 1024 x 1024 quads: on main-path-shaped nodal values
    (tolerances of tests/test_pallas.py: w 2e-5 stacked, 1e-5 shared, 3e-5
    per-element; bcv 1e-5; the slack in magnitude; the diagnostics also
    relative to their own size, see SLACK_REL), and on zero nodal values
    with zero boundary data, where w is the rhs part alone (RHS_REL_TOL).
    Also the ptxas rows and launch shapes of the tensor-core kernels and of
    the per-element ones, the torch.mm yardsticks and the
    torch.linalg.lstsq one of the per-element kernels."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    emit_launch_shapes_2d()
    lib = cuda_lib.load("enhance2d_varcoeff")
    emit_launch_shape("fused_enhance_varcoeff_2d", "varcoeff2d_sne_kernel",
                      lib.enhance2d_varcoeff_sne_launch_shape)
    emit_launch_shape("fused_enhance_varcoeff_2d", "varcoeff2d_qr_kernel",
                      lib.enhance2d_varcoeff_launch_shape)

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
        rec = check_kernel_against_plain(
            tag, wrapper, ref, kname, nodal, args, kw, (E, M2D * M2D), w_tol,
            rng, args_for(dataclasses.replace(bundle, B=1.5 * bundle.B),
                          problem, problem.g),
            args_for(bundle, problem, zero_g_2d))
        rec["ms"], rec["kernel_ms"] = device_ms(kern, kname, reps=REPS_2D)
        rec["plain_ms"] = device_ms(plain, reps=REPS_2D)[0]
        method = kw.get("method", "sne")
        rec.update(bound(*work_2d(name, method, vops.n_terms)))
        emit("kernel", name=name, variant=variant, nx=N2D, ny=N2D, M=M2D,
             C=C2D, wall_ms=cuda_ms(kern, reps=REPS_2D),
             plain_wall_ms=cuda_ms(plain, reps=REPS_2D), **rec)
        key = QR_2D if variant == "qr" else name
        if key not in summary:  # the first variant of each kernel
            summary[key] = dict(rec, library_ms=None)
    # The yardsticks: one torch.mm of the stacked operator on a prebuilt
    # z = [f; bc]; for the shared kernel, [Wf | Wbc] z (w alone, library_ms)
    # and [W; D W; B W] z with W = [Wf | Wbc] (w, D w and B w in one
    # product, library_all_ms); for the per-element kernels (both methods
    # solve the same systems), one torch.linalg.lstsq of the quads' systems
    # as the plain version builds them.
    f, gedge, pts, _ = K2._shared_inputs(fem_inh, inh.f, inh.g, *tail,
                                         inh.f_shifted)
    z = torch.cat([f, K2._trace_bc(fem_inh, gedge, pts, N2D, N2D)])
    del f
    top = torch.cat([ops.Wf, ops.Wbc], dim=1)
    full = torch.cat([top, torch.cat([ops.Pres, ops.Qres], dim=1)])
    every = torch.cat([top, ops.D @ top, ops.B @ top])
    for name, O, key in (
            ("fused_enhance_stacked_2d", full.contiguous(), "library_ms"),
            ("fused_enhance_shared_2d", top.contiguous(), "library_ms"),
            ("fused_enhance_shared_2d", every.contiguous(),
             "library_all_ms")):
        summary[name][key], timing = library_ms(
            functools.partial(torch.mm, O, z), reps=REPS_2D)
        emit("library", name=name, call=f"torch.mm({list(O.shape)}, "
             f"{list(z.shape)})", **{key: summary[name][key]},
             timing=timing)
    del z, top, full, every
    name = "fused_enhance_varcoeff_2d"
    G, g = K2.varcoeff_least_squares_system(
        fem_vc, vops, vc.a_var, vc.grad_a, vc.f, vc.g, *tail, s2,
        f_shifted_fn=vc.f_shifted)
    summary[name]["library_ms"] = summary[QR_2D]["library_ms"] = lstsq_ms(
        name, G, g)
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


def gate(label, s, sol, pts, gates, shape, maxiter):
    """Shape, finiteness, solve_ok, convergence and the Linf gate."""
    import torch

    check(tuple(sol.coeffs.shape) == shape,
          f"{label}: coeffs shape {tuple(sol.coeffs.shape)}")
    check(bool(torch.isfinite(sol.coeffs).all()), f"{label}: non-finite")
    check(bool(sol.solve_ok.all()), f"{label}: "
          f"{int((~sol.solve_ok).sum())} elements fell back")
    check(sol.cg_iters < maxiter, f"{label}: the coarse solve did not "
          f"converge in {maxiter} iterations")
    t0 = time.perf_counter()
    linf, l2 = (float(v) for v in s.errors(*pts))
    errors_s = time.perf_counter() - t0
    check(linf < gates[label], f"{label}: Linf {linf} >= gate "
          f"{gates[label]}")
    return dict(linf=linf, l2=l2, gate=gates[label], errors_s=errors_s,
                cg_iters=sol.cg_iters, cg_residual=float(sol.cg_residual),
                max_bc_violation=float(sol.bc_violation.max()))


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
    qr_launches = 0  # fused_enhance_varcoeff_2d's, under method='qr'
    for label, name, kw in runs_2d():
        before = dict(K2.launch_counts())
        s, sol, solve_s = solve_2d(name, device, backend="cuda", **kw)
        rec = gate(label, s, sol, (x, y), GATES_2D, (N2D, N2D, M2D, M2D),
                   s.config.cg_maxiter)
        launched = {k: v - before[k] for k, v in K2.launch_counts().items()
                    if v != before[k]}
        check(sum(launched.values()) == 1, f"{label}: launches {launched}")
        if kw.get("varcoeff_method") == "qr":
            qr_launches += launched.get("fused_enhance_varcoeff_2d", 0)
        emit("main_path_2d", run=label, nx=N2D, ny=N2D, solve_s=solve_s,
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
                 **gate("poisson_2d/shared_2d", s, s.solution, (x, y),
                        GATES_2D, (N2D, N2D, M2D, M2D), s.config.cg_maxiter))
        del s, sol
    # The wrapper counts both methods' launches: each record its own.
    counts = dict(K2.launch_counts())
    counts["fused_enhance_varcoeff_2d"] -= qr_launches
    counts[QR_2D] = qr_launches
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
    spans, busy, _, reads, read_ms = read_profile(prof, H2.SPANS,
                                                  count="aten::item")
    check(spans["enhance_2d"]["device_ms"] > 0,
          "the profiler attributed no device time to enhance_2d")
    emit("stages_2d", run="poisson_2d", nx=N2D, ny=N2D, wall_ms=wall_ms,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, cg_iters=iters[-1],
         host_reads=reads, host_read_wait_ms=read_ms, spans=spans)


# ----------------------------------------------- graded 2D and 3D phases

def graded_axis_nodes(n, d0, d1, power):
    """Power-law stretched nodes on [d0, d1], clustered toward the centre
    for power > 1 (a copy of the JAX package's cli._graded_axis_nodes)."""
    import numpy as np

    s = np.linspace(-1.0, 1.0, n + 1)
    t = np.sign(s) * np.abs(s) ** power
    return d0 + 0.5 * (t + 1.0) * (d1 - d0)


def graded_mesh(n=None):
    nodes = graded_axis_nodes(n or NG, -1.0, 1.0, GRADED_POWER)
    return nodes, nodes.copy()


def work_graded_2d(var):
    """(bytes, flops) of fused_enhance_graded_2d at NG x NG quads, (M2D,
    C2D), with diagnostics: G formed once from the five blocks, g from the
    trace, two Gram-Schmidt passes, Q^T g and R, w = Pbc bc + Z y, B w and
    the final residual."""
    E = NG * NG
    M2, C2, Kb = M2D * M2D, C2D * C2D, 4 * M2D - 4
    K = M2 - Kb
    nbytes = 4 * ((NG + 1) ** 2 + 2 * (NG + 1) + 4 * Kb * NG
                  + (4 if var else 1) * C2 * E + E * M2 + 2 * E)
    ops = (5 * C2 * K + 5 * C2 * Kb  # G; g = f / s2 - sum_s c_s AP_s bc
           + 2 * K * K * C2 + C2 * K + K * K // 2  # CGS2, Q^T g, R^-1
           + M2 * (Kb + K) + Kb * M2 + C2 * K)  # w, B w, the residual
    return nbytes, 2 * E * ops


def work_3d():
    """(bytes, flops) of fused_enhance_stacked_3d at N3D^3 hexes, (M3D,
    C3D), with diagnostics: the [M^3 + C^3, C^3 + S] product and B w."""
    E = N3D ** 3
    M3, C3 = M3D ** 3, C3D ** 3
    S = M3 - (M3D - 2) ** 3
    nbytes = 4 * ((N3D + 1) ** 3 + 6 * S * N3D * N3D + C3 * E + E * M3
                  + 2 * E)
    return nbytes, 2 * E * ((M3 + C3) * (C3 + S) + S * M3)


def nodal_grid_graded(problem, xs, ys, device):
    """The exact solution on the graded nodes plus noise on the interior
    ones, float32 (seed 0)."""
    import torch

    g = torch.Generator().manual_seed(0)
    Y, X = torch.meshgrid(torch.tensor(ys), torch.tensor(xs), indexing="ij")
    u = problem.exact(X, Y).clone()
    u[1:-1, 1:-1] += 1e-3 * torch.randn(len(ys) - 2, len(xs) - 2,
                                        generator=g, dtype=torch.float64)
    return u.to(device=device, dtype=torch.float32).contiguous()


def nodal_grid_3d(problem, device, n=None):
    """The exact solution on the (n+1)^3 nodes plus noise on the interior
    ones, float32 (seed 0)."""
    import torch

    n = n or N3D
    g = torch.Generator().manual_seed(0)
    xs = torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64)
    Z, Y, X = torch.meshgrid(xs, xs, xs, indexing="ij")
    u = problem.exact(X, Y, Z)
    u[1:-1, 1:-1, 1:-1] += 1e-3 * torch.randn(n - 1, n - 1, n - 1,
                                              generator=g,
                                              dtype=torch.float64)
    return u.to(device=device, dtype=torch.float32).contiguous()


def zero_g_2d(x, y):
    import torch

    return torch.zeros_like(x + y)


def zero_g_3d(x, y, z):
    import torch

    return torch.zeros_like(x + y + z)


def phase_kernels_graded_2d(device="cuda"):
    """fused_enhance_graded_2d against its plain version at 1024 x 1024
    quads on the power-law mesh, M = C = 6, for variable coefficients (a,
    a_x, a_y sampled) and constant ones (advection): the checks of
    check_kernel_against_plain at tests/test_pallas.py:383's tolerances (w
    3e-5, bcv 1e-5, slack ratio in (0.2, 5)), then device times; the
    kernel's ptxas rows and launch shape; and the torch.linalg.lstsq
    yardstick on the variable-coefficient quads' systems."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d_graded as HG
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG
    from hybrid_fem_lssvr_tpu_torch.utils import cuda_lib

    emit_launch_shape(
        "fused_enhance_graded_2d", "graded2d_kernel",
        cuda_lib.load("enhance2d_graded").enhance2d_graded_launch_shape)
    xs_np, ys_np = graded_mesh()
    xs = torch.tensor(xs_np, dtype=torch.float32, device=device)
    ys = torch.tensor(ys_np, dtype=torch.float32, device=device)
    cfg = Solver2DConfig(M=M2D, n_colloc=C2D, dtype="float32")
    name = "fused_enhance_graded_2d"
    summary = {}
    for pname in ("variable_coeff_elliptic_2d", "advection_diffusion_2d"):
        problem = get_problem_2d(pname)
        gops, (t_int, bpts) = HG.prepare_shared_2d_graded(problem, cfg)
        gops = gops.to(device)
        nodal = nodal_grid_graded(problem, xs_np, ys_np, device)
        tail = (xs, ys, NG, NG, t_int, bpts)
        args = (gops, problem) + tail
        skewed = (dataclasses.replace(gops, B=1.5 * gops.B), problem) + tail
        rhs_only = (gops, dataclasses.replace(problem, g=zero_g_2d)) + tail
        rec = check_kernel_against_plain(
            f"{name}/{pname}", KG.fused_enhance_graded_2d,
            KG.fused_enhance_graded_2d_ref, "graded2d_kernel", nodal, args,
            {}, (NG * NG, M2D * M2D), 3e-5, (0.2, 5.0), skewed, rhs_only)
        kern = functools.partial(KG.fused_enhance_graded_2d, nodal, *args)
        plain = functools.partial(KG.fused_enhance_graded_2d_ref, nodal,
                                  *args)
        rec["ms"], rec["kernel_ms"] = device_ms(kern, "graded2d_kernel",
                                                reps=REPS_2D)
        rec["plain_ms"] = device_ms(plain, reps=2)[0]
        var = problem.a_var is not None
        rec.update(bound(*work_graded_2d(var)))
        emit("kernel", name=name, variant=pname, nx=NG, ny=NG, M=M2D,
             C=C2D, grading=f"power {GRADED_POWER}",
             wall_ms=cuda_ms(kern, reps=REPS_2D),
             plain_wall_ms=cuda_ms(plain, reps=2), **rec)
        if name not in summary:
            G, g = KG.least_squares_system(nodal, *args)
            summary[name] = dict(rec, library_ms=lstsq_ms(name, G, g))
            del G, g
        torch.cuda.empty_cache()
    return summary


def phase_kernels_3d(device="cuda"):
    """fused_enhance_stacked_3d against its plain version at 128^3 hexes,
    M = C = 4, on poisson_3d (g = 0) and poisson_3d_inhomogeneous (g on
    every face), with and without the structured rhs: the checks of
    check_kernel_against_plain at tests/test_pallas.py:274's tolerances
    (w 2e-5, bcv 1e-5, slack ratio in (0.05, 20)), device times, and one
    torch.mm of the stacked operator on a prebuilt z as the yardstick."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import Solver3DConfig, get_problem_3d
    from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3

    n = N3D
    h = 2.0 / n
    geom = (-1.0, h, -1.0, h, -1.0, h)
    cfg = Solver3DConfig(nx=n, ny=n, nz=n, M=M3D, n_colloc=C3D,
                         dtype="float32")
    name = "fused_enhance_stacked_3d"
    emit_ptxas(name, "stacked3d_kernel")
    cases = [("poisson_3d", True, True), ("poisson_3d", False, True),
             ("poisson_3d_inhomogeneous", True, True),
             ("poisson_3d_inhomogeneous", False, True),
             ("poisson_3d_inhomogeneous", True, False)]
    summary, bundles = {}, {}
    for pname, shifted, diag in cases:
        problem = get_problem_3d(pname)
        if pname not in bundles:
            ops, (t_int, spts) = H3.prepare_shared_3d(problem, cfg)
            bundles[pname] = (ops.to(device), t_int, spts,
                              nodal_grid_3d(problem, device))
        ops, t_int, spts, nodal = bundles[pname]
        tail = (geom, n, n, n, t_int, spts)
        args = (ops, problem.f, problem.g) + tail
        kw = dict(with_diagnostics=diag,
                  f_shifted_fn=problem.f_shifted if shifted else None)
        variant = (f"{pname}/{'f_shifted' if shifted else 'f'}"
                   f"{'' if diag else '/no diagnostics'}")
        rec = check_kernel_against_plain(
            f"{name}/{variant}", K3.fused_enhance_stacked_3d,
            K3.fused_enhance_stacked_3d_ref, "stacked3d_kernel", nodal, args,
            kw, (n ** 3, M3D ** 3), 2e-5, (0.05, 20.0) if diag else None,
            (dataclasses.replace(ops, B=1.5 * ops.B), problem.f,
             problem.g) + tail,
            (ops, problem.f, zero_g_3d) + tail)
        kern = functools.partial(K3.fused_enhance_stacked_3d, nodal, *args,
                                 **kw)
        plain = functools.partial(K3.fused_enhance_stacked_3d_ref, nodal,
                                  *args, **kw)
        rec["ms"], rec["kernel_ms"] = device_ms(kern, "stacked3d_kernel",
                                                reps=REPS_3D)
        rec["plain_ms"] = device_ms(plain, reps=REPS_3D)[0]
        rec.update(bound(*work_3d()))
        emit("kernel", name=name, variant=variant, nx=n, ny=n, nz=n, M=M3D,
             C=C3D, wall_ms=cuda_ms(kern, reps=REPS_3D),
             plain_wall_ms=cuda_ms(plain, reps=REPS_3D), **rec)
        if variant == "poisson_3d_inhomogeneous/f_shifted":
            summary[name] = dict(rec, library_ms=None)
        torch.cuda.empty_cache()
    # The yardstick: one torch.mm of the stacked operator on a prebuilt
    # z = [f; bc] (the main path's inputs, sampled beforehand).
    problem = get_problem_3d("poisson_3d_inhomogeneous")
    ops, t_int, spts, nodal = bundles["poisson_3d_inhomogeneous"]
    f, gface, pts = K3._inputs(nodal, ops, problem.f, problem.g, geom, n, n,
                               n, t_int, spts, problem.f_shifted)
    z = torch.cat([f, K3._trace_bc(nodal, gface, pts, n, n, n)])
    del f
    O = K2._stacked_operator(ops.Wf, ops.Wbc, ops.Pres, ops.Qres,
                             True).contiguous()
    summary[name]["library_ms"], timing = library_ms(
        functools.partial(torch.mm, O, z), reps=REPS_3D)
    emit("library", name=name, call=f"torch.mm({list(O.shape)}, "
         f"{list(z.shape)})", library_ms=summary[name]["library_ms"],
         timing=timing)
    del z, bundles
    torch.cuda.empty_cache()
    return summary


# Linf gates of the new paths: 10x what the port's torch route gives for
# the same configuration on the same card (``--gate-basis``, float32
# enhancement over a float64 coarse solve, on an H100: graded 4.17e-6 and
# 4.41e-6; 3D 3.43e-4 and 6.00e-4, the Q1 nodal floor at h = 1/64; variable
# coefficients at 32^3, which run on the torch route, 5.89e-3).
GATES_GRADED = {
    "poisson_2d": 4.2e-5,
    "variable_coeff_elliptic_2d": 4.5e-5,
}
GATES_3D = {
    "poisson_3d": 3.5e-3,
    "poisson_3d_inhomogeneous": 6e-3,
    "variable_coeff_elliptic_3d": 6e-2,
}


def points_3d():
    import torch

    g = torch.Generator().manual_seed(0)
    pts = torch.rand(3, POINTS_3D, generator=g, dtype=torch.float64) * 2 - 1
    return tuple(p.to(torch.float32) for p in pts)


def solve_graded(name, device, n=None, **kw):
    import torch

    from hybrid_fem_lssvr_tpu_torch import (HybridSolver2DGraded,
                                            Solver2DConfig, get_problem_2d)

    cfg = Solver2DConfig(**dict(dict(M=M2D, n_colloc=C2D, dtype="float32",
                                     fem_dtype="float64",
                                     cg_maxiter=GRADED_CG_MAXITER), **kw))
    xs, ys = graded_mesh(n or NG)
    t0 = time.perf_counter()
    s = HybridSolver2DGraded(get_problem_2d(name), cfg, xs, ys,
                             device=device)
    sol = s.solve()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, sol, time.perf_counter() - t0


def solve_3d(name, device, n=None, **kw):
    import torch

    from hybrid_fem_lssvr_tpu_torch import (HybridSolver3D, Solver3DConfig,
                                            get_problem_3d)

    n = n or N3D
    cfg = Solver3DConfig(**dict(dict(nx=n, ny=n, nz=n, M=M3D, n_colloc=C3D,
                                     dtype="float32", fem_dtype="float64",
                                     precond="mg"), **kw))
    t0 = time.perf_counter()
    s = HybridSolver3D(get_problem_3d(name), cfg, device=device)
    sol = s.solve()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, sol, time.perf_counter() - t0


def phase_main_path_graded_2d(device="cuda", gate_basis=False):
    """The graded 2D path through HybridSolver2DGraded at 1024 x 1024 quads
    on the power-law mesh (Jacobi-CG, float64, then the kernel); returns
    the launch counts of that run.  With ``gate_basis`` each configuration
    is solved once more through the torch route, for its Linf."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG

    x, y = points_2d()
    labels = ("poisson_2d", "variable_coeff_elliptic_2d")
    KG.reset_launch_counts()
    for label in labels:
        before = KG.launch_counts()["fused_enhance_graded_2d"]
        s, sol, solve_s = solve_graded(label, device)
        rec = gate(label, s, sol, (x, y), GATES_GRADED, (NG, NG, M2D, M2D),
                   GRADED_CG_MAXITER)
        launched = KG.launch_counts()["fused_enhance_graded_2d"] - before
        check(launched == 1, f"graded {label}: {launched} kernel launches")
        emit("main_path_graded_2d", run=label, nx=NG, ny=NG,
             grading=f"power {GRADED_POWER}", solve_s=solve_s,
             launched=launched, **rec)
        del s, sol
    counts = KG.launch_counts()
    if gate_basis:
        for label in labels:
            s, sol, solve_s = solve_graded(label, device, backend="torch")
            linf, l2 = (float(v) for v in s.errors(x, y))
            emit("gate_basis_graded_2d", run=label, route="torch", linf=linf,
                 l2=l2, solve_s=solve_s)
            del s, sol
            torch.cuda.empty_cache()
    # GPU (kernel) against CPU (torch route) coefficients at 64 x 64.
    for label in labels:
        gpu = solve_graded(label, device, n=64)[1]
        cpu = solve_graded(label, "cpu", n=64, backend="torch")[1]
        agree = max_err(gpu.coeffs.cpu(), cpu.coeffs)
        check(agree < 3e-5, f"graded {label}: GPU vs CPU coeffs differ "
              f"{agree}")
        check(abs(gpu.cg_iters - cpu.cg_iters) <= 1, f"graded {label}: cg "
              f"iters {gpu.cg_iters} on the GPU, {cpu.cg_iters} on the CPU")
        emit("main_path_graded_2d", run=f"{label}@64",
             gpu_vs_cpu_max_abs=agree, cg_iters=gpu.cg_iters)
    check(counts["fused_enhance_graded_2d"] > 0,
          "fused_enhance_graded_2d was not launched on the graded path")
    emit("launch_counts_graded_2d", **counts)
    return counts


def phase_main_path_3d(device="cuda", gate_basis=False):
    """The 3D path through HybridSolver3D at 128^3 hexes (V-cycle CG,
    float64, then the kernel), and variable coefficients at 32^3 through
    the torch route (no TPU kernel exists for them); returns the launch
    counts of that run.  With ``gate_basis`` the kernel configurations are
    solved once more through the torch route, for their Linf."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3

    pts = points_3d()
    labels = ("poisson_3d", "poisson_3d_inhomogeneous")
    K3.reset_launch_counts()
    for label in labels:
        before = K3.launch_counts()["fused_enhance_stacked_3d"]
        s, sol, solve_s = solve_3d(label, device)
        rec = gate(label, s, sol, pts, GATES_3D,
                   (N3D, N3D, N3D, M3D, M3D, M3D), s.config.cg_maxiter)
        launched = K3.launch_counts()["fused_enhance_stacked_3d"] - before
        check(launched == 1, f"3d {label}: {launched} kernel launches")
        emit("main_path_3d", run=label, n=N3D, precond="mg",
             solve_s=solve_s, launched=launched, **rec)
        del s, sol
    label = "variable_coeff_elliptic_3d"
    before = K3.launch_counts()["fused_enhance_stacked_3d"]
    n = N3D_VARCOEFF
    s, sol, solve_s = solve_3d(label, device, n=n)
    rec = gate(label, s, sol, pts, GATES_3D, (n, n, n, M3D, M3D, M3D),
               s.config.cg_maxiter)
    check(K3.launch_counts()["fused_enhance_stacked_3d"] == before,
          f"{label}: the kernel ran for variable coefficients")
    emit("main_path_3d", run=label, n=n, precond="mg", route="torch",
         solve_s=solve_s, **rec)
    del s, sol
    counts = K3.launch_counts()
    if gate_basis:
        for label in labels:
            s, sol, solve_s = solve_3d(label, device, backend="torch")
            linf, l2 = (float(v) for v in s.errors(*pts))
            emit("gate_basis_3d", run=label, route="torch", linf=linf, l2=l2,
                 solve_s=solve_s)
            del s, sol
            torch.cuda.empty_cache()
    # GPU (kernel) against CPU (torch route) coefficients at 16^3.
    for label in labels:
        gpu = solve_3d(label, device, n=16)[1]
        cpu = solve_3d(label, "cpu", n=16, backend="torch")[1]
        agree = max_err(gpu.coeffs.cpu(), cpu.coeffs)
        check(agree < 3e-5, f"3d {label}: GPU vs CPU coeffs differ {agree}")
        check(abs(gpu.cg_iters - cpu.cg_iters) <= 1, f"3d {label}: cg iters "
              f"{gpu.cg_iters} on the GPU, {cpu.cg_iters} on the CPU")
        emit("main_path_3d", run=f"{label}@16", gpu_vs_cpu_max_abs=agree,
             cg_iters=gpu.cg_iters)
    check(counts["fused_enhance_stacked_3d"] > 0,
          "fused_enhance_stacked_3d was not launched on the 3D path")
    emit("launch_counts_3d", **counts)
    return counts


def phase_routes_new(device="cuda"):
    """The enhancement stage of each new path alone, through its two routes
    on the same nodal values, in turns (kernel, torch, torch, kernel): what
    ``backend='auto'`` chooses between.  ``ms`` is the device-busy time of
    one call, ``wall_ms`` its CUDA-event time with the host's share."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import elastic as EL
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d_graded as HG
    from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3

    s, sol, _ = solve_graded("poisson_2d", device)
    graded = (lambda cfg: functools.partial(
        HG.enhance_2d_graded, s.problem, cfg, sol.xs, sol.ys,
        sol.fem_values, s._shared), s.config, "poisson_2d graded", NG)
    s3, sol3, _ = solve_3d("poisson_3d", device)
    hexes = (lambda cfg: functools.partial(
        H3.enhance_3d, s3.problem, cfg, sol3.xs, sol3.ys, sol3.zs,
        sol3.fem_values, s3._shared), s3.config, "poisson_3d", N3D)
    # The A/B test behind backend='auto' taking the elastic kernel
    # (models/elastic.py _resolve_backend).
    se, sole, _ = solve_elastic("sin_elastic_2d", device, backend="cuda")
    elastic = (lambda cfg: functools.partial(
        EL.enhance_elastic, se.problem, cfg, sole.xs, sole.ys,
        sole.fem_values, se._shared), se.config, "sin_elastic_2d", NE)
    for make, config, label, n in (graded, hexes, elastic):
        recs = {"cuda": [], "torch": []}
        for backend in ("cuda", "torch", "torch", "cuda"):
            fn = make(dataclasses.replace(config, backend=backend))
            reps = 2 if backend == "torch" else REPS_2D
            recs[backend].append((device_ms(fn, reps=reps)[0],
                                  cuda_ms(fn, reps=reps)))
            torch.cuda.empty_cache()
        emit("routes_new", run=label, n=n,
             **{f"{b}_{k}": [r[i] for r in recs[b]]
                for b in recs for i, k in enumerate(("ms", "wall_ms"))})
    del s, sol, s3, sol3, se, sole
    torch.cuda.empty_cache()


def profile_stages(phase, label, solve, pts, span_names, enhance_span,
                   **fields):
    """Where one solve spends its time: ``solve()`` (returning the solver
    and its solution) plus errors() on the host clock, then once more under
    torch.profiler, read through the solver's spans ``span_names``; emits
    the spans, device-busy time, idle share and device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    iters = []

    def run():
        s, sol, _ = solve()
        iters.append(sol.cg_iters)
        return [float(v) for v in s.errors(*pts)]  # synchronises

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    spans, busy, launches, _, _ = read_profile(prof, span_names)
    check(spans[enhance_span]["device_ms"] > 0,
          f"the profiler attributed no device time to {enhance_span}")
    emit(phase, run=label, **fields, wall_ms=wall_ms,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, cg_iters=iters[-1],
         device_ops=launches, spans=spans)


def phase_stages_3d(device="cuda"):
    """Where the poisson_3d solve at 128^3 hexes spends its time
    (``models/hybrid3d.py`` SPANS)."""
    from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3

    profile_stages("stages_3d", "poisson_3d",
                   functools.partial(solve_3d, "poisson_3d", device),
                   points_3d(), H3.SPANS, "enhance_3d", n=N3D)


# ----------------------------------------------------- elasticity phases

# 2D elasticity: ElasticSolver2D at 1024 x 1024 quads, M = C = 6 (the JAX
# default), float32 throughout (the JAX package's elasticity has one dtype,
# coarse CG included), block V-cycle CG.  The kernel checks also run at
# M = C = 4, bench.py's elastic_block_lse shape.  poly_elastic_2d runs at
# 64 x 64, the largest power of two where its float32 coarse CG reaches
# 100 eps(float32): its boundary lift puts the recursive residual's
# rounding floor near that tolerance (48 iterations at 32^2, 393 on a CPU
# and 601 on an H100 at 64^2, none within 1500 at 128^2 and 256^2;
# ROADMAP section 3).  sin_elastic_2d (g = 0) needs 9-11 at every size.
NE = 1024
NE_POLY = 64
ELASTIC_CG_MAXITER = 500  # sin_elastic_2d at 1024^2: a stall fails here
# 3D elasticity: ElasticSolver3D at 64^3 hexes, M = C = 4, float32, torch
# route (the JAX package has no kernel for it).
NE3D = 64
# Linf gates: 2D at 10x the torch route on the same card (--gate-basis);
# bench.py's own gate for its 16^2 configuration (bench.py:265-282: 400
# random points from seed 2, the JAX package measured 0.04990 on its chip);
# 3D at 2x the O(h^2) line through the JAX package's 0.136 at 8^3
# (RESULTS.md:512): 0.136 / 64 * 2.
GATES_ELASTIC = {
    "sin_elastic_2d": 1.5e-2,  # torch route on an H100: 1.524e-3
    "poly_elastic_2d": 6.9e-3,  # at 64^2; torch route: 6.945e-4
    "bench_16": 0.08,
    "sin_elastic_3d": 4.3e-3,
}


def work_elastic_2d(M_, C_):
    """(bytes, flops) of fused_enhance_elastic_2d at NE x NE quads, (M_,
    C_), with diagnostics: w = [Wf | Wbc] [f; bc], D w and B w with B's
    zero blocks skipped (what the kernel does)."""
    n = NE
    E = n * n
    M2, C2, Kb = M_ * M_, C_ * C_, 4 * M_ - 4
    nbytes = 4 * (2 * (n + 1) ** 2 + 2 * 4 * Kb * n + 2 * C2 * E
                  + 2 * M2 * E + 2 * E)
    flops = 2 * E * (2 * M2 * (2 * C2 + 2 * Kb) + 2 * C2 * 2 * M2
                     + 2 * Kb * M2)
    return nbytes, flops


def nodal_grid_elastic(problem, device, n=None):
    """[2, n+1, n+1]: both components' exact displacement on the nodes plus
    noise on the interior ones, float32 (seed 0); n defaults to NE."""
    import torch

    n = n or NE
    g = torch.Generator().manual_seed(0)
    xs = torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64)
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    u = torch.stack([problem.exact1(X, Y), problem.exact2(X, Y)])
    u[:, 1:-1, 1:-1] += 1e-3 * torch.randn(2, n - 1, n - 1, generator=g,
                                           dtype=torch.float64)
    return u.to(device=device, dtype=torch.float32).contiguous()


def phase_kernels_elastic(device="cuda"):
    """fused_enhance_elastic_2d against its plain version at 1024 x 1024
    quads on sin_elastic_2d's nodal grids (and poly_elastic_2d's, g on every
    edge), at M = C = 6 and 4: the checks of check_kernel_against_plain at
    tests/test_pallas.py:423-469's coefficient tolerance (3e-5), a ragged
    5 x 3 mesh, the ptxas summary, device times and one torch.mm of
    [Wf | Wbc] on a prebuilt [f; bc] as the yardstick."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import elastic as EL
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_elastic as KE

    name, kname = "fused_enhance_elastic_2d", "elastic2d_kernel"
    emit_ptxas(name, kname)
    h = 2.0 / NE
    geom = (-1.0, h, -1.0, h)
    summary = {}
    cases = [("sin_elastic_2d", 6, True), ("sin_elastic_2d", 6, False),
             ("poly_elastic_2d", 6, True), ("sin_elastic_2d", 4, True)]
    for pname, M_, diag in cases:
        problem = EL.get_elastic_problem(pname)
        cfg = EL.ElasticConfig2D(nx=NE, ny=NE, M=M_, n_colloc=M_,
                                 dtype="float32")
        ops, (t_int, bpts) = EL.prepare_shared_elastic(problem, cfg)
        ops = ops.to(device)
        nodal = nodal_grid_elastic(problem, device)
        fs, gs = (problem.f1, problem.f2), (problem.g1, problem.g2)
        tail = (geom, NE, NE, t_int, bpts)
        args = (ops, fs, gs) + tail
        kw = dict(with_diagnostics=diag)
        variant = f"{pname}/M={M_}{'' if diag else '/no diagnostics'}"
        rec = check_kernel_against_plain(
            f"{name}/{variant}", KE.fused_enhance_elastic_2d,
            KE.fused_enhance_elastic_2d_ref, kname, nodal, args, kw,
            (NE * NE, 2 * M_ * M_), 3e-5, (0.05, 20.0) if diag else None,
            (dataclasses.replace(ops, B=1.5 * ops.B), fs, gs) + tail,
            (ops, fs, (zero_g_2d, zero_g_2d)) + tail)
        kern = functools.partial(KE.fused_enhance_elastic_2d, nodal, *args,
                                 **kw)
        plain = functools.partial(KE.fused_enhance_elastic_2d_ref, nodal,
                                  *args, **kw)
        rec["ms"], rec["kernel_ms"] = device_ms(kern, kname, reps=REPS_2D)
        rec["plain_ms"] = device_ms(plain, reps=REPS_2D)[0]
        rec.update(bound(*work_elastic_2d(M_, M_)))
        emit("kernel", name=name, variant=variant, nx=NE, ny=NE, M=M_, C=M_,
             wall_ms=cuda_ms(kern, reps=REPS_2D),
             plain_wall_ms=cuda_ms(plain, reps=REPS_2D), **rec)
        if variant == "sin_elastic_2d/M=6":
            summary[name] = dict(rec, library_ms=None)
            # The yardstick: one torch.mm of [Wf | Wbc] [72, 112] on the
            # main path's z = [f; bc] [112, 2^20], sampled beforehand.
            f, gedge, pts = KE._inputs(nodal, fs, gs, *tail)
            z = torch.cat([f] + [K2._trace_bc(nodal[c], gedge[c], pts, NE,
                                              NE) for c in range(2)])
            del f
            O = torch.cat([ops.Wf, ops.Wbc], dim=1).contiguous()
            summary[name]["library_ms"], timing = library_ms(
                functools.partial(torch.mm, O, z), reps=REPS_2D)
            emit("library", name=name, call=f"torch.mm({list(O.shape)}, "
                 f"{list(z.shape)})", library_ms=summary[name]["library_ms"],
                 timing=timing)
            del z
        torch.cuda.empty_cache()
    # A ragged mesh with fewer quads than one block of threads.
    for M_ in (6, 4):
        problem = EL.get_elastic_problem("poly_elastic_2d")
        cfg = EL.ElasticConfig2D(nx=5, ny=3, M=M_, n_colloc=M_,
                                 dtype="float32")
        ops, (t_int, bpts) = EL.prepare_shared_elastic(problem, cfg)
        nodal = nodal_grid_elastic(problem, device, n=5)[:, :4].contiguous()
        args = (nodal, ops.to(device), (problem.f1, problem.f2),
                (problem.g1, problem.g2), (-1.0, 2.0 / 5, -1.0, 2.0 / 3), 5,
                3, t_int, bpts)
        got = KE.fused_enhance_elastic_2d(*args)
        want = KE.fused_enhance_elastic_2d_ref(*args)
        torch.cuda.synchronize()
        errs = [max_err(g, w) for g, w in zip(got, want)]
        check(errs[0] <= 3e-5 and errs[2] <= 1e-5,
              f"{name}/ragged 5x3 M={M_}: w, slack, bcv errors {errs}")
        emit("kernel_ragged", name=name, nx=5, ny=3, M=M_,
             max_abs_err=errs[0], slack_max_abs_err=errs[1],
             bcv_max_abs_err=errs[2])
    return summary


def solve_elastic(name, device, n=None, **kw):
    import torch

    from hybrid_fem_lssvr_tpu_torch import (ElasticConfig2D, ElasticSolver2D,
                                            get_elastic_problem)

    n = n or NE
    cfg = ElasticConfig2D(**dict(dict(nx=n, ny=n, M=M2D, n_colloc=C2D,
                                      dtype="float32", precond="mg",
                                      cg_maxiter=ELASTIC_CG_MAXITER), **kw))
    t0 = time.perf_counter()
    s = ElasticSolver2D(get_elastic_problem(name), cfg, device=device)
    sol = s.solve()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, sol, time.perf_counter() - t0


def solve_elastic_3d(device, n=None, **kw):
    import torch

    from hybrid_fem_lssvr_tpu_torch import (ElasticConfig3D, ElasticSolver3D,
                                            get_elastic_problem_3d)

    n = n or NE3D
    cfg = ElasticConfig3D(**dict(dict(nx=n, ny=n, nz=n, M=M3D, n_colloc=C3D,
                                      dtype="float32", precond="mg",
                                      cg_maxiter=ELASTIC_CG_MAXITER), **kw))
    t0 = time.perf_counter()
    s = ElasticSolver3D(get_elastic_problem_3d("sin_elastic_3d"), cfg,
                        device=device)
    sol = s.solve()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, sol, time.perf_counter() - t0


def gate_elastic(label, s, sol, pts, shape):
    """Shape, finiteness, solve_ok, convergence of the coarse CG (it left
    its loop on the tolerance, 100 eps(float32) of ||b||) and the Linf
    gate."""
    import torch

    check(tuple(sol.coeffs.shape) == shape,
          f"{label}: coeffs shape {tuple(sol.coeffs.shape)}")
    check(bool(torch.isfinite(sol.coeffs).all()), f"{label}: non-finite")
    check(bool(sol.solve_ok.all()), f"{label}: "
          f"{int((~sol.solve_ok).sum())} elements fell back")
    check(sol.cg_iters < s.config.cg_maxiter, f"{label}: the float32 coarse "
          f"CG did not reach its tolerance in {s.config.cg_maxiter} "
          f"iterations (residual {float(sol.cg_residual)})")
    t0 = time.perf_counter()
    linf, l2 = (float(v) for v in s.errors(*pts))
    errors_s = time.perf_counter() - t0
    gate_ = GATES_ELASTIC[label]
    check(linf < gate_, f"{label}: Linf {linf} >= gate {gate_}")
    return dict(linf=linf, l2=l2, gate=gate_, errors_s=errors_s,
                cg_iters=sol.cg_iters, cg_residual=float(sol.cg_residual),
                max_bc_violation=float(sol.bc_violation.max()))


def phase_main_path_elastic(device="cuda", gate_basis=False):
    """2D elasticity through ElasticSolver2D at 1024 x 1024 quads with
    backend='cuda' (sin_elastic_2d and poly_elastic_2d), bench.py's 16^2
    gate configuration, and GPU against CPU coefficients at 64^2; returns
    the launch counts of the 1024^2 runs.  With ``gate_basis`` both are
    solved once more through the torch route, for their Linf."""
    import numpy as np
    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_elastic as KE

    x, y = points_2d()
    runs = (("sin_elastic_2d", NE, {}),
            ("poly_elastic_2d", NE_POLY, dict(cg_maxiter=4000)))
    KE.reset_launch_counts()
    for label, n, kw in runs:
        before = KE.launch_counts()["fused_enhance_elastic_2d"]
        s, sol, solve_s = solve_elastic(label, device, n=n, backend="cuda",
                                        **kw)
        rec = gate_elastic(label, s, sol, (x, y), (2, n, n, M2D, M2D))
        launched = KE.launch_counts()["fused_enhance_elastic_2d"] - before
        check(launched == 1, f"elastic {label}: {launched} kernel launches")
        emit("main_path_elastic", run=label, nx=n, ny=n, M=M2D,
             dtype="float32", precond="mg", solve_s=solve_s,
             launched=launched, **rec)
        del s, sol
        torch.cuda.empty_cache()
    counts = KE.launch_counts()
    # bench.py's gate configuration (float32, M = 6, 16 x 16, 'auto'
    # preconditioner), on the kernel.
    rng = np.random.default_rng(2)
    xq = torch.tensor(rng.uniform(-1, 1, 400), dtype=torch.float32)
    yq = torch.tensor(rng.uniform(-1, 1, 400), dtype=torch.float32)
    s, sol, solve_s = solve_elastic("sin_elastic_2d", device, n=16,
                                    precond="auto", backend="cuda")
    emit("main_path_elastic", run="bench_16", nx=16, ny=16, M=M2D,
         solve_s=solve_s, **gate_elastic("bench_16", s, sol, (xq, yq),
                                         (2, 16, 16, M2D, M2D)))
    if gate_basis:
        for label, n, kw in runs:
            s, sol, solve_s = solve_elastic(label, device, n=n,
                                            backend="torch", **kw)
            linf, l2 = (float(v) for v in s.errors(x, y))
            emit("gate_basis_elastic", run=label, n=n, route="torch",
                 linf=linf, l2=l2, solve_s=solve_s, cg_iters=sol.cg_iters)
            del s, sol
            torch.cuda.empty_cache()
    # GPU (kernel) against CPU (torch route) coefficients at 64 x 64 (poly:
    # 32 x 32, where its float32 CG converges by more than rounding luck).
    for label, n in (("sin_elastic_2d", 64), ("poly_elastic_2d", 32)):
        gpu = solve_elastic(label, device, n=n, backend="cuda")[1]
        cpu = solve_elastic(label, "cpu", n=n, backend="torch")[1]
        agree = max_err(gpu.coeffs.cpu(), cpu.coeffs)
        check(agree < 3e-5, f"elastic {label}: GPU vs CPU coeffs differ "
              f"{agree}")
        check(abs(gpu.cg_iters - cpu.cg_iters) <= 1, f"elastic {label}: cg "
              f"iters {gpu.cg_iters} on the GPU, {cpu.cg_iters} on the CPU")
        emit("main_path_elastic", run=f"{label}@{n}",
             gpu_vs_cpu_max_abs=agree, cg_iters=gpu.cg_iters)
    check(counts["fused_enhance_elastic_2d"] > 0,
          "fused_enhance_elastic_2d was not launched on the elastic path")
    emit("launch_counts_elastic", **counts)
    return counts


def phase_main_path_elastic_3d(device="cuda"):
    """3D elasticity through ElasticSolver3D at 64^3 hexes (block V-cycle
    CG in float32, then the torch enhancement), gated at 2x the O(h^2) line
    through the JAX package's 8^3 error."""
    import torch

    pts = points_3d()
    s, sol, solve_s = solve_elastic_3d(device)
    rec = gate_elastic("sin_elastic_3d", s, sol, pts,
                       (3, NE3D, NE3D, NE3D, M3D, M3D, M3D))
    emit("main_path_elastic_3d", run="sin_elastic_3d", n=NE3D, M=M3D,
         dtype="float32", precond="mg", route="torch", solve_s=solve_s,
         **rec)
    del s, sol
    torch.cuda.empty_cache()


def phase_stages_elastic(device="cuda"):
    """Where the sin_elastic_2d solve at 1024 x 1024 quads spends its time
    (``models/elastic.py`` SPANS), through the kernel."""
    from hybrid_fem_lssvr_tpu_torch.models import elastic as EL

    profile_stages("stages_elastic", "sin_elastic_2d",
                   functools.partial(solve_elastic, "sin_elastic_2d", device,
                                     backend="cuda"),
                   points_2d(), EL.SPANS, "enhance_elastic", nx=NE, ny=NE)

# ------------------------------------------------- families, adaptivity,
# graded 3D and semilinear solves

# The family layout of fused_enhance_varcoeff: P = 128 families of 8,191
# elements (1,048,448 in all, 128 fewer than E_MAIN), M = 8, C = 12.  The
# family main path: the helmholtz family at 128 values of k spread evenly
# over [0.5, 3] and the advection-diffusion family at 64 pairs (eps in
# [0.5, 2], beta in [0, 3]), num_nodes 8192 (the largest mesh tridiag
# 'auto' solves by Thomas), float32 enhancement over a float64 coarse
# stage.
P_FAM, EF_FAM = 128, 8191
REPS_SINGLES = 5  # timed calls of the 128-launch loop
# adaptive_solve on tests/test_adaptive.py's atan layer from 2^16 + 1 nodes
# (four rounds, refine_frac 0.3); goal_adaptive_solve on poisson_1d with
# tests/test_goal.py's Gaussian weight (three rounds), same start.
# The 2D and 3D goal loops hold each round's DWR estimate to the true goal
# error within tests/test_goal.py's 0.35 of it (its first two rounds, as
# there), and the error falls each round.
GOAL_TRACK = 0.35
N_ADAPT = (1 << 16) + 1
# Graded 3D: HybridSolver3DGraded at 64^3 on the power-law mesh (D is
# [E, C^3, M^3], 16 KB an element in float32: 4.3 GB at 64^3, 34 GB at
# 128^3 before the solve's workspace), variable coefficients at 32^3 on the
# autograd path, adaptive_solve_3d from 16^3, goal_adaptive_solve_3d from
# 8^3 and goal_adaptive_solve_2d from 64^2, two rounds each.
NG3D = 64
NG3D_VAR = 32
GRADED3D_CG_MAXITER = 20000
# Semilinear (the JAX package's semilinear solvers have one dtype): 1D in
# float64 (a float32 coarse Newton at 2^20 elements would be the float32
# coarse solve's 0.98 Linf, bench.py:105-109); 2D and 3D in float32, whose
# element Newton takes the gamma-free null-space QR (in float64 the
# per-element Cholesky of I + gamma D^T D loses positive definiteness from
# 128^2 on, in the JAX package's algebra as in the port's).
E_NONLIN = 1 << 20
N2D_NONLIN = 256
N3D_NONLIN = 32
# Linf gates of the new paths, 10x the torch route's Linf on an H100
# (--gate-basis; NVIDIA H100 80GB HBM3, 700.00 W: helmholtz family
# 1.609e-6, advdiff family 1.311e-6, atan layer 1.669e-6, goal poisson
# 9.537e-7, goal 2D 7.761e-4); the graded 3D and semilinear paths run on
# the torch route only, so 10x their own Linf there (poisson_3d graded
# 1.935e-3, variable coefficients 7.99e-3, adaptive 3D 6.13e-3; 1D
# semilinear 1.81e-11, 3.15e-11, 2.23e-11, 4.32e-11; cubic_2d 1.382e-4;
# cubic_3d 1.444e-2).  The 3D goal loop refines from 8^3 toward the goal's
# support only, so its gate is on what it controls, the goal error
# |J(u) - J(u_h)| of its last round: 10x the card's 1.0696e-4.
GATES_NEW = {
    "helmholtz_family": 1.6e-5,
    "advdiff_family": 1.3e-5,
    "atan_layer": 1.7e-5,
    "goal_poisson_1d": 9.5e-6,
    "poisson_3d_graded": 1.9e-2,
    "variable_coeff_elliptic_3d_graded": 8e-2,
    "adaptive_3d": 6.1e-2,
    "goal_3d": 1.1e-3,
    "goal_2d": 7.8e-3,
    "cubic_1d/p1": 1.8e-10,
    "cubic_1d/numerov": 3.1e-10,
    "bratu_1d/p1": 2.2e-10,
    "bratu_1d/numerov": 4.3e-10,
    "cubic_2d": 1.4e-3,
    "cubic_3d": 0.14,
}
# The semilinear solves' final nonlinear collocation residual, 10x the
# card's (3.0e-14 in 1D; 0.730 and 11.52 in 2D and 3D, where it is the
# least-squares floor of the fit, scaling with (2/h)^2, not a convergence
# certificate).
COLLOC_GATES = {"1d": 3e-13, "cubic_2d": 7.3, "cubic_3d": 115.0}
# The last coarse Newton residual against the first: 10x the card's
# largest ratio (3.0e-4, cubic_2d in float32), the rows' rounding over
# the data.
NEWTON_REL = 3e-3


def family_kernel_inputs(device, seam=False):
    """Main-path-shaped family inputs (seed 0): each family's nodal values
    of sin(pi x) plus noise (with ``seam``: plus a jump of +-1e3 p between
    families), the uniform nodes [P, Ef+1] solve_family hands the kernel,
    the helmholtz family at k in [0.5, 3] as one batched problem, and the
    statics at h = 2 / Ef."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import batched as B
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(0)
    x = torch.linspace(-1.0, 1.0, EF_FAM + 1, dtype=torch.float64)
    fem = torch.sin(torch.pi * x)[None] + 1e-3 * torch.randn(
        P_FAM, EF_FAM + 1, generator=g, dtype=torch.float64)
    fem[:, 0] = fem[:, -1] = 0.0
    if seam:
        p = torch.arange(P_FAM, dtype=torch.float64)[:, None]
        fem = fem + 1e3 * p * (1.0 - 2.0 * (p % 2))
    fem = fem.to(device=device, dtype=torch.float32).contiguous()
    nodes = torch.linspace(-1.0, 1.0, EF_FAM + 1, dtype=torch.float32,
                           device=device).expand(P_FAM, EF_FAM + 1)
    ks = torch.linspace(0.5, 3.0, P_FAM, dtype=torch.float32, device=device)
    h = 2.0 / EF_FAM
    host = K.VarCoeffOperators.host(M, C, h).to(device)
    return fem, nodes, ks, B.batched_problem(B.helmholtz_family(), ks), \
        host, h


def phase_kernels_family(device="cuda"):
    """fused_enhance_varcoeff in its family layout (P_FAM x EF_FAM, one
    launch) against the plain version in the same layout: w, cond, the
    diagnostics, the rhs part alone on zero nodal values, and the seam
    check (nodal values jumping by up to 1.3e5 between families: an element
    that read across a family boundary would be off by ~1e3).  Times the
    family launch, its wrapper, and the route it replaces: the 128 P = 1
    launches of EF_FAM elements, one a family."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import batched as B
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    name, kname = "fused_enhance_varcoeff", "varcoeff_kernel"
    E = P_FAM * EF_FAM
    tag = f"{name}/family {P_FAM}x{EF_FAM}"
    fem, nodes, ks, prob, host, h = family_kernel_inputs(device)
    args = (prob, host, -1.0, h, C)
    kern = functools.partial(K.fused_enhance_varcoeff, fem, *args,
                             nodes=nodes)
    plain = functools.partial(K.fused_enhance_varcoeff_ref, fem, *args,
                              nodes=nodes)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(got[0].shape == (E, M), f"{tag}: w shape {got[0].shape}")
    check(bool(torch.isfinite(got[0]).all()), f"{tag}: non-finite w")
    err = max_err(got[0], want[0])
    check(err <= VC_TOL, f"{tag}: w max abs err {err} > {VC_TOL}")
    bcv_err = max_err(got[2], want[2])
    check(bcv_err <= BCV_TOL, f"{tag}: bcv max abs err {bcv_err}")
    rel = float(((got[3] - want[3]).abs() / want[3]).max())
    check(rel <= 1e-3, f"{tag}: cond rel err {rel}")
    ratio = float(got[1].max()) / float(want[1].max())
    check(0.2 < ratio < 5.0, f"{tag}: slack ratio {ratio}")
    rec = dict(max_abs_err=err, bcv_max_abs_err=bcv_err, cond_rel_err=rel,
               slack_ratio=ratio)
    for what, i, rel_ in (("slack", 1, SLACK_REL[kname]),
                          ("bcv", 2, BCV_REL)):
        rec.update(check_diagnostic(tag, what, got[i], want[i], rel_))
    del got, want
    zero = torch.zeros_like(fem)
    w_rhs = K.fused_enhance_varcoeff(zero, *args, nodes=nodes)[0]
    w_rhs_plain = K.fused_enhance_varcoeff_ref(zero, *args, nodes=nodes)[0]
    rec["rhs_size"] = float(w_rhs_plain.abs().max())
    check(rec["rhs_size"] > 0, f"{tag}: the plain version's rhs part is 0")
    rec["rhs_rel_err"] = max_err(w_rhs, w_rhs_plain) / rec["rhs_size"]
    check(rec["rhs_rel_err"] <= RHS_REL_TOL, f"{tag}: rhs part of w differs "
          f"from the plain version by {rec['rhs_rel_err']} of its size")
    del w_rhs, w_rhs_plain, zero
    # The seam check, and each family of the seam case against its own
    # P = 1 launch (the same element arithmetic: bit for bit).
    sfem = family_kernel_inputs(device, seam=True)[0]
    scale = float(sfem.abs().max())
    sgot = K.fused_enhance_varcoeff(sfem, *args, nodes=nodes)
    swant = K.fused_enhance_varcoeff_ref(sfem, *args, nodes=nodes)
    rec["seam_scale"] = scale
    rec["seam_w_rel_err"] = max_err(sgot[0], swant[0]) / scale
    rec["seam_bcv_rel_err"] = max_err(sgot[2], swant[2]) / scale
    check(rec["seam_w_rel_err"] <= VC_TOL and rec["seam_bcv_rel_err"] <=
          BCV_TOL, f"{tag}: seam case differs from the plain version: "
          f"w {rec['seam_w_rel_err']}, bcv {rec['seam_bcv_rel_err']} of "
          f"{scale}")
    coef, he = K._sample_varcoeff(sfem, prob, -1.0, h, C, None, nodes)
    for p in (0, 1, P_FAM // 2, P_FAM - 1):
        rows = slice(p * EF_FAM, (p + 1) * EF_FAM)
        one = K._varcoeff_cuda(sfem[p].contiguous(),
                               coef[:, :, rows].contiguous(),
                               he[rows].contiguous(), host, h, True)
        check(all(torch.equal(g[rows], o) for g, o in zip(sgot, one)),
              f"{tag}: family {p} differs from its own P = 1 launch")
    del sgot, swant, coef, he, sfem
    # Times: the family launch, its plain version, and the route the
    # batching avoids, 128 P = 1 launches (each family's own problem).
    ms, kernel_ms = device_ms(kern, kname)
    plain_ms, _ = device_ms(plain)
    members = [(fem[p].contiguous(), B.helmholtz_family().instantiate(
        float(ks[p])), nodes[p].contiguous()) for p in range(P_FAM)]

    def singles():
        for f_p, prob_p, n_p in members:
            K.fused_enhance_varcoeff(f_p, prob_p, host, -1.0, h, C,
                                     nodes=n_p)

    one_ms, one_kernel_ms = device_ms(functools.partial(
        K.fused_enhance_varcoeff, *members[0][:2], host, -1.0, h, C,
        nodes=members[0][2]), kname)
    singles_busy_ms, singles_kernel_ms = device_ms(
        singles, kname, reps=REPS_SINGLES, launches=P_FAM)
    nbytes, flops = work_1d(name, E)
    bounds = bound(nbytes + 4 * (P_FAM - 1), flops)  # P nodal rows of Ef+1
    rec.update(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
               wall_ms=cuda_ms(kern), plain_wall_ms=cuda_ms(plain),
               single_kernel_ms=one_kernel_ms, single_ms=one_ms,
               singles_kernel_ms=singles_kernel_ms,
               singles_busy_ms=singles_busy_ms,
               singles_wall_ms=cuda_ms(singles, reps=REPS_SINGLES), **bounds)
    emit("kernel", name=name, variant=f"family {P_FAM}x{EF_FAM}", E=E, P=P_FAM,
         Ef=EF_FAM, M=M, C=C, **rec)
    return dict(family_kernel_ms=kernel_ms, family_ms=ms,
                singles_kernel_ms=singles_kernel_ms,
                singles_busy_ms=singles_busy_ms)


def family_linf(sol, points):
    """Linf of every member of a family solution against sin(pi x) at
    ``points`` (the members share their nodes)."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval
    from hybrid_fem_lssvr_tpu_torch.ops import legendre

    nodes = sol.nodes[0]
    x = points.to(device=nodes.device, dtype=nodes.dtype)
    e = ops_eval.locate_elements(nodes, x)
    t = (2.0 * x - nodes[e] - nodes[e + 1]) / (nodes[e + 1] - nodes[e])
    (V,) = legendre.legendre_vandermonde(t, sol.coeffs.shape[-1],
                                         num_derivs=0)
    exact = torch.sin(torch.pi * x)
    return torch.stack([(torch.einsum("xm,xm->x", sol.coeffs[p, e], V)
                         - exact).abs().max()
                        for p in range(sol.coeffs.shape[0])])


def family_runs():
    import torch

    from hybrid_fem_lssvr_tpu_torch import SolverConfig
    from hybrid_fem_lssvr_tpu_torch.models import batched as B

    cfg = SolverConfig(num_nodes=EF_FAM + 1, M=M, gamma=1e4, n_colloc=C,
                       dtype="float32", fem_dtype="float64")
    ks = torch.linspace(0.5, 3.0, P_FAM, dtype=torch.float64)
    eps, beta = torch.meshgrid(torch.linspace(0.5, 2.0, 8,
                                              dtype=torch.float64),
                               torch.linspace(0.0, 3.0, 8,
                                              dtype=torch.float64),
                               indexing="ij")
    pairs = torch.stack([eps.reshape(-1), beta.reshape(-1)], 1)
    return [("helmholtz_family", B.helmholtz_family(), cfg, ks),
            ("advdiff_family", B.advdiff_family(), cfg, pairs)]


def phase_main_path_families(device="cuda", gate_basis=False):
    """solve_family on the helmholtz family (128 values of k) and the
    advection-diffusion family (64 pairs), then solve_groups of both: one
    launch of fused_enhance_varcoeff a family, one a group; every member
    held to sin(pi x) on the dense grid.  Returns the launch counts."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import solve_family, solve_groups
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    name = "fused_enhance_varcoeff"
    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS // 4 + 1,
                           dtype=torch.float32)
    runs = family_runs()
    K.reset_launch_counts()
    for label, family, cfg, thetas in runs:
        before = K.launch_counts()[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_family(family, cfg, thetas, device=device)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launched = K.launch_counts()[name] - before
        check(launched == 1, f"{label}: {launched} launches of {name}")
        P = thetas.shape[0]
        check(tuple(sol.coeffs.shape) == (P, EF_FAM, M),
              f"{label}: coeffs shape {tuple(sol.coeffs.shape)}")
        check(bool(sol.solve_ok.all()), f"{label}: "
              f"{int((~sol.solve_ok).sum())} elements fell back")
        linf = family_linf(sol, dense)
        worst = int(linf.argmax())
        check(bool(torch.isfinite(linf).all())
              and float(linf.max()) < GATES_NEW[label], f"{label}: Linf "
              f"{float(linf.max())} (member {worst}) >= gate "
              f"{GATES_NEW[label]}")
        emit("main_path_families", run=label, P=P, E=EF_FAM, M=M, C=C,
             solve_s=solve_s, launched=launched,
             linf_max=float(linf.max()), linf_worst_member=worst,
             linf_median=float(linf.median()), gate=GATES_NEW[label])
        if gate_basis:
            tsol = solve_family(family, dataclasses.replace(
                cfg, backend="torch"), thetas, device=device)
            emit("gate_basis_families", run=label, route="torch",
                 linf_max=float(family_linf(tsol, dense).max()))
            del tsol
        del sol
        torch.cuda.empty_cache()
    before = K.launch_counts()[name]
    out = solve_groups([(family, cfg, thetas)
                        for _, family, cfg, thetas in runs], device=device)
    launched = K.launch_counts()[name] - before
    check(launched == 2, f"solve_groups: {launched} launches of {name}")
    for (label, *_), group in zip(runs, out):
        check(group.family_name == label, f"group {group.family_name}")
        check(bool(group.solution.solve_ok.all()), f"group {label} fell back")
        linf = float(family_linf(group.solution, dense).max())
        check(linf < GATES_NEW[label], f"group {label}: Linf {linf}")
    emit("main_path_families", run="solve_groups", launched=launched)
    counts = K.launch_counts()
    emit("launch_counts_families", **counts)
    return {name: counts[name]}


def phase_stages_families(device="cuda"):
    """Where the helmholtz family solve (128 x 8,191 elements) spends its
    time: host clock, then torch.profiler through the spans of
    ``models/batched.py`` (the batched float64 Thomas, the assembly, the
    enhancement): each span's host and device time, the device-busy time
    and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hybrid_fem_lssvr_tpu_torch import solve_family
    from hybrid_fem_lssvr_tpu_torch.models import batched as B

    label, family, cfg, thetas = family_runs()[0]

    def run():
        sol = solve_family(family, cfg, thetas, device=device)
        return float(sol.coeffs.abs().max())  # synchronises

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    spans, busy, launches, _, _ = read_profile(prof, B.SPANS)
    emit("stages_families", run=label, P=P_FAM, E=EF_FAM, wall_ms=wall_ms,
         profiled_wall_ms=profiled_ms, device_busy_ms=busy,
         device_idle_share=1.0 - busy / wall_ms, device_ops=launches,
         spans=spans)


def layer_problem():
    """tests/test_adaptive.py's atan layer (alpha = 40, x0 = 0.2) in torch:
    -u'' = f, u = atan(alpha (x - x0))."""
    import math

    import torch

    from hybrid_fem_lssvr_tpu_torch import Problem1D

    alpha, x0 = 40.0, 0.2

    def f(x):
        s = x - x0
        return 2.0 * alpha**3 * s / (1.0 + alpha**2 * s**2) ** 2

    return Problem1D(name="atan_layer", f=f,
                     g_left=math.atan(alpha * (-1.0 - x0)),
                     g_right=math.atan(alpha * (1.0 - x0)),
                     exact=lambda x: torch.atan(alpha * (x - x0)),
                     constant_coeffs=True)


def goal_weight(x):
    """tests/test_goal.py's Gaussian goal weight."""
    import torch

    return torch.exp(-0.5 * ((x - 0.3) / 0.15) ** 2)


def phase_main_path_adaptive(device="cuda"):
    """adaptive_solve on the atan layer from 2^16 + 1 nodes (four rounds)
    and goal_adaptive_solve on poisson_1d (three rounds), float32 through
    the graded mode of fused_enhance_varcoeff: one launch a solve; the
    final Linf within its gate.  Each history's element counts equal the
    torch route's: refine_nodes bisects ceil(frac E) elements whatever the
    indicator, so that checks the loop's bookkeeping, not that the routes
    agree (their slack rounds differently, so they may bisect different
    elements; their nodes are not compared).  Returns the launch counts."""
    import numpy as np
    import torch

    from hybrid_fem_lssvr_tpu_torch import (SolverConfig, adaptive_solve,
                                            goal_adaptive_solve, problems)
    from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K

    name = "fused_enhance_varcoeff"
    cfg = SolverConfig(num_nodes=N_ADAPT, M=M, gamma=1e4, n_colloc=C,
                       dtype="float32", fem_dtype="float64")
    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float32)
    K.reset_launch_counts()
    runs = {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, backend=backend)
        before = K.launch_counts()[name]
        t0 = time.perf_counter()
        res = adaptive_solve(layer_problem(), c, rounds=4, refine_frac=0.3,
                             eval_points=dense, device=device)
        solve_s = time.perf_counter() - t0
        runs[backend] = res
        launched = K.launch_counts()[name] - before
        want = len(res.history) if backend == "cuda" else 0
        check(launched == want, f"adaptive_solve ({backend}): {launched} "
              f"launches, expected {want}")
        check(bool(res.solution.solve_ok.all()),
              f"adaptive_solve ({backend}): elements fell back")
        emit("main_path_adaptive", run="atan_layer", route=backend,
             solve_s=solve_s, launched=launched, history=res.history)
    elements = [[r["elements"] for r in runs[b].history] for b in runs]
    check(elements[0] == elements[1], f"adaptive_solve: elements {elements}")
    linf = runs["cuda"].history[-1]["linf"]
    check(linf < GATES_NEW["atan_layer"], f"atan_layer: Linf {linf} >= "
          f"gate {GATES_NEW['atan_layer']}")
    emit("main_path_adaptive", run="atan_layer", linf=linf,
         torch_route_linf=runs["torch"].history[-1]["linf"],
         gate=GATES_NEW["atan_layer"])
    tq, wq = np.polynomial.legendre.leggauss(400)
    exact_goal = float(np.sum(wq * np.sin(np.pi * tq)
                              * np.exp(-0.5 * ((tq - 0.3) / 0.15) ** 2)))
    goal = {}
    for backend in ("cuda", "torch"):
        c = dataclasses.replace(cfg, backend=backend)
        before = K.launch_counts()[name]
        t0 = time.perf_counter()
        res = goal_adaptive_solve(problems.poisson_1d(), goal_weight, c,
                                  rounds=3, refine_frac=0.3,
                                  exact_goal=exact_goal, device=device)
        solve_s = time.perf_counter() - t0
        goal[backend] = res
        launched = K.launch_counts()[name] - before
        want = 2 * len(res.history) if backend == "cuda" else 0
        check(launched == want, f"goal_adaptive_solve ({backend}): "
              f"{launched} launches, expected {want} (primal and adjoint)")
        sol = res.solution
        u = ops_eval.evaluate(sol.nodes, sol.coeffs,
                              dense.to(sol.nodes.device))
        linf = float((u - torch.sin(torch.pi * dense.to(u.device)))
                     .abs().max())
        check(bool(sol.solve_ok.all()) and bool(res.adjoint.solve_ok.all()),
              f"goal_adaptive_solve ({backend}): elements fell back")
        emit("main_path_adaptive", run="goal_poisson_1d", route=backend,
             solve_s=solve_s, launched=launched, linf=linf,
             history=res.history)
        if backend == "cuda":
            check(linf < GATES_NEW["goal_poisson_1d"], f"goal_poisson_1d: "
                  f"Linf {linf} >= gate {GATES_NEW['goal_poisson_1d']}")
    elements = [[r["elements"] for r in goal[b].history] for b in goal]
    check(elements[0] == elements[1], f"goal_adaptive_solve: {elements}")
    counts = K.launch_counts()
    emit("launch_counts_adaptive", **counts)
    return {name: counts[name]}


def graded_3d_solve(name, n, device, **kw):
    import torch

    from hybrid_fem_lssvr_tpu_torch import (HybridSolver3DGraded,
                                            Solver3DConfig, get_problem_3d)

    problem = get_problem_3d(name)
    if name == "variable_coeff_elliptic_3d":
        problem = dataclasses.replace(problem, grad_a=None)  # autograd
    nodes = graded_axis_nodes(n, -1.0, 1.0, GRADED_POWER)
    cfg = Solver3DConfig(**dict(dict(nx=n, ny=n, nz=n, M=M3D, n_colloc=C3D,
                                     dtype="float32", fem_dtype="float64",
                                     precond="jacobi",
                                     cg_maxiter=GRADED3D_CG_MAXITER), **kw))
    t0 = time.perf_counter()
    s = HybridSolver3DGraded(problem, cfg, nodes, nodes, nodes,
                             device=device)
    sol = s.solve()
    torch.cuda.synchronize()
    return s, sol, time.perf_counter() - t0


def goal_weight_2d(x, y):
    import torch

    return torch.exp(-0.5 * (((x - 0.55) / 0.08) ** 2
                             + ((y - 0.55) / 0.08) ** 2))


def goal_weight_3d(x, y, z):
    import torch

    return torch.exp(-0.5 * (((x - 0.45) ** 2 + (y - 0.45) ** 2
                              + (z - 0.45) ** 2) / 0.15 ** 2))


def exact_goal(weight, exact, dim, n):
    """J(u) = integral of weight * exact over (-1, 1)^dim, Gauss-Legendre
    with n points an axis, in float64 on the host."""
    import numpy as np
    import torch

    tq, wq = np.polynomial.legendre.leggauss(n)
    X = np.meshgrid(*([tq] * dim), indexing="ij")
    W = np.prod(np.meshgrid(*([wq] * dim), indexing="ij"), axis=0)
    X = [torch.as_tensor(v) for v in X]
    return float(np.sum(W * (weight(*X) * exact(*X)).numpy()))


def phase_main_path_graded_3d(device="cuda", gate_basis=False):
    """HybridSolver3DGraded at 64^3 on the power-law mesh (poisson_3d) and
    at 32^3 with variable coefficients through autograd, adaptive_solve_3d
    from 16^3, goal_adaptive_solve_3d from 8^3 and goal_adaptive_solve_2d
    from 64^2 (two rounds each; the 2D loop through graded2d_kernel):
    Jacobi-CG converged, solve_ok, Linf within its gate (the 3D goal loop:
    its last goal error); in both goal loops the goal error falls each
    round and the estimate tracks it within GOAL_TRACK.  Returns the 2D
    loop's launch counts.  With ``gate_basis`` the 2D loop runs once more
    through the torch route, for its Linf (the rest has no kernel)."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                            get_problem_2d, get_problem_3d,
                                            goal_adaptive_solve_2d,
                                            goal_adaptive_solve_3d)
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d_graded as HG2
    from hybrid_fem_lssvr_tpu_torch.models import hybrid3d_graded as HG
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG

    pts = points_3d()
    for label, name, n in (("poisson_3d_graded", "poisson_3d", NG3D),
                           ("variable_coeff_elliptic_3d_graded",
                            "variable_coeff_elliptic_3d", NG3D_VAR)):
        torch.cuda.reset_peak_memory_stats()
        s, sol, solve_s = graded_3d_solve(name, n, device)
        rec = gate(label, s, sol, pts, GATES_NEW, (n, n, n, M3D, M3D, M3D),
                   GRADED3D_CG_MAXITER)
        emit("main_path_graded_3d", run=label, n=n,
             grading=f"power {GRADED_POWER}", route="torch",
             solve_s=solve_s,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **rec)
        del s, sol
        torch.cuda.empty_cache()
    cfg3 = Solver3DConfig(nx=16, ny=16, nz=16, M=M3D, n_colloc=C3D,
                          dtype="float32", fem_dtype="float64",
                          precond="jacobi", cg_maxiter=GRADED3D_CG_MAXITER)
    t0 = time.perf_counter()
    res = HG.adaptive_solve_3d(get_problem_3d("poisson_3d"), cfg3, rounds=2,
                               eval_points=pts, device=device)
    solve_s = time.perf_counter() - t0
    linf = res.history[-1]["linf"]
    check(bool(res.solution.solve_ok.all()), "adaptive_3d: fell back")
    check(res.solution.cg_iters < GRADED3D_CG_MAXITER, "adaptive_3d: CG")
    check(linf < GATES_NEW["adaptive_3d"], f"adaptive_3d: Linf {linf}")
    emit("main_path_graded_3d", run="adaptive_3d", solve_s=solve_s,
         linf=linf, gate=GATES_NEW["adaptive_3d"], history=res.history)
    for label, loop, problem, weight, c, dim in (
            ("goal_3d", goal_adaptive_solve_3d, get_problem_3d("poisson_3d"),
             goal_weight_3d, dataclasses.replace(cfg3, nx=8, ny=8, nz=8), 3),
            ("goal_2d", goal_adaptive_solve_2d, get_problem_2d("poisson_2d"),
             goal_weight_2d, Solver2DConfig(
                 nx=64, ny=64, M=M2D, n_colloc=C2D, dtype="float32",
                 fem_dtype="float64", precond="jacobi",
                 cg_maxiter=GRADED_CG_MAXITER), 2)):
        j_exact = exact_goal(weight, problem.exact, dim, 80 if dim == 3
                             else 200)
        KG.reset_launch_counts()
        t0 = time.perf_counter()
        res = loop(problem, weight, c, rounds=2, exact_goal=j_exact,
                   device=device)
        solve_s = time.perf_counter() - t0
        launched = KG.launch_counts()["fused_enhance_graded_2d"]
        want = 2 * len(res.history) if label == "goal_2d" else 0
        check(launched == want, f"{label}: {launched} launches of "
              f"graded2d_kernel, expected {want}")
        sol = res.solution
        check(bool(sol.solve_ok.all()) and bool(res.adjoint.solve_ok.all()),
              f"{label}: elements fell back")
        check(sol.cg_iters < c.cg_maxiter, f"{label}: CG did not converge")
        q = tuple(v.to(device) for v in (pts if label == "goal_3d"
                                          else points_2d()))
        u = (HG.evaluate_3d_graded(sol, *q) if label == "goal_3d"
             else HG2.evaluate_2d_graded(sol, *q))
        linf = float((u - problem.exact(*q)).abs().max())
        errs = [abs(r["true_error"]) for r in res.history]
        check(all(b < a for a, b in zip(errs, errs[1:])),
              f"{label}: goal errors {errs} do not fall each round")
        for r in res.history[:2]:  # as tests/test_goal.py: the last
            # round may sit where the error crosses zero
            check(abs(r["est_error"] - r["true_error"])
                  < GOAL_TRACK * abs(r["true_error"]), f"{label}: estimate "
                  f"{r['est_error']} against the goal error "
                  f"{r['true_error']}")
        gated = errs[-1] if label == "goal_3d" else linf
        check(gated < GATES_NEW[label], f"{label}: "
              f"{'goal error' if label == 'goal_3d' else 'Linf'} {gated} "
              f">= gate {GATES_NEW[label]}")
        emit("main_path_graded_3d", run=label, solve_s=solve_s,
             launched=launched, linf=linf, exact_goal=j_exact,
             gated="goal_error" if label == "goal_3d" else "linf",
             gate=GATES_NEW[label], cg_iters=sol.cg_iters,
             history=res.history)
        counts = {"fused_enhance_graded_2d":
                  KG.launch_counts()["fused_enhance_graded_2d"]}
        if gate_basis and label == "goal_2d":
            tsol = loop(problem, weight, dataclasses.replace(
                c, backend="torch"), rounds=2, device=device).solution
            emit("gate_basis_graded_3d", run=label, route="torch",
                 linf=float((HG2.evaluate_2d_graded(tsol, *q)
                             - problem.exact(*q)).abs().max()))
    emit("launch_counts_graded_3d", **counts)
    return counts


def phase_main_path_nonlinear(device="cuda"):
    """The semilinear solves: hybrid_solve_semilinear on cubic_1d and
    bratu_1d at 2^20 elements (p1 and numerov; float64), _2d on cubic_2d at
    256^2 and _3d on cubic_3d at 32^3 (float32): the coarse Newton's
    residual history (quadratic, then at rounding), the final nonlinear
    collocation residual, solve_ok and Linf within their gates."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                            SolverConfig)
    from hybrid_fem_lssvr_tpu_torch.models import nonlinear as NL

    cfg1 = SolverConfig(num_nodes=E_NONLIN + 1, M=M, gamma=1e4, n_colloc=C,
                        dtype="float64")
    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float64,
                           device=device)
    pts3 = tuple(v.to(device=device) for v in points_3d())
    pts2 = pts3[:2]
    runs = [(f"{n}/{sch}", functools.partial(
        NL.hybrid_solve_semilinear, getattr(NL, n)(), cfg1, scheme=sch),
        lambda sol: NL.evaluate_semilinear(sol, dense),
        lambda: torch.sin(torch.pi * dense), "1d")
        for n in ("cubic_1d", "bratu_1d") for sch in ("p1", "numerov")]
    cubic2, cubic3 = NL.cubic_2d(), NL.cubic_3d()
    runs.append(("cubic_2d", functools.partial(
        NL.hybrid_solve_semilinear_2d, cubic2, Solver2DConfig(
            nx=N2D_NONLIN, ny=N2D_NONLIN, M=M2D, n_colloc=C2D,
            dtype="float32", cg_maxiter=GRADED_CG_MAXITER)),
        lambda sol: NL.evaluate_semilinear_2d(sol, *pts2),
        lambda: cubic2.exact(*pts2), "cubic_2d"))
    runs.append(("cubic_3d", functools.partial(
        NL.hybrid_solve_semilinear_3d, cubic3, Solver3DConfig(
            nx=N3D_NONLIN, ny=N3D_NONLIN, nz=N3D_NONLIN, M=M3D,
            n_colloc=C3D, dtype="float32",
            cg_maxiter=GRADED3D_CG_MAXITER)),
        lambda sol: NL.evaluate_semilinear_3d(sol, *pts3),
        lambda: cubic3.exact(*pts3), "cubic_3d"))
    for label, solve, evaluate, exact, colloc_key in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve(device=device)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        r = [float(v) for v in sol.newton_residuals]
        colloc = float(sol.colloc_residual)
        linf = float((evaluate(sol) - exact()).abs().max())
        check(bool(sol.solve_ok.all()), f"{label}: elements fell back")
        # quadratic contraction, then down to the rows' float64 rounding
        check(r[1] < 0.3 * r[0] and r[-1] < NEWTON_REL * r[0],
              f"{label}: Newton residuals {r}")
        check(colloc < COLLOC_GATES[colloc_key], f"{label}: collocation "
              f"residual {colloc} >= {COLLOC_GATES[colloc_key]}")
        check(linf < GATES_NEW[label], f"{label}: Linf {linf} >= gate "
              f"{GATES_NEW[label]}")
        emit("main_path_nonlinear", run=label,
             dtype=str(sol.coeffs.dtype).split(".")[-1],
             solve_s=solve_s, newton_residuals=r, colloc_residual=colloc,
             colloc_gate=COLLOC_GATES[colloc_key], linf=linf,
             gate=GATES_NEW[label])
        del sol
        torch.cuda.empty_cache()


# ------------------------------------------- biharmonic and eigen phases

# The simply-supported chains (models/biharmonic.py): two hybrid solves
# each, the second's rhs the first's enhanced polynomials read pointwise
# (READ_CHUNK points at a time), each stage's enhancement through the
# kernel of its dimension: 1D at 2^20 elements (M = 8, C = 12; the chain's
# problems carry no constant_coeffs, so fused_enhance_varcoeff), the plate
# at 1024^2 (M = C = 6, fused_enhance_stacked_2d) and the box at 128^3
# (M = C = 4, fused_enhance_stacked_3d); float32 enhancement, float64
# coarse stage.  The clamped beam (E = 1,024, M = 10, C = 12) and plate
# (64^2, M = C = 10) run in float64 (their solvers refuse float32) on the
# torch route; the plate's Jacobi-CG count grows as h^-2.  The eigensolves
# (models/eigen.py): 1D at 1,025 nodes in float32, k = 4 (the shifted
# problem's enhancement is fused_enhance_shared with f = 0: k rq_iters
# launches), the mixed 2D route at 256^2 (k = 2, 15 iterations) and 3D at
# 32^3 (k = 1, one oversampled vector, 10 iterations: its next eigenvalue,
# the (1,1,2) triple, is twice the first, so each iteration gains 2x, and
# a 3D MG-CG column solve at 32^3 takes ~1.4 s on an H100): float64
# pencil, float32 enhancement through the stacked kernels with
# trace_lift = 0, then the torch route and trace_lift = 6 (the torch route)
# on the same pencil.
E_BIH = 1 << 20
N_BIH2 = 1024
N_BIH3 = 128
E_BEAM = 1024
N_PLATE = 64
M_PLATE = 10
PLATE_CG_MAXITER = 20000
N_EIG1 = 1025
N_EIG2 = 256
N_EIG3 = 32
EIG_ITERS = {"2d": 15, "3d": 10}
# Linf gates of the chains' displacement u, 10x the torch route's on the
# card (the phase runs it every time and prints it; NVIDIA H100 80GB HBM3,
# 700.00 W: 1.073e-6, 2.623e-6, 2.773e-4).
GATES_BIH = {
    "biharmonic_1d": 1.1e-5,
    "biharmonic_2d": 2.6e-5,
    "biharmonic_3d": 2.8e-3,
}
# The clamped solvers' Linf, 10x the card's (7.146e-8; 1.925e-6), and the
# plate's Jacobi-CG count, 10% over the card's 1,132.
GATES_CLAMPED = {"beam": 7.1e-7, "plate": 1.9e-5}
PLATE_CG_GATE = 1250
# max |lambda - exact| over the k eigenvalues, 10x the torch route's
# (--gate-basis for the 1D one; 2.653e-6; 2.000e-4, 1.277e-9; 1.829e-3,
# 7.406e-11).
GATES_EIG = {
    "eigen_1d": 2.7e-5,
    "eigen_2d_mixed": 2.0e-3,
    "eigen_2d_mixed/lift6": 1.3e-8,
    "eigen_3d_mixed": 1.8e-2,
    "eigen_3d_mixed/lift6": 7.4e-10,
}
# Kernel route against torch route on the card: the coefficients within
# ROUTE_REL of their largest (measured at most 1.1e-6 of it: the kernels'
# float32 rounding against cuBLAS's), the mixed eigenvalues within
# ROUTE_LAMS_REL of the largest (measured 3.4e-8).
ROUTE_REL = 1e-5
ROUTE_LAMS_REL = 1e-6


def profiled_busy(run, skip):
    """(profiled wall ms, device-busy ms, device operations, seconds the
    profile took in all) of one run() under torch.profiler, recording the
    device only.  The device records are read straight from the
    profiler's kineto results, leaving out the device-side copies of user
    spans (names in ``skip``): building ``prof.events()`` for a trace of
    50,000 device operations takes ~20 s on the card's host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and e.name() not in skip)
    busy = union_ms(spans, 1e6)
    return wall, busy, len(spans), time.perf_counter() - t_all


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main_path_biharmonic(device="cuda"):
    """solve_biharmonic_1d / _2d / _3d at 2^20 elements, 1024^2 quads and
    128^3 hexes: each chain through the kernels (two launches, one a
    stage; the counts read right after it), then through the torch route,
    both held to the exact u and u'' (Lap u); the routes' coefficients
    side by side; for the plate and the box one more kernel-route chain
    under torch.profiler for the device's busy share.  Returns the launch
    counts."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                            SolverConfig)
    from hybrid_fem_lssvr_tpu_torch.models import biharmonic as BH
    from hybrid_fem_lssvr_tpu_torch.models import hybrid as H1
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
    from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
    from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3

    p1, p2, p3 = (BH.sin_biharmonic_1d(), BH.sin_biharmonic_2d(),
                  BH.sin_biharmonic_3d())
    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float32,
                           device=device)
    pts2 = tuple(v.to(device) for v in points_2d())
    pts3 = tuple(v.to(device) for v in points_3d())

    def linf(evaluate, stage, exact, pts):
        return float((evaluate(stage, *pts) - exact(*pts)).abs().max())

    def eval_1d(s, x):
        return ops_eval.evaluate(s.nodes, s.coeffs, x)

    runs = [
        ("biharmonic_1d", K, "fused_enhance_varcoeff",
         lambda b: BH.solve_biharmonic_1d(p1, SolverConfig(
             num_nodes=E_BIH + 1, M=M, gamma=1e4, n_colloc=C,
             dtype="float32", fem_dtype="float64", backend=b),
             device=device),
         lambda s: (linf(eval_1d, s.u, p1.exact, (dense,)),
                    linf(eval_1d, s.v, p1.exact_d2, (dense,)))),
        ("biharmonic_2d", K2, "fused_enhance_stacked_2d",
         lambda b: BH.solve_biharmonic_2d(p2, Solver2DConfig(
             nx=N_BIH2, ny=N_BIH2, M=M2D, n_colloc=C2D, dtype="float32",
             fem_dtype="float64", backend=b), device=device),
         lambda s: (linf(H2.evaluate_2d, s.u, p2.exact, pts2),
                    linf(H2.evaluate_2d, s.v, p2.exact_lap, pts2))),
        ("biharmonic_3d", K3, "fused_enhance_stacked_3d",
         lambda b: BH.solve_biharmonic_3d(p3, Solver3DConfig(
             nx=N_BIH3, ny=N_BIH3, nz=N_BIH3, M=M3D, n_colloc=C3D,
             dtype="float32", fem_dtype="float64", precond="mg",
             backend=b), device=device),
         lambda s: (linf(H3.evaluate_3d, s.u, p3.exact, pts3),
                    linf(H3.evaluate_3d, s.v, p3.exact_lap, pts3))),
    ]
    spans = H1.SPANS + H2.SPANS + H3.SPANS + BH.SPANS
    counts = {}
    for label, mod, kname, solve, linfs in runs:
        mod.reset_launch_counts()
        sol, solve_s = timed(lambda: solve("cuda"))
        launched = mod.launch_counts()[kname]
        check(launched == 2, f"{label}: {launched} launches of {kname}, "
              f"expected 2 (one a stage)")
        counts[kname] = launched
        for stage in (sol.v, sol.u):
            check(bool(torch.isfinite(stage.coeffs).all()),
                  f"{label}: non-finite coefficients")
            check(bool(stage.solve_ok.all()), f"{label}: "
                  f"{int((~stage.solve_ok).sum())} elements fell back")
        lu, lv = linfs(sol)
        check(lu < GATES_BIH[label], f"{label}: Linf {lu} >= gate "
              f"{GATES_BIH[label]}")
        tsol, torch_s = timed(lambda: solve("torch"))
        tlu, tlv = linfs(tsol)
        agree, scale = {}, {}
        for st in ("v", "u"):
            a, b = getattr(sol, st).coeffs, getattr(tsol, st).coeffs
            agree[st], scale[st] = max_err(a, b), float(b.abs().max())
            check(agree[st] < ROUTE_REL * scale[st], f"{label}: {st}-stage "
                  f"coefficients, kernel against torch route: {agree[st]} "
                  f">= {ROUTE_REL} x {scale[st]}")
        rec = dict(run=label, solve_s=solve_s, launched=launched,
                   linf_u=lu, linf_v=lv, gate=GATES_BIH[label],
                   torch_route_solve_s=torch_s, torch_route_linf_u=tlu,
                   torch_route_linf_v=tlv, kernel_vs_torch_max_abs=agree,
                   coeff_scale=scale)
        if label != "biharmonic_1d":
            rec["cg_iters"] = [sol.v.cg_iters, sol.u.cg_iters]
            del tsol
            torch.cuda.empty_cache()
            wall, busy, ops, prof_s = profiled_busy(lambda: solve("cuda"),
                                                    spans)
            rec.update(profiled_wall_ms=wall, device_busy_ms=busy,
                       device_idle_share=1.0 - busy / (solve_s * 1e3),
                       device_ops=ops, profile_s=prof_s)
        emit("main_path_biharmonic", **rec)
        del sol
        torch.cuda.empty_cache()
    emit("launch_counts_biharmonic", **counts)
    return counts


def phase_main_path_clamped(device="cuda"):
    """The clamped beam (solve_clamped_biharmonic_1d, clamped_sin2_1d at
    E = 1,024, M = 10, C = 12) and the clamped BFS plate
    (solve_clamped_biharmonic_2d, clamped_sin2_2d at 64^2, M = C = 10),
    float64 on the torch route: solve_ok, the nodal Hermite values and
    slopes, Linf within its gate, the plate's Jacobi-CG count within its."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, SolverConfig
    from hybrid_fem_lssvr_tpu_torch.models import biharmonic as BH
    from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval

    pb = BH.clamped_sin2_1d()
    sol, solve_s = timed(lambda: BH.solve_clamped_biharmonic_1d(
        pb, SolverConfig(num_nodes=E_BEAM + 1, M=10, n_colloc=12,
                         dtype="float64"), device=device))
    x = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float64,
                       device=device)
    linf = float((ops_eval.evaluate(sol.nodes, sol.coeffs, x)
                  - pb.exact(x)).abs().max())
    nodal = float((sol.u_nodal - pb.exact(sol.nodes)).abs().max())
    slope = float((sol.up_nodal - pb.exact_d1(sol.nodes)).abs().max())
    check(bool(sol.solve_ok.all()), "beam: elements fell back")
    check(linf < GATES_CLAMPED["beam"], f"beam: Linf {linf} >= gate "
          f"{GATES_CLAMPED['beam']}")
    emit("main_path_clamped", run="beam", E=E_BEAM, M=10, C=12,
         solve_s=solve_s, linf=linf, nodal_linf=nodal, slope_linf=slope,
         max_slack=float(sol.max_slack.max()), gate=GATES_CLAMPED["beam"])
    pp = BH.clamped_sin2_2d()
    sol, solve_s = timed(lambda: BH.solve_clamped_biharmonic_2d(
        pp, Solver2DConfig(nx=N_PLATE, ny=N_PLATE, M=M_PLATE,
                           n_colloc=M_PLATE, dtype="float64",
                           cg_maxiter=PLATE_CG_MAXITER), device=device))
    pts = tuple(v.to(device=device, dtype=torch.float64)
                for v in points_2d())
    linf = float((BH.evaluate_clamped_2d(sol, *pts) - pp.exact(*pts))
                 .abs().max())
    X, Y = torch.meshgrid(sol.xs, sol.ys, indexing="xy")
    nodal = float((sol.u_nodal[..., 0] - pp.exact(X, Y)).abs().max())
    check(bool(sol.solve_ok.all()), "plate: elements fell back")
    check(sol.cg_iters < PLATE_CG_GATE, f"plate: {sol.cg_iters} CG "
          f"iterations >= gate {PLATE_CG_GATE}")
    check(linf < GATES_CLAMPED["plate"], f"plate: Linf {linf} >= gate "
          f"{GATES_CLAMPED['plate']}")
    emit("main_path_clamped", run="plate", n=N_PLATE, M=M_PLATE,
         solve_s=solve_s, linf=linf, nodal_linf=nodal,
         cg_iters=sol.cg_iters, cg_gate=PLATE_CG_GATE,
         cg_residual=float(sol.cg_residual), gate=GATES_CLAMPED["plate"])


def phase_main_path_eigen(device="cuda", gate_basis=False):
    """hybrid_eigensolve (poisson_1d, 1,025 nodes, float32, k = 4: the
    shifted enhancement through fused_enhance_shared, k rq_iters launches),
    hybrid_eigensolve_2d_mixed (poisson_2d, 256^2, k = 2) and _3d_mixed
    (poisson_3d, 32^3, k = 1) with trace_lift = 0 (the stacked kernels, k
    rq_iters launches), each gated on max |lambda - exact|; the counts are
    read right after each.  Then on the same pencil: each 1D pair's
    enhancement on both routes; the mixed enhancement rounds on the torch
    route and with trace_lift = 6.  ``gate_basis`` also runs the whole 1D
    eigensolve on the torch route.  Returns the launch counts."""
    import numpy as np
    import torch

    from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                            SolverConfig, problems)
    from hybrid_fem_lssvr_tpu_torch.models import eigen as EG
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import poisson_2d
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import poisson_3d
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3

    def lam_err(sol, exact):
        return float(np.abs(sol.lams.cpu().numpy() - exact).max())

    def held(label, sol, exact):
        err = lam_err(sol, exact)
        check(bool(torch.isfinite(sol.coeffs).all()), f"{label}: non-finite")
        check(bool(sol.solve_ok.all()), f"{label}: elements fell back")
        check(err < GATES_EIG[label], f"{label}: max |lambda - exact| "
              f"{err} >= gate {GATES_EIG[label]}")
        return err

    counts = {}
    p1 = problems.poisson_1d()
    ec1 = EG.EigenConfig(k=4)
    cfg1 = SolverConfig(num_nodes=N_EIG1, M=M, n_colloc=C, dtype="float32")
    ex1 = EG.exact_eigenvalues(p1, ec1.k)
    K.reset_launch_counts()
    sol, solve_s = timed(lambda: EG.hybrid_eigensolve(
        p1, dataclasses.replace(cfg1, backend="cuda"), ec1, device=device))
    name = "fused_enhance_shared"
    launched = K.launch_counts()[name]
    check(launched == ec1.k * ec1.rq_iters, f"eigen_1d: {launched} "
          f"launches of {name}")
    counts[name] = launched
    err = held("eigen_1d", sol, ex1)
    agree = 0.0
    for j in range(ec1.k):
        u, lam = sol.fem.vectors[:, j], float(sol.fem.lams[j])
        w = [EG.enhance_eigenpair(p1, sol.fem.nodes, lam, u,
                                  dataclasses.replace(cfg1, backend=b))[0]
             for b in ("cuda", "torch")]
        scale = float(w[1].abs().max())
        agree = max(agree, max_err(*w) / scale)
    check(agree < ROUTE_REL, f"eigen_1d: enhancement, kernel against torch "
          f"route: {agree} of the coefficients' size >= {ROUTE_REL}")
    rec = dict(run="eigen_1d", N=N_EIG1, k=ec1.k, solve_s=solve_s,
               launched=launched, lams=sol.lams.tolist(), max_err=err,
               fem_max_err=lam_err(sol.fem, ex1), gate=GATES_EIG["eigen_1d"],
               kernel_vs_torch_enhance_max_rel=agree)
    if gate_basis:
        tsol, torch_s = timed(lambda: EG.hybrid_eigensolve(
            p1, dataclasses.replace(cfg1, backend="torch"), ec1,
            device=device))
        rec.update(torch_route_solve_s=torch_s,
                   torch_route_max_err=lam_err(tsol, ex1))
    emit("main_path_eigen", **rec)

    mixed = [
        ("eigen_2d_mixed", K2, "fused_enhance_stacked_2d", poisson_2d(),
         Solver2DConfig(nx=N_EIG2, ny=N_EIG2, M=M2D, n_colloc=C2D,
                        dtype="float32"),
         EG.EigenConfig(k=2, iters=EIG_ITERS["2d"], trace_lift=0),
         EG.hybrid_eigensolve_2d_mixed, EG._enhance_pairs_2d,
         EG.exact_eigenvalues_2d),
        ("eigen_3d_mixed", K3, "fused_enhance_stacked_3d", poisson_3d(),
         Solver3DConfig(nx=N_EIG3, ny=N_EIG3, nz=N_EIG3, M=M3D,
                        n_colloc=C3D, dtype="float32"),
         EG.EigenConfig(k=1, iters=EIG_ITERS["3d"], oversample=1,
                        trace_lift=0),
         EG.hybrid_eigensolve_3d_mixed, EG._enhance_pairs_3d,
         EG.exact_eigenvalues_3d),
    ]
    for label, mod, name, p, cfg, ec, solve, pairs, exact in mixed:
        ex = exact(p, ec.k)
        mod.reset_launch_counts()
        sol, solve_s = timed(lambda: solve(p, cfg, ec, device=device))
        launched = mod.launch_counts()[name]
        check(launched == ec.k * ec.rq_iters, f"{label}: {launched} "
              f"launches of {name}")
        counts[name] = launched
        err = held(label, sol, ex)
        ksol, kernel_s = timed(lambda: pairs(p, cfg, ec, sol.fem, True))
        tsol, torch_s = timed(lambda: pairs(
            p, dataclasses.replace(cfg, backend="torch"), ec, sol.fem, True))
        lsol, lift_s = timed(lambda: pairs(
            p, cfg, dataclasses.replace(ec, trace_lift=6), sol.fem, True))
        lift_err = held(f"{label}/lift6", lsol, ex)
        lam_agree = max_err(sol.lams, tsol.lams)
        lam_scale = float(tsol.lams.abs().max())
        coeff_agree = max_err(ksol.coeffs, tsol.coeffs)
        coeff_scale = float(tsol.coeffs.abs().max())
        check(lam_agree < ROUTE_LAMS_REL * lam_scale, f"{label}: "
              f"eigenvalues, kernel against torch route: {lam_agree}")
        check(coeff_agree < ROUTE_REL * coeff_scale, f"{label}: "
              f"coefficients, kernel against torch route: {coeff_agree}")
        emit("main_path_eigen", run=label, n=cfg.nx, k=ec.k,
             iters=ec.iters, solve_s=solve_s, launched=launched,
             lams=sol.lams.tolist(), max_err=err,
             fem_max_err=lam_err(sol.fem, ex),
             fem_residuals=sol.fem.residuals.tolist(),
             gate=GATES_EIG[label], kernel_enhance_s=kernel_s,
             torch_route_enhance_s=torch_s,
             torch_route_max_err=lam_err(tsol, ex),
             kernel_vs_torch_lams_max_abs=lam_agree,
             kernel_vs_torch_max_abs=coeff_agree, coeff_scale=coeff_scale,
             lift6_enhance_s=lift_s, lift6_max_err=lift_err,
             lift6_gate=GATES_EIG[f"{label}/lift6"])
        del sol, ksol, tsol, lsol
        torch.cuda.empty_cache()
    emit("launch_counts_eigen", **counts)
    return counts


# ------------------------------------------------------ transient phase

# The time marches (models/transient.py), all in float64: a float32 1D
# march at 2^20 elements loses its answer as the float32 steady coarse
# solve does (bench.py:105-109), and a float32 2D march stops each CG
# solve at 100 float32 eps, far above the march's own error.  1D at 2^20
# elements (M = 8, C = 12), 2D at 1024^2 quads (M = C = 6).  Each march
# takes TR_STEPS steps of DT_TR = 2^-9, a step a march on the 1024^2
# mesh (h = 2^-9) would take, so t_final = 1/32: the depth is cut, not
# the step.  The adaptive marches run TR_ATTEMPTS attempts towards the
# same t_final from their default first step t_final/64.  The small runs
# held against the CPU: 33 nodes and 16^2 quads, 16 steps to t = 0.25.
E_TR = 1 << 20
N_TR = 1024
TR_STEPS = 16
DT_TR = 2.0 ** -9
TR_ATTEMPTS = 32
TR_CHUNK = TR_STEPS // 4  # the kill-and-resume run's chunk
TR_CG_MAXITER = 40000
# Linf against the exact solution at t_final (the enhanced polynomials'
# on the dense grid or POINTS_2D random points where a march has them,
# else the nodal values'), 10x the card's own (NVIDIA H100 80GB HBM3,
# 700.00 W: 7.82e-7, 1.03e-6, 7.93e-7, 3.02e-8, 3.02e-8, 3.45e-6,
# 3.45e-6; 1.27e-6, 7.29e-9, 1.21e-7, 1.21e-7, 1.50e-6, 1.50e-6; the
# adaptive 6.88e-9, 1.25e-6).
GATES_TR = {
    "fem_march": 7.8e-6,
    "fem_march/robin": 1.0e-5,
    "hybrid_march": 7.9e-6,
    "wave_march": 3.0e-7,
    "hybrid_wave_march": 3.0e-7,
    "fem_march_semilinear": 3.5e-5,
    "hybrid_march_semilinear": 3.5e-5,
    "fem_march_2d": 1.3e-5,
    "hybrid_march_2d": 7.3e-8,
    "wave_march_2d": 1.2e-6,
    "hybrid_wave_march_2d": 1.2e-6,
    "fem_march_semilinear_2d": 1.5e-5,
    "hybrid_march_semilinear_2d": 1.5e-5,
    "fem_march_adaptive": 6.9e-8,
    "fem_march_adaptive_2d": 1.2e-5,
}
# The enhanced 1D CN march rides its nodal error (tests/test_transient.py
# :72-89): Linf within HYBRID_FLOOR times the nodal Linf.
HYBRID_FLOOR = 3.0
# GPU against CPU at the small size, float64: nodal values and velocities
# within TR_NODAL_REL of their size, coefficients within TR_COEFF_REL.
TR_NODAL_REL = 1e-12
TR_COEFF_REL = 1e-9


class _Killed(Exception):
    """The simulated kill of the kill-and-resume run."""


def transient_runs():
    """(label, march, problem, mass, keyword arguments) of the phase."""
    return [
        ("fem_march", "fem_march", "heat_1d", "consistent", {}),
        ("fem_march/robin", "fem_march", "heat_robin_1d", "consistent", {}),
        ("hybrid_march", "hybrid_march", "heat_1d", "numerov", {}),
        ("wave_march", "wave_march", "wave_1d", "numerov", {}),
        ("hybrid_wave_march", "hybrid_wave_march", "wave_1d", "numerov",
         {}),
        ("fem_march_semilinear", "fem_march_semilinear",
         "semilinear_heat_1d", "numerov", {}),
        ("hybrid_march_semilinear", "hybrid_march_semilinear",
         "semilinear_heat_1d", "numerov", {}),
        ("fem_march_2d", "fem_march_2d", "heat_2d", "consistent", {}),
        ("hybrid_march_2d", "hybrid_march_2d", "heat_2d", "numerov",
         {"trace_lift": 6}),
        ("wave_march_2d", "wave_march_2d", "wave_2d", "numerov", {}),
        ("hybrid_wave_march_2d", "hybrid_wave_march_2d", "wave_2d",
         "numerov", {"trace_lift": 6}),
        ("fem_march_semilinear_2d", "fem_march_semilinear_2d",
         "semilinear_heat_2d", "numerov", {}),
        ("hybrid_march_semilinear_2d", "hybrid_march_semilinear_2d",
         "semilinear_heat_2d", "numerov", {"trace_lift": 6}),
        ("fem_march_adaptive", "fem_march_adaptive", "heat_1d", None, {}),
        ("fem_march_adaptive_2d", "fem_march_adaptive_2d", "heat_2d", None,
         {}),
    ]


def transient_call(run, device, small=False):
    """One march of ``transient_runs`` through its public function:
    (problem, config, march config or None, solution, nodal velocity or
    None, adaptive result or None)."""
    from hybrid_fem_lssvr_tpu_torch import Solver2DConfig, SolverConfig
    from hybrid_fem_lssvr_tpu_torch.models import transient as TR

    _, march, prob, mass, kw = run
    problem = getattr(TR, prob)()
    if march.endswith("_3d"):
        from hybrid_fem_lssvr_tpu_torch import Solver3DConfig

        n = N_TR3_SMALL if small else N3D
        cfg = Solver3DConfig(nx=n, ny=n, nz=n, M=M3D, n_colloc=C3D,
                             dtype="float64", cg_maxiter=TR_CG_MAXITER)
    elif march.endswith("_2d"):
        n = 16 if small else N_TR
        cfg = Solver2DConfig(nx=n, ny=n, M=M2D, n_colloc=C2D,
                             dtype="float64", cg_maxiter=TR_CG_MAXITER)
    else:
        cfg = SolverConfig(num_nodes=(33 if small else E_TR + 1), M=M,
                           n_colloc=C, gamma=1e4, dtype="float64")
    steps = 16 if small else TR_STEPS
    t_final = 0.25 if small else TR_STEPS * DT_TR
    if mass is None:  # adaptive: the attempt budget, default tolerance
        res = getattr(TR, march)(problem, cfg, t_final=t_final,
                                 max_attempts=(steps if small
                                               else TR_ATTEMPTS),
                                 device=device)
        return problem, cfg, None, res.solution, None, res
    tcfg = TR.TransientConfig(t_final=t_final, n_steps=steps, mass=mass)
    out = getattr(TR, march)(problem, cfg, tcfg, device=device, **kw)
    sol, vel = (out if "wave" in march else (out, None))
    return problem, cfg, tcfg, sol, vel, None


def timed_steps(fn):
    """(fn(), seconds of the whole call, seconds of the first step,
    seconds of the steps after it): the march loop (utils.checkpoint.scan,
    which every march runs) is timed with the card synchronised before its
    first step, after it and after the last, so the call's set-up, initial
    fit and result fall outside it and the later steps overlap as they do
    in a plain run."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.utils import checkpoint as CK

    orig, marks = CK.scan, []

    def scan(step_fn, carry, ts):
        n, i = int(ts.shape[0]), [0]

        def step(c, t):
            if i[0] == 0:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            out = step_fn(c, t)
            i[0] += 1
            if i[0] in (1, n):
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            return out

        return orig(step, carry, ts)

    CK.scan = scan
    try:
        out, whole = timed(fn)
    finally:
        CK.scan = orig
    return out, whole, marks[1] - marks[0], marks[2] - marks[1]


def transient_errors(problem, sol, t, dense, pts2, pts3=None):
    """(nodal Linf, enhanced Linf or None) against problem.exact at t."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import (Solution2D,
                                                            evaluate_2d)
    from hybrid_fem_lssvr_tpu_torch.ops import eval as ops_eval

    if hasattr(sol, "zs"):
        from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import (Solution3D,
                                                                evaluate_3d)

        X, Y, Z = (sol.xs[None, None, :], sol.ys[None, :, None],
                   sol.zs[:, None, None])
        nodal = float((sol.fem_values - problem.exact(X, Y, Z, t))
                      .abs().max())
        if sol.coeffs is None:
            return nodal, None
        z = torch.zeros((), dtype=sol.fem_values.dtype,
                        device=pts3[0].device)
        s3 = Solution3D(sol.xs, sol.ys, sol.zs, sol.fem_values, sol.coeffs,
                        0, z, z, z, z)
        u = evaluate_3d(s3, *pts3)
        return nodal, float((u - problem.exact(*pts3, t)).abs().max())
    if hasattr(sol, "nodes"):
        nodal = float((sol.fem_values - problem.exact(sol.nodes, t))
                      .abs().max())
        if sol.coeffs is None:
            return nodal, None
        u = ops_eval.evaluate(sol.nodes, sol.coeffs, dense)
        return nodal, float((u - problem.exact(dense, t)).abs().max())
    Y, X = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
    nodal = float((sol.fem_values - problem.exact(X, Y, t)).abs().max())
    if sol.coeffs is None:
        return nodal, None
    z = torch.zeros((), dtype=sol.fem_values.dtype, device=dense.device)
    s2 = Solution2D(sol.xs, sol.ys, sol.fem_values, sol.coeffs, 0, z, z, z,
                    z)
    u = evaluate_2d(s2, *pts2)
    return nodal, float((u - problem.exact(*pts2, t)).abs().max())


def rel_diff(a, b):
    return float((a - b.to(a.device)).abs().max()
                 / b.abs().max().clamp(min=1e-300))


def phase_main_path_transient(device="cuda"):
    """Every 1D and 2D time march through its public function on the card
    at full width (1D 2^20 elements, 2D 1024^2 quads, float64, TR_STEPS
    steps of 2^-9): finite values, Linf against the exact solution within
    its gate, the enhanced 1D CN march within HYBRID_FLOOR of its nodal
    error, every CG solve converged; each march once more at a small size
    on the card and on the CPU, to round-off; hybrid_march at 2^20 killed
    after its second checkpoint chunk and resumed, bit for bit the
    uninterrupted checkpointed run and the plain run.  Each full-width
    march reports its whole call, its step loop, the rest of the call
    (set-up, initial fit, result), its first step and the mean of the
    steps after it."""
    import tempfile

    import torch

    from hybrid_fem_lssvr_tpu_torch.models import transient as TR
    from hybrid_fem_lssvr_tpu_torch.utils import checkpoint as CK

    dense = torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float64,
                           device=device)
    pts2 = tuple(v.to(device=device, dtype=torch.float64)
                 for v in points_2d())
    kept = {}
    for run in transient_runs():
        label, march = run[0], run[1]
        (problem, cfg, tcfg, sol, vel, res), solve_s, first_s, later_s = \
            timed_steps(lambda: transient_call(run, device))
        n = TR_STEPS if res is None else TR_ATTEMPTS
        t_end = float(res.t_reached) if res is not None else sol.t_final
        check(bool(torch.isfinite(sol.fem_values).all())
              and (sol.coeffs is None
                   or bool(torch.isfinite(sol.coeffs).all())),
              f"{label}: non-finite values")
        nodal, linf = transient_errors(problem, sol, t_end, dense, pts2)
        err = nodal if linf is None else linf
        loop_ms = (first_s + later_s) * 1e3
        rec = dict(run=label, steps=n, solve_s=solve_s,
                   setup_ms=solve_s * 1e3 - loop_ms, loop_ms=loop_ms,
                   first_step_ms=first_s * 1e3,
                   later_step_ms=later_s * 1e3 / (n - 1),
                   nodal_linf=nodal, linf=linf, gate=GATES_TR.get(label))
        if march.endswith("_2d"):
            rec.update(n=N_TR, cg_iters=sol.cg_iters)
            check(sol.cg_iters < TR_CG_MAXITER, f"{label}: a CG solve did "
                  f"not converge in {TR_CG_MAXITER} iterations")
        else:
            rec.update(E=E_TR)
        if res is None:
            rec.update(dt=DT_TR, t_final=sol.t_final)
        else:
            rec.update(t_final=sol.t_final, t_reached=t_end,
                       accepted=int(res.accepted),
                       rejected=int(res.rejected),
                       max_err=float(res.max_err))
            check(abs(t_end - sol.t_final) < 1e-12, f"{label}: reached "
                  f"t = {t_end} of {sol.t_final} in {TR_ATTEMPTS} "
                  f"attempts")
        if label == "hybrid_march":
            check(linf < HYBRID_FLOOR * nodal + 1e-12, f"{label}: Linf "
                  f"{linf} >= {HYBRID_FLOOR} x nodal {nodal}")
            kept[label] = (problem, cfg, tcfg, sol)
        check(label in GATES_TR and err < GATES_TR[label],
              f"{label}: Linf {err} >= gate {GATES_TR.get(label)}")
        emit("main_path_transient", **rec)
        del sol, vel, res
        torch.cuda.empty_cache()

    # the same marches at a small size, on the card and on the CPU
    worst = {}
    for run in transient_runs():
        _, _, _, g, gv, gres = transient_call(run, device, small=True)
        _, _, _, c, cv, cres = transient_call(run, "cpu", small=True)
        d = {"fem_values": rel_diff(c.fem_values, g.fem_values)}
        if gv is not None:
            d["velocity"] = rel_diff(cv, gv)
        if g.coeffs is not None:
            d["coeffs"] = rel_diff(c.coeffs, g.coeffs)
        if gres is not None:
            check(int(gres.accepted) == int(cres.accepted)
                  and int(gres.rejected) == int(cres.rejected),
                  f"{run[0]}: attempt counts differ on the CPU")
        check(all(v < (TR_COEFF_REL if k == "coeffs" else TR_NODAL_REL)
                  for k, v in d.items()), f"{run[0]}: GPU against CPU {d}")
        worst[run[0]] = d
    emit("transient_gpu_vs_cpu", nodal_tol=TR_NODAL_REL,
         coeff_tol=TR_COEFF_REL, rel_diff=worst)

    # kill-and-resume on the card: hybrid_march at 2^20
    problem, cfg, tcfg, plain = kept["hybrid_march"]
    with tempfile.TemporaryDirectory() as tmp:
        whole_cfg = dataclasses.replace(
            tcfg, checkpoint=os.path.join(tmp, "whole"),
            checkpoint_chunk=TR_CHUNK)
        whole, whole_s = timed(lambda: TR.hybrid_march(
            problem, cfg, whole_cfg, device=device))
        kill_cfg = dataclasses.replace(whole_cfg,
                                       checkpoint=os.path.join(tmp, "kill"))
        orig, writes = CK._write_march, [0]

        def bomb(*a, **k):
            orig(*a, **k)
            writes[0] += 1
            if writes[0] == 2:
                raise _Killed

        CK._write_march = bomb
        killed = False
        try:
            TR.hybrid_march(problem, cfg, kill_cfg, device=device)
        except _Killed:
            killed = True
        finally:
            CK._write_march = orig
        fp = CK.march_fingerprint(problem.name, cfg, kill_cfg,
                                  "hybrid_march")
        at = CK.load_march_state(kill_cfg.checkpoint, fp)[0]
        check(killed and at == 2 * TR_CHUNK, f"kill: state at step {at}")
        resumed, resume_s = timed(lambda: TR.hybrid_march(
            problem, cfg, kill_cfg, device=device))
        same = {
            "resumed_vs_whole": torch.equal(resumed.coeffs, whole.coeffs)
            and torch.equal(resumed.fem_values, whole.fem_values),
            "whole_vs_plain": torch.equal(whole.coeffs, plain.coeffs)
            and torch.equal(whole.fem_values, plain.fem_values)}
        emit("transient_resume", run="hybrid_march", E=E_TR,
             steps=TR_STEPS, chunk=TR_CHUNK, resumed_at=at,
             checkpointed_s=whole_s, resumed_s=resume_s, bitwise=same)
        check(all(same.values()), f"kill-and-resume: {same}")
    del whole, resumed, plain, kept
    torch.cuda.empty_cache()


# The 3D marches at the steady 3D path's full width, 128^3 hexes (M = C =
# 4), float64, TR_STEPS steps of DT_TR (dt/h^2 = 8; TR_ATTEMPTS attempts
# for the adaptive march); against the CPU at 6^3 (the lifted trace needs
# six nodes a grid line).  The enhanced marches are gated through
# evaluate_3d on POINTS_3D random points, the others on their nodal values.
N_TR3_SMALL = 6
# Linf at t_final, 10x the card's own (NVIDIA H100 80GB HBM3, 700.00 W:
# 2.261e-4, 1.625e-8, 2.712e-7, 2.793e-7, 8.039e-7, 8.080e-7, 2.263e-4).
GATES_TR3 = {
    "fem_march_3d": 2.3e-3,
    "hybrid_march_3d": 1.7e-7,
    "wave_march_3d": 2.8e-6,
    "hybrid_wave_march_3d": 2.8e-6,
    "fem_march_semilinear_3d": 8.1e-6,
    "hybrid_march_semilinear_3d": 8.1e-6,
    "fem_march_adaptive_3d": 2.3e-3,
}
# The elastodynamics marches: 2D at 1024^2 quads (M = C = 6) and 3D at
# 64^3 hexes (M = C = 4), the steady elastic phases' sizes, float64,
# TR_STEPS steps of DT_TR; against the CPU at 16^2 and 4^3.  The enhanced
# marches are gated through their evaluate functions on POINTS_2D /
# POINTS_3D random points, the others on their nodal values (the larger
# component's).  Linf at t_final, 10x the card's own (NVIDIA H100 80GB
# HBM3, 700.00 W: 3.058e-7, 1.834e-5, 1.091e-4, 5.683e-3).
N_EW3 = 64
GATES_EW = {
    "elastic_wave_march_2d": 3.1e-6,
    "hybrid_elastic_wave_march_2d": 1.9e-4,
    "elastic_wave_march_3d": 1.1e-3,
    "hybrid_elastic_wave_march_3d": 5.7e-2,
}
# Newmark (1/4, 1/2) conserves the discrete energy when f = 0
# (tests/test_elastic_wave.py:36-47): |energyN - energy0| / energy0 of
# elastic_free_vibration_2d at 1024^2 within ENERGY_DRIFT.
ENERGY_DRIFT = 1e-10


def transient_3d_runs():
    """(label, march, problem, mass, keyword arguments) of the 3D phase."""
    return [
        ("fem_march_3d", "fem_march_3d", "heat_3d", "consistent", {}),
        ("hybrid_march_3d", "hybrid_march_3d", "heat_3d", "numerov",
         {"trace_lift": 6}),
        ("wave_march_3d", "wave_march_3d", "wave_3d", "numerov", {}),
        ("hybrid_wave_march_3d", "hybrid_wave_march_3d", "wave_3d",
         "numerov", {"trace_lift": 6}),
        ("fem_march_semilinear_3d", "fem_march_semilinear_3d",
         "semilinear_heat_3d", "numerov", {}),
        ("hybrid_march_semilinear_3d", "hybrid_march_semilinear_3d",
         "semilinear_heat_3d", "numerov", {"trace_lift": 6}),
        ("fem_march_adaptive_3d", "fem_march_adaptive_3d", "heat_3d", None,
         {}),
    ]


def march_record(label, n, steps, timing, peak_bytes, nodal, linf, gate,
                 cg_iters):
    """The phase line of one full-width march (``timed_steps``' numbers),
    after checking its Linf gate and its CG solves."""
    solve_s, first_s, later_s = timing
    loop_ms = (first_s + later_s) * 1e3
    err = nodal if linf is None else linf
    check(gate is not None and err < gate,
          f"{label}: Linf {err} >= gate {gate}")
    check(cg_iters < TR_CG_MAXITER, f"{label}: a CG solve did not "
          f"converge in {TR_CG_MAXITER} iterations")
    return dict(run=label, n=n, steps=steps, solve_s=solve_s,
                setup_ms=solve_s * 1e3 - loop_ms, loop_ms=loop_ms,
                first_step_ms=first_s * 1e3,
                later_step_ms=later_s * 1e3 / (steps - 1),
                peak_gb=peak_bytes / 2**30, cg_iters=cg_iters,
                nodal_linf=nodal, linf=linf, gate=gate)


def timed_peak(fn):
    """``timed_steps(fn)`` and the card's peak allocated bytes in it."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, whole, first, later = timed_steps(fn)
    return out, (whole, first, later), torch.cuda.max_memory_allocated()


def phase_main_path_transient_3d(device="cuda"):
    """The seven 3D marches through their public functions on the card at
    128^3 hexes (M = C = 4, float64, TR_STEPS steps of DT_TR, the
    adaptive march TR_ATTEMPTS attempts): finite values, Linf at t_final
    within GATES_TR3, every CG solve converged, the adaptive march at
    t_final; set-up, first and later steps timed apart, and the card's
    peak memory.  Each march once more at 6^3 on the card and on the CPU,
    to round-off (the adaptive counts equal)."""
    import torch

    pts3 = tuple(v.to(device=device, dtype=torch.float64)
                 for v in points_3d())
    for run in transient_3d_runs():
        label = run[0]
        (problem, cfg, tcfg, sol, vel, res), timing, peak = timed_peak(
            lambda: transient_call(run, device))
        n = TR_STEPS if res is None else TR_ATTEMPTS
        t_end = float(res.t_reached) if res is not None else sol.t_final
        check(bool(torch.isfinite(sol.fem_values).all())
              and (sol.coeffs is None
                   or bool(torch.isfinite(sol.coeffs).all())),
              f"{label}: non-finite values")
        nodal, linf = transient_errors(problem, sol, t_end, None, None,
                                       pts3)
        rec = march_record(label, N3D, n, timing, peak, nodal, linf,
                           GATES_TR3.get(label), sol.cg_iters)
        if res is None:
            rec.update(dt=DT_TR, t_final=sol.t_final)
        else:
            rec.update(t_final=sol.t_final, t_reached=t_end,
                       accepted=int(res.accepted),
                       rejected=int(res.rejected),
                       max_err=float(res.max_err))
            check(abs(t_end - sol.t_final) < 1e-12, f"{label}: reached "
                  f"t = {t_end} of {sol.t_final} in {TR_ATTEMPTS} "
                  f"attempts")
        emit("main_path_transient_3d", **rec)
        del sol, vel, res
        torch.cuda.empty_cache()

    worst = {}
    for run in transient_3d_runs():
        _, _, _, g, gv, gres = transient_call(run, device, small=True)
        _, _, _, c, cv, cres = transient_call(run, "cpu", small=True)
        d = {"fem_values": rel_diff(c.fem_values, g.fem_values)}
        if gv is not None:
            d["velocity"] = rel_diff(cv, gv)
        if g.coeffs is not None:
            d["coeffs"] = rel_diff(c.coeffs, g.coeffs)
        if gres is not None:
            check(int(gres.accepted) == int(cres.accepted)
                  and int(gres.rejected) == int(cres.rejected),
                  f"{run[0]}: attempt counts differ on the CPU")
        check(all(v < (TR_COEFF_REL if k == "coeffs" else TR_NODAL_REL)
                  for k, v in d.items()), f"{run[0]}: GPU against CPU {d}")
        worst[run[0]] = d
    emit("transient_3d_gpu_vs_cpu", n=N_TR3_SMALL, nodal_tol=TR_NODAL_REL,
         coeff_tol=TR_COEFF_REL, rel_diff=worst)


ELASTIC_WAVE_MARCHES = (
    "elastic_wave_march_2d", "hybrid_elastic_wave_march_2d",
    "elastic_wave_march_3d", "hybrid_elastic_wave_march_3d")


def elastic_wave_call(march, device, small=False, problem=None):
    """(problem, config, solution) of one elastodynamics march through its
    public function."""
    from hybrid_fem_lssvr_tpu_torch import ElasticConfig2D, ElasticConfig3D
    from hybrid_fem_lssvr_tpu_torch.models import elastic_wave as EW
    from hybrid_fem_lssvr_tpu_torch.models.transient import TransientConfig

    if march.endswith("_2d"):
        n = 16 if small else NE
        cfg = ElasticConfig2D(nx=n, ny=n, M=M2D, n_colloc=C2D,
                              dtype="float64", cg_maxiter=TR_CG_MAXITER)
        problem = problem or EW.elastic_wave_2d()
    else:
        n = 4 if small else N_EW3
        cfg = ElasticConfig3D(nx=n, ny=n, nz=n, M=M3D, n_colloc=C3D,
                              dtype="float64", cg_maxiter=TR_CG_MAXITER)
        problem = problem or EW.elastic_wave_3d()
    tcfg = TransientConfig(t_final=0.25 if small else TR_STEPS * DT_TR,
                           n_steps=16 if small else TR_STEPS)
    return problem, cfg, getattr(EW, march)(problem, cfg, tcfg,
                                             device=device)


def elastic_wave_errors(problem, sol, pts):
    """(nodal Linf, enhanced Linf or None) at t_final, the larger
    component's."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import elastic_wave as EW

    t = sol.t_final
    if hasattr(sol, "zs"):
        grid = (sol.xs[None, None, :], sol.ys[None, :, None],
                sol.zs[:, None, None])
        exact = problem.exact
        evaluate = EW.evaluate_elastic_wave_3d
    else:
        Y, X = torch.meshgrid(sol.ys, sol.xs, indexing="ij")
        grid = (X, Y)
        exact = (problem.exact1, problem.exact2)
        evaluate = EW.evaluate_elastic_wave_2d
    nodal = max(float((sol.fem_values[c] - ex(*grid, t)).abs().max())
                for c, ex in enumerate(exact))
    if sol.coeffs is None:
        return nodal, None
    u = evaluate(sol, *pts)
    return nodal, max(float((u[c] - ex(*pts, t)).abs().max())
                      for c, ex in enumerate(exact))


def phase_main_path_elastic_wave(device="cuda"):
    """The four elastodynamics marches through their public functions on
    the card (2D at 1024^2, M = C = 6; 3D at 64^3, M = C = 4; float64,
    TR_STEPS steps of DT_TR): finite values, Linf at t_final within
    GATES_EW, the CG solves converged, set-up and steps timed apart with
    the card's peak memory; elastic_free_vibration_2d at 1024^2, its
    energy drift within ENERGY_DRIFT; each march once more at 16^2 / 4^3
    on the card and on the CPU, to round-off."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import elastic_wave as EW

    pts = {"2d": tuple(v.to(device=device, dtype=torch.float64)
                       for v in points_2d()),
           "3d": tuple(v.to(device=device, dtype=torch.float64)
                       for v in points_3d())}
    for march in ELASTIC_WAVE_MARCHES:
        (problem, cfg, sol), timing, peak = timed_peak(
            lambda: elastic_wave_call(march, device))
        check(bool(torch.isfinite(sol.fem_values).all())
              and (sol.coeffs is None
                   or bool(torch.isfinite(sol.coeffs).all())),
              f"{march}: non-finite values")
        nodal, linf = elastic_wave_errors(problem, sol, pts[march[-2:]])
        rec = march_record(march, cfg.nx, TR_STEPS, timing, peak, nodal,
                           linf, GATES_EW.get(march), sol.cg_iters)
        emit("main_path_elastic_wave", **rec, dt=DT_TR, t_final=sol.t_final,
             energy0=float(sol.energy0), energyN=float(sol.energyN))
        del sol
        torch.cuda.empty_cache()

    (_, _, sol), solve_s = timed(lambda: elastic_wave_call(
        "elastic_wave_march_2d", device,
        problem=EW.elastic_free_vibration_2d()))
    drift = abs(float(sol.energyN - sol.energy0)) / float(sol.energy0)
    emit("main_path_elastic_wave", run="elastic_free_vibration_2d",
         n=NE, steps=TR_STEPS, solve_s=solve_s, energy0=float(sol.energy0),
         energyN=float(sol.energyN), energy_drift=drift,
         drift_tol=ENERGY_DRIFT, cg_iters=sol.cg_iters)
    check(drift <= ENERGY_DRIFT, f"free vibration: energy drift {drift}")
    del sol
    torch.cuda.empty_cache()

    worst = {}
    for march in ELASTIC_WAVE_MARCHES:
        _, _, g = elastic_wave_call(march, device, small=True)
        _, _, c = elastic_wave_call(march, "cpu", small=True)
        d = {f: rel_diff(getattr(c, f), getattr(g, f))
             for f in ("fem_values", "velocity", "energy0", "energyN")}
        if g.coeffs is not None:
            d["coeffs"] = rel_diff(c.coeffs, g.coeffs)
        check(all(v < (TR_COEFF_REL if k == "coeffs" else TR_NODAL_REL)
                  for k, v in d.items()), f"{march}: GPU against CPU {d}")
        worst[march] = d
    emit("elastic_wave_gpu_vs_cpu", n2d=16, n3d=4, nodal_tol=TR_NODAL_REL,
         coeff_tol=TR_COEFF_REL, rel_diff=worst)


def phase_stages_transient(device="cuda"):
    """hybrid_march, hybrid_march_2d, hybrid_march_3d and
    hybrid_elastic_wave_march_2d at full width under a device-only
    torch.profiler: the device's busy ms and idle share of the call."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import hybrid as H1
    from hybrid_fem_lssvr_tpu_torch.models import hybrid2d as H2
    from hybrid_fem_lssvr_tpu_torch.models import hybrid3d as H3
    from hybrid_fem_lssvr_tpu_torch.models import transient as TR

    spans = TR.SPANS + H1.SPANS + H2.SPANS + H3.SPANS
    runs = [("transient", r) for r in transient_runs()
            if r[0] in ("hybrid_march", "hybrid_march_2d")]
    runs += [("transient", r) for r in transient_3d_runs()
             if r[0] == "hybrid_march_3d"]
    runs += [("elastic_wave", "hybrid_elastic_wave_march_2d")]
    for kind, run in runs:
        if kind == "transient":
            label, call = run[0], functools.partial(transient_call, run,
                                                    device)
        else:
            label, call = run, functools.partial(elastic_wave_call, run,
                                                 device)
        _, solve_s = timed(call)
        wall, busy, ops, prof_s = profiled_busy(call, spans)
        emit("stages_transient", run=label, steps=TR_STEPS,
             solve_ms=solve_s * 1e3, profiled_wall_ms=wall,
             device_busy_ms=busy,
             device_idle_share=1.0 - busy / (solve_s * 1e3),
             device_ops=ops, profile_s=prof_s)
        torch.cuda.empty_cache()


def transient_phases(device="cuda"):
    """The march phases, with the nine wrappers' counts set to 0 just
    before them and read just after: no march runs a hand-written kernel,
    as in the JAX package, so every count must stay 0."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_elastic as KE
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG
    from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3

    mods = (K, K2, KG, K3, KE)
    for mod in mods:
        mod.reset_launch_counts()
    phases = (phase_main_path_transient, phase_main_path_transient_3d,
              phase_main_path_elastic_wave, phase_stages_transient)
    seconds = {}
    for phase in phases:
        t0 = time.perf_counter()
        phase(device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[phase.__name__] = time.perf_counter() - t0
    launched = {}
    for mod in mods:
        launched.update(mod.launch_counts())
    emit("launch_counts_transient", phases=[p.__name__ for p in phases],
         phase_s=seconds, **launched)
    check(not any(launched.values()), f"a march launched a kernel: "
          f"{launched}")


# The distributed solves (parallel/): SHARDED_RANKS ranks on the one card
# under gloo (NCCL refuses two ranks on one card; the collectives stage
# each tensor through host memory), and one rank under NCCL.  Ranks that
# share a card measure no multi-GPU scaling.  Every sharded result is held
# against the single-device solve of the same configuration on the card:
# coefficients within SHARDED_COEFF_REL of their size (float32
# enhancement over a float64 coarse stage on both sides), Linf at the
# single-device phase's gate, solve_ok everywhere, a converged coarse
# solve.  The graded 3D path runs at NG3D^3, as main_path_graded_3d.
SHARDED_RANKS = 4
SHARDED_COEFF_REL = 1e-5
SHARDED_PG_TIMEOUT_S = 240
SHARDED_JOIN_S = 420
SHARDED_WARMUP_E = 4096


def sharded_cases(world):
    """(label, dict) of the distributed paths: the 1D SPIKE solve through
    separable_kernel (poisson_1d) and varcoeff_kernel in graded mode
    (variable_coeff_elliptic) a rank; with four ranks also poisson_2d on
    y-slabs and on the 2 x 2 grid, the graded 2D solve on y-slabs, and
    poisson_3d on z-slabs, on the 2 x 2 (z, y) grid and graded z-slabs."""
    from hybrid_fem_lssvr_tpu_torch import (Solver2DConfig, Solver3DConfig,
                                            SolverConfig, problems)

    cfg1 = SolverConfig(num_nodes=E_MAIN + 1, M=M, gamma=1e4, n_colloc=C,
                        dtype="float32", fem_dtype="float64")
    cases = [(f"1d/{name}", dict(dim=1, problem=problems.get(name),
                                 cfg=cfg1, mesh="line", gate=GATES[name]))
             for name in ("poisson_1d", "variable_coeff_elliptic")]
    if world == 1:
        return cases
    cfg2 = Solver2DConfig(nx=N2D, ny=N2D, M=M2D, n_colloc=C2D,
                          dtype="float32", fem_dtype="float64")
    cfg2g = dataclasses.replace(cfg2, nx=NG, ny=NG,
                                cg_maxiter=GRADED_CG_MAXITER)
    cfg3 = Solver3DConfig(nx=N3D, ny=N3D, nz=N3D, M=M3D, n_colloc=C3D,
                          dtype="float32", fem_dtype="float64",
                          precond="mg")
    cfg3g = dataclasses.replace(cfg3, nx=NG3D, ny=NG3D, nz=NG3D,
                                precond="jacobi",
                                cg_maxiter=GRADED3D_CG_MAXITER)
    g2 = GATES_2D["poisson_2d"]
    g3 = GATES_3D["poisson_3d"]
    return cases + [
        ("2d/slab", dict(dim=2, cfg=cfg2, mesh="line", gate=g2)),
        ("2d/grid", dict(dim=2, cfg=cfg2, mesh="grid", gate=g2)),
        ("2d/graded", dict(dim=2, cfg=cfg2g, mesh="line", graded=True,
                           gate=GATES_GRADED["poisson_2d"])),
        ("3d/slab", dict(dim=3, cfg=cfg3, mesh="line", gate=g3)),
        ("3d/grid", dict(dim=3, cfg=cfg3, mesh="grid3", gate=g3)),
        ("3d/graded", dict(dim=3, cfg=cfg3g, mesh="line", graded=True,
                           gate=GATES_NEW["poisson_3d_graded"])),
    ]


def sharded_entry(case, mesh, device):
    """(solve callable, evaluate callable, query points, exact-solution
    function, twin) of one distributed path; the twin solves the same
    configuration on one device and returns (solver, solution)."""
    import torch

    from hybrid_fem_lssvr_tpu_torch import (HybridSolver, HybridSolver2D,
                                            HybridSolver2DGraded,
                                            HybridSolver3D,
                                            HybridSolver3DGraded,
                                            get_problem_2d, get_problem_3d)
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded2d as S2
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded3d as S3

    cfg, dim = case["cfg"], case["dim"]
    torch_cfg = dataclasses.replace(cfg, backend="torch")
    if dim == 1:
        problem = case["problem"]
        pts = (torch.linspace(-1.0, 1.0, DENSE_POINTS, dtype=torch.float32,
                              device=device),)
        return (sharded.make_sharded_solve(problem, cfg, mesh, device=device,
                                           enhance_backend="cuda"),
                sharded.make_sharded_evaluate(problem, cfg, mesh,
                                              device=device),
                pts, problem.exact,
                lambda: HybridSolver(problem, cfg, device=device))
    if dim == 2:
        problem = get_problem_2d("poisson_2d")
        pts = tuple(p.to(device) for p in points_2d())
        if case.get("graded"):
            xs, ys = graded_mesh(cfg.nx)
            return (S2.make_sharded_solve_2d_graded(problem, cfg, mesh, xs,
                                                    ys, device=device),
                    S2.make_sharded_evaluate_2d_graded(cfg, mesh, xs, ys,
                                                       device=device),
                    pts, problem.exact,
                    lambda: HybridSolver2DGraded(problem, torch_cfg, xs, ys,
                                                 device=device))
        grid = case["mesh"] == "grid"
        solve = (S2.make_sharded_solve_2d_grid if grid
                 else S2.make_sharded_solve_2d)
        ev = (S2.make_sharded_evaluate_2d_grid if grid
              else S2.make_sharded_evaluate_2d)
        return (solve(problem, cfg, mesh, device=device),
                ev(problem, cfg, mesh, device=device), pts, problem.exact,
                lambda: HybridSolver2D(problem, torch_cfg, device=device))
    problem = get_problem_3d("poisson_3d")
    pts = tuple(p.to(device) for p in points_3d())
    if case.get("graded"):
        nodes = graded_axis_nodes(cfg.nx, -1.0, 1.0, GRADED_POWER)
        xyz = (nodes, nodes, nodes)
        return (S3.make_sharded_solve_3d_graded(problem, cfg, mesh, *xyz,
                                                device=device),
                S3.make_sharded_evaluate_3d_graded(cfg, mesh, *xyz,
                                                   device=device),
                pts, problem.exact,
                lambda: HybridSolver3DGraded(problem, torch_cfg, *xyz,
                                             device=device))
    grid = case["mesh"] == "grid3"
    solve = (S3.make_sharded_solve_3d_grid if grid
             else S3.make_sharded_solve_3d)
    ev = (S3.make_sharded_evaluate_3d_grid if grid
          else S3.make_sharded_evaluate_3d)
    return (solve(problem, cfg, mesh, device=device),
            ev(problem, cfg, mesh, device=device), pts, problem.exact,
            lambda: HybridSolver3D(problem, torch_cfg, device=device))


def sharded_nodal(dim, sol):
    """The gathered solution's nodal grid (1D: the nodal vector)."""
    import torch

    if dim == 1:
        fl = sol.fem_local
        return torch.cat([fl[:, :-1].reshape(-1), fl[-1, -1:]])
    return torch.as_tensor(sol.assemble_fem_grid())


def shard_plain_errors(case, sol, d, world):
    """This rank's 1D shard outputs (w, slack, bcv) against the kernel's
    plain version on the shard's own inputs: its nodal values, its left
    edge (separable_kernel) or its nodes (varcoeff_kernel in graded mode,
    through the same finalize as the shard)."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models.hybrid import (
        _kernel_finalize, prepare_shared_host)
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded

    problem, cfg = case["problem"], case["cfg"]
    device, dtype = sol.coeffs.device, cfg.torch_dtype()
    E_total = cfg.num_nodes - 1
    E_loc = -(-E_total // world)
    x0, x1 = problem.domain
    h = (x1 - x0) / E_total
    fem = sol.fem_local[0]
    shared = prepare_shared_host(problem, cfg)
    if shared is not None:
        want = K.fused_enhance_separable_ref(
            fem, shared.to(device), problem.f_elem_factors,
            sharded.shard_x0(x0, d, E_loc, h, dtype), h,
            with_fallback=True)[:3]
        kname, tols = "separable_kernel", (W_TOL, SLACK_TOL, BCV_TOL)
    else:
        nodes = sharded._local_nodes(problem, E_total, E_loc, d,
                                     getattr(torch, cfg.fem_dtype),
                                     device).to(dtype)
        host = K.VarCoeffOperators.host(cfg.M, cfg.n_colloc, h,
                                        dtype).to(device)
        w, slack, bcv, cond = K.fused_enhance_varcoeff_ref(
            fem, problem, host, x0, h, cfg.n_colloc,
            with_diagnostics=cfg.diagnostics, nodes=nodes)
        w, diags = _kernel_finalize(w, slack, bcv, fem[:-1], fem[1:], cfg,
                                    cond=cond)
        want = (w, diags.max_slack, diags.bc_violation)
        kname, tols = "varcoeff_kernel", (GRADED_TOL, None, BCV_TOL)
    got = (sol.coeffs, sol.max_slack, sol.bc_violation)
    out = {"kernel": kname, "shape_ok": all(
        tuple(g.shape) == tuple(w.shape) for g, w in zip(got, want))}
    for what, g, w, tol in zip(("w", "slack", "bcv"), got, want, tols):
        out[f"{what}_max_abs_err"] = max_err(g, w)
        out[f"{what}_tol"] = tol
        if what != "w":
            mean = float(w.mean())
            out[f"{what}_size"], out[f"{what}_mean"] = float(w.max()), mean
            out[f"{what}_mean_ratio"] = (float(g.mean()) / mean if mean
                                         else float("nan"))
    out["slack_rel"] = SLACK_REL[kname]
    return out


def check_shard_plain(label, backend, rank, rec):
    """The gates of phase_kernels on one shard's ``shard_plain_errors``."""
    tag = f"{label} ({backend}, rank {rank}) {rec['kernel']}"
    check(rec["shape_ok"], f"{tag}: shapes differ from the plain version")
    for what in ("w", "slack", "bcv"):
        err, tol = rec[f"{what}_max_abs_err"], rec[f"{what}_tol"]
        check(tol is None or err <= tol, f"{tag}: {what} max abs err {err} "
              f"> {tol}")
    for what, rel in (("slack", rec["slack_rel"]), ("bcv", BCV_REL)):
        check(rec[f"{what}_mean"] > 0, f"{tag}: the plain version's {what} "
              f"is zero")
        err, size = rec[f"{what}_max_abs_err"], rec[f"{what}_size"]
        check(err <= rel * size, f"{tag}: {what} differs from the plain "
              f"version by {err}, more than {rel} of its largest value "
              f"{size}")
        ratio = rec[f"{what}_mean_ratio"]
        check(MEAN_RATIO[0] < ratio < MEAN_RATIO[1], f"{tag}: mean {what} "
              f"is {ratio} of the plain version's")


def sharded_worker(rank, world, backend, init_file, out_dir):
    """One rank of main_path_sharded: joins the process group, runs every
    distributed path (each rank holds its 1D shards against the kernels'
    plain versions; rank 0 solves each path's single-device twin and
    compares), saves rank 0's records and every rank's launch counts and
    shard checks."""
    import datetime

    import torch
    import torch.distributed as dist

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d as K2
    from hybrid_fem_lssvr_tpu_torch.ops import kernels2d_graded as KG
    from hybrid_fem_lssvr_tpu_torch.ops import kernels3d as K3
    from hybrid_fem_lssvr_tpu_torch.parallel import collectives as col
    from hybrid_fem_lssvr_tpu_torch.parallel import mesh as pm
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=SHARDED_PG_TIMEOUT_S))
    try:
        meshes = {"line": pm.element_mesh()}
        if world == 4:
            meshes["grid"] = pm.grid_mesh(2, 2)
            meshes["grid3"] = pm.grid_mesh_3d(2, 2)
        device = pm.mesh_device(None)
        cases = sharded_cases(world)
        # Warm-up: both 1D kernels once a rank on a small mesh.
        for label, case in cases[:2]:
            small = dataclasses.replace(case["cfg"],
                                        num_nodes=SHARDED_WARMUP_E + 1)
            sharded.make_sharded_solve(case["problem"], small,
                                       meshes["line"], device=device)()
        mods = (K, K2, KG, K3)
        for mod in mods:
            mod.reset_launch_counts()
        records, launched, shards = [], {}, {}
        for label, case in cases:
            mesh = meshes[case["mesh"]]
            run, evaluate, pts, exact, twin = sharded_entry(case, mesh,
                                                            device)
            before = {k: v for mod in mods
                      for k, v in mod.launch_counts().items()}
            dist.barrier()
            t0 = time.perf_counter()
            sol = run()
            torch.cuda.synchronize(device)
            dist.barrier()
            wall_ms = (time.perf_counter() - t0) * 1e3
            after = {k: v for mod in mods
                     for k, v in mod.launch_counts().items()}
            launched[label] = {k: after[k] - before[k] for k in after
                               if after[k] != before[k]}
            u = evaluate(sol.coeffs, *pts)
            g = col.gather_solution(sol, mesh)
            if case["dim"] == 1:
                shards[label] = shard_plain_errors(
                    case, sol, col.axis_index(mesh, "elements"), world)
            del sol
            if rank == 0:
                records.append(sharded_compare(label, case, g, u, pts,
                                               exact, twin, wall_ms, world,
                                               backend))
            del g, u
            torch.cuda.empty_cache()
            dist.barrier()
        tag = f"{backend}_{world}"
        with open(os.path.join(out_dir, f"counts_{tag}_{rank}.json"),
                  "w") as fh:
            json.dump({"launched": launched, "shards": shards}, fh)
        if rank == 0:
            with open(os.path.join(out_dir, f"records_{tag}.json"),
                      "w") as fh:
                json.dump(records, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sharded_compare(label, case, g, u, pts, exact, twin, wall_ms, world,
                    backend):
    """Rank 0's record of one distributed path against its single-device
    twin, solved here on the same device."""
    import torch

    dim, cfg = case["dim"], case["cfg"]
    device = u.device
    linf = float(torch.max(torch.abs(u - exact(*pts) * torch.ones_like(u))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = twin()
    ref = s.solve()
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    twin_linf = float(s.errors(*pts)[0])
    coeffs = g.coeffs.to(device)
    scale = float(torch.max(torch.abs(ref.coeffs)))
    coeff_rel = float(torch.max(torch.abs(coeffs - ref.coeffs))) / scale
    nodal = sharded_nodal(dim, g).to(device)
    fem = ref.fem_values.reshape(nodal.shape) if dim == 1 else \
        ref.fem_values
    nodal_err = float(torch.max(torch.abs(nodal[tuple(
        slice(0, n) for n in fem.shape)] - fem)))
    rec = dict(run=label, ranks=world, backend=backend,
               shape=list(coeffs.shape), wall_ms=wall_ms,
               twin_wall_ms=twin_ms, linf=linf, twin_linf=twin_linf,
               gate=case["gate"], coeff_rel_err=coeff_rel,
               coeff_tol=SHARDED_COEFF_REL, nodal_max_abs_err=nodal_err,
               solve_ok=bool(g.solve_ok.all()),
               finite=bool(torch.isfinite(coeffs).all()),
               shape_ok=tuple(coeffs.shape) == tuple(ref.coeffs.shape))
    if dim > 1:
        iters = g.cg_iters.reshape(-1).tolist()
        rec.update(cg_iters=iters, twin_cg_iters=int(ref.cg_iters),
                   cg_maxiter=cfg.cg_maxiter,
                   cg_residual=float(g.cg_residual.reshape(-1)[0]),
                   converged=(len(set(iters)) == 1
                              and iters[0] < cfg.cg_maxiter))
    return rec


def phase_main_path_sharded():
    """The distributed solves of parallel/ on the one card: SHARDED_RANKS
    spawned ranks under gloo (every path), then one rank under NCCL in
    this process (the 1D paths).  Returns the launches of separable_kernel
    and varcoeff_kernel on those paths, which must be one a rank a 1D
    solve; every path must meet its gates against its single-device
    twin, and every 1D shard its kernel's plain version on the shard's
    inputs."""
    import multiprocessing as mp
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="sharded_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=sharded_worker,
                         args=(r, SHARDED_RANKS, "gloo",
                               os.path.join(tmp, "pg_gloo"), tmp))
             for r in range(SHARDED_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    check(not alive, f"main_path_sharded: ranks {alive} still running "
          f"after {SHARDED_JOIN_S} s")
    codes = {r: p.exitcode for r, p in enumerate(procs)}
    check(not any(codes.values()), f"main_path_sharded: rank exit codes "
          f"{codes}")
    gloo_s = time.perf_counter() - t_phase
    t1 = time.perf_counter()
    sharded_worker(0, 1, "nccl", os.path.join(tmp, "pg_nccl_1"), tmp)
    single_s = time.perf_counter() - t1
    counts = {"fused_enhance_separable": 0, "fused_enhance_varcoeff": 0}
    for backend, world in (("gloo", SHARDED_RANKS), ("nccl", 1)):
        with open(os.path.join(tmp, f"records_{backend}_{world}.json")) as fh:
            records = json.load(fh)
        for rec in records:
            emit("main_path_sharded", note="ranks share one card: no "
                 "multi-GPU scaling", **rec)
            label = rec["run"]
            check(rec["shape_ok"] and rec["finite"], f"{label} "
                  f"({backend}): coeffs shape {rec['shape']} or non-finite")
            check(rec["solve_ok"], f"{label} ({backend}): elements fell "
                  f"back")
            check(rec["linf"] < rec["gate"], f"{label} ({backend}): Linf "
                  f"{rec['linf']} >= gate {rec['gate']}")
            check(rec["coeff_rel_err"] <= SHARDED_COEFF_REL, f"{label} "
                  f"({backend}): coeffs {rec['coeff_rel_err']} of their "
                  f"size from the single-device solve")
            check(rec.get("converged", True), f"{label} ({backend}): the "
                  f"distributed coarse solve did not converge: "
                  f"{rec.get('cg_iters')}")
        for r in range(world):
            with open(os.path.join(tmp, f"counts_{backend}_{world}_{r}.json")
                      ) as fh:
                saved = json.load(fh)
            launched = saved["launched"]
            check(sorted(saved["shards"]) == ["1d/poisson_1d",
                                              "1d/variable_coeff_elliptic"],
                  f"{backend} rank {r}: shard checks {sorted(saved['shards'])}")
            for label, rec in saved["shards"].items():
                emit("main_path_sharded_shard", run=label, backend=backend,
                     rank=r, **rec)
                check_shard_plain(label, backend, rank=r, rec=rec)
            for label, got in launched.items():
                want = {}
                if label == "1d/poisson_1d":
                    want = {"fused_enhance_separable": 1}
                elif label == "1d/variable_coeff_elliptic":
                    want = {"fused_enhance_varcoeff": 1}
                check(got == want, f"{label} ({backend}, rank {r}): "
                      f"launches {got}, want {want}")
                for k, n in got.items():
                    counts[k] += n
    emit("launch_counts_sharded", gloo_ranks=SHARDED_RANKS, nccl_ranks=1,
         gloo_s=gloo_s, nccl_s=single_s,
         phase_s=time.perf_counter() - t_phase, **counts)
    return counts


IDENTITY_CHILD = r"""
import functools, json, sys
import torch
tree, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import chip_smoke as cs
from hybrid_fem_lssvr_tpu_torch.models import problems
from hybrid_fem_lssvr_tpu_torch.ops import kernels as K
torch.backends.cuda.matmul.allow_tf32 = False
fem, _, host, h, graded = cs.kernel_inputs("cuda")
vc = problems.variable_coeff_elliptic()
cases = {
    "uniform": ((fem, vc, host, -1.0, h, cs.C),
                dict(f_shifted_fn=vc.f_shifted)),
    "graded": ((torch.sin(torch.pi * graded), vc, host, -1.0, h, cs.C),
               dict(nodes=graded)),
}
times = {}
for label, (args, kw) in cases.items():
    for diag in (True, False):
        fn = functools.partial(K.fused_enhance_varcoeff, *args,
                               with_diagnostics=diag, **kw)
        torch.save(fn(), f"{out}/{label}_{int(diag)}.pt")
        times[f"{label}_{int(diag)}"] = cs.device_ms(fn, "varcoeff_kernel")[1]
print(json.dumps(times))
"""


def phase_identity(old_tree):
    """``--identity``: the 1D varcoeff kernel of OLD_TREE and of this
    checkout, bit for bit and in time (see the module docstring)."""
    import tempfile

    import torch

    def run(tree, out):
        os.makedirs(out, exist_ok=True)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "-c", IDENTITY_CHILD, tree,
                              out], capture_output=True, text=True, env=env,
                             cwd=tree)
        check(res.returncode == 0, f"{tree}: {res.stderr[-4000:]}")
        return json.loads(res.stdout.strip().splitlines()[-1])

    trees = {"old": os.path.abspath(old_tree), "new": ROOT}
    times = {"old": [], "new": []}
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("old", "new", "new", "old"):
            times[which].append(run(trees[which], os.path.join(tmp, which)))
        identical = {}
        for name in sorted(os.listdir(os.path.join(tmp, "old"))):
            a, b = (torch.load(os.path.join(tmp, w, name))
                    for w in ("old", "new"))
            identical[name[:-3]] = all(
                (x is None and y is None) or (x is not None and y is not None
                                              and torch.equal(x, y))
                for x, y in zip(a, b))
    emit("identity", old_tree=trees["old"], identical=identical,
         kernel_ms=times, device=torch.cuda.get_device_name(0))
    check(all(identical.values()), f"outputs differ: {identical}")


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
    if "--identity" in sys.argv:
        phase_identity(sys.argv[sys.argv.index("--identity") + 1])
        return

    phase_build()
    if "--sharded" in sys.argv:
        emit("sharded_only", **phase_main_path_sharded())
        return
    summary = phase_kernels()
    torch.cuda.synchronize()
    summary["fused_enhance_varcoeff"].update(phase_kernels_family())
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    summary.update(phase_kernels_graded_2d())
    summary.update(phase_kernels_3d())
    gate_basis = "--gate-basis" in sys.argv
    counts.update(phase_main_path_graded_2d(gate_basis=gate_basis))
    counts.update(phase_main_path_3d(gate_basis=gate_basis))
    phase_routes_new()
    phase_stages_3d()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary.update(phase_kernels_elastic())
    counts.update(phase_main_path_elastic(gate_basis=gate_basis))
    phase_main_path_elastic_3d()
    phase_stages_elastic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # Each new path's launches, read with the counts set to 0 just before
    # it, add to the kernel's main-path launches.
    for phase in (functools.partial(phase_main_path_families,
                                    gate_basis=gate_basis),
                  phase_main_path_adaptive,
                  functools.partial(phase_main_path_graded_3d,
                                    gate_basis=gate_basis)):
        for kname, n in phase().items():
            counts[kname] += n
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    phase_stages_families()
    phase_main_path_nonlinear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for phase in (phase_main_path_biharmonic,
                  functools.partial(phase_main_path_eigen,
                                    gate_basis=gate_basis)):
        for kname, n in phase().items():
            counts[kname] += n
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    phase_main_path_clamped()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    transient_phases()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for kname, n in phase_main_path_sharded().items():
        counts[kname] += n

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
