"""Ranks of the distributed tests: spawned CPU processes on ``gloo``.

This module imports neither JAX nor the JAX package, and neither does any
rank: a ``multiprocessing`` spawn child imports the module of its target
function, and a target defined in a test file would pull in JAX and the
repo conftest's XLA set-up.  The test files start one set of ranks per
module (``run_ranks``) that runs every case of the module, then compare the
gathered arrays that rank 0 saves with the JAX package's in the pytest
process.

Each rank joins the group through a file in the test's temporary
directory, with a process-group timeout of ``PG_TIMEOUT_S`` and one thread
(the suite runs several pytest workers on few cores).  ``run_ranks`` joins
with a deadline of ``JOIN_TIMEOUT_S``, three to nine times what a module's
cases take on one idle worker (10-30 s): a rank that dies fails the
calling fixture within seconds (its peers' collectives error out), one
that deadlocks within the deadline, and every rank left is killed.
"""

from __future__ import annotations

import datetime
import importlib
import os
import sys
import time
import traceback

PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 90


def _rank_main(rank, world, init_file, out_dir, module, cases):
    if "jax" in sys.modules:
        raise RuntimeError("a rank of the distributed tests loaded jax")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    results = {}
    try:
        mod = importlib.import_module(module)
        ctx = mod.Context(rank, world)
        for name in cases:
            t0 = time.perf_counter()
            try:
                results[name] = getattr(mod, f"case_{name}")(ctx)
            except Exception:  # recorded; the test of that case fails
                results[name] = {"error": traceback.format_exc()}
            results[name]["seconds"] = time.perf_counter() - t0
        results["_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "hybrid_fem_lssvr_tpu"))
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


class Ranks:
    """A started set of ranks; ``results()`` joins them (with the deadline
    counted from the start) and returns rank 0's results.  Starting the
    ranks before the JAX side of a test module runs overlaps the two."""

    def __init__(self, world, module, cases, tmp_dir,
                 timeout=JOIN_TIMEOUT_S):
        import multiprocessing as mp

        self.tmp_dir = str(tmp_dir)
        init_file = os.path.join(self.tmp_dir, "pg_init")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, init_file, self.tmp_dir,
                                        module, list(cases)))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        import torch

        try:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            alive = [r for r, p in enumerate(self.procs) if p.is_alive()]
            if alive:
                raise TimeoutError(f"ranks {alive} still running after "
                                   f"{self.timeout} s")
            bad = {r: p.exitcode for r, p in enumerate(self.procs)
                   if p.exitcode}
            if bad:
                raise RuntimeError(f"ranks exited with {bad}")
        finally:
            self.stop()
        self._results = torch.load(
            os.path.join(self.tmp_dir, "results.pt"), weights_only=False)
        return self._results


    def stop(self):
        """Kill every rank still running (a fixture's teardown)."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def run_ranks(world, module, cases, tmp_dir, timeout=JOIN_TIMEOUT_S):
    """Run ``module.case_<name>(ctx)`` for every name of ``cases`` on
    ``world`` spawned ranks; returns rank 0's results {name: dict}."""
    return Ranks(world, module, cases, tmp_dir, timeout).results()


# --------------------------------------------------------------------------
# The cases.  Each runs on every rank and returns numpy arrays (rank 0's
# are kept); the meshes are built once per set of ranks.
# --------------------------------------------------------------------------

class Context:
    """This rank's meshes: ``line`` the 1-D mesh over every rank, ``grid``
    a 2 x 2 ("ely", "elx") mesh and ``grid3`` a 2 x 2 ("elz", "ely") one
    (four ranks)."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world
        self._meshes = {}

    def mesh(self, kind):
        from hybrid_fem_lssvr_tpu_torch.parallel import mesh as pm

        if kind not in self._meshes:
            build = {"line": lambda: pm.element_mesh(device_type="cpu"),
                     "grid": lambda: pm.grid_mesh(2, 2, device_type="cpu"),
                     "grid3": lambda: pm.grid_mesh_3d(2, 2,
                                                      device_type="cpu")}
            self._meshes[kind] = build[kind]()
        return self._meshes[kind]


def _np(sol):
    """A gathered solution as {field: numpy array}."""
    return {k: (None if v is None else v.detach().cpu().numpy())
            for k, v in sol._asdict().items()}


def case_isolation(ctx):
    """The modules of JAX or the JAX package loaded in a rank after it
    imported every distributed module of the port."""
    import numpy as np

    for name in ("mesh", "collectives", "sharded", "sharded2d", "sharded3d",
                 "transpose"):
        importlib.import_module(f"hybrid_fem_lssvr_tpu_torch.parallel.{name}")
    return {"modules": np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "hybrid_fem_lssvr_tpu")),
        dtype=object)}


def case_die(ctx):
    """Rank 1 dies; rank 0 waits for it in a collective."""
    import torch.distributed as dist

    if ctx.rank == 1:
        os._exit(3)
    dist.barrier()
    return {}


# ---- collectives ----------------------------------------------------------

def _collectives(ctx):
    """This rank's results of the five operations."""
    import numpy as np
    import torch

    from hybrid_fem_lssvr_tpu_torch.parallel import collectives as col

    line, grid = ctx.mesh("line"), ctx.mesh("grid")
    n = ctx.world
    d = col.axis_index(line, "elements")
    x = torch.full((3,), float(d + 1), dtype=torch.float64)
    # Open (non-cyclic) shifts: the end that no pair sends to gets zeros.
    up = col.ppermute(x, line, "elements", [(i, i + 1) for i in range(n - 1)])
    dn = col.ppermute(x, line, "elements", [(i + 1, i) for i in range(n - 1)])
    cyc = col.ppermute(x, line, "elements",
                       [(i, (i + 1) % n) for i in range(n)])
    dy, dx = col.axis_index(grid, "ely"), col.axis_index(grid, "elx")
    v = torch.tensor([10.0 * dy + dx], dtype=torch.float64)
    s_y = col.psum(v, grid, "ely")
    s_x = col.psum(v, grid, "elx")
    s_xy = col.psum(v, grid, ("ely", "elx"))
    s_line = col.psum(x, line, "elements")
    gathered = col.all_gather(torch.tensor([d, 7 * d], dtype=torch.float64),
                              line, "elements")
    gx = col.all_gather(v, grid, "elx")
    # all_to_all: block e of rank d holds (d, e); rank d receives (e, d).
    blocks = torch.tensor([[d, e] for e in range(n)], dtype=torch.float64)
    a2a = col.all_to_all(blocks, line, "elements")
    return {"rank": np.array([d, dy, dx]), "up": up.numpy(),
            "dn": dn.numpy(), "cyc": cyc.numpy(), "s_y": s_y.numpy(),
            "s_x": s_x.numpy(), "s_xy": s_xy.numpy(),
            "s_line": s_line.numpy(), "gathered": gathered.numpy(),
            "gx": gx.numpy(), "a2a": a2a.numpy()}


def case_collectives_all(ctx):
    """Every rank's ``case_collectives`` output, gathered on rank 0."""
    import torch.distributed as dist

    mine = _collectives(ctx)
    outs = [None] * ctx.world
    dist.all_gather_object(outs, mine)
    return {"ranks": outs}


# ---- 1D --------------------------------------------------------------------

def cfg_1d(**kw):
    from hybrid_fem_lssvr_tpu_torch import SolverConfig

    base = dict(num_nodes=33, M=8, gamma=1e4)
    base.update(kw)
    return SolverConfig(**base)


def _solve_1d(ctx, problem, cfg, kind="line", axis="elements",
              backend="torch"):
    from hybrid_fem_lssvr_tpu_torch.parallel import collectives, sharded

    mesh = ctx.mesh(kind)
    run = sharded.make_sharded_solve(problem, cfg, mesh, axis=axis,
                                     enhance_backend=backend, device="cpu")
    sol = run()
    return mesh, sol, _np(collectives.gather_solution(sol, mesh, (axis,)))


def case_sharded_1d(ctx):
    """poisson_1d at E = 32 on four ranks (the JAX comparison), with the
    distributed evaluation at 101 points."""
    import numpy as np
    import torch

    from hybrid_fem_lssvr_tpu_torch.models import problems
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded

    problem, cfg = problems.poisson_1d(), cfg_1d()
    mesh, sol, out = _solve_1d(ctx, problem, cfg)
    ev = sharded.make_sharded_evaluate(problem, cfg, mesh, device="cpu")
    x = np.linspace(-1.0, 1.0, 101)
    out["u"] = ev(sol.coeffs, torch.from_numpy(x)).numpy()
    return out


def case_sharded_1d_variants(ctx):
    """The variants held to the port's single-device solver: every problem
    family, an indivisible E, two ranks (the grid's "elx" axis), fem_dtype
    and the dual formulation."""
    from hybrid_fem_lssvr_tpu_torch.models import problems

    res = {}
    for name in ("poisson_1d", "helmholtz_1d", "advection_diffusion_1d",
                 "variable_coeff_elliptic"):
        cfg = cfg_1d(num_nodes=41)
        res[name] = _solve_1d(ctx, problems.get(name), cfg)[2]
    res["indivisible_30"] = _solve_1d(ctx, problems.poisson_1d(),
                                      cfg_1d(num_nodes=31))[2]
    res["d2"] = _solve_1d(ctx, problems.poisson_1d(), cfg_1d(),
                          kind="grid", axis="elx")[2]
    res["dual"] = _solve_1d(ctx, problems.poisson_1d(),
                            cfg_1d(formulation="dual"))[2]
    res["fem_dtype"] = _solve_1d(
        ctx, problems.poisson_1d(),
        cfg_1d(num_nodes=513, dtype="float32", fem_dtype="float64"))[2]
    return res


def case_sharded_1d_plain_kernels(ctx):
    """The per-shard kernel route on the CPU ('auto': the wrappers' plain
    versions): the separable kernel for poisson_1d, the varcoeff kernel in
    graded mode for variable coefficients, float64 and float32 (with the
    float64 coarse stage, as on the card)."""
    from hybrid_fem_lssvr_tpu_torch.models import problems

    res = {}
    for dt in ("float64", "float32"):
        for name in ("poisson_1d", "variable_coeff_elliptic"):
            cfg = cfg_1d(num_nodes=65, dtype=dt, fem_dtype="float64")
            res[f"{name}_{dt}"] = _solve_1d(ctx, problems.get(name), cfg,
                                            backend="auto")[2]
    return res


def case_sharded_1d_rejects(ctx):
    import numpy as np

    from hybrid_fem_lssvr_tpu_torch.models import problems
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded

    raised, said = [], []
    for problem, cfg, kw in (
            (problems.poisson_neumann(), cfg_1d(), {}),
            (problems.poisson_1d(), cfg_1d(num_nodes=5), {}),
            (problems.poisson_1d(), cfg_1d(), {"enhance_backend": "cuda"}),
            # No kernel applies without diagnostics: 'cuda' names the unmet
            # condition, 'auto' takes the torch route.
            (problems.poisson_1d(), cfg_1d(diagnostics=False),
             {"enhance_backend": "cuda"}),
            (problems.poisson_1d(), cfg_1d(diagnostics=False), {})):
        try:
            sharded.make_sharded_solve(problem, cfg, ctx.mesh("line"),
                                       device="cpu", **kw)
            raised.append("")
            said.append("")
        except (NotImplementedError, ValueError) as e:
            raised.append(type(e).__name__)
            said.append(str(e))
    return {"raised": np.array(raised), "said": np.array(said)}


def case_transpose(ctx):
    """The all-to-all transpose of an 8 x 12 array, both ways, and the
    distributed ADI sweeps against the local ones (17-node grid)."""
    import numpy as np
    import torch

    from hybrid_fem_lssvr_tpu_torch.parallel import collectives as col
    from hybrid_fem_lssvr_tpu_torch.parallel import transpose as tr

    mesh = ctx.mesh("line")
    n = ctx.world
    d = col.axis_index(mesh, "elements")
    rows, cols = 8, 12
    x = torch.arange(rows * cols, dtype=torch.float64).reshape(rows, cols)
    r = rows // n
    tp = tr.make_sharded_transpose(mesh, rows, cols)
    tpb = tr.make_sharded_transpose(mesh, cols, rows)
    xt = tp(x[d * r:(d + 1) * r])
    back = tpb(xt)
    out = {"xt": col.all_gather(xt, mesh, "elements").numpy(),
           "back": col.all_gather(back, mesh, "elements").numpy()}
    try:
        tr.make_sharded_transpose(mesh, 10, 16)
        out["rejects"] = np.array(False)
    except ValueError:
        out["rejects"] = np.array(True)
    nn = 17  # 16 interior lines on (0, 1)^2, as tests/test_transpose.py
    h = 1.0 / nn
    xs = np.arange(1, nn) * h
    X, Y = np.meshgrid(xs, xs)
    f = torch.from_numpy(2 * np.pi**2 * np.sin(np.pi * X)
                         * np.sin(np.pi * Y))
    tau = 2.0 * np.pi / h
    u_local = tr.adi_poisson_sweeps(f, h, h, tau, n_sweeps=20)
    tp16 = tr.make_sharded_transpose(mesh, nn - 1, nn - 1)
    rr = (nn - 1) // n
    u_dist = tr.adi_poisson_sweeps(f[d * rr:(d + 1) * rr], h, h, tau,
                                   n_sweeps=20, transpose_fn=tp16,
                                   transpose_fn_T=tp16)
    out["adi_local"] = u_local.numpy()
    out["adi_dist"] = torch.cat(list(col.all_gather(
        u_dist, mesh, "elements"))).numpy()
    return out


# ---- 2D --------------------------------------------------------------------

def graded_nodes(n, seed=7, lo=-1.0, hi=1.0):
    """A random monotone mesh of n intervals on [lo, hi] (seeded)."""
    import numpy as np

    w = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    t = np.concatenate([[0.0], np.cumsum(w)])
    return lo + (hi - lo) * t / t[-1]


def cfg_2d(**kw):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import Solver2DConfig

    base = dict(nx=8, ny=8, M=4, n_colloc=4, precond="jacobi")
    base.update(kw)
    return Solver2DConfig(**base)


EVAL_POINTS = 301


def eval_points(seed=9, n=EVAL_POINTS, dim=2):
    """Query points, some outside the domain (the clamp)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.2, 1.2, n) for _ in range(dim)]


def _solve_2d(ctx, name, cfg, kind="line", axis="elements", grid=False,
              **kw):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.parallel import collectives
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded2d as S2

    mesh = ctx.mesh(kind)
    problem = get_problem_2d(name)
    if grid:
        run = S2.make_sharded_solve_2d_grid(problem, cfg, mesh, device="cpu")
        axes = None
    else:
        run = S2.make_sharded_solve_2d(problem, cfg, mesh, axis=axis,
                                       device="cpu", **kw)
        axes = (axis,)
    sol = run()
    g = collectives.gather_solution(sol, mesh, axes)
    out = _np(g)
    out["grid"] = g.assemble_fem_grid()
    return problem, mesh, sol, out


def case_sharded_2d(ctx):
    """The JAX comparisons: poisson_2d at 8 x 8 on four y-slabs and on the
    2 x 2 grid, the graded solve at 10 x 8 on four slabs, each with its
    distributed evaluation."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.parallel import collectives
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded2d as S2

    x, y = (torch.from_numpy(v) for v in eval_points())
    res = {}
    problem, mesh, sol, out = _solve_2d(ctx, "poisson_2d", cfg_2d())
    out["u"] = S2.make_sharded_evaluate_2d(problem, cfg_2d(), mesh,
                                           device="cpu")(sol.coeffs, x,
                                                         y).numpy()
    res["slab"] = out
    problem, mesh, sol, out = _solve_2d(ctx, "poisson_2d", cfg_2d(),
                                        kind="grid", grid=True)
    out["u"] = S2.make_sharded_evaluate_2d_grid(
        problem, cfg_2d(), mesh, device="cpu")(sol.coeffs, x, y).numpy()
    res["grid"] = out
    xs, ys = graded_nodes(10), graded_nodes(8, seed=8)
    mesh = ctx.mesh("line")
    for name in ("poisson_2d", "variable_coeff_elliptic_2d"):
        cfg = cfg_2d(nx=10)
        sol = S2.make_sharded_solve_2d_graded(
            get_problem_2d(name), cfg, mesh, xs, ys, device="cpu")()
        g = collectives.gather_solution(sol, mesh)
        out = _np(g)
        out["grid"] = g.assemble_fem_grid()
        out["u"] = S2.make_sharded_evaluate_2d_graded(
            cfg, mesh, xs, ys, device="cpu")(sol.coeffs, x, y).numpy()
        res[f"graded_{name}"] = out
    return res


# (key, problem, config overrides, mesh kind, axis, grid, solve kwargs)
VARIANTS_2D = [
    ("mg", "poisson_2d", dict(nx=16, ny=16, precond="mg"), "line",
     "elements", False, {}),
    ("auto_d2", "poisson_2d", dict(nx=16, ny=16, precond="auto"), "grid",
     "elx", False, {}),
    ("adi", "poisson_2d", dict(nx=16, ny=16, precond="adi"), "line",
     "elements", False, {}),
    ("adi_13", "poisson_2d", dict(nx=13, ny=16, precond="adi"), "line",
     "elements", False, {}),
    ("replicated_fem", "poisson_2d", dict(ny=16), "line", "elements", False,
     {"distributed_fem": False}),
    ("indivisible", "poisson_2d", dict(ny=10), "line", "elements", False,
     {}),
    ("compact_lift", "poisson_2d",
     dict(nx=16, ny=16, M=6, n_colloc=6, precond="mg", coarse="compact",
          trace_lift=6), "line", "elements", False, {}),
    ("varcoeff_mg", "variable_coeff_elliptic_2d",
     dict(nx=16, ny=16, precond="mg"), "line", "elements", False, {}),
    ("advection", "advection_diffusion_2d", dict(), "line", "elements",
     False, {}),
    ("helmholtz_shifted", "helmholtz_2d", dict(nx=16, ny=16,
                                               precond="auto"),
     "line", "elements", False, {}),
    ("grid_mg", "poisson_2d", dict(nx=16, ny=16, precond="auto"), "grid",
     None, True, {}),
    ("grid_varcoeff", "variable_coeff_elliptic_2d", dict(), "grid", None,
     True, {}),
    ("grid_compact_lift", "poisson_2d",
     dict(nx=16, ny=16, M=6, n_colloc=6, coarse="compact", trace_lift=6),
     "grid", None, True, {}),
    ("grid_shifted", "helmholtz_2d", dict(nx=16, ny=16, precond="auto"),
     "grid", None, True, {}),
]


def case_sharded_2d_variants(ctx):
    res = {}
    for key, name, over, kind, axis, grid, kw in VARIANTS_2D:
        res[key] = _solve_2d(ctx, name, cfg_2d(**over), kind=kind,
                             axis=axis, grid=grid, **kw)[3]
    return res


def case_sharded_2d_rejects(ctx):
    import numpy as np

    from hybrid_fem_lssvr_tpu_torch.models.hybrid2d import get_problem_2d
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded2d as S2

    mesh, grid = ctx.mesh("line"), ctx.mesh("grid")
    xs = graded_nodes(8)
    tries = (
        lambda: S2.make_sharded_solve_2d(get_problem_2d("poisson_2d_neumann"),
                                         cfg_2d(), mesh, device="cpu"),
        lambda: S2.make_sharded_solve_2d(
            get_problem_2d("variable_coeff_elliptic_2d"),
            cfg_2d(coarse="compact"), mesh, device="cpu"),
        lambda: S2.make_sharded_solve_2d_grid(get_problem_2d("poisson_2d"),
                                              cfg_2d(nx=9), grid,
                                              device="cpu"),
        lambda: S2.make_sharded_solve_2d_graded(
            get_problem_2d("poisson_2d"), cfg_2d(), mesh, xs,
            graded_nodes(6), device="cpu"),
        lambda: S2.make_sharded_solve_2d_graded(
            get_problem_2d("poisson_2d"), cfg_2d(coarse="compact"), mesh,
            xs, xs, device="cpu"),
    )
    raised = []
    for t in tries:
        try:
            t()
            raised.append("")
        except (NotImplementedError, ValueError) as e:
            raised.append(type(e).__name__)
    return {"raised": np.array(raised)}


# ---- 3D --------------------------------------------------------------------

def cfg_3d(**kw):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import Solver3DConfig

    base = dict(nx=4, ny=4, nz=8, M=3, n_colloc=3, precond="jacobi")
    base.update(kw)
    return Solver3DConfig(**base)


def graded_mesh_3d():
    return graded_nodes(4, seed=11), graded_nodes(4, seed=12), \
        graded_nodes(8, seed=13)


def _solve_3d(ctx, name, cfg, kind="line", axis="elements", grid=False,
              **kw):
    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import get_problem_3d
    from hybrid_fem_lssvr_tpu_torch.parallel import collectives
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded3d as S3

    mesh = ctx.mesh(kind)
    problem = get_problem_3d(name)
    if grid:
        run = S3.make_sharded_solve_3d_grid(problem, cfg, mesh, device="cpu")
        axes = None
    else:
        run = S3.make_sharded_solve_3d(problem, cfg, mesh, axis=axis,
                                       device="cpu", **kw)
        axes = (axis,)
    sol = run()
    g = collectives.gather_solution(sol, mesh, axes)
    out = _np(g)
    out["grid"] = g.assemble_fem_grid()
    return problem, mesh, sol, out


def case_sharded_3d(ctx):
    """The JAX comparisons: poisson_3d at 4 x 4 x 8 on four z-slabs, at
    4 x 4 x 4 on the 2 x 2 (z, y) grid, and the graded solve at
    4 x 4 x 8, each with its distributed evaluation."""
    import torch

    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import get_problem_3d
    from hybrid_fem_lssvr_tpu_torch.parallel import collectives
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded3d as S3

    x, y, z = (torch.from_numpy(v) for v in eval_points(dim=3))
    res = {}
    problem, mesh, sol, out = _solve_3d(ctx, "poisson_3d", cfg_3d())
    out["u"] = S3.make_sharded_evaluate_3d(problem, cfg_3d(), mesh,
                                           device="cpu")(sol.coeffs, x, y,
                                                         z).numpy()
    res["slab"] = out
    cfg = cfg_3d(nz=4)
    problem, mesh, sol, out = _solve_3d(ctx, "poisson_3d", cfg,
                                        kind="grid3", grid=True)
    out["u"] = S3.make_sharded_evaluate_3d_grid(
        problem, cfg, mesh, device="cpu")(sol.coeffs, x, y, z).numpy()
    res["grid"] = out
    xs, ys, zs = graded_mesh_3d()
    mesh = ctx.mesh("line")
    for name in ("poisson_3d", "variable_coeff_elliptic_3d"):
        sol = S3.make_sharded_solve_3d_graded(
            get_problem_3d(name), cfg_3d(), mesh, xs, ys, zs,
            device="cpu")()
        g = collectives.gather_solution(sol, mesh)
        out = _np(g)
        out["grid"] = g.assemble_fem_grid()
        out["u"] = S3.make_sharded_evaluate_3d_graded(
            cfg_3d(), mesh, xs, ys, zs, device="cpu")(sol.coeffs, x, y,
                                                      z).numpy()
        res[f"graded_{name}"] = out
    return res


# (key, problem, config overrides, mesh kind, axis, grid, solve kwargs)
VARIANTS_3D = [
    ("mg", "poisson_3d", dict(nx=8, ny=8, nz=8, precond="auto"), "line",
     "elements", False, {}),
    ("replicated_fem", "poisson_3d", dict(), "line", "elements", False,
     {"distributed_fem": False}),
    ("d2", "poisson_3d", dict(), "grid3", "ely", False, {}),
    ("varcoeff", "variable_coeff_elliptic_3d", dict(), "line", "elements",
     False, {}),
    ("advection", "advection_diffusion_3d", dict(), "line", "elements",
     False, {}),
    ("helmholtz_shifted", "helmholtz_3d",
     dict(nx=8, ny=8, nz=8, precond="auto"), "line", "elements", False,
     {}),
    ("compact_lift", "poisson_3d",
     dict(nx=8, ny=8, nz=8, M=4, n_colloc=4, precond="auto",
          coarse="compact", trace_lift=6), "line", "elements", False, {}),
    ("grid_mg", "poisson_3d", dict(nx=8, ny=8, nz=8, precond="auto"),
     "grid3", None, True, {}),
    ("grid_varcoeff", "variable_coeff_elliptic_3d", dict(nz=4), "grid3",
     None, True, {}),
    ("grid_compact_lift", "poisson_3d",
     dict(nx=8, ny=8, nz=8, M=4, n_colloc=4, coarse="compact",
          trace_lift=6), "grid3", None, True, {}),
]


def case_sharded_3d_variants(ctx):
    res = {}
    for key, name, over, kind, axis, grid, kw in VARIANTS_3D:
        res[key] = _solve_3d(ctx, name, cfg_3d(**over), kind=kind,
                             axis=axis, grid=grid, **kw)[3]
    return res


def case_sharded_3d_rejects(ctx):
    import numpy as np

    from hybrid_fem_lssvr_tpu_torch.models.hybrid3d import get_problem_3d
    from hybrid_fem_lssvr_tpu_torch.parallel import sharded3d as S3

    mesh, grid = ctx.mesh("line"), ctx.mesh("grid3")
    xs, ys, zs = graded_mesh_3d()
    p = get_problem_3d("poisson_3d")
    tries = (
        lambda: S3.make_sharded_solve_3d(get_problem_3d("poisson_3d_neumann"),
                                         cfg_3d(), mesh, device="cpu"),
        lambda: S3.make_sharded_solve_3d(p, cfg_3d(nz=6), mesh,
                                         device="cpu"),
        lambda: S3.make_sharded_solve_3d_grid(p, cfg_3d(ny=5), grid,
                                              device="cpu"),
        lambda: S3.make_sharded_solve_3d_graded(
            p, cfg_3d(coarse="compact"), mesh, xs, ys, zs, device="cpu"),
        lambda: S3.make_sharded_solve_3d_graded(
            p, cfg_3d(), mesh, xs, ys, graded_nodes(6), device="cpu"),
    )
    raised = []
    for t in tries:
        try:
            t()
            raised.append("")
        except (NotImplementedError, ValueError) as e:
            raised.append(type(e).__name__)
    return {"raised": np.array(raised)}
