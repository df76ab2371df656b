"""Grouped batched solves over parametric problem families.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/models/batched.py``.
Heterogeneous workloads are grouped by (operator family, solver config)
into groups with a static partition; each group is one batched solve over
its parameter batch, so parameter sweeps (k sweeps, boundary-data families,
ensembles) run as one batch instead of a Python loop of solves.

JAX's ``jax.vmap`` over the family member becomes explicit batching: the
family's callables are evaluated with the parameter on a leading axis
(shaped [P, 1, ...] against points [P, ...]), the P coarse systems are
assembled as one [P, N] batch and solved together (``tridiag.solve`` takes
a batch of systems), and one enhancement runs over all P E elements: on a
CUDA float32 run that is one launch of ``fused_enhance_varcoeff`` in its
family layout, each element reading its own family's nodal values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.device import resolve as resolve_device
from .hybrid import SolverConfig, Solution, fem_solve, lssvr_enhance
from .problem import Problem1D

_span = torch.profiler.record_function
# fem_solve's spans (models/hybrid.py) and the enhancement's
SPANS = ("fem_solve.assembly", "fem_solve.tridiag", "lssvr_enhance")


def _ones(x, th):
    return torch.ones_like(x)


def _zeros(x, th):
    return torch.zeros_like(x)


def _zero_bc(th):
    return 0.0


@dataclasses.dataclass(frozen=True)
class ParametricFamily1D:
    """A family of 1D problems indexed by a parameter vector theta.

    Every callable takes (x, theta); theta may be a scalar or a small
    vector.  Instances of the family share mesh and config and therefore
    solve as ONE batch.  In a batched solve theta arrives with the family
    axis leading: a tensor [P, 1, ...] for a scalar parameter, and for a
    vector one theta[i] is component i, [P, 1, ...].
    """

    name: str
    f: Callable  # (x, theta) -> rhs
    a: Callable = _ones
    da: Callable = _zeros
    b: Callable = _zeros
    c: Callable = _zeros
    g_left: Callable = _zero_bc
    g_right: Callable = _zero_bc
    domain: Tuple[float, float] = (-1.0, 1.0)
    exact: Optional[Callable] = None  # (x, theta) -> u

    def instantiate(self, theta) -> Problem1D:
        """Bind theta into a concrete Problem1D."""
        return Problem1D(
            name=self.name,
            f=lambda x: self.f(x, theta),
            a=lambda x: self.a(x, theta),
            da=lambda x: self.da(x, theta),
            b=lambda x: self.b(x, theta),
            c=lambda x: self.c(x, theta),
            domain=self.domain,
            g_left=self.g_left(theta),
            g_right=self.g_right(theta),
            exact=(lambda x: self.exact(x, theta)) if self.exact else None,
            constant_coeffs=False,
        )


def helmholtz_family() -> ParametricFamily1D:
    """-u'' - k^2 u = (pi^2 - k^2) sin(pi x); theta = k; exact sin(pi x)."""
    pi = torch.pi
    return ParametricFamily1D(
        name="helmholtz_family",
        f=lambda x, k: (pi**2 - k**2) * torch.sin(pi * x),
        c=lambda x, k: -(k**2) * torch.ones_like(x),
        exact=lambda x, k: torch.sin(pi * x),
    )


def advdiff_family() -> ParametricFamily1D:
    """-eps u'' + beta u' = f; theta = (eps, beta); exact sin(pi x)."""
    pi = torch.pi
    return ParametricFamily1D(
        name="advdiff_family",
        f=lambda x, th: th[0] * pi**2 * torch.sin(pi * x)
        + th[1] * pi * torch.cos(pi * x),
        a=lambda x, th: th[0] * torch.ones_like(x),
        b=lambda x, th: th[1] * torch.ones_like(x),
        exact=lambda x, th: torch.sin(pi * x),
    )


def _theta_field(thetas, ndim: int):
    """thetas [P] or [P, d] shaped to broadcast against points of ``ndim``
    axes whose first is the family axis: [P, 1, ...] (a vector parameter:
    [d, P, 1, ...], so that theta[i] is component i)."""
    P = thetas.shape[0]
    tail = (1,) * (ndim - 1)
    if thetas.ndim == 1:
        return thetas.reshape((P,) + tail)
    return thetas.T.reshape((thetas.shape[1], P) + tail)


def batched_problem(family: ParametricFamily1D, thetas) -> Problem1D:
    """The whole family as one Problem1D over a batch of meshes: its
    callables take points [P, ...] of three axes (the [P, E, Q] quadrature
    points of the assembly, the [P, E, C] / [P, C, E] collocation points of
    the enhancement) and its boundary data are [P] tensors or scalars."""
    bc = _theta_field(thetas, 1)
    return dataclasses.replace(family.instantiate(_theta_field(thetas, 3)),
                               g_left=family.g_left(bc),
                               g_right=family.g_right(bc))


def solve_family(family: ParametricFamily1D, cfg: SolverConfig, thetas,
                 device=None) -> Solution:
    """One batched hybrid solve over the family's parameter batch.

    thetas: [P] or [P, d] (tensor, array or list).  Returns a Solution
    whose fields carry a leading batch axis [P, ...].  The coarse stage runs
    in ``cfg.fem_dtype`` where it is set (as ``hybrid_solve`` does), the
    enhancement in the run dtype, on ``device`` (None: the GPU).
    """
    device = resolve_device(device)
    dtype = cfg.torch_dtype()
    thetas = torch.as_tensor(thetas, dtype=dtype, device=device)
    P = thetas.shape[0]
    x0, x1 = family.domain
    nodes = torch.linspace(x0, x1, cfg.num_nodes, dtype=dtype,
                           device=device).expand(P, cfg.num_nodes)
    fd = getattr(torch, cfg.fem_dtype) if cfg.fem_dtype else dtype
    fem_values = fem_solve(batched_problem(family, thetas.to(fd)),
                           nodes.to(fd), cfg).to(dtype)
    with _span("lssvr_enhance"):
        w, diags = lssvr_enhance(batched_problem(family, thetas), nodes,
                                 fem_values, cfg, shared_ops=None)
    return Solution(nodes, fem_values, w, diags.max_slack,
                    diags.bc_violation, diags.solve_ok)


class GroupResult(NamedTuple):
    family_name: str
    solution: Solution


def solve_groups(groups: Sequence[Tuple[ParametricFamily1D, SolverConfig,
                                        object]], device=None):
    """Static routing: each (family, cfg, thetas) group is one batched
    solve (one enhancement launch on the card); groups run back to back."""
    return [
        GroupResult(family.name, solve_family(family, cfg, thetas,
                                              device=device))
        for family, cfg, thetas in groups
    ]
